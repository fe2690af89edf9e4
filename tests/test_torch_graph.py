"""PyTorch port: the train step replayed as a CUDA graph
(``engine/graph.py``).

On the CPU, ``graph.EagerReplays`` stands in for the CUDA graphs (each
replay runs the recorded step and writes the first replay's output, as a
graph writes its static output), so the graph path's host draws, packed
buffer, tensor learning rate and metric snapshots run here: over three
toy ``lrw_video`` steps they give bitwise the eager step's losses,
metrics, parameters, moments, running statistics and generator states,
with CutMix on and on the TCN path's batch mixup; a step's metrics
outlive the next replays; each reason that keeps a step eager does; and
a profiler window replays a captured signature.

The ``chip``-marked tests need a card and skip without one; on the card
(with no JAX: ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graph.py -m chip

they hold 4 replayed steps of each word recipe (full widths, a batch of
8) against 4 eager steps from the same seeds, bitwise, count the
captures and replays, read the hand-written kernels' launches in
replayed steps from a profiler trace, and replay correctly after eager
kernel calls have replaced the kernels' result arena.
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

from syncvsr_tpu_torch import config as tcfg
from syncvsr_tpu_torch.data.synthetic import sentence_batch, word_batch
from syncvsr_tpu_torch.engine import build_train_step, create_train_state, graph
from syncvsr_tpu_torch.models import build_model
from syncvsr_tpu_torch.ops import launch_counts, traced_launches
from syncvsr_tpu_torch.ops.image import build_sentence_aug, build_word_aug
from syncvsr_tpu_torch.parallel.mesh import Mesh
from syncvsr_tpu_torch.utils import profiling
import torch_threads  # noqa: F401  (one torch thread a test process)

# toy widths, f32, dropout and CutMix on
TINY = {
    "model.encoder.layers": 1, "model.encoder.dim": 32, "model.encoder.heads": 2,
    "model.frontend.resnet_width": 8, "model.labels": 7,
    "model.codec.audio_vocab_size": 13, "model.dtype": "float32",
    "model.encoder.emb_dropout": 0.1, "model.encoder.mlp_dropout": 0.1,
    "data.batch_size": 2, "data.num_frames": 4, "data.crop_size": 16,
    "data.use_cutmix": True, "optim.total_steps": 10, "optim.warmup_steps": 2,
}
TOY_TCN = {"model.encoder.tcn_growth_rates": (12, 12), "model.encoder.tcn_blocks": (2, 1),
           "model.encoder.tcn_reduced_size": 16}
SENTENCE = {
    "model.encoder.layers": 1, "model.encoder.dim": 32, "model.encoder.heads": 2,
    "model.decoder.layers": 1, "model.decoder.dim": 16, "model.decoder.heads": 2,
    "model.decoder.hidden": 24, "model.frontend.resnet_width": 8, "model.labels": 11,
    "model.codec.audio_vocab_size": 13, "model.dtype": "float32", "data.batch_size": 2,
    "data.crop_size": 16, "optim.total_steps": 10, "optim.warmup_steps": 2,
}


def _config(path="cutmix", **over):
    if path == "mixup":
        return tcfg.lrw_dctcn_config().override(**dict(TINY, **TOY_TCN, **over))
    return tcfg.lrw_video_config().override(**dict(TINY, **over))


def _word(cfg, seed, batch_size=0, device="cpu"):
    """A word batch with uint8 clips [B, T, crop, crop + 4, 1]."""
    batch = word_batch(cfg, batch_size=batch_size, seed=seed)
    b, t = batch["inputs"].shape[:2]
    if batch["inputs"].ndim == 5:
        s = cfg.data.crop_size
        rng = np.random.RandomState(seed + 100)
        batch["inputs"] = rng.randint(0, 256, (b, t, s, s + 4, 1)).astype(np.uint8)
    if cfg.model.encoder.kind == "dense_tcn":
        batch["attention_mask"] = np.ones((b, t), np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _counts_since(before):
    now = profiling.graph_counts()
    eager = {k: n - before["eager"].get(k, 0) for k, n in now["eager"].items()}
    return {"captures": now["captures"] - before["captures"],
            "replays": now["replays"] - before["replays"],
            "eager": {k: n for k, n in eager.items() if n}}


def _run(cfg, batches, graphs=None, aug=True, device="cpu", between=None):
    """A fresh state (the config's seeded weights) through ``batches``:
    (state, each step's metrics as host floats, the graph counts it
    added, each step's hand-written kernel launches, the step)."""
    state = create_train_state(cfg, build_model(cfg, device=device), batches[0], device=device)
    step = build_train_step(aug_fn=build_word_aug(cfg.data) if aug else None)
    if graphs is not None:
        step.graphs = graphs
    before, out, launched = profiling.graph_counts(), [], []
    for i, batch in enumerate(batches):
        if between is not None:
            between(i)
        n0 = launch_counts()
        state, m = step(state, batch)
        out.append({k: float(v) for k, v in m.items()})
        launched.append({k: n - n0[k] for k, n in launch_counts().items()})
    return state, out, _counts_since(before), launched, step


def _tensors(state):
    return {"params": state.params, "mu": state.mu, "nu": state.nu,
            "buffers": [b for _, b in state.model.named_buffers()]}


@pytest.mark.parametrize("path", ["cutmix", "mixup"])
def test_the_split_step_is_the_eager_step_bitwise(path):
    cfg = _config(path)
    batches = [_word(cfg, seed) for seed in range(3)]
    eager, m_e, c_e, _, _ = _run(cfg, batches)
    split, m_s, c_s, _, _ = _run(cfg, batches, graph.EagerReplays())
    assert c_e == {"captures": 0, "replays": 0, "eager": {"device": 3}}
    assert c_s == {"captures": 1, "replays": 2, "eager": {"warmup": 1}}
    assert m_s == m_e and list(m_s[0]) == list(m_e[0])
    for name, a in _tensors(eager).items():
        b = _tensors(split)[name]
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert torch.equal(x, y), name
    for gen in ("mixup_gen", "dropout_gen"):
        assert torch.equal(getattr(eager, gen).get_state(), getattr(split, gen).get_state())
    assert (split.step, split.count, split.lr) == (eager.step, eager.count, eager.lr) == (
        3, 3, eager.schedule(2))


def test_a_steps_metrics_outlive_the_next_replays():
    cfg = _config()
    state = create_train_state(cfg, build_model(cfg, device="cpu"), _word(cfg, 0),
                               device="cpu")
    step = build_train_step(aug_fn=build_word_aug(cfg.data))
    step.graphs = graph.EagerReplays()
    held, read = [], []
    for seed in range(5):
        state, m = step(state, _word(cfg, seed))
        held.append(m)
        read.append({k: v.clone() for k, v in m.items()})
    assert len({r["loss"].item() for r in read}) == 5
    for m, r in zip(held, read):
        for k in m:
            assert torch.equal(m[k], r[k]), k


def _toy_state(cfg, batch):
    return create_train_state(cfg, build_model(cfg, device="cpu"), batch, device="cpu")


def _eager_case(reason):
    """(step, state, batches) of a step that stays eager for ``reason``."""
    over = {"accum": {"optim.accum_steps": 2}, "skip_nonfinite": {"optim.skip_nonfinite": True},
            "remat": {"model.remat": True}}.get(reason, {})
    cfg = _config(**over)
    aug = build_word_aug(cfg.data)
    batches = [_word(cfg, 0)]
    if reason == "host_read":   # a sentence step reads clip lengths and CTC's finiteness
        cfg = tcfg.lrs3_config().override(**SENTENCE)
        aug = build_sentence_aug(cfg.data)
        batches = [{k: torch.from_numpy(v) for k, v in
                    sentence_batch(cfg, num_frames=8, label_len=3, seed=s).items()}
                   for s in range(2)]
    elif reason == "cap":         # one graph kept; the second signature stays eager
        batches = [_word(cfg, 0), _word(cfg, 1), _word(cfg, 2, batch_size=3)]
    step = build_train_step(aug_fn=aug)
    if reason != "device":
        step.graphs = graph.EagerReplays()
    if reason == "cap":
        step.cap = 1
    return step, _toy_state(cfg, batches[0]), batches


@pytest.mark.parametrize("reason", ["device", "mesh", "accum", "skip_nonfinite", "remat",
                                    "spans", "host_read", "cap"])
def test_a_step_stays_eager_for_its_reason(reason):
    assert reason in graph.REASONS
    if reason == "mesh":   # two processes: decided before any collective runs
        cfg = _config()
        batch = _word(cfg, 0)
        state = _toy_state(cfg, batch)
        for size, expect in ((2, "mesh"), (1, None)):
            step = build_train_step(build_word_aug(cfg.data),
                                    Mesh(size=size, rank=0, device=torch.device("cpu")))
            step.graphs = graph.EagerReplays()
            assert step.reason(state, batch) == expect
        return
    step, state, batches = _eager_case(reason)
    before = profiling.graph_counts()
    with profiling.spans() if reason == "spans" else contextlib.nullcontext():
        for batch in batches:
            state, m = step(state, batch)
            assert np.isfinite(float(m["loss"]))
    counts = _counts_since(before)
    if reason == "cap":
        assert counts == {"captures": 1, "replays": 1, "eager": {"warmup": 1, "cap": 1}}
    else:
        assert counts == {"captures": 0, "replays": 0, "eager": {reason: len(batches)}}


def test_a_profile_window_replays_a_captured_signature(tmp_path):
    """Inside a ``Trace`` window (``train.profile_steps``) a signature with
    a graph replays; one without stays eager, with its spans."""
    cfg = _config()
    batches = [_word(cfg, 0), _word(cfg, 1), _word(cfg, 2), _word(cfg, 3, batch_size=3)]
    state = _toy_state(cfg, batches[0])
    step = build_train_step(aug_fn=build_word_aug(cfg.data))
    step.graphs = graph.EagerReplays()
    before = profiling.graph_counts()
    for batch in batches[:2]:
        state, _ = step(state, batch)
    trace = profiling.Trace(str(tmp_path))
    trace.start()
    for batch in batches[2:]:
        state, m = step(state, batch)
        assert np.isfinite(float(m["loss"]))
    trace.stop()
    assert _counts_since(before) == {"captures": 1, "replays": 2,
                                     "eager": {"warmup": 1, "spans": 1}}
    assert (tmp_path / "trace.json").exists()


# --- on the card ---------------------------------------------------------

CARD_BATCH = 8


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_config(preset):
    return tcfg.PRESETS[preset]().override(**{"data.batch_size": CARD_BATCH})


def _close_runs(cfg, eager, graphed):
    """Bitwise the same: every metric of every step, the parameters, Adam's
    moments, the BatchNorm statistics and both generators' states; and the
    hand-written kernels' launches a step that the wrappers count."""
    (s_e, m_e, _, l_e, _), (s_g, m_g, _, l_g, _) = eager, graphed
    assert m_e == m_g and [list(m) for m in m_e] == [list(m) for m in m_g]
    for name, a in _tensors(s_e).items():
        b = _tensors(s_g)[name]
        assert len(a) == len(b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert torch.equal(x.detach(), y.detach()), (name, i)
    for gen in ("mixup_gen", "dropout_gen"):
        assert torch.equal(getattr(s_e, gen).get_state(), getattr(s_g, gen).get_state()), gen
    assert l_e == l_g
    assert (s_e.step, s_e.count, s_e.lr) == (s_g.step, s_g.count, s_g.lr)


def _traced(step, state, batch, n=2):
    """The hand-written kernels' launches a step over ``n`` replays of
    ``batch``: (read by kernel name from a profiler trace, counted by the
    wrappers; one unprofiled replay before, ``profile_window``)."""
    from syncvsr_tpu_torch.utils.benchmark import profile_window

    n0, before = launch_counts(), profiling.graph_counts()
    window = profile_window(lambda: step(state, batch), torch.device("cuda"), n)
    assert _counts_since(before) == {"captures": 0, "replays": n + 1, "eager": {}}
    counted = {k: (c - n0[k]) / (n + 1) for k, c in launch_counts().items()}
    return traced_launches((k, calls) for k, _, calls in window["kernels"]), counted


@pytest.mark.chip
@pytest.mark.parametrize("preset", ["lrw_video", "lrw_dctcn", "lrw1000", "lrw_landmark"])
def test_replayed_steps_match_eager_steps_on_the_card(preset):
    _need_card()
    cfg = _card_config(preset)
    batches = [_word(cfg, seed, device="cuda") for seed in range(4)]
    with profiling.spans():      # the spans keep every step eager
        eager = _run(cfg, batches, device="cuda")
    graphed = _run(cfg, batches, device="cuda")
    assert eager[2] == {"captures": 0, "replays": 0, "eager": {"spans": 4}}
    assert graphed[2] == {"captures": 1, "replays": 3, "eager": {"warmup": 1}}
    _close_runs(cfg, eager, graphed)
    # what the replays ran, from the trace, is what the eager steps launched
    traced, counted = _traced(graphed[4], graphed[0], batches[0])
    assert traced == counted == eager[3][-1]
    if preset == "lrw_video":
        assert traced == {"sync_ce_fwd": 1, "sync_ce_split_fwd": 0,
                          "bn_stats_fwd": 20, "bn_stats_bwd": 20}


@pytest.mark.chip
def test_a_step_that_synchronizes_stays_eager_on_the_card():
    """A device value read inside the step where no ``host_read`` counts it
    (here a forward hook's ``.item()``): the warm-up's sync debug mode sees
    it, and the signature stays eager."""
    _need_card()
    cfg = _card_config("lrw_video")
    batches = [_word(cfg, seed, device="cuda") for seed in range(3)]
    state = create_train_state(cfg, build_model(cfg, device="cuda"), batches[0], device="cuda")

    def read(module, inputs, out):
        out.float().sum().item()

    state.model.frontend.register_forward_hook(read)
    step = build_train_step(aug_fn=build_word_aug(cfg.data))
    before = profiling.graph_counts()
    for batch in batches:
        state, m = step(state, batch)
    assert _counts_since(before) == {"captures": 0, "replays": 0, "eager": {"host_read": 3}}


@pytest.mark.chip
def test_a_replay_outlives_a_replaced_kernel_arena():
    _need_card()
    from syncvsr_tpu_torch.ops import cuda_bn
    from syncvsr_tpu_torch.utils import kernels

    cfg = _card_config("lrw_video")
    batches = [_word(cfg, seed, device="cuda") for seed in range(4)]
    fillers = []

    def churn(i):
        if i != 2:
            return
        arena = kernels._arena[torch.cuda.current_device()][3]
        x = torch.randn(64, 2048, device="cuda", dtype=torch.bfloat16)
        while kernels._arena[torch.cuda.current_device()][3] is arena:
            cuda_bn.bn_stats(x)
        del arena
        gc.collect()
        torch.cuda.empty_cache()
        fillers.extend(torch.full((1 << 22,), 7.0, device="cuda") for _ in range(64))

    with profiling.spans():
        eager = _run(cfg, batches, device="cuda")
    graphed = _run(cfg, batches, device="cuda", between=churn)
    assert graphed[2] == {"captures": 1, "replays": 3, "eager": {"warmup": 1}}
    _close_runs(cfg, eager, graphed)
    assert fillers and all(bool((f == 7.0).all()) for f in fillers)

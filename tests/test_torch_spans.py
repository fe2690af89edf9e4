"""PyTorch port: the spans and the host-read counter of
``utils/profiling.py``. Off, a span is one shared no-op that records
nothing; on, spans nest, carry their names and thread ids (a span in an
autograd backward included), share ``torch.profiler``'s clock, and a toy
train step records its phases and modules in order and the host reads it
makes by site."""

import ast
import pathlib
import threading
import time

import pytest
import torch

from syncvsr_tpu_torch.config import lrs3_config, lrw_video_config
from syncvsr_tpu_torch.data.synthetic import sentence_batch, word_batch
from syncvsr_tpu_torch.engine import build_train_step, create_train_state
from syncvsr_tpu_torch.models import build_model
from syncvsr_tpu_torch.ops.image import build_sentence_aug, build_word_aug
from syncvsr_tpu_torch.utils import profiling
from syncvsr_tpu_torch.utils.profiling import host_read_counts, span, spans
import torch_threads  # noqa: F401  (one torch thread a test process)

PACKAGE = pathlib.Path(profiling.__file__).resolve().parents[1]
TINY = {
    "model.encoder.layers": 1, "model.encoder.dim": 32, "model.encoder.heads": 2,
    "model.encoder.conv_kernel": 7, "model.decoder.layers": 1, "model.decoder.dim": 32,
    "model.decoder.heads": 2, "model.decoder.hidden": 64, "model.frontend.resnet_width": 8,
    "model.frontend.stem_channels": 8, "model.labels": 33,
    "model.codec.audio_vocab_size": 16, "model.dtype": "float32", "data.batch_size": 2,
    "data.crop_size": 16}


class _Twice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        with span("kernel.bn_stats"):
            return x * 2

    @staticmethod
    def backward(ctx, g):
        with span("kernel.bn_stats.bwd"):
            return g * 2


def test_off_a_span_is_the_shared_no_op_and_records_nothing():
    assert not profiling._on
    a, b = span("step.forward"), span("model.encoder")
    assert a is b is profiling._NO_SPAN
    with a:
        with span("kernel.bn_stats"):
            pass
    assert profiling._records == []
    with spans() as rec:
        pass
    assert rec == [] and not profiling._on


def test_on_spans_nest_with_their_names_and_threads():
    x = torch.ones(3, requires_grad=True)
    other = []
    with spans() as rec:
        with span("step.forward"):
            with span("model.frontend"):
                y = _Twice.apply(x).sum()
        with span("step.backward"):
            y.backward()
        with span("step.update"):
            t = threading.Thread(target=_open_and_close, args=(other,))
            t.start()
            t.join()
    assert [r[0] for r in rec] == ["step.forward", "model.frontend", "kernel.bn_stats",
                                   "step.backward", "kernel.bn_stats.bwd", "step.update",
                                   "train.loader_wait"]
    by = {r[0]: r for r in rec}
    main = threading.get_ident()
    for name in ("step.forward", "model.frontend", "kernel.bn_stats", "step.backward"):
        assert by[name][1] == main
    assert by["train.loader_wait"][1] == other[0] != main
    for outer, inner in (("step.forward", "model.frontend"), ("model.frontend", "kernel.bn_stats"),
                         ("step.backward", "kernel.bn_stats.bwd"),
                         ("step.update", "train.loader_wait")):
        assert by[outer][2] <= by[inner][2] <= by[inner][3] <= by[outer][3]
    assert x.grad.tolist() == [2.0, 2.0, 2.0]
    assert profiling._records == [] and not profiling._on


def _open_and_close(out):
    out.append(threading.get_ident())
    with span("train.loader_wait"):
        time.sleep(0.001)


def test_a_span_is_on_the_profilers_clock():
    """Under a CPU profiler the span mirrors itself as a ``record_function``
    and starts within 1 ms of it, inside a second ``record_function``
    opened around the same block (on another clock, such as
    ``perf_counter``'s, the two would lie ~1e18 ns apart)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof, spans() as rec:
        for _ in range(3):   # the last is read: the first pays the profiler's set-up
            with record_function("outer.probe"):
                with span("step.forward"):
                    torch.ones(64).sum()
    _, _, start, end = rec[-1]
    kineto = {e.name(): e for e in sorted(prof.profiler.kineto_results.events(),
                                          key=lambda e: e.start_ns())}
    outer, mirror = kineto["outer.probe"], kineto["step.forward"]
    assert abs(mirror.start_ns() - start) < 1_000_000
    assert abs(mirror.start_ns() + mirror.duration_ns() - end) < 1_000_000
    assert outer.start_ns() <= start <= end <= outer.start_ns() + outer.duration_ns()


def test_every_span_of_the_package_is_in_the_fixed_list():
    used = set()
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                used.add(node.args[0].value)
    assert used == set(profiling.SPANS)


def _word_state(overrides=None):
    cfg = lrw_video_config().override(**dict(TINY, **{"data.num_frames": 4},
                                             **(overrides or {})))
    batch = {k: torch.from_numpy(v) for k, v in word_batch(cfg, seed=3).items()}
    state = create_train_state(cfg, build_model(cfg, device="cpu"), batch, device="cpu")
    return state, build_train_step(aug_fn=build_word_aug(cfg.data)), batch


def _sentence_state():
    cfg = lrs3_config().override(**TINY)
    raw = sentence_batch(cfg, num_frames=12, label_len=3, seed=3)
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    state = create_train_state(cfg, build_model(cfg, device="cpu"), batch, device="cpu")
    return state, build_train_step(aug_fn=build_sentence_aug(cfg.data)), batch


def test_a_word_train_step_records_its_phases_and_modules_in_order():
    state, step, batch = _word_state()
    with spans() as rec:
        step(state, batch)
    names = [r[0] for r in rec]
    bn = names.count("kernel.bn_stats")
    assert bn > 0 and names.count("kernel.bn_stats.bwd") == bn
    # the CPU runs the sync head's plain path (autograd's backward: no span)
    assert [n for n in names if not n.startswith("kernel.bn_stats")] == [
        "step.forward", "step.augment", "model.frontend", "model.encoder", "kernel.sync_ce",
        "step.backward", "step.update"]
    by = {n: r for n, *r in rec}
    for outer, inners in (("step.forward", ("step.augment", "model.frontend",
                                            "model.encoder", "kernel.sync_ce")),
                          ("model.frontend", ("kernel.bn_stats",))):
        for inner in inners:
            assert by[outer][1] <= by[inner][1] <= by[inner][2] <= by[outer][2]
    assert by["step.forward"][2] <= by["step.backward"][1] < by["step.update"][1]
    fwd = [r for r in rec if r[0] == "kernel.bn_stats"]
    assert all(by["model.frontend"][1] <= r[2] <= by["model.frontend"][2] for r in fwd)
    bwd = [r for r in rec if r[0] == "kernel.bn_stats.bwd"]
    assert all(by["step.backward"][1] <= r[2] <= by["step.backward"][2] for r in bwd)


def _reads(fn):
    before = host_read_counts()
    fn()
    after = host_read_counts()
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


@pytest.mark.parametrize("case", ["word", "word_skip_nonfinite", "sentence"])
def test_a_train_step_counts_its_host_reads_by_site(case):
    from syncvsr_tpu_torch.train import host_metrics

    if case == "sentence":
        state, step, batch = _sentence_state()
        expect = {"ops.image_aug": 1, "ops.ctc_loss": 1}
    else:
        skip = case == "word_skip_nonfinite"
        state, step, batch = _word_state({"optim.skip_nonfinite": skip})
        expect = {"engine.all_finite": 1} if skip else {}
    box = {}
    assert _reads(lambda: box.update(m=step(state, batch)[1])) == expect
    # the lagged read of the step's metrics: one a key but the host-made
    # learning_rate
    assert len(box["m"]) == 7 and "learning_rate" in box["m"]
    assert _reads(lambda: host_metrics(box["m"])) == {"train.host_metrics": 6}


def test_the_loader_wait_is_summed_and_every_batch_comes():
    from syncvsr_tpu_torch.train import waited

    def slow():
        for i in range(3):
            time.sleep(0.01)
            yield i

    seconds = [0.0]
    with spans() as rec:
        got = list(waited(slow(), seconds))
    assert got == [0, 1, 2]
    assert seconds[0] >= 0.03
    assert [r[0] for r in rec] == ["train.loader_wait"] * 4
    assert sum(r[3] - r[2] for r in rec) <= seconds[0] * 1e9 + 1e6

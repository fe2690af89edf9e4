"""PyTorch port: the train and evaluate CLIs (``syncvsr_tpu_torch.train``,
``.evaluate``) on the CPU (``device="cpu"``), against the JAX package's.
The driver end to end on synthetic data and its ``resume=auto``; the word
evaluation of one JAX-written checkpoint by both packages (equal metrics,
f32: 1e-5 relative, sums in other orders); the LM checkpoint formats. The
sentence decode modes on one JAX-written checkpoint are
``test_torch_cli_decode.py``'s, with this file's arguments and helpers."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from syncvsr_tpu import config as jcfg
from syncvsr_tpu import evaluate as jevaluate
from syncvsr_tpu.data.synthetic import word_batch
from syncvsr_tpu.engine import create_train_state as jax_create_train_state
from syncvsr_tpu.models import build_model as jax_build_model
from syncvsr_tpu.utils import checkpoint as jckpt
from syncvsr_tpu_torch import evaluate as tevaluate
from syncvsr_tpu_torch import train as ttrain
from syncvsr_tpu_torch.utils import checkpoint as tckpt
from torch_parity import JitInit
import torch_threads  # noqa: F401  (one torch thread a test process)

WORD_ARGS = [
    "preset=lrw_landmark", "model.encoder.layers=2", "model.encoder.dim=32",
    "model.encoder.heads=2", "model.frontend.input_features=12", "model.labels=11",
    "model.codec.audio_vocab_size=17", 'model.dtype="float32"', 'data.dataset="synthetic"',
    "data.batch_size=8", "data.num_frames=6"]
# tests/test_evaluate_cli.py's sentence model: a landmark frontend under
# the lrs3 stack, encoder and decoder 16 wide
SENT_ARGS = [
    "preset=lrs3", 'model.frontend.kind="landmark"',
    "model.frontend.input_features=8", "model.encoder.layers=1",
    "model.encoder.dim=16", "model.encoder.heads=2",
    "model.encoder.conv_kernel=7", "model.decoder.layers=1",
    "model.decoder.dim=16", "model.decoder.heads=2",
    "model.decoder.hidden=32", "model.labels=13",
    "model.codec.audio_vocab_size=11", 'model.dtype="float32"',
    'data.dataset="synthetic"', "data.batch_size=2"]


def test_train_end_to_end_and_resume(tmp_path):
    """As tests/test_train_driver.py holds the JAX driver: metrics.jsonl,
    best.msgpack and step checkpoints written; resume=auto goes on from
    the newest step; the driver's launch counts are 0 on the CPU."""
    ckpt_dir = tmp_path / "ckpt"
    args = WORD_ARGS + ["optim.total_steps=0", "optim.lr=1e-3", "train.epochs=1",
                        "train.log_every=4", "train.eval_every=8", "train.ckpt_every=8",
                        f"train.ckpt_dir={json.dumps(str(ckpt_dir))}"]
    final = ttrain.main(args, device="cpu")
    assert "val/loss" in final and np.isfinite(final["val/loss"])
    assert sorted(os.listdir(ckpt_dir)) == ["best.msgpack", "metrics.jsonl",
                                            "step_16.msgpack", "step_8.msgpack"]
    best = tckpt.load_msgpack(str(ckpt_dir / "best.msgpack"))
    assert set(best) == {"params", "batch_stats", "step", "acc1"} and best["step"] in (8, 16)
    records = [json.loads(line) for line in open(ckpt_dir / "metrics.jsonl")]
    train_logs = [r for r in records if "train/launches/sync_ce_fwd" in r]
    assert [r["step"] for r in train_logs] == [4, 8, 12, 16]
    assert all(r["train/launches/bn_stats_fwd"] == 0.0 for r in train_logs)
    assert all(np.isfinite(r["train/loss"]) for r in train_logs)
    # the lagged metrics' read, 6 keys a step (learning_rate is made on the
    # host) from the second step on
    assert [r["train/host_reads"] for r in train_logs] == [4.5, 6.0, 6.0, 6.0]
    assert all(r["train/loader_wait_ms"] >= 0.0 for r in train_logs)

    final2 = ttrain.main(args + ['train.resume="auto"'], device="cpu")
    assert np.isfinite(final2["val/loss"])
    assert tckpt.latest_checkpoint(str(ckpt_dir)) == str(ckpt_dir / "step_32.msgpack")
    records = [json.loads(line) for line in open(ckpt_dir / "metrics.jsonl")]
    assert [r["step"] for r in records if "train/launches/sync_ce_fwd" in r] == \
        [4, 8, 12, 16, 20, 24, 28, 32]


def test_train_pretrained_and_profile_window(tmp_path, capsys):
    """train.pretrained warm-starts every leaf of a checkpoint's params by
    intersection; train.profile_steps=a:b writes a torch.profiler trace,
    with the port's spans."""
    first = tmp_path / "first"
    args = WORD_ARGS + ["optim.total_steps=2", "train.log_every=1", "train.eval_every=100",
                        "train.ckpt_every=100"]
    ttrain.main(args + [f"train.ckpt_dir={json.dumps(str(first))}"], device="cpu")
    trace = tmp_path / "trace"
    ttrain.main(args + [f"train.ckpt_dir={json.dumps(str(tmp_path / 'second'))}",
                        f"train.pretrained={json.dumps(str(first / 'step_2.msgpack'))}",
                        'train.profile_steps="0:1"',
                        f"train.profile_dir={json.dumps(str(trace))}"], device="cpu")
    out = capsys.readouterr().out
    assert "[ckpt] loaded 41/41 params from pretrained tree" in out
    assert f"[trace] wrote {trace}" in out
    assert (trace / "trace.json").stat().st_size > 0 and (trace / "ops.txt").exists()
    # the window carries the step's spans as record_function ranges
    text = (trace / "trace.json").read_text()
    assert all(f'"{name}"' in text for name in ("step.forward", "step.backward",
                                                "step.update", "model.frontend"))


def test_train_raises_for_what_is_not_ported(tmp_path, monkeypatch):
    """A data, seq or model axis that does not fit the process group, and
    ``train.distributed`` without a launcher's environment, are errors (the
    multi-process driver is tests/test_torch_parallel.py's,
    tests/test_torch_tensor_parallel_cli.py's and
    tests/test_torch_seq_parallel_grid.py's). The Conv1D audio frontend on
    a waveform split over the seq ranks, which raised here before it was
    ported, is split at frame boundaries (its steps:
    tests/test_torch_seq_parallel_audio.py)."""
    import torch

    from syncvsr_tpu_torch.config import lrs3_audio_config
    from syncvsr_tpu_torch.data.synthetic import sentence_batch as t_sentence_batch
    from syncvsr_tpu_torch.models.frontend import Conv1DResNetFrontend
    from syncvsr_tpu_torch.parallel import Mesh, split_time

    acfg = lrs3_audio_config().override(**{"data.batch_size": 1})
    batch = {k: torch.from_numpy(v) for k, v in
             t_sentence_batch(acfg, num_frames=4, label_len=2).items()}
    seq2 = Mesh(size=2, rank=1, device=torch.device("cpu"), seq=2)
    frame = Conv1DResNetFrontend.frame
    part = split_time(seq2, batch, frame)   # a waveform of 4 * 640 samples splits by frames
    assert (part.time.start, part.time.length, part.time.total) == (2, 2, 4)
    assert torch.equal(part["videos"], batch["videos"][:, 2 * 640:4 * 640])
    tail = split_time(seq2, dict(batch, videos=torch.zeros(1, 4 * 640 + 100)), frame)
    assert tail.time.total == 4 and tail["videos"].shape[1] == 2 * 640
    odd = split_time(seq2, dict(batch, videos=torch.zeros(1, 3 * 640)), frame)
    assert odd.time is None and odd["videos"].shape[1] == 3 * 640
    cfg = ttrain.load_config(WORD_ARGS + [f"train.ckpt_dir={json.dumps(str(tmp_path))}"])
    for over, shape in (({"mesh.data": 2}, "2x1x1"), ({"mesh.model": 2}, "1x1x2"),
                        ({"mesh.seq": 2}, "1x2x1")):
        with pytest.raises(ValueError, match=f"mesh {shape} != 1 processes"):
            ttrain.train(cfg.override(**over), device="cpu")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR|RANK|WORLD_SIZE"):
        ttrain.train(cfg.override(**{"train.distributed": True}), device="cpu")
    assert ttrain.monitored_metric(cfg) == "acc1"
    assert ttrain.monitored_metric(ttrain.load_config(["preset=lrs3"])) == "decoder_acc"


def _jax_checkpoint(args, path, batch_fn, seed=0):
    """A JAX train state of the config ``args`` make, its params moved off
    their init by two updates with random gradients, saved as the train
    driver saves best.msgpack."""
    cfg = jcfg.PRESETS[args[0].split("=")[1]]().override(
        **jcfg.parse_cli_overrides(args[1:]))
    state = jax_create_train_state(cfg, JitInit(jax_build_model(cfg)),
                                   {k: jnp.asarray(v) for k, v in batch_fn(cfg).items()})
    rng = np.random.RandomState(seed)
    apply = jax.jit(lambda st, g: st.apply_gradients(grads=g))   # eager optax is slow
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)), state.params)
        state = apply(state, grads)
    jckpt.save_msgpack(str(path), {"params": jax.device_get(state.params),
                                   "batch_stats": jax.device_get(state.batch_stats or {}),
                                   "step": 2, "acc1": 0.5})
    return str(path)


def _run(main, args, monkeypatch, capsys, **kw):
    monkeypatch.setattr(sys, "argv", ["evaluate"] + args)
    main(**kw)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_word_evaluate_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    ckpt = _jax_checkpoint(WORD_ARGS, tmp_path / "best.msgpack", word_batch)
    args = WORD_ARGS + [f"ckpt={json.dumps(ckpt)}"]
    want = _run(jevaluate.main, args, monkeypatch, capsys)
    got = _run(tevaluate.main, args, monkeypatch, capsys, device="cpu")
    assert set(got) == set(want) and "test/acc1" in got and "test/acc5" in got
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k


def _hypotheses(main, args, monkeypatch, capsys, **kw):
    summary = _run(main, args, monkeypatch, capsys, **kw)
    with open("hypotheses.jsonl") as f:
        return summary, [json.loads(line) for line in f]


def test_lm_checkpoint_formats(tmp_path):
    """A torch (espnet) LM checkpoint is converted on load and must hold
    every leaf (a state dict without them raises); an RNN LM msgpack loads
    onto the seeded init by intersection."""
    import torch

    from syncvsr_tpu.models.lm import RNNLM
    from syncvsr_tpu.utils.torch_convert import convert_lm

    torch.save({"x": torch.zeros(1)}, tmp_path / "lm.pth")
    shape = {"layers": 1, "dim": 16, "heads": 1, "hidden": 16, "embed_dim": 16}
    with pytest.raises(KeyError):
        tevaluate.load_lm(str(tmp_path / "lm.pth"), "rnn", 13, shape, torch.device("cpu"))
    gen = torch.Generator().manual_seed(2)
    rnn_sd = {"encoder.weight": torch.randn(13, 16, generator=gen),
              "rnn.weight_ih_l0": torch.randn(64, 16, generator=gen),
              "rnn.weight_hh_l0": torch.randn(64, 16, generator=gen),
              "rnn.bias_ih_l0": torch.randn(64, generator=gen),
              "rnn.bias_hh_l0": torch.randn(64, generator=gen),
              "decoder.weight": torch.randn(13, 16, generator=gen),
              "decoder.bias": torch.randn(13, generator=gen)}
    torch.save({"state_dict": rnn_sd}, tmp_path / "rnn.pth")
    lm = tevaluate.load_lm(str(tmp_path / "rnn.pth"), "rnn", 13, shape, torch.device("cpu"))
    from syncvsr_tpu_torch.utils.bridge import to_flax

    want = convert_lm(rnn_sd, "rnn", 16, 1, 1)
    got = to_flax(lm.state_dict())[0]
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    jlm = RNNLM(vocab=13, layers=1, dim=16, embed_dim=16)
    params = jax.device_get(jlm.init(jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))
                            ["params"])
    jckpt.save_msgpack(str(tmp_path / "rnn.msgpack"), {"params": params})
    lm = tevaluate.load_lm(str(tmp_path / "rnn.msgpack"), "rnn", 13, shape,
                           torch.device("cpu"))
    got = to_flax(lm.state_dict())[0]
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


def test_sentence_transforms_pass_other_inputs_through():
    """The sentence augmentation and eval transform leave landmark [B, T, F]
    and waveform [B, S] inputs as they are, as the JAX package's do (the
    train driver hands them every sentence batch)."""
    import torch

    from syncvsr_tpu_torch import config as tcfg
    from syncvsr_tpu_torch.ops.image import build_sentence_aug, build_sentence_eval_transform

    data = tcfg.lrs3_config().data
    gen = torch.Generator().manual_seed(0)
    for videos in (torch.randn(2, 5, 8), torch.randn(2, 3200)):
        batch = {"videos": videos, "lengths": torch.tensor([5, 4])}
        assert build_sentence_aug(data)(gen, batch) is batch
        assert build_sentence_eval_transform(data)(batch) is batch

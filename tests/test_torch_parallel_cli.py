"""PyTorch port: the train and evaluate drivers over two gloo processes on
the CPU against one process (``python -m syncvsr_tpu_torch.train`` /
``.evaluate`` with a process group joined): rank 0 alone writes, the
metrics and checkpoints equal one process's, FSDP's checkpoint resumes at
one process, and the hypotheses come back in the loaders' order."""

import json
import os

import jax
import numpy as np
import pytest

from syncvsr_tpu_torch.utils import checkpoint as tckpt
from test_torch_parallel import _leaves
from torch_multiproc import cli, spawn
from torch_parity import close
import torch_threads  # noqa: F401  (one torch thread a test process)

# test_torch_cli.py's word model (landmarks: no augmentation on the device,
# CutMix on) and sentence model (a landmark frontend under the lrs3 stack)
WORD_ARGS = [
    "preset=lrw_landmark", "model.encoder.layers=2", "model.encoder.dim=32",
    "model.encoder.heads=2", "model.frontend.input_features=12", "model.labels=11",
    "model.codec.audio_vocab_size=17", 'model.dtype="float32"', 'data.dataset="synthetic"',
    "data.batch_size=8", "data.num_frames=6", "model.encoder.emb_dropout=0.0",
    "model.encoder.msa_dropout=0.0", "model.encoder.mlp_dropout=0.0",
    "model.encoder.droppath=0.0"]
SENT_ARGS = [
    "preset=lrs3", 'model.frontend.kind="landmark"', "model.frontend.input_features=8",
    "model.encoder.layers=1", "model.encoder.dim=16", "model.encoder.heads=2",
    "model.encoder.conv_kernel=7", "model.decoder.layers=1", "model.decoder.dim=16",
    "model.decoder.heads=2", "model.decoder.hidden=32", "model.labels=13",
    "model.codec.audio_vocab_size=11", 'model.dtype="float32"',
    'data.dataset="synthetic"', "data.batch_size=4"]


# seconds for the file's two-process group: 3x the most measured (10.8 s), at least 60
SPAWN_TIMEOUT = 60


def cli_job(module, args, cwd):
    """A driver run in ``cwd`` (made here), for ``torch_multiproc.cli``."""
    cwd.mkdir(parents=True, exist_ok=True)
    return {"kind": "cli", "module": module, "args": args, "cwd": str(cwd)}


def _cli(module, args, cwd):
    """The driver at one process, in this process; its summary."""
    return cli(cli_job(module, args, cwd))


def _train_args(fsdp):
    return WORD_ARGS + ["data.use_cutmix=false", "optim.total_steps=4", "optim.lr=1e-3",
                        "train.log_every=2", "train.eval_every=4", "train.ckpt_every=4",
                        f"mesh.fsdp={'true' if fsdp else 'false'}", "mesh.fsdp_min_size=256"]


@pytest.fixture(scope="module")
def two_rank_runs(tmp_path_factory):
    """Each case's driver run at one process (here) and over two processes
    (all four cases in one two-process group, one after the other): its
    directory and the two summaries."""
    dirs, one, jobs = {}, {}, []
    for name, fsdp in (("dp", False), ("fsdp", True)):
        d = dirs[name] = tmp_path_factory.mktemp(f"train_{name}")
        for world in ("one", "two"):
            job = cli_job("train", _train_args(fsdp)
                          + [f"train.ckpt_dir={json.dumps(str(d / world))}"], d / f"cwd_{world}")
            if world == "one":
                one[name] = cli(job)
            else:
                jobs.append(job)
    for mode in ("word", "greedy"):
        d = dirs[mode] = tmp_path_factory.mktemp(f"evaluate_{mode}")
        args = WORD_ARGS if mode == "word" else SENT_ARGS + ["decode=greedy"]
        one[mode] = _cli("evaluate", args, d / "one")
        jobs.append(cli_job("evaluate", args, d / "two"))
    two = spawn(jobs, 2, tmp_path_factory.mktemp("spawn"), timeout=SPAWN_TIMEOUT)
    return {name: (dirs[name], one[name], ranks[0]) for name, ranks in zip(dirs, two)}


@pytest.mark.parametrize("fsdp", [False, True], ids=["dp", "fsdp"])
def test_train_driver_two_ranks_matches_one(fsdp, two_rank_runs):
    """``python -m syncvsr_tpu_torch.train`` over two processes (gloo):
    rank 0 alone writes ``metrics.jsonl`` and the checkpoints; its eval
    metrics and its step checkpoint (gathered under FSDP) equal one
    process's on the same global batches (``tests/test_spmd.py``'s
    tolerances), and one process resumes from it. CutMix is off: the
    loaders give each rank strided rows, so the two runs' global batches
    hold the same clips in another order, and CutMix pairs each clip with
    its mirror in that order (the step tests above hold CutMix)."""
    tmp_path, *summaries = two_rank_runs["fsdp" if fsdp else "dp"]
    runs = dict(zip(("one", "two"), summaries))
    assert set(runs["one"]) == set(runs["two"])
    for k, v in runs["one"].items():
        close(runs["two"][k], v, 1e-5, 1e-6, k)
    assert sorted(os.listdir(tmp_path / "two")) == ["best.msgpack", "metrics.jsonl",
                                                    "step_4.msgpack"]
    logs = [(tmp_path / d / "metrics.jsonl").read_text().splitlines() for d in ("one", "two")]
    assert len(logs[0]) == len(logs[1]) == 5   # one writer: records at 2, 4, eval, tail, final
    one = tckpt.load_msgpack(str(tmp_path / "one" / "step_4.msgpack"))
    two = tckpt.load_msgpack(str(tmp_path / "two" / "step_4.msgpack"))
    for key in ("params", "opt_state"):
        for (path, a), b in zip(_leaves(one[key]), jax.tree_util.tree_leaves(two[key])):
            close(b, a, 1e-4, 1e-6, key + jax.tree_util.keystr(path))
    resumed = _cli("train", WORD_ARGS + [
        "optim.total_steps=6", "train.resume=auto", "train.eval_every=100",
        f"train.ckpt_dir={json.dumps(str(tmp_path / 'two'))}"], tmp_path / "cwd_resume")
    assert np.isfinite(resumed["val/loss"])
    assert "step_6.msgpack" in os.listdir(tmp_path / "two")


@pytest.mark.parametrize("mode", ["word", "greedy"])
def test_evaluate_two_ranks_matches_one(mode, two_rank_runs):
    """``python -m syncvsr_tpu_torch.evaluate`` over two processes: the
    word meter (global means, the global real-row count) and the greedy
    hypotheses (each rank's rows, gathered by rank 0 in the loader's order)
    equal one process's."""
    tmp_path, one, two = two_rank_runs[mode]
    assert set(one) == set(two)
    for k, v in one.items():
        if isinstance(v, float):
            close(two[k], v, 1e-5, 1e-6, k)
        else:
            assert two[k] == v, k
    if mode == "greedy":
        hyps = [(tmp_path / d / "hypotheses.jsonl").read_text() for d in ("one", "two")]
        assert hyps[0] == hyps[1] and hyps[0].count("\n") == 16

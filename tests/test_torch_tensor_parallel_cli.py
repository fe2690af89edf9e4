"""PyTorch port: ``python -m syncvsr_tpu_torch.train`` with ``mesh.model=2``
over two gloo processes on the CPU. As the JAX driver does, it places the
state by the rule only under ``mesh.fsdp`` (``shard_state``): without it
every rank holds the whole state and the model ranks repeat each other's
work; with it the leaves whose trailing dim is >= 512 are split over the
model ranks (here the FFN columns, the word head and the sync head, whose
512 columns are 8 slots of 64), and rank 0's checkpoint, gathered from
both, loads at one process bitwise. Both runs train the same global
batches to the same metrics and weights (``tests/test_spmd.py``'s
tolerances). ``evaluate`` at ``mesh.model=2`` equals one process."""

import json
import re

import jax
import numpy as np
import pytest
import torch

from syncvsr_tpu_torch.config import PRESETS, parse_cli_overrides
from syncvsr_tpu_torch.data.synthetic import word_batch
from syncvsr_tpu_torch.engine import create_train_state
from syncvsr_tpu_torch.models import build_model
from syncvsr_tpu_torch.parallel import Mesh, state_shardings
from syncvsr_tpu_torch.utils import checkpoint as tckpt
from test_torch_parallel import _leaves
from test_torch_parallel_cli import SENT_ARGS, WORD_ARGS, _cli, cli_job
from torch_multiproc import spawn
from torch_parity import close, tt
import torch_threads  # noqa: F401  (one torch thread a test process)

# test_torch_parallel_cli.py's landmark model with 512-wide FFNs, a
# 512-way word head and a 512-column sync head (the full-width rule's line)
ARGS = [
    "preset=lrw_landmark", "model.encoder.layers=2", "model.encoder.dim=32",
    "model.encoder.heads=2", "model.encoder.hidden=512", "model.frontend.input_features=12",
    "model.labels=512", "model.codec.audio_vocab_size=64", 'model.dtype="float32"',
    'data.dataset="synthetic"', "data.batch_size=8", "data.num_frames=6",
    "model.encoder.emb_dropout=0.0", "model.encoder.msa_dropout=0.0",
    "model.encoder.mlp_dropout=0.0", "model.encoder.droppath=0.0", "data.use_cutmix=false",
    "optim.total_steps=3", "optim.lr=1e-3", "train.log_every=3", "train.eval_every=3",
    "train.ckpt_every=3", "mesh.model=2"]


# seconds for the file's two-process group: 3x the most measured (8.2 s), at least 60
SPAWN_TIMEOUT = 60


@pytest.fixture(scope="module")
def two_rank_runs(tmp_path_factory):
    """Every two-process driver run of this file in one group, one after
    the other: the train driver at ``mesh.model=2`` without and with FSDP
    (rank 0's captured summaries and output, and their directory), and
    ``evaluate`` at ``mesh.model=2`` on the word and the greedy case (rank
    0's summary)."""
    train = tmp_path_factory.mktemp("train")
    jobs = []
    for name in ("whole", "split"):
        (train / name).mkdir()
        jobs.append({"kind": "cli", "module": "train", "capture": True, "cwd": str(train),
                     "args": ARGS + [f"mesh.fsdp={'true' if name == 'split' else 'false'}",
                                     f"train.ckpt_dir={json.dumps(str(train / name))}"]})
    evals = {}
    for mode in ("word", "greedy"):
        d = evals[mode] = tmp_path_factory.mktemp(f"evaluate_{mode}")
        args = WORD_ARGS if mode == "word" else SENT_ARGS + ["decode=greedy"]
        jobs.append(cli_job("evaluate", args + ["mesh.model=2"], d / "two"))
    whole, split, word, greedy = (ranks[0] for ranks in spawn(
        jobs, 2, tmp_path_factory.mktemp("spawn"), timeout=SPAWN_TIMEOUT))
    return {"train": (train, whole, split), "word": (evals["word"], word),
            "greedy": (evals["greedy"], greedy)}


def _held(stdout):
    m = re.search(r"params (\d+) B, Adam moments (\d+) B", stdout)
    return int(m.group(1)), int(m.group(2))


def test_train_driver_model_axis(two_rank_runs):
    tmp_path, whole, split = two_rank_runs["train"]
    over = parse_cli_overrides(ARGS)
    cfg = PRESETS[over.pop("preset")]().override(**over)
    batch = {k: tt(v) for k, v in word_batch(cfg).items()}
    state = create_train_state(cfg, build_model(cfg, device="cpu"), batch, device="cpu")
    n_bytes = sum(p.numel() * 4 for p in state.params)
    # the JAX CLI at mesh.model > 1 without fsdp keeps the state whole
    assert _held(whole["stdout"]) == (n_bytes, 2 * n_bytes)
    held = _held(split["stdout"])[0]
    specs = state_shardings(Mesh(size=2, rank=0, device=torch.device("cpu"), model=2), state)
    split_bytes = sum(p.numel() * 4 for n, p in zip(state.names, state.params)
                      if "model" in specs[n])
    assert split_bytes > 0.5 * n_bytes and held == n_bytes - split_bytes // 2
    for k, v in whole["summary"].items():
        close(split["summary"][k], v, 1e-5, 1e-6, k)
    path = tckpt.latest_checkpoint(str(tmp_path / "split"))
    want = tckpt.load_msgpack(str(tmp_path / "whole" / "step_3.msgpack"))
    got = tckpt.load_msgpack(path)
    for key in ("params", "opt_state"):
        for (p, a), b in zip(_leaves(want[key]), jax.tree_util.tree_leaves(got[key])):
            close(b, a, 1e-4, 1e-6, key + jax.tree_util.keystr(p))
    # the split run's checkpoint restores at one process, every leaf bitwise
    tckpt.restore_train_state(path, state)
    assert state.step == 3
    for key, tree in zip(("params", "opt_state"),
                         (tckpt.state_variables(state)[0],
                          tckpt.state_payload(state)["opt_state"])):
        for (p, a), b in zip(_leaves(got[key]), jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(np.asarray(b), a, err_msg=key + jax.tree_util.keystr(p))


@pytest.mark.parametrize("mode", ["word", "greedy"])
def test_evaluate_model_axis_matches_one(mode, two_rank_runs):
    """``python -m syncvsr_tpu_torch.evaluate`` with ``mesh.model=2`` over
    two processes: the weights stay whole on each rank and the rows split
    over the data axis (one index here), so the word meter and the greedy
    hypotheses equal one process's, written once."""
    args = WORD_ARGS if mode == "word" else SENT_ARGS + ["decode=greedy"]
    tmp_path, two = two_rank_runs[mode]
    one = _cli("evaluate", args, tmp_path / "one")
    assert set(one) == set(two)
    for k, v in one.items():
        if isinstance(v, float):
            close(two[k], v, 1e-5, 1e-6, k)
        else:
            assert two[k] == v, k
    if mode == "greedy":
        hyps = [(tmp_path / d / "hypotheses.jsonl").read_text() for d in ("one", "two")]
        assert hyps[0] == hyps[1] and hyps[0].count("\n") == 16

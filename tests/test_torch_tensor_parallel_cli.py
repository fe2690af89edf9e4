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
from test_torch_parallel_cli import SENT_ARGS, WORD_ARGS, _cli
from torch_multiproc import spawn
from torch_parity import close, tt

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


def _held(stdout):
    m = re.search(r"params (\d+) B, Adam moments (\d+) B", stdout)
    return int(m.group(1)), int(m.group(2))


def test_train_driver_model_axis(tmp_path):
    jobs = []
    for name in ("whole", "split"):
        (tmp_path / name).mkdir()
        jobs.append({"kind": "cli", "module": "train", "capture": True, "cwd": str(tmp_path),
                     "args": ARGS + [f"mesh.fsdp={'true' if name == 'split' else 'false'}",
                                     f"train.ckpt_dir={json.dumps(str(tmp_path / name))}"]})
    whole, split = (runs[0] for runs in spawn(jobs, 2, tmp_path))
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
def test_evaluate_model_axis_matches_one(mode, tmp_path):
    """``python -m syncvsr_tpu_torch.evaluate`` with ``mesh.model=2`` over
    two processes: the weights stay whole on each rank and the rows split
    over the data axis (one index here), so the word meter and the greedy
    hypotheses equal one process's, written once."""
    args = WORD_ARGS if mode == "word" else SENT_ARGS + ["decode=greedy"]
    one = _cli("evaluate", args, tmp_path / "one")
    two = _cli("evaluate", args + ["mesh.model=2"], tmp_path / "two", 2, tmp_path)
    assert set(one) == set(two)
    for k, v in one.items():
        if isinstance(v, float):
            close(two[k], v, 1e-5, 1e-6, k)
        else:
            assert two[k] == v, k
    if mode == "greedy":
        hyps = [(tmp_path / d / "hypotheses.jsonl").read_text() for d in ("one", "two")]
        assert hyps[0] == hyps[1] and hyps[0].count("\n") == 16

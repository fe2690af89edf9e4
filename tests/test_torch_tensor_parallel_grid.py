"""PyTorch port: tensor parallel against the JAX package's (data=1,
model=2) step, and the data x model grid with and without FSDP.

* The JAX step on ``jax.devices()[:2]`` with ``shard_state(min_dim=16)``
  on ``tests/test_word_model.py``'s ``tiny_landmark_config`` (dropout and
  CutMix off: torch cannot draw JAX's masks), against the port's two
  processes on bridged weights, at the single-device parity tests'
  tolerances (``test_torch_parallel.assert_jax_close``). This is the
  file's only JAX compile.
* Four processes on a (data=2, model=2) mesh, without and with FSDP, on
  the tiny ``lrw_video`` model with CutMix, zero-weight rows and masked
  sync slots, against the port's one-process step at
  ``tests/test_spmd.py``'s tolerances: every rank's gathered state is
  bitwise alike, some leaf carries both axes, and each rank holds exactly
  the bytes the specs predict."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.data.synthetic import word_batch
from syncvsr_tpu.engine import build_train_step as jax_build_train_step
from syncvsr_tpu.engine import create_train_state as jax_create_train_state
from syncvsr_tpu.models import build_model as jax_build_model
from syncvsr_tpu.parallel import create_mesh as jax_create_mesh
from syncvsr_tpu.parallel import shard_batch as jax_shard_batch
from syncvsr_tpu.parallel import shard_state as jax_shard_state
from syncvsr_tpu_torch import config as tcfg
from syncvsr_tpu_torch.models import build_model
from syncvsr_tpu_torch.parallel import Mesh, state_shardings
from syncvsr_tpu_torch.utils.bridge import to_flax
from test_torch_parallel import RATIO, START, WORD_METRICS, assert_jax_close, assert_ranks_equal
from test_torch_step import _adam_moments
from test_torch_tensor_parallel import _Shapes
from test_torch_tensor_parallel_models import MIN_DIM, assert_tp_close, word_case
from test_word_model import tiny_landmark_config
from torch_multiproc import spawn, train_steps
from torch_parity import JitInit, to_np
import torch_threads  # noqa: F401  (one torch thread a test process)

STEPS = 2
# seconds for the file's two-process group: 3x the most measured (9.2 s), at least 60
SPAWN_TIMEOUT = 60
# seconds for the file's four-process group: 3x the most measured (13.8 s), at least 60
GRID_TIMEOUT = 60
MIN_SIZE = 256   # the JAX package's tests' fsdp_min_size at toy widths
# torch cannot draw JAX's dropout masks or CutMix spans
NO_DRAWS = {"model.encoder.emb_dropout": 0.0, "model.encoder.msa_dropout": 0.0,
            "model.encoder.mlp_dropout": 0.0, "model.encoder.droppath": 0.0,
            "data.use_cutmix": False}
LANDMARK_METRICS = ("loss", "loss_word", "loss_audio", "acc1", "acc5", "learning_rate",
                    "grad_norm")


def _landmark_configs():
    cfg_j = tiny_landmark_config().override(**NO_DRAWS)
    cfg_t = tcfg.lrw_landmark_config().override(**{
        "model.encoder.layers": 2, "model.encoder.dim": 32, "model.encoder.heads": 2,
        "model.frontend.input_features": 12, "model.labels": 11,
        "model.codec.audio_vocab_size": 17, "model.dtype": "float32",
        "data.batch_size": 8, "data.num_frames": 6, "optim.total_steps": 100,
        "optim.warmup_steps": 10, **NO_DRAWS})
    assert cfg_t.to_dict() == cfg_j.to_dict()
    return cfg_j, cfg_t


def test_tensor_parallel_matches_jax_model_mesh_step(tmp_path):
    """The port's (data=1, model=2) steps on bridged weights equal the JAX
    package's steps on a (data=1, model=2) mesh with the state placed by
    ``shard_state(min_dim=16)``."""
    cfg_j, cfg_t = _landmark_configs()
    batch = word_batch(cfg_j)
    model = jax_build_model(cfg_j)
    state = jax_create_train_state(cfg_j, JitInit(model),
                                   {k: jnp.asarray(v) for k, v in batch.items()})
    params, stats = to_np(state.params), to_np(state.batch_stats)
    mesh = jax_create_mesh(data=1, model=2, devices=jax.devices()[:2])
    state = jax_shard_state(mesh, state, min_dim=MIN_DIM)
    assert any("model" in str(x.sharding.spec) for x in jax.tree_util.tree_leaves(state.params))
    step = jax_build_train_step(mesh, donate=False)
    metrics, first = [], None
    for i in range(STEPS):
        state, m = step(state, jax_shard_batch(mesh, batch))
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            mu, nu = _adam_moments(state.opt_state)
            first = {"params": to_np(state.params), "mu": to_np(mu), "nu": to_np(nu),
                     "batch_stats": to_np(state.batch_stats)}
    want = {"params": to_np(state.params), "metrics": metrics, "first": first}
    job = {"kind": "train", "config": cfg_t.to_dict(), "params": params,
           "batch_stats": stats, "batch": batch, "steps": STEPS, "model": 2,
           "min_dim": MIN_DIM}
    two = spawn(job, 2, tmp_path, timeout=SPAWN_TIMEOUT)
    lr_sum = sum(m["learning_rate"] for m in metrics)
    for out in two:
        assert_jax_close(out, want, LANDMARK_METRICS, lr_sum)
    assert two[0]["metrics"] == two[1]["metrics"]


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    """The tiny lrw_video word case at one process, and on four processes
    as (data=2, model=2), without and with FSDP, in one group."""
    cfg, batch, drawn = word_case()
    params, stats = to_flax(build_model(cfg, device="cpu").state_dict())
    job = {"kind": "train", "config": cfg.to_dict(), "params": params,
           "batch_stats": stats, "batch": batch, "steps": STEPS, "aug": drawn,
           "cutmix": (RATIO, START)}
    grid = dict(job, model=2, min_dim=MIN_DIM)
    tp, fsdp = spawn([grid, dict(grid, fsdp=MIN_SIZE)], 4, tmp_path_factory.mktemp("grid"),
                      timeout=GRID_TIMEOUT)
    return cfg, train_steps(job), {"tp": tp, "tp_fsdp": fsdp}


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "tp_fsdp"])
def test_grid_step_matches_one_process(grid_runs, fsdp):
    cfg, one, runs = grid_runs
    outs = runs["tp_fsdp" if fsdp else "tp"]
    for r in range(1, 4):
        assert_ranks_equal([outs[0], outs[r]])
    lr_sum = sum(m["learning_rate"] for m in one["metrics"])
    assert_tp_close(outs[0], one, WORD_METRICS, 1e-6, lr_sum)
    # the bytes each rank holds: a leaf's share is 1/2 per axis it splits on
    model = build_model(cfg, device="cpu")
    specs = state_shardings(Mesh(size=4, rank=0, device=torch.device("cpu"), model=2),
                            _Shapes(model), fsdp=fsdp, fsdp_min_size=MIN_SIZE,
                            min_dim=MIN_DIM)
    if fsdp:
        assert any("model" in s and "data" in s for s in specs.values())
    held = sum(p.numel() * 4 // (2 ** (("model" in specs[n]) + ("data" in specs[n])))
               for n, p in model.named_parameters())
    for out in outs:
        assert out["resident"] == {"params": held, "moments": 2 * held}
    whole = sum(p.numel() * 4 for p in model.parameters())
    assert held < (0.6 if fsdp else 0.9) * whole

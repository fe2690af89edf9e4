"""PyTorch port: sequence-parallel training of the sentence model, two gloo
processes on a (data=1, seq=2) mesh, each holding 8 of a clip's 16 frames.

* ``tests/test_sentence_model.py``'s ``tiny_sentence_config`` (landmark
  frontend, as ``tests/test_spmd.py``'s (data=4, seq=2) test uses it;
  dropout 0: torch cannot draw JAX's masks) against the JAX package's
  step on a (data=1, seq=2) mesh of two CPU devices, from bridged weights.
* The tiny ``lrs3`` model with a narrow Conv3D frontend (the stem's
  2-frame halo) and the Conformer's k = 31 depthwise conv (a 15-frame
  halo, wider than a rank's 8 frames), the augmentation's draws injected,
  against the port's one-process step (the state too), and its metrics
  against the JAX package's one-device step at the world-1 parity test's
  1e-4. (At 16 frames the port's one-process step itself differs from
  JAX's by up to 7.4e-5 in the stem's first moment, beyond
  ``tests/test_torch_sentence_step.py``'s tolerance at 10 frames: JAX's
  f32 rounding, which both packages' float64 steps show, ROADMAP.md §3.
  So the state is held to the port's one process, which the seq ranks
  match at ``tests/test_spmd.py``'s tolerances.)
* The same model with dropout and the port's own augmentation on, without
  and with ``model.remat``, against the port's one-process step: the seq
  ranks draw each mask and time mask at the whole clip's shape and keep
  their frames, so the draws are one process's.

The tolerances are otherwise ``tests/test_spmd.py``'s (each step's loss
and metrics rtol 1e-5; every parameter rtol 1e-4, atol 1e-5 against JAX,
atol 1e-6 against the port's one process, the moments and statistics
likewise); the two ranks end bitwise alike."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from syncvsr_tpu.data.synthetic import sentence_batch
from syncvsr_tpu.engine import build_train_step as jax_build_train_step
from syncvsr_tpu.engine import create_train_state as jax_create_train_state
from syncvsr_tpu.models import build_model as jax_build_model
from syncvsr_tpu.parallel import create_mesh as jax_create_mesh
from syncvsr_tpu.parallel import shard_batch as jax_shard_batch
from syncvsr_tpu_torch import config as tcfg
from test_sentence_model import tiny_sentence_config
from test_torch_parallel import AUG_KEY, SENTENCE_METRICS, _leaves, assert_ranks_equal
from test_torch_sentence_step import SRC, _jax_sentence_aug
from test_torch_step import _adam_moments
from torch_multiproc import spawn, train_steps
from torch_parity import JitInit, close, jax_aug_sample, sentence_configs, to_np

STEPS = 2
FRAMES = 16
NO_DROPOUT = {"model.encoder.mlp_dropout": 0.0, "model.encoder.msa_dropout": 0.0,
              "model.decoder.dropout": 0.0}


def jax_steps(cfg_j, batch, init, aug_fn=None, mesh=None, steps=STEPS):
    """``steps`` JAX train steps on ``mesh`` (None: one device); the initial
    variables as numpy trees and the state after the first and last step,
    as the port's workers report them."""
    state = jax_create_train_state(cfg_j, JitInit(jax_build_model(cfg_j)),
                                   {k: jnp.asarray(v) for k, v in init.items()})
    params, stats = to_np(state.params), to_np(state.batch_stats)
    step = jax_build_train_step(mesh, donate=False, aug_fn=aug_fn)

    def snapshot(state):
        mu, nu = _adam_moments(state.opt_state)
        return {"params": to_np(state.params), "mu": to_np(mu), "nu": to_np(nu),
                "batch_stats": to_np(state.batch_stats)}

    metrics, first = [], None
    for i in range(steps):
        placed = (jax_shard_batch(mesh, batch) if mesh is not None
                  else {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, placed)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            first = snapshot(state)
    return params, stats, dict(snapshot(state), metrics=metrics, first=first)


def assert_steps_close(got, want, metrics, atol):
    """``tests/test_spmd.py``'s tolerances: each step's metrics rtol 1e-5,
    every element of the params, statistics and moments after the first
    and the last step rtol 1e-4 and ``atol``."""
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k in metrics:
            close(g[k], w[k], 1e-5, 1e-7, f"step {i + 1} {k}")
    for when in ("first", None):
        g_all, w_all = (got, want) if when is None else (got[when], want[when])
        for key in ("params", "batch_stats", "mu", "nu"):
            leaves = _leaves(w_all[key])
            assert len(leaves) == len(jax.tree_util.tree_leaves(g_all[key]))
            for (path, w), g in zip(leaves, jax.tree_util.tree_leaves(g_all[key])):
                close(g, w, 1e-4, atol, f"{when or 'last'} {key}"
                      + jax.tree_util.keystr(path))


def _uint8_clips(cfg_t, seed=0):
    """A batch of 2 uint8 clips of 16 frames, the second 11 frames long."""
    batch = sentence_batch(cfg_t, num_frames=FRAMES, label_len=3, seed=seed)
    rng = np.random.RandomState(seed + 100)
    b = cfg_t.data.batch_size
    batch["videos"] = rng.randint(0, 256, (b, FRAMES, SRC, SRC, 1)).astype(np.uint8)
    batch["lengths"] = np.array([FRAMES, 11], np.int32)
    return batch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three cases' references, and their two-process runs in one
    group."""
    # landmark: JAX on a (data=1, seq=2) mesh
    cfg_lj = tiny_sentence_config(**NO_DROPOUT)
    cfg_lt = tcfg.Config.from_dict(cfg_lj.to_dict())
    lm_batch = sentence_batch(cfg_lj, num_frames=FRAMES, label_len=5)
    mesh = jax_create_mesh(data=1, seq=2, devices=jax.devices()[:2])
    params, stats, want_lm = jax_steps(cfg_lj, lm_batch, lm_batch, mesh=mesh)
    lm_job = {"kind": "train", "config": cfg_lt.to_dict(), "params": params,
              "batch_stats": stats, "batch": lm_batch, "steps": STEPS, "seq": 2}

    # conv3d: JAX on one device, the augmentation's draws injected (f32 clips)
    cfg_vj, cfg_vt = sentence_configs(**{"optim.lr": 1e-4})
    batch = _uint8_clips(cfg_vj)
    b, t, h, w, _ = batch["videos"].shape
    drawn = {k: v.numpy() for k, v in jax_aug_sample(
        AUG_KEY, b, t, h, w, cfg_vt.data, sentence=True, lengths=batch["lengths"]).items()}
    s = cfg_vj.data.crop_size
    init = dict(batch, videos=np.zeros((b, t, s, s, 1), np.float32))
    params, stats, want_video = jax_steps(
        cfg_vj, batch, init, _jax_sentence_aug(cfg_vj.data, AUG_KEY, jnp.float32))
    video_job = {"kind": "train", "config": cfg_vt.to_dict(), "params": params,
                 "batch_stats": stats, "batch": batch, "steps": STEPS, "aug": drawn,
                 "aug_dtype": "float32", "seq": 2}

    one_video = train_steps(video_job)

    # conv3d with dropout and the port's augmentation: against one process
    _, cfg_dt = sentence_configs(**{"optim.lr": 1e-4, "model.encoder.mlp_dropout": 0.1,
                                    "model.encoder.msa_dropout": 0.1,
                                    "model.decoder.dropout": 0.1})
    draws_job = dict(video_job, config=cfg_dt.to_dict(), aug=None, port_aug=True)
    one = train_steps(draws_job)
    # and under model.remat: the recompute replays the frames' collectives
    remat_job = dict(draws_job, config=cfg_dt.override(**{"model.remat": True}).to_dict())
    one_remat = train_steps(remat_job)

    two = spawn([lm_job, video_job, draws_job, remat_job], 2,
                tmp_path_factory.mktemp("seq_sentence"))
    return {"landmark": (want_lm, two[0]), "conv3d": (want_video, one_video, two[1]),
            "draws": (one, two[2]), "remat": (one_remat, two[3])}


def test_seq_step_matches_jax_seq_mesh(runs):
    want, two = runs["landmark"]
    assert_ranks_equal(two)
    assert_steps_close(two[0], want, SENTENCE_METRICS, 1e-5)


def test_conv3d_seq_step_matches_one_process_and_jax(runs):
    want, one, two = runs["conv3d"]
    assert_ranks_equal(two)
    assert_steps_close(two[0], one, SENTENCE_METRICS, 1e-6)
    for i, (g, w) in enumerate(zip(two[0]["metrics"], want["metrics"])):
        for k in SENTENCE_METRICS:
            close(g[k], w[k], 1e-3 if i and k == "grad_norm" else 1e-4, 1e-7,
                  f"step {i + 1} {k}")


@pytest.mark.parametrize("case", ["draws", "remat"])
def test_seq_step_draws_as_one_process(runs, case):
    """Dropout on the Conformer's frames, its position table and the
    decoder, the crop, flip and time masks: the same draws as one
    process; with ``model.remat`` too (its recompute re-enters the
    time-split region: the halos, K/V gathers and BatchNorm sums again)."""
    one, two = runs[case]
    assert_ranks_equal(two)
    assert two[0]["dropout_draw"] == one["dropout_draw"]
    assert_steps_close(two[0], one, SENTENCE_METRICS, 1e-6)

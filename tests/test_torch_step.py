"""PyTorch port: the lrw_video train step (augmentation, forward, backward,
clipped AdamW, BatchNorm running stats) against the JAX package's, from
bridged weights, on the CPU. f32, dropout 0, CutMix off; the augmentation's
draws come from one fixed JAX key and are injected into the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.engine import build_train_step as jax_build_train_step
from syncvsr_tpu.engine import create_train_state as jax_create_train_state
from syncvsr_tpu.models import build_model as jax_build_model
from syncvsr_tpu.ops.image import fused_train_aug
from syncvsr_tpu_torch.engine import build_eval_step, build_train_step, create_train_state
from syncvsr_tpu_torch.ops.image import batch_hook, fused_train_aug_apply
from syncvsr_tpu_torch.utils.bridge import to_flax
from torch_parity import (
    JitInit,
    close,
    configs,
    jax_aug_sample,
    to_np,
    torch_model,
    tt,
    uint8_batch,
)
import torch_threads  # noqa: F401  (one torch thread a test process)

AUG_KEY = jax.random.PRNGKey(7)
METRICS = ("loss", "loss_word", "loss_audio", "learning_rate", "grad_norm")


def _adam_moments(opt_state):
    """The (mu, nu) trees of the ScaleByAdamState inside the optax chain."""
    for node in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda n: hasattr(n, "mu") and hasattr(n, "nu")):
        if hasattr(node, "mu"):
            return node.mu, node.nu
    raise AssertionError("no Adam state")


@pytest.fixture(scope="module")
def runs():
    """Three steps in each framework; snapshots after steps 1 and 3."""
    cfg_j, cfg_t = configs()
    batch = uint8_batch(cfg_t)
    b, t, h, w, _ = batch["inputs"].shape
    d = cfg_j.data

    def jax_aug(rng, bt):  # the fixed key replaces the step's aug stream
        return dict(bt, inputs=fused_train_aug(
            AUG_KEY, bt["inputs"], d.crop_size, d.rrc_scale, hflip_prob=d.hflip_prob,
            time_mask_span=d.time_mask_window, time_mask_n=d.time_mask_stride,
            mean=d.mean, std=d.std))

    drawn = jax_aug_sample(AUG_KEY, b, t, h, w, cfg_t.data)

    def torch_aug(gen, bt):
        return dict(bt, inputs=fused_train_aug_apply(
            bt["inputs"], drawn, cfg_t.data.crop_size, cfg_t.data.mean, cfg_t.data.std))

    model_j = jax_build_model(cfg_j)
    init = dict(batch, inputs=np.zeros((b, t, h, h, 1), np.float32))
    state_j = jax_create_train_state(cfg_j, JitInit(model_j),
                                     {k: jnp.asarray(v) for k, v in init.items()})
    model = torch_model(cfg_t, to_np(state_j.params), to_np(state_j.batch_stats))
    state = create_train_state(cfg_t, model, batch, device="cpu")

    step_j = jax_build_train_step(donate=False, aug_fn=jax_aug)
    step = build_train_step(aug_fn=batch_hook(lambda bt: torch_aug(None, bt)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: tt(v) for k, v in batch.items()}
    snaps, lr_sum = {}, 0.0
    for i in range(1, 4):
        state_j, m_j = step_j(state_j, jb)
        state, m = step(state, tb)
        lr_sum += float(m_j["learning_rate"])
        if i in (1, 3):
            mu_j, nu_j = _adam_moments(state_j.opt_state)
            snaps[i] = {
                "jax": {"params": to_np(state_j.params), "mu": to_np(mu_j),
                        "nu": to_np(nu_j), "batch_stats": to_np(state_j.batch_stats),
                        "metrics": {k: float(m_j[k]) for k in METRICS}},
                "torch": {
                    "params": to_flax(model.state_dict())[0],
                    "mu": to_flax(dict(zip(state.names, state.mu)))[0],
                    "nu": to_flax(dict(zip(state.names, state.nu)))[0],
                    "batch_stats": to_flax(model.state_dict())[1],
                    "metrics": {k: float(m[k]) for k in METRICS}},
                "lr_sum": lr_sum,
            }
    eval_out = build_eval_step()(state, dict(tb, inputs=torch.zeros(b, t, h, h, 1)))
    return snaps, eval_out


def _compare(got, want, rtol, atol_rel, what):
    pairs = zip(jax.tree_util.tree_leaves_with_path(want), jax.tree_util.tree_leaves(got))
    n = 0
    for (path, w), g in pairs:
        scale = float(np.abs(w).max())
        close(g, w, rtol, atol_rel * scale + 1e-12, what + jax.tree_util.keystr(path))
        n += 1
    assert n == len(jax.tree_util.tree_leaves(want))


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(runs, n_steps):
    """Params, Adam moments and batch_stats to a small share of each leaf's
    scale. f32 sums taken in other orders through 20 BatchNorm backwards
    (whose per-channel sums of g nearly cancel) leave gradient noise of
    ~1.5e-4 of a leaf's largest element after one step; after three, the
    parameters of near-zero gradients have drifted apart by up to the
    learning rate (below), which adds to it. ``nu`` squares the gradient,
    doubling the relative noise."""
    snap = runs[0][n_steps]
    j, t = snap["jax"], snap["torch"]
    for k in METRICS:
        close(t["metrics"][k], j["metrics"][k], 1e-4, 1e-7, k)
    _compare(t["batch_stats"], j["batch_stats"], 1e-4, 1e-5, "batch_stats")
    _compare(t["mu"], j["mu"], 1e-3, 5e-4, "mu")
    _compare(t["nu"], j["nu"], 1e-3, 1e-3, "nu")
    # an element whose gradient sits at the noise floor of the two f32
    # reductions (|g| ~ 1e-8) gets an Adam update of either sign, up to the
    # learning rate: allow 5% of the summed rates on top of 1e-4 of the scale
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(j["params"]),
                            jax.tree_util.tree_leaves(t["params"])):
        close(g, w, 1e-4, 1e-4 * float(np.abs(w).max()) + 0.05 * snap["lr_sum"],
              "params" + jax.tree_util.keystr(path))


def test_schedule_moves_and_eval_runs(runs):
    snaps, eval_out = runs
    # warmup 2 of 10 steps: step 1 uses init_lr, step 3 the peak lr
    assert snaps[1]["torch"]["metrics"]["learning_rate"] == pytest.approx(1e-6, rel=1e-6)
    assert snaps[3]["torch"]["metrics"]["learning_rate"] == pytest.approx(1e-4, rel=1e-6)
    assert all(np.isfinite(float(v)) for v in eval_out.values())
    assert "_slots" in eval_out

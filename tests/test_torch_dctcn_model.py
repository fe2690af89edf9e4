"""PyTorch port: the ``lrw_dctcn`` model (a tiny DC-TCN under TINY's
frontend) against the JAX package, on the CPU, from bridged weights: its
eval step (masked mean pooling), its train step with batch mixup at an
injected lambda (params and Adam moments), and the bridge over its new
leaves. f32; dropout 0 on both sides. The layer tests and the shared
helpers are ``test_torch_dctcn.py``'s (the two files are one file split in
two, so that ``--dist loadfile`` can put them on different workers)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import syncvsr_tpu.models.word as jword
from syncvsr_tpu.engine import build_train_step as jax_build_train_step
from syncvsr_tpu.engine import create_train_state as jax_create_train_state
from syncvsr_tpu.models import build_model as jax_build_model
from syncvsr_tpu.models import dense_tcn as jdt
from syncvsr_tpu_torch.engine import build_eval_step, build_train_step, create_train_state
from syncvsr_tpu_torch.models import dense_tcn as tdt
from syncvsr_tpu_torch.models import word as tword
from syncvsr_tpu_torch.utils.bridge import to_flax
from test_torch_dctcn import (
    LAM,
    METRICS,
    _batch,
    _compare_split,
    _fixed_mixup,
    _no_dropout,
    _zero_gradient,
    dctcn_configs,
)
from test_torch_step import _adam_moments, _compare
from torch_parity import JitInit, close, to_np, torch_model, tt
import torch_threads  # noqa: F401  (one torch thread a test process)


@pytest.fixture(scope="module")
def pair():
    """The tiny lrw_dctcn model in both packages, the same weights; the JAX
    DC-TCN's dropout (fixed at 0.2 there) is 0 here, and so is the port's."""
    cfg_j, cfg_t = dctcn_configs()
    batch = _batch(cfg_t)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jword, "DenseTCN", functools.partial(jdt.DenseTCN, dropout=0.0))
        mp.setattr(jword, "batch_mixup", _fixed_mixup)
        model_j = jax_build_model(cfg_j)
        state_j = jax_create_train_state(cfg_j, JitInit(model_j),
                                         {k: jnp.asarray(v) for k, v in batch.items()})
        params, stats = to_np(state_j.params), to_np(state_j.batch_stats)
        step_j = jax_build_train_step(donate=False)
        state_j, m_j = step_j(state_j, {k: jnp.asarray(v) for k, v in batch.items()})
        mu_j, nu_j = _adam_moments(state_j.opt_state)
        after = {"params": to_np(state_j.params), "mu": to_np(mu_j), "nu": to_np(nu_j),
                 "batch_stats": to_np(state_j.batch_stats),
                 "metrics": {k: float(m_j[k]) for k in METRICS}}
        out_j = jax.jit(lambda v, b: model_j.apply(v, **b, det=True))(
            {"params": params, "batch_stats": stats},
            {k: jnp.asarray(v) for k, v in batch.items()})
    return cfg_t, batch, params, stats, after, {k: float(v) for k, v in out_j.items()}



def test_dctcn_model_eval_matches_jax(pair):
    """Every output key of the eval step (mean pooling under the ragged
    attention_mask, the sync slots' count): f32, 1e-5 relative."""
    cfg_t, batch, params, stats, _, out_j = pair
    model = torch_model(cfg_t, params, stats)
    assert isinstance(model.encoder, tdt.DenseTCN) and not hasattr(model, "cls_token")
    state = create_train_state(cfg_t, model, batch, device="cpu")
    out = build_eval_step()(state, {k: tt(v) for k, v in batch.items()})
    assert set(out) == set(out_j)
    for k in out_j:
        close(out[k], out_j[k], 1e-5, 1e-6, k)
    # the mask matters: clip 2's padded frames do not enter its pooled mean
    full = dict(batch, attention_mask=np.ones_like(batch["attention_mask"]))
    out_full = build_eval_step()(state, {k: tt(v) for k, v in full.items()})
    assert abs(float(out_full["loss_word"]) - float(out["loss_word"])) > 1e-6


def test_dctcn_train_step_matches_jax(pair, monkeypatch):
    """One train step with the mixup weight injected on both sides (so both
    losses are lerped and the sync head runs twice): metrics, batch_stats,
    Adam moments and params, with test_torch_step's tolerances. The conv
    biases whose true gradient is 0 hold noise under 1e-6 of the largest
    Adam moment (the audio step test's bound), and Adam turns that noise
    into an update of either sign up to the rate: their params are held to
    2x the rate."""
    cfg_t, batch, params, stats, after, _ = pair
    monkeypatch.setattr(tword, "sample_mixup", lambda gen, alpha: torch.tensor(LAM))
    model = _no_dropout(torch_model(cfg_t, params, stats))
    state = create_train_state(cfg_t, model, batch, device="cpu")
    state, m = build_train_step()(state, {k: tt(v) for k, v in batch.items()})
    for k in METRICS:
        close(float(m[k]), after["metrics"][k], 1e-4, 1e-7, k)
    sd = model.state_dict()
    _compare(to_flax(sd)[1], after["batch_stats"], 1e-4, 1e-5, "batch_stats")
    assert _compare_split(to_flax(dict(zip(state.names, state.mu)))[0], after["mu"], 1e-3,
                          5e-4, 1e-6, "mu") > 0
    _compare_split(to_flax(dict(zip(state.names, state.nu)))[0], after["nu"], 1e-3, 1e-3,
                   1e-6, "nu")
    lr = after["metrics"]["learning_rate"]
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(after["params"]),
                            jax.tree_util.tree_leaves(to_flax(sd)[0])):
        extra = 2 * lr if _zero_gradient(path) else 0.05 * lr
        close(g, w, 1e-4, 1e-4 * float(np.abs(w).max()) + extra,
              "params" + jax.tree_util.keystr(path))


def test_dctcn_bridge_round_trip(pair):
    """flax -> torch -> flax is bitwise and total over every new leaf: the
    1-D conv kernels ([k, in, out]), SELayer1D's Dense_0/Dense_1 and the
    flax BatchNorms' scale, bias, mean and var."""
    cfg_t, _, params, stats, _, _ = pair
    model = torch_model(cfg_t, params, stats)
    back, back_stats = to_flax(model.state_dict())
    for tree, got in ((params, back), (stats, back_stats)):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(tree)
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    enc = params["encoder"]
    assert enc["block0_layer0"]["conv0_2"]["conv"]["kernel"].shape == (7, 16, 4)
    assert model.encoder.block0_layer0.conv0_2.conv.weight.shape == (4, 16, 7)
    assert set(enc["block0_layer0"]["se_0"]) == {"Dense_0", "Dense_1"}
    assert set(stats["encoder"]["final_bn"]) == {"mean", "var"}

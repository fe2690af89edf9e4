"""PyTorch port: the lrw_landmark word model against the JAX package, on the
CPU, from bridged weights: the LayerNorm + plain-GELU transformer, the
landmark frontend, the -100 pad sentinel, every output key, three train
steps (params and Adam moments) and the bridge round trip. f32, dropout and
drop-path 0, CutMix off."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.engine import build_train_step as jax_build_train_step
from syncvsr_tpu.engine import create_train_state as jax_create_train_state
from syncvsr_tpu.models import build_model as jax_build_model
from syncvsr_tpu.models import layers as jl
from syncvsr_tpu.models.frontend import LandmarkFrontend as JaxLandmarkFrontend
from syncvsr_tpu.models.transformer import TransformerEncoder as JaxEncoder
from syncvsr_tpu_torch.data.synthetic import word_batch
from syncvsr_tpu_torch.engine import build_eval_step, build_train_step, create_train_state
from syncvsr_tpu_torch.models import build_model
from syncvsr_tpu_torch.models import layers as tl
from syncvsr_tpu_torch.models.frontend import LandmarkFrontend
from syncvsr_tpu_torch.models.transformer import TransformerEncoder
from syncvsr_tpu_torch.utils.bridge import to_flax
from test_torch_layers import _init, _load, _x
from test_torch_step import _adam_moments, _compare
from torch_parity import JitInit, close, landmark_configs, to_np, torch_model, tt
import torch_threads  # noqa: F401  (one torch thread a test process)

KEYS = ("loss", "loss_word", "loss_audio", "acc1", "acc5")
METRICS = ("loss", "loss_word", "loss_audio", "learning_rate", "grad_norm")
LR = 1e-4   # the step tests' rate (test_torch_sentence_step gives the reason)


def _padded_batch(cfg_t, seed=0):
    """word_batch with the loader's padding: the last frames of clip 1 are
    the -100 sentinel in every feature, and some sync slots are ignored."""
    batch = word_batch(cfg_t, seed=seed)
    batch["inputs"][1, -2:] = -100.0
    batch["audio_tokens"][0, :3] = -1
    return batch


# f32 against f32 through two pre-norm blocks: ~1e-6 relative
def test_plain_feed_forward_matches_jax():
    x = _x((2, 5, 33), 2)
    mod = jl.FeedForward(dim=33, hidden=48, use_glu=False)
    params = _init(mod, jnp.asarray(x))
    assert set(params) == {"wi", "wo"}
    y_j = mod.apply({"params": params}, jnp.asarray(x))
    y = _load(tl.FeedForward(33, 48, use_glu=False), params)(tt(x))
    close(y, y_j, 1e-5, 1e-6)


def test_layernorm_gelu_encoder_matches_jax():
    x = _x((2, 9, 64), 8)
    mod = JaxEncoder(layers=2, dim=64, heads=2, hidden=256, use_rmsnorm=False,
                     use_glu=False, rope=True)
    params = _init(mod, jnp.asarray(x))
    y_j = jax.jit(functools.partial(mod.apply, det=True))({"params": params}, jnp.asarray(x))
    enc = _load(TransformerEncoder(64, 2, 64, 2, 256, use_rmsnorm=False, use_glu=False),
                params)
    assert not hasattr(enc, "RMSNorm_0") and not hasattr(enc.block_0.ff, "wi_gate")
    y = enc(tt(x), det=True)
    assert y.shape == (2, 9, 64)
    close(y, y_j, 2e-5, 2e-5)


def test_landmark_frontend_matches_jax():
    x = _x((2, 4, 1434), 3)
    mod = JaxLandmarkFrontend(dim=64)
    params = _init(mod, jnp.asarray(x))
    y_j = mod.apply({"params": params}, jnp.asarray(x))
    y = _load(LandmarkFrontend(1434, 64), params)(tt(x))
    close(y, y_j, 1e-5, 1e-5)


@pytest.fixture(scope="module")
def pair():
    """The tiny lrw_landmark model in both packages, the same weights."""
    cfg_j, cfg_t = landmark_configs(**{"optim.lr": LR})
    batch = _padded_batch(cfg_t)
    model_j = jax_build_model(cfg_j)
    state_j = jax_create_train_state(cfg_j, JitInit(model_j),
                                     {k: jnp.asarray(v) for k, v in batch.items()})
    params, stats = to_np(state_j.params), to_np(state_j.batch_stats)
    return cfg_j, cfg_t, batch, model_j, state_j, params, stats


def _eval_both(pair, batch):
    _, cfg_t, _, model_j, _, params, stats = pair
    out_j = jax.jit(lambda v, b: model_j.apply(v, **b, det=True))(
        {"params": params, "batch_stats": stats}, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        out = torch_model(cfg_t, params, stats)(**{k: tt(v) for k, v in batch.items()},
                                                det=True)
    return out, out_j


def test_landmark_model_eval_matches_jax(pair):
    batch = dict(pair[2], sample_weight=np.array([1.0, 0.0], np.float32))
    out, out_j = _eval_both(pair, batch)
    assert set(out) == set(out_j)
    for k in out_j:
        close(out[k], out_j[k], 1e-5, 1e-6, k)


def test_landmark_pad_sentinel_matches_jax(pair):
    """Frames padded with -100 enter the model as zeros, as in the JAX
    package: the outputs equal those of the same batch with the padding
    zeroed by hand, and JAX's."""
    batch = pair[2]
    assert (batch["inputs"] == -100.0).sum() == 2 * 1434
    out, out_j = _eval_both(pair, batch)
    zeroed, _ = _eval_both(pair, dict(batch, inputs=np.where(batch["inputs"] == -100.0, 0.0,
                                                             batch["inputs"])))
    for k in KEYS + ("_slots",):
        close(out[k], out_j[k], 1e-5, 1e-6, k)
        close(out[k], zeroed[k].numpy(), 0, 0, k)


@pytest.fixture(scope="module")
def runs(pair):
    """Three steps in each framework; snapshots after steps 1 and 3."""
    cfg_j, cfg_t, batch, _, state_j, params, stats = pair
    model = torch_model(cfg_t, params, stats)
    state = create_train_state(cfg_t, model, batch, device="cpu")
    step_j = jax_build_train_step(donate=False)
    step = build_train_step()
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
                        "nu": to_np(nu_j), "metrics": {k: float(m_j[k]) for k in METRICS}},
                "torch": {"params": to_flax(model.state_dict())[0],
                          "mu": to_flax(dict(zip(state.names, state.mu)))[0],
                          "nu": to_flax(dict(zip(state.names, state.nu)))[0],
                          "metrics": {k: float(m[k]) for k in METRICS}},
                "lr_sum": lr_sum,
            }
    return snaps, build_eval_step()(state, tb)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_landmark_train_steps_match_jax(runs, n_steps):
    """Metrics, Adam moments and params with test_torch_step's tolerances:
    f32 sums in other orders give ~1e-6 relative gradient noise here (no
    BatchNorm), well inside them."""
    snap = runs[0][n_steps]
    j, t = snap["jax"], snap["torch"]
    for k in METRICS:
        close(t["metrics"][k], j["metrics"][k], 1e-4, 1e-7, k)
    _compare(t["mu"], j["mu"], 1e-3, 5e-4, "mu")
    _compare(t["nu"], j["nu"], 1e-3, 1e-3, "nu")
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(j["params"]),
                            jax.tree_util.tree_leaves(t["params"])):
        close(g, w, 1e-4, 1e-4 * float(np.abs(w).max()) + 0.05 * snap["lr_sum"],
              "params" + jax.tree_util.keystr(path))


def test_landmark_eval_after_steps(runs):
    snaps, eval_out = runs
    assert snaps[1]["torch"]["metrics"]["learning_rate"] == pytest.approx(1e-6, rel=1e-6)
    assert snaps[3]["torch"]["metrics"]["learning_rate"] == pytest.approx(LR, rel=1e-6)
    assert all(np.isfinite(float(v)) for v in eval_out.values())
    assert "_slots" in eval_out


def test_landmark_bridge_round_trip(pair):
    """flax -> torch -> flax is bitwise, total, and decays exactly the flax
    leaves named ``kernel``."""
    _, cfg_t, _, _, _, params, stats = pair
    model = torch_model(cfg_t, params, stats)
    back, back_stats = to_flax(model.state_dict())
    assert back_stats == {} and jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    assert "encoder.LayerNorm_0.LayerNorm_0.weight" in model.state_dict()
    assert not hasattr(model, "frontend_proj")


def test_landmark_preset_builds_at_full_width():
    """build_model takes lrw_landmark_config() as it is (8 x 320, 4 heads,
    LayerNorm, GELU, bf16) on the CPU when asked, and the stream is 320 wide."""
    from syncvsr_tpu_torch.config import lrw_landmark_config

    cfg = lrw_landmark_config()
    model = build_model(cfg, device="cpu")
    assert model.frontend.wte.weight.shape == (320, 1434)
    assert model.cls_token.shape == (1, 1, 320)
    assert model.encoder.layers == 8 and hasattr(model.encoder, "LayerNorm_0")
    assert model.audio_classifier.weight.shape == (8 * 320, 320)


@pytest.mark.parametrize("n", [300, 37])
def test_k1_plain_matches_pallas_interpret_at_d320(n):
    """K1's plain version at the landmark head's D = 320 (f32 features),
    against the Pallas kernel in interpret mode: the same bf16 operands and
    f32 accumulation, the sums in other orders: 2e-6 relative, the count
    exact."""
    from syncvsr_tpu.ops.pallas_sync import _pallas_forward
    from syncvsr_tpu_torch.ops.cuda_sync import sync_ce_partials_plain, uses_split_kernel

    rng = np.random.RandomState(5)
    d, s, v = 320, 8, 320
    assert not uses_split_kernel(d, s, v)
    x = rng.randn(n, d).astype(np.float32)
    w = (rng.randn(d, s * v) * 0.05).astype(np.float32)
    b = (rng.randn(s * v) * 0.1).astype(np.float32)
    tok = rng.randint(0, v, (n, s)).astype(np.int32)
    tok[rng.rand(n, s) < 0.15] = -1
    ce, cnt = sync_ce_partials_plain(tt(x), tt(w), tt(b), tt(tok))
    jce, jcnt = _pallas_forward(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                jnp.asarray(tok), s, v, interpret=True)
    assert float(cnt) == float(jcnt) == float((tok >= 0).sum())
    close(ce, jce, 2e-6, 0.0, "ce_sum")

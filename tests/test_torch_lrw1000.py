"""PyTorch port: the lrw1000 word model against the JAX package, on the CPU,
from bridged weights: the wav2vec2 codec's A = 2 token rows a frame of G = 2
groups over V = 640 (the sync head's plain path, and K1's plain version at
lrw1000's head), no word boundary, every output key of the eval step and
two train steps (params and Adam moments). f32, dropout and CutMix off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from syncvsr_tpu import config as jcfg
from syncvsr_tpu.engine import build_train_step as jax_build_train_step
from syncvsr_tpu.engine import create_train_state as jax_create_train_state
from syncvsr_tpu.models import build_model as jax_build_model
from syncvsr_tpu.ops.sync_loss import sync_cross_entropy as jax_sync_ce
from syncvsr_tpu_torch import config as tcfg
from syncvsr_tpu_torch.data.synthetic import word_batch
from syncvsr_tpu_torch.engine import build_eval_step, build_train_step, create_train_state
from syncvsr_tpu_torch.ops.sync_loss import regroup_tokens, sync_cross_entropy
from syncvsr_tpu_torch.utils.bridge import to_flax
from test_torch_step import _adam_moments, _compare
from torch_parity import TINY, JitInit, close, to_np, torch_model, tt
import torch_threads  # noqa: F401  (one torch thread a test process)

METRICS = ("loss", "loss_word", "loss_audio", "learning_rate", "grad_norm")
# TINY's widths, but the preset's codec (640 tokens) and 6 frames
OVER = dict(TINY, **{"model.codec.audio_vocab_size": 640, "data.num_frames": 6,
                     "optim.lr": 1e-4})


def lrw1000_configs():
    return (jcfg.lrw1000_config().override(**OVER), tcfg.lrw1000_config().override(**OVER))


def test_lrw1000_preset_and_batch():
    """The preset as the JAX package defines it, and the batch word_batch
    makes for it: 40 frames, T*A + 4 token rows of 2 groups, no word_mask."""
    cfg = tcfg.lrw1000_config()
    codec = cfg.model.codec
    assert (codec.audio_alignment, codec.vq_groups, codec.audio_vocab_size) == (2, 2, 640)
    assert cfg.model.labels == 1000 and not cfg.model.use_word_boundary
    batch = word_batch(cfg.override(**{"data.batch_size": 2, "data.crop_size": 8}))
    assert batch["inputs"].shape == (2, 40, 8, 8, 1) and "word_mask" not in batch
    assert batch["audio_tokens"].shape == (2, 40 * 2 + 4, 2)
    assert int(batch["audio_tokens"].max()) < 640


def test_token_regrouping_at_a2():
    """[B, T*A + 4, G] -> [B, T, A*G]: frame t's slots are rows 2t and 2t+1,
    each with its 2 groups, in row-major order; the extra rows are cut."""
    rng = np.random.RandomState(0)
    tok = rng.randint(0, 640, (3, 5 * 2 + 4, 2)).astype(np.int32)
    got = regroup_tokens(tt(tok), 3, 5, 2, 2).numpy()
    assert got.shape == (3, 5, 4)
    for t in range(5):
        np.testing.assert_array_equal(got[:, t], tok[:, 2 * t:2 * t + 2].reshape(3, 4))


@pytest.mark.parametrize("chunk", [None, 2])
def test_sync_loss_at_v640_matches_jax(chunk):
    """The sync head's plain loss and its gradients at A = 2, G = 2, V =
    640, some tokens ignored: f32 against f32, 1e-5 relative."""
    rng = np.random.RandomState(1)
    b, t, d = 2, 5, 24
    feats = rng.randn(b, t, d).astype(np.float32)
    kern = (rng.randn(d, 4 * 640) * 0.1).astype(np.float32)
    bias = (rng.randn(4 * 640) * 0.1).astype(np.float32)
    tok = rng.randint(0, 640, (b, t * 2 + 4, 2)).astype(np.int32)
    tok[0, :3] = -1
    want, want_g = jax.jit(jax.value_and_grad(
        lambda f, k, bb: jax_sync_ce(f, k, bb, jnp.asarray(tok), 2, 2, 640, chunk=chunk),
        argnums=(0, 1, 2)))(jnp.asarray(feats), jnp.asarray(kern), jnp.asarray(bias))
    args = [tt(a).requires_grad_() for a in (feats, kern, bias)]
    got = sync_cross_entropy(*args, tt(tok), 2, 2, 640, chunk=chunk)
    got.backward()
    close(got, want, 1e-5, 0.0, "loss")
    for a, g, name in zip(args, want_g, ("features", "kernel", "bias")):
        g = np.asarray(g)
        close(a.grad, g, 1e-5, 1e-5 * float(np.abs(g).max()), name)


@pytest.mark.parametrize("n", [300, 37])
def test_k1_plain_matches_pallas_interpret_at_v640(n):
    """K1's plain version at lrw1000's head (D = 512, 4 slots of 640) against
    the Pallas kernel in interpret mode: the same bf16 operands and f32
    accumulation, the sums in other orders: 2e-6 relative, the count exact.
    The JAX rule sends this head to K1 (2.6 MB of weight)."""
    from syncvsr_tpu.ops.pallas_sync import _pallas_forward
    from syncvsr_tpu_torch.ops.cuda_sync import sync_ce_partials_plain, uses_split_kernel

    rng = np.random.RandomState(5)
    d, s, v = 512, 4, 640
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


@pytest.fixture(scope="module")
def pair():
    cfg_j, cfg_t = lrw1000_configs()
    batch = word_batch(cfg_t)
    batch["audio_tokens"][1, :5] = -1
    model_j = jax_build_model(cfg_j)
    state_j = jax_create_train_state(cfg_j, JitInit(model_j),
                                     {k: jnp.asarray(v) for k, v in batch.items()})
    return cfg_j, cfg_t, batch, model_j, state_j


def test_lrw1000_eval_matches_jax(pair):
    """Every output key, a padded row among them: f32, 1e-5 relative."""
    _, cfg_t, batch, model_j, state_j = pair
    params, stats = to_np(state_j.params), to_np(state_j.batch_stats)
    assert params["audio_classifier"]["kernel"].shape == (64, 4 * 640)
    assert "frontend_proj" not in params
    batch = dict(batch, sample_weight=np.array([1.0, 0.0], np.float32))
    out_j = jax.jit(lambda v, b: model_j.apply(v, **b, det=True))(
        {"params": params, "batch_stats": stats}, {k: jnp.asarray(v) for k, v in batch.items()})
    model = torch_model(cfg_t, params, stats)
    state = create_train_state(cfg_t, model, batch, device="cpu")
    out = build_eval_step()(state, {k: tt(v) for k, v in batch.items()})
    assert set(out) == set(out_j) | {"_weight"}
    for k in out_j:
        close(out[k], out_j[k], 1e-5, 1e-6, k)


def test_lrw1000_train_steps_match_jax(pair):
    """Two steps: metrics, batch_stats, Adam moments and params with
    test_torch_step's tolerances (20 chained BatchNorm backwards)."""
    cfg_j, cfg_t, batch, _, state_j = pair
    model = torch_model(cfg_t, to_np(state_j.params), to_np(state_j.batch_stats))
    state = create_train_state(cfg_t, model, batch, device="cpu")
    step_j, step = jax_build_train_step(donate=False), build_train_step()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: tt(v) for k, v in batch.items()}
    lr_sum = 0.0
    for _ in range(2):
        state_j, m_j = step_j(state_j, jb)
        state, m = step(state, tb)
        lr_sum += float(m_j["learning_rate"])
        for k in METRICS:
            close(float(m[k]), float(m_j[k]), 1e-4, 1e-7, k)
    assert abs(float(m["loss_audio"]) - np.log(640)) < 0.5
    mu_j, nu_j = _adam_moments(state_j.opt_state)
    sd = model.state_dict()
    _compare(to_flax(sd)[1], to_np(state_j.batch_stats), 1e-4, 1e-5, "batch_stats")
    _compare(to_flax(dict(zip(state.names, state.mu)))[0], to_np(mu_j), 1e-3, 5e-4, "mu")
    _compare(to_flax(dict(zip(state.names, state.nu)))[0], to_np(nu_j), 1e-3, 1e-3, "nu")
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(to_np(state_j.params)),
                            jax.tree_util.tree_leaves(to_flax(sd)[0])):
        close(g, w, 1e-4, 1e-4 * float(np.abs(w).max()) + 0.05 * lr_sum,
              "params" + jax.tree_util.keystr(path))

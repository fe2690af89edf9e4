"""PyTorch port: the word-level model (eval and train mode), in-step
augmentation, CutMix and the eval transform against the JAX package, on the
CPU. Random draws are replayed from the JAX keys and injected into the
port's apply parts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.ops.cutmix import temporal_cutmix
from syncvsr_tpu.ops.image import build_eval_transform as jax_eval_transform
from syncvsr_tpu.ops.image import fused_train_aug
from syncvsr_tpu_torch.ops.cutmix import cutmix_keep, temporal_cutmix_apply
from syncvsr_tpu_torch.ops.image import build_eval_transform, fused_train_aug_apply
from syncvsr_tpu_torch.utils.bridge import to_flax
from torch_parity import (
    close,
    configs,
    jax_aug_sample,
    jax_cutmix_sample,
    jax_model_and_vars,
    to_np,
    torch_model,
    tt,
    uint8_batch,
)

KEYS = ("loss", "loss_word", "loss_audio", "acc1", "acc5")


def _model_pair(seed=0, **over):
    cfg_j, cfg_t = configs(**over)
    batch = {k: v for k, v in uint8_batch(cfg_t, seed).items()}
    init = dict(batch, inputs=np.zeros(batch["inputs"].shape[:3] + (batch["inputs"].shape[2], 1),
                                       np.float32))
    model_j, params, stats = jax_model_and_vars(cfg_j, init)
    return cfg_j, cfg_t, batch, model_j, params, stats


def _float_inputs(batch, cfg):
    rng = np.random.RandomState(3)
    b, t, s = cfg.data.batch_size, cfg.data.num_frames, cfg.data.crop_size
    out = dict(batch, inputs=rng.randn(b, t, s, s, 1).astype(np.float32))
    out["audio_tokens"] = out["audio_tokens"].copy()
    out["audio_tokens"][0, :5] = -1  # some ignored sync slots
    return out


# f32: the transformer and the 20-BN trunk agree to ~1e-5 relative
def test_word_model_eval_matches_jax():
    cfg_j, cfg_t, batch, model_j, params, stats = _model_pair()
    batch = _float_inputs(batch, cfg_t)
    batch["sample_weight"] = np.array([1.0, 0.0], np.float32)
    out_j = jax.jit(lambda v, b: model_j.apply(v, **b, det=True))(
        {"params": params, "batch_stats": stats}, {k: jnp.asarray(v) for k, v in batch.items()})
    model = torch_model(cfg_t, params, stats)
    with torch.no_grad():
        out = model(**{k: tt(v) for k, v in batch.items()}, det=True)
    assert set(out) == set(out_j) == set(KEYS) | {"_slots"}
    for k in out_j:
        close(out[k], out_j[k], 2e-5, 2e-5, k)


def test_word_model_train_mode_matches_jax():
    """det=False, dropout 0, CutMix off: train-mode BatchNorm through the
    whole model, the loss, every gradient and the running statistics."""
    cfg_j, cfg_t, batch, model_j, params, stats = _model_pair(1)
    batch = _float_inputs(batch, cfg_t)

    def loss(p, b):
        out, mut = model_j.apply({"params": p, "batch_stats": stats}, **b, det=False,
                                 mutable=["batch_stats"])
        return out["loss"], (out, mut["batch_stats"])

    (_, (out_j, stats_j)), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = torch_model(cfg_t, params, stats)
    out = model(**{k: tt(v) for k, v in batch.items()}, det=False)
    out["loss"].backward()
    for k in KEYS:
        close(out[k], out_j[k], 2e-5, 2e-5, k)
    grads, _ = to_flax({n: p.grad for n, p in model.named_parameters()})
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(to_np(g_j)),
                                 jax.tree_util.tree_leaves(grads)):
        scale = float(np.abs(want).max())
        close(got, want, 1e-3, 1e-4 * scale + 1e-7, jax.tree_util.keystr(path))
    # the CLS token's boundary element gets no gradient on either side
    assert float(model.cls_token.grad[0, 0, -1]) == 0.0
    _, stats_t = to_flax(model.state_dict())
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(to_np(stats_j)),
                                 jax.tree_util.tree_leaves(stats_t)):
        close(got, want, 1e-4, 1e-5, jax.tree_util.keystr(path))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cutmix_apply_matches_jax(seed):
    rng = np.random.RandomState(seed)
    b, t, a, g = 4, 10, 4, 2
    x = rng.randn(b, t, 3, 3, 1).astype(np.float32)
    labels = np.eye(5, dtype=np.float32)[rng.randint(0, 5, b)]
    tokens = rng.randint(0, 13, (b, t * a, g)).astype(np.int32)
    wm = (rng.rand(b, t) > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    out_j = temporal_cutmix(key, *(jnp.asarray(v) for v in (x, labels, tokens, wm)), 1.0)
    keep = cutmix_keep(t, *jax_cutmix_sample(key, 1.0))
    out = temporal_cutmix_apply(tt(x), tt(labels), tt(tokens), tt(wm), keep)
    for name, a_, e in zip(("inputs", "labels", "tokens", "word_mask"), out, out_j):
        close(a_, e, 1e-6, 1e-7, name)


@pytest.mark.parametrize("seed", [0, 1])
def test_train_aug_apply_matches_jax(seed):
    # f32 resample of the same uint8 source, then bf16 output on both sides:
    # they agree to one bf16 rounding step
    cfg_j, cfg_t = configs()
    rng = np.random.RandomState(seed)
    b, t, h, w = 3, 5, 20, 24
    videos = rng.randint(0, 256, (b, t, h, w, 1)).astype(np.uint8)
    key = jax.random.PRNGKey(10 + seed)
    d = cfg_j.data
    want = fused_train_aug(key, jnp.asarray(videos), d.crop_size, d.rrc_scale,
                           hflip_prob=d.hflip_prob, time_mask_span=d.time_mask_window,
                           time_mask_n=d.time_mask_stride, mean=d.mean, std=d.std)
    p = jax_aug_sample(key, b, t, h, w, cfg_t.data)
    got = fused_train_aug_apply(tt(videos), p, cfg_t.data.crop_size, cfg_t.data.mean,
                                cfg_t.data.std)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    close(got, np.asarray(want.astype(jnp.float32)), 8e-3, 8e-3)


def test_eval_transform_matches_jax():
    cfg_j, cfg_t = configs()
    videos = np.random.RandomState(4).randint(0, 256, (2, 3, 16, 20, 1)).astype(np.uint8)
    want = jax_eval_transform(cfg_j.data)({"inputs": jnp.asarray(videos)})["inputs"]
    got = build_eval_transform(cfg_t.data)({"inputs": tt(videos)})["inputs"]
    close(got, want, 1e-5, 1e-5)


def test_word_model_bf16_forward():
    # bf16 rounds at other places in the two libraries (fused bias adds,
    # activation internals); the losses agree to ~1%
    cfg_j, cfg_t, batch, model_j, params, stats = _model_pair(2, **{"model.dtype": "bfloat16"})
    batch = _float_inputs(batch, cfg_t)
    out_j = jax.jit(lambda v, b: model_j.apply(v, **b, det=True))(
        {"params": params, "batch_stats": stats}, {k: jnp.asarray(v) for k, v in batch.items()})
    model = torch_model(cfg_t, params, stats)
    with torch.no_grad():
        out = model(**{k: tt(v) for k, v in batch.items()}, det=True)
    for k in ("loss", "loss_word", "loss_audio"):
        close(out[k], out_j[k], 2e-2, 2e-2, k)

"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
one tiny ``lrw_video`` configuration built in both packages, the JAX model's
variables, and a port model carrying the same weights through the bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from syncvsr_tpu import config as jcfg
from syncvsr_tpu.models import build_model as jax_build_model
from syncvsr_tpu_torch import config as tcfg
from syncvsr_tpu_torch.models import build_model as torch_build_model
from syncvsr_tpu_torch.utils.bridge import load_flax

TINY = {
    "model.encoder.layers": 2, "model.encoder.dim": 64, "model.encoder.heads": 2,
    "model.frontend.resnet_width": 8, "model.labels": 7,
    "model.codec.audio_vocab_size": 13, "model.dtype": "float32",
    "model.encoder.emb_dropout": 0.0, "model.encoder.msa_dropout": 0.0,
    "model.encoder.mlp_dropout": 0.0, "model.encoder.droppath": 0.0,
    "data.batch_size": 2, "data.num_frames": 4, "data.crop_size": 16,
    "data.use_cutmix": False,
    "optim.total_steps": 10, "optim.warmup_steps": 2,
}


def configs(**over):
    """(JAX config, port config) of the tiny lrw_video model."""
    o = dict(TINY, **over)
    return jcfg.lrw_video_config().override(**o), tcfg.lrw_video_config().override(**o)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_model_and_vars(cfg_j, batch):
    model = jax_build_model(cfg_j)
    variables = jax.jit(lambda b: model.init(
        {"params": jax.random.PRNGKey(0), "mixup": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, **b, det=True))(
        {k: jnp.asarray(v) for k, v in batch.items()})
    return model, to_np(variables["params"]), to_np(variables["batch_stats"])


def torch_model(cfg_t, params, batch_stats):
    model = torch_build_model(cfg_t, device="cpu")
    load_flax(model, params, batch_stats)
    return model


def tt(a):
    """numpy -> torch (CPU), keeping the dtype."""
    return torch.from_numpy(np.array(a))


def close(actual, expected, rtol, atol, what=""):
    a = actual.detach().float().numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    np.testing.assert_allclose(a, np.asarray(expected, np.float32), rtol=rtol, atol=atol,
                               err_msg=what)


def jax_aug_sample(key, b, t, h, w, data_cfg):
    """The values ``syncvsr_tpu.ops.image.fused_train_aug`` draws from ``key``
    (its sampling lines, replayed), as numpy arrays for the port's
    ``fused_train_aug_apply``."""
    scale, ratio = data_cfg.rrc_scale, (3 / 4, 4 / 3)
    r_area, r_ratio, r_y, r_x, r_flip, r_tm = jax.random.split(key, 6)
    area = jax.random.uniform(r_area, (b,), minval=scale[0], maxval=scale[1]) * (h * w)
    log_r = jax.random.uniform(r_ratio, (b,), minval=jnp.log(ratio[0]),
                               maxval=jnp.log(ratio[1]))
    aspect = jnp.exp(log_r)
    cw = jnp.clip(jnp.sqrt(area * aspect), 1, w)
    ch = jnp.clip(jnp.sqrt(area / aspect), 1, h)
    y0 = jax.random.uniform(r_y, (b,)) * (h - ch)
    x0 = jax.random.uniform(r_x, (b,)) * (w - cw)
    flip = jax.random.bernoulli(r_flip, data_cfg.hflip_prob, (b,))
    frames = jnp.arange(t)[None, :]
    hit = jnp.zeros((b, t), bool)
    for _ in range(data_cfg.time_mask_stride):
        r_span, r_start, r_tm = jax.random.split(r_tm, 3)
        span = jax.random.randint(r_span, (b,), 0, data_cfg.time_mask_window + 1)
        start = (jax.random.uniform(r_start, (b,))
                 * jnp.maximum(jnp.full((b,), t, jnp.float32) - span, 1)).astype(jnp.int32)
        hit |= (frames >= start[:, None]) & (frames < (start + span)[:, None])
    out = {"ch": ch, "cw": cw, "y0": y0, "x0": x0, "flip": flip, "hit": hit}
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def jax_cutmix_sample(key, alpha):
    """(ratio, start) as ``syncvsr_tpu.ops.cutmix.temporal_cutmix`` draws them."""
    r1, r2 = jax.random.split(key)
    ratio = jax.random.beta(r1, alpha, alpha)
    start = (1.0 - ratio) * jax.random.uniform(r2)
    return torch.tensor(np.float32(ratio)), torch.tensor(np.float32(start))


def uint8_batch(cfg_t, seed=0, width_extra=4):
    """word_batch with uint8 clips [B, T, crop, crop + width_extra, 1]."""
    from syncvsr_tpu_torch.data.synthetic import word_batch

    batch = word_batch(cfg_t, seed=seed)
    b, t, s = cfg_t.data.batch_size, cfg_t.data.num_frames, cfg_t.data.crop_size
    rng = np.random.RandomState(seed + 100)
    batch["inputs"] = rng.randint(0, 256, (b, t, s, s + width_extra, 1)).astype(np.uint8)
    return batch

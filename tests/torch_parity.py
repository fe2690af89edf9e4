"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
tiny ``lrw_video``, ``lrw_landmark``, ``lrs3`` and ``lrs3_audio``
configurations built in both packages, the JAX model's variables, and a
port model carrying the same weights through the bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from syncvsr_tpu import config as jcfg
from syncvsr_tpu.models import build_model as jax_build_model
from syncvsr_tpu_torch import config as tcfg
from syncvsr_tpu_torch.models import build_model as torch_build_model
from syncvsr_tpu_torch.utils.bridge import load_flax
import torch_threads  # noqa: F401  (one torch thread a test process)

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


# the lrs3 sentence model at toy widths: the encoder (32) and decoder (16)
# widths differ, so proj_decoder is built
SENTENCE_TINY = {
    "model.encoder.layers": 2, "model.encoder.dim": 32, "model.encoder.heads": 2,
    "model.decoder.layers": 1, "model.decoder.dim": 16, "model.decoder.heads": 2,
    "model.decoder.hidden": 24, "model.frontend.resnet_width": 8, "model.labels": 11,
    "model.codec.audio_vocab_size": 13, "model.dtype": "float32",
    "model.encoder.mlp_dropout": 0.0, "model.encoder.msa_dropout": 0.0,
    "model.decoder.dropout": 0.0, "data.batch_size": 2, "data.crop_size": 16,
    "optim.total_steps": 10, "optim.warmup_steps": 2,
}


# the lrs3 sentence model at toy widths with EQUAL encoder and decoder
# widths: the decoding hooks of both packages feed the encoder output to the
# decoder without proj_decoder, so SENTENCE_TINY (32 / 16) cannot decode
SENTENCE_DECODE = dict(SENTENCE_TINY, **{"model.decoder.dim": 32, "model.decoder.layers": 2})


def configs(**over):
    """(JAX config, port config) of the tiny lrw_video model."""
    o = dict(TINY, **over)
    return jcfg.lrw_video_config().override(**o), tcfg.lrw_video_config().override(**o)


def sentence_configs(**over):
    """(JAX config, port config) of the tiny lrs3 model."""
    o = dict(SENTENCE_TINY, **over)
    return jcfg.lrs3_config().override(**o), tcfg.lrs3_config().override(**o)


def sentence_decode_configs(**over):
    """(JAX config, port config) of the tiny lrs3 model that both packages
    can decode (encoder and decoder 32 wide)."""
    o = dict(SENTENCE_DECODE, **over)
    return jcfg.lrs3_config().override(**o), tcfg.lrs3_config().override(**o)


def landmark_configs(**over):
    """(JAX config, port config) of the tiny lrw_landmark model: TINY's
    encoder, heads and batch over the published 1434 landmark features."""
    o = dict(TINY, **over)
    return (jcfg.lrw_landmark_config().override(**o),
            tcfg.lrw_landmark_config().override(**o))


def audio_configs(**over):
    """(JAX config, port config) of the tiny lrs3_audio model: the tiny lrs3
    model over an 8-wide ResNet1D."""
    o = dict(SENTENCE_TINY, **over)
    return (jcfg.lrs3_audio_config().override(**o),
            tcfg.lrs3_audio_config().override(**o))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_model_and_vars(cfg_j, batch):
    model = jax_build_model(cfg_j)
    variables = jax.jit(lambda b: model.init(
        {"params": jax.random.PRNGKey(0), "mixup": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, **b, det=True))(
        {k: jnp.asarray(v) for k, v in batch.items()})
    return model, to_np(variables["params"]), to_np(variables.get("batch_stats", {}))


class JitInit:
    """A flax model whose ``init`` is jitted, for the JAX package's
    ``create_train_state`` (flax runs an un-jitted init op by op: ~35 s of
    the CPU test run for the sentence model)."""

    def __init__(self, model):
        self.apply = model.apply
        self._init = jax.jit(model.init, static_argnames="det")

    def init(self, rngs, **batch):
        return self._init(rngs, **batch)


def replicated(mesh, state):
    """A JAX train state committed replicated on ``mesh``, as a data-parallel
    step returns it: fresh from ``create_train_state`` it is uncommitted,
    and the step would compile again for its second call."""
    return jax.device_put(state, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))


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


def jax_aug_sample(key, b, t, h, w, data_cfg, sentence=False, lengths=None):
    """The values ``syncvsr_tpu.ops.image.fused_train_aug`` draws from ``key``
    (its sampling lines, replayed), as numpy arrays for the port's
    ``fused_train_aug_apply``: with the word recipe of ``data_cfg``, or with
    ``sentence`` the one of ``build_sentence_aug`` (time masks bounded by
    ``lengths``)."""
    scale, ratio = data_cfg.rrc_scale, (3 / 4, 4 / 3)
    hflip, span_max, n_masks = (data_cfg.hflip_prob, data_cfg.time_mask_window,
                                data_cfg.time_mask_stride)
    if sentence:
        scale, hflip, span_max, n_masks = (0.7, 1.0), 0.5, 10, 2
    r_area, r_ratio, r_y, r_x, r_flip, r_tm = jax.random.split(key, 6)
    area = jax.random.uniform(r_area, (b,), minval=scale[0], maxval=scale[1]) * (h * w)
    log_r = jax.random.uniform(r_ratio, (b,), minval=jnp.log(ratio[0]),
                               maxval=jnp.log(ratio[1]))
    aspect = jnp.exp(log_r)
    cw = jnp.clip(jnp.sqrt(area * aspect), 1, w)
    ch = jnp.clip(jnp.sqrt(area / aspect), 1, h)
    y0 = jax.random.uniform(r_y, (b,)) * (h - ch)
    x0 = jax.random.uniform(r_x, (b,)) * (w - cw)
    flip = jax.random.bernoulli(r_flip, hflip, (b,))
    frames = jnp.arange(t)[None, :]
    hit = jnp.zeros((b, t), bool)
    limit = (jnp.full((b,), t) if lengths is None else jnp.asarray(lengths)).astype(jnp.float32)
    for _ in range(n_masks):
        r_span, r_start, r_tm = jax.random.split(r_tm, 3)
        span = jax.random.randint(r_span, (b,), 0, span_max + 1)
        start = (jax.random.uniform(r_start, (b,))
                 * jnp.maximum(limit - span, 1)).astype(jnp.int32)
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

"""PyTorch port: RMSNorm, RoPE, GLU feed-forward, attention and the
transformer encoder against the JAX package, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.models import layers as jl
from syncvsr_tpu.models.transformer import RotaryAttention as JaxAttention
from syncvsr_tpu.models.transformer import TransformerEncoder as JaxEncoder
from syncvsr_tpu_torch.models import layers as tl
from syncvsr_tpu_torch.models.transformer import RotaryAttention, TransformerEncoder
from syncvsr_tpu_torch.utils.bridge import from_flax
from torch_parity import close, to_np, tt


def _init(module, *args, **kw):
    return to_np(module.init(jax.random.PRNGKey(0), *args, **kw)["params"])


def _load(module, params):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in from_flax(params).items()},
                           strict=True)
    return module


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# every comparison below is f32 against f32: ~1e-6 relative agreement
def test_rmsnorm():
    x = _x((2, 5, 33))
    mod = jl.RMSNorm()
    params = _init(mod, jnp.asarray(x))
    params["scale"] = np.linspace(0.5, 1.5, 33).astype(np.float32)
    y_j = mod.apply({"params": params}, jnp.asarray(x))
    y = _load(tl.RMSNorm(33), params)(tt(x))
    close(y, y_j, 1e-5, 1e-6)


@pytest.mark.parametrize("d", [64, 32])
def test_rope(d):
    x = _x((2, 7, 3, d), 1)
    pos = np.arange(7)
    cos_j, sin_j = jl.rope_angles(jnp.asarray(pos), d)
    cos, sin = tl.rope_angles(torch.arange(7), d)
    close(cos, cos_j, 1e-6, 1e-6, "cos")
    close(sin, sin_j, 1e-6, 1e-6, "sin")
    close(tl.apply_rope(tt(x), cos, sin), jl.apply_rope(jnp.asarray(x), cos_j, sin_j),
          1e-5, 1e-6, "apply_rope")


def test_glu_feed_forward():
    x = _x((2, 5, 33), 2)
    mod = jl.FeedForward(dim=33, hidden=48, use_glu=True)
    params = _init(mod, jnp.asarray(x))
    y_j = mod.apply({"params": params}, jnp.asarray(x))
    y = _load(tl.FeedForward(33, 48), params)(tt(x))
    close(y, y_j, 1e-5, 1e-6)


def test_dot_attention():
    q, k, v = (_x((2, 6, 3, 8), s) for s in (3, 4, 5))
    bias = np.where(np.random.RandomState(6).rand(2, 1, 1, 6) < 0.2, -1e9, 0.0).astype(np.float32)
    o_j = jl.dot_attention(*(jnp.asarray(a) for a in (q, k, v, bias)), 0.0, True, None,
                           jnp.float32)
    o = tl.dot_attention(tt(q), tt(k), tt(v), tt(bias), 0.0, True, None, torch.float32)
    close(o, o_j, 1e-5, 1e-6)


@pytest.mark.parametrize("rope_dim", [0, 4])
def test_rotary_attention_wider_stream(rope_dim):
    # stream 33 read and written by an attention 32 wide (the word-boundary channel)
    x = _x((2, 6, 33), 7)
    mod = JaxAttention(dim=32, heads=4, rope_dim=rope_dim)
    pos = jnp.arange(6)
    params = _init(mod, jnp.asarray(x), pos)
    y_j = mod.apply({"params": params}, jnp.asarray(x), pos)
    att = _load(RotaryAttention(33, 32, 4, rope_dim=rope_dim), params)
    close(att(tt(x), torch.arange(6)), y_j, 1e-5, 1e-6)


def test_transformer_encoder_det():
    x = _x((2, 9, 65), 8)
    mod = JaxEncoder(layers=2, dim=64, heads=2, hidden=128, use_rmsnorm=True,
                     use_glu=True, rope=True)
    params = _init(mod, jnp.asarray(x))
    y_j = mod.apply({"params": params}, jnp.asarray(x), det=True)
    enc = _load(TransformerEncoder(65, 2, 64, 2, 128), params)
    y = enc(tt(x), det=True)
    assert y.shape == (2, 9, 65)
    close(y, y_j, 2e-5, 2e-5)

"""PyTorch port: the sentence model's layers (LayerNorm, the attention masks,
rel-shift, relative-position attention, the Conformer convolution module and
encoder, the teacher-forced decoder) against the JAX package's flax modules
from bridged weights, on the CPU, in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.models import conformer as jc
from syncvsr_tpu.models import decoder as jd
from syncvsr_tpu.models import layers as jl
from syncvsr_tpu_torch.models import conformer as tc
from syncvsr_tpu_torch.models import decoder as td
from syncvsr_tpu_torch.models import layers as tl
from syncvsr_tpu_torch.utils.bridge import from_flax, to_flax
from torch_parity import close, to_np, tt

DIM, HEADS = 16, 2


def _load(module, variables):
    sd = from_flax(variables["params"], variables.get("batch_stats"))
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return module


def _pad_mask(b, t, seed):
    lengths = np.random.RandomState(seed).randint(t // 2, t + 1, b)
    lengths[0] = t
    return np.arange(t)[None, :] < lengths[:, None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm(dtype):
    # eps 1e-6, f32 inside, the compute dtype out; f32 sums in other orders
    x = (np.random.RandomState(0).randn(3, 5, DIM) * 4 + 1).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    mod = jl.LayerNorm(dtype=jdt)
    v = to_np(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v["params"]["LayerNorm_0"]["scale"] = np.linspace(0.5, 1.5, DIM, dtype=np.float32)
    v["params"]["LayerNorm_0"]["bias"] = np.linspace(-1, 1, DIM, dtype=np.float32)
    want = mod.apply(v, jnp.asarray(x).astype(jdt))
    got = _load(tl.LayerNorm(DIM, tdt), v)(tt(x).to(tdt))
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 8e-3
    close(got, np.asarray(want.astype(jnp.float32)), tol, tol)


def test_masks_exact():
    keep = _pad_mask(3, 6, 1)
    np.testing.assert_array_equal(tl.make_pad_bias(tt(keep)).numpy(),
                                  np.asarray(jl.make_pad_bias(jnp.asarray(keep))))
    np.testing.assert_array_equal(tl.causal_bias(6).numpy(), np.asarray(jl.causal_bias(6)))


@pytest.mark.parametrize("t", [1, 4, 7])
def test_rel_shift_and_tables_exact(t):
    x = np.random.RandomState(t).randn(2, 3, t, 2 * t - 1).astype(np.float32)
    np.testing.assert_array_equal(tc.rel_shift(tt(x)).numpy(),
                                  np.asarray(jc.rel_shift(jnp.asarray(x))))
    # column j of row i holds relative distance i - j: table index t-1-(i-j)
    got = tc.rel_shift(torch.arange(2 * t - 1.0).expand(1, 1, t, 2 * t - 1))[0, 0]
    i, j = np.meshgrid(np.arange(t), np.arange(t), indexing="ij")
    np.testing.assert_array_equal(got.numpy(), t - 1 - (i - j))
    # sin/cos tables computed the same way in f32 (libm sin/cos may differ by an ulp)
    close(tc.rel_sinusoid_table(t, DIM), jc.rel_sinusoid_table(t, DIM), 1e-6, 1e-6)
    close(td.sinusoid_pe(t, DIM, 3), jd.sinusoid_pe(t, DIM, 3), 1e-6, 1e-6)


# f32 on both sides: sums in other orders, ~1e-6 relative
def test_rel_position_attention_matches_jax():
    b, t = 2, 7
    rng = np.random.RandomState(2)
    x = rng.randn(b, t, DIM).astype(np.float32)
    pos = np.asarray(jc.rel_sinusoid_table(t, DIM))
    bias = np.asarray(jl.make_pad_bias(jnp.asarray(_pad_mask(b, t, 3))))
    mod = jc.RelPositionAttention(DIM, HEADS)
    v = to_np(mod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(pos)))
    want = mod.apply(v, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(bias))
    got = _load(tc.RelPositionAttention(DIM, HEADS), v)(tt(x), tt(pos), tt(bias))
    close(got, want, 1e-5, 1e-5)


def test_conv_module_train_forward_matches_jax():
    """Outputs and running statistics after one train-mode forward over a
    padded batch (the statistics include the zeroed padding)."""
    b, t = 3, 9
    rng = np.random.RandomState(4)
    x = rng.randn(b, t, DIM).astype(np.float32)
    keep = _pad_mask(b, t, 5)
    mod = jc.ConvModule(DIM, 31)
    v = to_np(mod.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(keep)))
    v["params"]["dw"]["bias"] = rng.randn(DIM).astype(np.float32) * 0.1
    want, mut = mod.apply(v, jnp.asarray(x), jnp.asarray(keep), train=True,
                          mutable=["batch_stats"])
    port = _load(tc.ConvModule(DIM, 31), v)
    got = port(tt(x), tt(keep), train=True)
    close(got, want, 1e-5, 1e-5, "out")
    stats = to_flax(port.state_dict())[1]
    for k in ("mean", "var"):
        close(stats["bn"][k], mut["batch_stats"]["bn"][k], 1e-5, 1e-6, k)


def test_conformer_encoder_det_matches_jax():
    b, t, din = 2, 8, 12
    rng = np.random.RandomState(6)
    x = rng.randn(b, t, din).astype(np.float32)
    keep = _pad_mask(b, t, 7)
    mod = jc.ConformerEncoder(layers=2, dim=DIM, heads=HEADS, hidden=32)
    v = to_np(mod.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(keep)))
    want = mod.apply(v, jnp.asarray(x), jnp.asarray(keep), det=True)
    port = _load(tc.ConformerEncoder(din, 2, DIM, HEADS, 32), v)
    with torch.no_grad():
        got = port(tt(x), tt(keep), det=True)
    close(got, want, 2e-5, 2e-5)


def test_transformer_decoder_teacher_forced_matches_jax():
    b, l, t, vocab = 3, 5, 7, 11
    rng = np.random.RandomState(8)
    ys = rng.randint(0, vocab, (b, l)).astype(np.int32)
    ys_len = np.array([5, 3, 1], np.int32)
    memory = rng.randn(b, t, DIM).astype(np.float32)
    keep = _pad_mask(b, t, 9)
    mod = jd.TransformerDecoder(vocab=vocab, layers=2, dim=DIM, heads=HEADS, hidden=24)
    args = (jnp.asarray(ys), jnp.asarray(ys_len), jnp.asarray(memory), jnp.asarray(keep))
    v = to_np(mod.init(jax.random.PRNGKey(4), *args))
    want = mod.apply(v, *args, det=True)
    port = _load(td.TransformerDecoder(vocab, 2, DIM, HEADS, 24), v)
    with torch.no_grad():
        got = port(tt(ys), tt(ys_len), tt(memory), tt(keep), det=True)
    assert got.dtype == torch.float32 and got.shape == (b, l, vocab)
    close(got, want, 2e-5, 2e-5)

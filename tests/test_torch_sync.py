"""PyTorch port: sync cross-entropy (plain, chunked, fused forward) and the
plain version of kernel K1 against the JAX package, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.ops.pallas_sync import _pallas_forward, pallas_sync_cross_entropy
from syncvsr_tpu.ops.sync_loss import sync_cross_entropy as jax_sce
from syncvsr_tpu.ops.sync_loss import sync_cross_entropy_reference as jax_sce_ref
from syncvsr_tpu_torch.ops.cuda_sync import fused_sync_cross_entropy, sync_ce_partials_plain
from syncvsr_tpu_torch.ops.sync_loss import sync_cross_entropy, sync_cross_entropy_reference
from torch_parity import close, tt

A, G = 4, 2


def _inputs(seed, b, t, d, v, ignore=True):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, t, d).astype(np.float32)
    kernel = (rng.randn(d, A * G * v) * 0.05).astype(np.float32)
    bias = (rng.randn(A * G * v) * 0.1).astype(np.float32)
    tokens = rng.randint(0, v, (b, t * A + 3, G)).astype(np.int32)
    if ignore:
        tokens[rng.rand(*tokens.shape) < 0.2] = -1
    return feats, kernel, bias, tokens


def _torch_value_and_grads(fn, feats, kernel, bias, tokens, *args):
    x, w, bb = (tt(a).requires_grad_() for a in (feats, kernel, bias))
    loss = fn(x, w, bb, tt(tokens), *args)
    loss.backward()
    return loss, (x.grad, w.grad, bb.grad)


def _jax_value_and_grads(fn, feats, kernel, bias, tokens, *args):
    return jax.value_and_grad(lambda x, w, b: fn(x, w, b, jnp.asarray(tokens), *args),
                              argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (feats, kernel, bias)))


# f32 throughout: both sides compute the same f32 sums in other orders, so
# values agree to ~1e-6 relative and gradients to ~1e-7 absolute
@pytest.mark.parametrize("d,v,chunk", [(16, 32, None), (16, 32, 3), (513, 320, None),
                                       (513, 320, 4)])
def test_sync_cross_entropy_matches_jax(d, v, chunk):
    b, t = 2, 7
    inputs = _inputs(0, b, t, d, v)
    loss, grads = _torch_value_and_grads(sync_cross_entropy, *inputs, A, G, v, chunk)
    jl, jg = _jax_value_and_grads(jax_sce, *inputs, A, G, v, chunk)
    close(loss, jl, 1e-5, 1e-6, "loss")
    for name, a, e in zip(("dfeatures", "dkernel", "dbias"), grads, jg):
        close(a, e, 1e-4, 2e-6, name)


@pytest.mark.parametrize("d,v", [(16, 32), (513, 320)])
def test_sync_reference_matches_jax(d, v):
    inputs = _inputs(1, 2, 5, d, v, ignore=False)
    loss, grads = _torch_value_and_grads(sync_cross_entropy_reference, *inputs, A, G, v)
    jl, jg = _jax_value_and_grads(jax_sce_ref, *inputs, A, G, v)
    close(loss, jl, 1e-5, 1e-6, "loss")
    for name, a, e in zip(("dfeatures", "dkernel", "dbias"), grads, jg):
        close(a, e, 1e-4, 2e-6, name)
    # without ignored tokens the chunked op is the reference
    chunked = sync_cross_entropy(*(tt(a) for a in inputs), A, G, v, chunk=2)
    close(chunked, jl, 1e-5, 1e-6, "chunked")


@pytest.mark.parametrize("n", [300, 37])
def test_k1_plain_matches_pallas_interpret(n):
    # both cast features and weight to bf16 and accumulate the product in
    # f32; only the summation order differs
    rng = np.random.RandomState(2)
    d, s, v = 513, 8, 320
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


def test_fused_sync_ce_matches_pallas_interpret():
    # forward through K1's plain version (bf16 product), backward through the
    # f32 chunked recompute on both sides
    b, t, d, v = 2, 9, 513, 320
    inputs = _inputs(3, b, t, d, v)
    loss, grads = _torch_value_and_grads(fused_sync_cross_entropy, *inputs, A, G, v, 4)
    jl, jg = _jax_value_and_grads(
        lambda x, w, bb, tok: pallas_sync_cross_entropy(x, w, bb, tok, A, G, v, 4, True),
        *inputs)
    close(loss, jl, 1e-5, 1e-6, "loss")
    for name, a, e in zip(("dfeatures", "dkernel", "dbias"), grads, jg):
        close(a, e, 1e-4, 2e-6, name)

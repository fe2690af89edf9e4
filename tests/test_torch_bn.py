"""PyTorch port: train/eval BatchNorm and the plain versions of kernels K3
and K4 against the JAX package, on the CPU."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.ops.pallas_bn import FastBatchNorm as JaxFastBatchNorm
from syncvsr_tpu.ops.pallas_bn import pallas_batch_stats, pallas_bn_bwd_stats
from syncvsr_tpu_torch.ops.cuda_bn import (
    FastBatchNorm,
    batch_norm_train,
    bn_bwd_stats_plain,
    bn_stats_plain,
)
from torch_parity import close, tt
import torch_threads  # noqa: F401  (one torch thread a test process)


def _bn_case(shape, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    scale = rng.randn(c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    ra_mean = rng.randn(c).astype(np.float32) * 0.1
    ra_var = (np.abs(rng.randn(c)) + 0.5).astype(np.float32)
    return x, scale, bias, ra_mean, ra_var


# f32: the two sides reduce in other orders; 2e-5 matches the JAX package's
# own FastBatchNorm-vs-flax test (values), 2e-4 its gradient tolerance
@pytest.mark.parametrize("shape", [(8, 6, 6, 64), (16, 32), (2, 3, 4, 4, 16)])
def test_fast_bn_train_matches_jax(shape):
    x, scale, bias, ra_mean, ra_var = _bn_case(shape, 2)
    c = shape[-1]
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(ra_mean), "var": jnp.asarray(ra_var)}}
    ref = JaxFastBatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)

    def loss(mod, v, x):
        y, mut = mod.apply(v, x, mutable=["batch_stats"])
        return jnp.sum(jnp.sin(y)), (y, mut)

    (_, (y_j, mut_j)), (gv_j, gx_j) = jax.jit(jax.value_and_grad(
        lambda v, x: loss(ref, v, x), argnums=(0, 1), has_aux=True))(variables, jnp.asarray(x))
    y_flax, _ = flax_bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])

    bn = FastBatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(tt(scale))
        bn.bias.copy_(tt(bias))
        bn.running_mean.copy_(tt(ra_mean))
        bn.running_var.copy_(tt(ra_var))
    xt = tt(x).requires_grad_()
    y = bn(xt, train=True)
    torch.sin(y).sum().backward()
    close(y, y_j, 2e-5, 2e-5, "y")
    close(y, y_flax, 2e-5, 2e-5, "y vs nn.BatchNorm")
    close(bn.running_mean, mut_j["batch_stats"]["mean"], 2e-5, 2e-5, "running mean")
    close(bn.running_var, mut_j["batch_stats"]["var"], 2e-5, 2e-5, "running var")
    close(xt.grad, gx_j, 2e-4, 2e-4, "dx")
    close(bn.weight.grad, gv_j["params"]["scale"], 2e-4, 2e-4, "dscale")
    close(bn.bias.grad, gv_j["params"]["bias"], 2e-4, 2e-4, "dbias")

    # the functional form returns the biased batch statistics
    _, mean, var = batch_norm_train(tt(x), tt(scale), tt(bias), 1e-5, torch.float32)
    x2 = x.reshape(-1, c).astype(np.float64)
    close(mean, x2.mean(0), 1e-5, 1e-5, "mean")
    close(var, x2.var(0), 1e-4, 1e-4, "var")


def test_fast_bn_eval_matches_jax():
    x, scale, bias, ra_mean, ra_var = _bn_case((4, 5, 64), 3)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(ra_mean), "var": jnp.asarray(ra_var)}}
    y_j = JaxFastBatchNorm(use_running_average=True, epsilon=1e-5).apply(
        variables, jnp.asarray(x))
    y_flax = nn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
        variables, jnp.asarray(x))
    bn = FastBatchNorm(64)
    with torch.no_grad():
        bn.weight.copy_(tt(scale))
        bn.bias.copy_(tt(bias))
        bn.running_mean.copy_(tt(ra_mean))
        bn.running_var.copy_(tt(ra_var))
    y = bn(tt(x), train=False)
    close(y, y_j, 2e-5, 2e-5, "eval y")
    close(y, y_flax, 2e-5, 2e-5, "eval y vs nn.BatchNorm")
    # eval mode leaves the running statistics alone
    close(bn.running_mean, ra_mean, 0, 0)


# K3/K4 plain vs the Pallas kernels in interpret mode: f32 sums of the same
# values in other orders, so 1e-5 relative to the summed magnitude; the
# trunk widths, the Conformer's 768, and a row count no tile divides
@pytest.mark.parametrize("c,n", [(64, 512), (128, 512), (256, 512), (512, 512), (768, 512),
                                 (768, 700)],
                         ids=["64", "128", "256", "512", "768", "768-n700"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_k4_plain_match_pallas_interpret(c, n, dtype):
    rng = np.random.RandomState(c)
    x = (rng.randn(n, c) + 0.3).astype(np.float32)
    g = rng.randn(n, c).astype(np.float32)
    mean = rng.randn(c).astype(np.float32) * 0.3
    inv = (np.abs(rng.randn(c)) + 0.5).astype(np.float32)
    jd = jnp.dtype(dtype)
    xj, gj = jnp.asarray(x, jd), jnp.asarray(g, jd)
    s_j, s2_j = pallas_batch_stats(xj, interpret=True)
    b1_j, b2_j = pallas_bn_bwd_stats(gj, xj, jnp.asarray(mean), jnp.asarray(inv),
                                     interpret=True)
    td = getattr(torch, dtype)
    xt, gt = tt(np.asarray(xj.astype(jnp.float32))).to(td), tt(np.asarray(gj.astype(jnp.float32))).to(td)
    s, s2 = bn_stats_plain(xt)
    b1, b2 = bn_bwd_stats_plain(gt, xt, tt(mean), tt(inv))
    scale = float(np.abs(x).sum(0).max())
    for name, a, e in (("sum x", s, s_j), ("sum x^2", s2, s2_j), ("sum g", b1, b1_j),
                       ("sum g*xhat", b2, b2_j)):
        close(a, e, 0, 1e-5 * scale * 4, name)

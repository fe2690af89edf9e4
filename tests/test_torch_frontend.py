"""PyTorch port: video stem, max-pool and the Conv3D-ResNet frontend (one
train-mode forward and backward) against the JAX package, on the CPU."""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.models.frontend import Conv3DResNetFrontend as JaxFrontend
from syncvsr_tpu.ops.stem import stem_conv3d_reference, stem_conv3d_s2d
from syncvsr_tpu_torch.models.frontend import Conv3DResNetFrontend
from syncvsr_tpu_torch.ops.maxpool import max_pool_3x3_s2
from syncvsr_tpu_torch.ops.stem import stem_conv3d
from syncvsr_tpu_torch.utils.bridge import from_flax, to_flax
from torch_parity import close, to_np, tt
import torch_threads  # noqa: F401  (one torch thread a test process)


@pytest.mark.parametrize("hw", [(16, 20), (15, 17)])
def test_stem_matches_reference_and_s2d(hw):
    # f32: the three forms sum the same 245 products in other orders
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, *hw, 1).astype(np.float32)
    w = (rng.randn(5, 7, 7, 1, 8) * 0.1).astype(np.float32)
    y = stem_conv3d(tt(x), tt(w.transpose(4, 3, 0, 1, 2)), torch.float32)
    assert y.is_contiguous()
    close(y, stem_conv3d_reference(jnp.asarray(x), jnp.asarray(w), jnp.float32), 1e-5, 1e-5)
    if hw[0] % 2 == 0 and hw[1] % 2 == 0:
        close(y, stem_conv3d_s2d(jnp.asarray(x), jnp.asarray(w), jnp.float32), 1e-5, 1e-5)


@pytest.mark.parametrize("shape", [(2, 3, 9, 8, 4), (3, 7, 6, 5)])
def test_maxpool_value_and_grad(shape):
    # distinct values: ties route the gradient differently in the two libraries
    rng = np.random.RandomState(1)
    x = rng.permutation(np.prod(shape)).reshape(shape).astype(np.float32) / 7.0
    g = rng.randn(*np.asarray(x[..., ::2, ::2, :].shape)).astype(np.float32)
    if len(shape) == 5:  # the frontend's [B, T, H, W, C] call
        window, strides, pad = (1, 3, 3), (1, 2, 2), ((0, 0), (1, 1), (1, 1))
    else:  # the folded [B*T, H, W, C] call
        window, strides, pad = (3, 3), (2, 2), ((1, 1), (1, 1))

    def pool(v):
        return nn.max_pool(v, window, strides, padding=pad)

    y_j, vjp = jax.vjp(pool, jnp.asarray(x))
    xt = tt(x).requires_grad_()
    y = max_pool_3x3_s2(xt)
    y.backward(tt(np.asarray(g.reshape(y.shape))))
    close(y, y_j, 0, 0, "value")
    close(xt.grad, vjp(jnp.asarray(g.reshape(y_j.shape)))[0], 0, 1e-6, "grad")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


@pytest.mark.parametrize("fold_threshold", [256, 3])
def test_frontend_train_step_matches_jax(fold_threshold):
    """One train-mode forward + backward from bridged weights: features, every
    batch_stats leaf after the update, and every parameter gradient (f32;
    20 stacked BatchNorms amplify reduction-order differences to ~1e-5)."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 16, 16, 1).astype(np.float32)
    jmod = JaxFrontend(stem_channels=16, width=8, fold_threshold=fold_threshold)
    variables = jax.jit(functools.partial(jmod.init, train=False))(jax.random.PRNGKey(0),
                                                                   jnp.asarray(x))
    params, stats = to_np(variables["params"]), to_np(variables["batch_stats"])

    def loss(p, v):
        feats, mut = jmod.apply({"params": p, "batch_stats": stats}, v, train=True,
                                mutable=["batch_stats"])
        return jnp.sum(jnp.sin(feats * 3.0)), (feats, mut["batch_stats"])

    (_, (f_j, stats_j)), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))

    mod = Conv3DResNetFrontend(stem_channels=16, width=8, fold_threshold=fold_threshold)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in from_flax(params, stats).items()},
                        strict=True)
    feats = mod(tt(x), train=True)
    torch.sin(feats * 3.0).sum().backward()
    close(feats, f_j, 1e-4, 1e-5, "features")

    _, stats_t = to_flax(mod.state_dict())
    want = dict(_leaves(to_np(stats_j)))
    got = dict(_leaves(stats_t))
    assert got.keys() == want.keys() and len(got) == 2 * 21
    for k in want:
        close(got[k], want[k], 1e-4, 1e-5, k)

    grads_t, _ = to_flax({n: p.grad for n, p in mod.named_parameters()})
    want = dict(_leaves(to_np(g_j)))
    got = dict(_leaves(grads_t))
    assert got.keys() == want.keys()
    for k in want:
        scale = float(np.abs(want[k]).max())
        close(got[k], want[k], 1e-3, 1e-4 * scale + 1e-6, k)

# Frozen copy of syncvsr_tpu_torch/ops/cuda_bn.py, part of the benchmark's plain reference;
# its statistics kernels are replaced by their plain versions.
"""Train-mode BatchNorm over channels-last activations (flax
``nn.BatchNorm`` semantics), with its statistics in plain PyTorch f32: the
port's K3/K4 kernels are replaced by the sums they compute. Variance in the
E[x^2] - E[x]^2 form, clamped at 0, biased; eps 1e-5; the analytic
backward over (sum g, sum g * xhat); running statistics once a step, not
again in a ``model.remat`` recompute."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from vsrbench.reference.models.layers import recomputing

Tensor = torch.Tensor


def bn_stats(x2d: Tensor) -> Tuple[Tensor, Tensor]:
    """[N, C] -> per-channel f32 (sum x, sum x^2)."""
    x32 = x2d.float()
    return x32.sum(0), (x32 * x32).sum(0)


def bn_bwd_stats(g2d: Tensor, x2d: Tensor, mean: Tensor, inv: Tensor
                 ) -> Tuple[Tensor, Tensor]:
    """Per-channel f32 (sum g, sum g * xhat), xhat = (x - mean) * inv."""
    g32 = g2d.float()
    xhat = (x2d.float() - mean) * inv
    return g32.sum(0), (g32 * xhat).sum(0)


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, dtype):
        c = x.shape[-1]
        x2d = x.view(-1, c)
        m = x2d.shape[0]
        s, s2 = bn_stats(x2d)
        ctx.rows = m
        mean = s / m
        var = torch.clamp(s2 / m - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        a = (inv * scale).to(dtype)
        b = (bias - mean * inv * scale).to(dtype)
        y = x.to(dtype) * a + b
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.dtype = dtype
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        # cotangents of the batch statistics (running stats) are not propagated
        x, scale, mean, inv = ctx.saved_tensors
        dtype = ctx.dtype
        c = x.shape[-1]
        gy = gy.contiguous()
        n = x.numel() // c
        g1, g2 = bn_bwd_stats(gy.view(n, c), x.view(n, c), mean, inv)
        n = ctx.rows
        k = (inv * scale).to(dtype)
        c1 = (inv * scale * g1 / n).to(dtype)
        c2 = (inv * inv * scale * g2 / n).to(dtype)
        xc = x.to(dtype) - mean.to(dtype)
        dx = gy.to(dtype) * k - (c1 + xc * c2)
        return dx, g2, g1, None, None


def batch_norm_train(x: Tensor, scale: Tensor, bias: Tensor, eps: float,
                     dtype: torch.dtype) -> Tuple[Tensor, Tensor, Tensor]:
    """Train-mode BN over all but the last axis of a contiguous tensor.
    Returns (y, mean, var); mean and var carry no gradient."""
    return _BatchNormTrain.apply(x, scale, bias, eps, dtype)


class FastBatchNorm(nn.Module):
    """BatchNorm with flax ``nn.BatchNorm`` semantics over the last axis;
    ``weight``/``bias`` and ``running_mean``/``running_var`` map to flax's
    ``scale``/``bias`` and ``batch_stats`` ``mean``/``var``."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: Tensor, train: bool) -> Tensor:
        if not train:
            inv = torch.rsqrt(self.running_var + self.eps)
            a = (inv * self.weight).to(self.dtype)
            b = (self.bias - self.running_mean * inv * self.weight).to(self.dtype)
            return x.to(self.dtype) * a + b
        y, mean, var = batch_norm_train(x, self.weight, self.bias, self.eps, self.dtype)
        if recomputing():      # a remat recompute: the forward updated them
            return y
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return y

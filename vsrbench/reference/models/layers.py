# Frozen copy of syncvsr_tpu_torch/models/layers.py, part of the benchmark's plain reference.
"""Shared building blocks (port of ``syncvsr_tpu/models/layers.py``).

Parameters stay f32; each module casts to its compute ``dtype`` where the
flax counterpart does (no autocast). Random draws (dropout, drop-path) take
an explicit ``torch.Generator`` on the activations' device.

``remat`` is flax ``nn.remat`` (``model.remat``): the region's activations
are dropped after the forward and recomputed in the backward
(``torch.utils.checkpoint``), with the same dropout masks and without a
second update of the BatchNorm running statistics.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

Tensor = torch.Tensor

# set while a ``remat`` region is recomputed, in the thread that runs the
# backward (autograd's device thread for CUDA tensors)
_remat = threading.local()


def recomputing() -> bool:
    """Whether a ``remat`` region is being recomputed in the backward: a
    train-mode BatchNorm then leaves its running statistics alone (flax
    drops the recompute's ``batch_stats`` mutation)."""
    return getattr(_remat, "recomputing", False)


def remat(gen: Optional[torch.Generator], fn, *args):
    """``fn(*args)``, its activations recomputed in the backward instead of
    kept (non-reentrant ``torch.utils.checkpoint``). ``torch.utils.checkpoint``
    replays only the global RNG; the recompute here starts ``gen`` (the
    region's dropout generator, if any) from its state at the forward, so it
    draws the same masks, and puts it back afterwards, so the draws after
    the region do not move. Without autograd it is the plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    at_forward = gen.get_state() if gen is not None else None
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*a)
        live = gen.get_state() if gen is not None else None
        if gen is not None:
            gen.set_state(at_forward)
        _remat.recomputing = True
        try:
            return fn(*a)
        finally:   # a recompute may stop early by raising
            _remat.recomputing = False
            if gen is not None:
                gen.set_state(live)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def trunc_normal_(t: Tensor, std: float = 0.02) -> Tensor:
    """Truncated normal in [-2 std, 2 std] (flax ``trunc_normal`` init)."""
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std)


def variance_scaling_fan_out_(t: Tensor, fan_out: int) -> Tensor:
    """flax ``variance_scaling(2.0, "fan_out", "truncated_normal")``."""
    std = math.sqrt(2.0 / fan_out) / 0.87962566103423978
    return trunc_normal_(t, std)


def lecun_normal_(t: Tensor, fan_in: int) -> Tensor:
    """flax ``lecun_normal`` (the default kernel init of ``nn.Dense``,
    ``nn.DenseGeneral`` and ``nn.Conv``): truncated normal of variance
    1 / fan_in."""
    return trunc_normal_(t, math.sqrt(1.0 / fan_in) / 0.87962566103423978)


def activation(name: str):
    # flax nn.gelu defaults to the tanh approximation; "prelu" is the JAX
    # package's parameter-free stand-in, flax nn.leaky_relu (slope 0.01),
    # not torch's PReLU
    return {
        "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "swish": F.silu,
        "silu": F.silu,
        "prelu": lambda x: F.leaky_relu(x, 0.01),
    }[name]


def dropout(x: Tensor, rate: float, det: bool, gen: Optional[torch.Generator]) -> Tensor:
    """Element dropout with flax semantics: keep with p = 1 - rate, scale
    kept values by 1 / p."""
    if det or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def drop_path(x: Tensor, rate: float, det: bool, gen: Optional[torch.Generator]) -> Tensor:
    """Stochastic depth: one keep decision per sample, broadcast over the
    remaining axes."""
    if det or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.rand(shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense`` with f32 params: ``weight`` [out, in], ``bias``
    [out]; input, weight and bias are cast to ``dtype`` before the product.
    The weight starts truncated-normal at std 0.02, or at flax's default
    ``lecun_normal`` with ``lecun=True``."""

    def __init__(self, din: int, dout: int, dtype: torch.dtype = torch.float32,
                 lecun: bool = False):
        super().__init__()
        self.dtype = dtype
        w = torch.empty(dout, din)
        self.weight = nn.Parameter(lecun_normal_(w, din) if lecun else trunc_normal_(w))
        self.bias = nn.Parameter(torch.zeros(dout))

    def forward(self, x: Tensor) -> Tensor:
        d = self.dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


class _Affine(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, computed in f32, emitting ``dtype``;
    eps 1e-6 (torch's default is 1e-5). The parameters sit in a submodule
    ``LayerNorm_0``, where flax's wrapper module auto-names its inner
    ``nn.LayerNorm`` (``.../norm_mha/LayerNorm_0/{scale,bias}``)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32, eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.LayerNorm_0 = _Affine(dim)

    def forward(self, x: Tensor) -> Tensor:
        p = self.LayerNorm_0
        y = F.layer_norm(x.float(), (x.shape[-1],), p.weight, p.bias, self.eps)
        return y.to(self.dtype)


class RMSNorm(nn.Module):
    """Root-mean-square norm, f32 inside, eps 1e-6; emits ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32, eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: Tensor) -> Tensor:
        x32 = x.float()
        x32 = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + self.eps)
        return (x32 * self.weight).to(self.dtype)


def rotate_half(x: Tensor) -> Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


def rope_angles(positions: Tensor, head_dim: int, base: float = 10000.0
                ) -> Tuple[Tensor, Tensor]:
    """cos/sin tables [T, d/2]; frequencies ``base ** -linspace(0, 1, d/2,
    endpoint=False)``."""
    half = head_dim // 2
    freqs = base ** -(torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    theta = positions[..., None].float() * freqs
    return torch.cos(theta), torch.sin(theta)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """Rotary embedding on x [B, T, H, D], split-halves pairing."""
    c = torch.cat((cos, cos), dim=-1)[None, :, None, :].to(x.dtype)
    s = torch.cat((sin, sin), dim=-1)[None, :, None, :].to(x.dtype)
    return x * c + rotate_half(x) * s


class FeedForward(nn.Module):
    """Position-wise feed-forward: the GLU form ``wo(gelu(wi_gate(x)) *
    wi(x))`` or the plain ``wo(gelu(wi(x)))`` (leaves ``wi`` and ``wo``
    only), dropout before ``wo``."""

    def __init__(self, dim: int, hidden: int, dropout: float = 0.0, use_glu: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rate = dropout
        if use_glu:
            self.wi_gate = Dense(dim, hidden, dtype)
        self.wi = Dense(dim, hidden, dtype)
        self.wo = Dense(hidden, dim, dtype)

    def forward(self, x: Tensor, det: bool = True,
                gen: Optional[torch.Generator] = None) -> Tensor:
        if hasattr(self, "wi_gate"):
            h = F.gelu(self.wi_gate(x), approximate="tanh") * self.wi(x)
        else:
            h = F.gelu(self.wi(x), approximate="tanh")
        return self.wo(dropout(h, self.rate, det, gen))


def dot_attention(q: Tensor, k: Tensor, v: Tensor, bias: Optional[Tensor],
                  rate: float, det: bool, gen: Optional[torch.Generator],
                  dtype: torch.dtype) -> Tensor:
    """Softmax attention over q, k, v [B, T, H, D]: f32 scores and softmax,
    the probability-value product from ``dtype`` operands with f32
    accumulation; returns [B, T, H, D] in ``dtype``."""
    depth = q.shape[-1]
    qh = q.float().permute(0, 2, 1, 3)
    kh = k.float().permute(0, 2, 3, 1)
    scores = torch.matmul(qh, kh) / math.sqrt(depth)
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    probs = dropout(probs, rate, det, gen).to(dtype)
    out = torch.matmul(probs.float(), v.to(dtype).float().permute(0, 2, 1, 3))
    return out.permute(0, 2, 1, 3).to(dtype)


def make_pad_bias(pad_mask: Tensor) -> Tensor:
    """[B, T] boolean keep-mask -> additive f32 attention bias [B, 1, 1, T]:
    0 where kept, the f32 minimum where padded."""
    neg = torch.finfo(torch.float32).min
    return torch.where(pad_mask[:, None, None, :], 0.0, neg)


def causal_bias(t: int, device=None) -> Tensor:
    """Additive f32 causal mask [1, 1, T, T]: 0 on and below the diagonal,
    the f32 minimum above it."""
    keep = torch.ones((t, t), dtype=torch.bool, device=device).tril()
    return torch.where(keep, 0.0, torch.finfo(torch.float32).min)[None, None]

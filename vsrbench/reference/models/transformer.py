# Frozen copy of syncvsr_tpu_torch/models/transformer.py, part of the benchmark's plain reference.
"""Pre-norm rotary transformer encoder (port of
``syncvsr_tpu/models/transformer.py``), both flavours of the JAX module:
RMSNorm + GLU feed-forward (the LRW video stack) or LayerNorm + plain GELU
feed-forward (the LRW landmark stack), chosen by ``use_rmsnorm`` and
``use_glu``, with rotary attention and drop-path.

The attention's inner width (``dim`` = heads x head_dim) may differ from the
residual stream it reads and writes: on ``lrw_video`` the stream is 513
wide (the word-boundary channel) and the attention 512.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vsrbench.reference.models.layers import (
    FeedForward,
    LayerNorm,
    RMSNorm,
    apply_rope,
    dot_attention,
    drop_path,
    lecun_normal_,
    remat,
    rope_angles,
    trunc_normal_,
)

Tensor = torch.Tensor


class HeadProjection(nn.Module):
    """flax ``DenseGeneral((heads, head_dim))``: ``weight`` [H, Dh, in],
    ``bias`` [H, Dh] (none with ``bias=False``); [B, T, in] -> [B, T, H, Dh].
    The weight starts at std 0.02, or at flax's ``lecun_normal``."""

    def __init__(self, din: int, heads: int, head_dim: int, dtype: torch.dtype,
                 bias: bool = True, lecun: bool = False):
        super().__init__()
        self.dtype = dtype
        w = torch.empty(heads, head_dim, din)
        self.weight = nn.Parameter(lecun_normal_(w, din) if lecun else trunc_normal_(w))
        self.bias = nn.Parameter(torch.zeros(heads, head_dim)) if bias else None

    def forward(self, x: Tensor) -> Tensor:
        h, dh, din = self.weight.shape
        d = self.dtype
        b = None if self.bias is None else self.bias.to(d).reshape(-1)
        x = x.to(d)
        y = F.linear(x, self.weight.to(d).reshape(h * dh, din), b)
        return y.reshape(*x.shape[:-1], h, dh)


class HeadMerge(nn.Module):
    """flax ``DenseGeneral(out, axis=(-2, -1))``: ``weight`` [out, H, Dh],
    ``bias`` [out]; [B, T, H, Dh] -> [B, T, out]."""

    def __init__(self, heads: int, head_dim: int, dout: int, dtype: torch.dtype,
                 lecun: bool = False):
        super().__init__()
        self.dtype = dtype
        w = torch.empty(dout, heads, head_dim)
        self.weight = nn.Parameter(lecun_normal_(w, heads * head_dim) if lecun
                                   else trunc_normal_(w))
        self.bias = nn.Parameter(torch.zeros(dout))

    def forward(self, o: Tensor) -> Tensor:
        d = self.dtype
        dout = self.weight.shape[0]
        x = o.reshape(*o.shape[:-2], -1).to(d)
        w = self.weight.to(d).reshape(dout, -1)
        return F.linear(x, w, self.bias.to(d))


class RotaryAttention(nn.Module):
    def __init__(self, stream: int, dim: int, heads: int, dropout: float = 0.0,
                 rope: bool = True, rope_dim: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.head_dim = dim // heads
        self.rate = dropout
        self.rope = rope
        self.rope_dim = rope_dim or self.head_dim
        self.dtype = dtype
        self.wq = HeadProjection(stream, heads, self.head_dim, dtype)
        self.wk = HeadProjection(stream, heads, self.head_dim, dtype)
        self.wv = HeadProjection(stream, heads, self.head_dim, dtype)
        self.wo = HeadMerge(heads, self.head_dim, stream, dtype)

    def forward(self, x: Tensor, positions: Tensor, det: bool = True,
                gen: Optional[torch.Generator] = None) -> Tensor:
        q, k, v = self.wq(x), self.wk(x), self.wv(x)
        if self.rope:
            rd = self.rope_dim
            cos, sin = rope_angles(positions, rd)
            if rd == self.head_dim:
                q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            else:  # partial rotary: the tail dims stay unrotated
                q = torch.cat((apply_rope(q[..., :rd], cos, sin), q[..., rd:]), dim=-1)
                k = torch.cat((apply_rope(k[..., :rd], cos, sin), k[..., rd:]), dim=-1)
        o = dot_attention(q, k, v, None, self.rate, det, gen, self.dtype)
        return self.wo(o)


class TransformerBlock(nn.Module):
    def __init__(self, stream: int, dim: int, heads: int, hidden: int,
                 use_rmsnorm: bool = True, use_glu: bool = True, rope: bool = True,
                 rope_dim: int = 0, msa_dropout: float = 0.0, mlp_dropout: float = 0.0,
                 droppath: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        norm = RMSNorm if use_rmsnorm else LayerNorm
        self.droppath = droppath
        self.norm_attn = norm(stream, dtype)
        self.attn = RotaryAttention(stream, dim, heads, msa_dropout, rope, rope_dim, dtype)
        self.norm_ff = norm(stream, dtype)
        self.ff = FeedForward(stream, hidden, mlp_dropout, use_glu, dtype)

    def forward(self, x: Tensor, positions: Tensor, det: bool = True,
                gen: Optional[torch.Generator] = None) -> Tensor:
        x = x + drop_path(self.attn(self.norm_attn(x), positions, det, gen),
                          self.droppath, det, gen)
        x = x + drop_path(self.ff(self.norm_ff(x), det, gen), self.droppath, det, gen)
        return x


class TransformerEncoder(nn.Module):
    """Stack of pre-norm rotary blocks over [B, T, stream], then a final
    norm over every position, under flax's auto-name: ``RMSNorm_0``, or
    ``LayerNorm_0`` (whose own parameters sit in a further ``LayerNorm_0``).
    With ``remat`` each block's activations are recomputed in the backward
    (``layers.remat``, as the JAX package's ``nn.remat`` of the block)."""

    def __init__(self, stream: int, layers: int, dim: int, heads: int, hidden: int,
                 use_rmsnorm: bool = True, use_glu: bool = True, rope: bool = True,
                 rope_dim: int = 0, msa_dropout: float = 0.0, mlp_dropout: float = 0.0,
                 droppath: float = 0.0, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.layers = layers
        self.remat = remat
        for i in range(layers):
            self.add_module(f"block_{i}", TransformerBlock(
                stream, dim, heads, hidden, use_rmsnorm, use_glu, rope, rope_dim,
                msa_dropout, mlp_dropout, droppath, dtype))
        if use_rmsnorm:
            self.RMSNorm_0 = RMSNorm(stream, dtype)
        else:
            self.LayerNorm_0 = LayerNorm(stream, dtype)

    def forward(self, x: Tensor, det: bool = True,
                gen: Optional[torch.Generator] = None) -> Tensor:
        positions = torch.arange(x.shape[1], device=x.device)
        for i in range(self.layers):
            block = getattr(self, f"block_{i}")
            x = (remat(gen, block, x, positions, det, gen) if self.remat
                 else block(x, positions, det, gen))
        final = self.RMSNorm_0 if hasattr(self, "RMSNorm_0") else self.LayerNorm_0
        return final(x)

# Frozen copy of syncvsr_tpu_torch/models/conformer.py, part of the benchmark's plain reference.
"""Conformer encoder for sentence-level VSR (port of
``syncvsr_tpu/models/conformer.py``): macaron feed-forwards (0.5x, ReLU),
relative-position multi-head attention (Transformer-XL style, the
reshape rel-shift), a
convolution module (pointwise GLU ->
depthwise k=31 -> BatchNorm -> swish -> pointwise), pre-LN blocks, and a
final LayerNorm. The input embedding scales by sqrt(d) and the encoder
builds the relative sinusoid table.

Scores and softmax are f32; the products take ``dtype`` operands with f32
accumulation, as the flax einsums with ``preferred_element_type=f32``.
In train mode dropout draws from ``gen`` on the activations' device: one
mask over the shared [2T-1, D] position table, one over the attention
probabilities. The convolution module's BatchNorm is ``FastBatchNorm`` over
the contiguous [B*T, C] view (kernels K3 and K4 on the GPU); its statistics
cover every position, padding included, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vsrbench.reference.models.layers import (
    Dense,
    LayerNorm,
    dropout,
    lecun_normal_,
    make_pad_bias,
    remat,
)
from vsrbench.reference.models.transformer import HeadMerge, HeadProjection
from vsrbench.reference.ops.cuda_bn import FastBatchNorm

Tensor = torch.Tensor


def rel_sinusoid_table(t: int, dim: int, dtype: torch.dtype = torch.float32,
                       device=None) -> Tensor:
    """Positions t-1 .. -(t-1): the [2T-1, D] sinusoid table, sin on even
    and cos on odd columns, computed in f32."""
    pos = torch.arange(t - 1, -t, -1, dtype=torch.float32, device=device)
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / dim))
    angles = pos[:, None] * div[None, :]
    pe = torch.zeros((2 * t - 1, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles)
    return pe.to(dtype)


def rel_shift(x: Tensor, t0: int = 0) -> Tensor:
    """[B, H, Tq, 2T-1] -> [B, H, Tq, T]: column j of row i holds relative
    distance (t0 + i) - j, the table's column T-1 - (t0 + i) + j (queries
    t0 .. t0+Tq-1 of a clip of T frames; the square case is Tq = T, t0 = 0).
    The rows' windows lie in columns [c - Tq + 1, c + T) with c = T-1 - t0:
    that [Tq, W] slice (W = T + Tq - 1), read flat from element Tq - 1 as
    rows of W - 1, gives row i's window in its first T columns (the
    pad-and-reshape shift of the square case, without the pad)."""
    b, h, tq, w2 = x.shape
    t = (w2 + 1) // 2
    c = t - 1 - t0
    x = x[..., c - tq + 1:c + t]
    if tq == 1:
        return x
    w = t + tq - 1
    x = x.reshape(b, h, tq * w)[..., tq - 1:tq - 1 + tq * (w - 1)]
    return x.reshape(b, h, tq, w - 1)[..., :t]


def _xavier_uniform_(t: Tensor) -> Tensor:
    """flax ``xavier_uniform`` on a 2-D [H, Dk] leaf (fan_in H, fan_out Dk)."""
    limit = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    with torch.no_grad():
        return t.uniform_(-limit, limit)


class RelPositionAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.d_k = dim // heads
        self.rate = dropout
        self.dtype = dtype
        self.wq = HeadProjection(dim, heads, self.d_k, dtype, lecun=True)
        self.wk = HeadProjection(dim, heads, self.d_k, dtype, lecun=True)
        self.wv = HeadProjection(dim, heads, self.d_k, dtype, lecun=True)
        self.linear_pos = HeadProjection(dim, heads, self.d_k, dtype, bias=False,
                                         lecun=True)
        self.pos_bias_u = nn.Parameter(_xavier_uniform_(torch.empty(heads, self.d_k)))
        self.pos_bias_v = nn.Parameter(_xavier_uniform_(torch.empty(heads, self.d_k)))
        self.wo = HeadMerge(heads, self.d_k, dim, dtype, lecun=True)

    def forward(self, x: Tensor, pos_emb: Tensor, bias: Optional[Tensor] = None,
                det: bool = True, gen: Optional[torch.Generator] = None) -> Tensor:
        dt = self.dtype
        q, k, v = self.wq(x), self.wk(x), self.wv(x)                 # [B, T, H, Dk]
        p = self.linear_pos(pos_emb)                                 # [2T-1, H, Dk]
        qu = (q + self.pos_bias_u.to(dt)).float().permute(0, 2, 1, 3)
        qv = (q + self.pos_bias_v.to(dt)).float().permute(0, 2, 1, 3)
        ac = torch.matmul(qu, k.float().permute(0, 2, 3, 1))         # [B, H, Tq, T]
        bd = torch.matmul(qv, p.float().permute(1, 2, 0))            # [B, H, Tq, 2T-1]
        scores = (ac + rel_shift(bd)) / math.sqrt(self.d_k)
        if bias is not None:
            scores = scores + bias.float()
        probs = torch.softmax(scores, dim=-1)
        probs = dropout(probs, self.rate, det, gen)
        o = torch.matmul(probs.to(dt).float(), v.float().permute(0, 2, 1, 3))
        return self.wo(o.permute(0, 2, 1, 3).to(dt))


class ConvModule(nn.Module):
    def __init__(self, dim: int, kernel: int = 31, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.pw1 = Dense(dim, 2 * dim, dtype, lecun=True)
        # depthwise, SAME padding; the flax kernel (K, 1, C) is ``weight``
        # [C, 1, K] here
        self.dw = nn.Conv1d(dim, dim, kernel, padding=(kernel - 1) // 2, groups=dim)
        with torch.no_grad():
            lecun_normal_(self.dw.weight, kernel)
            self.dw.bias.zero_()
        self.bn = FastBatchNorm(dim, dtype)
        self.pw2 = Dense(dim, dim, dtype, lecun=True)

    def forward(self, x: Tensor, pad_mask: Optional[Tensor] = None,
                train: bool = False) -> Tensor:
        dt = self.dtype
        if pad_mask is not None:   # zero padded frames before the depthwise conv
            x = x * pad_mask[:, :, None].to(x.dtype)
        a, g = self.pw1(x).chunk(2, dim=-1)
        h = a * torch.sigmoid(g)                                       # GLU
        # over [B, C, T], back to a contiguous [B, T, C] for the BatchNorm
        w, b = self.dw.weight.to(dt), self.dw.bias.to(dt)
        h = F.conv1d(h.transpose(1, 2), w, b, padding=self.dw.padding[0],
                     groups=self.dw.groups)
        h = h.transpose(1, 2).contiguous()
        h = self.bn(h, train)
        h = h * torch.sigmoid(h)                                       # swish
        return self.pw2(h)


class ConformerFeedForward(nn.Module):
    """Position-wise feed-forward, ReLU (the vendored espnet's choice)."""

    def __init__(self, dim: int, hidden: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rate = dropout
        self.w1 = Dense(dim, hidden, dtype, lecun=True)
        self.w2 = Dense(hidden, dim, dtype, lecun=True)

    def forward(self, x: Tensor, det: bool = True,
                gen: Optional[torch.Generator] = None) -> Tensor:
        return self.w2(dropout(F.relu(self.w1(x)), self.rate, det, gen))


class ConformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int, conv_kernel: int = 31,
                 macaron: bool = True, dropout: float = 0.1, attn_dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.macaron = macaron
        self.rate = dropout
        if macaron:
            self.norm_ff_macaron = LayerNorm(dim, dtype)
            self.ff_macaron = ConformerFeedForward(dim, hidden, dropout, dtype)
        self.norm_mha = LayerNorm(dim, dtype)
        self.attn = RelPositionAttention(dim, heads, attn_dropout, dtype)
        self.norm_conv = LayerNorm(dim, dtype)
        self.conv = ConvModule(dim, conv_kernel, dtype)
        self.norm_ff = LayerNorm(dim, dtype)
        self.ff = ConformerFeedForward(dim, hidden, dropout, dtype)
        self.norm_final = LayerNorm(dim, dtype)

    def forward(self, x: Tensor, pos_emb: Tensor, bias: Optional[Tensor],
                pad_mask: Optional[Tensor], det: bool = True,
                gen: Optional[torch.Generator] = None) -> Tensor:
        def drop(h):
            return dropout(h, self.rate, det, gen)

        if self.macaron:
            x = x + 0.5 * drop(self.ff_macaron(self.norm_ff_macaron(x), det, gen))
        x = x + drop(self.attn(self.norm_mha(x), pos_emb, bias, det, gen))
        x = x + drop(self.conv(self.norm_conv(x), pad_mask, not det))
        x = x + (0.5 if self.macaron else 1.0) * drop(self.ff(self.norm_ff(x), det, gen))
        return self.norm_final(x)


class ConformerEncoder(nn.Module):
    """[B, T, D_in] (frontend features) -> [B, T, dim]. With ``remat`` each
    block's activations are recomputed in the backward (``layers.remat``,
    as the JAX package's ``nn.remat`` of the block)."""

    def __init__(self, din: int, layers: int, dim: int, heads: int, hidden: int,
                 conv_kernel: int = 31, macaron: bool = True, dropout: float = 0.1,
                 attn_dropout: float = 0.1, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.layers = layers
        self.remat = remat
        self.dim = dim
        self.rate = dropout
        self.dtype = dtype
        self.embed = Dense(din, dim, dtype, lecun=True)
        for i in range(layers):
            self.add_module(f"block_{i}", ConformerBlock(
                dim, heads, hidden, conv_kernel, macaron, dropout, attn_dropout, dtype))
        self.after_norm = LayerNorm(dim, dtype)

    def forward(self, x: Tensor, pad_mask: Optional[Tensor] = None, det: bool = True,
                gen: Optional[torch.Generator] = None) -> Tensor:
        t = x.shape[1]
        x = self.embed(x) * math.sqrt(self.dim)
        x = dropout(x, self.rate, det, gen)
        pos_emb = rel_sinusoid_table(t, self.dim, self.dtype, x.device)
        pos_emb = dropout(pos_emb, self.rate, det, gen)   # one mask for the batch
        bias = None if pad_mask is None else make_pad_bias(pad_mask)
        for i in range(self.layers):
            block = getattr(self, f"block_{i}")
            x = (remat(gen, block, x, pos_emb, bias, pad_mask, det, gen) if self.remat
                 else block(x, pos_emb, bias, pad_mask, det, gen))
        return self.after_norm(x)

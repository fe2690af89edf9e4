"""Transformer attention decoder, teacher-forced path (port of
``syncvsr_tpu/models/decoder.py``): embedding + sinusoidal PE (scaled by
sqrt(d)), pre-LN blocks of causal self-attention, source attention over the
encoder memory and a ReLU feed-forward; a trailing LayerNorm and an f32
vocab projection.

The self-attention bias is the causal bias plus the padding bias, both the
f32 minimum, so masked entries of a padded future position sum to -inf;
that is harmless because the scores stay f32 and every row keeps its first
position. The decoding step, its KV cache and the precomputed memory
projections are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from syncvsr_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    causal_bias,
    dot_attention,
    dropout,
    make_pad_bias,
)
from syncvsr_tpu_torch.models.transformer import HeadMerge, HeadProjection

Tensor = torch.Tensor


def sinusoid_pe(t: int, dim: int, offset: int = 0, dtype: torch.dtype = torch.float32,
                device=None) -> Tensor:
    """Absolute positions offset .. offset+t-1: [T, D], sin on even and cos
    on odd columns, computed in f32."""
    pos = torch.arange(offset, offset + t, dtype=torch.float32, device=device)
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / dim))
    angles = pos[:, None] * div[None, :]
    pe = torch.zeros((t, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles)
    return pe.to(dtype)


class MHA(nn.Module):
    def __init__(self, dim: int, heads: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d_k = dim // heads
        self.rate = dropout
        self.dtype = dtype
        self.wq = HeadProjection(dim, heads, d_k, dtype, lecun=True)
        self.wk = HeadProjection(dim, heads, d_k, dtype, lecun=True)
        self.wv = HeadProjection(dim, heads, d_k, dtype, lecun=True)
        self.wo = HeadMerge(heads, d_k, dim, dtype, lecun=True)

    def forward(self, q_in: Tensor, kv_in: Tensor, bias: Optional[Tensor],
                det: bool = True, gen: Optional[torch.Generator] = None) -> Tensor:
        q, k, v = self.wq(q_in), self.wk(kv_in), self.wv(kv_in)
        return self.wo(dot_attention(q, k, v, bias, self.rate, det, gen, self.dtype))


class FF(nn.Module):
    def __init__(self, dim: int, hidden: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rate = dropout
        self.w1 = Dense(dim, hidden, dtype, lecun=True)
        self.w2 = Dense(hidden, dim, dtype, lecun=True)

    def forward(self, x: Tensor, det: bool = True,
                gen: Optional[torch.Generator] = None) -> Tensor:
        return self.w2(dropout(F.relu(self.w1(x)), self.rate, det, gen))


class DecoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rate = dropout
        self.self_attn = MHA(dim, heads, dropout, dtype)
        self.src_attn = MHA(dim, heads, dropout, dtype)
        self.ff = FF(dim, hidden, dropout, dtype)
        self.norm1 = LayerNorm(dim, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.norm3 = LayerNorm(dim, dtype)

    def forward(self, x: Tensor, self_bias: Tensor, memory: Tensor,
                mem_bias: Optional[Tensor], det: bool = True,
                gen: Optional[torch.Generator] = None) -> Tensor:
        def drop(h):
            return dropout(h, self.rate, det, gen)

        h = self.norm1(x)
        x = x + drop(self.self_attn(h, h, self_bias, det, gen))
        x = x + drop(self.src_attn(self.norm2(x), memory, mem_bias, det, gen))
        return x + drop(self.ff(self.norm3(x), det, gen))


class _Embed(nn.Module):
    """flax ``nn.Embed``: the table ``embedding`` [V, D] (f32; the flax leaf
    name, which the optimizer does not decay), looked up in ``dtype``."""

    def __init__(self, vocab: int, dim: int):
        super().__init__()
        # flax default_embed_init: variance_scaling(1.0, "fan_in", "normal", out_axis=0)
        self.embedding = nn.Parameter(torch.randn(vocab, dim) / math.sqrt(dim))


class TransformerDecoder(nn.Module):
    def __init__(self, vocab: int, layers: int = 6, dim: int = 768, heads: int = 12,
                 hidden: int = 3072, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = layers
        self.dim = dim
        self.rate = dropout
        self.dtype = dtype
        self.embed = _Embed(vocab, dim)
        for i in range(layers):
            self.add_module(f"block_{i}", DecoderLayer(dim, heads, hidden, dropout, dtype))
        self.after_norm = LayerNorm(dim, dtype)
        self.output = Dense(dim, vocab, torch.float32, lecun=True)

    def _embed(self, ys: Tensor, det: bool = True,
               gen: Optional[torch.Generator] = None) -> Tensor:
        x = self.embed.embedding.to(self.dtype)[ys.long()] * math.sqrt(self.dim)
        x = x + sinusoid_pe(ys.shape[1], self.dim, 0, self.dtype, ys.device)[None]
        return dropout(x, self.rate, det, gen)

    def forward(self, ys_in: Tensor, ys_in_lengths: Tensor, memory: Tensor,
                memory_mask: Optional[Tensor], det: bool = True,
                gen: Optional[torch.Generator] = None) -> Tensor:
        """Teacher-forced: ys_in [B, L] -> f32 logits [B, L, V]."""
        l = ys_in.shape[1]
        x = self._embed(ys_in, det, gen)
        pad_keep = torch.arange(l, device=ys_in.device)[None, :] < ys_in_lengths[:, None]
        self_bias = causal_bias(l, ys_in.device) + make_pad_bias(pad_keep)
        mem_bias = None if memory_mask is None else make_pad_bias(memory_mask)
        for i in range(self.layers):
            x = getattr(self, f"block_{i}")(x, self_bias, memory, mem_bias, det, gen)
        return self.output(self.after_norm(x).float())

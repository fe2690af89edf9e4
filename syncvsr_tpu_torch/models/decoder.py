"""Transformer attention decoder, teacher-forced path (port of
``syncvsr_tpu/models/decoder.py``): embedding + sinusoidal PE (scaled by
sqrt(d)), pre-LN blocks of causal self-attention, source attention over the
encoder memory and a ReLU feed-forward; a trailing LayerNorm and an f32
vocab projection.

The self-attention bias is the causal bias plus the padding bias, both the
f32 minimum, so masked entries of a padded future position sum to -inf;
that is harmless because the scores stay f32 and every row keeps its first
position.

Decoding: ``TransformerDecoder.step`` attends from one new token per row
over a self-attention K/V cache of every layer stacked as [N, layers, L, H,
Dk] (written in place at (layer, pos)), and over the encoder memory's
cross-attention K/V, projected once per utterance by ``precompute_memory``
and shared by every hypothesis of that utterance (``MHA.attend_shared``).
``grow_cache`` resizes the length axis between the beam search's stages.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

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
from syncvsr_tpu_torch.parallel import tensor

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

    def project_kv(self, kv_in: Tensor) -> Tuple[Tensor, Tensor]:
        return self.wk(kv_in), self.wv(kv_in)

    def attend_cached(self, q_in: Tensor, k: Tensor, v: Tensor,
                      bias: Optional[Tensor]) -> Tensor:
        q = self.wq(q_in)
        return self.wo(dot_attention(q, k, v, bias, 0.0, True, None, self.dtype))

    def attend_shared(self, q_in: Tensor, k: Tensor, v: Tensor,
                      mem_bias: Optional[Tensor]) -> Tensor:
        """Single-query attention of q_in [N, 1, D] over K/V [B, T, H, Dk]
        that the N // B consecutive rows of each utterance share (the beam's
        hypotheses attend one encoder memory); ``mem_bias`` [B, T] additive
        f32. Scores, softmax and both products in f32 (the JAX package's
        ``preferred_element_type``: a bf16 matmul here would round its
        output to bf16), probabilities and output rounded to ``dtype``."""
        b, t, h, dk = k.shape
        q = self.wq(q_in[:, 0]).float().reshape(b, -1, h, dk)           # [B, W, H, Dk]
        scores = torch.einsum("bwhd,bthd->bwht", q, k.float()) / math.sqrt(dk)
        if mem_bias is not None:
            scores = scores + mem_bias[:, None, None, :]
        probs = torch.softmax(scores, dim=-1).to(self.dtype)
        o = torch.einsum("bwht,bthd->bwhd", probs.float(), v.to(self.dtype).float())
        return self.wo(o.to(self.dtype).reshape(-1, h, dk))[:, None, :]


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

    def project_step_kv(self, x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """x [N, 1, D], the new token -> (its normed input h, its
        self-attention K/V [N, 1, H, Dk]) for the cache write."""
        h = self.norm1(x)
        k_new, v_new = self.self_attn.project_kv(h)
        return h, k_new, v_new

    def step_attend(self, x: Tensor, h: Tensor, k: Tensor, v: Tensor, self_bias: Tensor,
                    memory: Optional[Tensor], mem_bias: Optional[Tensor],
                    mem_kv: Optional[Dict[str, Tensor]] = None) -> Tensor:
        """Finish one decode step over this layer's cache k, v [N, L, H,
        Dk] (the new token already written); ``self_bias`` keeps the
        positions <= pos. With ``mem_kv`` ({"k", "v"} [B, T, H, Dk] from
        ``precompute_memory``) the cross-attention skips its K/V
        projections and ``mem_bias`` is [B, T]; without, it attends
        ``memory`` [N, T, D] under ``mem_bias`` [N, 1, 1, T]."""
        x = x + self.self_attn.attend_cached(h, k, v, self_bias)
        if mem_kv is not None:
            x = x + self.src_attn.attend_shared(self.norm2(x), mem_kv["k"], mem_kv["v"],
                                                mem_bias)
        else:
            x = x + self.src_attn(self.norm2(x), memory, mem_bias)
        return x + self.ff(self.norm3(x))


def grow_cache(cache: Dict[str, Tensor], new_len: int) -> Dict[str, Tensor]:
    """Pad the length axis (axis 2 of [N, layers, L, H, Dk]) of a stacked
    K/V cache with zeros up to ``new_len`` (positions past the current one
    are never attended). The TransformerLM's cache has the same layout.
    The JAX package's version also shrinks, for its LM's fresh cache; here
    every cache starts at its first stage's capacity."""
    return {k: F.pad(v, (0, 0, 0, 0, 0, new_len - v.shape[2])) for k, v in cache.items()}


def step_bias(length: int, pos: int, device=None) -> Tensor:
    """Additive f32 bias [1, 1, 1, L] of a decode step at ``pos``: 0 on
    the positions <= pos, the f32 minimum after them."""
    keep = torch.arange(length, device=device) <= pos
    return torch.where(keep, 0.0, torch.finfo(torch.float32).min)[None, None, None]


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
        table = self.embed.embedding
        x = table.to(self.dtype)[ys.long()]
        if tensor.split_dim(table) is not None:   # this rank's columns of the width
            x = tensor.gather_from_model(x)
        x = x * math.sqrt(self.dim)
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

    def init_cache(self, batch: int, max_len: int) -> Dict[str, Tensor]:
        """Self-attention K/V of every layer stacked on axis 1, [N, layers,
        L, H, Dk] in ``dtype``: the beam search reorders hypotheses with one
        gather per tensor, not one per layer."""
        blk = self.block_0.self_attn.wk
        heads, d_k = blk.weight.shape[:2]
        shape = (batch, self.layers, max_len, heads, d_k)
        dev = blk.weight.device
        return {"k": torch.zeros(shape, dtype=self.dtype, device=dev),
                "v": torch.zeros(shape, dtype=self.dtype, device=dev)}

    def precompute_memory(self, memory: Tensor) -> Dict[str, Dict[str, Tensor]]:
        """Every layer's cross-attention K/V [B, T, H, Dk] of the encoder
        memory [B, T, D], projected once for all decode steps."""
        out = {}
        for i in range(self.layers):
            k, v = getattr(self, f"block_{i}").src_attn.project_kv(memory)
            out[f"block_{i}"] = {"k": k, "v": v}
        return out

    def step(self, y_prev: Tensor, pos: int, cache: Dict[str, Tensor],
             memory: Optional[Tensor], memory_mask: Optional[Tensor],
             mem_kv: Optional[Dict] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
        """One decode step: y_prev [N] token ids at position ``pos`` ->
        (f32 log-probs [N, V] of the next token, the cache, updated in
        place). With ``mem_kv``, ``memory_mask`` is [B, T] per utterance and
        N = B x hypotheses; without, ``memory`` [N, T, D] and
        ``memory_mask`` [N, T]."""
        x = self.embed.embedding[y_prev.long()].to(self.dtype)[:, None] * math.sqrt(self.dim)
        x = x + sinusoid_pe(1, self.dim, pos, self.dtype, x.device)[None]
        mem_bias = None
        if memory_mask is not None:
            mem_bias = torch.where(memory_mask, 0.0, torch.finfo(torch.float32).min)
            if mem_kv is None:
                mem_bias = mem_bias[:, None, None, :]
        k_all, v_all = cache["k"], cache["v"]
        self_bias = step_bias(k_all.shape[2], pos, x.device)
        for i in range(self.layers):
            block = getattr(self, f"block_{i}")
            h, k_new, v_new = block.project_step_kv(x)
            k_all[:, i, pos] = k_new[:, 0]
            v_all[:, i, pos] = v_new[:, 0]
            x = block.step_attend(x, h, k_all[:, i], v_all[:, i], self_bias, memory, mem_bias,
                                  None if mem_kv is None else mem_kv[f"block_{i}"])
        logits = self.output(self.after_norm(x[:, 0]).float())
        return torch.log_softmax(logits, dim=-1), cache

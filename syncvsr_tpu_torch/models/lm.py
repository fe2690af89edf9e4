"""Language models for shallow fusion in the beam search (port of
``syncvsr_tpu/models/lm.py``): a Transformer LM (espnet's "linear" input
layer, pre-LN blocks) and an LSTM LM, each with ``init_cache``, ``step``
(y_prev [N], pos, state) -> (log-probs [N, V], state) over states whose
leading axis is the beam's, and a teacher-forced ``forward``. They serve
decoding: no dropout, and the JAX package's ``max_len`` default capacity is
gone (the beam search gives every cache its capacity).

Like the JAX package's, ``TransformerLM.step`` embeds every token at
position 0: with ``pos_enc="sinusoidal"`` its steps differ from its
teacher-forced ``forward``, which adds the positions 0..L-1 (with
``pos_enc="none"``, the published shape's, the two agree).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from syncvsr_tpu_torch.models.decoder import FF, MHA, _Embed, sinusoid_pe, step_bias
from syncvsr_tpu_torch.models.layers import Dense, LayerNorm, causal_bias, lecun_normal_

Tensor = torch.Tensor


class LMBlock(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attn = MHA(dim, heads, 0.0, dtype)
        self.ff = FF(dim, hidden, 0.0, dtype)
        self.norm1 = LayerNorm(dim, dtype)
        self.norm2 = LayerNorm(dim, dtype)

    def forward(self, x: Tensor, bias: Tensor) -> Tensor:
        h = self.norm1(x)
        x = x + self.attn(h, h, bias)
        return x + self.ff(self.norm2(x))

    def step_attend(self, x: Tensor, h: Tensor, k: Tensor, v: Tensor, bias: Tensor) -> Tensor:
        """Finish one step over this block's cache k, v [N, L, H, Dk] (the
        new token already written; ``bias`` keeps the positions <= pos)."""
        x = x + self.attn.attend_cached(h, k, v, bias)
        return x + self.ff(self.norm2(x))


class TransformerLM(nn.Module):
    def __init__(self, vocab: int, layers: int = 16, dim: int = 512, heads: int = 8,
                 hidden: int = 2048, embed_dim: int = 128, pos_enc: str = "none",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if pos_enc not in ("none", "sinusoidal"):
            raise ValueError(f"pos_enc must be 'none' or 'sinusoidal', not {pos_enc!r}")
        self.layers, self.dim, self.heads = layers, dim, heads
        self.pos_enc, self.dtype = pos_enc, dtype
        self.embed = _Embed(vocab, embed_dim)
        self.input_proj = Dense(embed_dim, dim, dtype, lecun=True)
        self.input_norm = LayerNorm(dim, dtype)
        for i in range(layers):
            self.add_module(f"block_{i}", LMBlock(dim, heads, hidden, dtype))
        self.norm = LayerNorm(dim, dtype)
        self.output = Dense(dim, vocab, torch.float32, lecun=True)

    def _embed(self, ys: Tensor, offset: int = 0) -> Tensor:
        # espnet's "linear" input layer: Linear -> LayerNorm -> ReLU -> pos_enc
        x = self.embed.embedding[ys.long()].to(self.dtype)
        x = F.relu(self.input_norm(self.input_proj(x)))
        if self.pos_enc == "sinusoidal":
            x = x * math.sqrt(self.dim) + sinusoid_pe(ys.shape[1], self.dim, offset,
                                                      self.dtype, x.device)[None]
        return x

    def forward(self, ys: Tensor) -> Tensor:
        """Teacher-forced f32 logits [B, L, V] of the next token."""
        x = self._embed(ys)
        bias = causal_bias(ys.shape[1], ys.device)
        for i in range(self.layers):
            x = getattr(self, f"block_{i}")(x, bias)
        return self.output(self.norm(x).float())

    def init_cache(self, width: int, max_len: int) -> Dict[str, Tensor]:
        """K/V of every block stacked on axis 1, [N, layers, L, H, Dk], as
        the decoder's cache (``decoder.grow_cache`` grows both)."""
        shape = (width, self.layers, max_len, self.heads, self.dim // self.heads)
        dev = self.output.weight.device
        return {"k": torch.zeros(shape, dtype=self.dtype, device=dev),
                "v": torch.zeros(shape, dtype=self.dtype, device=dev)}

    def step(self, y_prev: Tensor, pos: int, cache: Dict[str, Tensor]
             ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """f32 log-probs [N, V] of the next token; the cache is updated in
        place at (layer, pos)."""
        x = self._embed(y_prev[:, None], offset=0)
        k_all, v_all = cache["k"], cache["v"]
        bias = step_bias(k_all.shape[2], pos, x.device)
        for i in range(self.layers):
            block = getattr(self, f"block_{i}")
            h = block.norm1(x)
            k_new, v_new = block.attn.project_kv(h)
            k_all[:, i, pos] = k_new[:, 0]
            v_all[:, i, pos] = v_new[:, 0]
            x = block.step_attend(x, h, k_all[:, i], v_all[:, i], bias)
        logits = self.output(self.norm(x[:, 0]).float())
        return torch.log_softmax(logits, dim=-1), cache


class _Kernel(nn.Module):
    """A flax ``DenseParams`` leaf pair: ``weight`` [out, in] (flax
    ``kernel`` [in, out]) and, with ``bias``, ``bias`` [out]."""

    def __init__(self, din: int, dout: int, bias: bool, orthogonal: bool):
        super().__init__()
        w = torch.empty(dout, din)
        # flax's defaults: lecun_normal for the input kernels, orthogonal for
        # the recurrent ones
        self.weight = nn.Parameter(nn.init.orthogonal_(w) if orthogonal
                                   else lecun_normal_(w, din))
        self.bias = nn.Parameter(torch.zeros(dout)) if bias else None


class OptimizedLSTMCell(nn.Module):
    """flax ``nn.OptimizedLSTMCell`` with f32 parameters: input kernels
    ``ii``/``if``/``ig``/``io`` (no bias) and recurrent ``hi``/``hf``/``hg``/
    ``ho`` (kernel and bias), gates in the order i, f, g, o, no forget-gate
    offset. Each side's four kernels run as one product, as in flax.
    carry (c, h) -> (c', h'), computed in f32."""

    GATES = "ifgo"

    def __init__(self, din: int, features: int):
        super().__init__()
        for g in self.GATES:
            self.add_module("i" + g, _Kernel(din, features, bias=False, orthogonal=False))
            self.add_module("h" + g, _Kernel(features, features, bias=True, orthogonal=True))

    def forward(self, carry: Tuple[Tensor, Tensor], x: Tensor) -> Tuple[Tensor, Tensor]:
        c, h = (s.float() for s in carry)
        hs = [getattr(self, "h" + g) for g in self.GATES]
        w_i = torch.cat([getattr(self, "i" + g).weight for g in self.GATES])
        y = (F.linear(h, torch.cat([m.weight for m in hs])) + torch.cat([m.bias for m in hs])
             + F.linear(x.float(), w_i))
        i, f, g, o = y.chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return new_c, torch.sigmoid(o) * torch.tanh(new_c)


class RNNLM(nn.Module):
    """LSTM LM (espnet's default and seq_rnn LMs)."""

    def __init__(self, vocab: int, layers: int = 2, dim: int = 650, embed_dim: int = 650,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers, self.dim, self.dtype = layers, dim, dtype
        self.embed = _Embed(vocab, embed_dim)
        for i in range(layers):
            self.add_module(f"lstm_{i}", OptimizedLSTMCell(embed_dim if i == 0 else dim, dim))
        self.output = Dense(dim, vocab, torch.float32, lecun=True)

    def init_cache(self, width: int) -> List[Tuple[Tensor, Tensor]]:
        dev = self.output.weight.device
        return [(torch.zeros(width, self.dim, dtype=self.dtype, device=dev),
                 torch.zeros(width, self.dim, dtype=self.dtype, device=dev))
                for _ in range(self.layers)]

    def step(self, y_prev: Tensor, pos: int, state: List[Tuple[Tensor, Tensor]]
             ) -> Tuple[Tensor, List[Tuple[Tensor, Tensor]]]:
        x = self.embed.embedding[y_prev.long()].to(self.dtype)
        new_state = []
        for i, s in enumerate(state):
            s = getattr(self, f"lstm_{i}")(s, x)
            new_state.append(s)
            x = s[1]
        logits = self.output(x.float())
        return torch.log_softmax(logits, dim=-1), new_state

    def forward(self, ys: Tensor) -> Tensor:
        """Teacher-forced log-probs [B, L, V] (one step a position)."""
        state = self.init_cache(ys.shape[0])
        outs = []
        for i in range(ys.shape[1]):
            logp, state = self.step(ys[:, i], i, state)
            outs.append(logp)
        return torch.stack(outs, dim=1)

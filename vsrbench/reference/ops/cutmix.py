# Frozen copy of syncvsr_tpu_torch/ops/cutmix.py, part of the benchmark's plain reference.
"""In-step temporal CutMix (port of
``syncvsr_tpu/ops/cutmix.py::temporal_cutmix``), split into a sampling
part and a deterministic apply part.

A contiguous span of frames (beta-distributed length) is swapped with the
partner sample (the batch reversed); soft labels and word-boundary masks are
lerped by the kept share; audio tokens are swapped over the same span
repeated ``audio_rep`` times. Sampling draws from a CPU ``torch.Generator``
so it never waits on the GPU; the keep-mask is built on the host in f32 and
copied over.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def sample_cutmix(gen: torch.Generator, alpha: float) -> Tuple[Tensor, Tensor]:
    """-> (ratio, start), f32 scalars on the CPU: ratio ~ Beta(alpha, alpha),
    start = (1 - ratio) * U(0, 1)."""
    a = torch.full((2,), float(alpha), dtype=torch.float32)
    g = torch._standard_gamma(a, generator=gen)
    ratio = g[0] / (g[0] + g[1])
    u = torch.rand((), generator=gen, dtype=torch.float32)
    return ratio, (1.0 - ratio) * u


def cutmix_keep(t: int, ratio: Tensor, start: Tensor) -> Tensor:
    """[T] bool keep-mask over ``linspace(0, 1, T)`` (True = own frame)."""
    grid = torch.linspace(0.0, 1.0, t, dtype=torch.float32)
    return ~((start < grid) & (grid <= start + ratio))


def temporal_cutmix_apply(inputs: Tensor, labels: Tensor, audio_tokens: Tensor,
                          word_mask: Optional[Tensor], keep: Tensor
                          ) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor]]:
    """inputs [B, T, ...], labels [B, L] soft, audio_tokens [B, T*rep, G],
    word_mask [B, T] or None, keep [T] bool -> the mixed four."""
    t = keep.shape[0]
    keep = keep.to(inputs.device)
    lam = keep.float().mean()
    audio_keep = keep.repeat_interleave(audio_tokens.shape[1] // t)

    def flip(x):
        return torch.flip(x, dims=(0,))

    kshape = (1, inputs.shape[1]) + (1,) * (inputs.dim() - 2)
    inputs = torch.where(keep.reshape(kshape), inputs, flip(inputs))
    labels = lam * labels + (1.0 - lam) * flip(labels)
    audio_tokens = torch.where(audio_keep[None, :, None], audio_tokens, flip(audio_tokens))
    if word_mask is not None:
        word_mask = lam * word_mask + (1.0 - lam) * flip(word_mask)
    return inputs, labels, audio_tokens, word_mask

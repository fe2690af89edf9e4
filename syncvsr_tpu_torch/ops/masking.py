"""Loss masking helpers (port of ``syncvsr_tpu/ops/masking.py``; only
``weighted_mean`` is on the word-level path)."""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def weighted_mean(per_sample: Tensor, weight: Optional[Tensor]) -> Tensor:
    """Mean over the batch, or a sample-weighted mean when ``weight`` [B] is
    given (padded tail batches in exact eval)."""
    if weight is None:
        return per_sample.mean()
    w = weight.float()
    return (per_sample * w).sum() / torch.clamp(w.sum(), min=1.0)

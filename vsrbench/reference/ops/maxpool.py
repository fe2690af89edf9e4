# Frozen copy of syncvsr_tpu_torch/ops/maxpool.py, part of the benchmark's plain reference.
"""Spatial max-pool (port of the default path of the JAX frontend:
``nn.max_pool`` window (1, 3, 3), stride (1, 2, 2), padding (0, 1, 1), with
-inf padding). The recomputed-backward variant ``max_pool_s2`` is a closed
TPU experiment and is not ported."""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def max_pool_3x3_s2(x: Tensor) -> Tensor:
    """3x3 / stride 2 / pad 1 max over the (-3, -2) axes of a contiguous
    channels-last [..., H, W, C] tensor; returns [..., H', W', C]."""
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    x4 = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)   # channels_last NCHW view
    y = F.max_pool2d(x4, kernel_size=3, stride=2, padding=1)
    y = y.permute(0, 2, 3, 1).contiguous()
    return y.reshape(*lead, *y.shape[1:])

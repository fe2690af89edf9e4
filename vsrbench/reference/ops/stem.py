# Frozen copy of syncvsr_tpu_torch/ops/stem.py, part of the benchmark's plain reference.
"""The video stem conv (port of ``syncvsr_tpu/ops/stem.py``).

Semantics of ``stem_conv3d_reference``: Conv3D 1 -> C, kernel (5, 7, 7),
stride (1, 2, 2), padding (2, 3, 3), in the compute dtype. The JAX package's
space-to-depth regrouping (``stem_conv3d_s2d``) is a TPU device; here it is
one ``conv3d`` on the channels-last-3d layout, and the tests hold it to
both JAX forms.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def stem_conv3d(x: Tensor, weight: Tensor, dtype: torch.dtype) -> Tensor:
    """x [B, T, H, W, 1]; weight [C, 1, 5, 7, 7] (OITHW) ->
    contiguous [B, T, ceil(H/2), ceil(W/2), C] in ``dtype`` (SAME
    padding)."""
    xc = x.to(dtype).permute(0, 4, 1, 2, 3)           # [B, 1, T, H, W], free view
    w = weight.to(dtype).contiguous(memory_format=torch.channels_last_3d)
    y = F.conv3d(xc, w, stride=(1, 2, 2), padding=(2, 3, 3))
    return y.permute(0, 2, 3, 4, 1).contiguous()

# Frozen copy of syncvsr_tpu_torch/models/resnet.py, part of the benchmark's plain reference.
"""ResNet-18 video trunk (port of ``syncvsr_tpu/models/resnet.py``:
``ResNetTrunk``; the raw-audio ResNet1D runs in no cell and is not copied).

Activations keep the JAX layout, channels last and contiguous
([B, T, H, W, C]), so a BatchNorm's ``[N, C]`` view is free; convolutions
run on the ``channels_last`` NCHW view of the folded [B*T, H, W, C] tensor.
Every BatchNorm is ``FastBatchNorm`` (its statistics in plain sums here).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vsrbench.reference.models.layers import activation, variance_scaling_fan_out_
from vsrbench.reference.ops.cuda_bn import FastBatchNorm

Tensor = torch.Tensor


class SpatialConv(nn.Module):
    """k x k spatial conv, no bias, over [..., H, W, C] (4-D or 5-D; a 5-D
    clip is convolved per frame); ``weight`` [O, I, k, k]."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.pad = (kernel - 1) // 2
        self.dtype = dtype
        w = torch.empty(cout, cin, kernel, kernel)
        self.weight = nn.Parameter(variance_scaling_fan_out_(w, kernel * kernel * cout))

    def forward(self, x: Tensor) -> Tensor:
        lead = x.shape[:-3]
        h, w, c = x.shape[-3:]
        x = x.to(self.dtype)
        x4 = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
        wt = self.weight.to(self.dtype).contiguous(memory_format=torch.channels_last)
        y = F.conv2d(x4, wt, stride=self.stride, padding=self.pad)
        y = y.permute(0, 2, 3, 1).contiguous()
        y = y.reshape(*lead, *y.shape[1:])
        return y


class BasicBlock(nn.Module):
    def __init__(self, cin: int, channels: int, stride: int = 1, relu_type: str = "swish",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = activation(relu_type)
        self.conv1 = SpatialConv(cin, channels, 3, stride, dtype)
        self.bn1 = FastBatchNorm(channels, dtype)
        self.conv2 = SpatialConv(channels, channels, 3, 1, dtype)
        self.bn2 = FastBatchNorm(channels, dtype)
        self.has_down = stride != 1 or cin != channels
        if self.has_down:
            self.downsample_conv = SpatialConv(cin, channels, 1, stride, dtype)
            self.downsample_bn = FastBatchNorm(channels, dtype)

    def forward(self, x: Tensor, train: bool) -> Tensor:
        y = self.act(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        residual = x
        if self.has_down:
            residual = self.downsample_bn(self.downsample_conv(x), train)
        return self.act(y + residual)


class ResNetTrunk(nn.Module):
    """layer1..layer4 of ResNet-18 over [N, H, W, C] or [B, T, H, W, C];
    returns the spatial mean, [N, 8*width] or [B, T, 8*width]."""

    def __init__(self, cin: int, width: int = 64, blocks: Sequence[int] = (2, 2, 2, 2),
                 relu_type: str = "swish", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.names = []
        for i, n in enumerate(blocks):
            channels = width * (2 ** i)
            for j in range(n):
                stride = 2 if (i > 0 and j == 0) else 1
                name = f"layer{i + 1}_{j}"
                self.add_module(name, BasicBlock(cin, channels, stride, relu_type, dtype))
                self.names.append(name)
                cin = channels
        self.out_dim = cin

    def forward(self, x: Tensor, train: bool) -> Tensor:
        for name in self.names:
            x = getattr(self, name)(x, train)
        return x.mean(dim=(-3, -2))

"""ResNet-18 video trunk and raw-audio ResNet1D (port of
``syncvsr_tpu/models/resnet.py``: ``ResNetTrunk``, ``BasicBlock1D``,
``ResNet1D``).

Activations keep the JAX layout, channels last and contiguous
([B, T, H, W, C], or [B, S, C] for audio), so a BatchNorm's ``[N, C]`` view
is free; convolutions run on the ``channels_last`` NCHW view of the folded
[B*T, H, W, C] tensor (a 1-D one, on the GPU, as a 2-D conv over a unit
height). Every BatchNorm is ``FastBatchNorm`` (statistics kernels K3/K4 on
the GPU).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from syncvsr_tpu_torch.models.layers import (
    activation,
    lecun_normal_,
    variance_scaling_fan_out_,
)
from syncvsr_tpu_torch.ops.cuda_bn import FastBatchNorm
from syncvsr_tpu_torch.parallel import tensor

Tensor = torch.Tensor


class SpatialConv(nn.Module):
    """k x k spatial conv, no bias, over [..., H, W, C] (4-D or 5-D; a 5-D
    clip is convolved per frame); ``weight`` [O, I, k, k]. Split over the
    model axis (on O), each rank gives its output channels, gathered."""

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
        split = tensor.split_dim(self.weight) is not None
        x = tensor.copy_to_model(x.to(self.dtype)) if split else x.to(self.dtype)
        x4 = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
        wt = self.weight.to(self.dtype).contiguous(memory_format=torch.channels_last)
        y = F.conv2d(x4, wt, stride=self.stride, padding=self.pad)
        y = y.permute(0, 2, 3, 1).contiguous()
        y = y.reshape(*lead, *y.shape[1:])
        return tensor.gather_from_model(y) if split else y


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


def same_padding(length: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) of flax's ``padding="SAME"``: ceil(length / stride)
    outputs, the padding's odd element after (a stride-2 k = 3 conv over an
    even length pads (0, 1), where torch's ``padding=1`` pads (1, 1))."""
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


class Conv1d(nn.Module):
    """flax ``nn.Conv(features, (k,), (s,), padding="SAME",
    kernel_dilation=(dilation,), feature_group_count=groups,
    use_bias=bias)`` over [B, S, C] channels last; ``weight`` [O, I /
    groups, k] (flax [k, I / groups, O]), flax's default ``lecun_normal``
    init, a zero ``bias`` where it has one (ResNet1D's convs have none; the
    TCN family's do). Uneven padding is one explicit ``F.pad``. On the GPU
    it runs as a 2-D conv over the free ``channels_last`` [B, C, 1, S] view,
    so the output is contiguous [B, S', O] as cuDNN writes it: no transpose
    around the BatchNorms. On the CPU it runs as ``conv1d`` on the [B, C, S]
    transpose: oneDNN's backward of that 2-D form corrupts the heap there
    (PyTorch 2.13 CPU, seen from a chain of two blocks). Split over the
    model axis (on O), each rank gives its output channels (a depthwise
    conv from its channels of the input), gathered before the bias."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, dilation: int = 1, groups: int = 1,
                 bias: bool = False):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.dtype = dtype
        fan_in = kernel * cin // groups
        self.weight = nn.Parameter(lecun_normal_(torch.empty(cout, cin // groups, kernel),
                                                 fan_in))
        if bias:
            self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: Tensor) -> Tensor:
        k = (self.weight.shape[-1] - 1) * self.dilation + 1
        lo, hi = same_padding(x.shape[1], k, self.stride)
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        b = self.bias.to(self.dtype) if hasattr(self, "bias") else None
        groups = self.groups
        split = tensor.split_dim(self.weight) is not None
        if split:   # a depthwise conv (groups = channels) reads its channels
            x = tensor.local(x) if groups > 1 else tensor.copy_to_model(x)
            groups = w.shape[0] if groups > 1 else 1
            b, bias = None, b
        if lo != hi:
            x, lo = F.pad(x, (0, 0, lo, hi)), 0
        if not x.is_cuda:
            y = F.conv1d(x.transpose(1, 2), w, b, stride=self.stride, padding=lo,
                         dilation=self.dilation, groups=groups)
            y = y.transpose(1, 2).contiguous()
        else:
            x4 = x.unsqueeze(1).permute(0, 3, 1, 2)              # [B, C, 1, S]
            w4 = w.unsqueeze(2).contiguous(memory_format=torch.channels_last)
            y = F.conv2d(x4, w4, b, stride=(1, self.stride), padding=(0, lo),
                         dilation=(1, self.dilation), groups=groups)
            y = y.permute(0, 2, 3, 1).reshape(y.shape[0], y.shape[3], y.shape[1])
        return tensor.gather_from_model(y, bias=bias) if split else y


class BasicBlock1D(nn.Module):
    def __init__(self, cin: int, channels: int, stride: int = 1, relu_type: str = "swish",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = activation(relu_type)
        self.conv1 = Conv1d(cin, channels, 3, stride, dtype)
        self.bn1 = FastBatchNorm(channels, dtype)
        self.conv2 = Conv1d(channels, channels, 3, 1, dtype)
        self.bn2 = FastBatchNorm(channels, dtype)
        self.has_down = stride != 1 or cin != channels
        if self.has_down:
            self.downsample_conv = Conv1d(cin, channels, 1, stride, dtype)
            self.downsample_bn = FastBatchNorm(channels, dtype)

    def forward(self, x: Tensor, train: bool) -> Tensor:
        y = self.act(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        residual = x
        if self.has_down:
            residual = self.downsample_bn(self.downsample_conv(x), train)
        return self.act(y + residual)


class ResNet1D(nn.Module):
    """Raw-audio ResNet-18: a k = 80, stride 4 stem conv, its BatchNorm and
    activation, four stages of two ``BasicBlock1D`` (stride 2 at the first
    block of stages 2-4), then the mean over windows of 20 samples (16 kHz /
    4 / 8 / 20 = 25 frames a second), the length first cut to a multiple of
    the window. [B, S, 1] -> [B, S // 640, 8 * width]. (The JAX module's
    ``a_upsample_ratio``, which no configuration sets, is left out.)"""

    POOL = 20

    def __init__(self, width: int = 64, blocks: Sequence[int] = (2, 2, 2, 2),
                 relu_type: str = "swish", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = activation(relu_type)
        self.stem_conv = Conv1d(1, width, 80, 4, dtype)
        self.stem_bn = FastBatchNorm(width, dtype)
        self.names = []
        cin = width
        for i, n in enumerate(blocks):
            channels = width * (2 ** i)
            for j in range(n):
                stride = 2 if (i > 0 and j == 0) else 1
                name = f"layer{i + 1}_{j}"
                self.add_module(name, BasicBlock1D(cin, channels, stride, relu_type, dtype))
                self.names.append(name)
                cin = channels
        self.out_dim = cin

    def forward(self, x: Tensor, train: bool) -> Tensor:
        x = self.act(self.stem_bn(self.stem_conv(x), train))
        for name in self.names:
            x = getattr(self, name)(x, train)
        b, s, c = x.shape
        p = self.POOL
        return x[:, :s // p * p].reshape(b, s // p, p, c).mean(2)

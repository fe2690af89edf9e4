"""Classic and multibranch temporal convolutional networks (port of
``syncvsr_tpu/models/tcn.py``; ``encoder.kind`` "tcn" and "mstcn"):
TemporalBlock stacks with dilation 2^level and flax's SAME padding,
single-kernel (``TemporalConvNet``) and multibranch (one branch per kernel
size) variants, with an optional depthwise + pointwise (``dwpw``)
factorisation. Channels last, [B, T, C]; flax-semantics BatchNorms, no
kernel; submodules carry the flax names.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from syncvsr_tpu_torch.models.layers import FlaxBatchNorm, dropout
from syncvsr_tpu_torch.models.resnet import Conv1d

Tensor = torch.Tensor


class ConvBNAct(nn.Module):
    """``conv``, ``bn``, swish; with ``dwpw`` a depthwise ``dw`` conv (one
    group a channel), ``dw_bn``, swish, then a 1x1 ``pw`` conv, ``pw_bn``,
    swish. Every conv has a bias."""

    def __init__(self, cin: int, channels: int, kernel: int, dilation: int,
                 dwpw: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dwpw = dwpw
        if dwpw:
            self.dw = Conv1d(cin, cin, kernel, 1, dtype, dilation=dilation, groups=cin,
                             bias=True)
            self.dw_bn = FlaxBatchNorm(cin, dtype)
            self.pw = Conv1d(cin, channels, 1, 1, dtype, bias=True)
            self.pw_bn = FlaxBatchNorm(channels, dtype)
        else:
            self.conv = Conv1d(cin, channels, kernel, 1, dtype, dilation=dilation, bias=True)
            self.bn = FlaxBatchNorm(channels, dtype)

    def forward(self, x: Tensor, train: bool) -> Tensor:
        if self.dwpw:
            x = F.silu(self.dw_bn(self.dw(x), train))
            return F.silu(self.pw_bn(self.pw(x), train))
        return F.silu(self.bn(self.conv(x), train))


class TemporalBlock(nn.Module):
    def __init__(self, cin: int, channels: int, kernel: int, dilation: int,
                 rate: float = 0.2, dwpw: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rate = rate
        self.conv1 = ConvBNAct(cin, channels, kernel, dilation, dwpw, dtype)
        self.conv2 = ConvBNAct(channels, channels, kernel, dilation, dwpw, dtype)
        if cin != channels:
            self.downsample = Conv1d(cin, channels, 1, 1, dtype, bias=True)

    def forward(self, x: Tensor, train: bool, gen: Optional[torch.Generator] = None) -> Tensor:
        h = dropout(self.conv1(x, train), self.rate, not train, gen)
        h = dropout(self.conv2(h, train), self.rate, not train, gen)
        res = self.downsample(x) if hasattr(self, "downsample") else x
        return F.silu(h + res)


class MultibranchTemporalBlock(nn.Module):
    def __init__(self, cin: int, channels: int, kernel_sizes: Sequence[int], dilation: int,
                 rate: float = 0.2, dwpw: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rate, self.n = rate, len(kernel_sizes)
        branch = channels // self.n
        for i, k in enumerate(kernel_sizes):
            self.add_module(f"branch0_{i}",
                            ConvBNAct(cin, branch, k, dilation, dwpw, dtype))
        for i, k in enumerate(kernel_sizes):
            self.add_module(f"branch1_{i}",
                            ConvBNAct(branch * self.n, branch, k, dilation, dwpw, dtype))
        # the reference's condition (tcn.py:92): a downsample whenever
        # cin // branches != channels, so in equal-width blocks too
        if cin // self.n != channels:
            self.downsample = Conv1d(cin, channels, 1, 1, dtype, bias=True)

    def forward(self, x: Tensor, train: bool, gen: Optional[torch.Generator] = None) -> Tensor:
        h = torch.cat([getattr(self, f"branch0_{i}")(x, train) for i in range(self.n)], -1)
        h = dropout(h, self.rate, not train, gen)
        h = torch.cat([getattr(self, f"branch1_{i}")(h, train) for i in range(self.n)], -1)
        h = dropout(h, self.rate, not train, gen)
        res = self.downsample(x) if hasattr(self, "downsample") else x
        return F.silu(h + res)


class TemporalConvNet(nn.Module):
    """Single-kernel TCN: ``block_i`` at dilation 2^i."""

    def __init__(self, cin: int, channels: Sequence[int] = (256, 256, 256), kernel: int = 3,
                 rate: float = 0.2, dwpw: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = len(channels)
        for i, c in enumerate(channels):
            self.add_module(f"block_{i}",
                            TemporalBlock(cin, c, kernel, 2 ** i, rate, dwpw, dtype))
            cin = c
        self.out_dim = cin

    def forward(self, x: Tensor, train: bool, gen: Optional[torch.Generator] = None) -> Tensor:
        for i in range(self.n):
            x = getattr(self, f"block_{i}")(x, train, gen)
        return x


class MultibranchTemporalConvNet(nn.Module):
    """Multibranch TCN: ``block_i`` at dilation 2^i, one branch a kernel size."""

    def __init__(self, cin: int, channels: Sequence[int] = (256, 256, 256),
                 kernel_sizes: Sequence[int] = (3, 5, 7), rate: float = 0.2,
                 dwpw: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = len(channels)
        for i, c in enumerate(channels):
            self.add_module(f"block_{i}", MultibranchTemporalBlock(
                cin, c, kernel_sizes, 2 ** i, rate, dwpw, dtype))
            cin = c
        self.out_dim = cin

    def forward(self, x: Tensor, train: bool, gen: Optional[torch.Generator] = None) -> Tensor:
        for i in range(self.n):
            x = getattr(self, f"block_{i}")(x, train, gen)
        return x

"""Dense temporal convolutional network, DC-TCN (port of
``syncvsr_tpu/models/dense_tcn.py``): an input transition to
``reduced_size`` channels, then dense blocks whose layers each run two
rounds of multi-kernel (3/5/7) dilated (1/2/5 cycling) temporal
convolutions with a residual, concatenating every layer's output;
transitions reset the width between blocks, and a last BatchNorm closes the
net. Channels last, [B, T, C]; 1-D convs with flax's SAME padding
(``resnet.Conv1d``) and flax-semantics BatchNorms (``FlaxBatchNorm``, no
kernel: the JAX package runs plain ``nn.BatchNorm`` here). Final width =
reduced + layers x growth of the last block (1664 for the published
config). Submodules carry the flax names.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from syncvsr_tpu_torch.models.layers import FlaxBatchNorm, SELayer1D, activation, dropout
from syncvsr_tpu_torch.models.resnet import Conv1d

Tensor = torch.Tensor


class TemporalConvLayer(nn.Module):
    """``conv`` (k, dilation, bias), ``bn``, swish."""

    def __init__(self, cin: int, channels: int, kernel: int, dilation: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv1d(cin, channels, kernel, 1, dtype, dilation=dilation, bias=True)
        self.bn = FlaxBatchNorm(channels, dtype)

    def forward(self, x: Tensor, train: bool) -> Tensor:
        return F.silu(self.bn(self.conv(x), train))


class MultiKernelLayer(nn.Module):
    """One dense layer: per kernel size an (optionally squeeze-excited)
    branch ``conv0_i``, their concatenation and dropout, a second round
    ``conv1_i``, dropout, and the residual (a 1x1 ``downsample`` conv where
    the width changes), then swish."""

    def __init__(self, cin: int, out_channels: int, kernel_sizes: Sequence[int],
                 dilation: int, rate: float = 0.2, use_se: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rate, self.n = rate, len(kernel_sizes)
        self.use_se = use_se
        branch = out_channels // self.n
        for i, k in enumerate(kernel_sizes):
            if use_se:
                self.add_module(f"se_{i}", SELayer1D(cin, dtype=dtype))
            self.add_module(f"conv0_{i}",
                            TemporalConvLayer(cin, branch, k, dilation, dtype))
        for i, k in enumerate(kernel_sizes):
            self.add_module(f"conv1_{i}",
                            TemporalConvLayer(branch * self.n, branch, k, dilation, dtype))
        if cin != out_channels:
            self.downsample = Conv1d(cin, out_channels, 1, 1, dtype, bias=True)

    def forward(self, x: Tensor, train: bool, gen: Optional[torch.Generator] = None) -> Tensor:
        outs = []
        for i in range(self.n):
            h = getattr(self, f"se_{i}")(x) if self.use_se else x
            outs.append(getattr(self, f"conv0_{i}")(h, train))
        h = dropout(torch.cat(outs, -1), self.rate, not train, gen)
        h = torch.cat([getattr(self, f"conv1_{i}")(h, train) for i in range(self.n)], -1)
        h = dropout(h, self.rate, not train, gen)
        res = self.downsample(x) if hasattr(self, "downsample") else x
        return F.silu(h + res)


class Transition(nn.Module):
    """1x1 ``conv`` without bias, ``bn``, activation."""

    def __init__(self, cin: int, channels: int, relu_type: str,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = activation(relu_type)
        self.conv = Conv1d(cin, channels, 1, 1, dtype)
        self.bn = FlaxBatchNorm(channels, dtype)

    def forward(self, x: Tensor, train: bool) -> Tensor:
        return self.act(self.bn(self.conv(x), train))


class DenseTCN(nn.Module):
    """[B, T, cin] -> [B, T, out_dim]. ``transition0`` (leaky ReLU, the
    JAX package's "prelu"), blocks of ``block{b}_layer{l}``, ``transition{b}``
    between blocks, ``final_bn``."""

    def __init__(self, cin: int, growth_rates: Sequence[int] = (384, 384, 384, 384),
                 blocks: Sequence[int] = (3, 3, 3, 3), kernel_sizes: Sequence[int] = (3, 5, 7),
                 dilations: Sequence[int] = (1, 2, 5), reduced_size: int = 512,
                 rate: float = 0.2, use_se: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layout = []
        self.transition0 = Transition(cin, reduced_size, "prelu", dtype)
        width = reduced_size
        for bi, (num_layers, growth) in enumerate(zip(blocks, growth_rates)):
            names = []
            for li in range(num_layers):
                name = f"block{bi}_layer{li}"
                self.add_module(name, MultiKernelLayer(
                    width, growth, kernel_sizes, dilations[li % len(dilations)], rate,
                    use_se, dtype))
                names.append(name)
                width += growth
            self.layout.append(names)
            if bi != len(blocks) - 1:
                self.add_module(f"transition{bi + 1}",
                                Transition(width, reduced_size, "swish", dtype))
                width = reduced_size
        self.final_bn = FlaxBatchNorm(width, dtype)
        self.out_dim = width

    def forward(self, x: Tensor, train: bool, gen: Optional[torch.Generator] = None) -> Tensor:
        x = self.transition0(x, train)
        for bi, names in enumerate(self.layout):
            features = [x]
            for name in names:
                inp = torch.cat(features, -1) if len(features) > 1 else features[0]
                features.append(getattr(self, name)(inp, train, gen))
            x = torch.cat(features, -1)
            if bi != len(self.layout) - 1:
                x = getattr(self, f"transition{bi + 1}")(x, train)
        return self.final_bn(x, train)

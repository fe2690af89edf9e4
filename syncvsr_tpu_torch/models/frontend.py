"""Video frontend (port of ``syncvsr_tpu/models/frontend.py::
Conv3DResNetFrontend``): Conv3D stem -> stem BatchNorm -> GELU (tanh) ->
(1, 3, 3) max-pool -> ResNet-18 trunk -> spatial mean, [B, T, H, W, 1] ->
[B, T, 8*width]."""

from __future__ import annotations

import torch
from torch import nn

from syncvsr_tpu_torch.models.layers import activation, variance_scaling_fan_out_
from syncvsr_tpu_torch.models.resnet import ResNetTrunk
from syncvsr_tpu_torch.ops.cuda_bn import FastBatchNorm
from syncvsr_tpu_torch.ops.maxpool import max_pool_3x3_s2
from syncvsr_tpu_torch.ops.stem import stem_conv3d

Tensor = torch.Tensor


class Conv3DResNetFrontend(nn.Module):
    def __init__(self, stem_channels: int = 64, width: int = 64, relu_type: str = "swish",
                 stem_act: str = "gelu", fold_threshold: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fold_threshold = fold_threshold
        self.act = activation(stem_act)
        # flax leaf ``stem_conv_kernel`` (5, 7, 7, 1, C), held here as OITHW
        w = torch.empty(stem_channels, 1, 5, 7, 7)
        self.stem_conv_kernel = nn.Parameter(
            variance_scaling_fan_out_(w, 5 * 7 * 7 * stem_channels))
        self.stem_bn = FastBatchNorm(stem_channels, dtype)
        self.resnet = ResNetTrunk(stem_channels, width, relu_type=relu_type, dtype=dtype)
        self.out_dim = self.resnet.out_dim

    def forward(self, videos: Tensor, train: bool = False) -> Tensor:
        x = stem_conv3d(videos, self.stem_conv_kernel, self.dtype)   # [B, T, H, W, C]
        # long clips fold time into batch after the only temporal op; the
        # statistics reduce over all non-channel axes either way
        b, t = x.shape[0], x.shape[1]
        fold = t >= self.fold_threshold
        if fold:
            x = x.reshape((b * t,) + x.shape[2:])
        x = self.act(self.stem_bn(x, train))
        x = max_pool_3x3_s2(x)
        feats = self.resnet(x, train)
        if fold:
            feats = feats.reshape(b, t, feats.shape[-1])
        return feats

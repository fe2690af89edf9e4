# Frozen copy of syncvsr_tpu_torch/models/frontend.py, part of the benchmark's plain reference.
"""The video frontend (port of ``syncvsr_tpu/models/frontend.py``):
``Conv3DResNetFrontend``, Conv3D stem -> stem BatchNorm -> GELU (tanh)
-> (1, 3, 3) max-pool -> ResNet-18 trunk -> spatial mean,
[B, T, H, W, 1] -> [B, T, 8*width]. (The port's landmark and audio
frontends run in no cell and are not copied.)
"""

from __future__ import annotations

import torch
from torch import nn

from vsrbench.reference.config import FrontendConfig
from vsrbench.reference.models.layers import activation, variance_scaling_fan_out_
from vsrbench.reference.models.resnet import ResNetTrunk
from vsrbench.reference.ops.cuda_bn import FastBatchNorm
from vsrbench.reference.ops.maxpool import max_pool_3x3_s2
from vsrbench.reference.ops.stem import stem_conv3d

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


def build_frontend(cfg: FrontendConfig, dtype: torch.dtype, embed_dim: int = 0) -> nn.Module:
    """The frontend of ``cfg.kind`` (the video one alone here)."""
    if cfg.kind == "conv3d_resnet":
        return Conv3DResNetFrontend(cfg.stem_channels, cfg.resnet_width, cfg.relu_type,
                                    cfg.stem_act, cfg.fold_threshold, dtype)
    raise ValueError(f"unknown frontend kind: {cfg.kind}")

"""Input frontends (port of ``syncvsr_tpu/models/frontend.py``), mapping a
modality to a [B, T, D] sequence:

* ``Conv3DResNetFrontend``: Conv3D stem -> stem BatchNorm -> GELU (tanh)
  -> (1, 3, 3) max-pool -> ResNet-18 trunk -> spatial mean,
  [B, T, H, W, 1] -> [B, T, 8*width];
* ``LandmarkFrontend``: one Dense over each frame's flattened landmarks
  (flax name ``wte``), [B, T, F] -> [B, T, dim];
* ``Conv1DResNetFrontend``: the raw-audio ResNet1D (flax name
  ``resnet1d``), [B, S] or [B, S, 1] at 16 kHz -> [B, S // 640, 8*width].

``build_frontend`` picks one by ``frontend.kind``, as the JAX function does.

In the time-split region of a sequence-parallel step
(``parallel/sequence.py``) each rank runs the video and landmark frontends
on its frames: the stem conv, the only temporal op, reads a 2-frame halo,
and the trunk's BatchNorms reduce over data x seq. The audio frontend
raises there.
"""

from __future__ import annotations

import torch
from torch import nn

from syncvsr_tpu_torch.config import FrontendConfig
from syncvsr_tpu_torch.models.layers import Dense, activation, variance_scaling_fan_out_
from syncvsr_tpu_torch.models.resnet import ResNet1D, ResNetTrunk
from syncvsr_tpu_torch.ops.cuda_bn import FastBatchNorm
from syncvsr_tpu_torch.ops.maxpool import max_pool_3x3_s2
from syncvsr_tpu_torch.ops.stem import stem_conv3d
from syncvsr_tpu_torch.parallel import sequence, tensor

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
        if sequence.active() is None:
            x = stem_conv3d(videos, self.stem_conv_kernel, self.dtype)   # [B, T, H, W, C]
        else:   # this rank's frames: the stem's 5-frame kernel reads 2 frames around
            x = stem_conv3d(sequence.halo(videos, 2, 2), self.stem_conv_kernel, self.dtype,
                            time_pad=0)
        if tensor.split_dim(self.stem_conv_kernel) is not None:   # this rank's channels
            x = tensor.gather_from_model(x)
        # long clips fold time into batch after the only temporal op; the
        # statistics reduce over all non-channel axes either way (under
        # sequence parallel the threshold reads this rank's frames: the
        # fold is a view, so the result is the same on either side of it)
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


class LandmarkFrontend(nn.Module):
    """[B, T, F] landmarks (the -100 pad sentinel already zeroed by the
    word model) -> [B, T, dim] in ``dtype``."""

    def __init__(self, features: int, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_dim = dim
        self.wte = Dense(features, dim, dtype)

    def forward(self, landmarks: Tensor, train: bool = False) -> Tensor:
        return self.wte(landmarks)


class Conv1DResNetFrontend(nn.Module):
    """Raw 16 kHz waveform [B, S] or [B, S, 1], cut to a multiple of 640
    samples (one video frame) and cast to ``dtype`` -> ResNet1D features."""

    def __init__(self, width: int = 64, relu_type: str = "swish",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.resnet1d = ResNet1D(width, relu_type=relu_type, dtype=dtype)
        self.out_dim = self.resnet1d.out_dim

    def forward(self, audio: Tensor, train: bool = False) -> Tensor:
        if sequence.active() is not None:
            raise NotImplementedError(
                "mesh.seq > 1 with the Conv1D audio frontend: a waveform split over "
                "the seq ranks needs a halo at every strided conv of ResNet1D, which "
                "is not ported (a waveform whose length does not divide mesh.seq "
                "stays whole and runs)")
        if audio.dim() == 2:
            audio = audio[..., None]
        s = audio.shape[1] // 640 * 640
        return self.resnet1d(audio[:, :s].to(self.dtype), train)


def build_frontend(cfg: FrontendConfig, dtype: torch.dtype, embed_dim: int = 0) -> nn.Module:
    """The frontend of ``cfg.kind``; ``embed_dim`` sets the landmark
    embedding's width (the others have their own output widths)."""
    if cfg.kind == "landmark":
        return LandmarkFrontend(cfg.input_features, embed_dim or cfg.out_dim, dtype)
    if cfg.kind == "conv3d_resnet":
        return Conv3DResNetFrontend(cfg.stem_channels, cfg.resnet_width, cfg.relu_type,
                                    cfg.stem_act, cfg.fold_threshold, dtype)
    if cfg.kind == "conv1d_resnet":
        return Conv1DResNetFrontend(cfg.resnet_width, cfg.relu_type, dtype=dtype)
    raise ValueError(f"unknown frontend kind: {cfg.kind}")

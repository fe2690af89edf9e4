# Frozen copy of syncvsr_tpu_torch/ops/image.py, part of the benchmark's plain reference.
"""On-device video augmentation (port of ``syncvsr_tpu/ops/image.py``).

Train: horizontal flip + RandomResizedCrop + time mask + normalize in one
pass (``fused_train_aug``), split into a sampling part (crop boxes, flips and
time-mask spans, drawn from a CPU ``torch.Generator``) and a deterministic
apply part on the device: the bilinear resample as two small interpolation
matmuls straight from the uint8 source, with the flip folded into the x
coordinates as a mirrored ramp, the clip-mean fill and the normalisation.

The word-level pipeline (``build_word_aug``) reads ``inputs``; the
sentence-level one (``build_sentence_aug``) reads ``videos`` and bounds
each clip's time masks by its true length. (The port's eval transforms
run in no cell's train step and are not copied.)
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

Tensor = torch.Tensor


def _interp_matrix(coords: Tensor, size: int) -> Tensor:
    """[..., O] fractional coords -> [..., O, size] linear-interpolation
    weights (two taps per row, border-replicating)."""
    c = torch.clamp(coords, 0.0, size - 1.0)
    idx = torch.arange(size, dtype=torch.float32, device=coords.device)
    return torch.clamp(1.0 - torch.abs(c[..., None] - idx), min=0.0)


def sample_train_aug(gen: torch.Generator, b: int, t: int, h: int, w: int,
                     scale: Tuple[float, float] = (0.6, 1.0),
                     ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                     hflip_prob: float = 0.5, time_mask_span: int = 15,
                     time_mask_n: int = 1, lengths: Optional[Tensor] = None
                     ) -> Dict[str, Tensor]:
    """Per-clip crop box (ch, cw, y0, x0), flip [B] bool and time-mask hits
    [B, T] bool, as CPU tensors. A mask's start is drawn below
    ``max(limit - span, 1)``, the limit being each clip's length where
    ``lengths`` [B] is given, else T."""

    def u():
        return torch.rand((b,), generator=gen, dtype=torch.float32)

    area = (scale[0] + (scale[1] - scale[0]) * u()) * (h * w)
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    aspect = torch.exp(lo + (hi - lo) * u())
    cw = torch.clamp(torch.sqrt(area * aspect), 1, w)
    ch = torch.clamp(torch.sqrt(area / aspect), 1, h)
    y0 = u() * (h - ch)
    x0 = u() * (w - cw)
    flip = u() < hflip_prob
    frames = torch.arange(t)[None, :]
    hit = torch.zeros((b, t), dtype=torch.bool)
    limit = (torch.full((b,), t, dtype=torch.float32) if lengths is None
             else lengths.detach().cpu().float())
    for _ in range(time_mask_n):
        span = torch.randint(0, time_mask_span + 1, (b,), generator=gen)
        start = (u() * torch.clamp(limit - span, min=1.0)).long()
        hit |= (frames >= start[:, None]) & (frames < (start + span)[:, None])
    return {"ch": ch, "cw": cw, "y0": y0, "x0": x0, "flip": flip, "hit": hit}


def fused_train_aug_apply(videos: Tensor, p: Dict[str, Tensor], out_size: int,
                          mean: float = 0.421, std: float = 0.165,
                          dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """videos [B, T, H, W, C] (uint8 or float) + sampled values ->
    [B, T, out, out, C] normalised clips in ``dtype``."""
    dev = videos.device
    ch, cw, y0, x0 = (p[k].to(dev)[:, None] for k in ("ch", "cw", "y0", "x0"))
    flip, hit = p["flip"].to(dev), p["hit"].to(dev)
    grid = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) / out_size
    ys = y0 + grid * ch - 0.5
    xs_f = x0 + grid * cw - 0.5
    xs = torch.where(flip[:, None], x0 + (cw - 1.0) - grid * cw + 0.5, xs_f)
    wy = _interp_matrix(ys, videos.shape[2])                     # [B, O, H]
    wx = _interp_matrix(xs, videos.shape[3])                     # [B, P, W]
    f = videos.float()
    v = torch.einsum("boh,bthwc->btowc", wy, f)
    v = torch.einsum("bpw,btowc->btopc", wx, v) * (1.0 / 255.0)
    fill = v.mean(dim=(1, 2, 3, 4), keepdim=True)
    v = torch.where(hit[:, :, None, None, None], fill, v)
    return ((v - mean) / std).to(dtype)


def fused_train_aug(gen: torch.Generator, videos: Tensor, out_size: int,
                    scale: Tuple[float, float] = (0.6, 1.0),
                    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                    hflip_prob: float = 0.5, time_mask_span: int = 15,
                    time_mask_n: int = 1, mean: float = 0.421, std: float = 0.165,
                    lengths: Optional[Tensor] = None,
                    dtype: torch.dtype = torch.bfloat16) -> Tensor:
    b, t, h, w, _ = videos.shape
    p = sample_train_aug(gen, b, t, h, w, scale, ratio, hflip_prob,
                         time_mask_span, time_mask_n, lengths)
    return fused_train_aug_apply(videos, p, out_size, mean, std, dtype)


def build_word_aug(data_cfg):
    """Train-time augmentation of the LRW video workload, the ``aug_fn`` of
    engine.build_train_step: ``aug(gen, batch) -> batch``."""

    def aug(gen: torch.Generator, batch):
        videos = batch["inputs"]
        if videos.dim() != 5:
            return batch  # landmark inputs: augmented in the loader
        v = fused_train_aug(
            gen, videos, data_cfg.crop_size, tuple(data_cfg.rrc_scale),
            hflip_prob=data_cfg.hflip_prob,
            time_mask_span=data_cfg.time_mask_window,
            time_mask_n=data_cfg.time_mask_stride,
            mean=data_cfg.mean, std=data_cfg.std)
        return dict(batch, inputs=v)

    return aug


def build_sentence_aug(data_cfg):
    """Train-time augmentation of the LRS sentence workload (RandomResizedCrop
    scale 0.7-1.0, flip 0.5, two time masks of up to 10 frames each bounded
    by the clip's length when ``data.adaptive_time_mask``, clip-mean fill,
    normalise), the ``aug_fn`` of engine.build_train_step."""

    def aug(gen: torch.Generator, batch):
        videos = batch["videos"]
        if videos.dim() != 5:
            return batch  # landmark or waveform inputs pass through
        adaptive = data_cfg.adaptive_time_mask
        v = fused_train_aug(
            gen, videos, data_cfg.crop_size, (0.7, 1.0), hflip_prob=0.5,
            time_mask_span=10 if adaptive else 0, time_mask_n=2 if adaptive else 0,
            mean=data_cfg.mean, std=data_cfg.std, lengths=batch.get("lengths"))
        return dict(batch, videos=v)

    return aug

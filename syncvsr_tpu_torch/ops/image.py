"""On-device video augmentation (port of ``syncvsr_tpu/ops/image.py``).

Train: horizontal flip + RandomResizedCrop + time mask + normalize in one
pass (``build_word_aug``, ``build_sentence_aug``), a ``TrainAug`` split
into a sampling part (``draw``: crop boxes, flips and time-mask spans,
drawn from a CPU ``torch.Generator``) and a deterministic apply part on
the device (``apply``): the
bilinear resample as two small interpolation matmuls straight from the
uint8 source, with the flip folded into the x coordinates as a mirrored
ramp, the clip-mean fill and the normalisation.

Eval: ``to_float`` -> ``center_crop_resize`` -> ``normalize``.

In a data-parallel step (``parallel/collectives.py``) the draws are made
for the global batch on every rank, from the same-seeded generator, and
each rank keeps its own rows; under sequence parallel
(``parallel/sequence.py``) the time masks are drawn over the whole clip
and each seq rank keeps its frames, so a clip gets the same draws at any
mesh.

The word-level pipeline (``build_word_aug``, ``build_eval_transform``)
reads ``inputs``; the sentence-level one (``build_sentence_aug``,
``build_sentence_eval_transform``) reads ``videos`` and bounds each clip's
time masks by its true length.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from syncvsr_tpu_torch.parallel import collectives, sequence
from syncvsr_tpu_torch.utils.profiling import host_read

Tensor = torch.Tensor


def to_float(videos: Tensor) -> Tensor:
    """uint8 [0, 255] -> f32 [0, 1]."""
    if videos.dtype == torch.uint8:
        return videos.float() / 255.0
    return videos


def normalize(videos: Tensor, mean: float = 0.421, std: float = 0.165) -> Tensor:
    return (videos - mean) / std


def _bilinear_sample(frames: Tensor, ys: Tensor, xs: Tensor) -> Tensor:
    """frames [B, T, H, W, C]; ys [Ho], xs [Wo] fractional coords (shared by
    the batch) -> [B, T, Ho, Wo, C]; corner indices clipped to the frame."""
    h, w = frames.shape[2], frames.shape[3]
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = (ys - y0.to(ys.dtype))[None, None, :, None, None]
    wx = (xs - x0.to(xs.dtype))[None, None, None, :, None]

    def g(yi, xi):
        return frames[:, :, yi][:, :, :, xi]

    top = g(y0, x0) * (1 - wx) + g(y0, x1) * wx
    bot = g(y1, x0) * (1 - wx) + g(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def _interp_matrix(coords: Tensor, size: int) -> Tensor:
    """[..., O] fractional coords -> [..., O, size] linear-interpolation
    weights (two taps per row, border-replicating)."""
    c = torch.clamp(coords, 0.0, size - 1.0)
    idx = torch.arange(size, dtype=torch.float32, device=coords.device)
    return torch.clamp(1.0 - torch.abs(c[..., None] - idx), min=0.0)


def center_crop_resize(videos: Tensor, out_size: int, resize_first: bool = True) -> Tensor:
    """Eval geometry: bilinear resize of the whole frame to out_size (or a
    center crop when ``resize_first`` is False)."""
    _, _, h, w, _ = videos.shape
    if resize_first and (h, w) != (out_size, out_size):
        grid = (torch.arange(out_size, dtype=torch.float32, device=videos.device) + 0.5) / out_size
        return _bilinear_sample(videos, grid * h - 0.5, grid * w - 0.5)
    y0 = (h - out_size) // 2
    x0 = (w - out_size) // 2
    return videos[:, :, y0:y0 + out_size, x0:x0 + out_size]


def sample_train_aug(gen: torch.Generator, b: int, t: int, h: int, w: int,
                     scale: Tuple[float, float] = (0.6, 1.0),
                     ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                     hflip_prob: float = 0.5, time_mask_span: int = 15,
                     time_mask_n: int = 1, lengths: Optional[Tensor] = None,
                     shard: Tuple[int, int] = (0, 1)) -> Dict[str, Tensor]:
    """Per-clip crop box (ch, cw, y0, x0), flip [B] bool and time-mask hits
    [B, T] bool, as CPU tensors. A mask's start is drawn below
    ``max(limit - span, 1)``, the limit being each clip's length where
    ``lengths`` [B] is given, else T. With ``shard`` = (rank, world) the
    values are drawn for a global batch of world * B clips and rank's rows
    [rank * B, (rank + 1) * B) are kept (``lengths`` are those rows'), so a
    clip gets the same draws at any world size."""
    rank, world = shard
    rows = slice(rank * b, (rank + 1) * b)

    def u():
        return torch.rand((world * b,), generator=gen, dtype=torch.float32)[rows]

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
    if lengths is None:
        limit = torch.full((b,), t, dtype=torch.float32)
    else:
        host_read("ops.image_aug")
        limit = lengths.detach().cpu().float()
    for _ in range(time_mask_n):
        span = torch.randint(0, time_mask_span + 1, (world * b,), generator=gen)[rows]
        start = (u() * torch.clamp(limit - span, min=1.0)).long()
        hit |= (frames >= start[:, None]) & (frames < (start + span)[:, None])
    return {"ch": ch, "cw": cw, "y0": y0, "x0": x0, "flip": flip, "hit": hit}


def fused_train_aug_apply(videos: Tensor, p: Dict[str, Tensor], out_size: int,
                          mean: float = 0.421, std: float = 0.165,
                          dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """videos [B, T, H, W, C] (uint8 or float) + sampled values ->
    [B, T, out, out, C] normalised clips in ``dtype``. Under sequence
    parallel ``videos`` holds this rank's frames and ``p["hit"]`` the whole
    clip's: the rank takes its slice, and the clip-mean fill is the whole
    clip's (a sum over the seq ranks)."""
    dev = videos.device
    ch, cw, y0, x0 = (p[k].to(dev)[:, None] for k in ("ch", "cw", "y0", "x0"))
    flip, hit = p["flip"].to(dev), sequence.local(p["hit"].to(dev), 1)
    grid = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) / out_size
    ys = y0 + grid * ch - 0.5
    xs_f = x0 + grid * cw - 0.5
    xs = torch.where(flip[:, None], x0 + (cw - 1.0) - grid * cw + 0.5, xs_f)
    wy = _interp_matrix(ys, videos.shape[2])                     # [B, O, H]
    wx = _interp_matrix(xs, videos.shape[3])                     # [B, P, W]
    f = videos.float()
    v = torch.einsum("boh,bthwc->btowc", wy, f)
    v = torch.einsum("bpw,btowc->btopc", wx, v) * (1.0 / 255.0)
    if sequence.current() is None:
        fill = v.mean(dim=(1, 2, 3, 4), keepdim=True)
    else:
        fill = sequence.time_sum(v, (1, 2, 3, 4)) / (sequence.total(v.shape[1])
                                                     * v[0, 0].numel())
    v = torch.where(hit[:, :, None, None, None], fill, v)
    return ((v - mean) / std).to(dtype)


class TrainAug:
    """A train augmentation in its two parts: ``draw(gen, batch)``, the
    values it samples from the CPU generator ``gen``, on the host (None
    where it draws nothing), and ``apply(batch, drawn) -> batch``, its
    device work. The train step draws before its device work and applies
    inside it (``engine/steps.py``); ``aug(gen, batch)`` does both."""

    def __init__(self, draw: Callable, apply: Callable):
        self.draw, self.apply = draw, apply

    def __call__(self, gen: torch.Generator, batch):
        return self.apply(batch, self.draw(gen, batch))

    def after(self, fn: Callable) -> "TrainAug":
        """This augmentation of ``fn(batch)``: the device hook ``fn``, which
        draws nothing (the in-step codec's tokenizer), runs before the
        apply; the draws read the batch as given."""
        return TrainAug(self.draw, lambda batch, drawn: self.apply(fn(batch), drawn))


def batch_hook(fn: Callable) -> TrainAug:
    """The device hook ``fn(batch) -> batch``, which draws nothing, as a
    train step's augmentation."""
    return TrainAug(lambda gen, batch: None, lambda batch, drawn: fn(batch))


def _split_aug(key: str, out_size: int, mean: float, std: float, lengths: bool = False,
               **draw_kw) -> TrainAug:
    """The fused train augmentation of ``batch[key]`` (a 5-D clip batch;
    any other input passes through): ``draw`` samples its values
    (``sample_train_aug``; ``draw_kw`` are its arguments, and ``lengths``
    bounds the time masks by ``batch["lengths"]``), ``apply`` runs
    ``fused_train_aug_apply``."""

    def draw(gen: torch.Generator, batch) -> Optional[Dict[str, Tensor]]:
        videos = batch[key]
        if videos.dim() != 5:
            return None
        b, t, h, w, _ = videos.shape
        return sample_train_aug(gen, b, sequence.total(t), h, w,
                                lengths=batch.get("lengths") if lengths else None,
                                shard=collectives.shard(), **draw_kw)

    def apply(batch, drawn: Optional[Dict[str, Tensor]]):
        if drawn is None:
            return batch
        return dict(batch, **{key: fused_train_aug_apply(batch[key], drawn, out_size,
                                                         mean, std)})

    return TrainAug(draw, apply)


def build_word_aug(data_cfg):
    """Train-time augmentation of the LRW video workload, the ``aug_fn`` of
    engine.build_train_step, a ``TrainAug`` (landmark inputs, augmented in
    the loader, pass through)."""
    return _split_aug("inputs", data_cfg.crop_size, data_cfg.mean, data_cfg.std,
                      scale=tuple(data_cfg.rrc_scale), hflip_prob=data_cfg.hflip_prob,
                      time_mask_span=data_cfg.time_mask_window,
                      time_mask_n=data_cfg.time_mask_stride)


def build_eval_transform(data_cfg):
    def transform(batch):
        videos = batch["inputs"]
        if videos.dim() != 5:
            return batch
        v = center_crop_resize(to_float(videos), data_cfg.crop_size)
        return dict(batch, inputs=normalize(v, data_cfg.mean, data_cfg.std))

    return transform


def build_sentence_aug(data_cfg):
    """Train-time augmentation of the LRS sentence workload (RandomResizedCrop
    scale 0.7-1.0, flip 0.5, two time masks of up to 10 frames each bounded
    by the clip's length when ``data.adaptive_time_mask``, clip-mean fill,
    normalise), the ``aug_fn`` of engine.build_train_step, a ``TrainAug``;
    landmark or waveform inputs pass through."""
    adaptive = data_cfg.adaptive_time_mask
    return _split_aug("videos", data_cfg.crop_size, data_cfg.mean, data_cfg.std,
                      scale=(0.7, 1.0), hflip_prob=0.5,
                      time_mask_span=10 if adaptive else 0,
                      time_mask_n=2 if adaptive else 0, lengths=True)


def build_sentence_eval_transform(data_cfg, dataset: str = "lrs3"):
    """Eval: LRS3 resizes the whole frame to the crop size, LRS2 center-crops."""
    resize_first = dataset != "lrs2"

    def transform(batch):
        if batch["videos"].dim() != 5:
            return batch  # landmark or waveform inputs pass through
        v = center_crop_resize(to_float(batch["videos"]), data_cfg.crop_size, resize_first)
        return dict(batch, videos=normalize(v, data_cfg.mean, data_cfg.std))

    return transform

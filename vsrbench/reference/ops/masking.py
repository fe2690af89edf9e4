# Frozen copy of syncvsr_tpu_torch/ops/masking.py, part of the benchmark's plain reference.
"""Mask and sequence helpers (port of ``syncvsr_tpu/ops/masking.py``):
padding masks, the teacher-forcing io pair, the label-smoothed KL of the
attention decoder and its token accuracy. Token conventions: sos = eos =
``labels - 1``, ignore = -1. The label-smoothed KL takes the logq form, or,
when the environment sets ``SYNCVSR_LSM_V2`` (as in the JAX package), the
reassociated form that never materializes the [N, V] log-softmax. One
device: every mean is the local batch's (``ratio``)."""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def ratio(num: Tensor, den, floor: Optional[float] = None) -> Tensor:
    """``num / max(den, floor)`` (``num / den`` without ``floor``)."""
    return num / (den if floor is None else torch.clamp(den, min=floor))


def length_mask(lengths: Tensor, max_len: int) -> Tensor:
    """[B] lengths -> [B, T] boolean keep-mask."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def weighted_mean(per_sample: Tensor, weight: Optional[Tensor]) -> Tensor:
    """Mean over the batch, or a sample-weighted mean when ``weight`` [B] is
    given (padded tail batches in exact eval)."""
    if weight is None:
        return per_sample.mean()
    w = weight.float()
    return ratio((per_sample * w).sum(), w.sum(), floor=1.0)


def add_sos_eos(labels: Tensor, sos: int, eos: int, ignore_id: int = -1
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """labels [B, L] padded with ``ignore_id`` -> (ys_in [B, L+1]: sos, then
    the labels, padded with eos; ys_out [B, L+1]: the labels, eos at each
    row's length, padded with ``ignore_id``; ys_in lengths [B] = length + 1)."""
    b, l = labels.shape
    valid = labels != ignore_id
    lengths = valid.sum(1)
    ys_in = torch.cat([torch.full((b, 1), sos, dtype=labels.dtype, device=labels.device),
                       torch.where(valid, labels, torch.full_like(labels, eos))], dim=1)
    ys_out = torch.cat([torch.where(valid, labels, torch.full_like(labels, ignore_id)),
                        torch.full((b, 1), ignore_id, dtype=labels.dtype,
                                   device=labels.device)], dim=1)
    pos = torch.arange(l + 1, device=labels.device)[None, :]
    ys_out = torch.where(pos == lengths[:, None], torch.full_like(ys_out, eos), ys_out)
    return ys_in, ys_out, lengths + 1


def label_smoothing_kl(logits: Tensor, targets: Tensor, vocab: int, smoothing: float,
                       ignore_id: int = -1, normalize_length: bool = False,
                       sample_weight: Optional[Tensor] = None) -> Tensor:
    """KL between the f32 log-softmax predictions and the smoothed target
    (confidence 1 - smoothing on the target, smoothing / (V - 1) elsewhere),
    summed over the non-ignored tokens and divided by the batch size (by the
    token count with ``normalize_length``). ``sample_weight`` [B] excludes
    padded rows from the average. With ``SYNCVSR_LSM_V2`` set, the token
    terms come from the logsumexp, the row sum and the target logit of the
    raw logits (logq.sum(-1) == logits.sum(-1) - V * lse)."""
    b = logits.shape[0]
    flat = logits.reshape(-1, vocab).float()
    flat_t = targets.reshape(-1)
    ignore = flat_t == ignore_id
    safe_t = torch.where(ignore, torch.zeros_like(flat_t), flat_t).long()
    confidence = 1.0 - smoothing
    low = smoothing / (vocab - 1)
    logp_low = math.log(max(low, 1e-30)) if low > 0 else 0.0
    logp_conf = math.log(max(confidence, 1e-30))
    if os.environ.get("SYNCVSR_LSM_V2"):
        lse = torch.logsumexp(flat, dim=-1)
        q_t = torch.gather(flat, 1, safe_t[:, None])[:, 0] - lse
        logq_sum = flat.sum(-1) - vocab * lse
    else:
        logq = torch.log_softmax(flat, dim=-1)
        q_t = torch.gather(logq, 1, safe_t[:, None])[:, 0]
        logq_sum = logq.sum(-1)
    kl = (low * (logp_low * vocab - logq_sum)
          + confidence * logp_conf - low * logp_low
          - (confidence - low) * q_t)
    kl = torch.where(ignore, torch.zeros_like(kl), kl)
    if sample_weight is not None:
        w = sample_weight.float()
        per_sample = kl.reshape(b, -1).sum(1)
        if normalize_length:
            tokens = (~ignore).reshape(b, -1).sum(1) * w
            return ratio((per_sample * w).sum(), tokens.sum(), floor=1)
        return weighted_mean(per_sample, sample_weight)
    if normalize_length:
        return ratio(kl.sum(), (~ignore).sum(), floor=1)
    return ratio(kl.sum(), b)


def decoder_accuracy(logits: Tensor, targets: Tensor, ignore_id: int = -1,
                     sample_weight: Optional[Tensor] = None) -> Tensor:
    """Token accuracy of the argmax over the non-ignored targets (rows of
    zero ``sample_weight`` excluded)."""
    pred = logits.argmax(-1)
    valid = targets != ignore_id
    if sample_weight is not None:
        valid = valid & (sample_weight[:, None] > 0)
    correct = (pred == targets) & valid
    return ratio(correct.sum().float(), valid.sum(), floor=1)

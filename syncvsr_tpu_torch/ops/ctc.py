"""CTC loss of the hybrid sentence-level objective (port of
``syncvsr_tpu/ops/ctc.py::ctc_loss``).

``F.ctc_loss`` on time-major f32 log-softmax inputs, blank 0, no reduction,
``zero_infinity=False`` (an infeasible alignment stays infinite), then the
batch (or sample-weighted) mean. PyTorch's CTC backward returns the
gradient for normalised log-probabilities, so the log-softmax is taken here
in f32 and the gradient reaches the logits through it. Greedy decoding and
forced alignment belong to decoding and are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from syncvsr_tpu_torch.ops.masking import weighted_mean

Tensor = torch.Tensor


def ctc_loss(logits: Tensor, logit_lengths: Tensor, labels: Tensor, label_lengths: Tensor,
             blank_id: int = 0, sample_weight: Optional[Tensor] = None) -> Tensor:
    """Batch-averaged CTC negative log-likelihood.

    logits [B, T, V] raw (pre-softmax); labels [B, N], anything past
    ``label_lengths`` (sanitised here); ``sample_weight`` [B] excludes padded
    rows from the average."""
    n = labels.shape[1]
    label_pad = torch.arange(n, device=labels.device)[None, :] >= label_lengths[:, None]
    safe = torch.where(label_pad, torch.zeros_like(labels), labels).long()
    log_probs = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)   # [T, B, V]
    per_seq = F.ctc_loss(log_probs, safe, logit_lengths.long(), label_lengths.long(),
                         blank=blank_id, reduction="none", zero_infinity=False)
    return weighted_mean(per_seq, sample_weight)

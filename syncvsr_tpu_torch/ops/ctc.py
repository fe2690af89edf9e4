"""CTC loss of the hybrid sentence-level objective (port of
``syncvsr_tpu/ops/ctc.py::ctc_loss``, which calls ``optax.ctc_loss``).

Feasible rows take ``F.ctc_loss`` on time-major f32 log-softmax inputs,
blank 0, no reduction. A row is infeasible when its labels and their
repeated neighbours outnumber its frames: no alignment exists, the exact
loss is infinite, and optax's recursion, which stands ``LOG_EPSILON`` in for
log 0, gives a large finite loss with finite gradients. Such rows take the
same recursion here (``ctc_loss_optax``), selected per row with
``torch.where``; ``F.ctc_loss`` then runs with ``zero_infinity=True`` so
that its infinite rows reach no gradient. A batch with no infeasible row
pays for the test (six small launches and one host read of its ``any``)
and runs ``F.ctc_loss`` as before: neither the recursion, a Python loop
over the frames, nor ``zero_infinity``'s own launches.

PyTorch's CTC backward returns the gradient for normalised
log-probabilities, so the log-softmax is taken here in f32 and the gradient
reaches the logits through it. Greedy decoding and forced alignment belong
to decoding and are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from syncvsr_tpu_torch.ops.masking import weighted_mean

Tensor = torch.Tensor

LOG_EPSILON = -1e5   # optax.ctc_loss's stand-in for log 0


def infeasible_rows(logit_lengths: Tensor, labels: Tensor, label_lengths: Tensor,
                    label_pad: Tensor) -> Tensor:
    """[B] bool: rows whose labels, plus one blank between each pair of
    equal neighbours, need more frames than they have. ``label_pad`` [B, N]
    is True past ``label_lengths``."""
    # an equal pair counts where its second label is real (True > False)
    repeats = torch.gt(labels[:, 1:] == labels[:, :-1], label_pad[:, 1:]).sum(1)
    return label_lengths + repeats > logit_lengths


def ctc_loss_optax(log_probs: Tensor, logit_lengths: Tensor, labels: Tensor,
                   label_lengths: Tensor, blank_id: int = 0) -> Tensor:
    """Per-row loss of optax's log-space alpha recursion
    (``optax.losses.ctc_loss_with_forward_probs``, ``log_epsilon`` -1e5):
    log_probs [B, T, K] normalised f32, labels [B, N] with pads already
    sanitised -> [B]. Finite on every row, feasible or not."""
    b, t, _ = log_probs.shape
    eps = LOG_EPSILON
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))      # [B, N]
    lp_phi = log_probs[:, :, blank_id:blank_id + 1]                          # [B, T, 1]
    lp_emit = torch.gather(log_probs, 2, labels[:, None, :].expand(b, t, -1))  # [B, T, N]
    phi = torch.full((b, labels.shape[1] + 1), eps, dtype=log_probs.dtype,
                     device=log_probs.device)
    phi[:, 0] = 0.0
    emit = torch.full_like(phi[:, 1:], eps)
    pad = torch.arange(t, device=log_probs.device)[None, :] >= logit_lengths[:, None]

    def add_to_tail(x, score):   # logaddexp ``score`` into x[:, 1:]
        return torch.cat((x[:, :1], torch.logaddexp(x[:, 1:], score)), dim=1)

    for i in range(t):
        prev_phi = add_to_tail(phi, emit + eps * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit[:, i], emit + lp_emit[:, i])
        next_phi = add_to_tail(prev_phi + lp_phi[:, i],
                               emit + lp_phi[:, i] + eps * (1.0 - repeat))
        skip = pad[:, i:i + 1]
        emit = torch.where(skip, emit, next_emit)
        phi = torch.where(skip, phi, next_phi)
    last = add_to_tail(phi, emit)
    return -torch.gather(last, 1, label_lengths.long()[:, None])[:, 0]


def ctc_loss(logits: Tensor, logit_lengths: Tensor, labels: Tensor, label_lengths: Tensor,
             blank_id: int = 0, sample_weight: Optional[Tensor] = None) -> Tensor:
    """Batch-averaged CTC negative log-likelihood.

    logits [B, T, V] raw (pre-softmax); labels [B, N], anything past
    ``label_lengths`` (sanitised here); ``sample_weight`` [B] excludes padded
    rows from the average."""
    n = labels.shape[1]
    label_pad = torch.arange(n, device=labels.device)[None, :] >= label_lengths[:, None]
    safe = torch.where(label_pad, torch.zeros_like(labels), labels).long()
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    bad = infeasible_rows(logit_lengths, safe, label_lengths, label_pad)
    any_bad = bool(bad.any())
    per_seq = F.ctc_loss(log_probs.transpose(0, 1), safe, logit_lengths.long(),
                         label_lengths.long(), blank=blank_id, reduction="none",
                         zero_infinity=any_bad)
    if any_bad:
        per_seq = torch.where(bad, ctc_loss_optax(log_probs, logit_lengths, safe,
                                                  label_lengths, blank_id), per_seq)
    return weighted_mean(per_seq, sample_weight)

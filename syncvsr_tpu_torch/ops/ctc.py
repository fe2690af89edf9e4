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
reaches the logits through it.

Decoding: greedy collapse (``ctc_greedy_decode``) and Viterbi forced
alignment (``ctc_forced_align``), ports of the functions of the same names,
equal to them token for token.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from syncvsr_tpu_torch.ops.masking import weighted_mean
from syncvsr_tpu_torch.utils.profiling import host_read

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
    host_read("ops.ctc_loss")
    any_bad = bool(bad.any())
    per_seq = F.ctc_loss(log_probs.transpose(0, 1), safe, logit_lengths.long(),
                         label_lengths.long(), blank=blank_id, reduction="none",
                         zero_infinity=any_bad)
    if any_bad:
        per_seq = torch.where(bad, ctc_loss_optax(log_probs, logit_lengths, safe,
                                                  label_lengths, blank_id), per_seq)
    return weighted_mean(per_seq, sample_weight)


def ctc_greedy_decode(logits: Tensor, logit_lengths: Tensor,
                      blank_id: int = 0) -> Tuple[Tensor, Tensor]:
    """Greedy CTC collapse: argmax per frame, merge repeats, drop blanks.

    Returns (tokens [B, T] padded with -1, lengths [B]). Each kept token is
    scattered to its rank among the row's kept tokens and every other frame
    to a column of its own past T, so no two writes meet (a scatter with
    repeated indices is nondeterministic on CUDA)."""
    b, t, _ = logits.shape
    path = logits.argmax(-1)                                     # first maximum
    frames = torch.arange(t, device=logits.device)
    prev = F.pad(path[:, :-1], (1, 0), value=blank_id)
    keep = (path != blank_id) & (path != prev) & (frames[None, :] < logit_lengths[:, None])
    rank = keep.cumsum(1) - 1
    dest = torch.where(keep, rank, t + frames[None, :])
    out = torch.full((b, 2 * t), -1, dtype=path.dtype, device=path.device)
    out.scatter_(1, dest, torch.where(keep, path, -1))
    return out[:, :t], keep.sum(1)


_NEG = -1e30  # log(0) stand-in that survives f32 additions over T frames


def ctc_forced_align(logits: Tensor, logit_lengths: Tensor, labels: Tensor,
                     label_lengths: Tensor, blank_id: int = 0) -> Tensor:
    """Batched CTC forced alignment: the most likely frame-level path of
    the blank-interleaved trellis [blank, l1, blank, ..., lN, blank]
    (transitions stay / advance 1 / advance 2 where the label differs from
    the one two states back; the path ends in the last blank or the last
    label). A forward max-DP over the frames keeps uint8 backpointers, then
    a reverse backtrace reads the path; both are loops over T. The three
    transitions are stacked in the order [stay, advance 1, advance 2] and
    ``torch.max`` takes the first maximum, as ``jnp.argmax`` does.

    logits [B, T, V] raw; labels [B, N], anything past ``label_lengths``.
    Returns [B, T] int32 token ids (blank between emissions), -1 past
    ``logit_lengths``; a row with no labels aligns every frame to blank."""
    b, t, _ = logits.shape
    n = labels.shape[1]
    s = 2 * n + 1
    dev = logits.device
    lp = torch.log_softmax(logits.float(), dim=-1)
    label_pad = torch.arange(n, device=dev)[None, :] >= label_lengths[:, None]
    y_int = torch.full((b, s), blank_id, dtype=torch.long, device=dev)
    y_int[:, 1::2] = torch.where(label_pad, blank_id, labels.long())
    states = torch.arange(s, device=dev)
    prev2 = F.pad(y_int[:, :-2], (2, 0), value=-1)
    allow2 = (states[None, :] % 2 == 1) & (y_int != prev2)
    # states past a row's own trellis can never be entered
    s_eff = 2 * label_lengths.long() + 1
    in_trellis = states[None, :] < s_eff[:, None]
    emit = torch.gather(lp, 2, y_int[:, None, :].expand(b, t, s))        # [B, T, S]
    emit = torch.where(in_trellis[:, None, :], emit, _NEG)
    live = torch.arange(t, device=dev)[None, :] < logit_lengths[:, None]  # [B, T]

    delta = torch.full((b, s), _NEG, device=dev)
    delta[:, :2] = emit[:, 0, :2]
    neg = torch.full((b, 2), _NEG, device=dev)
    bps = []
    for i in range(1, t):
        shift1 = torch.cat((neg[:, :1], delta[:, :-1]), 1)
        shift2 = torch.where(allow2, torch.cat((neg, delta[:, :-2]), 1), _NEG)
        best, bp = torch.max(torch.stack((delta, shift1, shift2)), 0)
        on = live[:, i:i + 1]
        # past its length a row's lattice stays as it is (stay, no emission)
        delta = torch.where(on, best + emit[:, i], delta)
        bps.append(torch.where(on, bp, 0).to(torch.uint8))

    last_blank = s_eff - 1
    last_label = torch.clamp(s_eff - 2, min=0)
    take = lambda idx: torch.gather(delta, 1, idx[:, None])[:, 0]  # noqa: E731
    state = torch.where(take(last_blank) >= take(last_label), last_blank, last_label)
    path = [state]
    for bp in reversed(bps):
        state = state - torch.gather(bp, 1, state[:, None])[:, 0].long()
        path.append(state)
    path = torch.stack(path[::-1], 1)                                     # [B, T]
    align = torch.gather(y_int, 1, path).to(torch.int32)
    return torch.where(live, align, -1)

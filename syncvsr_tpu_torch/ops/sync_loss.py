"""Frame-level audio-token synchronization loss (port of
``syncvsr_tpu/ops/sync_loss.py``).

A linear head on the encoder's per-frame outputs predicts, for each frame,
``alignment * groups`` codec tokens over ``vocab``; the loss is the mean
cross-entropy over the valid (token >= 0) slots. Token contract: tokens
arrive ``[B, >= T*A, G]``, are truncated to ``T*A`` rows and regrouped to
``[B, T, A*G]``; the mean divides by the valid count clamped to >= 1.

``sync_cross_entropy`` with a ``chunk`` shorter than T runs a time-chunked
autograd function whose backward recomputes each chunk's softmax, so the
[B, T, A*G, V] logits are never held for the backward.

In a data-parallel step (``parallel/collectives.py``) the sum and the valid
count are the global batch's, all-reduced before the division; the
backward scales by the global count. With ``model`` (a head whose slots
are split over the model axis, ``models/word.py::SyncHead``) they are
this rank's slots' partials, summed over every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from syncvsr_tpu_torch.parallel import collectives
from syncvsr_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


def sync_logits(features: Tensor, kernel: Tensor, bias: Tensor,
                alignment: int, groups: int, vocab: int) -> Tensor:
    """[B, T, D] -> [B, T, A*G, V] f32 logits. The product takes the kernel
    in the features' dtype and accumulates in f32, like the JAX einsum with
    ``preferred_element_type=f32``."""
    b, t, _ = features.shape
    logits = torch.matmul(features.float(), kernel.to(features.dtype).float())
    logits = logits + bias.float()
    return logits.reshape(b, t, alignment * groups, vocab)


def regroup_tokens(tokens: Tensor, b: int, t: int, alignment: int, groups: int) -> Tensor:
    """[B, >= T*A, G] -> [B, T, A*G] (truncated to the aligned window)."""
    return tokens.reshape(b, -1, groups)[:, : t * alignment].reshape(b, t, alignment * groups)


def _masked_ce(logits: Tensor, tok: Tensor) -> Tuple[Tensor, Tensor]:
    """logits [..., V], tok [...] -> (sum of CE over tok >= 0, valid count)."""
    valid = tok >= 0
    safe = torch.where(valid, tok, torch.zeros_like(tok))
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    ce = torch.where(valid, lse - lab, torch.zeros_like(lse))
    return ce.sum(), valid.sum()


def sync_cross_entropy_reference(features: Tensor, kernel: Tensor, bias: Tensor,
                                 tokens: Tensor, alignment: int, groups: int,
                                 vocab: int) -> Tensor:
    """Unfused reference (no ignore handling: every token must be valid)."""
    b, t, _ = features.shape
    logits = sync_logits(features, kernel, bias, alignment, groups, vocab)
    logits = logits.reshape(b * t * alignment * groups, vocab)
    tok = tokens.reshape(b, -1, groups)[:, : t * alignment].reshape(-1)
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, tok[:, None].long())[:, 0]
    return (lse - lab).sum() / float(logits.shape[0])


def make_chunk_residuals(features: Tensor, tokens: Tensor, alignment: int,
                         groups: int, chunk: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Pad the time axis to whole chunks (pad tokens -1) -> (features
    [B, n*chunk, D], tok [B, n*chunk, A*G], count clamped to >= 1)."""
    b, t, _ = features.shape
    tok = regroup_tokens(tokens, b, t, alignment, groups)
    n_chunks = max(1, -(-t // chunk))
    pad_t = n_chunks * chunk - t
    if pad_t:
        features = F.pad(features, (0, 0, 0, pad_t))
        tok = F.pad(tok, (0, 0, 0, pad_t), value=-1)
    count = torch.clamp((tok >= 0).sum(), min=1)
    return features, tok, count


def chunked_backward(features: Tensor, kernel: Tensor, bias: Tensor, tok: Tensor,
                     count: Tensor, t: int, alignment: int, groups: int, vocab: int,
                     chunk: int, g: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-chunk recompute of the softmax-CE gradient (port of
    ``_chunked_bwd``): f32 features, the kernel in f32, scale ``g / count``.
    ``features``/``tok`` are the padded residuals of make_chunk_residuals.
    Returns (dfeatures [B, t, D], dkernel, dbias) in the inputs' dtypes."""
    b, tp, d = features.shape
    slots = alignment * groups
    scale = g / count.float()
    k32 = kernel.float()
    dk = torch.zeros((d, slots * vocab), dtype=torch.float32, device=features.device)
    db = torch.zeros((slots * vocab,), dtype=torch.float32, device=features.device)
    dfeat = []
    for c0 in range(0, tp, chunk):
        feat_c = features[:, c0:c0 + chunk]
        tok_c = tok[:, c0:c0 + chunk]
        valid = tok_c >= 0
        safe = torch.where(valid, tok_c, torch.zeros_like(tok_c))
        logits = sync_logits(feat_c, kernel, bias, alignment, groups, vocab)
        probs = torch.softmax(logits, dim=-1)
        onehot = F.one_hot(safe.long(), vocab).float()
        dlogits = (probs - onehot) * valid[..., None].float() * scale
        dl_flat = dlogits.reshape(b, feat_c.shape[1], slots * vocab)
        dfeat.append(torch.matmul(dl_flat, k32.t()))
        dk = dk + torch.einsum("bcd,bcv->dv", feat_c.float(), dl_flat)
        db = db + dl_flat.sum((0, 1))
    dfeatures = torch.cat(dfeat, dim=1)[:, :t]
    return dfeatures.to(features.dtype), dk.to(kernel.dtype), db.to(bias.dtype)


class _ChunkedSyncCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, kernel, bias, tokens, alignment, groups, vocab, chunk,
                model):
        t = features.shape[1]
        feats, tok, count = make_chunk_residuals(features, tokens, alignment, groups, chunk)
        total = torch.zeros((), dtype=torch.float32, device=features.device)
        with span("kernel.sync_ce"):
            for c0 in range(0, feats.shape[1], chunk):
                logits = sync_logits(feats[:, c0:c0 + chunk], kernel, bias,
                                     alignment, groups, vocab)
                s, _ = _masked_ce(logits, tok[:, c0:c0 + chunk])
                total = total + s
        if collectives.reduces(model):   # the global sum and slot count
            total, count = collectives.reduce_sums(total, (tok >= 0).sum(), model=model)
            count = torch.clamp(count, min=1.0)
        ctx.save_for_backward(feats, kernel, bias, tok, count)
        ctx.meta = (t, alignment, groups, vocab, chunk)
        return total / count.float()

    @staticmethod
    def backward(ctx, g):
        feats, kernel, bias, tok, count = ctx.saved_tensors
        t, alignment, groups, vocab, chunk = ctx.meta
        with span("kernel.sync_ce.bwd"):
            df, dk, db = chunked_backward(feats, kernel, bias, tok, count, t, alignment,
                                          groups, vocab, chunk, g)
        return df, dk, db, None, None, None, None, None, None


def sync_cross_entropy(features: Tensor, kernel: Tensor, bias: Tensor, tokens: Tensor,
                       alignment: int, groups: int, vocab: int,
                       chunk: Optional[int] = None, model: bool = False) -> Tensor:
    """Mean CE over every valid (frame, alignment, group) slot.

    features [B, T, D]; kernel [D, A*G*V]; bias [A*G*V];
    tokens [B, >= T*A, G] int (negative = ignore). ``model``: the slots are
    this rank's share of the model group's (the sums span every rank).
    """
    b, t, _ = features.shape
    if chunk is None or chunk >= t:
        tok = regroup_tokens(tokens, b, t, alignment, groups)
        with span("kernel.sync_ce"):
            logits = sync_logits(features, kernel, bias, alignment, groups, vocab)
            total, count = _masked_ce(logits, tok)
        return collectives.global_mean(total, count, floor=1, model=model)
    return _ChunkedSyncCE.apply(features, kernel, bias, tokens, alignment, groups,
                                vocab, chunk, model)

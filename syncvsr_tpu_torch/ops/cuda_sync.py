"""Fused sync-head projection + cross-entropy on the GPU (port of
``syncvsr_tpu/ops/pallas_sync.py``).

Two kernels compute the same function, as on the TPU: the forward reduces
the per-slot softmax-CE to a (sum, count) pair without writing the logits,
with the TPU kernels' casts (features and weight to bf16 before the
product, the bias f32, f32 accumulation).

* K1, ``sync_ce_mono_partials`` (``csrc/sync_ce.cu::sync_ce_fwd``,
  replacing the Pallas ``_kernel``): grid (128-row tile, slot), TMA and
  wgmma, one launch (``mono_geometry``);
  features whose rows are no multiple of 16 bytes (D = 513) are copied
  into a zero-padded buffer first (``pad_features``), as the JAX wrapper
  pads them for its kernel;
* K2, ``sync_ce_split_partials`` (``csrc/sync_ce_split.cu::
  sync_ce_split_fwd``, replacing ``_kernel_split``): grid (64-row tile,
  slot), TMA and wgmma, one launch (``split_geometry``).

Both keep their partials in one per-device scratch buffer (they run on one
stream at a time) and write their (sum, count) into a slice of the
per-device result arena (``utils/kernels``): no allocation a call.

``sync_ce_partials`` picks between them by the JAX package's rule
(``_pallas_forward``): K2 when the padded bf16 weight exceeds 4 MiB. The
backward is the chunked recompute of ``ops/sync_loss.py`` in plain
PyTorch, as the JAX package runs ``_chunked_bwd`` in XLA, over the original
f32 features.
"""

from __future__ import annotations

from typing import Tuple

import torch

from syncvsr_tpu_torch.ops.sync_loss import (
    chunked_backward,
    make_chunk_residuals,
    regroup_tokens,
)
from syncvsr_tpu_torch.utils import kernels

Tensor = torch.Tensor

_SMS = 132        # H100 SXM streaming multiprocessors
MAX_VOCAB = 320  # vocabulary one block holds per slot
_MONO_ROWS = 128  # rows per block of K1 (two wgmma m64 tiles)
_MONO_STAGES = 3
_SPLIT_ROWS = 64  # rows per block of K2 (one wgmma m64)
# weights larger than this (bf16, D and V padded to 128) take K2
# (syncvsr_tpu/ops/pallas_sync.py::_MONO_W_BYTES)
_MONO_W_BYTES = 4 * 1024 * 1024


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def uses_split_kernel(d: int, slots: int, vocab: int) -> bool:
    """The JAX dispatch rule: K2 when the padded bf16 weight exceeds 4 MiB."""
    return _round_up(d, 128) * slots * _round_up(vocab, 128) * 2 > _MONO_W_BYTES


def sync_ce_partials_plain(x: Tensor, w: Tensor, b: Tensor, tok: Tensor
                           ) -> Tuple[Tensor, Tensor]:
    """x [N, D], w [D, S*V], b [S*V], tok [N, S] (< 0 = ignore) ->
    f32 (sum of CE over valid slots, valid count). The plain version of
    both K1 and K2."""
    n = x.shape[0]
    s = tok.shape[1]
    xb = x.to(torch.bfloat16).float()
    wb = w.to(torch.bfloat16).float()
    logits = (torch.matmul(xb, wb) + b.float()).reshape(n, s, -1)
    valid = tok >= 0
    safe = torch.where(valid, tok, torch.zeros_like(tok)).long()
    m = logits.amax(-1, keepdim=True)
    lse = (m + torch.log(torch.exp(logits - m).sum(-1, keepdim=True)))[..., 0]
    lab = torch.gather(logits, -1, safe[..., None])[..., 0]
    ce = torch.where(valid, lse - lab, torch.zeros_like(lse))
    return ce.sum(), valid.sum().float()


def split_geometry(n: int, slots: int) -> dict:
    """K2's launch, as ``csrc/sync_ce_split.cu`` makes it: a (64-row tile,
    slot) grid of blocks of two consumer warpgroups, each owning half of
    the 320 columns a block holds, over a ring of two 48 KB stages."""
    tiles = -(-n // _SPLIT_ROWS)
    return {"grid": (tiles, slots), "blocks": tiles * slots, "rows": _SPLIT_ROWS,
            "threads": 256, "columns_per_warpgroup": MAX_VOCAB // 2,
            # the ring, its 1024-byte alignment, the barriers and merge buffers
            "smem_bytes": 2 * (_SPLIT_ROWS + MAX_VOCAB) * 64 * 2 + 1024 + 864}


def mono_geometry(n: int, slots: int) -> dict:
    """K1's launch, as ``csrc/sync_ce.cu`` makes it: a (128-row tile,
    slot) grid of blocks of two consumer warpgroups, each owning half of
    the 320 columns of the slot for both of the block's 64-row tiles (80
    f32 accumulators a tile), over a ring of three stages; the shared
    memory a block takes (the ring, its 1024-byte alignment, barriers and
    merge buffers), the one block an SM holds (its 255 registers a thread
    allow no second), and the waves of the 132 SMs the grid makes."""
    tiles = -(-n // _MONO_ROWS)
    threads, stages = 256, _MONO_STAGES
    smem = (stages * (_MONO_ROWS * 64 * 2 + MAX_VOCAB * 64 * 2) + 1024
            + 16 * stages + _MONO_ROWS * 3 * 4 + threads // 32 * 8)
    return {"grid": (tiles, slots), "blocks": tiles * slots, "rows": _MONO_ROWS,
            "threads": threads, "stages": stages, "accumulators": 80 * _MONO_ROWS // 64,
            "smem_bytes": smem, "blocks_per_sm": 1, "waves": tiles * slots / _SMS}


def _kernel_operands(name: str, x: Tensor, w: Tensor, b: Tensor, tok: Tensor):
    """Check the shapes both kernels take; returns (bf16 w, f32 b, int32
    tok, n, d, slots, vocab), contiguous."""
    n, d = x.shape
    s = tok.shape[1]
    sv = w.shape[1]
    if w.shape[0] != d or sv % s or b.shape != (sv,) or tok.shape[0] != n:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}, tok {tuple(tok.shape)} disagree")
    vocab = sv // s
    if vocab > MAX_VOCAB or vocab % 8:
        raise ValueError(f"{name}: vocab {vocab} per slot must be a multiple "
                         f"of 8 and at most {MAX_VOCAB}")
    if not (w.is_cuda and b.is_cuda and tok.is_cuda):
        raise ValueError(f"{name}: all inputs must be on the GPU")
    wb = w.to(torch.bfloat16).contiguous()
    if wb.data_ptr() % 16:
        raise ValueError(f"{name}: the weight is not 16-byte aligned")
    return wb, b.float().contiguous(), tok.to(torch.int32).contiguous(), n, d, s, vocab


def pad_features(x: Tensor) -> Tensor:
    """x [N, D] as the bf16 operand K1's TMA reads: x itself where it is a
    contiguous, 16-byte aligned bf16 tensor with rows a multiple of 16
    bytes; else a copy into [N, D rounded up to 8] whose pad columns are
    zero, in a per-device buffer for this D (reused by the next call, so it
    holds the last call's features)."""
    n, d = x.shape
    if (d % 8 == 0 and x.dtype == torch.bfloat16 and x.is_contiguous()
            and x.data_ptr() % 16 == 0):
        return x
    ldx = -(-d // 8) * 8
    buf = kernels.scratch(f"sync_x{d}", x.device, n * ldx, torch.bfloat16)[2]
    xp = buf[:n * ldx].view(n, ldx)
    xp[:, :d].copy_(x)
    return xp


def sync_ce_mono_partials(x: Tensor, w: Tensor, b: Tensor, tok: Tensor
                          ) -> Tuple[Tensor, Tensor]:
    """K1 on CUDA tensors (the plain version on CPU tensors); same contract
    as sync_ce_partials_plain. One launch after the features' pad copy
    (none where D is a multiple of 8 and x is bf16): the kernel also sums
    its partials."""
    if not x.is_cuda:
        return sync_ce_partials_plain(x, w, b, tok)
    wb, bf, ti, n, d, s, vocab = _kernel_operands("sync_ce_mono_partials", x, w, b, tok)
    xp = pad_features(x)
    device = x.get_device()
    partials = kernels.scratch("sync_partials", device,
                               2 * mono_geometry(n, s)["blocks"])[1]
    out, res = kernels.result(device, 2)
    status = kernels.library().sync_ce_fwd(
        xp.data_ptr(), wb.data_ptr(), bf.data_ptr(), ti.data_ptr(), partials, out, n, d,
        xp.stride(0), s, vocab, kernels.current_stream(device))
    kernels.check(status, "sync_ce_fwd")
    sync_ce_mono_partials.launches += 1
    return res[0], res[1]


sync_ce_mono_partials.launches = 0


def sync_ce_split_partials(x: Tensor, w: Tensor, b: Tensor, tok: Tensor
                           ) -> Tuple[Tensor, Tensor]:
    """K2 on CUDA tensors (the plain version on CPU tensors); same contract
    as sync_ce_partials_plain. D must be a multiple of 8 (TMA's 16-byte row
    strides). One launch: the kernel also sums its partials."""
    if not x.is_cuda:
        return sync_ce_partials_plain(x, w, b, tok)
    wb, bf, ti, n, d, s, vocab = _kernel_operands("sync_ce_split_partials", x, w, b, tok)
    xb = x.to(torch.bfloat16).contiguous()
    if d % 8:
        raise ValueError(f"sync_ce_split_partials: D={d} must be a multiple of 8")
    if xb.data_ptr() % 16:
        raise ValueError("sync_ce_split_partials: the features are not 16-byte aligned")
    device = x.get_device()
    partials = kernels.scratch("sync_partials", device,
                               2 * split_geometry(n, s)["blocks"])[1]
    out, res = kernels.result(device, 2)
    status = kernels.library().sync_ce_split_fwd(
        xb.data_ptr(), wb.data_ptr(), bf.data_ptr(), ti.data_ptr(), partials, out, n, d, s,
        vocab, kernels.current_stream(device))
    kernels.check(status, "sync_ce_split_fwd")
    sync_ce_split_partials.launches += 1
    return res[0], res[1]


sync_ce_split_partials.launches = 0


def sync_ce_partials(x: Tensor, w: Tensor, b: Tensor, tok: Tensor
                     ) -> Tuple[Tensor, Tensor]:
    """K1 or K2 by the JAX rule (``uses_split_kernel``); same contract as
    sync_ce_partials_plain."""
    s = tok.shape[1]
    split = uses_split_kernel(x.shape[1], s, w.shape[1] // s)
    return (sync_ce_split_partials if split else sync_ce_mono_partials)(x, w, b, tok)


class _FusedSyncCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, kernel, bias, tokens, alignment, groups, vocab, chunk):
        b, t, d = features.shape
        slots = alignment * groups
        tok = regroup_tokens(tokens, b, t, alignment, groups)
        ce_sum, count = sync_ce_partials(features.reshape(b * t, d), kernel, bias,
                                         tok.reshape(b * t, slots))
        feats, tok_p, cnt = make_chunk_residuals(features, tokens, alignment, groups, chunk)
        ctx.save_for_backward(feats, kernel, bias, tok_p, cnt)
        ctx.meta = (t, alignment, groups, vocab, chunk)
        return ce_sum / torch.clamp(count, min=1.0)

    @staticmethod
    def backward(ctx, g):
        feats, kernel, bias, tok, count = ctx.saved_tensors
        t, alignment, groups, vocab, chunk = ctx.meta
        df, dk, db = chunked_backward(feats, kernel, bias, tok, count, t, alignment,
                                      groups, vocab, chunk, g)
        return df, dk, db, None, None, None, None, None


def fused_sync_cross_entropy(features: Tensor, kernel: Tensor, bias: Tensor,
                             tokens: Tensor, alignment: int, groups: int, vocab: int,
                             chunk: int = 128) -> Tensor:
    """Drop-in fused version of ops.sync_loss.sync_cross_entropy.

    features [B, T, D]; kernel [D, A*G*V]; bias [A*G*V];
    tokens [B, >= T*A, G] (-1 ignored); ``chunk`` is the backward's time chunk.
    """
    return _FusedSyncCE.apply(features, kernel, bias, tokens, alignment, groups,
                              vocab, chunk)

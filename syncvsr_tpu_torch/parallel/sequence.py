"""Sequence parallel over the mesh's ``seq`` axis (the port of the ``seq``
part of ``syncvsr_tpu/parallel/mesh.py``).

The JAX package splits the time axis of the ``videos``/``inputs`` leaves
over ``seq`` (``batch_shardings``) and lets GSPMD insert the collectives:
halo exchanges for the temporal convolutions, K/V all-gathers for
attention, and the BatchNorm and loss reductions across shards. Here the
step splits a batch's time (``mesh.split_time``: seq index s holds frames
[s*T/S, (s+1)*T/S)), makes that slice the current one (``batch``), and the
model marks the part of its forward that runs on the rank's frames
(``region``): the frontend and, in the sentence model, the Conformer and
the sync head. Inside the region

* every global-batch reduction spans data x seq (``collectives.span``:
  BatchNorm sums, the sync CE's (sum, count), loss means);
* a temporal conv takes ``halo`` frames of its neighbours;
* attention takes its local queries against ``gather_kv`` keys and values;
* a dropout mask is drawn at the whole clip's shape and sliced
  (``layers.dropout``), so a clip's masks are those of one process.

The region's output goes through ``gather_time`` into the replicated part
(the CTC head, CTC and the decoder; a word model's encoder and heads),
which every seq rank computes alike on the whole clip, with reductions
over ``data`` only.

**Where the gradient sums.** Every gradient is summed over data x seq
(``engine/steps.py``). A parameter used in the region gets this rank's
frames' share, so the sum is its gradient. A parameter used after the
gather gets the whole gradient on every seq rank, so each loss term
computed there is weighted by 1/S in the backward (``replicated``; its
value is unscaled), and ``gather_time``'s backward is a reduce-scatter:
it sums the seq ranks' 1/S shares of the whole clip's cotangent and keeps
this rank's frames. ``gather_kv``'s backward is a reduce-scatter for
another reason: every rank's queries read every key, so a key's cotangent
is the sum of every rank's. Each is tested against the one-process
gradient (``tests/test_torch_seq_parallel.py``).

Only all_gather_into_tensor and reduce_scatter_tensor are used (gloo runs
both on CUDA tensors), so two processes that share one card can check the
path. With no current slice every function here is the identity.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Iterator, Optional

import torch
import torch.distributed as dist

from syncvsr_tpu_torch.parallel import collectives

Tensor = torch.Tensor


@dataclass(frozen=True)
class TimeSlice:
    """Frames [start, start + length) of a clip of ``total`` frames, this
    rank's on ``mesh``'s seq axis."""

    mesh: Any
    start: int
    length: int
    total: int


_SLICE: Optional[TimeSlice] = None   # the running step's batch slice


def current() -> Optional[TimeSlice]:
    """The running step's time slice (None where its batch is whole)."""
    return _SLICE


def active() -> Optional[TimeSlice]:
    """The time slice inside the model's time-split ``region``, else None:
    what the ops that exchange frames (``halo``, ``gather_kv``) and draw
    per-frame masks ask."""
    return _SLICE if collectives.splitting() else None


@contextlib.contextmanager
def batch(time: Optional[TimeSlice]) -> Iterator[None]:
    """Make ``time`` the running step's slice (the step's forward and
    backward; process-wide, as ``collectives.data_parallel``)."""
    global _SLICE
    prev, _SLICE = _SLICE, time
    try:
        yield
    finally:
        _SLICE = prev


def region():
    """The model's time-split part: inside it the reductions span data x
    seq and ``active()`` is the slice. A no-op where the batch is whole."""
    return collectives.time_split(_SLICE is not None)


def total(length: int) -> int:
    """The whole clip's frame count of a tensor with ``length`` frames of
    this rank (itself where the batch is whole)."""
    return _SLICE.total if _SLICE is not None else length


def start() -> int:
    """This rank's first frame (0 where the batch is whole)."""
    return _SLICE.start if _SLICE is not None else 0


def local(x: Tensor, dim: int = 1) -> Tensor:
    """This rank's frames of a tensor that spans the whole clip on ``dim``
    (a length mask, time-mask hits, a CutMix keep mask)."""
    if _SLICE is None:
        return x
    return x.narrow(dim, _SLICE.start, _SLICE.length)


def _gather_parts(x: Tensor, mesh) -> Tensor:
    """[S, *x.shape]: every seq rank's ``x``, in seq order (one all-gather
    of the bytes: any dtype alike)."""
    x = x.contiguous()
    flat = x.reshape(-1).view(torch.uint8)
    out = torch.empty(mesh.seq * flat.numel(), dtype=torch.uint8, device=x.device)
    dist.all_gather_into_tensor(out, flat, group=mesh.seq_group)
    return out.view(x.dtype).view((mesh.seq,) + tuple(x.shape))


def _scatter_sum(g: Tensor, mesh) -> Tensor:
    """The sum over the seq ranks of their part ``seq_index`` of ``g``
    [S, ...] (one reduce-scatter, in f32 or wider)."""
    parts = g.to(torch.promote_types(g.dtype, torch.float32)).contiguous()
    mine = torch.empty(parts[0].numel(), dtype=parts.dtype, device=g.device)
    dist.reduce_scatter_tensor(mine, parts.view(-1), group=mesh.seq_group)   # flat: gloo's
    return mine.view(parts.shape[1:]).to(g.dtype)


class _AllGatherSeq(torch.autograd.Function):
    """[S, *x.shape] from every seq rank; the backward sums each rank's
    cotangent of this rank's part (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather_parts(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.mesh), None


def _gather_frames(x: Tensor, dim: int) -> Tensor:
    ts = _SLICE
    parts = _AllGatherSeq.apply(x, ts.mesh)            # [S, ..., Tl, ...]
    shape = list(x.shape)
    shape[dim] *= ts.mesh.seq
    return parts.movedim(0, dim).reshape(shape)


def gather_time(x: Tensor) -> Tensor:
    """The region's output [B, Tl, ...] -> the whole clip [B, T, ...] on
    every seq rank (an all-gather on axis 1), into the replicated part of
    the model. Its backward is a reduce-scatter: the loss terms computed
    after it are weighted by 1/S in the backward (``replicated``), so the
    sum of the seq ranks' cotangents of this rank's frames is the whole
    cotangent. The identity where the batch is whole."""
    if _SLICE is None:
        return x
    return _gather_frames(x, 1)


def gather_kv(x: Tensor) -> Tensor:
    """Keys (or values) of this rank's frames [B, Tl, ...] -> every frame's
    [B, T, ...], for attention with local queries (an all-gather on axis
    1). Its backward is a reduce-scatter: every rank's queries read every
    key, so a key's cotangent is the sum of every rank's. Inside the
    ``region`` only; the identity elsewhere."""
    if active() is None:
        return x
    return _gather_frames(x, 1)


def halo(x: Tensor, left: int, right: int) -> Tensor:
    """[B, Tl, ...] -> [B, left + Tl + right, ...]: this rank's frames with
    the ``left`` frames before them and the ``right`` after, zero beyond
    the clip's ends (SAME padding), so a conv with no temporal padding over
    the result gives this rank's frames of the conv over the whole clip.
    One all-gather over the seq ranks of each rank's first ``min(right,
    Tl)`` and last ``min(left, Tl)`` frames (a halo wider than a slice
    takes whole slices of ranks further away); its backward adds the halo's
    cotangent back to the frames' owners (a reduce-scatter). Inside the
    ``region`` only."""
    ts = active()
    mesh, s, tl = ts.mesh, ts.mesh.seq_index, x.shape[1]
    lw, rw = min(left, tl), min(right, tl)
    edges = torch.cat((x[:, :rw], x[:, tl - lw:]), dim=1)
    parts = _AllGatherSeq.apply(edges, mesh)                  # [S, B, rw + lw, ...]
    zeros = x.new_zeros((x.shape[0], max(left, right)) + tuple(x.shape[2:]))
    before = torch.cat([zeros[:, :left]] + [parts[r][:, rw:] for r in range(s)], dim=1)
    after = torch.cat([parts[r][:, :rw] for r in range(s + 1, mesh.seq)]
                      + [zeros[:, :right]], dim=1)
    return torch.cat((before[:, before.shape[1] - left:], x, after[:, :right]), dim=1)


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def replicated(loss: Tensor) -> Tensor:
    """A loss term computed alike on every seq rank (after ``gather_time``,
    or on a whole batch): itself, with its gradient weighted by 1/S, so
    the step's sum over the seq ranks counts it once. The identity inside
    the ``region`` and on a mesh without a seq axis."""
    mesh = collectives.running()
    if mesh is None or mesh.seq == 1 or collectives.splitting() or not loss.requires_grad:
        return loss
    return _Replicated.apply(loss, 1.0 / mesh.seq)


def time_sum(x: Tensor, dims) -> Tensor:
    """``x`` summed over ``dims`` (axis 1, time, among them) and over the
    seq ranks' frames where the batch is split (one all-reduce, no
    gradient): a whole clip's sum."""
    s = x.sum(dim=dims, keepdim=True)
    if _SLICE is not None:
        dist.all_reduce(s, group=_SLICE.mesh.seq_group)
    return s

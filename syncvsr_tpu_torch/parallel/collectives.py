"""Collectives that give a data-parallel step the JAX package's global-batch
semantics.

Under the JAX package's one global ``jit`` every reduction in the step runs
over the whole batch sharded on ``data``. Here each process holds its rows
of that batch (rank r: global rows [r*b, (r+1)*b)), and the helpers below
stand in for the cross-shard reductions XLA inserts:

* ``global_mean(num, den)``: the mean over the global batch from a local
  numerator and denominator. One all-reduce of the pair; the value is
  ``sum num / sum den`` on every rank, the gradient that of
  ``num_local / sum den``, so summing the ranks' gradients (not averaging
  them, as DDP does) gives the gradient of the global mean.
  ``global_sum`` is the same without the division.
* ``reduce_sums``: an all-reduce of small per-channel sums without a
  gradient (K3's and K4's (sum x, sum x^2) and (sum g, sum g*xhat)) and
  ``all_reduce_grad``, an all-reduce whose backward all-reduces the
  cotangent (the plain ``FlaxBatchNorm``'s sums).
* ``global_flip`` and ``global_roll``: the batch reversed, and rolled by one
  row, over the global batch (CutMix's and mixup's partners), with
  ``all_to_all_single`` and ``all_gather_into_tensor``.

These reduce over the ranks that hold other rows or frames of the global
batch (``span``): the **data group**, and inside the time-split region of
a step whose batch is split over ``seq`` (``parallel/sequence.py``;
``time_split``) the data x seq ranks, each of which holds its frames of
its rows. The ranks of one model group hold the same rows and, after
every gather, the same activations, so a sum over them too would count
each row ``model`` times. The one exception is ``model=True``
(``reduce_sums``, ``global_mean``): the (sum, count) partials of a sync
head whose slots are split over the model ranks, which are summed over
the model ranks as well. ``global_flip`` and ``global_roll`` pair rows, so
they run over the data group only (a seq rank's partner holds the same
frames of another row).

The step makes its mesh the active one (``data_parallel``) for its forward
and backward; the ops ask ``span()`` or ``active()``. An op whose backward
reduces too keeps the span of its forward (a ``model.remat`` recompute
re-enters the region it ran in, ``models/layers.py::remat``). The marks
are process-wide, not per-thread: the autograd engine runs a CUDA
backward, and a recompute inside it, on a thread of its own. With no
active mesh (one process) every helper is the identity and issues no
collective, so the one-process step runs exactly the code it ran before.

Only collectives that gloo runs on CUDA tensors are used (all_reduce,
all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single), so two
processes that share one card can check the path; gloo's point-to-point
send/recv hands the device pointer to the socket and fails there.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

Tensor = torch.Tensor

_ACTIVE = None   # the Mesh whose step is running, or None
_SPLIT = False   # inside the time-split region of a step whose batch is split


def running():
    """The mesh whose step is running (any axis above one), or None."""
    return _ACTIVE


@contextlib.contextmanager
def data_parallel(mesh) -> Iterator[None]:
    """Make ``mesh`` the active one for a step's forward and backward (a
    mesh of one process is never made active)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, (mesh if mesh is not None and mesh.size > 1 else None)
    try:
        yield
    finally:
        _ACTIVE = prev


def splitting() -> bool:
    """Whether the running step is inside its time-split region (its batch
    split over a seq axis above one)."""
    return _SPLIT and _ACTIVE is not None and _ACTIVE.seq > 1


@contextlib.contextmanager
def time_split(on: bool = True) -> Iterator[None]:
    """Mark the time-split region (``parallel/sequence.py::region``), or,
    with ``on`` False, its absence (a ``model.remat`` recompute restores
    its forward's mark)."""
    global _SPLIT
    prev, _SPLIT = _SPLIT, bool(on)
    try:
        yield
    finally:
        _SPLIT = prev


@dataclass(frozen=True)
class Span:
    """The ranks a global-batch reduction sums over: their ``group`` (None:
    the default group) and count."""

    group: Any
    ranks: int


def span(model: bool = False) -> Optional[Span]:
    """The ranks holding other rows (and, inside the time-split region,
    other frames) of the running step's global batch, with ``model`` the
    model ranks too; None where that is this rank alone."""
    mesh = _ACTIVE
    if mesh is None:
        return None
    axes = ("data",) + (("seq",) if splitting() else ()) + (("model",) if model else ())
    n = mesh.axis_size(*axes)
    return None if n == 1 else Span(mesh.over(*axes), n)


def active():
    """The running mesh where the global-batch reductions span other ranks
    (``span``), or None."""
    return _ACTIVE if span() is not None else None


def shard() -> Tuple[int, int]:
    """(data index, data size) of the running mesh; (0, 1) with none: which
    rows of the global batch this rank holds."""
    mesh = _ACTIVE
    return (0, 1) if mesh is None else (mesh.data_index, mesh.data)


def reduces(model: bool = False) -> bool:
    """Whether ``reduce_sums(..., model=model)`` sums over other ranks."""
    return span(model) is not None


def reduce_sums(*ts: Tensor, model: bool = False, over: Optional[Span] = None
                ) -> List[Tensor]:
    """Each tensor summed over ``over`` (default: ``span(model)``), in one
    all-reduce of their f32 concatenation (no gradient); the tensors
    themselves where there is nothing to sum over."""
    over = over or span(model)
    if over is None:
        return list(ts)
    flat = torch.cat([t.detach().float().reshape(-1) for t in ts])
    dist.all_reduce(flat, group=over.group)
    out, i = [], 0
    for t in ts:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


def global_sum(t: Tensor) -> Tensor:
    """The sum of ``t`` over the global batch (``span``): its value on
    every rank, with the gradient of the local term."""
    if span() is None:
        return t
    (tot,) = reduce_sums(t)
    return tot + (t - t.detach()) if t.requires_grad else tot


def global_mean(num: Tensor, den: Union[Tensor, float],
                floor: Optional[float] = None, model: bool = False) -> Tensor:
    """``num / max(den, floor)`` with both summed over the global batch
    (``span(model)``; one all-reduce): the global mean on every rank, whose
    gradient is that of ``num_local / den_global``. With nothing to sum
    over, the local division."""
    over = span(model)
    if over is None:
        return num / (den if floor is None else torch.clamp(den, min=floor))
    if not isinstance(den, Tensor):
        den = torch.tensor(float(den), device=num.device)
    tot_num, tot_den = reduce_sums(num, den, over=over)
    if floor is not None:
        tot_den = torch.clamp(tot_den, min=floor)
    if num.requires_grad:
        tot_num = tot_num + (num - num.detach())
    return tot_num / tot_den


class _AllReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_grad(x: Tensor) -> Tensor:
    """``x`` summed over the global batch (``span``); its backward sums the
    cotangent over the same ranks (the gradient of a shared statistic)."""
    over = span()
    if over is None:
        return x
    return _AllReduceGrad.apply(x, over.group)


def _bytes(x: Tensor) -> Tensor:
    """A contiguous tensor as [rows, bytes] uint8 (gloo and NCCL move bytes
    of any dtype alike)."""
    return x.contiguous().reshape(x.shape[0], -1).view(torch.uint8)


def _from_bytes(b: Tensor, like: Tensor) -> Tensor:
    return b.view(like.dtype).reshape((b.shape[0],) + tuple(like.shape[1:]))


def global_flip(x: Tensor) -> Tensor:
    """``x`` flipped along the global batch: data index d's rows are index
    (D-1-d)'s, reversed. One ``all_to_all_single`` over the data group that
    sends the whole local batch to the partner (the middle rank of an odd
    mesh is its own)."""
    mesh = _ACTIVE
    if mesh is None or mesh.data == 1:
        return torch.flip(x, dims=(0,))
    partner = mesh.data - 1 - mesh.data_index
    src = _bytes(x)
    out = torch.empty_like(src)
    splits = [src.shape[0] if r == partner else 0 for r in range(mesh.data)]
    dist.all_to_all_single(out, src, output_split_sizes=splits, input_split_sizes=splits,
                           group=mesh.data_group)
    return torch.flip(_from_bytes(out, x), dims=(0,))


def global_roll(x: Tensor) -> Tensor:
    """``x`` rolled by one row along the global batch (``roll(x, 1, 0)`` of
    the whole): data index d's first row is index (d-1)'s last. One
    all-gather over the data group of every rank's last row."""
    mesh = _ACTIVE
    if mesh is None or mesh.data == 1:
        return torch.roll(x, 1, dims=0)
    last = _bytes(x[-1:])
    rows = torch.empty((mesh.data, last.shape[1]), dtype=torch.uint8, device=x.device)
    dist.all_gather_into_tensor(rows, last, group=mesh.data_group)
    prev = _from_bytes(rows[(mesh.data_index - 1) % mesh.data][None], x)
    return torch.cat((prev, x[:-1]), dim=0)

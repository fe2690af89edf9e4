"""Tensor parallel over the mesh's ``model`` axis (the port of the ``model``
part of ``syncvsr_tpu/parallel/mesh.py::state_shardings``).

The JAX package splits a leaf of rank >= 2 over ``model`` on its trailing
flax dim (a Dense's or a conv's output features, an embedding's width, a
depthwise conv's channels) and lets GSPMD insert the collectives. Here the
state holds each such leaf's part on its rank for good
(``parallel.mesh.TensorLayout``; the parameter carries ``tp_dim``) and the
layer that uses it runs column-parallel:

    input -> copy_to_model -> the layer's own op on its part of the weight
          -> gather_from_model (-> + the whole bias)

* ``copy_to_model``: the identity forward; the backward sums the input's
  gradient over the model group (each rank's is its columns' share);
* ``gather_from_model``: the forward all-gathers the ranks' columns on the
  feature dim; the backward takes this rank's slice of the gradient (which
  is the same on every rank of the group: everything after the gather is).

A bias is 1-D, so the rule leaves it whole: it is added after the gather.
(A head projection's [H, Dh] bias is split with its weight and added
before.) Leaves used as they are (the CLS token, the Conformer's
position biases) are gathered whole (``whole``). The sync head runs its
kernel on this rank's slots instead (``models/word.py::SyncHead``).

The ranks of a model group hold the same rows and, after every gather, the
same activations, so each draws the same dropout masks
(``mesh.seed_dropout`` seeds from the data index) and the replicated
leaves' gradients are alike on them. Only all_reduce and
all_gather_into_tensor are used (gloo runs both on CUDA tensors).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from syncvsr_tpu_torch.parallel import collectives

Tensor = torch.Tensor


def mesh():
    """The running step's mesh where its model axis has more than one rank,
    or None."""
    m = collectives.running()
    return m if m is not None and m.model > 1 else None


def split_dim(p: Tensor) -> Optional[int]:
    """The torch dim on which parameter ``p`` holds only this rank's part in
    the running step (``TensorLayout``), or None when it is whole."""
    if mesh() is None:
        return None
    return getattr(p, "tp_dim", None)


def index() -> Tuple[int, int]:
    """(model index, model size) of the running mesh; (0, 1) with none."""
    m = mesh()
    return (0, 1) if m is None else (m.model_index, m.model)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = g.float().contiguous()   # f32: the sum of the ranks' shares
        dist.all_reduce(total, group=ctx.group)
        return total.to(g.dtype), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, m):
        ctx.dim, ctx.index, ctx.width = dim, m.model_index, x.shape[dim]
        x = x.contiguous()
        flat = x.reshape(-1).view(torch.uint8)   # bytes: any dtype alike
        out = torch.empty(m.model * flat.numel(), dtype=torch.uint8, device=x.device)
        dist.all_gather_into_tensor(out, flat, group=m.model_group)
        parts = out.view(x.dtype).view((m.model,) + tuple(x.shape))
        shape = list(x.shape)
        shape[dim] *= m.model
        return parts.movedim(0, dim).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width).contiguous(), None, None


def copy_to_model(x: Tensor) -> Tensor:
    """``x`` as the input of a column-parallel op: itself, with its
    gradient summed over the model group. The identity without a model
    axis."""
    m = mesh()
    if m is None or not x.requires_grad:
        return x
    return _CopyToModel.apply(x, m.model_group)


def gather_from_model(y: Tensor, dim: int = -1, bias: Optional[Tensor] = None) -> Tensor:
    """The ranks' parts of ``y`` on ``dim`` concatenated in model order (one
    all-gather), plus ``bias`` (whole, on the last dim) where given; the
    backward keeps this rank's slice of the gradient."""
    m = mesh()
    if m is not None:
        y = _GatherFromModel.apply(y, dim % y.dim(), m)
    return y if bias is None else y + bias


def local(x: Tensor, dim: int = -1) -> Tensor:
    """This rank's part on ``dim`` of a tensor every rank holds whole (the
    channels of a depthwise conv's input), through ``copy_to_model``."""
    i, n = index()
    if n == 1:
        return x
    width = x.shape[dim] // n
    return copy_to_model(x).narrow(dim, i * width, width)


def whole(p: Tensor) -> Tensor:
    """Parameter ``p`` whole: gathered where this rank holds its part."""
    d = split_dim(p)
    return p if d is None else gather_from_model(p, d)

"""The process group as a mesh (port of ``syncvsr_tpu/parallel/mesh.py``).

The JAX package runs one process per host over a ``(data, seq, model)``
device mesh and lets XLA place a sharded batch and state. PyTorch's idiom
is one process per GPU: ``Mesh`` describes the ``torch.distributed`` group
(its size is the ``data`` axis, each rank one device) and the step issues
the collectives itself (``parallel/collectives.py``, ``engine/steps.py``).
Each process holds its rows of the global batch: rank r rows
[r*b, (r+1)*b), as ``jax.make_array_from_process_local_data`` lays
processes out along ``data``.

``mesh.fsdp`` (ZeRO over ``data``) keeps every parameter of at least
``fsdp_min_size`` elements, and both of its Adam moments, split over the
ranks on one dimension, chosen by the JAX package's rule on the flax
layout of the leaf (``state_shardings``); the step gathers the parameters
for its forward and backward and reduce-scatters their gradients
(``ShardedParams``). The ``model`` (tensor parallel) and ``seq`` (sequence
parallel) axes are not ported: sizes above 1 raise.

With no process group, the mesh has one process and every function here is
the identity: the step runs the one-process code, with no collective and no
added host read.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from syncvsr_tpu_torch.utils.bridge import flax_perm

Tensor = torch.Tensor


@dataclass(frozen=True)
class Mesh:
    """A data-parallel process group: ``size`` processes (the ``data``
    axis), this one ``rank``, on ``device``; ``group`` None is the default
    group."""

    size: int
    rank: int
    device: torch.device
    group: Any = None


def world() -> Tuple[int, int]:
    """(rank, size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def create_mesh(data: int = -1, model: int = 1, seq: int = 1,
                device: Optional[torch.device] = None) -> Mesh:
    """The mesh of the default process group (one process without one).
    ``data=-1`` takes every process; another size must equal the world's.
    ``device`` is this rank's (default: the current CUDA device)."""
    for name, size, what in (("model", model, "tensor parallel"),
                             ("seq", seq, "sequence parallel")):
        if size != 1:
            raise NotImplementedError(f"mesh.{name}={size} ({what}) is not ported to "
                                      "PyTorch yet")
    rank, n = world()
    if data == -1:
        data = n
    if data != n:
        raise ValueError(f"mesh {data}x{seq}x{model} != {n} processes")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(size=n, rank=rank, device=torch.device(device))


def host_local_batch(global_batch_size: int, mesh: Optional[Mesh] = None) -> int:
    """This process's rows of a global batch."""
    n = mesh.size if mesh is not None else world()[1]
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} does not split over {n} "
                         "processes")
    return global_batch_size // n


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Tensor]:
    """This rank's rows [r*b, (r+1)*b) of a global batch (numpy arrays or
    tensors), as tensors on its device. (The loaders give each process its
    rows already: the driver only moves them.)"""
    b = host_local_batch(len(next(iter(batch.values()))), mesh)
    rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    return {k: torch.as_tensor(v[rows]).to(mesh.device) for k, v in batch.items()}


def seed_dropout(state, mesh: Mesh) -> None:
    """Give rank r > 0 a dropout stream of its own, seeded from
    (``train.dropout_seed``, r, ``state.step``); rank 0 keeps the state's
    (the one-process stream, or the one a checkpoint restored). The ranks'
    dropout masks differ by design: the JAX package draws one mask over the
    global batch, which torch cannot reproduce (only dropout's apply part
    is held against JAX)."""
    if mesh.rank > 0:   # a 32-bit seed: the CPU generator reads no more
        seq = np.random.SeedSequence([state.seeds[1], mesh.rank, state.step])
        state.dropout_gen.manual_seed(int(seq.generate_state(1)[0]))


def leaf_spec(key: str, shape: Sequence[int], data: int, fsdp: bool,
              fsdp_min_size: int) -> Tuple[Optional[str], ...]:
    """The JAX package's ``state_shardings`` rule (its ``data`` part) for
    torch entry ``key``: a ``PartitionSpec`` tuple over the leaf's flax
    layout. Under ``fsdp`` a leaf of at least ``fsdp_min_size`` elements is
    split over ``data`` on its largest dimension divisible by it, ties to
    the earliest."""
    perm = flax_perm(key, len(shape))
    flax_shape = [shape[i] for i in perm]
    spec: List[Optional[str]] = [None] * len(shape)
    if fsdp and data > 1 and len(shape) >= 1 and int(np.prod(shape)) >= fsdp_min_size:
        free = [(d, i) for i, d in enumerate(flax_shape) if d % data == 0 and d >= data]
        if free:
            _, i = max(free, key=lambda t: (t[0], -t[1]))
            spec[i] = "data"
    return tuple(spec)


def state_shardings(mesh: Mesh, state, fsdp: bool = False,
                    fsdp_min_size: int = 2 ** 15) -> Dict[str, Tuple[Optional[str], ...]]:
    """Each parameter's spec (``leaf_spec``), by torch name; its Adam
    moments share it, as every JAX rule is shape-based. BatchNorm
    statistics stay replicated."""
    return {n: leaf_spec(n, tuple(p.shape), mesh.size, fsdp, fsdp_min_size)
            for n, p in zip(state.names, state.params)}


def _torch_dim(key: str, spec: Tuple[Optional[str], ...]) -> Optional[int]:
    if "data" not in spec:
        return None
    return flax_perm(key, len(spec))[spec.index("data")]


def _shard(t: Tensor, dim: int, mesh: Mesh) -> Tensor:
    """This rank's contiguous copy of ``t``'s equal part on ``dim``."""
    s = t.shape[dim] // mesh.size
    return t.narrow(dim, mesh.rank * s, s).clone(memory_format=torch.contiguous_format)


class ShardedParams:
    """Parameters split over the mesh on one torch dimension each (None:
    replicated). At rest each split parameter's ``.data`` is this rank's
    shard (``narrow(dim, rank * s, s)``), which the optimizer updates in
    place with its Adam moments of the same shape; ``gather`` swaps the
    whole tensors in for a forward and backward (one all-gather),
    ``reduce_gradients`` reduce-scatters their gradients (one
    reduce-scatter, plus one all-reduce of the replicated leaves'), and
    ``release`` swaps the shards back."""

    def __init__(self, mesh: Mesh, params: List[torch.nn.Parameter],
                 dims: List[Optional[int]]):
        self.mesh, self.params, self.dims = mesh, params, dims
        self.full_shapes = [tuple(p.shape) for p in params]
        self.split = [i for i, d in enumerate(dims) if d is not None]
        self.offsets, total = {}, 0
        self.shards: Dict[int, Tensor] = {}
        for i in self.split:
            self.shards[i] = _shard(params[i].data, dims[i], mesh)
            self.offsets[i] = total
            total += self.shards[i].numel()
        self.total = total
        self.release()

    def sharded(self, i: int) -> bool:
        return self.dims[i] is not None

    def _gather_flat(self, tensors: Dict[int, Tensor]) -> Dict[int, Tensor]:
        """Whole tensors from every rank's shards (one all-gather)."""
        w = self.mesh.size
        flat = torch.cat([tensors[i].reshape(-1) for i in self.split])
        out = torch.empty(w * self.total, dtype=flat.dtype, device=flat.device)
        dist.all_gather_into_tensor(out, flat, group=self.mesh.group)
        out = out.view(w, self.total)
        full = {}
        for i in self.split:
            d, shard = self.dims[i], tensors[i]
            n = shard.numel()
            parts = out[:, self.offsets[i]:self.offsets[i] + n].reshape(
                (w,) + tuple(shard.shape))
            full[i] = parts.movedim(0, d).reshape(self.full_shapes[i]).contiguous()
        return full

    def gather(self) -> None:
        """Each split parameter's whole tensor as its ``.data``."""
        for i, t in self._gather_flat(self.shards).items():
            self.params[i].data = t

    def release(self) -> None:
        """Each split parameter back to its shard."""
        for i in self.split:
            self.params[i].data = self.shards[i]

    def full(self, tensors: List[Tensor]) -> List[Tensor]:
        """A list laid out as the parameters at rest (Adam's moments) with
        every shard gathered into its whole tensor (a collective)."""
        whole = self._gather_flat({i: tensors[i] for i in self.split})
        return [whole.get(i, t) for i, t in enumerate(tensors)]

    def reduce_gradients(self, grads: List[Tensor]) -> List[Tensor]:
        """The whole-tensor gradients of this rank, summed over the mesh:
        this rank's shard for a split leaf (reduce-scatter), the whole sum
        for a replicated one (all-reduce)."""
        w, mesh = self.mesh.size, self.mesh
        out = list(grads)
        if self.split:
            buf = torch.empty((w, self.total), dtype=grads[self.split[0]].dtype,
                              device=grads[self.split[0]].device)
            for i in self.split:
                d, g = self.dims[i], grads[i]
                shard_shape = tuple(self.shards[i].shape)
                n = self.shards[i].numel()
                parts = g.reshape(shard_shape[:d] + (w,) + shard_shape[d:]).movedim(d, 0)
                buf[:, self.offsets[i]:self.offsets[i] + n] = parts.reshape(w, n)
            mine = torch.empty(self.total, dtype=buf.dtype, device=buf.device)
            dist.reduce_scatter_tensor(mine, buf.view(-1), group=mesh.group)
            for i in self.split:
                n = self.shards[i].numel()
                off = self.offsets[i]
                out[i] = mine[off:off + n].view(self.shards[i].shape)
        rest = [i for i in range(len(grads)) if not self.sharded(i)]
        out_rest = all_reduce_flat([grads[i] for i in rest], mesh)
        for i, g in zip(rest, out_rest):
            out[i] = g
        return out


def all_reduce_flat(tensors: List[Tensor], mesh: Mesh) -> List[Tensor]:
    """The tensors summed over the mesh, in one all-reduce of their
    concatenation (one bucket)."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


def resident_bytes(state) -> Dict[str, int]:
    """Bytes this rank holds at rest of the parameters and of Adam's two
    moments."""
    def size(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    return {"params": size(p.data for p in state.params),
            "moments": size(state.mu) + size(state.nu)}


def shard_state(mesh: Mesh, state, fsdp: bool = False, fsdp_min_size: int = 2 ** 15):
    """Place ``state`` by ``state_shardings``: under ``fsdp`` on a mesh of
    more than one process, split the parameters and their Adam moments
    (and the accumulated gradient) over the ranks, and print on rank 0, as
    the JAX package does, how many MiB of eligible leaves (parameters and
    moments) have no dimension divisible by the mesh and stay replicated.
    Otherwise the identity. Returns the state."""
    if not fsdp or mesh.size == 1:
        return state
    specs = state_shardings(mesh, state, fsdp, fsdp_min_size)
    dims = [_torch_dim(n, specs[n]) for n in state.names]
    if mesh.rank == 0:
        leftover = 3 * sum(p.numel() * p.element_size()
                           for p, d in zip(state.params, dims)
                           if d is None and p.numel() >= fsdp_min_size)
        if leftover >= 2 ** 20:
            print(f"[fsdp] {leftover / 2**20:.1f} MiB of >= {fsdp_min_size}-element "
                  "leaves have no data-divisible dim and stay REPLICATED on every "
                  "chip (per-chip memory unchanged for them); consider padding those "
                  f"dims to a multiple of data={mesh.size}")
    layout = ShardedParams(mesh, state.params, dims)

    def split(tensors):
        if tensors is None:
            return None
        return [t if d is None else _shard(t, d, mesh) for t, d in zip(tensors, dims)]

    state.mu, state.nu, state.acc = split(state.mu), split(state.nu), split(state.acc)
    state.fsdp = layout
    return state

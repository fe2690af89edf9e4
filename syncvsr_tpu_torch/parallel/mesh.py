"""The process group as a mesh (port of ``syncvsr_tpu/parallel/mesh.py``).

The JAX package runs one process per host over a ``(data, seq, model)``
device mesh and lets XLA place a sharded batch and state. PyTorch's idiom
is one process per GPU: ``Mesh`` describes the ``torch.distributed`` group
as a ``data`` x ``seq`` x ``model`` grid of ranks laid out as JAX's
``reshape(data, seq, model)`` (rank r at data index ``r // (seq*model)``,
seq index ``(r // model) % seq`` and model index ``r % model``), and the
step issues the collectives itself (``parallel/collectives.py``,
``parallel/sequence.py``, ``parallel/tensor.py``, ``engine/steps.py``).
Each data index holds its rows of the global batch (rows [d*b, (d+1)*b)),
as ``jax.make_array_from_process_local_data`` lays processes out along
``data``; the ranks of one data index hold the same rows. On a mesh with
``seq > 1`` the time axis (axis 1) of the ``videos``/``inputs`` leaves
whose length divides ``seq`` is split over the seq ranks too (JAX's
``batch_shardings``): seq index s holds frames [s*T/seq, (s+1)*T/seq);
an indivisible leaf (LRW's T = 29) stays whole and the seq ranks repeat
its rows.

``state_shardings`` is the JAX package's rule on the flax layout of each
leaf (``bridge.flax_perm``): on a mesh with ``model > 1`` a leaf of rank
>= 2 whose trailing flax dim is >= ``min_dim`` and divisible by ``model``
is split on it over the model ranks (tensor parallel: each rank then
computes its columns, ``parallel/tensor.py``); under ``mesh.fsdp`` (ZeRO
over ``data``) every leaf of at least ``fsdp_min_size`` elements is split
over the data ranks on its largest other divisible dimension, and its Adam
moments with it (``ShardedParams``: the step gathers the parameters for
its forward and backward and reduce-scatters their gradients). No leaf is
split over ``seq``: the seq ranks hold the same state, as the JAX rule
never names the axis.

With no process group, the mesh has one process and every function here is
the identity: the step runs the one-process code, with no collective and no
added host read.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from syncvsr_tpu_torch.utils.bridge import flax_perm

Tensor = torch.Tensor

AXES = ("data", "seq", "model")
# batch keys whose axis 1 is (video/waveform) time, candidates for the seq
# axis (the JAX package's ``_SEQ_KEYS``; ``audio_tokens``, T*alignment + 4
# long, is never split)
SEQ_KEYS = ("videos", "inputs")


@dataclass(frozen=True)
class Mesh:
    """A ``data`` x ``seq`` x ``model`` grid of ``size`` processes, this one
    ``rank``, on ``device``. ``group`` is every rank's (None: the default
    group); ``groups`` holds, by the axes it spans, the group of the ranks
    that share this one's indices on the other axes (``over``), made by
    every rank in the same order in ``create_mesh``."""

    size: int
    rank: int
    device: torch.device
    group: Any = None
    model: int = 1
    seq: int = 1
    groups: Dict[Tuple[str, ...], Any] = field(default_factory=dict, compare=False,
                                               hash=False, repr=False)

    @property
    def data(self) -> int:
        return self.size // (self.model * self.seq)

    @property
    def data_index(self) -> int:
        return self.rank // (self.seq * self.model)

    @property
    def seq_index(self) -> int:
        return (self.rank // self.model) % self.seq

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def axis_size(self, *axes: str) -> int:
        """The number of ranks that ``axes`` span."""
        sizes = {"data": self.data, "seq": self.seq, "model": self.model}
        return int(np.prod([sizes[a] for a in set(axes)]))

    def over(self, *axes: str):
        """The process group of the ranks that share this one's indices on
        every axis but ``axes`` (None: the default group, where they span
        the world)."""
        if self.axis_size(*axes) == self.size:
            return self.group
        return self.groups[tuple(a for a in AXES if a in axes)]

    @property
    def data_group(self):
        """The ranks of this one's (seq, model) indices: its data axis."""
        return self.over("data")

    @property
    def seq_group(self):
        """The ranks of this one's (data, model) indices, in seq order."""
        return self.over("seq")

    @property
    def model_group(self):
        """The ranks of this one's (data, seq) indices."""
        return self.over("model")


def world() -> Tuple[int, int]:
    """(rank, size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _coords(rank: int, seq: int, model: int) -> Dict[str, int]:
    return {"data": rank // (seq * model), "seq": (rank // model) % seq,
            "model": rank % model}


def create_mesh(data: int = -1, model: int = 1, seq: int = 1,
                device: Optional[torch.device] = None) -> Mesh:
    """The mesh of the default process group (one process without one):
    ``data`` x ``seq`` x ``model`` ranks, ``data=-1`` taking every process
    the other axes leave; the product must equal the world's size.
    ``device`` is this rank's (default: the current CUDA device). Where
    ``seq`` or ``model`` is above 1 every rank creates the group of every
    proper set of axes (``Mesh.over``), in the same order
    (``dist.new_group`` is collective)."""
    rank, n = world()
    if data == -1:
        data = max(n // max(model * seq, 1), 1)
    if model < 1 or seq < 1 or data * seq * model != n:
        raise ValueError(f"mesh {data}x{seq}x{model} != {n} processes")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    groups: Dict[Tuple[str, ...], Any] = {}
    if model > 1 or seq > 1:
        sizes = {"data": data, "seq": seq, "model": model}
        for axes in (("data",), ("seq",), ("model",), ("data", "seq"), ("data", "model"),
                     ("seq", "model")):
            if int(np.prod([sizes[a] for a in axes])) == n:
                continue   # the default group
            members: Dict[Tuple[int, ...], List[int]] = {}
            for r in range(n):
                c = _coords(r, seq, model)
                members.setdefault(tuple(c[a] for a in AXES if a not in axes), []).append(r)
            mine = tuple(c for a, c in _coords(rank, seq, model).items() if a not in axes)
            for key, ranks in members.items():
                g = dist.new_group(ranks)
                if key == mine:
                    groups[axes] = g
    return Mesh(size=n, rank=rank, device=torch.device(device), model=model, seq=seq,
                groups=groups)


def host_local_batch(global_batch_size: int, mesh: Optional[Mesh] = None) -> int:
    """This process's rows of a global batch (split over the data axis)."""
    n = mesh.data if mesh is not None else world()[1]
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} does not split over {n} "
                         "processes")
    return global_batch_size // n


class ShardedBatch(dict):
    """A rank's part of a global batch (a dict of tensors), with ``time``,
    the ``sequence.TimeSlice`` of its split time axis (None where nothing
    was split). The train and eval steps read ``time``; the model sees
    the dict."""

    time = None


def batch_shardings(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Tuple[str, ...]]:
    """The JAX package's ``batch_shardings`` rule, as each key's spec: the
    leading axis over ``data``; a time-like leaf (``SEQ_KEYS``) of rank
    >= 2 also splits axis 1 over ``seq`` where the mesh has one and the
    length divides it (an indivisible leaf falls back to data only)."""
    def spec(key, x):
        if (mesh.seq > 1 and key in SEQ_KEYS and getattr(x, "ndim", 0) >= 2
                and x.shape[1] % mesh.seq == 0):
            return ("data", "seq")
        return ("data",)

    return {k: spec(k, v) for k, v in batch.items()}


def split_time(mesh: Optional[Mesh], batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's time slice [s*T/seq, (s+1)*T/seq) of each seq-split leaf
    (``batch_shardings``) of a batch of its data index's rows (as the
    loaders give them), as a ``ShardedBatch`` whose ``time`` is that slice;
    the batch itself on a mesh without a seq axis or when it is a
    ``ShardedBatch`` already."""
    if mesh is None or mesh.seq == 1 or isinstance(batch, ShardedBatch):
        return batch
    from syncvsr_tpu_torch.parallel.sequence import TimeSlice

    specs = batch_shardings(mesh, batch)
    split = {k for k, sp in specs.items() if "seq" in sp}
    totals = {batch[k].shape[1] for k in split}
    if len(totals) > 1:
        raise ValueError(f"time-split leaves of unequal lengths: "
                         f"{ {k: batch[k].shape[1] for k in split} }")
    out = ShardedBatch()
    time = None
    if totals:
        total = totals.pop()
        length = total // mesh.seq
        time = TimeSlice(mesh, mesh.seq_index * length, length, total)
    for k, v in batch.items():
        v = torch.as_tensor(v)
        out[k] = v.narrow(1, time.start, time.length).contiguous() if k in split else v
    out.time = time
    return out


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Tensor]:
    """This rank's part of a global batch (numpy arrays or tensors), as
    tensors on its device: rows [d*b, (d+1)*b) (d its data index), then on
    a mesh with a seq axis the time slice of each seq-split leaf
    (``split_time``: a ``ShardedBatch``). (The loaders give each process
    its rows already: the driver moves them and the step splits time.)"""
    b = host_local_batch(len(next(iter(batch.values()))), mesh)
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    out = {k: torch.as_tensor(v[rows]).to(mesh.device) for k, v in batch.items()}
    return split_time(mesh, out)


def seed_dropout(state, mesh: Mesh) -> None:
    """Give data index d > 0 a dropout stream of its own, seeded from
    (``train.dropout_seed``, d, ``state.step``); index 0 keeps the state's
    (the one-process stream, or the one a checkpoint restored). The ranks
    of one data index draw alike: a model group's activations are the same
    rows, whole after each gather, and the seq ranks draw each mask at the
    whole clip's shape and keep their frames (``layers.dropout``). The data ranks' dropout masks differ by
    design: the JAX package draws one mask over the global batch, which
    torch cannot reproduce (only dropout's apply part is held against
    JAX)."""
    if mesh.data_index > 0:   # a 32-bit seed: the CPU generator reads no more
        seq = np.random.SeedSequence([state.seeds[1], mesh.data_index, state.step])
        state.dropout_gen.manual_seed(int(seq.generate_state(1)[0]))


def leaf_spec(key: str, shape: Sequence[int], data: int, fsdp: bool,
              fsdp_min_size: int, model: int = 1,
              min_dim: int = 512) -> Tuple[Optional[str], ...]:
    """The JAX package's ``state_shardings`` rule for torch entry ``key``
    of whole ``shape``: a ``PartitionSpec`` tuple over the leaf's flax
    layout. With ``model > 1`` a leaf of rank >= 2 whose trailing flax dim
    is >= ``min_dim`` and divisible by ``model`` is split on it over
    ``model``; under ``fsdp`` a leaf of at least ``fsdp_min_size`` elements
    is split over ``data`` on its largest other dimension divisible by it,
    ties to the earliest."""
    perm = flax_perm(key, len(shape))
    flax_shape = [shape[i] for i in perm]
    spec: List[Optional[str]] = [None] * len(shape)
    if (model > 1 and len(shape) >= 2 and flax_shape[-1] >= min_dim
            and flax_shape[-1] % model == 0):
        spec[-1] = "model"
    if fsdp and data > 1 and len(shape) >= 1 and int(np.prod(shape)) >= fsdp_min_size:
        free = [(d, i) for i, d in enumerate(flax_shape)
                if spec[i] is None and d % data == 0 and d >= data]
        if free:
            _, i = max(free, key=lambda t: (t[0], -t[1]))
            spec[i] = "data"
    return tuple(spec)


def state_shardings(mesh: Mesh, state, fsdp: bool = False, fsdp_min_size: int = 2 ** 15,
                    min_dim: int = 512) -> Dict[str, Tuple[Optional[str], ...]]:
    """Each parameter's spec (``leaf_spec``) by torch name, from the
    state's whole shapes (take it before ``shard_state``); its Adam moments
    share it, as every JAX rule is shape-based. BatchNorm statistics stay
    replicated."""
    return {n: leaf_spec(n, tuple(p.shape), mesh.data, fsdp, fsdp_min_size, mesh.model,
                         min_dim)
            for n, p in zip(state.names, state.params)}


def _torch_dim(key: str, spec: Tuple[Optional[str], ...], axis: str) -> Optional[int]:
    if axis not in spec:
        return None
    return flax_perm(key, len(spec))[spec.index(axis)]


def _shard(t: Tensor, dim: int, index: int, parts: int) -> Tensor:
    """A contiguous copy of part ``index`` of ``t``'s ``parts`` equal parts
    on ``dim``."""
    s = t.shape[dim] // parts
    return t.narrow(dim, index * s, s).clone(memory_format=torch.contiguous_format)


def _split(tensors: Optional[List[Tensor]], dims: List[Optional[int]], index: int,
           parts: int) -> Optional[List[Tensor]]:
    """Part ``index`` of each tensor of a list laid out as the parameters
    (Adam's moments, the accumulated gradient), whole where its dim is
    None."""
    if tensors is None:
        return None
    return [t if d is None else _shard(t, d, index, parts) for t, d in zip(tensors, dims)]


def _gather(shards: Dict[int, Tensor], dims: List[Optional[int]], parts: int,
            group) -> Dict[int, Tensor]:
    """Whole tensors from every rank's shards (``shards``: index -> this
    rank's part on ``dims[index]``), in one all-gather over ``group`` of
    their flat concatenation."""
    order = sorted(shards)
    flat = torch.cat([shards[i].reshape(-1) for i in order])
    out = torch.empty(parts * flat.numel(), dtype=flat.dtype, device=flat.device)
    dist.all_gather_into_tensor(out, flat, group=group)
    out = out.view(parts, flat.numel())
    full, off = {}, 0
    for i in order:
        d, shard = dims[i], shards[i]
        n = shard.numel()
        whole = list(shard.shape)
        whole[d] *= parts
        chunk = out[:, off:off + n].reshape((parts,) + tuple(shard.shape))
        full[i] = chunk.movedim(0, d).reshape(whole).contiguous()
        off += n
    return full


class ShardedParams:
    """Parameters split over the mesh's data axis on one torch dimension
    each (None: replicated), FSDP's layout. At rest each split parameter's
    ``.data`` is this rank's shard (``narrow(dim, data_index * s, s)`` of
    the tensor it holds whole over ``data``: under tensor parallel its
    model shard), which the optimizer updates in place with its Adam
    moments of the same shape; ``gather`` swaps those tensors in for a
    forward and backward (one all-gather over the data group),
    ``reduce_gradients`` reduce-scatters their gradients (one
    reduce-scatter, plus one all-reduce of the replicated leaves'), and
    ``release`` swaps the shards back."""

    def __init__(self, mesh: Mesh, params: List[torch.nn.Parameter],
                 dims: List[Optional[int]]):
        self.mesh, self.params, self.dims = mesh, params, dims
        self.full_shapes = [tuple(p.shape) for p in params]
        self.split = [i for i, d in enumerate(dims) if d is not None]
        self.shards: Dict[int, Tensor] = {
            i: _shard(params[i].data, dims[i], mesh.data_index, mesh.data)
            for i in self.split}
        self.release()

    def sharded(self, i: int) -> bool:
        return self.dims[i] is not None

    def gather(self) -> None:
        """Each split parameter's whole tensor as its ``.data``."""
        if self.split:
            for i, t in _gather(self.shards, self.dims, self.mesh.data,
                                self.mesh.data_group).items():
                self.params[i].data = t

    def release(self) -> None:
        """Each split parameter back to its shard."""
        for i in self.split:
            self.params[i].data = self.shards[i]

    def full(self, tensors: List[Tensor]) -> List[Tensor]:
        """A list laid out as the parameters at rest (Adam's moments) with
        every shard gathered into its whole tensor (a collective)."""
        if not self.split:
            return list(tensors)
        whole = _gather({i: tensors[i] for i in self.split}, self.dims, self.mesh.data,
                        self.mesh.data_group)
        return [whole.get(i, t) for i, t in enumerate(tensors)]

    def reduce_gradients(self, grads: List[Tensor]) -> List[Tensor]:
        """The whole-tensor gradients of this rank, summed over the data
        group: this rank's shard for a split leaf (reduce-scatter), the
        whole sum for a replicated one (all-reduce)."""
        w, mesh = self.mesh.data, self.mesh
        out = list(grads)
        if self.split:
            total = sum(self.shards[i].numel() for i in self.split)
            buf = torch.empty((w, total), dtype=grads[self.split[0]].dtype,
                              device=grads[self.split[0]].device)
            off = 0
            for i in self.split:
                d, g = self.dims[i], grads[i]
                shard_shape = tuple(self.shards[i].shape)
                n = self.shards[i].numel()
                parts = g.reshape(shard_shape[:d] + (w,) + shard_shape[d:]).movedim(d, 0)
                buf[:, off:off + n] = parts.reshape(w, n)
                off += n
            mine = torch.empty(total, dtype=buf.dtype, device=buf.device)
            dist.reduce_scatter_tensor(mine, buf.view(-1), group=mesh.data_group)
            off = 0
            for i in self.split:
                n = self.shards[i].numel()
                out[i] = mine[off:off + n].view(self.shards[i].shape)
                off += n
        rest = [i for i in range(len(grads)) if not self.sharded(i)]
        out_rest = all_reduce_flat([grads[i] for i in rest], mesh.data_group)
        for i, g in zip(rest, out_rest):
            out[i] = g
        return out


class TensorLayout:
    """Parameters split over the mesh's model axis on one torch dimension
    each (None: replicated), tensor parallel's layout. Each split
    parameter's ``.data`` is this rank's part for good (``narrow(dim,
    model_index * s, s)``) and the parameter carries ``tp_dim``, the dim
    ``parallel/tensor.py`` reads: the layers compute with it column-parallel
    in a step whose mesh is active. ``full`` gathers tensors laid out as
    the parameters (checkpoints)."""

    def __init__(self, mesh: Mesh, params: List[torch.nn.Parameter],
                 dims: List[Optional[int]]):
        self.mesh, self.dims = mesh, dims
        for p, d in zip(params, dims):
            if d is not None:
                p.data = _shard(p.data, d, mesh.model_index, mesh.model)
                p.tp_dim = d

    def sharded(self, i: int) -> bool:
        return self.dims[i] is not None

    def full(self, tensors: List[Tensor]) -> List[Tensor]:
        """``tensors`` (laid out as the parameters) with every part gathered
        into its whole tensor (a collective over the model group)."""
        split = {i: t for i, t in enumerate(tensors) if self.sharded(i)}
        if not split:
            return list(tensors)
        whole = _gather(split, self.dims, self.mesh.model, self.mesh.model_group)
        return [whole.get(i, t) for i, t in enumerate(tensors)]


def all_reduce_flat(tensors: List[Tensor], group=None) -> List[Tensor]:
    """The tensors summed over ``group`` (None: every rank), in one
    all-reduce of their concatenation (one bucket)."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
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


def shard_state(mesh: Mesh, state, fsdp: bool = False, fsdp_min_size: int = 2 ** 15,
                min_dim: int = 512):
    """Place ``state`` by ``state_shardings``: on a mesh with ``model > 1``
    split the parameters of the model rule, their Adam moments and the
    accumulated gradient over the model ranks (``TensorLayout``,
    ``state.tp``); under ``fsdp`` on a mesh of more than one data rank, then
    split the leaves of the data rule over the data ranks (``ShardedParams``,
    ``state.fsdp``), and print on rank 0, as the JAX package does, how many
    MiB of eligible leaves (parameters and moments) have no dimension
    divisible by the data axis and stay replicated over it. Otherwise the
    identity. Returns the state."""
    tp, zero = mesh.model > 1, fsdp and mesh.data > 1
    if not (tp or zero):
        return state
    specs = state_shardings(mesh, state, fsdp, fsdp_min_size, min_dim)
    if zero and mesh.rank == 0:
        leftover = 3 * sum(p.numel() * p.element_size()
                           for n, p in zip(state.names, state.params)
                           if "data" not in specs[n] and p.numel() >= fsdp_min_size)
        if leftover >= 2 ** 20:
            print(f"[fsdp] {leftover / 2**20:.1f} MiB of >= {fsdp_min_size}-element "
                  "leaves have no data-divisible dim and stay REPLICATED on every "
                  "chip (per-chip memory unchanged for them); consider padding those "
                  f"dims to a multiple of data={mesh.data}")
    if tp:
        layout = TensorLayout(mesh, state.params,
                              [_torch_dim(n, specs[n], "model") for n in state.names])
        state.mu, state.nu, state.acc = (
            _split(t, layout.dims, mesh.model_index, mesh.model)
            for t in (state.mu, state.nu, state.acc))
        state.tp = layout
    if zero:
        dims = [_torch_dim(n, specs[n], "data") for n in state.names]
        state.fsdp = ShardedParams(mesh, state.params, dims)
        state.mu, state.nu, state.acc = (_split(t, dims, mesh.data_index, mesh.data)
                                         for t in (state.mu, state.nu, state.acc))
    return state

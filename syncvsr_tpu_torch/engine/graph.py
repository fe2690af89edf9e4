"""The train step replayed as one CUDA graph (``torch.cuda.CUDAGraph``).

A fixed-shape train step launches thousands of kernels; launched one by
one from Python, the host sets the step's pace. ``GraphedStep`` captures
the step's device work once per input signature (the batch's keys,
shapes, dtypes and devices) and replays it:

* the host draws first, as the eager step does (``engine/steps.py``: the
  augmentation's crop boxes, flips and time masks, then CutMix's keep mask
  or mixup's weight), and hands the draws, with the update's learning rate
  and Adam's bias corrections (``state.update_scalars``), to the device in
  one copy of one pinned buffer;
* the batch is copied into the graph's static inputs;
* one replay runs the eager step's device work (its ``run``: the
  augmentation's apply, the forward, the backward, the gradients'
  collection, ``grad_norm``, then the clipped AdamW with those scalars as
  tensors, and the BatchNorm running statistics), the hand-written
  kernels among them; the dropout generator is registered with the graph,
  so N replays draw the masks of N eager steps;
* the metrics are copied out of the graph's output, so the next replay
  does not overwrite the ones a caller still holds; the host advances
  ``state.step``, ``count`` and ``lr`` as the eager update does.

A signature's first step runs the same device work eagerly on a side
stream (the warm-up; a step that reads a device value on the host there,
by ``utils/profiling.py::host_read`` or by a synchronizing CUDA call,
keeps its signature eager), its second captures and replays. A step runs
the eager step (``engine/steps.py``) instead where it cannot be replayed,
for the first of these reasons (``REASONS``; counted by
``utils/profiling.py::graph_counts``): its batch is not on a CUDA device;
it runs over a mesh of several processes or a split state; it accumulates
gradients or skips non-finite updates (both read the host); the model
recomputes with ``model.remat`` (which reads and sets the dropout
generator's state); a ``spans()`` block is open (it times the eager step's
phases), or a profiler window (``utils/profiling.py::Trace``) is open and
the signature has no graph yet (a signature with one replays there); its
signature read the host in its warm-up; or ``MAX_GRAPHS`` signatures hold
graphs already. A graph belongs to the train state it was captured with,
whose tensors it updates in place.
"""

from __future__ import annotations

import math
import warnings
import weakref
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from syncvsr_tpu_torch.engine.state import TrainState, adamw_apply, update_scalars
from syncvsr_tpu_torch.ops import kernel_wrappers, launch_counts
from syncvsr_tpu_torch.utils import kernels
from syncvsr_tpu_torch.utils.profiling import graph_step, host_read_counts, spans_on, step_spans

Tensor = torch.Tensor

MAX_GRAPHS = 4    # signatures a step keeps graphs of; later ones stay eager
REASONS = ("device", "mesh", "accum", "skip_nonfinite", "remat", "spans", "host_read", "cap",
           "warmup")
GROUPS = ("aug", "mix", "opt")   # the drawn values' groups, in the order drawn
Layout = Tuple[Tuple[str, str, Tuple[int, ...], torch.dtype], ...]


def _flatten(drawn: Dict[str, Optional[Dict[str, Tensor]]]) -> List[Tuple[str, str, Tensor]]:
    return [(g, k, v) for g in GROUPS if drawn[g] is not None for k, v in drawn[g].items()]


def _layout(drawn: Dict[str, Optional[Dict[str, Tensor]]]) -> Layout:
    """The (group, name, shape, dtype) of each drawn value; f32 and bool
    values only, as one f32 buffer carries them."""
    out = []
    for g, k, v in _flatten(drawn):
        if v.dtype not in (torch.float32, torch.bool):
            raise TypeError(f"drawn value {g}.{k} is {v.dtype}; f32 or bool expected")
        out.append((g, k, tuple(v.shape), v.dtype))
    return tuple(out)


def _pack(drawn: Dict[str, Optional[Dict[str, Tensor]]], out: Tensor) -> None:
    """The drawn values into the f32 buffer ``out``, in ``_layout``'s order."""
    off = 0
    for _, _, v in _flatten(drawn):
        n = v.numel()
        out[off:off + n].copy_(v.reshape(-1))
        off += n


def _unpack(buf: Tensor, layout: Layout) -> Dict[str, Optional[Dict[str, Tensor]]]:
    """The drawn values as views of ``buf`` (bool ones compared to 0), by
    group; None for a group that drew nothing."""
    out: Dict[str, Optional[Dict[str, Tensor]]] = dict.fromkeys(GROUPS)
    off = 0
    for g, k, shape, dtype in layout:
        n = math.prod(shape)
        v = buf[off:off + n].view(shape)
        out[g] = dict(out[g] or {}, **{k: v != 0 if dtype == torch.bool else v})
        off += n
    return out


class _Signature:
    """One signature's static inputs and draws, its pinned host buffers
    (two, taken in turn, each reused once its last copy has run) and, once
    captured, its replay."""

    def __init__(self, state: TrainState, batch: Dict[str, Tensor], layout: Layout,
                 pinned: bool):
        self.owner = weakref.ref(state)
        self.batch = {k: torch.empty_like(v) for k, v in batch.items()}
        self.layout = layout
        n = sum(math.prod(s) for _, _, s, _ in layout)
        device = next(iter(batch.values())).device
        self.draws = torch.empty(n, dtype=torch.float32, device=device)
        self.host = [torch.empty(n, dtype=torch.float32, pin_memory=pinned) for _ in range(2)]
        self.copied = [torch.cuda.Event() for _ in range(2)] if pinned else None
        self.turn = 0
        self.keys: List[Tuple[str, Tuple[int, ...], torch.dtype]] = []
        self.replay: Optional[Callable[[], Tensor]] = None

    def load(self, batch: Dict[str, Tensor], drawn: Dict[str, Optional[Dict[str, Tensor]]]
             ) -> None:
        for k, v in batch.items():
            self.batch[k].copy_(v)
        i, self.turn = self.turn, 1 - self.turn
        if self.copied is not None:
            self.copied[i].synchronize()
        _pack(drawn, self.host[i])
        self.draws.copy_(self.host[i], non_blocking=True)
        if self.copied is not None:
            self.copied[i].record()


class _Replay:
    """A captured graph, its output and what it must keep alive (the
    kernels' buffers it captured, ``kernels.retained``). Each replay
    counts the hand-written kernels' launches the capture made, which the
    capture itself does not count (``ops.launch_counts``)."""

    def __init__(self, graph, out: Tensor, held: List[Tensor], launched: Dict[str, int]):
        self.graph, self.out, self.held = graph, out, held
        self.wrappers = kernel_wrappers()
        self.launched = {k: n for k, n in launched.items() if n}
        for k, n in self.launched.items():
            self.wrappers[k].launches -= n

    def __call__(self) -> Tensor:
        self.graph.replay()
        for k, n in self.launched.items():
            self.wrappers[k].launches += n
        return self.out


class CudaGraphs:
    """Warm-up and capture on one side stream; the graphs share one memory
    pool (they replay one at a time, and what each keeps stays allocated)."""

    device_type = "cuda"

    def __init__(self):
        self.stream = None
        self.pool = None

    @contextmanager
    def side(self) -> Iterator[List[Any]]:
        """The block on the side stream; the list it gives holds, once the
        block has closed, the synchronizing CUDA calls the block made
        (PyTorch's sync debug mode); the block's other warnings are
        passed on."""
        if self.stream is None:
            self.stream = torch.cuda.Stream()
        main = torch.cuda.current_stream()
        self.stream.wait_stream(main)
        found: List[Any] = []
        mode = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with torch.cuda.stream(self.stream):
                    yield found
            finally:
                torch.cuda.set_sync_debug_mode(mode)
                main.wait_stream(self.stream)
        for w in seen:
            text = str(w.message)
            if "debug mode" in text:         # the mode's own notice
                continue
            if "synchronizing" in text:
                found.append(w)
            else:
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)

    def record(self, body: Callable[[], Tensor], generators: List[torch.Generator]
               ) -> _Replay:
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        before = launch_counts()
        with kernels.retained() as held, torch.cuda.graph(graph, pool=self.pool,
                                                          stream=self.stream):
            out = body()
        if self.pool is None:
            self.pool = graph.pool()
        return _Replay(graph, out, held,
                       {k: n - before[k] for k, n in launch_counts().items()})


class EagerReplays:
    """The CUDA graphs' stand-in on the CPU: each replay runs the recorded
    step eagerly and writes its output into the first replay's, as a graph
    writes its static output, so the graph path's draws, buffers and
    outputs run without a card."""

    device_type = "cpu"

    @contextmanager
    def side(self) -> Iterator[List[Any]]:
        yield []

    def record(self, body: Callable[[], Tensor], generators: List[torch.Generator]
               ) -> Callable[[], Tensor]:
        static: List[Tensor] = []

        def replay() -> Tensor:
            out = body()
            if static:
                return static[0].copy_(out)
            static.append(out)
            return out

        return replay


class GraphedStep:
    """``train_step(state, batch) -> (state, metrics)``: ``eager`` where the
    step cannot be replayed, else the graph path above, made of the eager
    step's parts: ``draw(state, batch)``, its host draws, and ``run(state,
    batch, drawn, update)``, its device work (``engine/steps.py``).
    ``graphs`` and ``cap`` may be replaced (``EagerReplays`` on the CPU)."""

    def __init__(self, eager: Callable, draw: Callable, run: Callable, mesh=None):
        self.eager, self.draw, self.run, self.mesh = eager, draw, run, mesh
        self.graphs = CudaGraphs()
        self.cap = MAX_GRAPHS
        self.signatures: Dict[Tuple, _Signature] = {}
        self.reading: set = set()     # signatures whose warm-up read the host

    def reason(self, state: TrainState, batch: Dict[str, Any]) -> Optional[str]:
        """Why the step cannot be replayed whatever its signature, or None."""
        if not all(isinstance(v, Tensor) and v.device.type == self.graphs.device_type
                   for v in batch.values()):
            return "device"
        if ((self.mesh is not None and self.mesh.size > 1) or state.fsdp is not None
                or state.tp is not None):
            return "mesh"
        if state.optim.accum_steps > 1:
            return "accum"
        if state.optim.skip_nonfinite:
            return "skip_nonfinite"
        if state.model.cfg.remat:
            return "remat"
        if step_spans():
            return "spans"
        return None

    def __call__(self, state: TrainState, batch: Dict[str, Any]):
        reads = sum(host_read_counts().values())
        reason = self.reason(state, batch)
        if reason is None:
            sig = tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in sorted(batch.items()))
            entry = self.signatures.get(sig)
            if entry is not None and entry.owner() is not state:
                del self.signatures[sig]   # its graph updates another state's tensors
                entry = None
            if sig in self.reading:
                reason = "host_read"
            elif entry is None and len(self.signatures) >= self.cap:
                reason = "cap"
            elif spans_on() and (entry is None or entry.replay is None):
                reason = "spans"     # a profiler window: no warm-up or capture in it
        if reason is not None:
            graph_step("eager." + reason)
            return self.eager(state, batch)

        drawn = self.draw(state, batch)
        lr, count, bc1, bc2 = update_scalars(state)
        drawn["opt"] = {"scalars": torch.tensor([lr, bc1, bc2], dtype=torch.float32)}
        if entry is None:
            entry = _Signature(state, batch, _layout(drawn),
                               pinned=self.graphs.device_type == "cuda")
            with self.graphs.side() as synced:
                entry.load(batch, drawn)
                flat = self._device_step(state, entry)
            read = bool(synced) or sum(host_read_counts().values()) > reads
            if read:
                self.reading.add(sig)
            else:
                self.signatures[sig] = entry
            graph_step("eager.host_read" if read else "eager.warmup")
        else:
            entry.load(batch, drawn)
            if entry.replay is None:
                entry.replay = self.graphs.record(lambda: self._device_step(state, entry),
                                                  [state.dropout_gen])
                graph_step("capture")
            else:
                graph_step("replay")
            flat = entry.replay().clone()
        state.step += 1
        state.count, state.lr = count, lr
        return state, self._metrics(entry.keys, flat, lr)

    def _device_step(self, state: TrainState, entry: _Signature) -> Tensor:
        """The eager step's device work on ``entry``'s inputs and draws; its
        metrics (the model's, then ``grad_norm``) as one flat f32 tensor."""
        drawn = _unpack(entry.draws, entry.layout)
        lr, bc1, bc2 = drawn["opt"]["scalars"]
        out, norm, _ = self.run(state, entry.batch, drawn,
                                lambda grads: adamw_apply(state, grads, lr, bc1, bc2))
        values = dict(out, grad_norm=norm)
        entry.keys = [(k, tuple(v.shape), v.dtype) for k, v in values.items()]
        return torch.cat([v.detach().float().reshape(-1) for v in values.values()])

    @staticmethod
    def _metrics(keys, flat: Tensor, lr: float) -> Dict[str, Tensor]:
        """The eager step's metrics from ``flat``: the model's, then
        ``learning_rate`` (made on the host) and ``grad_norm``."""
        metrics, off = {}, 0
        for k, shape, dtype in keys:
            n = math.prod(shape)
            metrics[k] = flat[off:off + n].view(shape).to(dtype)
            off += n
        norm = metrics.pop("grad_norm")
        metrics["learning_rate"] = torch.tensor(lr, dtype=torch.float32)
        metrics["grad_norm"] = norm
        return metrics

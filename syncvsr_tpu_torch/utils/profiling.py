"""Per-step timing and profiler windows (port of
``syncvsr_tpu/utils/profiling.py``).

``StepTimer`` times each step with an EMA over the steps after a warm-up,
as the JAX copy does: on the GPU with CUDA events recorded at the start and
the end of the step, read one step later (so the timer adds no host wait:
the train loop still reads a step's metrics only after it has enqueued the
next), on the CPU with the host clock. ``Trace`` is a ``torch.profiler``
window (CPU and CUDA activities) that writes a Chrome trace, with the
spans on.

Spans and counters inside the train step. ``span(name)`` marks a layer
boundary of the step by one of the names of ``SPANS``. Off (the default)
it returns one shared no-op context after a single flag read; on (inside
``spans()``, or a ``Trace`` window) it records ``(name, thread id,
start ns, end ns)`` on ``CLOCK``, the clock ``torch.profiler``'s events
are on, and while a profiler runs it also enters
``torch.profiler.record_function(name)``, so the span shows in the
Chrome trace and among the profiler's events. Backward spans run on the
autograd engine's thread; the thread id tells them apart.
``host_read(site)`` counts the host's reads of device values (``float``,
``.item()``, ``bool``, ``.cpu()`` of a tensor) by site, whether spans are
on or not; ``host_read_counts()`` returns the counts so far.
``graph_step(kind)`` counts train steps by how they ran
(``engine/graph.py``: captured and replayed as a CUDA graph, replayed, or
eager and why); ``graph_counts()`` returns the counts so far.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

# every span of the port, and what reads it: the train loop's log
# (``train.loader_wait``), and the device ms and idle ms a step that the
# benchmark's traced runs put down to each span
SPANS = (
    "train.to_device",        # a batch's host-to-device copies
    "train.host_metrics",     # the lagged read of a step's metrics
    "train.loader_wait",      # the loader's next batch (train/loader_wait_ms)
    "step.forward",           # augmentation and the model call
    "step.backward",          # loss.backward()
    "step.update",            # gradients' collection, grad_norm, apply_gradients
    "step.augment",           # aug_fn
    "model.frontend",         # the frontend (and its projection)
    "model.encoder",          # the word or sentence encoder
    "model.decoder",          # the attention decoder
    "kernel.sync_ce",         # sync head projection + CE forward (K1, K2 or plain)
    "kernel.sync_ce.bwd",     # its backward
    "kernel.bn_stats",        # BatchNorm statistics in the forward (K3 or plain)
    "kernel.bn_stats.bwd",    # BatchNorm statistics in the backward (K4 or plain)
)

# kineto's host events carry wall-clock ns (a record_function's start lies
# a fraction of a millisecond after time.time_ns() taken just before it),
# so spans do too
CLOCK = time.time_ns
SPAN_LIMIT = 1 << 20   # records held at once; later ones are dropped

SpanRecord = Tuple[str, int, int, int]


class _NoSpan:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()
_on = False
_step_spans = False   # a ``spans()`` block keeps the train steps eager
_records: List[SpanRecord] = []
_host_reads: Dict[str, int] = {}
_graph_steps: Dict[str, int] = {}


class _Span:
    __slots__ = ("name", "start", "mirror")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        self.mirror = None
        if torch.autograd.profiler._is_profiler_enabled:
            self.mirror = torch.profiler.record_function(self.name)
            self.mirror.__enter__()
        self.start = CLOCK()

    def __exit__(self, *exc) -> bool:
        end = CLOCK()
        if self.mirror is not None:
            self.mirror.__exit__(*exc)
        if len(_records) < SPAN_LIMIT:
            _records.append((self.name, threading.get_ident(), self.start, end))
        return False


def spans_on() -> bool:
    """Whether the spans are on."""
    return _on


def step_spans() -> bool:
    """Whether a ``spans()`` block that times the train steps' phases is
    open (``engine/graph.py`` then runs every step eagerly)."""
    return _step_spans


def span(name: str):
    """The context of the span ``name`` (one of ``SPANS``): the shared
    no-op while spans are off."""
    if not _on:
        return _NO_SPAN
    return _Span(name)


@contextmanager
def spans(steps: bool = True) -> Iterator[List[SpanRecord]]:
    """Turns the spans on; the list it gives holds, once the block has
    closed, every span that ended inside it, in order of their start.
    ``steps``: the train steps inside run eagerly, so their phases and
    modules have spans; without it (a ``Trace`` window) a step whose
    signature has a CUDA graph replays, as outside the block, and only the
    train loop's spans and the eager steps' are recorded
    (``engine/graph.py``)."""
    global _on, _step_spans
    was, was_steps = _on, _step_spans
    _on, _step_spans = True, was_steps or steps
    first = len(_records)
    out: List[SpanRecord] = []
    try:
        yield out
    finally:
        _on, _step_spans = was, was_steps
        out.extend(sorted(_records[first:], key=lambda r: r[2]))
        if not was:
            _records.clear()


def host_read(site: str, n: int = 1) -> None:
    """Counts ``n`` reads of device values by the host at ``site``."""
    _host_reads[site] = _host_reads.get(site, 0) + n


def host_read_counts() -> Dict[str, int]:
    """The host's reads of device values in this process so far, by site."""
    return dict(_host_reads)


def graph_step(kind: str) -> None:
    """Counts a train step as ``kind``: ``capture`` (captured as a CUDA
    graph, then replayed), ``replay``, or ``eager.<reason>``."""
    _graph_steps[kind] = _graph_steps.get(kind, 0) + 1


def graph_counts() -> Dict[str, Any]:
    """The train steps of this process so far by how they ran:
    ``captures``, ``replays`` (a captured step counts in both: its capture
    launches nothing, its replay runs it) and ``eager``, the steps that ran
    eagerly by reason (``engine/graph.py::REASONS``)."""
    eager = {k.split(".", 1)[1]: n for k, n in _graph_steps.items()
             if k.startswith("eager.")}
    captures = _graph_steps.get("capture", 0)
    return {"captures": captures, "replays": captures + _graph_steps.get("replay", 0),
            "eager": eager}


class Trace:
    """A torch.profiler window over CPU and CUDA activities, with the spans
    on: ``start()``, then ``stop()`` writes ``<log_dir>/trace.json``
    (chrome://tracing, Perfetto; the spans as ``record_function`` ranges)
    and ``<log_dir>/ops.txt`` (device and host time by op). A train step
    whose signature has a CUDA graph replays in the window, as it does
    outside it, so the trace shows the replayed step (without the step's
    own spans); one without a graph yet runs eagerly, with its spans
    (``spans(steps=False)``)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._prof = None
        self._spans = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._spans = spans(steps=False)
        self._spans.__enter__()

    def stop(self) -> None:
        prof, self._prof = self._prof, None
        self._spans.__exit__(None, None, None)
        self._spans = None
        prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.log_dir, "trace.json"))
        avgs = prof.key_averages()
        with open(os.path.join(self.log_dir, "ops.txt"), "w") as f:
            if torch.cuda.is_available():
                f.write(avgs.table(sort_by="self_cuda_time_total", row_limit=60))
                f.write("\nby host time:\n")
            f.write(avgs.table(sort_by="self_cpu_time_total", row_limit=60))


class StepTimer:
    """Per-step timing with warmup exclusion and EMA. ``device``: the CUDA
    device whose stream the step runs on, timed with events (None or a CPU
    device: the host clock)."""

    def __init__(self, warmup: int = 2, ema: float = 0.9,
                 device: Optional[torch.device] = None):
        self.warmup = warmup
        self.ema = ema
        self.cuda = device is not None and device.type == "cuda"
        self.count = 0
        self.avg_ms: Optional[float] = None
        self._t0: Optional[float] = None
        self._start: Optional[torch.cuda.Event] = None
        self._pending: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None

    def __enter__(self):
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.cuda:
            self._add((time.perf_counter() - self._t0) * 1000.0)
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        prev, self._pending = self._pending, (self._start, end)
        if prev is not None:
            prev[1].synchronize()
            self._add(prev[0].elapsed_time(prev[1]))

    def _add(self, dt: float) -> None:
        self.count += 1
        if self.count > self.warmup:
            self.avg_ms = dt if self.avg_ms is None else (
                self.ema * self.avg_ms + (1 - self.ema) * dt)

    @property
    def steps_per_sec(self) -> float:
        return 1000.0 / self.avg_ms if self.avg_ms else 0.0

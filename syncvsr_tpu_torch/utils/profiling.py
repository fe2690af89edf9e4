"""Per-step timing and profiler windows (port of
``syncvsr_tpu/utils/profiling.py``).

``StepTimer`` times each step with an EMA over the steps after a warm-up,
as the JAX copy does: on the GPU with CUDA events recorded at the start and
the end of the step, read one step later (so the timer adds no host wait:
the train loop still reads a step's metrics only after it has enqueued the
next), on the CPU with the host clock. ``Trace`` is a ``torch.profiler``
window (CPU and CUDA activities) that writes a Chrome trace.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import torch


class Trace:
    """A torch.profiler window over CPU and CUDA activities: ``start()``,
    then ``stop()`` writes ``<log_dir>/trace.json`` (chrome://tracing,
    Perfetto) and ``<log_dir>/ops.txt`` (device and host time by op)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()

    def stop(self) -> None:
        prof, self._prof = self._prof, None
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

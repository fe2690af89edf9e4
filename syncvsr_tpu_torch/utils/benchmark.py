"""Timing, bounds and profiles for the measurement tools
(``syncvsr_tpu_torch/tools/bench_*.py``, ``profile_step.py``,
``bisect_bs16.py``) and ``chip_smoke.py``.

Times on the GPU are CUDA events around back-to-back calls after a
``synchronize``; on the CPU (a tool's ``--device cpu``) the host clock.
Every tool prints one JSON line (``emit``) that carries the card's name and
power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them (null where there is no card). Bounds
use the H100 SXM's data-sheet peaks.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from syncvsr_tpu_torch.utils.device import resolve_device

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# them, device memory
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# device-time groups of a profile, matched in order on the kernel's name
KERNEL_GROUPS = (
    ("port kernels", ("sync_ce_kernel", "sync_ce_split_kernel", "stats_fwd_fused",
                      "stats_bwd_fused")),
    ("convolution", ("conv", "cudnn", "implicit", "fprop", "dgrad", "wgrad")),
    ("matmul", ("gemm", "cutlass", "xmma", "sm90_")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("reduction", ("reduce",)),
)


def card_line() -> str:
    """The card's name and power limit, from ``nvidia-smi``; raises where it
    fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def card_or_none(device: torch.device) -> Optional[str]:
    """``card_line()`` on a GPU run; on the CPU the card's line where the
    host has one, else None."""
    if device.type == "cuda":
        return card_line()
    try:
        return card_line() if shutil.which("nvidia-smi") else None
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn: Callable, device, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` in ms over ``iters`` back-to-back calls after
    ``warmup`` calls on ``device`` (a ``torch.device`` or its name): CUDA
    events after a ``synchronize`` on the GPU, the host clock on the CPU."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, peak_flops: float, nbytes: float):
    """(ms, "operations" or "bytes"): the least time for ``flops`` at
    ``peak_flops`` and ``nbytes`` at the device's memory rate."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


class PeakMemory:
    """Peak device memory over a region, less what was allocated at its
    start (None on the CPU)."""

    def __init__(self, device: torch.device):
        self.device, self.bytes = device, None

    def __enter__(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            self._base = torch.cuda.memory_allocated(self.device)
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.bytes = torch.cuda.max_memory_allocated(self.device) - self._base


def trunk_bn_shapes(cfg, frames: int):
    """(N, C, launches a step) of every BatchNorm statistics call of the
    Conv3D ResNet-18 frontend over ``frames`` frames a clip: the stem BN,
    then layer1..layer4."""
    b, t = cfg.data.batch_size, frames
    hw = -(-cfg.data.crop_size // 2)             # stem stride 2
    shapes = [(b * t * hw * hw, cfg.model.frontend.stem_channels, 1)]
    hw = -(-hw // 2)                             # max-pool stride 2
    width = cfg.model.frontend.resnet_width
    for i in range(4):
        if i:
            hw = -(-hw // 2)
        # two BasicBlocks of two BNs, plus the downsample BN of layer2..4
        shapes.append((b * t * hw * hw, width * 2 ** i, 4 if i == 0 else 5))
    return shapes


def resnet1d_bn_shapes(cfg, frames: int):
    """(N, C, launches a step) of every BatchNorm statistics call of the
    ResNet1D audio frontend over ``frames`` frames (640 samples each) a
    clip: the stem BN and layer1's four, then the five of each of
    layer2..layer4, each at half the samples of the one before."""
    n = cfg.data.batch_size * frames * 640 // 4          # stem stride 4
    width = cfg.model.frontend.resnet_width
    return [(n >> i, width * 2 ** i, 5) for i in range(4)]


def device_ms(fn: Callable, names: Sequence[str], iters: int = 20):
    """(ms, own launches per call, device kernels per call, source, all
    ms): the device time per call of the kernels whose names hold one of
    ``names``, with no host time in it, from a ``profile_window`` over
    ``iters`` warm calls, and that of all the call's device kernels. Where
    the profiler traces no device time, both times are that of CUDA-graph
    replay of the call (all the kernels it makes) and the launch counts are
    None; so it is where the window traced some of the calls' kernels and
    not others."""
    cuda = torch.device("cuda")
    window = profile_window(fn, cuda, iters)
    own = [k for k in window["kernels"] if any(n in k[0] for n in names)]
    launches = sum(calls for _, _, calls in own)
    # a window that lost kernel records counts a fraction of a launch a call
    if own and round(launches * iters) % iters == 0:
        return (sum(ms for _, ms, _ in own), launches, window["launches"], "profiler",
                window["ms"])
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        fn()
    ms = time_ms(graph.replay, cuda, iters)
    return ms, None, None, "graph replay", ms


def profile_window(fn: Callable, device: torch.device, n: int = 3,
                   table_path: Optional[str] = None) -> Dict:
    """``n`` calls of ``fn`` under torch.profiler, after one unprofiled call
    (which lets the allocator take back the blocks of the call's sizes):
    the kernels' time a call (``ms``) and launches a call, by
    ``KERNEL_GROUPS`` group and kernel. On the GPU these are the device
    kernels; on the CPU the host ops' self time (``source`` says which).
    ``table_path``: where the profiler's tables go (by device and by host
    time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    fn()
    sync(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        sync(device)
    avgs = prof.key_averages()
    key = ("self_cpu_time_total" if not cuda else "self_device_time_total"
           if avgs and hasattr(avgs[0], "self_device_time_total") else "self_cuda_time_total")
    want = DeviceType.CUDA if cuda else DeviceType.CPU
    kernels = [(e.key, getattr(e, key) / 1e3 / n, e.count / n) for e in avgs
               if e.device_type == want and getattr(e, key) > 0]
    if table_path:
        os.makedirs(os.path.dirname(os.path.abspath(table_path)), exist_ok=True)
        with open(table_path, "w") as f:
            f.write(avgs.table(sort_by=key, row_limit=80, max_name_column_width=90))
            f.write("\nby host time:\n")
            f.write(avgs.table(sort_by="self_cpu_time_total", row_limit=40,
                               max_name_column_width=90))
    groups: Dict[str, List[float]] = {}
    for name, ms, calls in kernels:
        low = name.lower()
        g = next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)), "other")
        acc = groups.setdefault(g, [0.0, 0.0])
        acc[0] += ms
        acc[1] += calls
    return {"source": "device kernels" if cuda else "host ops",
            "ms": sum(ms for _, ms, _ in kernels),
            "launches": sum(c for _, _, c in kernels),
            "groups": groups, "kernels": sorted(kernels, key=lambda k: -k[1])}


def tool_parser(description: str) -> argparse.ArgumentParser:
    """A tool's argument parser with ``--device`` (the card unless ``cpu``)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None,
                    help="cpu: run on the CPU (by default the card; without one the "
                         "tool raises)")
    return ap


def tool_device(args) -> torch.device:
    """The tool's device: the card, or the CPU where ``--device cpu`` asks;
    raises without a card otherwise."""
    return resolve_device(args.device)


def emit(tool: str, device: torch.device, **fields) -> Dict:
    """Print the tool's one JSON line: ``tool``, ``device``, ``card`` (name
    and power limit, null without a card) and ``fields``; returns it."""
    line = {"tool": tool, "device": str(device), "card": card_or_none(device), **fields}
    print(json.dumps(line), flush=True)
    return line

"""Reduction of ``torch.profiler`` windows to what the per-layer readers and
the breakdown take.

A traced run profiles the cell's steady steps twice. The first window
traces the device alone (CUPTI activity records cost the host little), so
its wall time, the time the device was busy (the union of its operations'
intervals) and its kernels stand for the untraced loop. The second traces
the host too and names each idle gap of the device by the innermost host
op that was running when the gap began (host ops slow the loop down, so
only the gaps' names and their relative lengths are taken from it)."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Any, Dict, List, Tuple

TOP = 10
COPIES = ("memcpy", "memset")

Span = Tuple[str, float, float]


def events(prof) -> Tuple[List[Span], List[Span]]:
    """(device ops, host ops) as (name, start s, end s), each sorted by
    start; user annotations (``record_function`` ranges, which the profiler
    also mirrors on the device's timeline) are host ops."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9)
        on_device = e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
        if on_device:
            dev.append(rec)
        elif e.device_type() != DeviceType.CUDA:
            host.append(rec)
    dev.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    return dev, host


def _busy_and_gaps(dev: List[Span]) -> Tuple[float, List[Tuple[float, float]]]:
    busy, gaps = 0.0, []
    cur_start = cur_end = None
    for _, a, b in dev:
        if cur_end is None:
            cur_start, cur_end = a, b
        elif a > cur_end:
            busy += cur_end - cur_start
            gaps.append((cur_end, a))
            cur_start, cur_end = a, b
        else:
            cur_end = max(cur_end, b)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy, gaps


def device_record(prof, window_s: float, steps: int) -> Dict[str, Any]:
    """From the device-only window: busy seconds, every kernel (name,
    seconds; copies and memsets are busy time but no kernel) and the
    device operations that took most time."""
    dev, _ = events(prof)
    busy, _ = _busy_and_gaps(dev)
    by_name: Dict[str, float] = defaultdict(float)
    for name, a, b in dev:
        by_name[name] += b - a
    return {
        "steps": steps,
        "window_s": window_s,
        "busy_s": busy,
        "kernels": [(n, b - a) for n, a, b in dev if not any(c in n.lower() for c in COPIES)],
        "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda r: -r[1])[:TOP],
    }


def idle_gaps(prof) -> List[List[Any]]:
    """From the host-and-device window: the device's idle seconds summed by
    the host op running as each gap began, the largest first."""
    dev, host = events(prof)
    _, gaps = _busy_and_gaps(dev)
    starts = [r[1] for r in host]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        idle[_running(host, starts, a)] += b - a
    return sorted(([n, s] for n, s in idle.items()), key=lambda r: -r[1])[:TOP]


def _running(host: List[Span], starts: List[float], t: float) -> str:
    """The innermost host op running at ``t`` (the latest-started one that
    has not ended), or "no host op"."""
    i = bisect.bisect_right(starts, t)
    for name, _, b in reversed(host[max(0, i - 4000):i]):
        if b > t:
            return name
    return "no host op"

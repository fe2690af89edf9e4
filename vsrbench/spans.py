"""The port's own spans (``syncvsr_tpu_torch/utils/profiling.py``) in two
profiled windows of the train loop: device time by the step phase, module
and ``kernel.*`` span that launched it, the device's idle time by the step
phase that was dispatching, and the host's reads of device values.

    python3 -m vsrbench.spans --workload lrw_video.train --seed 7

builds the cell's program as ``run.py`` does (no check steps), warms it
up, and profiles three windows of the cell's ``trace_steps`` steps: the
device-only window of a traced run with the spans off (window 1), then,
with the spans on, a device-only window (window 3: no host activity is
traced, so its pace stands for the untraced loop's) and a host-and-device
window (window 4: the spans mirrored as ``record_function`` ranges). It
prints one JSON line: the breakdowns, and under ``metrics`` the per-step
quantities of ``readings``.

Window 4 puts each device op down to the spans open on the thread that
launched it, at the launch: the launch is the runtime call that shares the
op's correlation id, and a backward kernel belongs to the module whose span
held the forward op of the same autograd sequence number. Each kernel is
timed as window 1 timed it. Window 3 puts each idle gap of the device down
to the step phase that launched the op ending the gap, read from window 4
at the same place in the same sequence of device ops. Where two windows ran
other ops, the quantities that need the match read nothing. A run of a
cell with ``--trace 1`` (``run.py``) profiles windows 1 and 2 only."""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import sys
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from vsrbench.trace import COPIES, TOP, Span, _busy_and_gaps

PHASES = ("step.forward", "step.backward", "step.update")
OUTSIDE = "outside"
MODULE = "model."
KERNEL = "kernel."
EVALUATE = "autograd::engine::evaluate_function"
MISMATCH = 0.05


def idle_by_phase(dev: List[Span], steps: int, launched: List[str] | None = None,
                  names: List[str] | None = None) -> Dict[str, Any]:
    """The device-only window's idle ms a step by the step phase that
    launched the op ending each gap (``idle_ms``; ``OUTSIDE`` where none),
    from its device ops ``dev``, where the host-and-device window ran the
    same device ops (``names``, in device order, the phase that launched
    each in ``launched``; ``matched``: how the two compare; a copy or
    memset of this window alone takes the phase of the next op placed, and
    a lost tail of this window's ops is passed over, up to ``MISMATCH`` of
    them). Where they ran other ops, no ``idle_ms``. ``gaps_ms``: every
    gap a step; ``busy_s``: the union of the device ops."""
    if not dev:
        return {}
    busy, gaps = _busy_and_gaps(dev)
    out: Dict[str, Any] = {"gaps_ms": 1e3 * sum(b - a for a, b in gaps) / steps, "busy_s": busy}
    at, out["matched"] = matched([d[0] for d in dev], names or [], prefix=True)
    if at is None:
        return out
    phase, by_op = OUTSIDE, [OUTSIDE] * len(at)
    for k in range(len(at) - 1, -1, -1):
        phase = by_op[k] = launched[at[k]] if at[k] is not None else phase
    idle: Dict[str, float] = dict.fromkeys(PHASES + (OUTSIDE,), 0.0)
    starts = [a for _, a, _ in dev]
    for a, b in gaps:
        idle[by_op[bisect.bisect_left(starts, b)]] += b - a
    out["idle_ms"] = {k: 1e3 * v / steps for k, v in idle.items()}
    return out


def _runtime(name: str) -> bool:
    """A call of the CUDA runtime or of its low-level API (``cudaLaunchKernel``,
    ``cuLaunchKernel``...)."""
    return name.startswith("cu") and len(name) > 2 and (
        name[2].isupper() or (name.startswith("cuda") and name[4:5].isupper()))


class _Ev:
    __slots__ = ("name", "start", "end", "tid", "seq")

    def __init__(self, name, start, end, tid, seq):
        self.name, self.start, self.end, self.tid, self.seq = name, start, end, tid, seq


def kineto_records(prof, span_names) -> Dict[str, Any]:
    """From a host-and-device window: its device ops (name, start, duration,
    correlation id, linked op's correlation id, whether a copy or memset),
    the launches by correlation id, the torch ops by correlation id, the
    spans (mirrored ``record_function`` ranges named in ``span_names``),
    the autograd engine's ``evaluate_function`` ranges and the ops that
    carry a sequence number. Times in ns, threads as the profiler numbers
    them."""
    from torch.autograd import DeviceType

    device, launches, ops, intervals, numbered = [], {}, {}, [], []
    names = set(span_names)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((name, e.start_ns(), e.duration_ns(), e.correlation_id(),
                               e.linked_correlation_id(),
                               _copy(name)))
            continue
        start = e.start_ns()
        ev = _Ev(name, start, start + e.duration_ns(), e.start_thread_id(), e.sequence_nr())
        if _runtime(name):
            launches[e.correlation_id()] = ev
            continue
        ops[e.correlation_id()] = ev
        if name in names and e.is_user_annotation():
            intervals.append(ev)
        elif name.startswith(EVALUATE):
            intervals.append(ev)
        elif ev.seq >= 0:
            numbered.append(ev)
    return {"device": sorted(device, key=lambda d: d[1]), "launches": launches, "ops": ops,
            "intervals": intervals, "numbered": numbered}


def _chains(intervals: List[_Ev], queries: List[Tuple[int, int, int]]
            ) -> Dict[int, Tuple[_Ev, ...]]:
    """For each query (thread, time ns, key) the intervals of that thread
    open at that time, outermost first (ranges of one thread nest), by key."""
    by_tid: Dict[int, List[_Ev]] = defaultdict(list)
    for iv in intervals:
        by_tid[iv.tid].append(iv)
    out: Dict[int, Tuple[_Ev, ...]] = {}
    per: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for tid, t, i in queries:
        per[tid].append((t, i))
    for tid, qs in per.items():
        ivs = sorted(by_tid.get(tid, ()), key=lambda v: (v.start, -v.end))
        j, stack = 0, []
        for t, i in sorted(qs):
            while j < len(ivs) and ivs[j].start <= t:
                while stack and stack[-1].end <= ivs[j].start:
                    stack.pop()
                stack.append(ivs[j])
                j += 1
            while stack and stack[-1].end <= t:
                stack.pop()
            out[i] = tuple(v for v in stack if v.end > t)
    return out


def _copy(name: str) -> bool:
    return any(c in name.lower() for c in COPIES)


def matched(names: List[str], other: List[str], prefix: bool = False) -> Tuple[Any, str]:
    """Where two windows ran the same device ops in the same order: for each
    op of ``names``, the place of the same op in ``other``, walking both
    in order (None for a copy or memset found in ``names`` only; one found
    in ``other`` only is passed over); else None. A kernel of another name
    at the same place counts as the same op (it takes a vectorized or an
    unrolled kernel as its operands' addresses happen to align), as long
    as at most ``MISMATCH`` of the places differ so, hold a copy of one
    window only or, with ``prefix`` (a trace that lost its last device
    ops), are left over in ``other``. Also says how the two compare."""
    at, i, j, differ, alone = [], 0, 0, 0, 0
    while i < len(names):
        a, b = names[i], other[j] if j < len(other) else None
        if a == b or (b is not None and not _copy(a) and not _copy(b)):
            differ += a != b
            at.append(j)
            i, j = i + 1, j + 1
        elif _copy(a):
            at.append(None)
            alone, i = alone + 1, i + 1
        elif b is not None and _copy(b):
            alone, j = alone + 1, j + 1
        else:
            return None, f"{len(names)} ops against {len(other)}, a kernel at {i} has no match"
    left = len(other) - j
    if not prefix and any(not _copy(n) for n in other[j:]):
        return None, f"{len(names)} ops against {len(other)}, {left} left over"
    how = (f"{len(names)} ops against {len(other)}: {differ} places differ in name, "
           f"{alone} copies in one window only, {left} left over")
    alone += left
    return (at if differ + alone <= MISMATCH * len(names) else None), how


def attribute(recs: Dict[str, Any], steps: int, window1=None) -> Dict[str, Any]:
    """Device ms a step of the host-and-device window's kernels (from
    ``kineto_records``; copies and memsets left out, as in
    ``device_record``): by the step phase open on the main thread at each
    kernel's launch (``phase_ms``, ``OUTSIDE`` where none was; the four sum
    to ``kernel_ms``), under each span open on the launching thread at the
    launch (``under_ms``; a module's also takes the backward kernels of the
    ops its span held, by autograd sequence number), and by the innermost
    such span or else the phase (``innermost_ms``, summing to ``kernel_ms``
    too); kernels a step by phase (``launches``), and the kernels under
    each ``kernel.*`` span by name (``kernels_under``). ``unlinked``:
    device ops whose launch was not found (put down to ``OUTSIDE``);
    ``before_launch``: device ops whose start reads earlier than their
    launch on the host's clock. Each kernel's device time is the one at
    its place in the device-only window's kernels (``window1``: (name, s)
    in device order), so the attribution sums what the kernel-class
    metrics read; where the two windows ran other kernels (``matched``;
    ``durations`` says how they compare) there are no ms (no
    ``kernel_ms``, ``phase_ms``, ``under_ms``, ``innermost_ms`` or
    ``kernels_under``). ``window4_kernel_ms``: the host-and-device
    window's own kernel ms a step. ``op_names`` and ``op_phases``: every
    device op in device order, and the phase that launched it (for
    ``idle_by_phase``)."""
    device, intervals = recs["device"], recs["intervals"]
    kernels = [d for d in device if not d[5]]
    if not kernels:
        return {}
    at, how = matched([k[0] for k in kernels], [w[0] for w in window1 or []])
    dur_of = None if at is None else {id(k): 1e9 * window1[j][1] for k, j in zip(kernels, at)}
    phases = [iv for iv in intervals if iv.name in PHASES]
    main = phases[0].tid if phases else None
    launch, unlinked, before = [], 0, 0
    for name, start, dur, corr, linked, _copy in device:
        ev = recs["launches"].get(corr) or recs["ops"].get(linked)
        if ev is None:
            unlinked += 1
            launch.append(None)
            continue
        before += start < ev.start
        launch.append((ev.tid, ev.start))
    queries = []
    for i, ln in enumerate(launch):
        if ln is not None:
            queries.append((ln[0], ln[1], 2 * i))
            queries.append((main, ln[1], 2 * i + 1))
    fwd = [ev for ev in recs["numbered"] if ev.tid == main and not ev.name.startswith(EVALUATE)]
    base = 2 * len(launch)
    queries += [(ev.tid, ev.start, base + k) for k, ev in enumerate(fwd)]
    chains = _chains(intervals, queries)

    module_of: Dict[int, Any] = {}
    for k, ev in sorted(enumerate(fwd), key=lambda r: r[1].start):
        chain = chains[base + k]
        if any(v.name == "step.forward" for v in chain):
            mods = [v.name for v in chain if v.name.startswith(MODULE)]
            module_of[ev.seq] = mods[-1] if mods else None

    phase_ms: Dict[str, float] = dict.fromkeys(PHASES + (OUTSIDE,), 0.0)
    launches: Dict[str, int] = dict.fromkeys(PHASES + (OUTSIDE,), 0)
    under: Dict[str, float] = defaultdict(float)
    inner: Dict[str, float] = defaultdict(float)
    named: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    op_phases = []
    for i, op in enumerate(device):
        phase, spans, own = OUTSIDE, [], ()
        if launch[i] is not None:
            own = chains[2 * i]
            ph = [v.name for v in chains[2 * i + 1] if v.name in PHASES]
            phase = ph[-1] if ph else OUTSIDE
            spans = [v.name for v in own if not v.name.startswith(EVALUATE)]
        op_phases.append(phase)
        if op[5]:
            continue
        launches[phase] += 1
        if dur_of is None:
            continue
        dur = dur_of[id(op)]
        phase_ms[phase] += dur
        inner[spans[-1] if spans else phase] += dur
        for n in spans:
            if n.startswith(KERNEL):
                named[n][op[0]] += dur
        names = set(spans) | {phase}
        if not any(n.startswith(MODULE) for n in names):
            evals = [v for v in own if v.name.startswith(EVALUATE)]
            mod = module_of.get(evals[-1].seq) if evals else None
            if mod is not None:
                names.add(mod)
        for n in names:
            under[n] += dur
    per = 1e-6 / steps
    out = {"durations": how, "window4_kernel_ms": sum(k[2] for k in kernels) * per,
           "launches": {k: v / steps for k, v in launches.items()},
           "unlinked": unlinked, "before_launch": before,
           "op_names": [d[0] for d in device], "op_phases": op_phases}
    if dur_of is None:
        return out
    out.update(kernel_ms=sum(dur_of.values()) * per,
               phase_ms={k: v * per for k, v in phase_ms.items()},
               under_ms={k: v * per for k, v in sorted(under.items())},
               innermost_ms={k: v * per for k, v in sorted(inner.items(), key=lambda r: -r[1])},
               kernels_under={s: sorted(([n[:TOP * 8], v * per] for n, v in ks.items()),
                                        key=lambda r: -r[1])[:TOP]
                              for s, ks in sorted(named.items())})
    return out


def span_windows(prog, pool: List[Dict], device, steps: int,
                 window1: Dict[str, Any]) -> Dict[str, Any]:
    """Windows 3 and 4, ``steps`` steps each, with the program's spans on,
    after the device-only window ``window1`` (its ``kernels``): the idle
    gaps of window 3 by phase with the host's reads of device values a step
    by site (``span_idle``), and window 4's device ops by span
    (``span_kernels``). Nothing where the program has no spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vsrbench.run import window
    from vsrbench.trace import events

    try:
        from syncvsr_tpu_torch.utils import profiling
    except ImportError:
        return {}
    if not all(hasattr(profiling, a) for a in ("spans", "host_read_counts", "SPANS")):
        return {}
    t0 = time.perf_counter()
    cuda = device.type == "cuda"
    prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
    reads0 = profiling.host_read_counts()
    with profiling.spans() as recorded:
        w3 = window(prog, pool, device, steps=steps, profiler=prof)
    reads = {k: (n - reads0.get(k, 0)) / w3["steps"]
             for k, n in profiling.host_read_counts().items() if n != reads0.get(k, 0)}
    dev, _ = events(prof)
    del prof
    prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
    with profiling.spans():
        w4 = window(prog, pool, device, steps=steps, profiler=prof)
    kernels = attribute(kineto_records(prof, profiling.SPANS), w4["steps"],
                        window1.get("kernels"))
    del prof
    idle = idle_by_phase(dev, w3["steps"], kernels.pop("op_phases", None),
                         kernels.pop("op_names", None))
    idle.update(host_reads=sum(reads.values()), host_reads_by_site=reads,
                spans=len(recorded) / w3["steps"], window_s=w3["wall_s"],
                enqueue_ms=1e3 * sum(w3["enqueue_s"]) / len(w3["enqueue_s"]))
    if "busy_s" in idle:
        idle["idle_share"] = 100.0 * (1.0 - idle["busy_s"] / w3["wall_s"])
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {"span_idle": idle, "span_kernels": kernels,
            "span_windows_s": time.perf_counter() - t0}


def readings(rec: Dict[str, Any]) -> Dict[str, float]:
    """The per-step quantities of the span windows under the names of the
    per-layer metrics they are for (``PERF.md`` §3): device ms by phase
    (window 4), under the augmentation, frontend and encoder spans (a
    module's backward by sequence number), idle ms by phase (window 3), the
    host's reads, and the two span rooflines (``counts.sync_ce``'s least
    time over the device time under ``kernel.sync_ce``; ``counts.bn_stats``'
    least bytes over that under ``kernel.bn_stats`` and ``.bwd``). What has
    nothing to read is left out."""
    from vsrbench import counts

    kern, idle = rec.get("span_kernels", {}), rec.get("span_idle", {})
    phase, under, by_phase = kern.get("phase_ms"), kern.get("under_ms"), idle.get("idle_ms")
    out: Dict[str, Optional[float]] = {}
    for p in PHASES:
        if phase is not None:
            out[f"{p[5:]}_ms_per_step.train"] = phase[p]
        if by_phase is not None:
            out[f"{p[5:]}_idle_ms_per_step.train"] = by_phase[p]
    if under is not None:
        for span in ("step.augment", "model.frontend", "model.encoder"):
            out[f"{span.split('.')[1]}_ms_per_step.train"] = under.get(span, 0.0)
        if rec.get("sync"):
            least = sum(counts.bound_s(*counts.sync_ce(n, d, slots, vocab, rec["compute_elem"]))
                        for n, d, slots, vocab in rec["sync"])
            out["sync_ce_span_roofline"] = counts.share(
                least, under.get("kernel.sync_ce", 0.0) * 1e-3)
        if rec.get("bn"):
            took = under.get("kernel.bn_stats", 0.0) + under.get("kernel.bn_stats.bwd", 0.0)
            least = counts.bn_stats(rec["bn"], rec["compute_elem"]) / counts.PEAK_BYTES
            out["bn_stats_span_roofline"] = counts.share(least, took * 1e-3)
    if "host_reads" in idle:
        out["host_reads_per_step.train"] = idle["host_reads"]
    return {k: v for k, v in out.items() if v is not None}


def measure(cell_name: str, seed: int, steps: int = 0, device=None,
            config_overrides: Optional[Dict[str, Any]] = None,
            batch_overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Windows 1, 3 and 4 of the cell's program; returns the printed line's
    object. ``device``, ``config_overrides`` and ``batch_overrides`` are for
    the CPU tests (a toy size)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vsrbench import check, counts, run, trace, weights

    device = torch.device(device or "cuda")
    cuda = device.type == "cuda"
    c = run.prepare(cell_name, seed, config_overrides, batch_overrides)
    cell, pool, ref_cfg = c["cell"], c["pool"], c["ref_cfg"]
    steps = steps or cell["trace_steps"]
    leaves = weights.make(weights.leaves(check.skeleton(ref_cfg)), c["seeds"]["weights"], device)
    prog = run.Program(c["conf"]["config"], c["overrides"], leaves, pool[0], device)
    del leaves
    compute_elem = torch.empty((), dtype=getattr(torch, prog.cfg.model.dtype)).element_size()
    run.window(prog, pool, device, steps=cell.get("warmup_steps", 2))
    gc.collect()
    prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
    rec = run.window(prog, pool, device, steps=steps, profiler=prof)
    rec.update(trace.device_record(prof, rec["wall_s"], rec["steps"]))
    del prof
    rec.update(span_windows(prog, pool, device, steps, rec))
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rec.update(counts.step_counts(ref_cfg, weights.make(
        weights.leaves(check.skeleton(ref_cfg)), c["seeds"]["weights"], device),
        pool[0], device, c["batch"]["batch_size"]), compute_elem=compute_elem)
    spans = dict(rec.get("span_kernels", {}), idle=rec.get("span_idle"),
                 seconds=rec.get("span_windows_s"),
                 window1_kernel_ms=1e3 * sum(s for _, s in rec["kernels"]) / rec["steps"],
                 window1_idle_share=100.0 * (1.0 - rec["busy_s"] / rec["window_s"]),
                 window1_enqueue_ms=1e3 * sum(rec["enqueue_s"]) / len(rec["enqueue_s"]))
    return {"workload": cell_name, "seed": seed, "steps": steps, "metrics": readings(rec),
            "spans": spans, "card": run.card_line() if cuda else None}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Profile a cell's train loop by the port's spans.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=0, help="steps a window (the cell's trace_steps)")
    args = ap.parse_args(argv)

    from vsrbench import run, spec

    run.set_cache_dirs(spec.CHECKOUT)
    import torch

    if not torch.cuda.is_available():
        print("vsrbench.spans: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, torch.get_num_threads()))
    print(json.dumps(measure(args.workload, args.seed, args.steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

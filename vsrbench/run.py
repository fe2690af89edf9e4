"""Run one cell once and print its result as the last line of standard
output.

    python3 -m vsrbench.run --workload lrw_video.train --seed 7 --seconds 30 --trace 0

Set-up (counted in ``setup_s``, from the process's start to the first timed
step): the port's kernel library from its build cache inside the checkout,
the configuration at the cell's sizes, the batches (``traffic.py``), the
weights on the device from the seed (``weights.py``), the port's model,
train state and train step as ``syncvsr_tpu_torch/train.py`` builds them,
the three check steps (``check.py``) and a few warm-up steps at the cell's
one shape. The window then runs the port's closed loop of train steps, as
``train.py``'s loop does (each batch through ``train.to_device``, each
step's metrics read with ``train.host_metrics`` after the next step is
enqueued), for ``--seconds`` (``--trace 0``), or ``trace_steps`` steps
under ``torch.profiler`` (``--trace 1``). Once it has closed, the peak
memory is read, the program's state is freed and the plain reference
follows the check steps. Without a card, or with fewer cards than the
cell asks for, the run prints no result and exits with 2; where a module
of JAX or of the JAX package is loaded once the window has closed, with 3.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Any, Callable, Dict, List, Optional  # noqa: E402

FOREIGN = ("jax", "jaxlib", "flax", "syncvsr_tpu")


def foreign_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FOREIGN))


def set_cache_dirs(checkout) -> None:
    """The port's build cache (``nvcc`` library) and Triton's at fixed paths
    inside the checkout, so only a checkout's first run builds."""
    build = os.path.join(str(checkout), "build")
    os.environ["SYNCVSR_COMPILE_CACHE"] = os.path.join(build, "syncvsr_tpu_torch")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


def seeds_of(seed: int) -> Dict[str, int]:
    """The generators' seeds of a run, drawn from ``--seed``."""
    import numpy as np

    w, m, d = np.random.SeedSequence(seed).generate_state(3)
    return {"weights": int(w), "train.mixup_seed": int(m), "train.dropout_seed": int(d)}


def card_line() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


class Program:
    """The port's train loop at the cell's configuration: model, state and
    step as ``train.py`` builds them, with the benchmark's weights."""

    def __init__(self, config: Dict[str, Any], overrides: Dict[str, Any], leaves,
                 batch0, device, step_factory: Optional[Callable] = None):
        from syncvsr_tpu_torch import train as trainer
        from syncvsr_tpu_torch.config import Config
        from syncvsr_tpu_torch.engine import build_train_step, create_train_state
        from syncvsr_tpu_torch.models.registry import build_model

        from vsrbench import weights

        self.cfg = Config.from_dict(config).override(**overrides)
        self.to_device = lambda b: trainer.to_device(b, device)
        self.host_metrics = trainer.host_metrics
        model = build_model(self.cfg, device=device)
        weights.load(model, leaves)
        eval_tf, aug_fn = trainer.transforms(self.cfg)
        self.state = create_train_state(self.cfg, model, eval_tf(self.to_device(batch0)),
                                        device=device)
        self.step = (step_factory or build_train_step)(aug_fn=aug_fn)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(prog: Program, pool: List[Dict], device, seconds: float = 0.0,
           steps: int = 0, profiler=None) -> Dict[str, Any]:
    """The closed loop of train steps, for ``seconds`` or for ``steps``
    steps: the record the end-to-end readers take (frames, wall time, step
    intervals from CUDA events at each step's end, host time of each
    step's call, losses that were not finite)."""
    import torch
    from torch.profiler import record_function

    from vsrbench import traffic

    cuda = device.type == "cuda"
    frames = [traffic.frames(b) for b in pool]
    ends, enqueue, done = [], [], 0
    nonfinite = 0
    pending = None
    _sync(device)
    if profiler is not None:
        profiler.start()
    t0 = time.perf_counter()
    start = torch.cuda.Event(enable_timing=True) if cuda else None
    if cuda:
        start.record()
    n = 0
    while True:
        batch = pool[n % len(pool)]
        with record_function("bench.to_device"):
            dev_batch = prog.to_device(batch)
        h0 = time.perf_counter()
        with record_function("bench.train_step"):
            prog.state, metrics = prog.step(prog.state, dev_batch)
        enqueue.append(time.perf_counter() - h0)
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ends.append(ev)
        if pending is not None:
            with record_function("bench.host_metrics"):
                nonfinite += not math.isfinite(prog.host_metrics(pending)["loss"])
        if not cuda:
            ends.append(time.perf_counter())
        pending = metrics
        done += frames[n % len(pool)]
        n += 1
        if (steps and n >= steps) or (not steps and time.perf_counter() - t0 >= seconds):
            break
    nonfinite += not math.isfinite(prog.host_metrics(pending)["loss"])
    _sync(device)
    t1 = time.perf_counter()
    if profiler is not None:
        profiler.stop()
    if cuda:
        marks = [start] + ends
        intervals = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        marks = [t0] + ends
        intervals = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return {"steps": n, "frames": done, "wall_s": t1 - t0, "step_ms": intervals,
            "enqueue_s": enqueue, "nonfinite": nonfinite}


def prepare(cell_name: str, seed: int, config_overrides: Optional[Dict[str, Any]] = None,
            batch_overrides: Optional[Dict[str, Any]] = None, pool: Optional[int] = None
            ) -> Dict[str, Any]:
    """A run's cell, configuration, seeds, the program's config overrides,
    the reference's configuration and the host batches (``pool`` of them,
    by default the cell's, the check steps' first)."""
    from vsrbench import check, spec, traffic

    cell = spec.cell(cell_name)
    conf = spec.config(cell["config"])
    run_seeds = seeds_of(seed)
    p = dict(cell["batch"], **(batch_overrides or {}))
    overrides = dict(cell.get("overrides", {}), **(config_overrides or {}))
    overrides.update({k: v for k, v in run_seeds.items() if k.startswith("train.")})
    ref_cfg = check.reference_config(conf["config"], dict(overrides, **cell.get("reference", {})))
    count = pool or max(p["pool"], check.CHECK_STEPS)
    batches = traffic.batches(p, ref_cfg.to_dict()["model"], seed, count)
    return {"cell": cell, "conf": conf, "seeds": run_seeds, "batch": p, "overrides": overrides,
            "ref_cfg": ref_cfg, "pool": batches}


def run(cell_name: str, seed: int, seconds: float, trace: bool, device=None,
        config_overrides: Optional[Dict[str, Any]] = None,
        batch_overrides: Optional[Dict[str, Any]] = None,
        step_factory: Optional[Callable] = None) -> Dict[str, Any]:
    """One run of a cell; returns the result line's object. ``device``,
    ``config_overrides``, ``batch_overrides`` and ``step_factory`` are for
    the CPU tests (a toy size, a planted fault)."""
    import torch

    from vsrbench import check, counts, spec, weights

    device = torch.device(device or "cuda")
    bench = spec.benchmark()
    c = prepare(cell_name, seed, config_overrides, batch_overrides)
    cell, conf, run_seeds, p, overrides, ref_cfg, pool = (
        c["cell"], c["conf"], c["seeds"], c["batch"], c["overrides"], c["ref_cfg"], c["pool"])
    checked = pool[:check.CHECK_STEPS]
    leaves = weights.make(weights.leaves(check.skeleton(ref_cfg)), run_seeds["weights"], device)
    prog = Program(conf["config"], overrides, leaves, pool[0], device, step_factory)
    del leaves
    compute_elem = torch.empty((), dtype=getattr(torch, prog.cfg.model.dtype)).element_size()

    prog_read = check.drive(prog.state, prog.step, checked, prog.to_device)
    window(prog, pool, device, steps=cell.get("warmup_steps", 2))
    gc.collect()
    setup_s = time.perf_counter() - PROCESS_START

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from vsrbench import trace as tr

        cuda = device.type == "cuda"
        prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        rec = window(prog, pool, device, steps=cell["trace_steps"], profiler=prof)
        rec.update(tr.device_record(prof, rec["wall_s"], rec["steps"]))
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if cuda else []))
        window(prog, pool, device, steps=cell["trace_steps"], profiler=prof)
        rec["breakdown"] = {"device_ops": rec.pop("device_ops"), "idle_gaps": tr.idle_gaps(prof)}
        del prof
    else:
        rec = window(prog, pool, device, seconds=seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rec.update(setup_s=setup_s, peak_bytes=peak, compute_elem=compute_elem)
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref_read = check.follow(ref_cfg, run_seeds["weights"], checked, device)
    found = check.gaps(prog_read, ref_read)
    correct, compared = check.judge(found, cell["limits"])
    if trace:
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        rec.update(counts.step_counts(ref_cfg, weights.make(
            weights.leaves(check.skeleton(ref_cfg)), run_seeds["weights"], device),
            pool[0], device, p["batch_size"]))

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.cell_metrics(bench, cell_name, kind):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        dev.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
    result = {"correct": bool(correct and rec["nonfinite"] == 0), "attempted": rec["steps"],
              "failed": rec["nonfinite"], "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = rec["breakdown"]
    result["card"] = card_line() if device.type == "cuda" else None
    result["readings"] = {"program_losses": prog_read.losses, "reference_losses": ref_read.losses,
                          "gaps": {n: found[n] for n in check.NAMES + ("grad_worst",)},
                          "leaves": found["leaves"],
                          "enqueue_ms_mean": 1e3 * sum(rec["enqueue_s"]) / len(rec["enqueue_s"]),
                          "step_ms_median": sorted(rec["step_ms"])[len(rec["step_ms"]) // 2],
                          "host_load": os.getloadavg()}
    result["compared"] = compared
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from vsrbench import spec

    set_cache_dirs(spec.CHECKOUT)
    import torch

    chips = spec.cell(args.workload).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vsrbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, torch.get_num_threads()))
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except ImportError as e:
        print(f"vsrbench: the program cannot be imported: {e}", file=sys.stderr)
        return 1
    found = foreign_modules()
    if found:
        print(f"vsrbench: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

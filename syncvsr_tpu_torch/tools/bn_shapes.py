#!/usr/bin/env python3
"""Per-shape times of the BatchNorm statistics kernels K3 and K4 on one GPU,
for the checkout at ``--root`` (default: this one), so that two versions can
be compared in one call on one card:

    python3 syncvsr_tpu_torch/tools/bn_shapes.py [--root DIR] [--label NAME] [--sweep]

It imports ``syncvsr_tpu_torch`` and ``chip_smoke`` from ``--root`` and
nothing of JAX. For every BatchNorm shape of the ``lrw_video`` and ``lrs3``
train steps (``chip_smoke.bn_shapes()``), in bf16, it prints per kernel:
``ms`` (CUDA events around 20 warm back-to-back calls of the wrapper, host
included, every shape timed before the first profiler window),
``device_ms`` (the kernel's own device time from a torch.profiler window
over 20 calls, with its launches per call), the library call's ``ms`` and
device time (``torch.batch_norm_stats`` /
``torch.batch_norm_backward_reduce``) and the bound (bytes at 3.35 TB/s),
then the sums per step of each path, and the card's name and power limit.
``--sweep`` adds K4's device time at each shape over ``SWEEP_STRIPS``
strips beside the count its wrapper picks.
"""

import argparse
import os
import subprocess
import sys

# the kernels' device function names, old and new
OWN = {"K3": ("stats_fwd_partial", "sum_strips"), "K4": ("stats_bwd", "sum_strips")}
PEAK_BYTES = 3.35e12
# K4 grids for --sweep: 1, 2, 3, 4, 6 and 8 blocks a SM of the H100's 132
SWEEP_STRIPS = (132, 264, 396, 528, 792, 1056)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.join(os.path.dirname(__file__), "..", ".."))
    ap.add_argument("--label", default="")
    ap.add_argument("--sweep", action="store_true",
                    help="also time K4 at the strip counts SWEEP_STRIPS (this checkout only)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    import syncvsr_tpu_torch
    from syncvsr_tpu_torch.ops import cuda_bn
    from syncvsr_tpu_torch.utils import kernels

    if not torch.cuda.is_available():
        print("no CUDA device: this script runs only on a GPU")
        return 1
    assert os.path.abspath(syncvsr_tpu_torch.__file__).startswith(root)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    kernels.library()
    dev = torch.device("cuda")
    label = args.label or root

    def device_ms(fn, names, iters=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        own = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and any(k in e.key for k in names)]
        return (sum(e.self_device_time_total for e in own) / 1e3 / iters,
                sum(e.count for e in own) / iters)

    g = torch.Generator(device=dev).manual_seed(1)
    launches = {}
    for path, shapes in chip_smoke.bn_shapes().items():
        for n, c, k in shapes:
            launches.setdefault((n, c), {})[path] = k
    # every CUDA-event timing first, then the profiler windows: a process
    # that torch.profiler has traced can pay more host time a launch afterwards
    calls = []
    for (n, c), per_step in sorted(launches.items()):
        x = (torch.randn(n, c, device=dev, generator=g) * 2 + 0.5).to(torch.bfloat16)
        gy = torch.randn(n, c, device=dev, generator=g).to(torch.bfloat16)
        mean = x.float().mean(0)
        inv = torch.rsqrt(x.float().var(0, unbiased=False) + 1e-5)
        for name, kern, lib, nbytes in (
                ("K3", lambda x=x: cuda_bn.bn_stats(x),
                 lambda x=x: torch.batch_norm_stats(x, 1e-5), n * c * 2 + 2 * c * 4),
                ("K4", lambda a=(gy, x, mean, inv): cuda_bn.bn_bwd_stats(*a),
                 lambda a=(gy, x, mean, inv): torch.batch_norm_backward_reduce(
                     *a, None, True, False, False),
                 2 * n * c * 2 + 4 * c * 4)):
            row = {"ms": chip_smoke.cuda_ms(torch, kern), "device_ms": None,
                   "library_ms": chip_smoke.cuda_ms(torch, lib), "library_device_ms": None,
                   "bound_ms": nbytes / PEAK_BYTES * 1e3}
            calls.append((name, n, c, per_step, kern, lib, row))
    totals = {}
    for name, n, c, per_step, kern, lib, row in calls:
        row["device_ms"], kernels_a_call = device_ms(kern, OWN[name])
        row["library_device_ms"], _ = device_ms(lib, ("",))
        print(f"{label} {name} [{n}, {c}] per step {per_step}: "
              + " ".join(f"{k} {v:.5f}" for k, v in row.items())
              + f" ({kernels_a_call:.0f} kernels a call)", flush=True)
        for path, k in per_step.items():
            t = totals.setdefault((name, path), dict.fromkeys(row, 0.0))
            for key, v in row.items():
                t[key] += k * v
    del calls
    torch.cuda.empty_cache()
    for (name, path), t in sorted(totals.items()):
        print(f"{label} {name} per step of {path}: "
              + " ".join(f"{k} {v:.5f}" for k, v in t.items()), flush=True)
    if args.sweep:
        # K4's device time at other strip counts than bwd_geometry's: the
        # evidence for its choice
        for (n, c) in sorted(launches):
            x = (torch.randn(n, c, device=dev, generator=g) * 2 + 0.5).to(torch.bfloat16)
            gy = torch.randn(n, c, device=dev, generator=g).to(torch.bfloat16)
            mean = x.float().mean(0)
            inv = torch.rsqrt(x.float().var(0, unbiased=False) + 1e-5)
            chosen = cuda_bn.bwd_geometry(n, c, 2)["strips"]
            for strips in sorted({chosen, *SWEEP_STRIPS}):
                if strips > n:
                    continue
                ms, _ = device_ms(lambda: cuda_bn.bn_bwd_stats(gy, x, mean, inv, strips=strips),
                                  OWN["K4"])
                print(f"{label} sweep K4 [{n}, {c}] strips {strips}"
                      f"{' (chosen)' if strips == chosen else ''}: device_ms {ms:.5f}",
                      flush=True)
            del x, gy
            torch.cuda.empty_cache()
    print(f"{label} on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

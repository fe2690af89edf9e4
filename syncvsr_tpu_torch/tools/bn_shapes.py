#!/usr/bin/env python3
"""Per-shape times of the BatchNorm statistics kernels K3 and K4, and of the
sync cross-entropy kernel K1, on one GPU, for the checkout at ``--root``
(default: this one), so that two versions can be compared in one call on
one card:

    python3 syncvsr_tpu_torch/tools/bn_shapes.py [--root DIR] [--label NAME]
        [--sweep]

It imports ``syncvsr_tpu_torch`` and ``chip_smoke`` from ``--root`` and
nothing of JAX. For every BatchNorm shape of the train steps that have
them (``chip_smoke.bn_shapes()``: ``lrw_video``, ``lrs3`` and, in a checkout
that has it, ``lrs3_audio``), in bf16, it prints per kernel:
``ms`` (CUDA events around 20 warm back-to-back calls of the wrapper, host
included, every timing taken before the first profiler window),
``device_ms`` (the kernel's own device time from a torch.profiler window
over 20 calls, with its kernels a call), the library call's ``ms`` and
device time (``torch.batch_norm_stats`` /
``torch.batch_norm_backward_reduce``) and the bound (bytes at 3.35 TB/s),
then the sums per step of each path. Then K1 at ``lrw_video``'s sync head
([2784, 513] x [513, 8 x 320], bf16): ``ms``, its own kernel's device time
and that of all the call's device kernels (the features' pad copy
included), beside ``cross_entropy(addmm)``. Last, the card's name and power
limit. ``--sweep`` (for this checkout only) adds K3's and K4's device time
at each shape over ``SWEEP_STRIPS`` strips beside the count the wrapper
picks.
"""

import argparse
import os
import subprocess
import sys

# the kernels' device function names, old and new
OWN = {"K3": ("stats_fwd", "sum_strips"), "K4": ("stats_bwd", "sum_strips"),
       "K1": ("sync_ce_kernel",)}
PEAK_BYTES = 3.35e12
# K3/K4 grids for --sweep: 1, 2, 3, 4, 6 and 8 blocks a SM of the H100's 132
SWEEP_STRIPS = (132, 264, 396, 528, 792, 1056)
K1_SHAPE = (29 * 96, 513, 8, 320)   # lrw_video: rows, D, slots, V


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.join(os.path.dirname(__file__), "..", ".."))
    ap.add_argument("--label", default="")
    ap.add_argument("--sweep", action="store_true",
                    help="also time K3 and K4 at the strip counts SWEEP_STRIPS")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    import syncvsr_tpu_torch
    from syncvsr_tpu_torch.ops import cuda_bn, cuda_sync
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
    cuda_ms = lambda fn: chip_smoke.cuda_ms(torch, fn)   # noqa: E731

    def device_ms(fn, names, iters=20):
        """(own ms, own kernels, all ms, all kernels) a call."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        every = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                 and e.self_device_time_total > 0]
        own = [e for e in every if any(k in e.key for k in names)]
        return tuple(f(evs) / iters for evs in (own, every) for f in (
            lambda evs: sum(e.self_device_time_total for e in evs) / 1e3,
            lambda evs: sum(e.count for e in evs)))

    def show(what, row, extra=""):
        print(f"{label} {what}: " + " ".join(f"{k} {v:.5f}" for k, v in row.items()
                                             if v is not None) + extra, flush=True)

    g = torch.Generator(device=dev).manual_seed(1)

    def bn_case(n, c):
        x = (torch.randn(n, c, device=dev, generator=g) * 2 + 0.5).to(torch.bfloat16)
        gy = torch.randn(n, c, device=dev, generator=g).to(torch.bfloat16)
        mean = x.float().mean(0)
        inv = torch.rsqrt(x.float().var(0, unbiased=False) + 1e-5)
        return x, gy, mean, inv

    launches = {}
    for path, shapes in chip_smoke.bn_shapes().items():
        for n, c, k in shapes:
            launches.setdefault((n, c), {})[path] = k
    # every CUDA-event timing first, then the profiler windows: a process
    # that torch.profiler has traced can pay more host time a launch afterwards
    calls = []
    for (n, c), per_step in sorted(launches.items()):
        x, gy, mean, inv = bn_case(n, c)
        for name, kern, lib, nbytes in (
                ("K3", lambda x=x: cuda_bn.bn_stats(x),
                 lambda x=x: torch.batch_norm_stats(x, 1e-5), n * c * 2 + 2 * c * 4),
                ("K4", lambda a=(gy, x, mean, inv): cuda_bn.bn_bwd_stats(*a),
                 lambda a=(gy, x, mean, inv): torch.batch_norm_backward_reduce(
                     *a, None, True, False, False),
                 2 * n * c * 2 + 4 * c * 4)):
            row = {"ms": cuda_ms(kern), "device_ms": None, "library_ms": cuda_ms(lib),
                   "library_device_ms": None, "bound_ms": nbytes / PEAK_BYTES * 1e3}
            calls.append((name, n, c, per_step, kern, lib, row))

    # K1 at lrw_video's sync head
    kn, kd, ks, kv = K1_SHAPE
    xb = torch.randn(kn, kd, device=dev, generator=g).to(torch.bfloat16)
    wb = (torch.randn(kd, ks * kv, device=dev, generator=g) * 0.05).to(torch.bfloat16)
    bias = torch.randn(ks * kv, device=dev, generator=g) * 0.1
    tok = torch.randint(0, kv, (kn, ks), device=dev, generator=g, dtype=torch.int32)
    tok[torch.rand(kn, ks, device=dev, generator=g) < 0.1] = -1
    k1_args = (xb, wb, bias, tok)
    b16, tok_l = bias.to(torch.bfloat16), tok.reshape(-1).long()

    def k1_lib():
        return torch.nn.functional.cross_entropy(
            torch.addmm(b16, xb, wb).reshape(kn * ks, kv).float(), tok_l, ignore_index=-1,
            reduction="sum")

    k1_row = {"ms": cuda_ms(lambda: cuda_sync.sync_ce_mono_partials(*k1_args)),
              "library_ms": cuda_ms(k1_lib)}

    def k1_window():
        own, own_n, every, every_n = device_ms(
            lambda: cuda_sync.sync_ce_mono_partials(*k1_args), OWN["K1"])
        k1_row.update(device_ms=every, own_device_ms=own,
                      library_device_ms=device_ms(k1_lib, ("",))[2])
        show(f"K1 [{kn}, {kd}] x [{kd}, {ks}x{kv}]", k1_row,
             f" ({own_n:.0f} own and {every_n:.0f} device kernels a call)")

    totals = {}
    for name, n, c, per_step, kern, lib, row in calls:
        row["device_ms"], kernels_a_call, _, _ = device_ms(kern, OWN[name])
        row["library_device_ms"] = device_ms(lib, ("",))[2]
        show(f"{name} [{n}, {c}] per step {per_step}", row,
             f" ({kernels_a_call:.0f} kernels a call)")
        for path, k in per_step.items():
            t = totals.setdefault((name, path), dict.fromkeys(row, 0.0))
            for key, val in row.items():
                t[key] += k * val
    del calls
    torch.cuda.empty_cache()
    for (name, path), t in sorted(totals.items()):
        show(f"{name} per step of {path}", t)
    k1_window()
    if args.sweep:
        # K3's and K4's device time at other strip counts than the wrapper's:
        # the evidence for fwd_geometry's and bwd_geometry's rules
        for (n, c) in sorted(launches):
            x, gy, mean, inv = bn_case(n, c)
            for name, geometry, run in (
                    ("K3", cuda_bn.fwd_geometry,
                     lambda strips: cuda_bn.bn_stats(x, strips=strips)),
                    ("K4", cuda_bn.bwd_geometry,
                     lambda strips: cuda_bn.bn_bwd_stats(gy, x, mean, inv, strips=strips))):
                chosen_strips = geometry(n, c, 2)["strips"]
                for strips in sorted({chosen_strips, *SWEEP_STRIPS}):
                    if strips > n:
                        continue
                    ms = device_ms(lambda: run(strips), OWN[name])[0]
                    print(f"{label} sweep {name} [{n}, {c}] strips {strips}"
                          f"{' (chosen)' if strips == chosen_strips else ''}: device_ms "
                          f"{ms:.5f}", flush=True)
            del x, gy
            torch.cuda.empty_cache()
    print(f"{label} on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

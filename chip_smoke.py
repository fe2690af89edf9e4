#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``syncvsr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout. Phases, in order; any failure exits
non-zero before the last line is printed:

1. device: a CUDA card is required (there is no CPU path); prints its name
   and power limit;
2. build: compiles the hand-written kernels (``syncvsr_tpu_torch/csrc``)
   with nvcc for sm_90a, one process per source, and prints ptxas's
   registers / shared memory / spills;
3. kernels: each kernel against its plain PyTorch version at the shapes
   its train steps give it (K1 at ``lrw_video``'s and ``lrw_landmark``'s
   sync heads and at ``MONO_CASES``, K2 at ``lrs3``'s and ``lrs3_audio``'s
   and at ``SPLIT_CASES``, K3/K4 at every BatchNorm shape of the three
   steps that have them and at ``BN_EXTRA``; each twice, bitwise), with
   its time (``ms``: CUDA events around 20 warm back-to-back calls of the
   wrapper, host included) beside its bound, the plain version's time and
   one PyTorch library call's, per path; K3/K4 per shape too;
4. reference, for each path: two train steps of a small f32 model on the
   card (through the kernels) against the same steps on the CPU (the plain
   versions): ``lrw_video``, ``lrs3`` (a 768-wide Conformer, so the sync
   head takes K2), ``lrw_landmark`` (the pad sentinel in some frames) and
   ``lrs3_audio`` (768 wide, 10240 samples a clip): the metrics and Adam's
   first moment, less the ReLU units whose input f32 rounding put on the
   other side of 0;
5. train, for each path: the full-width train step (``lrw_video``: batch
   96, 29 uint8 96x112 frames; ``lrs3``: batch 8, 160 uint8 128x128 frames,
   12-layer Conformer + 6-layer decoder; ``lrw_landmark``: batch 1024, 29
   frames of 1434 f32 landmark features, 8 x 320 LayerNorm/GELU encoder;
   ``lrs3_audio``: batch 32, 102400 samples of waveform, ResNet1D then
   ``lrs3``'s Conformer and decoder; bf16, augmentation and dropout as
   configured), 3 warm-up and two windows of 5 timed steps with the
   kernels' launches counted from 0, then one eval step; the audio stem
   conv timed alone;
6. profiler windows, after every timing above (a process that torch.profiler
   has traced can pay more host time a launch from then on): each kernel's
   own device time (``device_ms``) over the calls phase 3 timed (K1's with
   its features' pad copy), each held to one kernel of its own a call (K3
   and K4 to one device kernel); with ``--profile DIR``, 3 profiled steps of
   each path (device time by kernel group and the device's idle share);
   then K4 at the Conformer's shape timed again, beside its phase-3 time;
7. the ``kernels`` JSON line, the card line and the ``ok`` line.
"""

import json
import math
import subprocess
import sys
import time

WARMUP_STEPS = 3
TIMED_STEPS = 5      # per window; two windows
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# them, device memory
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def library_ms(torch, fn, what):
    """Time of a PyTorch library call used as a yardstick, or None (with the
    reason printed) where this PyTorch build refuses it."""
    try:
        return cuda_ms(torch, fn)
    except (RuntimeError, TypeError, AttributeError) as e:
        log(f"  library yardstick {what} unavailable: {e}")
        return None


def bound_ms(flops, peak_flops, nbytes):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def trunk_bn_shapes(cfg, frames):
    """(N, C, launches per step) of every BatchNorm statistics call of the
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


def lrw_video_cfg():
    from syncvsr_tpu_torch.config import lrw_video_config

    return lrw_video_config()   # bs 96, 29 frames, crop 96, 12 x 512 (+1) encoder, bf16


LRS3_FRAMES, LRS3_LABEL_LEN, LRS3_SOURCE = 160, 48, 128


def lrs3_cfg():
    from syncvsr_tpu_torch.config import lrs3_config

    # the JAX bench's single-chip bucket: bs 8 x 160 frames, 12 x 768 Conformer,
    # 6 x 768 decoder, 5049 labels, bf16
    return lrs3_config().override(**{"data.batch_size": 8})


def lrw_landmark_cfg():
    from syncvsr_tpu_torch.config import lrw_landmark_config

    # bench.py::bench_landmark's workload: bs 1024 x 29 frames of 1434 f32
    # landmark features, 8 x 320 LayerNorm/GELU encoder, 4 heads, bf16
    return lrw_landmark_config()


AUDIO_FRAMES, AUDIO_LABEL_LEN = 160, 48      # 160 x 640 = 102400 samples a clip


def lrs3_audio_cfg():
    from syncvsr_tpu_torch.config import lrs3_audio_config

    # bench.py::bench_audio's workload: bs 32 x 102400 samples of 16 kHz
    # waveform, the Conv1D ResNet-18 frontend, then lrs3's Conformer, decoder
    # and losses, bf16
    return lrs3_audio_config().override(**{"data.batch_size": 32})


def resnet1d_bn_shapes(cfg, frames):
    """(N, C, launches per step) of every BatchNorm statistics call of the
    ResNet1D audio frontend over ``frames`` frames (640 samples each) a clip:
    the stem BN and layer1's four, then the five of each of layer2..layer4,
    each at half the samples of the one before."""
    n = cfg.data.batch_size * frames * 640 // 4          # stem stride 4
    width = cfg.model.frontend.resnet_width
    return [(n >> i, width * 2 ** i, 5) for i in range(4)]


def bn_shapes():
    """Per path with BatchNorms, (N, C, launches per step) of every
    BatchNorm statistics call (``lrw_landmark`` has none)."""
    lrw, lrs3, audio = lrw_video_cfg(), lrs3_cfg(), lrs3_audio_cfg()

    def conformer(cfg, frames):
        return (cfg.data.batch_size * frames, cfg.model.encoder.dim, cfg.model.encoder.layers)

    return {"lrw_video": trunk_bn_shapes(lrw, lrw.data.num_frames),
            "lrs3": trunk_bn_shapes(lrs3, LRS3_FRAMES) + [conformer(lrs3, LRS3_FRAMES)],
            "lrs3_audio": (resnet1d_bn_shapes(audio, AUDIO_FRAMES)
                           + [conformer(audio, AUDIO_FRAMES)])}


def device_ms(torch, fn, names, iters=20):
    """(ms, own launches per call, device kernels per call, source, all
    ms): the device time per call of the kernels whose names hold one of
    ``names``, with no host time in it, from a torch.profiler window over
    ``iters`` warm calls, and that of all the call's device kernels. Where
    the profiler traces no device time, both times are that of CUDA-graph
    replay of the call (all the kernels it makes) and the launch counts are
    None; so it is where the window traced some of the calls' kernels and
    not others."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    key = ("self_device_time_total" if avgs and hasattr(avgs[0], "self_device_time_total")
           else "self_cuda_time_total")
    dev_events = [e for e in avgs if e.device_type == DeviceType.CUDA and getattr(e, key) > 0]
    own = [e for e in dev_events if any(n in e.key for n in names)]
    # a window that lost kernel records counts a fraction of a launch a call
    if own and sum(e.count for e in own) % iters == 0:
        return (sum(getattr(e, key) for e in own) / 1e3 / iters,
                sum(e.count for e in own) / iters,
                sum(e.count for e in dev_events) / iters, "profiler",
                sum(getattr(e, key) for e in dev_events) / 1e3 / iters)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(torch, graph.replay, iters)
    return ms, None, None, "graph replay", ms


# K1's cases (N, D, V, every token ignored, the features' dtype):
# lrw_video's and lrw_landmark's shapes first (timed; the landmark head's
# features reach the wrapper in f32, as in its step), then ragged row
# counts, D = 512 and 640 (bf16 rows TMA reads as they lie) and 520 (no
# copy, a ragged last stage), vocabularies below the 320 columns a block
# holds, and no valid token
MONO_CASES = [(29 * 96, 513, 320, False, "bfloat16"), (29 * 1024, 320, 320, False, "float32"),
              (1000, 513, 320, False, "bfloat16"), (33, 513, 320, False, "bfloat16"),
              (1, 513, 320, False, "bfloat16"), (1000, 320, 320, False, "float32"),
              (33, 320, 320, False, "float32"), (29 * 96, 512, 320, False, "bfloat16"),
              (29 * 96, 520, 320, False, "bfloat16"), (29 * 96, 640, 320, False, "bfloat16"),
              (29 * 96, 513, 256, False, "bfloat16"), (29 * 1024, 320, 256, False, "float32"),
              (29 * 96, 513, 320, True, "bfloat16")]
# K2's cases: lrs3's and lrs3_audio's shapes first (timed; the audio head's
# features in f32, as in its step), then ragged row counts, a D that is no
# multiple of the 64-deep stage, a vocabulary below the 320 columns a block
# holds, and no valid token
SPLIT_CASES = [(8 * 160, 768, 320, False, "bfloat16"), (32 * 160, 768, 320, False, "float32"),
               (1000, 768, 320, False, "bfloat16"), (33, 768, 320, False, "bfloat16"),
               (1, 768, 320, False, "bfloat16"), (8 * 160, 776, 320, False, "bfloat16"),
               (8 * 160, 768, 256, False, "bfloat16"), (8 * 160, 768, 320, True, "bfloat16")]
# the case of each path's sync head, timed: the entry's own numbers are its
# first path's
SYNC_PATHS = {"sync_ce_fwd": {"lrw_video": MONO_CASES[0], "lrw_landmark": MONO_CASES[1]},
              "sync_ce_split_fwd": {"lrs3": SPLIT_CASES[0], "lrs3_audio": SPLIT_CASES[1]}}


def check_sync(torch, dev, kind, later):
    """K1 (``kind`` "mono", at ``MONO_CASES``) or K2 ("split", at
    ``SPLIT_CASES``) against their plain version, and twice on the same
    inputs, bitwise; each path's case of ``SYNC_PATHS`` timed. Appends to
    ``later`` the profiler windows that fill each path's ``device_ms`` (K1's
    with its features' pad copy, K2's with their cast)."""
    from syncvsr_tpu_torch.ops import cuda_sync

    s = 8                                        # A*G slots of the vq codec
    if kind == "mono":
        name, fn, own = "K1 sync_ce_fwd", cuda_sync.sync_ce_mono_partials, "sync_ce_kernel"
        cases = MONO_CASES
    else:
        name, fn, own = ("K2 sync_ce_split_fwd", cuda_sync.sync_ce_split_partials,
                         "sync_ce_split_kernel")
        cases = SPLIT_CASES
    key = name.split()[1]
    timed = {case: path for path, case in SYNC_PATHS[key].items()}
    # every K1 case is K1's by the dispatch rule; K2's are its by the call
    # (the rule gives V = 256 at D = 768 to K1)
    for _, d0, v0, _, _ in (cases if kind == "mono" else timed):
        if cuda_sync.uses_split_kernel(d0, s, v0) != (kind == "split"):
            raise AssertionError(f"{name}: the dispatch rule does not pick it at D={d0}, "
                                 f"V={v0}")
    g = torch.Generator(device=dev).manual_seed(0)
    worst, paths = 0.0, {}
    for case in cases:
        n, d, v, ignored, dtype = case
        w = torch.randn(d, s * v, device=dev, generator=g) * 0.05
        b = torch.randn(s * v, device=dev, generator=g) * 0.1
        x = torch.randn(n, d, device=dev, generator=g).to(getattr(torch, dtype))
        tok = torch.randint(0, v, (n, s), device=dev, generator=g, dtype=torch.int32)
        tok[torch.rand(n, s, device=dev, generator=g) < 0.1] = -1
        if ignored:
            tok.fill_(-1)
        wb = w.to(torch.bfloat16)                  # the kernel's weight type
        ce, cnt = fn(x, wb, b, tok)
        ce_p, cnt_p = cuda_sync.sync_ce_partials_plain(x, wb, b, tok)
        torch.cuda.synchronize()
        err = abs(float(ce) - float(ce_p))
        worst = max(worst, err)
        # same bf16 operands, f32 accumulation in other orders: ~1e-8
        # relative expected on sums of ~1e4 terms; 1e-5 leaves room (1e-6
        # absolute where the sum is 0)
        tol = 1e-5 * abs(float(ce_p)) if float(ce_p) else 1e-6
        log(f"{name} [{n}, {d}] {dtype} x [{d}, {s}x{v}]{' all ignored' if ignored else ''}: "
            f"ce_sum {float(ce):.6f} vs plain {float(ce_p):.6f}, |err| {err:.3e} (tol "
            f"{tol:.3e}); count {float(cnt):.0f} vs {float(cnt_p):.0f}")
        if not (err <= tol and float(cnt) == float(cnt_p) == float((tok >= 0).sum())):
            raise AssertionError(f"{name} disagrees with its plain version at N={n}, D={d}, "
                                 f"V={v}")
        again = fn(x, wb, b, tok)
        if not (torch.equal(again[0], ce) and torch.equal(again[1], cnt)):
            raise AssertionError(f"{name}: two calls on the same inputs differ at N={n}, "
                                 f"D={d}, V={v}")
        if case not in timed:
            continue
        args = (x, wb, b, tok)
        ms = cuda_ms(torch, lambda: fn(*args))
        plain = cuda_ms(torch, lambda: cuda_sync.sync_ce_partials_plain(*args))
        b16, tok_l = b.to(torch.bfloat16), tok.reshape(-1).long()
        lib = library_ms(torch, lambda: torch.nn.functional.cross_entropy(
            torch.addmm(b16, x.to(torch.bfloat16), wb).reshape(n * s, v).float(), tok_l,
            ignore_index=-1, reduction="sum"), "cross_entropy(addmm)")
        parts = -(-n // 32) * s if kind == "mono" else -(-n // 64) * s
        nbytes = (n * d * x.element_size() + d * s * v * 2 + s * v * 4 + n * s * 4
                  + parts * 2 * 4)
        bound, by = bound_ms(2 * n * d * s * v, PEAK_BF16_FLOPS, nbytes)
        log(f"  {timed[case]}: kernel_ms {ms:.5f}  plain_ms {plain:.5f}  library_ms {lib}  "
            f"bound_ms {bound:.5f} ({by})")
        row = paths[timed[case]] = {"n": n, "d": d, "features": dtype, "ms": ms,
                                    "device_ms": None, "plain_ms": plain, "bound_ms": bound,
                                    "bound_by": by, "library_ms": lib}

        def profiled(n=n, d=d, args=args, row=row):
            own_ms, own_calls, dev_calls, src, all_ms = device_ms(torch, lambda: fn(*args),
                                                                  (own,))
            log(f"{name} [{n}, {d}]: device_ms {all_ms:.5f}, its own kernel {own_ms:.5f} "
                f"({src}; {own_calls} own and {dev_calls} device kernels a call)")
            if own_calls not in (None, 1):
                raise AssertionError(f"{name}: {own_calls} kernel launches a call, expected 1")
            row["device_ms"] = all_ms
            if row is main:
                entry["device_ms"] = all_ms

        later.append(profiled)
    main = paths[next(iter(SYNC_PATHS[key]))]
    src, line = (("sync_ce.cu", 36) if kind == "mono" else ("sync_ce_split.cu", 66))
    entry = {"name": key, "route": "cuda", "source": f"syncvsr_tpu_torch/csrc/{src}",
             "replaces": f"syncvsr_tpu/ops/pallas_sync.py:{line}", "launches": 0,
             "max_abs_err": worst,
             **{k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
             "paths": paths}
    return entry


# K3's and K4's extra cases beside the paths' shapes: a ragged N, a
# one-strip call (its one group's fold writes the result), and the stem's
# shape on 2880 strips (5.5 waves of the last-block fold)
BN_EXTRA = [(1283, 768, None), (1, 768, None), (2949120, 64, 2880)]


def bn_inputs(torch, dev, n, c):
    """(x, g, mean, inv) of a BatchNorm at [n, c]: bf16 x and g from a seed
    of the shape, x's f32 batch mean and inverse standard deviation."""
    gen = torch.Generator(device=dev).manual_seed(1000 * n + c)
    x = (torch.randn(n, c, device=dev, generator=gen) * 2 + 0.5).to(torch.bfloat16)
    gy = torch.randn(n, c, device=dev, generator=gen).to(torch.bfloat16)
    x32 = x.float()
    return x, gy, x32.mean(0), torch.rsqrt(x32.var(0, unbiased=False) + 1e-5)


def check_bn(torch, dev, later):
    """K3 and K4 at every BatchNorm shape of the train steps that have
    them (``bn_shapes()``) and at ``BN_EXTRA``, in bf16; each twice on the
    same inputs, bitwise. Each entry's own times are per step of the lrs3
    step (the per-shape times weighted by the launches per step); ``paths``
    has every step's sums and their per-shape rows. Appends to ``later`` the profiler windows of every
    timed shape, then the job that fills the entries' ``device_ms``.
    Returns (the two entries, a function that times K4 at the Conformer's
    shape again)."""
    from syncvsr_tpu_torch.ops import cuda_bn

    paths = bn_shapes()
    path_shapes = {(n, c) for shapes in paths.values() for n, c, _ in shapes}
    cases = sorted((n, c, None) for n, c in path_shapes) + BN_EXTRA
    conformer = paths["lrs3"][-1][:2]
    measured = {}                                # (kind, n, c) -> per-shape numbers
    for n, c, strips in cases:
        timed = (n, c) in path_shapes and strips is None
        x, gy, mean, inv = bn_inputs(torch, dev, n, c)
        x32 = x.float()
        xhat_abs = ((x32 - mean) * inv).abs()
        fwd, bwd = ((lambda *a: cuda_bn.bn_stats(*a, strips=strips),
                     lambda *a: cuda_bn.bn_bwd_stats(*a, strips=strips)) if strips
                    else (cuda_bn.bn_stats, cuda_bn.bn_bwd_stats))
        # f32 sums of n values in other orders: the error is a small share
        # of the sum of magnitudes; 1e-5 of it leaves a 10x margin
        for kind, kern, plain, args, mags in (
                ("fwd", fwd, cuda_bn.bn_stats_plain, (x,),
                 (x32.abs().sum(0), (x32 * x32).sum(0))),
                ("bwd", bwd, cuda_bn.bn_bwd_stats_plain, (gy, x, mean, inv),
                 (gy.float().abs().sum(0), (gy.float().abs() * xhat_abs).sum(0)))):
            got = kern(*args)
            want = plain(*args)
            err = max(float((a - e).abs().max()) for a, e in zip(got, want))
            ratio = max(float(((a - e).abs() / (1e-5 * m + 1e-6)).max())
                        for a, e, m in zip(got, want, mags))
            name = "K3 bn_stats_fwd" if kind == "fwd" else "K4 bn_stats_bwd"
            how = f", {strips} strips" if strips else ""
            log(f"{name} [{n}, {c}] bf16{how}: max |err| {err:.3e}, worst err/tol {ratio:.3f}")
            if not ratio <= 1.0:
                raise AssertionError(f"{name} disagrees with its plain version at [{n}, {c}]")
            again = kern(*args)
            if not all(torch.equal(a, b) for a, b in zip(again, got)):
                raise AssertionError(f"{name}: two calls on the same inputs differ at "
                                     f"[{n}, {c}]")
            if not timed:
                measured[kind, n, c, strips] = {"max_abs_err": err}
                continue
            ms = cuda_ms(torch, lambda: kern(*args))
            plain_t = cuda_ms(torch, lambda: plain(*args))
            if kind == "fwd":
                lib = library_ms(torch, lambda: torch.batch_norm_stats(x, 1e-5),
                                 "batch_norm_stats")
                nbytes, flops = n * c * 2 + 2 * c * 4, 3 * n * c
            else:
                lib = library_ms(torch, lambda: torch.batch_norm_backward_reduce(
                    gy, x, mean, inv, None, True, False, False), "batch_norm_backward_reduce")
                nbytes, flops = 2 * n * c * 2 + 4 * c * 4, 5 * n * c
                if (n, c) == conformer:
                    retime = (lambda kern=kern, args=args: cuda_ms(torch, lambda: kern(*args)))
            bound, by = bound_ms(flops, PEAK_F32_FLOPS, nbytes)
            log(f"  kernel_ms {ms:.5f}  plain_ms {plain_t:.5f}  library_ms {lib}  "
                f"bound_ms {bound:.5f} ({by})")
            row = measured[kind, n, c, None] = {
                "max_abs_err": err, "ms": ms, "device_ms": None, "plain_ms": plain_t,
                "library_ms": lib, "bound_ms": bound, "bound_by": by}
            # the window makes its inputs again, so that none is held meanwhile
            later.append(lambda name=name, n=n, c=c, kind=kind, kern=kern, row=row:
                         profile_bn(torch, dev, name, n, c, kind, kern, row))
        del x, gy, mean, inv, x32, xhat_abs, args, mags, got, want
        torch.cuda.empty_cache()

    def per_step(kind, shapes):
        rows = [dict(measured[kind, n, c, None], n=n, c=c, launches_per_step=k)
                for n, c, k in shapes]

        def total(key):
            if any(r[key] is None for r in rows):
                return None
            return sum(r["launches_per_step"] * r[key] for r in rows)

        return {"launches_per_step": sum(r["launches_per_step"] for r in rows),
                "bound_by": rows[0]["bound_by"], "ms": total("ms"),
                "device_ms": total("device_ms"), "plain_ms": total("plain_ms"),
                "bound_ms": total("bound_ms"), "library_ms": total("library_ms"),
                "shapes": [{k: r[k] for k in ("n", "c", "launches_per_step", "ms",
                                              "device_ms", "bound_ms", "library_ms")}
                           for r in rows]}

    def entry(name, src_line, kind):
        errs = [m["max_abs_err"] for (k, *_), m in measured.items() if k == kind]
        by_path = {p: per_step(kind, shapes) for p, shapes in paths.items()}
        main = by_path["lrs3"]
        return {"name": name, "route": "cuda", "source": "syncvsr_tpu_torch/csrc/bn_stats.cu",
                "replaces": f"syncvsr_tpu/ops/pallas_bn.py:{src_line}", "launches": 0,
                "max_abs_err": max(errs), "ms": main["ms"], "device_ms": main["device_ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": main["library_ms"],
                "paths": by_path}

    entries = [{"name": "bn_stats_fwd"}, {"name": "bn_stats_bwd"}]

    def fill():
        entries[0].update(entry("bn_stats_fwd", 47, "fwd"))
        entries[1].update(entry("bn_stats_bwd", 68, "bwd"))

    later.append(fill)
    return entries, retime


def profile_bn(torch, dev, name, n, c, kind, kern, row):
    """K3's or K4's device time at [n, c] (``bn_inputs``) into ``row``; each
    must be one device kernel a call."""
    x, gy, mean, inv = bn_inputs(torch, dev, n, c)
    args = (x,) if kind == "fwd" else (gy, x, mean, inv)
    # the kernels' names, and those of K3's first two-kernel version, which
    # tools/bn_shapes.py --root may time in an older tree
    own = (("stats_fwd_fused", "stats_fwd_partial", "sum_strips") if kind == "fwd"
           else ("stats_bwd_fused",))
    dev_ms, own_calls, dev_calls, src, _ = device_ms(torch, lambda: kern(*args), own)
    log(f"{name} [{n}, {c}]: device_ms {dev_ms:.5f} ({src}; {own_calls} own and {dev_calls} "
        "device kernels a call)")
    if dev_calls not in (None, 1):
        raise AssertionError(f"{name} [{n}, {c}]: {dev_calls} device kernels a call, expected 1")
    row["device_ms"] = dev_ms


def counters():
    from syncvsr_tpu_torch.ops import cuda_bn, cuda_sync

    return {"sync_ce_fwd": cuda_sync.sync_ce_mono_partials,
            "sync_ce_split_fwd": cuda_sync.sync_ce_split_partials,
            "bn_stats_fwd": cuda_bn.bn_stats,
            "bn_stats_bwd": cuda_bn.bn_bwd_stats}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def relu_layers(model):
    """name -> the first layer of each ReLU feed-forward (the Conformer's
    and the decoder's): its output is the ReLU's input."""
    from syncvsr_tpu_torch.models.conformer import ConformerFeedForward
    from syncvsr_tpu_torch.models.decoder import FF

    return {f"{n}.w1": m.w1 for n, m in model.named_modules()
            if isinstance(m, (ConformerFeedForward, FF))}


def zero_gradient_leaves(model):
    """Leaves whose true gradient is 0: the key bias of attention without
    RoPE (the softmax cancels a per-query constant) and the depthwise
    conv's bias (the train-mode BatchNorm after it subtracts the mean)."""
    from syncvsr_tpu_torch.models.conformer import ConvModule, RelPositionAttention
    from syncvsr_tpu_torch.models.decoder import MHA

    return ({f"{n}.wk.bias" for n, m in model.named_modules()
             if isinstance(m, (RelPositionAttention, MHA))}
            | {f"{n}.dw.bias" for n, m in model.named_modules() if isinstance(m, ConvModule)})


def run_steps(torch, cfg, batch_np, device, n_steps, aug_fn):
    """Build the model on ``device`` (the same seeded weights on every
    device) and run ``n_steps`` train steps; returns (state, metrics of
    each step, {ReLU layer: its output in each step, on the CPU})."""
    from syncvsr_tpu_torch.engine import build_train_step, create_train_state
    from syncvsr_tpu_torch.models import build_model

    model = build_model(cfg, device=device)
    relu_in = {}
    for name, layer in relu_layers(model).items():
        layer.register_forward_hook(lambda m, i, o, name=name: relu_in.setdefault(
            name, []).append(o.detach().cpu()))
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}
    state = create_train_state(cfg, model, batch, device=device)
    step = build_train_step(aug_fn=aug_fn)
    out = []
    for _ in range(n_steps):
        state, m = step(state, batch)
        out.append({k: float(v) for k, v in m.items()})
    return state, out, relu_in


def relu_flips(cpu_in, gpu_in):
    """Where f32 rounding leaves a ReLU's input on the other side of 0 on
    the card than on the CPU, that unit's row of the first layer's gradient
    (and its bias entry) differs by a whole term. Returns ({leaf: units to
    leave out of the gradient comparison}, the number of flips, the largest
    |input| that flipped as a share of its layer's largest)."""
    skip, flips, worst = {}, 0, 0.0
    for name, steps in cpu_in.items():
        for hc, hg in zip(steps, gpu_in[name]):
            flip = (hc > 0) != (hg > 0)
            if not bool(flip.any()):
                continue
            flips += int(flip.sum())
            worst = max(worst, float(hc[flip].abs().max()) / float(hc.abs().max()))
            units = flip.reshape(-1, flip.shape[-1]).any(0).nonzero()[:, 0].tolist()
            for leaf in (f"{name}.weight", f"{name}.bias"):
                skip.setdefault(leaf, set()).update(units)
    return skip, flips, worst


def uint8_clips(np, cfg, seed):
    """word_batch with uint8 clips [B, T, crop, crop * 112 / 96, 1], the
    shape of the LRW pipeline's frames."""
    from syncvsr_tpu_torch.data.synthetic import word_batch

    batch = word_batch(cfg, seed=seed)
    b, t, h = cfg.data.batch_size, cfg.data.num_frames, cfg.data.crop_size
    rng = np.random.RandomState(seed + 1)
    batch["inputs"] = rng.randint(0, 256, (b, t, h, h * 112 // 96, 1)).astype(np.uint8)
    return batch


def uint8_sentences(np, cfg, frames, label_len, source, seed):
    """sentence_batch with uint8 clips [B, T, source, source, 1], the face
    crops of the LRS3 preprocessing (RandomResizedCrop to the crop size in
    the step)."""
    from syncvsr_tpu_torch.data.synthetic import sentence_batch

    batch = sentence_batch(cfg, num_frames=frames, label_len=label_len, seed=seed)
    rng = np.random.RandomState(seed + 1)
    batch["videos"] = rng.randint(
        0, 256, (cfg.data.batch_size, frames, source, source, 1)).astype(np.uint8)
    return batch


def landmark_clips(cfg, seed):
    """word_batch (f32 landmark features [B, T, 1434]) with the loader's pad
    sentinel, -100, in the last 3 frames of every 8th clip."""
    from syncvsr_tpu_torch.data.synthetic import word_batch

    batch = word_batch(cfg, seed=seed)
    batch["inputs"][::8, -3:] = -100.0
    return batch


# the paths, in the order the phases run them, and the kernels each runs
# (the others must not launch there)
PATH_KERNELS = {"lrw_video": {"sync_ce_fwd", "bn_stats_fwd", "bn_stats_bwd"},
                "lrs3": {"sync_ce_split_fwd", "bn_stats_fwd", "bn_stats_bwd"},
                "lrw_landmark": {"sync_ce_fwd"},
                "lrs3_audio": {"sync_ce_split_fwd", "bn_stats_fwd", "bn_stats_bwd"}}


def check_reference(torch, np, path):
    """Two f32 train steps of a small model through the kernels on the card
    against the same steps through the plain versions on the CPU. The
    augmentation (and CutMix) draw from the same CPU generator on both
    sides; dropout is off."""
    from syncvsr_tpu_torch import config
    from syncvsr_tpu_torch.data.synthetic import sentence_batch
    from syncvsr_tpu_torch.ops.image import build_sentence_aug, build_word_aug

    common = {"model.dtype": "float32", "model.encoder.msa_dropout": 0.0,
              "model.encoder.mlp_dropout": 0.0, "data.crop_size": 32,
              "optim.total_steps": 10, "optim.warmup_steps": 2}
    word_keys = ("loss", "loss_word", "loss_audio", "grad_norm", "learning_rate")
    sentence_keys = ("loss", "loss_ctc", "loss_att", "loss_audio", "grad_norm",
                     "learning_rate")
    word = {"model.encoder.layers": 2, "model.encoder.dim": 64, "model.encoder.heads": 2,
            "model.encoder.emb_dropout": 0.0, "data.batch_size": 4, "data.num_frames": 8}
    # small but for the Conformer's width, 768, which keeps the sync head on
    # K2; the 64-wide decoder takes proj_decoder
    sentence = {"model.encoder.layers": 2, "model.encoder.dim": 768,
                "model.encoder.heads": 12, "model.frontend.resnet_width": 16,
                "model.decoder.layers": 1, "model.decoder.dim": 64, "model.decoder.heads": 4,
                "model.decoder.hidden": 128, "model.decoder.dropout": 0.0,
                "model.labels": 101, "data.batch_size": 4}
    aug = None
    if path == "lrw_video":
        cfg = config.lrw_video_config().override(
            **common, **word, **{"model.frontend.resnet_width": 16})
        batch = uint8_clips(np, cfg, seed=3)
        aug = build_word_aug(cfg.data)
        keys = word_keys
    elif path == "lrw_landmark":
        # 1434 landmark features, the -100 pad sentinel in two clips' last
        # frames; CutMix on, drop-path off
        cfg = config.lrw_landmark_config().override(
            **common, **word, **{"model.encoder.droppath": 0.0})
        batch = landmark_clips(cfg, seed=3)
        keys = word_keys
    elif path == "lrs3":
        cfg = config.lrs3_config().override(**common, **sentence)
        # 16 frames, clips of >= 8: labels of <= 4 keep every CTC alignment feasible
        batch = uint8_sentences(np, cfg, 16, 4, 40, seed=3)
        aug = build_sentence_aug(cfg.data)
        keys = sentence_keys
    else:
        # 16 frames of 640 samples, clips of >= 8 frames, as lrs3's
        cfg = config.lrs3_audio_config().override(**common, **sentence)
        batch = sentence_batch(cfg, num_frames=16, label_len=4, seed=3)
        keys = sentence_keys
    cpu_state, cpu_m, cpu_relu = run_steps(torch, cfg, batch, "cpu", 2, aug)
    before = read_counts()
    gpu_state, gpu_m, gpu_relu = run_steps(torch, cfg, batch, "cuda", 2, aug)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in read_counts().items()}
    log(f"reference {path}: 2 f32 steps of a small model, card vs CPU; launches {launched}")
    log(f"  card step 1: {gpu_m[0]}")
    log(f"  cpu  step 1: {cpu_m[0]}")
    for k, n in launched.items():
        if (n > 0) != (k in PATH_KERNELS[path]):
            raise AssertionError(f"reference {path}: launches {launched}, expected exactly "
                                 f"{sorted(PATH_KERNELS[path])}")
    # f32 on both sides with TF32 off. K1/K2 round the sync head's operands
    # to bf16 where the CPU head stays f32 (as on the TPU and CPU in the JAX
    # package), which moves loss_audio by ~1e-4 relative; the rest are f32
    # sums in other orders
    worst = 0.0
    for i, (a, e) in enumerate(zip(gpu_m, cpu_m)):
        for k in keys:
            rel = abs(a[k] - e[k]) / max(abs(e[k]), 1e-12)
            worst = max(worst, rel)
            if not (math.isfinite(a[k]) and rel <= 2e-3):
                raise AssertionError(f"{path} step {i + 1} {k}: card {a[k]} vs CPU {e[k]}")
    # Adam's first moment holds every (clipped) gradient of both steps; the
    # backward is f32 on both sides, so it agrees to f32 noise, held at
    # 2e-3 of each leaf's largest element. Two kinds of entries are held
    # apart: the ReLU units whose input flipped sign (relu_flips: only
    # inputs within rounding of 0 may flip, and only a few), and the leaves
    # whose true gradient is 0, which must hold rounding noise on both sides
    skip, flips, flip_size = relu_flips(cpu_relu, gpu_relu)
    log(f"  ReLU inputs that changed sign: {flips}, the largest {flip_size:.2e} of its "
        f"layer's largest; rows left out: { {k: sorted(v) for k, v in skip.items()} }")
    if flips > 4 or flip_size > 1e-5:
        raise AssertionError(f"{path}: {flips} ReLU inputs changed sign, up to {flip_size} "
                             "of their layer's largest: more than f32 rounding")
    zero = zero_gradient_leaves(cpu_state.model)
    top = max(float(c_mu.abs().max()) for c_mu in cpu_state.mu)
    ratios, noise = [], 0.0
    for name, g_mu, c_mu in zip(cpu_state.names, gpu_state.mu, cpu_state.mu):
        g_mu = g_mu.cpu()
        if name in zero:
            noise = max(noise, float(g_mu.abs().max()) / top, float(c_mu.abs().max()) / top)
            continue
        keep = torch.ones(c_mu.shape[0], dtype=torch.bool)
        keep[sorted(skip.get(name, ()))] = False
        sc = float(c_mu[keep].abs().max())
        if sc > 0:
            ratios.append((float((g_mu - c_mu)[keep].abs().max()) / sc, name, sc))
    ratios.sort(reverse=True)
    mu_ratio = ratios[0][0]
    log(f"  worst metric rel err {worst:.3e}; worst Adam mu err / leaf scale {mu_ratio:.3e}; "
        "worst leaves " + ", ".join(f"{n} {r:.2e} (scale {sc:.2e})" for r, n, sc in ratios[:4])
        + f"; {len(zero)} zero-gradient leaves hold up to {noise:.2e} of the largest leaf")
    if not mu_ratio <= 2e-3:
        raise AssertionError(f"{path}: gradients disagree: mu err / scale {mu_ratio}")
    if not noise <= 1e-6:
        raise AssertionError(f"{path}: a leaf whose true gradient is 0 holds {noise} of the "
                             "largest leaf's Adam moment")


def train_full_width(torch, np, path, profile_dir=None):
    """The full-width train step of ``path``; returns (launches in the timed
    steps, summary, the profiled window to run after every timing, or
    None without ``profile_dir``)."""
    from syncvsr_tpu_torch.data.synthetic import sentence_batch
    from syncvsr_tpu_torch.engine import build_eval_step, build_train_step, create_train_state
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.ops import image

    aug = transform = None
    near_ln = {}
    if path == "lrw_video":
        cfg = lrw_video_cfg()
        batch_np = uint8_clips(np, cfg, seed=0)
        frames, video = cfg.data.num_frames, "inputs"
        aug, transform = image.build_word_aug(cfg.data), image.build_eval_transform(cfg.data)
        near_ln["loss_word"] = cfg.model.labels
        per_step = {"sync_ce_fwd": 1, "sync_ce_split_fwd": 0,
                    "bn_stats_fwd": 20, "bn_stats_bwd": 20}
    elif path == "lrs3":
        cfg = lrs3_cfg()
        batch_np = uint8_sentences(np, cfg, LRS3_FRAMES, LRS3_LABEL_LEN, LRS3_SOURCE, seed=0)
        frames, video = LRS3_FRAMES, "videos"
        aug = image.build_sentence_aug(cfg.data)
        transform = image.build_sentence_eval_transform(cfg.data)
        # 20 in the frontend's trunk, 12 in the Conformer's conv modules
        per_step = {"sync_ce_fwd": 0, "sync_ce_split_fwd": 1,
                    "bn_stats_fwd": 32, "bn_stats_bwd": 32}
    elif path == "lrw_landmark":
        # no augmentation function (bench.py::bench_landmark); CutMix,
        # dropout and drop-path as configured
        cfg = lrw_landmark_cfg()
        batch_np = landmark_clips(cfg, seed=0)
        frames, video = cfg.data.num_frames, "inputs"
        near_ln["loss_word"] = cfg.model.labels
        per_step = {"sync_ce_fwd": 1, "sync_ce_split_fwd": 0,
                    "bn_stats_fwd": 0, "bn_stats_bwd": 0}
    else:
        # no augmentation function (bench.py::bench_audio); lengths in samples
        cfg = lrs3_audio_cfg()
        batch_np = sentence_batch(cfg, num_frames=AUDIO_FRAMES, label_len=AUDIO_LABEL_LEN,
                                  seed=0)
        frames, video = AUDIO_FRAMES, "videos"
        # 20 in ResNet1D, 12 in the Conformer's conv modules
        per_step = {"sync_ce_fwd": 0, "sync_ce_split_fwd": 1,
                    "bn_stats_fwd": 32, "bn_stats_bwd": 32}
    near_ln["loss_audio"] = cfg.model.codec.audio_vocab_size
    dev = torch.device("cuda")
    # what the process holds before this path (the other path's state, kept
    # for its profiled window) is left out of this path's peak
    held = torch.cuda.memory_allocated()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    b = cfg.data.batch_size
    enc = cfg.model.encoder
    log(f"train: {path}, {video} {tuple(batch[video].shape)} {batch[video].dtype}, "
        f"{enc.kind} {enc.layers} layers, dim {enc.dim}, dtype {cfg.model.dtype}")
    model = build_model(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    state = create_train_state(cfg, model, batch)
    step = build_train_step(aug_fn=aug)
    first = None
    for i in range(WARMUP_STEPS):
        state, m = step(state, batch)
        if first is None:
            first = {k: float(v) for k, v in m.items()}
    torch.cuda.synchronize()
    log(f"  {n_params} parameters; first step {first}")
    # random init: the heads start near ln(classes)
    for k, classes in near_ln.items():
        if not abs(first[k] - math.log(classes)) < 1.0:
            raise AssertionError(f"first-step {k} {first[k]} is far from "
                                 f"ln {classes} = {math.log(classes):.3f}")
    if not all(math.isfinite(v) for v in first.values()):
        raise AssertionError(f"non-finite first-step metrics: {first}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    windows = []
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / TIMED_STEPS)
    dt = sum(windows) / len(windows)
    launches = read_counts()
    last = {k: float(v) for k, v in m.items()}
    peak = torch.cuda.max_memory_allocated() - held
    if not all(math.isfinite(v) for v in last.values()):
        raise AssertionError(f"non-finite metrics: {last}")
    want = {k: n * TIMED_STEPS * len(windows) for k, n in per_step.items()}
    log(f"  {TIMED_STEPS * len(windows)} timed steps: {dt * 1e3:.2f} ms/step (windows of "
        f"{TIMED_STEPS}: {', '.join(f'{w * 1e3:.2f}' for w in windows)} ms/step), "
        f"{b * frames / dt:.1f} frames/s, peak memory {peak / 2**30:.2f} GiB (above "
        f"{held / 2**30:.2f} GiB held before the path); last step {last}")
    log(f"  launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{path}: launches {launches} != {want}")
    before = read_counts()
    ev = build_eval_step()(state, transform(batch) if transform else batch)
    ev = {k: float(v) for k, v in ev.items()}
    torch.cuda.synchronize()
    log(f"  eval step: {ev}")
    if not all(math.isfinite(v) for v in ev.values()):
        raise AssertionError(f"non-finite eval metrics: {ev}")
    sync = "sync_ce_fwd" if cfg.model.task == "word" else "sync_ce_split_fwd"
    got = {k: v - before[k] for k, v in read_counts().items() if k.startswith("sync")}
    if got != {k: int(k == sync) for k in got}:
        raise AssertionError(f"the {path} eval step launched {got}, expected one {sync}")
    summary = {"step_ms": dt * 1e3, "frames_per_s": b * frames / dt, "peak_bytes": peak,
               "launches_per_step": per_step}
    if cfg.model.frontend.kind == "conv1d_resnet":
        summary["stem_conv"] = time_stem_conv(torch, state.model, batch[video])
    window = None
    if profile_dir:
        def window():
            profile_steps(torch, state, step, batch, profile_dir, path, dt)
    return launches, summary, window


def time_stem_conv(torch, model, audio):
    """The ResNet1D stem conv alone (C_in 1, k 80, stride 4) on the path's
    waveform, in CUDA events: its forward, and its forward with the weight
    gradient (the waveform needs none), beside the forward's bound."""
    stem = model.frontend.resnet1d.stem_conv
    x = audio[..., None].to(stem.dtype)
    y = stem(x)
    gy = torch.randn_like(y)
    fwd = cuda_ms(torch, lambda: stem(x))
    fwd_wgrad = cuda_ms(torch, lambda: torch.autograd.grad(stem(x), stem.weight, gy))
    c_out, _, k = stem.weight.shape
    bound, by = bound_ms(2 * y.numel() * k, PEAK_BF16_FLOPS,
                         (x.numel() + y.numel()) * x.element_size())
    log(f"  stem conv {tuple(x.shape)} -> {tuple(y.shape)} (k {k}, stride 4, C_in 1, "
        f"{x.dtype}): forward {fwd:.5f} ms (bound {bound:.5f}, {by}), forward + weight "
        f"gradient {fwd_wgrad:.5f} ms")
    return {"forward_ms": fwd, "forward_weight_grad_ms": fwd_wgrad, "forward_bound_ms": bound}


# device-time groups of the profile, matched in order on the kernel's name
KERNEL_GROUPS = (
    ("port kernels", ("sync_ce_kernel", "sync_ce_split_kernel", "stats_fwd_fused",
                      "stats_bwd_fused")),
    ("convolution", ("conv", "cudnn", "implicit", "fprop", "dgrad", "wgrad")),
    ("matmul", ("gemm", "cutlass", "xmma", "sm90_")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("reduction", ("reduce",)),
)


def profile_steps(torch, state, step, batch, out_dir, path, step_s, n=3):
    """``n`` train steps under torch.profiler: device time by kernel group
    and the top kernels, beside the unprofiled step time ``step_s`` (the
    device's idle share is 1 - device time / step time). The full table goes
    to ``out_dir/profile_<path>.txt``. One step first, unprofiled, lets the
    allocator take back the blocks of the step's sizes after other work."""
    import os
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    sort_key = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
                else "self_cuda_time_total")
    kernels = [(e.key, getattr(e, sort_key) / 1e3 / n, e.count // n) for e in avgs
               if e.device_type == DeviceType.CUDA and getattr(e, sort_key) > 0]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{path}.txt"), "w") as f:
        f.write(avgs.table(sort_by=sort_key, row_limit=80, max_name_column_width=90))
        f.write("\nby host time:\n")
        f.write(avgs.table(sort_by="self_cpu_time_total", row_limit=40,
                           max_name_column_width=90))
    total = sum(ms for _, ms, _ in kernels)
    if not kernels:
        log(f"profile {path}: no device time was traced")
        return
    groups = {}
    for name, ms, calls in kernels:
        low = name.lower()
        g = next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)), "other")
        ms0, c0 = groups.get(g, (0.0, 0))
        groups[g] = (ms0 + ms, c0 + calls)
    log(f"profile {path} ({n} steps): device time {total:.2f} ms/step in "
        f"{sum(c for _, _, c in kernels)} launches/step; unprofiled step "
        f"{step_s * 1e3:.2f} ms, so the device idles {1 - total / (step_s * 1e3):.1%} of it")
    for g, (ms, calls) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"  {g:<14} {ms:9.3f} ms/step {ms / total:6.1%}  {calls} launches/step")
    for name, ms, calls in sorted(kernels, key=lambda k: -k[1])[:25]:
        log(f"  {ms:9.3f} ms/step  x{calls:<4} {name[:110]}")


def main():
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="after each train phase, profile 3 steps and write the table to DIR")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py runs only on a GPU")
        return 1
    from syncvsr_tpu_torch.utils import kernels

    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib, build_log = kernels.build(force=True)
    log(f"build: {lib} in {time.perf_counter() - t0:.1f} s\n{build_log}")
    kernels.library()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    # every profiler window runs after every timing: once torch.profiler has
    # traced a process, its later launches can cost the host more
    later = []
    entries = [check_sync(torch, dev, "mono", later), check_sync(torch, dev, "split", later)]
    bn_entries, retime_k4 = check_bn(torch, dev, later)
    entries += bn_entries
    for path in PATH_KERNELS:
        check_reference(torch, np, path)
    torch.backends.cudnn.benchmark = True     # the warm-up steps absorb the autotuning
    summary, per_step, windows = {}, {}, []
    launches = {k: 0 for k in counters()}
    for path in PATH_KERNELS:
        got, summary[path], window = train_full_width(torch, np, path, args.profile)
        launches = {k: launches[k] + got[k] for k in launches}
        per_step[path] = summary[path]["launches_per_step"]
        if window:
            windows.append(window)
    # the kernels' windows first: after the steps' windows, torch.profiler
    # traced no kernel of theirs (run on an H100, PyTorch 2.11)
    for job in later + windows:
        job()
    log(f"K4 at the Conformer's BatchNorm shape: {retime_k4():.5f} ms a call after the "
        f"profiler windows, {entries[-1]['paths']['lrs3']['shapes'][-1]['ms']:.5f} before them")
    for e in entries:
        # launches over every path's timed steps, and per step of each path
        e["launches"] = launches[e["name"]]
        e["launches_per_step"] = {p: per_step[p][e["name"]] for p in per_step}
    log(f"summary: {json.dumps(summary)} on {card}")
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

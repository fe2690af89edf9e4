#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``syncvsr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure exits
non-zero before the last line is printed:

1. device: a CUDA card is required (there is no CPU path); prints its name
   and power limit;
2. build: compiles the hand-written kernels (``syncvsr_tpu_torch/csrc``)
   with nvcc for sm_90a and prints ptxas's registers / shared memory /
   spills;
3. kernels: each kernel against its plain PyTorch version at the shapes
   the ``lrw_video`` train step gives it, with its time (CUDA events, warm,
   many launches) beside its bound, the plain version's time and one
   PyTorch library call's;
4. reference: two train steps of a small f32 model on the card (through
   the kernels) against the same steps on the CPU (the plain versions);
5. train: the full-width ``lrw_video`` train step (batch 96, 29 uint8
   96x112 frames, bf16, augmentation, CutMix and dropout as configured),
   3 warm-up and two windows of 5 timed steps, the kernels' launches per
   step, then one eval step (and, with ``--profile DIR``, 3 profiled
   steps: device time by kernel group and the device's idle share);
6. the ``kernels`` JSON line, the card line and the ``ok`` line.
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


def trunk_bn_shapes(cfg):
    """(N, C, launches per step) of every BatchNorm statistics call of the
    Conv3D ResNet-18 frontend: the stem BN, then layer1..layer4."""
    b, t = cfg.data.batch_size, cfg.data.num_frames
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


def check_k1(torch, dev):
    from syncvsr_tpu_torch.ops import cuda_sync

    n, d, s, v = 29 * 96, 513, 8, 320          # lrw_video: B*T rows, 513 wide, A*G slots
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(n, d, device=dev, generator=g)
    w = torch.randn(d, s * v, device=dev, generator=g) * 0.05
    b = torch.randn(s * v, device=dev, generator=g) * 0.1
    tok = torch.randint(0, v, (n, s), device=dev, generator=g, dtype=torch.int32)
    tok[torch.rand(n, s, device=dev, generator=g) < 0.1] = -1
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)   # the kernel's operand types
    ce, cnt = cuda_sync.sync_ce_partials(xb, wb, b, tok)
    ce_p, cnt_p = cuda_sync.sync_ce_partials_plain(xb, wb, b, tok)
    torch.cuda.synchronize()
    err = abs(float(ce) - float(ce_p))
    # same bf16 operands, f32 accumulation in other orders: ~1e-8 relative
    # expected on the 22k-term sum; 1e-5 leaves room
    tol = 1e-5 * abs(float(ce_p))
    log(f"K1 sync_ce_fwd [{n}, {d}] x [{d}, {s}x{v}]: ce_sum {float(ce):.6f} vs plain "
        f"{float(ce_p):.6f}, |err| {err:.3e} (tol {tol:.3e}); count {float(cnt):.0f} vs "
        f"{float(cnt_p):.0f}")
    if not (err <= tol and float(cnt) == float(cnt_p) == float((tok >= 0).sum())):
        raise AssertionError("K1 disagrees with its plain version")
    ms = cuda_ms(torch, lambda: cuda_sync.sync_ce_partials(xb, wb, b, tok))
    plain = cuda_ms(torch, lambda: cuda_sync.sync_ce_partials_plain(xb, wb, b, tok))
    b16, tok_l = b.to(torch.bfloat16), tok.reshape(-1).long()
    lib = library_ms(torch, lambda: torch.nn.functional.cross_entropy(
        torch.addmm(b16, xb, wb).reshape(n * s, v).float(), tok_l, ignore_index=-1,
        reduction="sum"), "cross_entropy(addmm)")
    tiles = -(-n // 32)
    nbytes = n * d * 2 + d * s * v * 2 + s * v * 4 + n * s * 4 + tiles * s * 2 * 4
    bound, by = bound_ms(2 * n * d * s * v, PEAK_BF16_FLOPS, nbytes)
    log(f"  kernel_ms {ms:.4f}  plain_ms {plain:.4f}  library_ms {lib}  bound_ms {bound:.4f} ({by})")
    return {"name": "sync_ce_fwd", "route": "cuda",
            "source": "syncvsr_tpu_torch/csrc/sync_ce.cu",
            "replaces": "syncvsr_tpu/ops/pallas_sync.py:36", "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, "library_ms": lib}


def check_bn(torch, dev, cfg):
    """K3 and K4 at every trunk shape in bf16; per-step times are the
    per-shape times weighted by the launches per step."""
    from syncvsr_tpu_torch.ops import cuda_bn

    g = torch.Generator(device=dev).manual_seed(1)
    rows = {"fwd": [], "bwd": []}
    for n, c, per_step in trunk_bn_shapes(cfg):
        x = (torch.randn(n, c, device=dev, generator=g) * 2 + 0.5).to(torch.bfloat16)
        gy = torch.randn(n, c, device=dev, generator=g).to(torch.bfloat16)
        x32 = x.float()
        mean = x32.mean(0)
        inv = torch.rsqrt(x32.var(0, unbiased=False) + 1e-5)
        xhat_abs = ((x32 - mean) * inv).abs()
        # f32 sums of n values in other orders: the error is a small share
        # of the sum of magnitudes; 1e-5 of it leaves a 10x margin
        for kind, kern, plain, args, mags in (
                ("fwd", cuda_bn.bn_stats, cuda_bn.bn_stats_plain, (x,),
                 (x32.abs().sum(0), (x32 * x32).sum(0))),
                ("bwd", cuda_bn.bn_bwd_stats, cuda_bn.bn_bwd_stats_plain, (gy, x, mean, inv),
                 (gy.float().abs().sum(0), (gy.float().abs() * xhat_abs).sum(0)))):
            got = kern(*args)
            want = plain(*args)
            err = max(float((a - e).abs().max()) for a, e in zip(got, want))
            ratio = max(float(((a - e).abs() / (1e-5 * m + 1e-6)).max())
                        for a, e, m in zip(got, want, mags))
            name = "K3 bn_stats_fwd" if kind == "fwd" else "K4 bn_stats_bwd"
            log(f"{name} [{n}, {c}] bf16: max |err| {err:.3e}, worst err/tol {ratio:.3f}")
            if not ratio <= 1.0:
                raise AssertionError(f"{name} disagrees with its plain version at [{n}, {c}]")
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
            bound, by = bound_ms(flops, PEAK_F32_FLOPS, nbytes)
            log(f"  kernel_ms {ms:.4f}  plain_ms {plain_t:.4f}  library_ms {lib}  "
                f"bound_ms {bound:.4f} ({by}), {per_step} per step")
            rows[kind].append((per_step, err, ms, plain_t, lib, bound, by))
        del x, gy, x32, xhat_abs
        torch.cuda.empty_cache()

    def entry(name, src_line, kind):
        r = rows[kind]
        libs = [k * lib for k, _, _, _, lib, _, _ in r]
        return {"name": name, "route": "cuda", "source": "syncvsr_tpu_torch/csrc/bn_stats.cu",
                "replaces": f"syncvsr_tpu/ops/pallas_bn.py:{src_line}", "launches": 0,
                "max_abs_err": max(e for _, e, _, _, _, _, _ in r),
                "ms": sum(k * ms for k, _, ms, _, _, _, _ in r),
                "plain_ms": sum(k * p for k, _, _, p, _, _, _ in r),
                "bound_ms": sum(k * bd for k, _, _, _, _, bd, _ in r),
                "bound_by": r[0][6],
                "library_ms": None if None in libs else sum(libs)}

    return [entry("bn_stats_fwd", 47, "fwd"), entry("bn_stats_bwd", 68, "bwd")]


def counters():
    from syncvsr_tpu_torch.ops import cuda_bn, cuda_sync

    return {"sync_ce_fwd": cuda_sync.sync_ce_partials,
            "bn_stats_fwd": cuda_bn.bn_stats,
            "bn_stats_bwd": cuda_bn.bn_bwd_stats}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def run_steps(torch, cfg, batch_np, device, n_steps):
    """Build the model on ``device`` (the same seeded weights on every
    device) and run ``n_steps`` train steps; returns (state, metrics of
    each step)."""
    from syncvsr_tpu_torch.engine import build_train_step, create_train_state
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.ops.image import build_word_aug

    model = build_model(cfg, device=device)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}
    state = create_train_state(cfg, model, batch, device=device)
    step = build_train_step(aug_fn=build_word_aug(cfg.data))
    out = []
    for _ in range(n_steps):
        state, m = step(state, batch)
        out.append({k: float(v) for k, v in m.items()})
    return state, out


def uint8_clips(np, cfg, seed):
    """word_batch with uint8 clips [B, T, crop, crop * 112 / 96, 1], the
    shape of the LRW pipeline's frames."""
    from syncvsr_tpu_torch.data.synthetic import word_batch

    batch = word_batch(cfg, seed=seed)
    b, t, h = cfg.data.batch_size, cfg.data.num_frames, cfg.data.crop_size
    rng = np.random.RandomState(seed + 1)
    batch["inputs"] = rng.randint(0, 256, (b, t, h, h * 112 // 96, 1)).astype(np.uint8)
    return batch


def check_reference(torch, np):
    """Two f32 train steps of a small model through the kernels on the card
    against the same steps through the plain versions on the CPU. The
    augmentation and CutMix draw from the same CPU generator on both sides;
    dropout is off."""
    from syncvsr_tpu_torch.config import lrw_video_config

    cfg = lrw_video_config().override(**{
        "model.encoder.layers": 2, "model.encoder.dim": 64, "model.encoder.heads": 2,
        "model.frontend.resnet_width": 16, "model.dtype": "float32",
        "model.encoder.emb_dropout": 0.0, "model.encoder.msa_dropout": 0.0,
        "model.encoder.mlp_dropout": 0.0, "data.batch_size": 4, "data.num_frames": 8,
        "data.crop_size": 32, "optim.total_steps": 10, "optim.warmup_steps": 2})
    batch = uint8_clips(np, cfg, seed=3)
    cpu_state, cpu_m = run_steps(torch, cfg, batch, "cpu", 2)
    before = read_counts()
    gpu_state, gpu_m = run_steps(torch, cfg, batch, "cuda", 2)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in read_counts().items()}
    log(f"reference: 2 f32 steps of a small model, card vs CPU; launches {launched}")
    log(f"  card step 1: {gpu_m[0]}")
    log(f"  cpu  step 1: {cpu_m[0]}")
    if any(v == 0 for v in launched.values()):
        raise AssertionError(f"a kernel was not launched in the reference run: {launched}")
    # f32 on both sides with TF32 off. K1 rounds the sync head's operands
    # to bf16 where the CPU head stays f32 (as on the TPU and CPU in the
    # JAX package), which moves loss_audio by ~1e-4 relative; the rest are
    # f32 sums in other orders
    worst = 0.0
    for i, (a, e) in enumerate(zip(gpu_m, cpu_m)):
        for k in ("loss", "loss_word", "loss_audio", "grad_norm", "learning_rate"):
            rel = abs(a[k] - e[k]) / max(abs(e[k]), 1e-12)
            worst = max(worst, rel)
            if not (math.isfinite(a[k]) and rel <= 2e-3):
                raise AssertionError(f"step {i + 1} {k}: card {a[k]} vs CPU {e[k]}")
    # Adam's first moment holds every (clipped) gradient of both steps; the
    # backward is f32 on both sides, so it agrees to f32 noise (~2e-4 of a
    # leaf's largest element through 20 BatchNorm backwards)
    mu_ratio = 0.0
    for name, g_mu, c_mu in zip(gpu_state.names, gpu_state.mu, cpu_state.mu):
        scale = float(c_mu.abs().max())
        if scale > 0:
            mu_ratio = max(mu_ratio, float((g_mu.cpu() - c_mu).abs().max()) / scale)
    log(f"  worst metric rel err {worst:.3e}; worst Adam mu err / leaf scale {mu_ratio:.3e}")
    if not mu_ratio <= 2e-3:
        raise AssertionError(f"gradients disagree: mu err / scale {mu_ratio}")


def train_full_width(torch, np, profile_dir=None):
    from syncvsr_tpu_torch.config import lrw_video_config
    from syncvsr_tpu_torch.engine import build_eval_step, build_train_step, create_train_state
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.ops.image import build_eval_transform, build_word_aug

    cfg = lrw_video_config()   # bs 96, 29 frames, crop 96, 12 x 512 (+1) encoder, bf16
    batch_np = uint8_clips(np, cfg, seed=0)
    dev = torch.device("cuda")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    b, t = cfg.data.batch_size, cfg.data.num_frames
    log(f"train: lrw_video, inputs {tuple(batch['inputs'].shape)} {batch['inputs'].dtype}, "
        f"{cfg.model.encoder.layers} layers, dim {cfg.model.encoder.dim}, dtype {cfg.model.dtype}")
    model = build_model(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    state = create_train_state(cfg, model, batch)
    step = build_train_step(aug_fn=build_word_aug(cfg.data))
    first = None
    for i in range(WARMUP_STEPS):
        state, m = step(state, batch)
        if first is None:
            first = {k: float(v) for k, v in m.items()}
    torch.cuda.synchronize()
    log(f"  {n_params} parameters; first step {first}")
    # random init: the word head starts near ln(labels), the sync head near ln(vocab)
    for k, ref in (("loss_word", math.log(cfg.model.labels)),
                   ("loss_audio", math.log(cfg.model.codec.audio_vocab_size))):
        if not abs(first[k] - ref) < 1.0:
            raise AssertionError(f"first-step {k} {first[k]} is far from ln = {ref:.3f}")
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
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in last.values()):
        raise AssertionError(f"non-finite metrics: {last}")
    per_step = {"sync_ce_fwd": 1, "bn_stats_fwd": 20, "bn_stats_bwd": 20}
    want = {k: n * TIMED_STEPS * len(windows) for k, n in per_step.items()}
    log(f"  {TIMED_STEPS * len(windows)} timed steps: {dt * 1e3:.2f} ms/step (windows of "
        f"{TIMED_STEPS}: {', '.join(f'{w * 1e3:.2f}' for w in windows)} ms/step), "
        f"{b * t / dt:.1f} frames/s, peak memory {peak / 2**30:.2f} GiB; last step {last}")
    log(f"  launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    before = read_counts()
    ev = build_eval_step()(state, build_eval_transform(cfg.data)(batch))
    ev = {k: float(v) for k, v in ev.items()}
    torch.cuda.synchronize()
    log(f"  eval step: {ev}")
    if not all(math.isfinite(v) for v in ev.values()):
        raise AssertionError(f"non-finite eval metrics: {ev}")
    if read_counts()["sync_ce_fwd"] != before["sync_ce_fwd"] + 1:
        raise AssertionError("the eval step did not run K1")
    if profile_dir:
        profile_steps(torch, state, step, batch, profile_dir, dt)
    return launches, {"step_ms": dt * 1e3, "frames_per_s": b * t / dt, "peak_bytes": peak}


# device-time groups of the profile, matched in order on the kernel's name
KERNEL_GROUPS = (
    ("port kernels", ("sync_ce_kernel", "stats_fwd_partial", "stats_bwd_partial",
                      "sum_strips")),
    ("convolution", ("conv", "cudnn", "implicit", "fprop", "dgrad", "wgrad")),
    ("matmul", ("gemm", "cutlass", "xmma", "sm90_")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("reduction", ("reduce",)),
)


def profile_steps(torch, state, step, batch, out_dir, step_s, n=3):
    """``n`` train steps under torch.profiler: device time by kernel group
    and the top kernels, beside the unprofiled step time ``step_s`` (the
    device's idle share is 1 - device time / step time). The full table goes
    to ``out_dir/profile.txt``."""
    import os
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    with open(os.path.join(out_dir, "profile.txt"), "w") as f:
        f.write(avgs.table(sort_by=sort_key, row_limit=80, max_name_column_width=90))
    total = sum(ms for _, ms, _ in kernels)
    if not kernels:
        log("profile: no device time was traced")
        return
    groups = {}
    for name, ms, calls in kernels:
        low = name.lower()
        g = next((g for g, keys in KERNEL_GROUPS if any(k in low for k in keys)), "other")
        ms0, c0 = groups.get(g, (0.0, 0))
        groups[g] = (ms0 + ms, c0 + calls)
    log(f"profile ({n} steps): device time {total:.2f} ms/step in "
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
                    help="after the train phase, profile 3 steps and write the table to DIR")
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
    from syncvsr_tpu_torch.config import lrw_video_config

    entries = [check_k1(torch, dev)] + check_bn(torch, dev, lrw_video_config())
    check_reference(torch, np)
    torch.backends.cudnn.benchmark = True     # the warm-up steps absorb the autotuning
    launches, summary = train_full_width(torch, np, args.profile)
    for e in entries:
        e["launches"] = launches[e["name"]]
    log(f"summary: {json.dumps(summary)} on {card}")
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

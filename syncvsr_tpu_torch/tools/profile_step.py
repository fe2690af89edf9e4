"""Where a train step's device time goes (the port's counterpart of
``syncvsr_tpu/tools/profile_step.py``, whose xplane walker reads a JAX
trace; here ``torch.profiler`` reads the CUDA kernels directly).

    python -m syncvsr_tpu_torch.tools.profile_step [lrw|lrs3|lrw_landmark|lrs3_audio]
        [--top K] [--steps N] [--out DIR] [--tiny] [--device cpu]

It times the unprofiled step first (CUDA events over ``--steps`` steps,
before any profiler window: a traced process can pay more host time a
launch), then profiles ``--steps`` steps (``benchmark.profile_window``,
what ``chip_smoke.py --profile`` runs): the device time and launches a
step, the time by kernel group (port kernels, convolution, matmul,
elementwise, reduction, other) and the top ``K`` kernels, each with its
share, and the device's idle share (1 - device time / step time).
``--out DIR`` also writes the profiler's tables to
``DIR/profile_<workload>.txt``. On the CPU the rows are host ops and there
is no idle share. ``--tiny``: toy widths and batch.
"""

from __future__ import annotations

import os

import torch

from syncvsr_tpu_torch.utils.benchmark import (
    emit,
    profile_window,
    time_ms,
    tool_device,
    tool_parser,
)

WORKLOADS = ("lrw", "lrs3", "lrw_landmark", "lrs3_audio")


def workload(name: str, tiny: bool):
    """(config, numpy batch, augmentation) of a workload at the JAX bench's
    size (``utils/workloads.py``), or at toy widths."""
    from syncvsr_tpu_torch.data.synthetic import sentence_batch
    from syncvsr_tpu_torch.ops.image import build_sentence_aug, build_word_aug
    from syncvsr_tpu_torch.utils import workloads as w

    shrink = w.tiny if tiny else (lambda c: c)
    if name == "lrw":
        cfg = shrink(w.lrw_video_cfg())
        return cfg, w.uint8_clips(cfg, seed=0), build_word_aug(cfg.data)
    if name == "lrs3":
        cfg = shrink(w.lrs3_cfg())
        frames, labels, source = (8, 4, 20) if tiny else (w.LRS3_FRAMES, w.LRS3_LABEL_LEN,
                                                         w.LRS3_SOURCE)
        return (cfg, w.uint8_sentences(cfg, frames, labels, source, seed=0),
                build_sentence_aug(cfg.data))
    if name == "lrw_landmark":
        cfg = shrink(w.lrw_landmark_cfg())
        return cfg, w.landmark_clips(cfg, seed=0), None
    cfg = shrink(w.lrs3_audio_cfg())
    frames, labels = (8, 4) if tiny else (w.AUDIO_FRAMES, w.AUDIO_LABEL_LEN)
    return cfg, sentence_batch(cfg, num_frames=frames, label_len=labels), None


def main(argv=None) -> dict:
    from syncvsr_tpu_torch.engine import build_train_step, create_train_state
    from syncvsr_tpu_torch.models import build_model

    ap = tool_parser(__doc__.split("\n")[0])
    ap.add_argument("workload", nargs="?", default="lrw", choices=WORKLOADS)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the profiler's tables here")
    ap.add_argument("--tiny", action="store_true", help="toy widths and batch")
    args = ap.parse_args(argv)
    device = tool_device(args)
    cfg, raw, aug = workload(args.workload, args.tiny)
    batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    state = create_train_state(cfg, build_model(cfg, device=device), batch, device=device)
    step = build_train_step(aug_fn=aug)
    step_ms = time_ms(lambda: step(state, batch), device, args.steps,
                      warmup=1 if args.tiny else 3)
    table = (os.path.join(args.out, f"profile_{args.workload}.txt") if args.out else None)
    prof = profile_window(lambda: step(state, batch), device, args.steps, table)
    total = prof["ms"]

    def share(ms):
        return ms / total if total else None

    return emit(
        "profile_step", device, workload=args.workload, steps=args.steps,
        step_ms=step_ms, source=prof["source"], kernel_ms_per_step=total,
        launches_per_step=prof["launches"],
        idle_share=(1 - total / step_ms) if device.type == "cuda" and total else None,
        groups={g: {"ms": ms, "share": share(ms), "launches": n}
                for g, (ms, n) in sorted(prof["groups"].items(), key=lambda kv: -kv[1][0])},
        top=[{"kernel": k[:160], "ms": ms, "share": share(ms), "calls": n}
             for k, ms, n in prof["kernels"][:args.top]])


if __name__ == "__main__":
    main()

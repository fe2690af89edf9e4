"""Train-step time of the two auxiliary workloads (the port's counterpart
of ``syncvsr_tpu/tools/bench_aux_workloads.py``).

    python -m syncvsr_tpu_torch.tools.bench_aux_workloads [--tiny] [--device cpu]

* ``lrw_landmark``: bs 1024 x 29 frames of 1434 f32 landmark features, the
  8 x 320 LayerNorm/GELU encoder, bf16 (its sync head runs K1);
* ``lrs3_audio``: bs 32 x 102400 samples (160 frames) of waveform, the
  Conv1D ResNet-18 frontend and ``lrs3``'s Conformer, decoder and losses,
  bf16 (K2 once a step, K3 and K4 32 times).

Each: ms a step over ``--steps`` steps after 3 (CUDA events), frames a
second, peak device memory, and the hand-written kernels' launches a step.
``--tiny`` runs both at toy widths and batch (a smoke of the tool).
"""

from __future__ import annotations

import torch

from syncvsr_tpu_torch.ops import kernel_wrappers, launch_counts
from syncvsr_tpu_torch.utils.benchmark import (
    PeakMemory,
    emit,
    time_ms,
    tool_device,
    tool_parser,
)


def step_time(cfg, raw, device: torch.device, steps: int, warmup: int) -> dict:
    """ms a train step of ``cfg``'s model on the batch ``raw``, the peak
    device memory of the steps and the kernels' launches a step."""
    from syncvsr_tpu_torch.engine import build_train_step, create_train_state
    from syncvsr_tpu_torch.models import build_model

    batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    state = create_train_state(cfg, build_model(cfg, device=device), batch, device=device)
    step = build_train_step()
    for fn in kernel_wrappers().values():
        fn.launches = 0
    step(state, batch)
    launches = launch_counts()
    with PeakMemory(device) as peak:
        ms = time_ms(lambda: step(state, batch), device, steps, warmup)
    return {"ms_per_step": ms, "peak_bytes": peak.bytes, "launches_per_step": launches}


def main(argv=None) -> dict:
    from syncvsr_tpu_torch.data.synthetic import sentence_batch
    from syncvsr_tpu_torch.utils.workloads import (
        AUDIO_FRAMES,
        AUDIO_LABEL_LEN,
        landmark_clips,
        lrs3_audio_cfg,
        lrw_landmark_cfg,
        tiny,
    )

    ap = tool_parser(__doc__.split("\n")[0])
    ap.add_argument("--tiny", action="store_true", help="toy widths and batch")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    device = tool_device(args)
    shrink = tiny if args.tiny else (lambda c: c)
    out = {}
    cfg = shrink(lrw_landmark_cfg())
    warmup = 1 if args.tiny else 2
    res = step_time(cfg, landmark_clips(cfg, seed=0), device, args.steps, warmup)
    frames = cfg.data.batch_size * cfg.data.num_frames
    out["lrw_landmark"] = dict(res, batch_size=cfg.data.batch_size,
                               frames_per_sec=frames / res["ms_per_step"] * 1e3)
    cfg = shrink(lrs3_audio_cfg())
    frames = 8 if args.tiny else AUDIO_FRAMES
    raw = sentence_batch(cfg, num_frames=frames, label_len=4 if args.tiny else AUDIO_LABEL_LEN)
    res = step_time(cfg, raw, device, args.steps, warmup)
    out["lrs3_audio"] = dict(res, batch_size=cfg.data.batch_size, video_equiv_frames=frames,
                             frames_per_sec=(cfg.data.batch_size * frames
                                             / res["ms_per_step"] * 1e3))
    return emit("bench_aux_workloads", device, **out)


if __name__ == "__main__":
    main()

"""One subgraph of the ``lrs3`` train step at bs 16 x 160 frames, forward
and backward, a variant a call (the port's counterpart of
``syncvsr_tpu/tools/bisect_bs16.py``, which bisected a TPU-worker crash of
the bs-16 step; ``docs/bs16_triage.md``).

    python -m syncvsr_tpu_torch.tools.bisect_bs16 <variant> [batch_size]
        [--frames N] [--tiny] [--device cpu]

Variants, each after the step's augmentation (uint8 128x128 clips, random
crop to 88, flips, time masks) from the state's generator:

* ``frontend``: the Conv3D stem and ResNet trunk, a sum-of-squares loss;
* ``encoder``: frontend and Conformer (``encode``), a sum-of-squares loss;
* ``model``: the model's loss (every branch), no optimizer update;
* ``ctc``, ``att``, ``sync``: ``encode`` and one loss branch (CTC; the
  decoder and its label-smoothing KL; the sync head);
* ``dec``: ``encode`` and the decoder, a sum of squares of its logits;
* ``lsm``: ``encode`` and the label-smoothing KL on the CTC head's logits
  at the decoder's target shape (no decoder);
* ``modelmetrics``: ``model`` with every metric output kept in the loss;
* ``full``: the whole train step (the optimizer update too).

``att_barrier`` put an XLA optimization barrier between the decoder and its
KL (a fusion probe of the TPU compiler); eager PyTorch fuses nothing, so it
has no counterpart and raises. Prints ms a step (CUDA events over
``--steps`` steps after 3) and the peak device memory of the timed steps.
``--tiny``: toy widths and batch.
"""

from __future__ import annotations

import torch

from syncvsr_tpu_torch.utils.benchmark import (
    PeakMemory,
    emit,
    time_ms,
    tool_device,
    tool_parser,
)

VARIANTS = ("frontend", "encoder", "model", "ctc", "att", "sync", "dec", "lsm",
            "modelmetrics", "full")
ATT_BARRIER = (
    "bisect_bs16 att_barrier: an XLA optimization barrier between the decoder's "
    "logits and the KL was a fusion probe of the TPU compiler; eager PyTorch fuses "
    "nothing across the two, so the variant has no counterpart (run att)")


def one_loss(model, batch, which: str, gen):
    """``encode`` and exactly one loss branch of the sentence model."""
    from syncvsr_tpu_torch.ops.ctc import ctc_loss
    from syncvsr_tpu_torch.ops.masking import add_sos_eos, label_smoothing_kl, length_mask

    cfg = model.cfg
    x = model.encode(batch["videos"], batch["lengths"], det=False, gen=gen)
    t = x.shape[1]
    lengths = model.frame_lengths(batch["videos"], batch["lengths"])
    pad_mask = length_mask(lengths, t)
    if which == "sync":
        a = cfg.codec.audio_alignment
        tokens = batch["audio_tokens"][:, :t * a]
        valid = pad_mask.repeat_interleave(a, dim=1)
        masked = torch.where(valid[:, :, None], tokens, torch.full_like(tokens, -1))
        return model.audio_classifier(x.float(), masked, chunk=128 if t > 256 else None)
    if which == "ctc":
        labels = batch["labels"]
        return ctc_loss(model.ctc_head(x.float()), lengths, labels, (labels != -1).sum(1),
                        blank_id=0)
    _, ys_out, _ = add_sos_eos(batch["labels"], model.sos, model.eos, -1)
    if which == "lsm":
        logits = model.ctc_head(x.float()[:, :ys_out.shape[1]])
        return label_smoothing_kl(logits, ys_out, cfg.labels, cfg.lsm_weight, ignore_id=-1)
    memory = model.proj_decoder(x) if hasattr(model, "proj_decoder") else x
    ys_in, ys_out, ys_lengths = add_sos_eos(batch["labels"], model.sos, model.eos, -1)
    logits = model.decoder(ys_in, ys_lengths, memory, pad_mask, False, gen)
    if which == "dec":
        return (logits.float() ** 2).sum()
    return label_smoothing_kl(logits, ys_out, cfg.labels, cfg.lsm_weight, ignore_id=-1)


def main(argv=None) -> dict:
    from syncvsr_tpu_torch.engine import build_train_step, create_train_state
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.ops.image import build_sentence_aug
    from syncvsr_tpu_torch.utils import workloads as w

    ap = tool_parser(__doc__.split("\n")[0])
    ap.add_argument("variant", choices=VARIANTS + ("att_barrier",))
    ap.add_argument("batch_size", nargs="?", type=int, default=16)
    ap.add_argument("--frames", type=int, default=w.LRS3_FRAMES)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--tiny", action="store_true", help="toy widths and batch")
    args = ap.parse_args(argv)
    if args.variant == "att_barrier":
        raise NotImplementedError(ATT_BARRIER)
    device = tool_device(args)
    cfg = w.lrs3_cfg().override(**{"data.batch_size": args.batch_size})
    source, label_len = w.LRS3_SOURCE, w.LRS3_LABEL_LEN
    if args.tiny:
        cfg = w.tiny(cfg).override(**{"data.batch_size": args.batch_size})
        source, label_len = 20, 4
    raw = w.uint8_sentences(cfg, args.frames, label_len, source, seed=0)
    batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    model = build_model(cfg, device=device)
    state = create_train_state(cfg, model, batch, device=device)
    aug = build_sentence_aug(cfg.data)
    params = [p for p in model.parameters() if p.requires_grad]
    variant = args.variant

    if variant == "full":
        step = build_train_step(aug_fn=aug)

        def run():
            step(state, batch)
    else:
        def loss():
            b = aug(state.mixup_gen, batch)
            gen = state.dropout_gen
            if variant == "frontend":
                return (model.frontend(b["videos"], train=True).float() ** 2).sum()
            if variant == "encoder":
                x = model.encode(b["videos"], b["lengths"], det=False, gen=gen)
                return (x.float() ** 2).sum()
            if variant in ("model", "modelmetrics"):
                out = model(**b, det=False, dropout_gen=gen,
                            mix=model.draw_mix(state.mixup_gen, b))
                if variant == "model":
                    return out["loss"]
                return sum(v.float().sum() for v in out.values())
            return one_loss(model, b, variant, gen)

        def run():
            torch.autograd.grad(loss(), params, allow_unused=True)

    with PeakMemory(device) as peak:
        ms = time_ms(run, device, args.steps, warmup=1 if args.tiny else 3)
    frames = args.batch_size * args.frames
    return emit("bisect_bs16", device, variant=variant, bs=args.batch_size,
                frames=args.frames, ms_per_step=ms, frames_per_sec=frames / ms * 1e3,
                peak_bytes=peak.bytes, ok=True)


if __name__ == "__main__":
    main()

"""Decoding at the ``lrs3`` model's full scale, and its longest train bucket
(the port's counterpart of ``syncvsr_tpu/tools/bench_decode.py``).

    python -m syncvsr_tpu_torch.tools.bench_decode [beam|greedy|train1800|testset|trained]
        [--frames T] [--beam K] [--steps N] [--tiny] [--device cpu]

* ``beam``: the hybrid CTC/attention beam search (``decode.api.
  make_beam_decoder``) on one clip of ``--frames`` (500) frames, beam 40,
  the 5049-token vocabulary, the full model (12 x 768 Conformer, 6 x 768
  decoder, bf16) with random weights. A random model never emits eos, so
  every one of the T steps runs: the worst case (the line says so).
* ``greedy``: greedy CTC decoding of the same clip.
* ``train1800``: the train step at bs 2 x 1800 frames with ``model.remat``
  (the recipe's longest bucket): s a step, frames a second, peak memory.
* ``testset``: 8 clips in each bucket of 160, 320 and 500 frames, decoded
  with the batched search three ways: every batch padded to the longest
  bucket (``decode_pad=max``), each at its bucket's length, and two clips
  of each bucket one at a time.
* ``trained``: the full model overfit on one synthetic utterance
  (``--steps`` steps), then the same ``--frames``-frame decode with the
  random weights (every step: the worst case) and with the trained weights
  (the search stops once eos wins): the early exit's speed-up.

Times are CUDA events around each call after a ``synchronize``: the mean of
3 calls after a first, untimed one. ``--tiny``: toy widths, one timed call.
"""

from __future__ import annotations

import numpy as np
import torch

from syncvsr_tpu_torch.utils.benchmark import (
    PeakMemory,
    emit,
    time_ms,
    tool_device,
    tool_parser,
)

WORST_CASE = ("random weights: no eos is ever emitted, so the search runs every one of "
              "its steps (the worst case)")


def _reps(tiny: bool) -> int:
    """Timed calls of a mode: 3, or 1 at toy widths."""
    return 1 if tiny else 3


def _model(cfg, device):
    from syncvsr_tpu_torch.models import build_model

    torch.manual_seed(0)
    model = build_model(cfg, device=device)
    model.eval()
    return model


def _cfg(tiny: bool, **over):
    from syncvsr_tpu_torch.utils import workloads as w

    cfg = w.lrs3_cfg().override(**over)
    return w.tiny(cfg).override(**over) if tiny else cfg


def _clips(cfg, b: int, t: int, device, seed: int = 0):
    s = cfg.data.crop_size
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(b, t, s, s, 1).astype(np.float32)).to(device)


def bench_beam(device, tiny: bool, t: int, beam: int, greedy: bool) -> dict:
    from syncvsr_tpu_torch.decode import BeamSearchConfig
    from syncvsr_tpu_torch.decode.api import make_beam_decoder, make_greedy_ctc_decoder

    cfg = _cfg(tiny, **{"data.batch_size": 1})
    model = _model(cfg, device)
    videos = _clips(cfg, 1, t, device)
    lengths = torch.full((1,), t, device=device)
    if greedy:
        decode = make_greedy_ctc_decoder(model)
        ms = time_ms(lambda: decode(videos, lengths), device, _reps(tiny), warmup=1)
        return {"mode": "greedy", "t_frames": t, "sec_per_utt": ms / 1e3}
    decode = make_beam_decoder(model, BeamSearchConfig(beam_size=beam,
                                                       ctc_weight=cfg.model.mtlalpha))
    ms = time_ms(lambda: decode(videos, t), device, _reps(tiny), warmup=1)
    _, n, _ = decode(videos, t)
    return {"mode": "beam", "beam": beam, "t_frames": t, "vocab": cfg.model.labels,
            "sec_per_utt": ms / 1e3, "ms_per_step": ms / t, "hyp_len": int(n),
            "note": WORST_CASE}


def bench_train1800(device, tiny: bool, frames: int) -> dict:
    from syncvsr_tpu_torch.engine import build_train_step, create_train_state
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.ops.image import build_sentence_aug
    from syncvsr_tpu_torch.utils import workloads as w

    cfg = _cfg(tiny, **{"data.batch_size": 2, "model.remat": True})
    raw = w.uint8_sentences(cfg, frames, 4 if tiny else w.LRS3_1800_LABEL_LEN,
                            20 if tiny else w.LRS3_SOURCE, seed=0)
    batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    state = create_train_state(cfg, build_model(cfg, device=device), batch, device=device)
    step = build_train_step(aug_fn=build_sentence_aug(cfg.data))
    _, m = step(state, batch)
    with PeakMemory(device) as peak:
        ms = time_ms(lambda: step(state, batch), device, _reps(tiny), warmup=0)
    return {"mode": "train1800", "batch_size": 2, "frames": frames, "remat": True,
            "loss_finite": bool(torch.isfinite(m["loss"]).item()), "sec_per_step": ms / 1e3,
            "frames_per_sec": 2 * frames / ms * 1e3, "peak_bytes": peak.bytes}


def bench_testset(device, tiny: bool, beam: int, buckets=(160, 320, 500), bs: int = 8) -> dict:
    from syncvsr_tpu_torch.decode import BeamSearchConfig
    from syncvsr_tpu_torch.decode.api import make_batched_beam_decoder, make_beam_decoder

    if tiny:
        buckets, bs = (8, 12, 16), 2
    cfg = _cfg(tiny, **{"data.batch_size": bs})
    model = _model(cfg, device)
    config = BeamSearchConfig(beam_size=beam, ctc_weight=cfg.model.mtlalpha)
    batches = [(t, _clips(cfg, bs, t, device, seed=i), torch.full((bs,), t, device=device))
               for i, t in enumerate(buckets)]
    n_utts = len(batches) * bs
    t_max = max(buckets)
    padded = make_batched_beam_decoder(model, config, max_len=t_max)

    def run_padded():
        for t, v, lens in batches:
            padded(torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 0, 0, t_max - t)), lens)

    per = {t: make_batched_beam_decoder(model, config, max_len=t) for t in buckets}

    def run_per_bucket():
        for t, v, lens in batches:
            per[t](v, lens)

    single = make_beam_decoder(model, config)

    def run_per_utt():
        for t, v, _ in batches:
            for i in range(2):
                single(v[i:i + 1], t)

    out = {"mode": "testset", "beam": beam, "bs": bs, "buckets": list(buckets),
           "n_utts": n_utts, "note": WORST_CASE}
    for name, fn, n in (("padded", run_padded, n_utts), ("per_bucket", run_per_bucket, n_utts),
                        ("per_utt_sample", run_per_utt, 2 * len(buckets))):
        s = time_ms(fn, device, 1, warmup=0) / 1e3
        out[name] = {"n": n, "wall_s": s, "sec_per_utt": s / n}
    return out


def bench_trained(device, tiny: bool, t: int, steps: int, beam: int,
                  train_frames: int = 160) -> dict:
    from syncvsr_tpu_torch.data.synthetic import sentence_batch
    from syncvsr_tpu_torch.decode import BeamSearchConfig
    from syncvsr_tpu_torch.decode.api import make_beam_decoder
    from syncvsr_tpu_torch.engine import build_train_step, create_train_state

    train_frames = min(train_frames, t)
    # the sync head off (memorising one clip needs CTC and attention only), a
    # short warm-up and a flat schedule, as the JAX tool sets them
    cfg = _cfg(tiny, **{"data.batch_size": 1, "model.sync_lambda": 0.0, "optim.lr": 3e-4,
                        "optim.warmup_steps": 20, "optim.total_steps": max(steps * 10, 1000),
                        "optim.clip_norm": 1.0})
    model = _model(cfg, device)
    model.train()
    label_len = 20
    rng = np.random.RandomState(0)
    raw = sentence_batch(cfg, num_frames=train_frames, label_len=label_len)
    s = cfg.data.crop_size
    raw["videos"] = rng.randn(1, train_frames, s, s, 1).astype(np.float32)
    raw["labels"] = np.concatenate([rng.randint(1, cfg.model.labels - 1, (1, label_len)),
                                    np.full((1, 4), -1)], axis=1).astype(np.int32)
    raw["lengths"] = np.full((1,), train_frames, np.int32)
    batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = create_train_state(cfg, model, batch, device=device)
    step = build_train_step()
    for _ in range(steps):
        step(state, batch)
    trained = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.eval()
    config = BeamSearchConfig(beam_size=beam, ctc_weight=cfg.model.mtlalpha)
    videos = torch.nn.functional.pad(batch["videos"], (0, 0, 0, 0, 0, 0, 0, t - train_frames))
    out = {"mode": "trained", "beam": beam, "t_frames": t, "train_frames": train_frames,
           "transcript_len": label_len, "overfit_steps": steps}
    for name, weights in (("worst_case_random", init), ("trained", trained)):
        model.load_state_dict(weights)
        decode = make_beam_decoder(model, config, early_exit=name == "trained")
        ms = time_ms(lambda: decode(videos, train_frames), device, _reps(tiny), warmup=1)
        toks, n, _ = decode(videos, train_frames)
        hyp = [int(x) for x in toks[:int(n)].tolist()]
        out[name] = {"sec_per_utt": ms / 1e3, "hyp_len": int(n)}
        if name == "trained":
            out[name]["exact_match"] = hyp == [int(x) for x in raw["labels"][0][:label_len]]
    out["early_exit_speedup"] = (out["worst_case_random"]["sec_per_utt"]
                                 / out["trained"]["sec_per_utt"])
    return out


def main(argv=None) -> dict:
    ap = tool_parser(__doc__.split("\n")[0])
    ap.add_argument("mode", nargs="?", default="beam",
                    choices=("beam", "greedy", "train1800", "testset", "trained"))
    ap.add_argument("--frames", type=int, default=None,
                    help="beam, greedy, trained: 500; train1800: 1800")
    ap.add_argument("--beam", type=int, default=40)
    ap.add_argument("--steps", type=int, default=400, help="trained: overfit steps")
    ap.add_argument("--tiny", action="store_true", help="toy widths")
    args = ap.parse_args(argv)
    device = tool_device(args)
    if args.mode in ("beam", "greedy"):
        res = bench_beam(device, args.tiny, args.frames or 500, args.beam,
                         args.mode == "greedy")
    elif args.mode == "train1800":
        res = bench_train1800(device, args.tiny, args.frames or 1800)
    elif args.mode == "testset":
        res = bench_testset(device, args.tiny, args.beam)
    else:
        res = bench_trained(device, args.tiny, args.frames or 500, args.steps, args.beam,
                            train_frames=16 if args.tiny else 160)
    return emit("bench_decode", device, **res)


if __name__ == "__main__":
    main()

"""The parts of one beam-search step at ``lrs3`` scale, each in its own loop
(the port's counterpart of ``syncvsr_tpu/tools/bench_beam_parts.py``).

    python -m syncvsr_tpu_torch.tools.bench_beam_parts [T] [beam] [--steps N]
        [--tiny] [--device cpu]

Over ``--steps`` (50) steps each, ms a step of: the CTC prefix scorer
(``decode/ctc_prefix.py``: ``score_partial`` over the pre-beam candidates,
1.5 x beam of them, and ``select_state``) on [T, 5049] posteriors; the
KV-cached decoder step of the full ``lrs3`` decoder (6 x 768, bf16) for the
beam's hypotheses over a T-frame memory, with its cross-attention K/V
projected once (``ms_decoder_memkv``) and projected at every step
(``ms_decoder_reproject``); the cache's reorder (one ``index_select`` a
tensor, ``ms_cache_gather``); and the step's top-k's (``stable_topk``: the
pre-beam over each hypothesis's vocabulary and the beam over every
candidate, ``ms_topk``). CUDA events around the loop after a
``synchronize``. ``--tiny``: a toy decoder and vocabulary.
"""

from __future__ import annotations

import numpy as np
import torch

from syncvsr_tpu_torch.utils.benchmark import emit, time_ms, tool_device, tool_parser


def main(argv=None) -> dict:
    from syncvsr_tpu_torch.decode.beam_search import stable_topk
    from syncvsr_tpu_torch.decode.ctc_prefix import CTCPrefixScorer
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.utils import workloads as w

    ap = tool_parser(__doc__.split("\n")[0])
    ap.add_argument("t_enc", nargs="?", type=int, default=500)
    ap.add_argument("beam", nargs="?", type=int, default=40)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--tiny", action="store_true", help="toy widths and vocabulary")
    args = ap.parse_args(argv)
    device = tool_device(args)
    t_enc, beam, n_steps = args.t_enc, args.beam, args.steps
    cfg = w.lrs3_cfg().override(**{"data.batch_size": 1})
    if args.tiny:
        cfg = w.tiny(cfg)
    vocab, p = cfg.model.labels, int(1.5 * beam)
    rng = np.random.RandomState(0)
    torch.manual_seed(0)

    # the CTC prefix scorer
    logp = torch.log_softmax(torch.from_numpy(rng.randn(1, t_enc, vocab).astype(np.float32)),
                             -1).to(device)
    scorer = CTCPrefixScorer(logp, torch.tensor([t_enc], device=device), 0, vocab - 1)
    last = torch.full((beam,), 3, dtype=torch.long, device=device)
    base_ids = torch.arange(p, device=device)[None].repeat(beam, 1)
    hyp = torch.arange(beam, device=device)

    def loop_scorer():
        state = scorer.init_state(beam)
        for i in range(n_steps):
            ids = torch.remainder(base_ids + i % 7, vocab)
            psi, r_new, _ = scorer.score_partial(state, last, ids, i)
            state = scorer.select_state(state, r_new, psi, ids, hyp, ids[:, 0])

    ms_scorer = time_ms(loop_scorer, device, 1, warmup=1) / n_steps

    # the decoder step over a T-frame memory
    model = build_model(cfg, device=device)
    enc = torch.from_numpy(rng.randn(1, t_enc, cfg.model.encoder.dim).astype(np.float32))
    enc = enc.to(device).to(model.dtype)
    mask = torch.ones(1, t_enc, dtype=torch.bool, device=device)
    mem = enc.expand(beam, -1, -1)
    mem_mask = mask.expand(beam, -1)
    y = torch.full((beam,), 5, dtype=torch.long, device=device)
    l_max = t_enc + 2

    @torch.inference_mode()
    def loop_decoder(precomputed: bool):
        cache = model.decoder_init_cache(beam, l_max)
        mem_kv = model.decoder_precompute_memory(enc) if precomputed else None
        for i in range(n_steps):
            if precomputed:
                model.decoder_step(y, i, cache, None, mask, mem_kv=mem_kv)
            else:
                model.decoder_step(y, i, cache, mem, mem_mask)

    ms_dec = time_ms(lambda: loop_decoder(True), device, 1, warmup=1) / n_steps
    ms_dec_re = time_ms(lambda: loop_decoder(False), device, 1, warmup=1) / n_steps

    cache0 = model.decoder_init_cache(beam, l_max)

    def loop_gather():
        cache = cache0
        for i in range(n_steps):
            sel = torch.remainder(hyp + i, beam)
            cache = {k: v.index_select(0, sel) for k, v in cache.items()}

    ms_gather = time_ms(loop_gather, device, 1, warmup=1) / n_steps

    total = torch.from_numpy(rng.randn(beam, vocab).astype(np.float32)).to(device)

    def loop_topk():
        acc = torch.zeros((), device=device)
        for _ in range(n_steps):
            t = total + acc
            _, part = stable_topk(t, p)
            sc, _ = stable_topk(t.reshape(1, -1), 2 * beam)
            acc = acc + sc[0, 0] * 1e-9 + part[0, 0] * 1e-12

    ms_topk = time_ms(loop_topk, device, 1, warmup=1) / n_steps
    return emit("bench_beam_parts", device, t_enc=t_enc, beam=beam, pre_beam=p, vocab=vocab,
                steps=n_steps, ms_scorer=ms_scorer, ms_decoder_memkv=ms_dec,
                ms_decoder_reproject=ms_dec_re, ms_cache_gather=ms_gather, ms_topk=ms_topk)


if __name__ == "__main__":
    main()

"""Decoding entry points over a trained ``SentenceVSRModel`` (port of
``syncvsr_tpu/decode/api.py``, without its ``mesh`` argument).

Each builder returns a function of torch tensors that runs where the
model's parameters are: on the GPU for a model built the default way (a
model on a CUDA device without a card cannot exist, so nothing here falls
back to the CPU), on the CPU for one built with ``device="cpu"``. Each
call encodes once under ``torch.inference_mode()`` in eval mode
(``det=True``: BatchNorms on their running statistics, no dropout), and the
beam decoders project the memory's cross-attention K/V once. The weights
live in the modules, so the builders take no variables.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from syncvsr_tpu_torch.decode.beam_search import BeamSearchConfig, beam_search
from syncvsr_tpu_torch.models.decoder import grow_cache
from syncvsr_tpu_torch.models.lm import TransformerLM
from syncvsr_tpu_torch.ops.ctc import ctc_forced_align, ctc_greedy_decode

Tensor = torch.Tensor


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _encode(model, videos: Tensor, lengths: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(encoder output [B, T, D], frame lengths [B], CTC log-probs [B, T, V])."""
    enc = model.encode(videos, lengths, det=True)
    return enc, model.frame_lengths(videos, lengths), model.ctc_log_probs(enc)


def make_batched_beam_decoder(model, config: BeamSearchConfig, max_len: Optional[int],
                              lm=None, early_exit: bool = True):
    """Hybrid CTC/attention beam search over a batch of utterances, all
    decoded together (the JAX package vmaps its search over the bucket).
    ``max_len``: the decode steps' bound, the padded frame count (None: the
    encoder's frame count). With an LM (``models.lm``) and
    ``config.lm_weight`` != 0, shallow fusion; ``early_exit=False`` runs
    every step (the worst case).

    Returns fn(videos [B, T, ...], lengths [B]) -> (tokens [B, max_len + 1]
    padded with -1, token counts [B], scores [B])."""
    vocab = model.cfg.labels
    use_lm = lm is not None and config.lm_weight != 0.0
    grow_lm = grow_cache if isinstance(lm, TransformerLM) else None

    def lm_init(n: int, capacity: int):
        return lm.init_cache(n, capacity) if grow_lm else lm.init_cache(n)

    def decode(videos: Tensor, lengths: Tensor):
        dev = _device(model)
        videos, lengths = videos.to(dev), lengths.to(dev)
        with torch.inference_mode():
            enc, flens, ctc_logp = _encode(model, videos, lengths)
            mem_kv = model.decoder_precompute_memory(enc)
            mem_mask = torch.arange(enc.shape[1], device=dev)[None, :] < flens[:, None]

            def decoder_step(y_prev, pos, cache):
                return model.decoder_step(y_prev, pos, cache, None, mem_mask, mem_kv=mem_kv)

            return beam_search(decoder_step, model.decoder_init_cache, flens, ctc_logp,
                               vocab, config, max_len=max_len,
                               lm_step=lm.step if use_lm else None,
                               lm_init=lm_init if use_lm else None,
                               early_exit=early_exit, grow_cache=grow_cache,
                               grow_lm_state=grow_lm)

    return decode


def make_beam_decoder(model, config: BeamSearchConfig, max_len: Optional[int] = None,
                      lm=None, early_exit: bool = True):
    """One utterance: the batched search at B = 1.

    Returns fn(videos [1, T, ...], length) -> (tokens [L] padded with -1,
    token count, score)."""
    batched = make_batched_beam_decoder(model, config, max_len, lm, early_exit)

    def decode(videos: Tensor, length):
        tokens, n, score = batched(videos, torch.as_tensor(length).reshape(1))
        return tokens[0], n[0], score[0]

    return decode


def make_forced_aligner(model):
    """Batched CTC forced alignment of ground-truth transcripts.

    Returns fn(videos [B, T, ...], lengths [B], labels [B, N] padded with
    -1) -> alignment [B, T] int32: the token of each frame (blank between
    emissions), -1 past each clip's frame length."""
    def align(videos: Tensor, lengths: Tensor, labels: Tensor) -> Tensor:
        dev = _device(model)
        videos, lengths, labels = videos.to(dev), lengths.to(dev), labels.to(dev)
        with torch.inference_mode():
            _, flens, ctc_logp = _encode(model, videos, lengths)
            # log_softmax is idempotent, so the log-probs go in as logits
            return ctc_forced_align(ctc_logp, flens, torch.clamp(labels, min=0),
                                    (labels >= 0).sum(1))

    return align


def make_greedy_ctc_decoder(model):
    """Batched greedy CTC decoding (no decoder, no LM).

    Returns fn(videos [B, T, ...], lengths [B]) -> (tokens [B, T] padded
    with -1, lengths [B])."""
    def decode(videos: Tensor, lengths: Tensor) -> Tuple[Tensor, Tensor]:
        dev = _device(model)
        videos, lengths = videos.to(dev), lengths.to(dev)
        with torch.inference_mode():
            _, flens, ctc_logp = _encode(model, videos, lengths)
            return ctc_greedy_decode(ctc_logp, flens)

    return decode

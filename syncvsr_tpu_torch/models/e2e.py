"""Sentence-level VSR model (port of ``syncvsr_tpu/models/e2e.py``):
video or raw-audio frontend (``build_frontend``) + Conformer encoder + CTC
head + attention decoder + sync head.

    loss = mtlalpha * ctc + (1 - mtlalpha) * att + sync_lambda * audio

with att the label-smoothed KL divided by the batch, ctc batch-averaged
and the per-frame audio sync CE over the valid frames only. Token
conventions: blank 0, sos = eos = labels - 1, ignore -1. In train mode
(``det=False``) dropout draws from ``dropout_gen``; ``mixup_gen`` is
accepted for the train step's calling shape and not used (the sentence
recipe has no CutMix).

Under sequence parallel (``parallel/sequence.py``) the frontend, the
Conformer and the sync head run on this rank's frames (the region), the
encoder output is gathered, and the CTC head, CTC and the decoder run on
the whole clip alike on every seq rank; those loss terms are weighted by
1/S in the backward (``sequence.replicated``), so the step sums every
gradient over data x seq. The metrics are unscaled.

The decoding hooks (``ctc_log_probs``, ``decoder_init_cache``,
``decoder_step``, ``decoder_precompute_memory``) feed the encoder output to
the decoder as it is, without ``proj_decoder``, as the JAX package's hooks
do; a model whose encoder and decoder widths differ trains but cannot
decode there, and raises here.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from syncvsr_tpu_torch.config import ModelConfig
from syncvsr_tpu_torch.models.conformer import ConformerEncoder
from syncvsr_tpu_torch.models.decoder import TransformerDecoder
from syncvsr_tpu_torch.models.frontend import build_frontend
from syncvsr_tpu_torch.models.layers import Dense, dropout, remat
from syncvsr_tpu_torch.models.word import SyncHead
from syncvsr_tpu_torch.ops.ctc import ctc_loss
from syncvsr_tpu_torch.ops.masking import (
    add_sos_eos,
    decoder_accuracy,
    label_smoothing_kl,
    length_mask,
)
from syncvsr_tpu_torch.parallel import collectives, sequence
from syncvsr_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


class SentenceVSRModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        enc, dec, codec = cfg.encoder, cfg.decoder, cfg.codec
        self.sos = self.eos = cfg.labels - 1
        self.frontend = build_frontend(cfg.frontend, self.dtype)
        self.encoder = ConformerEncoder(
            self.frontend.out_dim, enc.layers, enc.dim, enc.heads,
            int(enc.hidden_ratio * enc.dim), enc.conv_kernel, enc.macaron,
            enc.mlp_dropout, enc.msa_dropout, self.dtype, remat=cfg.remat)
        self.ctc_head = Dense(enc.dim, cfg.labels, torch.float32, lecun=True)
        self.decoder = TransformerDecoder(cfg.labels, dec.layers, dec.dim, dec.heads,
                                          dec.hidden, dec.dropout, self.dtype)
        self.audio_classifier = SyncHead(enc.dim, codec.audio_alignment, codec.vq_groups,
                                         codec.audio_vocab_size)
        if enc.dim != dec.dim:
            self.proj_decoder = Dense(enc.dim, dec.dim, self.dtype, lecun=True)

    def frame_lengths(self, inputs: Tensor, lengths: Tensor) -> Tensor:
        """Sample counts -> frame counts for a raw-audio frontend; video
        lengths are frame counts already."""
        if self.cfg.frontend.kind == "conv1d_resnet":
            return lengths // 640
        return lengths

    def encode(self, videos: Tensor, lengths: Tensor, det: bool = True,
               gen: Optional[torch.Generator] = None) -> Tensor:
        """Frontend + Conformer: [B, T, ...] -> [B, T, encoder dim] (in the
        time-split region of a sequence-parallel step, this rank's frames
        of both). With ``model.remat`` in training the frontend's
        activations are recomputed in the backward too: at the 1800-frame
        bucket its per-frame activations, not the Conformer's, take most
        memory."""
        with span("model.frontend"):
            if self.cfg.remat and not det:
                feats = remat(None, lambda v: self.frontend(v, train=True), videos)
            else:
                feats = self.frontend(videos, train=not det)
        pad_mask = length_mask(self.frame_lengths(videos, lengths),
                               sequence.total(feats.shape[1]))
        with span("model.encoder"):
            return self.encoder(feats, pad_mask, det, gen)

    def forward(self, videos: Tensor, lengths: Tensor, labels: Tensor, audio_tokens: Tensor,
                sample_weight: Optional[Tensor] = None, det: bool = True,
                mixup_gen: Optional[torch.Generator] = None,
                dropout_gen: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        cfg, codec = self.cfg, self.cfg.codec
        a = codec.audio_alignment
        with sequence.region():
            # the frontend, the Conformer and the sync head on this rank's
            # frames [t0, t0 + t) under sequence parallel
            x = self.encode(videos, lengths, det, dropout_gen)
            lengths = self.frame_lengths(videos, lengths)
            t, t0 = x.shape[1], sequence.start()
            pad_mask = sequence.local(length_mask(lengths, sequence.total(t)), 1)

            # frame-level audio sync loss over the valid frames only
            audio_tokens = audio_tokens[:, t0 * a:(t0 + t) * a]
            frame_valid = pad_mask.repeat_interleave(a, dim=1)
            if sample_weight is not None:
                frame_valid = frame_valid & (sample_weight[:, None] > 0)
            masked_tokens = torch.where(frame_valid[:, :, None], audio_tokens,
                                        torch.full_like(audio_tokens, -1))
            loss_audio = self.audio_classifier(x.float(), masked_tokens,
                                               chunk=128 if t > 256 else None)
            audio_term = sequence.replicated(loss_audio)
            if det:
                slots = collectives.global_sum((masked_tokens >= 0).sum().float())
        # the rest on the whole clip, alike on the seq ranks
        x = sequence.gather_time(x)
        t = x.shape[1]
        pad_mask = length_mask(lengths, t)

        # CTC
        label_lengths = (labels != -1).sum(1)
        ctc_logits = self.ctc_head(
            dropout(x, cfg.encoder.mlp_dropout, det, dropout_gen).float())
        loss_ctc = ctc_loss(ctc_logits, lengths, labels, label_lengths, blank_id=0,
                            sample_weight=sample_weight)

        # attention decoder
        memory = self.proj_decoder(x) if hasattr(self, "proj_decoder") else x
        ys_in, ys_out, ys_lengths = add_sos_eos(labels, self.sos, self.eos, -1)
        with span("model.decoder"):
            dec_logits = self.decoder(ys_in, ys_lengths, memory, pad_mask, det, dropout_gen)
        loss_att = label_smoothing_kl(dec_logits, ys_out, cfg.labels, cfg.lsm_weight,
                                      ignore_id=-1, sample_weight=sample_weight)
        acc = decoder_accuracy(dec_logits, ys_out, ignore_id=-1, sample_weight=sample_weight)

        loss = (sequence.replicated(cfg.mtlalpha * loss_ctc
                                    + (1.0 - cfg.mtlalpha) * loss_att)
                + cfg.sync_lambda * audio_term)
        out = {"loss": loss, "loss_ctc": loss_ctc, "loss_att": loss_att,
               "loss_audio": loss_audio, "decoder_acc": acc}
        if det:
            # the true denominators of the token and sync-slot means, for
            # aggregation across batches
            valid_out = ys_out != -1
            if sample_weight is not None:
                valid_out = valid_out & (sample_weight[:, None] > 0)
            out["_tokens"] = collectives.global_sum(valid_out.sum().float())
            out["_slots"] = slots
        return out

    # ---- decoding hooks (used by syncvsr_tpu_torch.decode) ------------------
    def _check_decodable(self) -> None:
        enc, dec = self.cfg.encoder.dim, self.cfg.decoder.dim
        if enc != dec:
            raise ValueError(
                f"cannot decode: the encoder is {enc} wide and the decoder {dec}; the "
                "decoding hooks feed the encoder output to the decoder without "
                "proj_decoder, as the JAX package's do")

    def ctc_log_probs(self, encoded: Tensor) -> Tensor:
        return torch.log_softmax(self.ctc_head(encoded.float()), dim=-1)

    def decoder_init_cache(self, batch: int, max_len: int) -> Dict[str, Tensor]:
        return self.decoder.init_cache(batch, max_len)

    def decoder_step(self, y_prev: Tensor, pos: int, cache: Dict[str, Tensor],
                     memory: Optional[Tensor], memory_mask: Optional[Tensor],
                     mem_kv: Optional[Dict] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
        self._check_decodable()
        return self.decoder.step(y_prev, pos, cache, memory, memory_mask, mem_kv=mem_kv)

    def decoder_precompute_memory(self, memory: Tensor) -> Dict[str, Dict[str, Tensor]]:
        self._check_decodable()
        return self.decoder.precompute_memory(memory)

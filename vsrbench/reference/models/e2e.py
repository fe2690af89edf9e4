# Frozen copy of syncvsr_tpu_torch/models/e2e.py, part of the benchmark's plain reference.
"""Sentence-level VSR model (port of ``syncvsr_tpu/models/e2e.py``):
video frontend + Conformer encoder + CTC head + attention decoder + sync
head.

    loss = mtlalpha * ctc + (1 - mtlalpha) * att + sync_lambda * audio

with att the label-smoothed KL divided by the batch, ctc batch-averaged
and the per-frame audio sync CE over the valid frames only. Token
conventions: blank 0, sos = eos = labels - 1, ignore -1. In train mode
(``det=False``) dropout draws from ``dropout_gen``; ``mixup_gen`` is
accepted for the train step's calling shape and not used (the sentence
recipe has no CutMix). (The port's raw-audio frontend and decoding hooks
run in no cell and are not copied.)
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from vsrbench.reference.config import ModelConfig
from vsrbench.reference.models.conformer import ConformerEncoder
from vsrbench.reference.models.decoder import TransformerDecoder
from vsrbench.reference.models.frontend import build_frontend
from vsrbench.reference.models.layers import Dense, dropout, remat
from vsrbench.reference.models.word import SyncHead
from vsrbench.reference.ops.ctc import ctc_loss
from vsrbench.reference.ops.masking import (
    add_sos_eos,
    decoder_accuracy,
    label_smoothing_kl,
    length_mask,
)

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

    def encode(self, videos: Tensor, lengths: Tensor, det: bool = True,
               gen: Optional[torch.Generator] = None) -> Tensor:
        """Frontend + Conformer: [B, T, ...] -> [B, T, encoder dim]. With
        ``model.remat`` in training the frontend's
        activations are recomputed in the backward too: at the 1800-frame
        bucket its per-frame activations, not the Conformer's, take most
        memory."""
        if self.cfg.remat and not det:
            feats = remat(None, lambda v: self.frontend(v, train=True), videos)
        else:
            feats = self.frontend(videos, train=not det)
        pad_mask = length_mask(lengths, feats.shape[1])
        return self.encoder(feats, pad_mask, det, gen)

    def forward(self, videos: Tensor, lengths: Tensor, labels: Tensor, audio_tokens: Tensor,
                sample_weight: Optional[Tensor] = None, det: bool = True,
                mixup_gen: Optional[torch.Generator] = None,
                dropout_gen: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        cfg, codec = self.cfg, self.cfg.codec
        a = codec.audio_alignment
        x = self.encode(videos, lengths, det, dropout_gen)
        t = x.shape[1]
        pad_mask = length_mask(lengths, t)

        # frame-level audio sync loss over the valid frames only
        audio_tokens = audio_tokens[:, :t * a]
        frame_valid = pad_mask.repeat_interleave(a, dim=1)
        if sample_weight is not None:
            frame_valid = frame_valid & (sample_weight[:, None] > 0)
        masked_tokens = torch.where(frame_valid[:, :, None], audio_tokens,
                                    torch.full_like(audio_tokens, -1))
        loss_audio = self.audio_classifier(x.float(), masked_tokens,
                                           chunk=128 if t > 256 else None)

        # CTC
        label_lengths = (labels != -1).sum(1)
        ctc_logits = self.ctc_head(
            dropout(x, cfg.encoder.mlp_dropout, det, dropout_gen).float())
        loss_ctc = ctc_loss(ctc_logits, lengths, labels, label_lengths, blank_id=0,
                            sample_weight=sample_weight)

        # attention decoder
        memory = self.proj_decoder(x) if hasattr(self, "proj_decoder") else x
        ys_in, ys_out, ys_lengths = add_sos_eos(labels, self.sos, self.eos, -1)
        dec_logits = self.decoder(ys_in, ys_lengths, memory, pad_mask, det, dropout_gen)
        loss_att = label_smoothing_kl(dec_logits, ys_out, cfg.labels, cfg.lsm_weight,
                                      ignore_id=-1, sample_weight=sample_weight)
        acc = decoder_accuracy(dec_logits, ys_out, ignore_id=-1, sample_weight=sample_weight)

        loss = (cfg.mtlalpha * loss_ctc + (1.0 - cfg.mtlalpha) * loss_att
                + cfg.sync_lambda * loss_audio)
        out = {"loss": loss, "loss_ctc": loss_ctc, "loss_att": loss_att,
               "loss_audio": loss_audio, "decoder_acc": acc}
        if det:
            # the true denominators of the token and sync-slot means, for
            # aggregation across batches
            valid_out = ys_out != -1
            if sample_weight is not None:
                valid_out = valid_out & (sample_weight[:, None] > 0)
            out["_tokens"] = valid_out.sum().float()
            out["_slots"] = (masked_tokens >= 0).sum().float()
        return out

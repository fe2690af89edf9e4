"""Word-level VSR model, transformer path (port of
``syncvsr_tpu/models/word.py``): video or landmark frontend (landmark
frames equal to the -100 pad sentinel are zeroed first) + word-boundary
channel + CLS token + rotary transformer + word head + sync head.

Loss: word cross-entropy (label-smoothed, soft under CutMix) plus
``sync_lambda`` x the per-frame audio-token cross-entropy. In train mode
(``det=False``) CutMix samples from the ``mixup_gen`` CPU generator and
dropout draws from ``dropout_gen`` on the activations' device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from syncvsr_tpu_torch.config import ModelConfig
from syncvsr_tpu_torch.models.frontend import build_frontend
from syncvsr_tpu_torch.models.layers import Dense, dropout, trunc_normal_
from syncvsr_tpu_torch.models.transformer import TransformerEncoder
from syncvsr_tpu_torch.ops.cuda_sync import fused_sync_cross_entropy
from syncvsr_tpu_torch.ops.cutmix import cutmix_keep, sample_cutmix, temporal_cutmix_apply
from syncvsr_tpu_torch.ops.masking import weighted_mean
from syncvsr_tpu_torch.ops.sync_loss import sync_cross_entropy

Tensor = torch.Tensor


def smooth_labels(onehot: Tensor, smoothing: float) -> Tensor:
    if smoothing == 0.0:
        return onehot
    return onehot * (1.0 - smoothing) + smoothing / onehot.shape[-1]


class SyncHead(nn.Module):
    """Per-frame audio-token head: ``weight`` [A*G*V, D], ``bias`` [A*G*V].
    On a CUDA tensor the loss runs the fused projection + CE kernel (K1, or
    K2 for a wide head); on a CPU tensor the plain (chunked when ``chunk``
    is given) path, as the JAX head dispatches on the backend. ``chunk`` is
    the backward's time chunk; the fused path defaults it to min(T, 128)."""

    def __init__(self, dim: int, alignment: int, groups: int, vocab: int):
        super().__init__()
        self.alignment, self.groups, self.vocab = alignment, groups, vocab
        out = alignment * groups * vocab
        self.weight = nn.Parameter(trunc_normal_(torch.empty(out, dim)))
        self.bias = nn.Parameter(torch.zeros(out))

    def forward(self, features: Tensor, tokens: Tensor,
                chunk: Optional[int] = None) -> Tensor:
        kernel = self.weight.t()  # [D, A*G*V], the flax layout
        if features.is_cuda:
            bwd_chunk = chunk or min(max(features.shape[1], 8), 128)
            return fused_sync_cross_entropy(features, kernel, self.bias, tokens,
                                            self.alignment, self.groups, self.vocab,
                                            bwd_chunk)
        return sync_cross_entropy(features, kernel, self.bias, tokens, self.alignment,
                                  self.groups, self.vocab, chunk=chunk)


class WordVSRModel(nn.Module):
    def __init__(self, cfg: ModelConfig, cutmix_alpha: float = 1.0, use_cutmix: bool = True):
        super().__init__()
        self.cfg = cfg
        self.cutmix_alpha = cutmix_alpha
        self.use_cutmix = use_cutmix
        self.dtype = getattr(torch, cfg.dtype)
        enc, fe, codec = cfg.encoder, cfg.frontend, cfg.codec
        self.frontend = build_frontend(fe, self.dtype, embed_dim=enc.dim)
        width = self.frontend.out_dim
        if width != enc.dim:
            self.frontend_proj = Dense(width, enc.dim, self.dtype)
        stream = enc.dim + (1 if cfg.use_word_boundary else 0)
        self.cls_token = nn.Parameter(trunc_normal_(torch.empty(1, 1, stream)))
        self.encoder = TransformerEncoder(
            stream, enc.layers, enc.dim, enc.heads,
            enc.hidden or int(enc.hidden_ratio * enc.dim), enc.use_rmsnorm, enc.use_glu,
            enc.rope, enc.rope_dim, enc.msa_dropout, enc.mlp_dropout, enc.droppath, self.dtype)
        self.category_classifier = Dense(stream, cfg.labels, torch.float32)
        self.audio_classifier = SyncHead(stream, codec.audio_alignment, codec.vq_groups,
                                         codec.audio_vocab_size)

    def forward(self, inputs: Tensor, labels: Tensor, audio_tokens: Tensor,
                word_mask: Optional[Tensor] = None,
                attention_mask: Optional[Tensor] = None,
                sample_weight: Optional[Tensor] = None, det: bool = True,
                mixup_gen: Optional[torch.Generator] = None,
                dropout_gen: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        # ``attention_mask`` belongs to the TCN path; the transformer path ignores it
        cfg, enc, codec, dtype = self.cfg, self.cfg.encoder, self.cfg.codec, self.dtype
        if inputs.dim() == 3:   # landmark pad sentinel -> 0
            inputs = torch.where(inputs == -100.0, torch.zeros_like(inputs), inputs)
        onehot = F.one_hot(labels.long(), cfg.labels).float() if labels.dim() == 1 else labels
        t_in = inputs.shape[1]
        need = t_in * codec.audio_alignment
        if audio_tokens.shape[1] < need:
            raise ValueError(
                f"audio_tokens has {audio_tokens.shape[1]} rows but {need} are required "
                f"({t_in} frames x alignment {codec.audio_alignment}); check the codec "
                f"config against the token pkls")
        audio_tokens = audio_tokens[:, :need]
        if sample_weight is not None:
            # padded rows contribute nothing to the sync loss (-1 = ignore)
            audio_tokens = torch.where(sample_weight[:, None, None] > 0, audio_tokens,
                                       torch.full_like(audio_tokens, -1))
        if not det:
            onehot = smooth_labels(onehot, cfg.label_smoothing)
            if self.use_cutmix and self.cutmix_alpha > 0:
                keep = cutmix_keep(t_in, *sample_cutmix(mixup_gen, self.cutmix_alpha))
                inputs, onehot, audio_tokens, word_mask = temporal_cutmix_apply(
                    inputs, onehot, audio_tokens, word_mask, keep)

        hidden = self.frontend(inputs, train=not det)               # [B, T, width]
        if hasattr(self, "frontend_proj"):
            hidden = self.frontend_proj(hidden)
        if cfg.use_word_boundary:
            if word_mask is None:
                raise ValueError("use_word_boundary needs a word_mask")
            hidden = torch.cat((hidden, word_mask[:, :, None].to(dtype)), dim=-1)
        b, t, dim_backbone = hidden.shape
        cls = self.cls_token
        if cfg.use_word_boundary:  # the CLS token carries no boundary bit
            cls = torch.cat((cls[..., :-1], torch.zeros_like(cls[..., -1:])), dim=-1)
        hidden = torch.cat((cls.to(dtype).expand(b, 1, dim_backbone), hidden), dim=1)
        hidden = dropout(hidden, enc.emb_dropout, det, dropout_gen)
        encoded = self.encoder(hidden, det=det, gen=dropout_gen)

        logits = self.category_classifier(encoded[:, 0].float())
        loss_word = weighted_mean(-(onehot * torch.log_softmax(logits, -1)).sum(-1),
                                  sample_weight)
        loss_audio = self.audio_classifier(encoded[:, 1:].float(), audio_tokens)
        loss = loss_word + cfg.sync_lambda * loss_audio
        hard = onehot.argmax(-1)
        acc1 = weighted_mean((logits.argmax(-1) == hard).float(), sample_weight)
        k5 = min(5, logits.shape[-1])
        acc5 = weighted_mean((logits.topk(k5, -1).indices == hard[:, None]).any(1).float(),
                             sample_weight)
        out = {"loss": loss, "loss_word": loss_word, "loss_audio": loss_audio,
               "acc1": acc1, "acc5": acc5}
        if det:
            # loss_audio is a sync-slot mean: eval aggregation needs its denominator
            out["_slots"] = (audio_tokens >= 0).sum().float()
        return out

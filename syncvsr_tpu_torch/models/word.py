"""Word-level VSR model (port of ``syncvsr_tpu/models/word.py``).

Transformer path: video or landmark frontend (landmark frames equal to the
-100 pad sentinel are zeroed first) + word-boundary channel + CLS token +
rotary transformer + word head + sync head. Loss: word cross-entropy
(label-smoothed, soft under CutMix) plus ``sync_lambda`` x the per-frame
audio-token cross-entropy.

TCN path (``encoder.kind`` "dense_tcn", "tcn", "mstcn"; ``_tcn_forward``):
batch mixup of the inputs, frontend + word-boundary channel (not mixed),
the temporal conv net, mean pooling under ``attention_mask``, word head and
sync head on the pooled and per-frame features; in train mode each loss is
lerped between the clip's own targets and the rolled batch's by the mixup
weight, so the sync head runs twice.

Under sequence parallel (``parallel/sequence.py``) the frontend runs on
this rank's frames and its features are gathered before the
word-boundary channel, the CLS token and the encoder, which run on the
whole clip alike on every seq rank (the loss weighted by 1/S in the
backward); CutMix's keep mask covers the whole clip, its slice the
rank's frames. A clip whose length does not divide the seq axis stays
whole on every seq rank.

In train mode (``det=False``) CutMix and mixup sample from the
``mixup_gen`` CPU generator and dropout draws from ``dropout_gen`` on the
activations' device. ``model.remat`` recomputes the transformer's blocks in
the backward; the TCN path ignores it, as the JAX package's does.
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
from syncvsr_tpu_torch.ops.cutmix import (
    batch_mixup_apply,
    cutmix_keep,
    sample_cutmix,
    sample_mixup,
    temporal_cutmix_apply,
)
from syncvsr_tpu_torch.ops.masking import weighted_mean
from syncvsr_tpu_torch.ops.sync_loss import regroup_tokens, sync_cross_entropy
from syncvsr_tpu_torch.parallel import collectives, sequence, tensor
from syncvsr_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

TCN_KINDS = ("dense_tcn", "tcn", "mstcn")


def smooth_labels(onehot: Tensor, smoothing: float) -> Tensor:
    if smoothing == 0.0:
        return onehot
    return onehot * (1.0 - smoothing) + smoothing / onehot.shape[-1]


class SyncHead(nn.Module):
    """Per-frame audio-token head: ``weight`` [A*G*V, D], ``bias`` [A*G*V].
    On a CUDA tensor the loss runs the fused projection + CE kernel (K1, or
    K2 for a wide head); on a CPU tensor the plain (chunked when ``chunk``
    is given) path, as the JAX head dispatches on the backend. ``chunk`` is
    the backward's time chunk; the fused path defaults it to min(T, 128).

    Split over the model axis (tensor parallel: the flax kernel [D, S*V] on
    its trailing dim), rank m holds the weight of slots [m*S/M, (m+1)*S/M):
    the loss runs on those slots only (K1 or K2 by the local weight's
    size), its (sum, count) partials are summed over every rank, and the
    features' gradient shares over the model group (``copy_to_model``).
    Where S does not split evenly the weight is gathered whole (one
    all-gather) and the kernel runs as on one rank."""

    def __init__(self, dim: int, alignment: int, groups: int, vocab: int):
        super().__init__()
        self.alignment, self.groups, self.vocab = alignment, groups, vocab
        out = alignment * groups * vocab
        self.weight = nn.Parameter(trunc_normal_(torch.empty(out, dim)))
        self.bias = nn.Parameter(torch.zeros(out))

    def forward(self, features: Tensor, tokens: Tensor,
                chunk: Optional[int] = None) -> Tensor:
        weight, bias = self.weight, self.bias
        alignment, groups = self.alignment, self.groups
        split = tensor.split_dim(weight) is not None
        if split:
            m, n = tensor.index()
            slots = alignment * groups
            if slots % n:
                weight, split = tensor.whole(weight), False
            else:   # this rank's slots: tokens [B, T, S/M] as (alignment 1, S/M groups)
                b, t = features.shape[:2]
                s = slots // n
                tokens = regroup_tokens(tokens, b, t, alignment, groups)[..., m * s:(m + 1) * s]
                alignment, groups = 1, s
                features = tensor.copy_to_model(features)
                bias = tensor.local(bias, 0)
        kernel = weight.t()  # [D, A*G*V], the flax layout
        if features.is_cuda:
            bwd_chunk = chunk or min(max(features.shape[1], 8), 128)
            return fused_sync_cross_entropy(features, kernel, bias, tokens, alignment,
                                            groups, self.vocab, bwd_chunk, model=split)
        return sync_cross_entropy(features, kernel, bias, tokens, alignment, groups,
                                  self.vocab, chunk=chunk, model=split)


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
        if enc.kind in TCN_KINDS:
            self._build_tcn(width)
            return
        if width != enc.dim:
            self.frontend_proj = Dense(width, enc.dim, self.dtype)
        stream = enc.dim + (1 if cfg.use_word_boundary else 0)
        self.cls_token = nn.Parameter(trunc_normal_(torch.empty(1, 1, stream)))
        self.encoder = TransformerEncoder(
            stream, enc.layers, enc.dim, enc.heads,
            enc.hidden or int(enc.hidden_ratio * enc.dim), enc.use_rmsnorm, enc.use_glu,
            enc.rope, enc.rope_dim, enc.msa_dropout, enc.mlp_dropout, enc.droppath, self.dtype,
            remat=cfg.remat)
        self.category_classifier = Dense(stream, cfg.labels, torch.float32)
        self.audio_classifier = SyncHead(stream, codec.audio_alignment, codec.vq_groups,
                                         codec.audio_vocab_size)

    def _build_tcn(self, width: int) -> None:
        from syncvsr_tpu_torch.models.dense_tcn import DenseTCN
        from syncvsr_tpu_torch.models.tcn import MultibranchTemporalConvNet, TemporalConvNet

        cfg, enc, codec = self.cfg, self.cfg.encoder, self.cfg.codec
        cin = width + (1 if cfg.use_word_boundary else 0)
        if enc.kind == "tcn":
            self.encoder = TemporalConvNet(cin, enc.tcn_channels, enc.tcn_kernel,
                                           enc.tcn_dropout, dwpw=enc.tcn_dwpw, dtype=self.dtype)
        elif enc.kind == "mstcn":
            self.encoder = MultibranchTemporalConvNet(
                cin, enc.tcn_channels, enc.tcn_kernel_sizes, enc.tcn_dropout,
                dwpw=enc.tcn_dwpw, dtype=self.dtype)
        else:   # the JAX package leaves DenseTCN at its default dropout, 0.2
            self.encoder = DenseTCN(cin, enc.tcn_growth_rates, enc.tcn_blocks,
                                    enc.tcn_kernel_sizes, enc.tcn_dilations,
                                    enc.tcn_reduced_size, use_se=enc.tcn_se, dtype=self.dtype)
        out = self.encoder.out_dim
        self.category_classifier = Dense(out, cfg.labels, torch.float32)
        self.audio_classifier = SyncHead(out, codec.audio_alignment, codec.vq_groups,
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
        t_in = sequence.total(inputs.shape[1])   # the whole clip's frames
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
        if enc.kind in TCN_KINDS:
            return self._tcn_forward(inputs, onehot, audio_tokens, word_mask, attention_mask,
                                     sample_weight, det, mixup_gen, dropout_gen)
        if not det:
            onehot = smooth_labels(onehot, cfg.label_smoothing)
            if self.use_cutmix and self.cutmix_alpha > 0:
                keep = cutmix_keep(t_in, *sample_cutmix(mixup_gen, self.cutmix_alpha))
                inputs, onehot, audio_tokens, word_mask = temporal_cutmix_apply(
                    inputs, onehot, audio_tokens, word_mask, keep)

        with sequence.region(), span("model.frontend"):   # this rank's frames under seq
            hidden = self.frontend(inputs, train=not det)           # [B, T, width]
            if hasattr(self, "frontend_proj"):
                hidden = self.frontend_proj(hidden)
        hidden = sequence.gather_time(hidden)
        if cfg.use_word_boundary:
            if word_mask is None:
                raise ValueError("use_word_boundary needs a word_mask")
            hidden = torch.cat((hidden, word_mask[:, :, None].to(dtype)), dim=-1)
        b, t, dim_backbone = hidden.shape
        cls = tensor.whole(self.cls_token)
        if cfg.use_word_boundary:  # the CLS token carries no boundary bit
            cls = torch.cat((cls[..., :-1], torch.zeros_like(cls[..., -1:])), dim=-1)
        hidden = torch.cat((cls.to(dtype).expand(b, 1, dim_backbone), hidden), dim=1)
        hidden = dropout(hidden, enc.emb_dropout, det, dropout_gen)
        with span("model.encoder"):
            encoded = self.encoder(hidden, det=det, gen=dropout_gen)

        logits = self.category_classifier(encoded[:, 0].float())
        loss_word = weighted_mean(-(onehot * torch.log_softmax(logits, -1)).sum(-1),
                                  sample_weight)
        loss_audio = self.audio_classifier(encoded[:, 1:].float(), audio_tokens)
        return self._outputs(logits, onehot, loss_word, loss_audio, audio_tokens,
                             sample_weight, det)

    def _outputs(self, logits, onehot, loss_word, loss_audio, audio_tokens, sample_weight,
                 det):
        """The step's metrics: the composite loss, its parts, top-1/top-5
        accuracy against the (soft) labels' argmax, and in eval the sync
        slots' count."""
        loss = sequence.replicated(loss_word + self.cfg.sync_lambda * loss_audio)
        hard = onehot.argmax(-1)
        acc1 = weighted_mean((logits.argmax(-1) == hard).float(), sample_weight)
        k5 = min(5, logits.shape[-1])
        acc5 = weighted_mean((logits.topk(k5, -1).indices == hard[:, None]).any(1).float(),
                             sample_weight)
        out = {"loss": loss, "loss_word": loss_word, "loss_audio": loss_audio,
               "acc1": acc1, "acc5": acc5}
        if det:
            # loss_audio is a sync-slot mean: eval aggregation needs its denominator
            out["_slots"] = collectives.global_sum((audio_tokens >= 0).sum().float())
        return out

    def _tcn_forward(self, inputs, onehot, audio_tokens, word_mask, attention_mask,
                     sample_weight, det, mixup_gen, dropout_gen):
        """``_dense_tcn_path`` of the JAX model (its mixup ignores
        ``use_cutmix``, as there; labels are not smoothed)."""
        cfg, dtype = self.cfg, self.dtype
        mixing = not det and self.cutmix_alpha > 0
        if mixing:
            lam = sample_mixup(mixup_gen, self.cutmix_alpha)
            inputs = batch_mixup_apply(inputs, lam)
            lam = lam.to(inputs.device)   # f32, for the losses' lerp
        with sequence.region(), span("model.frontend"):
            hidden = self.frontend(inputs, train=not det)           # [B, T, width]
        hidden = sequence.gather_time(hidden)
        if cfg.use_word_boundary:
            if word_mask is None:
                raise ValueError("use_word_boundary needs a word_mask")
            hidden = torch.cat((hidden, word_mask[:, :, None].to(dtype)), dim=-1)
        with span("model.encoder"):
            feats = self.encoder(hidden, not det, dropout_gen).float()   # [B, T, C]
        if attention_mask is None:
            am = torch.ones(feats.shape[:2] + (1,), device=feats.device)
        else:
            am = attention_mask.float()[:, :, None]
        pooled = (feats * am).sum(1) / (am.sum(1) + 1e-6)
        logits = self.category_classifier(pooled)
        logp = torch.log_softmax(logits, -1)

        def ce(target):
            return weighted_mean(-(target * logp).sum(-1), sample_weight)

        sync = self.audio_classifier
        if mixing:
            roll = collectives.global_roll
            loss_word = (1.0 - lam) * ce(onehot) + lam * ce(roll(onehot))
            loss_audio = ((1.0 - lam) * sync(feats, audio_tokens)
                          + lam * sync(feats, roll(audio_tokens)))
        else:
            loss_word = ce(onehot)
            loss_audio = sync(feats, audio_tokens)
        return self._outputs(logits, onehot, loss_word, loss_audio, audio_tokens,
                             sample_weight, det)

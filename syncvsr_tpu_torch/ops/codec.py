"""In-step frozen vq-wav2vec tokenizer (port of ``syncvsr_tpu/ops/codec.py``).

The reference quantizes raw audio inside the train step with a frozen
vq-wav2vec quantizer (e2e_asr_transformer.py:167-174,195-196: pad 0.5 s,
conv feature extractor, kmeans ``forward_idx``, truncate to
``T * alignment``). ``make_instep_tokenizer`` is that batch hook: the
512-wide conv stack and the codebook search are ``F.conv1d`` /
``F.group_norm`` / ``torch.matmul`` under ``torch.no_grad()``, and the codec
weights are frozen device tensors held in the hook's closure, outside the
model, the optimizer and every checkpoint (tokens are integer argmins with
no gradient path).

Semantics are the JAX package's: GroupNorm statistics span the padded time
axis, because the reference feeds the padded batch too
(e2e_asr_transformer.py:195); the codebook search is
argmin_v (||e_v||^2 - 2 z.e_v). The tokens are integer argmins, so the conv
stack and the codebook product run in full f32 on the card
(``full_f32``): TF32, cuDNN's default for f32 convolutions, moves the
features by ~1e-3 relative and flips argmins against the f32 tokens of the
CPU and of the JAX package. Only the codec's own calls are scoped; the
rest of the step keeps the process's settings.

``tools/tokenize_audio.py``'s ``vq`` route tokenizes through ``vq_tokens``
too. A checkpoint's ``activation``, ``skip_connections_feat`` /
``residual_scale`` and ``log_compression`` arguments, which fairseq's
feature extractor honours, reach ``vq_feature_extractor`` through
``load_vq_codec``'s geometry; their defaults (ReLU, no skip connections,
log compression) are the JAX package's in-step codec.
"""

from __future__ import annotations

import contextlib
import math
from functools import lru_cache
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from syncvsr_tpu_torch.utils.device import resolve_device

SAMPLE_RATE = 16_000
# (dim, kernel, stride) — fairseq wav2vec default conv_feature_layers; total
# hop 160 samples -> 100 Hz token rate, 4 tokens per 25 fps video frame
VQ_CONV_LAYERS = ((512, 10, 5), (512, 8, 4), (512, 4, 2), (512, 4, 2),
                  (512, 4, 2), (512, 1, 1), (512, 1, 1), (512, 1, 1))
_DEFAULT_STRIDES = tuple(s for _, _, s in VQ_CONV_LAYERS)
_ACTIVATIONS = {"relu": F.relu, "gelu": F.gelu}


@contextlib.contextmanager
def full_f32():
    """cuDNN convolutions and cuBLAS matmuls in IEEE f32 (no TF32) inside the
    block; the process's settings are restored after."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


def vq_feature_extractor(params: Dict[str, Any], wav: torch.Tensor,
                         log_compression: bool = True,
                         strides: Tuple[int, ...] = _DEFAULT_STRIDES,
                         activation: str = "relu",
                         residual_scale: Optional[float] = None) -> torch.Tensor:
    """[B, S] float32 -> [B, C, T'] features (100 Hz), torch's NCW layout.

    ``params`` is ``load_vq_codec``'s (``conv_<i>``: ``weight`` [Cout, Cin,
    K], optional ``scale``/``bias``). ``residual_scale`` set turns on
    fairseq's ``skip_connections_feat``: a layer whose width equals its
    input's adds the input, strided to its length, times the scale."""
    act = _ACTIVATIONS[activation]
    x = wav.float()[:, None]                              # [B, 1, S]
    for i, stride in enumerate(strides):
        layer = params[f"conv_{i}"]
        residual = x if residual_scale is not None else None
        x = F.conv1d(x, layer["weight"], stride=stride)
        x = act(F.group_norm(x, 1, layer.get("scale"), layer.get("bias"), eps=1e-5))
        if residual is not None and x.shape[1] == residual.shape[1]:
            t, r_t = x.shape[2], residual.shape[2]
            x = (x + residual[..., ::r_t // t][..., :t]) * residual_scale
    if log_compression:
        x = torch.log1p(x.abs())
    return x


def vq_tokens(params: Dict[str, Any], wav: torch.Tensor,
              strides: Tuple[int, ...] = _DEFAULT_STRIDES,
              **features) -> torch.Tensor:
    """[B, S] waveform -> [B, T', G] int32 kmeans codebook indices.

    The grouped 1x1 projection is one ``groups=G`` conv; the codebook search
    is one [B*T', d] x [d, V] product per group, argmin_v (||e_v||^2 -
    2 z.e_v), instead of materializing [B, T', G, V, d] differences.
    ``features`` go to ``vq_feature_extractor``."""
    with torch.no_grad(), full_f32():
        feats = vq_feature_extractor(params, wav, strides=strides, **features)
        proj = params["projection"]
        groups = proj["groups"]
        ze = F.conv1d(feats, proj["weight"], groups=groups)          # [B, C, T']
        ze = F.group_norm(ze, groups, proj.get("scale"), proj.get("bias"), eps=1e-5)
        b, c, t = ze.shape
        ze = ze.reshape(b, groups, c // groups, t)
        emb = params["embedding"]                                      # [G, d, V]
        dots = torch.matmul(ze.transpose(2, 3), emb)                   # [B, G, T', V]
        dist = params["embedding_sq"][None, :, None, :] - 2.0 * dots
        return dist.argmin(dim=-1).transpose(1, 2).to(torch.int32)    # [B, T', G]


def make_instep_tokenizer(codec_params: Dict[str, Any], alignment: int = 4,
                          audio_key: str = "audio", lengths_key: str = "lengths",
                          strides: Tuple[int, ...] = _DEFAULT_STRIDES,
                          **features) -> Callable:
    """Batch hook: replace the raw ``audio`` waveform [B, S] with in-step
    ``audio_tokens`` [B, Tframes*alignment, G] (reference
    e2e_asr_transformer.py:167-174 + the :195-196 truncation). Tokens past a
    sample's real frame length are -1 (ignored by the sync loss), as are
    the rows a conv-arithmetic shortfall leaves. Compose with the
    augmentation: ``aug_fn=aug.after(tokenize)`` (``ops.image.TrainAug``)."""

    def tokenize(batch: Dict[str, Any]) -> Dict[str, Any]:
        batch = dict(batch)
        wav = batch.pop(audio_key).float()                             # [B, S]
        num_frames = batch["videos"].shape[1] if "videos" in batch \
            else batch["inputs"].shape[1]
        wav = F.pad(wav, (0, SAMPLE_RATE // 2))                        # reference 0.5 s
        toks = vq_tokens(codec_params, wav, strides=strides, **features)
        need = num_frames * alignment
        toks = toks[:, :need]
        if toks.shape[1] < need:
            toks = F.pad(toks, (0, 0, 0, need - toks.shape[1]), value=-1)
        if lengths_key in batch:
            valid = torch.arange(need, device=toks.device)[None, :] < (
                batch[lengths_key][:, None] * alignment)
            toks = torch.where(valid[..., None], toks, -1)
        batch["audio_tokens"] = toks
        return batch

    return tokenize


def _torch_layout(params: Dict[str, Any], geometry: Dict[str, Any],
                  device: torch.device) -> Dict[str, Any]:
    """``convert_vq_wav2vec``'s flax-layout numpy tree -> the f32 device
    tensors ``vq_tokens`` reads: conv kernels [K, Cin, Cout] -> [Cout, Cin,
    K]; the per-group projection kernels [G, Ci/G, Co/G] -> one grouped
    conv's [Co, Ci/G, 1] (output group g reads input group g); the
    embedding [V, G, d] -> [G, d, V] with its squared norms [G, V]."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    out: Dict[str, Any] = {}
    for i in range(geometry["conv_layers"]):
        layer = params[f"conv_{i}"]
        out[f"conv_{i}"] = {"weight": dev(np.transpose(layer["kernel"], (2, 1, 0))),
                            **{k: dev(layer[k]) for k in ("scale", "bias") if k in layer}}
    proj = params["projection"]
    kernel = np.asarray(proj["kernel"])                                # [G, Ci/G, Co/G]
    out["projection"] = {
        "weight": dev(np.concatenate([k.T for k in kernel])[:, :, None]),
        "groups": int(kernel.shape[0]),
        **{k: dev(proj[k]) for k in ("scale", "bias") if k in proj}}
    emb = np.asarray(params["embedding"], np.float32)                  # [V, G, d]
    out["embedding"] = dev(np.transpose(emb, (1, 2, 0)))
    out["embedding_sq"] = dev(np.sum(emb * emb, axis=-1).T)
    return out


@lru_cache(maxsize=None)
def _load(ckpt_path: str, device: torch.device):
    from syncvsr_tpu_torch.utils.torch_convert import convert_vq_wav2vec

    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    args = ckpt.get("args")
    params, geometry = convert_vq_wav2vec(ckpt.get("model", ckpt), args)
    # the feature extractor's options fairseq reads from the same args
    geometry = dict(geometry, features={
        "log_compression": bool(getattr(args, "log_compression", True)),
        "activation": "gelu" if getattr(args, "activation", "relu") == "gelu" else "relu",
        "residual_scale": (math.sqrt(float(getattr(args, "residual_scale", 0.5)))
                           if getattr(args, "skip_connections_feat", False) else None)})
    return _torch_layout(params, geometry, device), geometry


def load_vq_codec(ckpt_path: str, device: Optional[Union[str, torch.device]] = None
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A fairseq vq-wav2vec checkpoint (``.pt``: ``args`` + ``model`` state
    dict, read without fairseq) -> (frozen device tensors, geometry), on the
    card unless ``device`` says otherwise; built once a process per
    (path, device). ``geometry`` is ``convert_vq_wav2vec``'s plus
    ``features``, the keyword arguments of ``vq_feature_extractor`` that the
    checkpoint's args set."""
    return _load(ckpt_path, resolve_device(device))

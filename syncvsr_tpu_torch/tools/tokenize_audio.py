"""Offline audio tokenizer: raw waveforms -> quantized audio-token pkls
(port of ``syncvsr_tpu/tools/tokenize_audio.py``).

The reference quantizes audio inside the train step with a frozen
vq-wav2vec / wav2vec2 quantizer (LRW/video/src/lightning.py:69-79,121-131;
LRS/video/espnet/nets/pytorch_backend/e2e_asr_transformer.py:145-180). For a
fixed dataset this tool runs the same math once and writes
``{codec}_tokens`` pkls in the released-token layout that
``data.audio_root`` maps back onto the video pkls (LRW/video/src/data.py:
49-55). It runs on the GPU unless ``--device cpu`` is given; both codecs
run in full f32 there (no TF32: tokens are argmins/argmaxes).

Codecs (constants per LRW/video/src/lightning.py:57-67):
  * ``vq``: a fairseq vq-wav2vec kmeans checkpoint (``.pt``: ``args`` +
    ``model`` state dict, read without fairseq), tokenized by
    ``ops/codec.py::vq_tokens``, the in-step codec of the train step.
  * ``wav2vec2``: an HF ``Wav2Vec2ForPreTraining`` model directory, read
    without ``transformers``: ``config.json`` and the weights
    (``model.safetensors`` by its header and JSON index, or
    ``pytorch_model.bin`` by ``torch.load``), of which only the conv
    feature extractor, ``feature_projection.layer_norm`` and
    ``quantizer.weight_proj`` are read; the transformer encoder is never
    built. Tokens are the per-group argmax of the Gumbel quantizer's
    codebook logits over the feature projection's LayerNorm output (the
    deterministic eval path, reference lightning.py:121-131), per-group
    indices in [0, vocab) as the sync loss expects (the reference's
    flattened indices carry a ``group * vocab`` offset for g > 0).

Audio input: 16 kHz mono waveforms from ``.wav`` files (scipy) or from the
``audio`` key of video pkls (int16 or float numpy array, or ``{"array":
..., "sample_rate": ...}``).

Usage:
    python -m syncvsr_tpu_torch.tools.tokenize_audio \\
        --src /data/LRW --dst /data/LRW_tokens \\
        --codec wav2vec2 --model /models/wav2vec2-large-xlsr-53 [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from syncvsr_tpu_torch.ops.codec import SAMPLE_RATE, full_f32, load_vq_codec, vq_tokens
from syncvsr_tpu_torch.utils.device import resolve_device

Device = Optional[Union[str, torch.device]]


# ---------------------------------------------------------------------------
# Waveform IO
# ---------------------------------------------------------------------------

def to_waveform(obj) -> np.ndarray:
    """Any supported audio payload -> float32 mono waveform at 16 kHz."""
    if isinstance(obj, dict) and "array" in obj:
        sr = int(obj.get("sample_rate", SAMPLE_RATE))
        if sr != SAMPLE_RATE:
            raise ValueError(f"expected {SAMPLE_RATE} Hz audio, got {sr}")
        obj = obj["array"]
    wav = np.asarray(obj)
    # int16 scaling BEFORE the stereo downmix (mean() promotes to float64 and
    # would skip the 1/32768 normalization for stereo int16 input)
    if wav.dtype == np.int16:
        wav = wav.astype(np.float32) / 32768.0
    elif wav.dtype != np.float32:
        wav = wav.astype(np.float32)
    if wav.ndim == 2:  # [C, S] or [S, C] -> mono
        wav = wav.mean(axis=0 if wav.shape[0] <= 2 else 1)
    return wav


def read_wav(path: str) -> np.ndarray:
    from scipy.io import wavfile

    sr, wav = wavfile.read(path)
    if sr != SAMPLE_RATE:
        raise ValueError(f"{path}: expected {SAMPLE_RATE} Hz, got {sr}")
    return to_waveform(wav)


# ---------------------------------------------------------------------------
# wav2vec2 (an HF model directory, read without transformers)
# ---------------------------------------------------------------------------

_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16, "F64": torch.float64}


def read_safetensors(path: str, keys: Iterable[str]) -> Dict[str, torch.Tensor]:
    """The tensors ``keys`` of a safetensors file: an 8-byte little-endian
    header length, a JSON index of {name: dtype, shape, data_offsets}, then
    the data; only the named tensors' bytes are read."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        index = json.loads(f.read(n))
        out = {}
        for key in keys:
            if key not in index:
                continue
            meta = index[key]
            begin, end = meta["data_offsets"]
            f.seek(8 + n + begin)
            buf = bytearray(f.read(end - begin))
            out[key] = torch.frombuffer(buf, dtype=_SAFETENSORS_DTYPES[meta["dtype"]]
                                        ).reshape(meta["shape"])
    return out


class Wav2Vec2Quantizer:
    """The feature extractor and quantizer logits of an HF
    ``Wav2Vec2ForPreTraining`` directory, as f32 tensors on ``device``
    (``transformers``' ``Wav2Vec2FeatureEncoder``: ``feat_extract_norm``
    "group" (a per-channel GroupNorm after the first conv only) or "layer"
    (a LayerNorm over channels after every conv), ``conv_bias``,
    ``feat_extract_activation``; then ``feature_projection.layer_norm`` and
    ``quantizer.weight_proj``)."""

    _ACT = {"gelu": F.gelu, "relu": F.relu}

    def __init__(self, model_dir: str, device: torch.device):
        with open(os.path.join(model_dir, "config.json")) as f:
            cfg = json.load(f)
        self.norm = cfg.get("feat_extract_norm", "group")
        if self.norm not in ("group", "layer"):
            raise ValueError(f"feat_extract_norm {self.norm!r}: expected group or layer")
        self.act = self._ACT[cfg.get("feat_extract_activation", "gelu")]
        self.strides = list(cfg.get("conv_stride", (5, 2, 2, 2, 2, 2, 2)))
        self.eps = float(cfg.get("layer_norm_eps", 1e-5))
        self.groups = int(cfg.get("num_codevector_groups", 2))
        conv = "wav2vec2.feature_extractor.conv_layers"
        keys = [f"{conv}.{i}.{part}" for i in range(len(self.strides))
                for part in ("conv.weight", "conv.bias", "layer_norm.weight", "layer_norm.bias")]
        keys += ["wav2vec2.feature_projection.layer_norm.weight",
                 "wav2vec2.feature_projection.layer_norm.bias",
                 "quantizer.weight_proj.weight", "quantizer.weight_proj.bias"]
        sd = {k: v.float().to(device) for k, v in self._read(model_dir, keys).items()}
        self.convs = [{"weight": sd[f"{conv}.{i}.conv.weight"],
                       "bias": sd[f"{conv}.{i}.conv.bias"] if cfg.get("conv_bias") else None,
                       "norm": ((sd[f"{conv}.{i}.layer_norm.weight"],
                                 sd[f"{conv}.{i}.layer_norm.bias"])
                                if self.norm == "layer" or i == 0 else None)}
                      for i in range(len(self.strides))]
        self.proj_norm = (sd["wav2vec2.feature_projection.layer_norm.weight"],
                          sd["wav2vec2.feature_projection.layer_norm.bias"])
        self.weight_proj = (sd["quantizer.weight_proj.weight"], sd["quantizer.weight_proj.bias"])
        self.device = device

    @staticmethod
    def _read(model_dir: str, keys: List[str]) -> Dict[str, torch.Tensor]:
        path = os.path.join(model_dir, "model.safetensors")
        if os.path.exists(path):
            return read_safetensors(path, keys)
        sd = torch.load(os.path.join(model_dir, "pytorch_model.bin"), map_location="cpu",
                        weights_only=True, mmap=True)
        return {k: sd[k] for k in keys if k in sd}

    def logits(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, S] -> codebook logits [B, T', G*V]."""
        x = wav.float()[:, None]
        for c, stride in zip(self.convs, self.strides):
            x = F.conv1d(x, c["weight"], c["bias"], stride=stride)
            if c["norm"] is not None and self.norm == "group":
                x = F.group_norm(x, x.shape[1], *c["norm"], eps=1e-5)
            elif c["norm"] is not None:
                x = F.layer_norm(x.transpose(1, 2), (x.shape[1],), *c["norm"],
                                 eps=1e-5).transpose(1, 2)
            x = self.act(x)
        feats = F.layer_norm(x.transpose(1, 2), (x.shape[1],), *self.proj_norm, eps=self.eps)
        return F.linear(feats, *self.weight_proj)

    def __call__(self, wav: np.ndarray) -> np.ndarray:
        """float32 [S] (or [B, S]) -> int32 tokens [T', G] (or [B, T', G])."""
        x = torch.as_tensor(np.asarray(wav, np.float32)).to(self.device)
        with torch.no_grad(), full_f32():
            logits = self.logits(x if x.ndim == 2 else x[None])
            b, t, _ = logits.shape
            idx = logits.view(b, t, self.groups, -1).argmax(-1)
        out = idx.to(torch.int32).cpu().numpy()
        return out[0] if x.ndim == 1 else out


# ---------------------------------------------------------------------------
# Dataset-level tokenization
# ---------------------------------------------------------------------------

def build_quantizer(codec: str, model_path: str, device: Device = None
                    ) -> Callable[[np.ndarray], np.ndarray]:
    """``quantize(wav [S] float32) -> int32 tokens [T', G]`` of ``codec``
    ("vq" or "wav2vec2"), with its weights on ``device`` (the GPU unless
    given)."""
    dev = resolve_device(device)
    if codec == "wav2vec2":
        return Wav2Vec2Quantizer(model_path, dev)
    if codec == "vq":
        params, geom = load_vq_codec(model_path, dev)

        def quantize(wav: np.ndarray) -> np.ndarray:
            x = torch.as_tensor(np.asarray(wav, np.float32)).to(dev)
            toks = vq_tokens(params, x if x.ndim == 2 else x[None],
                             strides=geom["strides"], **geom["features"])
            out = toks.cpu().numpy()
            return out[0] if x.ndim == 1 else out

        return quantize
    raise ValueError(f"unknown codec {codec!r} (want 'vq' or 'wav2vec2')")


def tokenize_waveform(quantize, wav: np.ndarray, num_frames: int,
                      alignment: int) -> np.ndarray:
    """Pad 0.5 s (reference e2e_asr_transformer.py:168-170, to avoid boundary
    mismatch), quantize, truncate/pad to num_frames*alignment rows (pad value
    -1 = ignored by the sync loss)."""
    wav = np.concatenate([wav, np.zeros(SAMPLE_RATE // 2, np.float32)])
    tokens = quantize(wav)
    need = num_frames * alignment
    if tokens.shape[0] >= need:
        return tokens[:need]
    pad = np.full((need - tokens.shape[0], tokens.shape[1]), -1, np.int32)
    return np.concatenate([tokens, pad], axis=0)


def iter_audio_files(src: str) -> Iterable[Tuple[str, str]]:
    """Yields (path, kind) for every pkl/wav under src."""
    for path in sorted(glob.glob(os.path.join(src, "**", "*.pkl"), recursive=True)):
        yield path, "pkl"
    for path in sorted(glob.glob(os.path.join(src, "**", "*.wav"), recursive=True)):
        yield path, "wav"


def tokenize_tree(src: str, dst: str, codec: str, model_path: str,
                  num_frames: int = 0, alignment: int = 0,
                  overwrite: bool = False, device: Device = None) -> List[str]:
    """Tokenize every audio-bearing file under ``src`` into token pkls under
    ``dst`` (same relative layout — the ``data.audio_root`` convention).
    Returns written paths. Resumable: existing outputs are skipped."""
    from syncvsr_tpu_torch.config import CodecConfig

    cc = CodecConfig.vq() if codec == "vq" else CodecConfig.wav2vec2()
    alignment = alignment or cc.audio_alignment
    quantize = build_quantizer(codec, model_path, device)
    written = []
    for path, kind in iter_audio_files(src):
        rel = os.path.relpath(path, src)
        out = os.path.join(dst, os.path.splitext(rel)[0] + ".pkl")
        if os.path.exists(out) and not overwrite:
            continue
        if kind == "pkl":
            data = torch.load(path, map_location="cpu", weights_only=False)
            if "audio" not in data:
                continue
            wav = to_waveform(data["audio"])
            frames = num_frames or len(data.get("video", [])) or 0
        else:
            wav = read_wav(path)
            frames = num_frames
        if not frames:  # infer from duration at 25 fps
            frames = int(round(len(wav) / SAMPLE_RATE * 25))
        tokens = tokenize_waveform(quantize, wav, frames, alignment)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        torch.save({f"{codec}_tokens": tokens}, out)
        written.append(out)
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--src", required=True, help="tree of pkls (with 'audio' key) or wavs")
    p.add_argument("--dst", required=True,
                   help="output token-pkl root (point data.audio_root here)")
    p.add_argument("--codec", default="wav2vec2", choices=["vq", "wav2vec2"])
    p.add_argument("--model", required=True,
                   help="HF model dir (wav2vec2) or fairseq .pt (vq)")
    p.add_argument("--num-frames", type=int, default=0,
                   help="video frames per clip (default: infer per file)")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device of the codec (default: the GPU; 'cpu' to run on the host)")
    args = p.parse_args(argv)
    written = tokenize_tree(args.src, args.dst, args.codec, args.model,
                            num_frames=args.num_frames, overwrite=args.overwrite,
                            device=args.device)
    print(f"wrote {len(written)} token pkls under {args.dst}")
    return written


if __name__ == "__main__":
    main()

"""Seeded synthetic checkpoints in the reference's own layouts, for the
tests and ``chip_smoke.py`` (no released checkpoint is downloaded):

- ``espnet_e2e_state_dict``: the LRS E2E state dict (espnet Conformer
  encoder, Conv3D ResNet-18 frontend, Transformer decoder, CTC head, sync
  head; ``Vox+LRS2+LRS3.ckpt``'s key layout) at a config's shapes, with the
  keys ``utils/torch_convert.py::convert_lrs_e2e`` reads;
- ``espnet_transformer_lm_state_dict``: espnet's ``TransformerLM`` (the
  keys ``convert_transformer_lm`` reads);
- ``write_fairseq_vq``: a fairseq vq-wav2vec kmeans ``.pt`` (``args`` +
  ``model``);
- ``write_hf_wav2vec2``: an HF ``Wav2Vec2ForPreTraining`` directory
  (``config.json`` + ``model.safetensors``) holding the feature extractor,
  the feature projection and the quantizer, written without
  ``transformers``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from syncvsr_tpu_torch.ops.codec import VQ_CONV_LAYERS


def _rand(rng: np.random.RandomState, scale: float = 0.05):
    return lambda *shape: torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))


def _bn(sd: Dict[str, torch.Tensor], key: str, c: int, rng) -> None:
    sd[f"{key}.weight"] = torch.from_numpy(1 + 0.1 * rng.randn(c).astype(np.float32))
    sd[f"{key}.bias"] = torch.from_numpy(0.1 * rng.randn(c).astype(np.float32))
    sd[f"{key}.running_mean"] = torch.from_numpy(0.1 * rng.randn(c).astype(np.float32))
    sd[f"{key}.running_var"] = torch.from_numpy(1 + rng.rand(c).astype(np.float32))


def _linear(sd, key: str, dout: int, din: int, t, bias: bool = True) -> None:
    sd[f"{key}.weight"] = t(dout, din)
    if bias:
        sd[f"{key}.bias"] = t(dout)


def _ln(sd, key: str, c: int, rng) -> None:
    sd[f"{key}.weight"] = torch.from_numpy(1 + 0.1 * rng.randn(c).astype(np.float32))
    sd[f"{key}.bias"] = torch.from_numpy(0.1 * rng.randn(c).astype(np.float32))


def _attention(sd, key: str, dim: int, t) -> None:
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        _linear(sd, f"{key}.{name}", dim, dim, t)


def espnet_e2e_state_dict(cfg, seed: int = 0, prefix: str = "model."
                          ) -> Dict[str, torch.Tensor]:
    """The reference E2E's state dict at ``cfg``'s shapes (a ``lrs3``-style
    config: ``conv3d_resnet`` frontend, Conformer encoder, Transformer
    decoder), under ``prefix`` ("model." as Lightning saves it), seeded."""
    rng = np.random.RandomState(seed)
    t = _rand(rng)
    m, fe, enc, dec = cfg.model, cfg.model.frontend, cfg.model.encoder, cfg.model.decoder
    sd: Dict[str, torch.Tensor] = {}
    stem = f"{prefix}encoder.frontend.frontend3D"
    sd[f"{stem}.0.weight"] = t(fe.stem_channels, 1, 5, 7, 7)
    _bn(sd, f"{stem}.1", fe.stem_channels, rng)
    cin = fe.stem_channels
    for layer in range(1, 5):
        width = fe.resnet_width * 2 ** (layer - 1)
        for block in range(2):
            key = f"{prefix}encoder.frontend.trunk.layer{layer}.{block}"
            sd[f"{key}.conv1.weight"] = t(width, cin, 3, 3)
            _bn(sd, f"{key}.bn1", width, rng)
            sd[f"{key}.conv2.weight"] = t(width, width, 3, 3)
            _bn(sd, f"{key}.bn2", width, rng)
            if block == 0 and layer > 1:
                sd[f"{key}.downsample.0.weight"] = t(width, cin, 1, 1)
                _bn(sd, f"{key}.downsample.1", width, rng)
            cin = width
    adim, heads = enc.dim, enc.heads
    hidden = enc.hidden or int(enc.hidden_ratio * adim)
    _linear(sd, f"{prefix}encoder.embed.0", adim, cin, t)
    for i in range(enc.layers):
        key = f"{prefix}encoder.encoders.{i}"
        _attention(sd, f"{key}.self_attn", adim, t)
        _linear(sd, f"{key}.self_attn.linear_pos", adim, adim, t, bias=False)
        sd[f"{key}.self_attn.pos_bias_u"] = t(heads, adim // heads)
        sd[f"{key}.self_attn.pos_bias_v"] = t(heads, adim // heads)
        for ff in ("feed_forward", "feed_forward_macaron"):
            _linear(sd, f"{key}.{ff}.w_1", hidden, adim, t)
            _linear(sd, f"{key}.{ff}.w_2", adim, hidden, t)
        conv = f"{key}.conv_module"
        sd[f"{conv}.pointwise_cov1.weight"] = t(2 * adim, adim, 1)
        sd[f"{conv}.pointwise_cov1.bias"] = t(2 * adim)
        sd[f"{conv}.depthwise_conv.weight"] = t(adim, 1, enc.conv_kernel)
        sd[f"{conv}.depthwise_conv.bias"] = t(adim)
        sd[f"{conv}.pointwise_cov2.weight"] = t(adim, adim, 1)
        sd[f"{conv}.pointwise_cov2.bias"] = t(adim)
        _bn(sd, f"{conv}.norm", adim, rng)
        for n in ("norm_ff", "norm_mha", "norm_conv", "norm_final", "norm_ff_macaron"):
            _ln(sd, f"{key}.{n}", adim, rng)
    _ln(sd, f"{prefix}encoder.after_norm", adim, rng)
    _linear(sd, f"{prefix}ctc.ctc_lo", m.labels, adim, t)
    ddim = dec.dim
    sd[f"{prefix}decoder.embed.0.weight"] = t(m.labels, ddim)
    for i in range(dec.layers):
        key = f"{prefix}decoder.decoders.{i}"
        _attention(sd, f"{key}.self_attn", ddim, t)
        _attention(sd, f"{key}.src_attn", ddim, t)
        _linear(sd, f"{key}.feed_forward.w_1", dec.hidden, ddim, t)
        _linear(sd, f"{key}.feed_forward.w_2", ddim, dec.hidden, t)
        for n in ("norm1", "norm2", "norm3"):
            _ln(sd, f"{key}.{n}", ddim, rng)
    _ln(sd, f"{prefix}decoder.after_norm", ddim, rng)
    _linear(sd, f"{prefix}decoder.output_layer", m.labels, ddim, t)
    codec = m.codec
    _linear(sd, f"{prefix}audio_projection", codec.tokens_per_frame * codec.audio_vocab_size,
            adim, t)
    if ddim != adim:
        _linear(sd, f"{prefix}proj_decoder", ddim, adim, t)
    return sd


def espnet_transformer_lm_state_dict(vocab: int, layers: int, dim: int, hidden: int,
                                     embed_dim: int, seed: int = 0
                                     ) -> Dict[str, torch.Tensor]:
    """espnet ``TransformerLM`` (lm/transformer.py: ``embed`` -> an encoder
    with a "linear" input layer -> the ``decoder`` Linear), seeded."""
    rng = np.random.RandomState(seed)
    t = _rand(rng, 0.1)
    sd: Dict[str, torch.Tensor] = {"embed.weight": t(vocab, embed_dim)}
    _linear(sd, "encoder.embed.0", dim, embed_dim, t)
    _ln(sd, "encoder.embed.1", dim, rng)
    for i in range(layers):
        key = f"encoder.encoders.{i}"
        _attention(sd, f"{key}.self_attn", dim, t)
        _linear(sd, f"{key}.feed_forward.w_1", hidden, dim, t)
        _linear(sd, f"{key}.feed_forward.w_2", dim, hidden, t)
        _ln(sd, f"{key}.norm_mha", dim, rng)
        _ln(sd, f"{key}.norm_ff", dim, rng)
    _ln(sd, "encoder.after_norm", dim, rng)
    _linear(sd, "decoder", vocab, dim, t)
    return sd


def write_fairseq_vq(path: str, seed: int = 0,
                     conv_layers: Sequence[Tuple[int, int, int]] = VQ_CONV_LAYERS,
                     groups: int = 2, num_vars: int = 320, separation: float = 1.0,
                     activation: str = "relu", skip_connections: bool = False) -> None:
    """A fairseq vq-wav2vec kmeans checkpoint at ``path`` (vq-wav2vec's own
    geometry by default: 8 convs 512 wide, G = 2, V = 320, vq_dim = the
    last conv's width), seeded. The codebook entries are ``separation``
    times a unit normal draw: a large one keeps every argmin clear of
    f32 rounding."""
    rng = np.random.RandomState(seed)
    t = _rand(rng, 0.4)
    sd: Dict[str, torch.Tensor] = {}
    cin = 1
    for i, (dim, k, _) in enumerate(conv_layers):
        # He-scaled, so the activations keep their scale through the stack
        sd[f"feature_extractor.conv_layers.{i}.0.weight"] = torch.from_numpy(
            (rng.randn(dim, cin, k) * np.sqrt(2.0 / (cin * k))).astype(np.float32))
        sd[f"feature_extractor.conv_layers.{i}.2.weight"] = 1 + 0.25 * t(dim)
        sd[f"feature_extractor.conv_layers.{i}.2.bias"] = 0.25 * t(dim)
        cin = dim
    sd["vector_quantizer.projection.0.weight"] = torch.from_numpy(
        (rng.randn(cin, cin // groups, 1) / np.sqrt(cin // groups)).astype(np.float32))
    sd["vector_quantizer.projection.1.weight"] = 1 + 0.25 * t(cin)
    sd["vector_quantizer.projection.1.bias"] = 0.25 * t(cin)
    sd["vector_quantizer.embedding"] = torch.from_numpy(
        (rng.randn(num_vars, groups, cin // groups) * separation).astype(np.float32))
    args = argparse.Namespace(
        conv_feature_layers=str(list(conv_layers)), activation=activation,
        log_compression=True, skip_connections_feat=skip_connections, residual_scale=0.5,
        non_affine_group_norm=False, vq_groups=groups, vq_vars=num_vars, vq_dim=cin)
    torch.save({"args": args, "model": sd}, path)


def _write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """``tensors`` (f32) as a safetensors file: the 8-byte header length,
    the JSON index, the data."""
    index, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        data = t.detach().float().contiguous().numpy().tobytes()
        index[name] = {"dtype": "F32", "shape": list(t.shape),
                       "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    header = json.dumps(index).encode()
    header += b" " * (-len(header) % 8)
    with open(path, "wb") as f:
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        for data in blobs:
            f.write(data)


def write_hf_wav2vec2(model_dir: str, seed: int = 0,
                      conv_dim: Sequence[int] = (512,) * 7,
                      conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2),
                      conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2),
                      groups: int = 2, vocab: int = 320, norm: str = "layer",
                      conv_bias: bool = True, hidden_size: int = 32) -> None:
    """An HF ``Wav2Vec2ForPreTraining`` directory holding the feature
    extractor (``norm`` "group" or "layer"), the feature projection and the
    quantizer's ``weight_proj`` and codevectors, seeded; by default the
    geometry of wav2vec2-large-xlsr-53, the LRW-1000 recipe's codec (7 convs
    512 wide with bias and LayerNorm, hop 320; G = 2 groups of 320 codes).
    The encoder is left out."""
    rng = np.random.RandomState(seed)
    t = _rand(rng, 0.1)
    sd: Dict[str, torch.Tensor] = {}
    conv = "wav2vec2.feature_extractor.conv_layers"
    cin = 1
    for i, (dim, k) in enumerate(zip(conv_dim, conv_kernel)):
        sd[f"{conv}.{i}.conv.weight"] = torch.from_numpy(
            (rng.randn(dim, cin, k) * np.sqrt(2.0 / (cin * k))).astype(np.float32))
        if conv_bias:
            sd[f"{conv}.{i}.conv.bias"] = t(dim)
        if norm == "layer" or i == 0:
            _ln(sd, f"{conv}.{i}.layer_norm", dim, rng)
        cin = dim
    _ln(sd, "wav2vec2.feature_projection.layer_norm", cin, rng)
    _linear(sd, "wav2vec2.feature_projection.projection", hidden_size, cin, t)
    sd["quantizer.weight_proj.weight"] = torch.from_numpy(
        (rng.randn(groups * vocab, cin) / np.sqrt(cin)).astype(np.float32))
    sd["quantizer.weight_proj.bias"] = t(groups * vocab)
    sd["quantizer.codevectors"] = t(1, groups * vocab, 8)
    os.makedirs(model_dir, exist_ok=True)
    config = {"model_type": "wav2vec2", "architectures": ["Wav2Vec2ForPreTraining"],
              "conv_dim": list(conv_dim), "conv_kernel": list(conv_kernel),
              "conv_stride": list(conv_stride), "conv_bias": conv_bias,
              "feat_extract_norm": norm, "feat_extract_activation": "gelu",
              "layer_norm_eps": 1e-5, "num_codevector_groups": groups,
              "num_codevectors_per_group": vocab, "codevector_dim": 8 * groups,
              "proj_codevector_dim": 8 * groups, "hidden_size": hidden_size,
              "num_hidden_layers": 1, "num_attention_heads": 2,
              "intermediate_size": 2 * hidden_size, "num_conv_pos_embeddings": 16,
              "num_conv_pos_embedding_groups": 2,
              "do_stable_layer_norm": norm == "layer"}
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    _write_safetensors(os.path.join(model_dir, "model.safetensors"), sd)

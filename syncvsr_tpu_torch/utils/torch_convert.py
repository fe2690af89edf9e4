"""Torch-checkpoint import: layout conversion + name mapping (the port's
own copy of ``syncvsr_tpu/utils/torch_convert.py``; the port imports
nothing of the JAX package, and ``tests/test_torch_reference_import.py``
holds every function's tree equal to the JAX copy's, leaf by leaf).

Maps the reference's released torch state dicts
(LRW_CKPT_epoch_167_step_213864.ckpt, Vox+LRS2+LRS3.ckpt — SURVEY.md §6),
the fairseq vq-wav2vec codec and the espnet language models to flax-layout
numpy trees: torch/timm layouts (OIHW convs, [out,in] linears, BN running
stats) -> flax (HWIO, [in,out], batch_stats collections). Those trees are
what both packages read: the port loads them into its modules through
``utils/bridge.py`` (``load_flax`` / ``utils.checkpoint.load_params``) and
writes them with ``utils/checkpoint.save_msgpack``
(``tools/import_checkpoint.py``).

Usage: ``state_dict = torch.load(...)["state_dict"]`` then
``params, batch_stats = convert_resnet_trunk(state_dict, "resnet.")`` etc.,
merged into a fresh model tree via utils.checkpoint.partial_load.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def convert_conv(w) -> np.ndarray:
    """torch conv weight OI(T)HW -> flax (T)HWIO."""
    w = _np(w)
    if w.ndim == 5:   # conv3d [O, I, T, H, W] -> [T, H, W, I, O]
        return w.transpose(2, 3, 4, 1, 0)
    if w.ndim == 4:   # conv2d [O, I, H, W] -> [H, W, I, O]
        return w.transpose(2, 3, 1, 0)
    if w.ndim == 3:   # conv1d [O, I, K] -> [K, I, O]
        return w.transpose(2, 1, 0)
    raise ValueError(f"not a conv weight: shape {w.shape}")


def convert_linear(w) -> np.ndarray:
    """torch linear [out, in] -> flax kernel [in, out]."""
    return _np(w).transpose(1, 0)


def convert_bn(sd: Dict[str, Any], prefix: str) -> Tuple[Dict, Dict]:
    """BatchNorm params + running stats."""
    params = {"scale": _np(sd[f"{prefix}.weight"]),
              "bias": _np(sd[f"{prefix}.bias"])}
    stats = {"mean": _np(sd[f"{prefix}.running_mean"]),
             "var": _np(sd[f"{prefix}.running_var"])}
    return params, stats


def convert_resnet_trunk(sd: Dict[str, Any], prefix: str = "resnet."
                         ) -> Tuple[Dict, Dict]:
    """timm/torchvision resnet18 layer1..layer4 -> models.resnet.ResNetTrunk.

    torch names: {prefix}layer{L}.{B}.conv1/bn1/conv2/bn2[/downsample.0|1]
    flax names:  layer{L}_{B}/{conv1,bn1,conv2,bn2,downsample_conv,downsample_bn}
    """
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for layer in range(1, 5):
        block = 0
        while f"{prefix}layer{layer}.{block}.conv1.weight" in sd:
            tname = f"{prefix}layer{layer}.{block}"
            fname = f"layer{layer}_{block}"
            p: Dict[str, Any] = {}
            s: Dict[str, Any] = {}
            p["conv1"] = {"kernel": convert_conv(sd[f"{tname}.conv1.weight"])}
            p["bn1"], s["bn1"] = convert_bn(sd, f"{tname}.bn1")
            p["conv2"] = {"kernel": convert_conv(sd[f"{tname}.conv2.weight"])}
            p["bn2"], s["bn2"] = convert_bn(sd, f"{tname}.bn2")
            if f"{tname}.downsample.0.weight" in sd:
                p["downsample_conv"] = {
                    "kernel": convert_conv(sd[f"{tname}.downsample.0.weight"])}
                p["downsample_bn"], s["downsample_bn"] = convert_bn(
                    sd, f"{tname}.downsample.1")
            params[fname] = p
            stats[fname] = s
            block += 1
    return params, stats


def convert_stem3d(sd: Dict[str, Any], prefix: str = "stem3d."
                   ) -> Tuple[Dict, Dict]:
    """Reference stem (Conv3d + BatchNorm3d, lightning.py:49-53) ->
    Conv3DResNetFrontend's {stem_conv_kernel, stem_bn}."""
    params = {"stem_conv_kernel": convert_conv(sd[f"{prefix}0.weight"])}
    bn_p, bn_s = convert_bn(sd, f"{prefix}1")
    params["stem_bn"] = bn_p
    return params, {"stem_bn": bn_s}


def convert_frontend(sd: Dict[str, Any], stem_prefix: str = "stem3d.",
                     resnet_prefix: str = "resnet.") -> Tuple[Dict, Dict]:
    """Full Conv3DResNetFrontend tree (params, batch_stats)."""
    params, stats = convert_stem3d(sd, stem_prefix)
    r_params, r_stats = convert_resnet_trunk(sd, resnet_prefix)
    params["resnet"] = r_params
    stats["resnet"] = r_stats
    return params, stats


def convert_sync_head(sd: Dict[str, Any], prefix: str = "audio_projection."
                      ) -> Dict:
    """audio_projection -> audio_classifier (the reference's own surgery
    rename, LRS/video/lightning.py:60-66)."""
    return {"kernel": convert_linear(sd[f"{prefix}weight"]),
            "bias": _np(sd[f"{prefix}bias"])}


def convert_word_classifier(sd: Dict[str, Any],
                            prefix: str = "category_classifier.") -> Dict:
    return {"kernel": convert_linear(sd[f"{prefix}weight"]),
            "bias": _np(sd[f"{prefix}bias"])}


# ---------------------------------------------------------------------------
# x-transformers encoder (the released LRW_CKPT layout,
# LRW/video/src/lightning.py:96-105: RMSNorm + GLU + partial rotary)
# ---------------------------------------------------------------------------

def _first_key(sd, *candidates):
    for k in candidates:
        if k in sd:
            return k
    return None


def convert_xtransformers_encoder(sd: Dict[str, Any], prefix: str, depth: int,
                                  dim: int, heads: int,
                                  dim_in: Optional[int] = None) -> Dict:
    """x-transformers ``Encoder(dim_in, depth, heads, use_rmsnorm, ff_glu,
    rotary_pos_emb)`` state dict -> models.transformer.TransformerEncoder
    params.

    Layer list alternates attention/feed-forward ('a','f'), so our block_i
    maps to their layers.{2i} (attn) and layers.{2i+1} (ff). Conventions
    mirrored (and required on the flax side): partial rotary over
    max(32, head_dim // 2) dims (``encoder.rope_dim``), split-halves rotation,
    GLU with value = first proj half / gate = second half, RMSNorm g == our
    scale. q/k/v carry no bias in x-transformers -> zeros here.
    """
    dim_in = dim_in or dim
    dk = dim // heads
    p: Dict[str, Any] = {}

    def qkv(key):
        kern = convert_linear(sd[key]).reshape(dim_in, heads, dk)
        return {"kernel": kern, "bias": np.zeros((heads, dk), np.float32)}

    def norm_scale(base):
        key = _first_key(sd, f"{base}.0.g", f"{base}.g",
                         f"{base}.0.weight", f"{base}.weight")
        if key is None:
            raise KeyError(f"no norm param under {base}")
        return {"scale": _np(sd[key])}

    for i in range(depth):
        a = f"{prefix}layers.{2 * i}"
        f = f"{prefix}layers.{2 * i + 1}"
        blk: Dict[str, Any] = {}
        blk["norm_attn"] = norm_scale(f"{a}.0")
        blk["norm_ff"] = norm_scale(f"{f}.0")

        attn: Dict[str, Any] = {
            "wq": qkv(f"{a}.1.to_q.weight"),
            "wk": qkv(f"{a}.1.to_k.weight"),
            "wv": qkv(f"{a}.1.to_v.weight"),
        }
        ok = _first_key(sd, f"{a}.1.to_out.weight", f"{a}.1.to_out.0.weight")
        wo_kernel = convert_linear(sd[ok]).reshape(heads, dk, dim_in)
        ob = _first_key(sd, f"{a}.1.to_out.bias", f"{a}.1.to_out.0.bias")
        attn["wo"] = {"kernel": wo_kernel,
                      "bias": _np(sd[ob]) if ob else np.zeros(dim_in, np.float32)}
        blk["attn"] = attn

        pk = _first_key(sd, f"{f}.1.ff.0.proj.weight", f"{f}.1.net.0.proj.weight")
        if pk is None:
            raise KeyError(f"no GLU proj under {f}.1")
        proj_w = convert_linear(sd[pk])            # [dim_in, 2*hidden]
        hidden = proj_w.shape[1] // 2
        proj_b = _np(sd[pk.replace(".weight", ".bias")])
        # x-transformers GLU: value = first half, gate = second half
        # (x * act(gate)); our FeedForward gates through wi_gate
        ff = {"wi": {"kernel": proj_w[:, :hidden], "bias": proj_b[:hidden]},
              "wi_gate": {"kernel": proj_w[:, hidden:], "bias": proj_b[hidden:]}}
        wk_out = _first_key(
            sd, *[f"{f}.1.{net}.{j}.weight" for net in ("ff", "net")
                  for j in (1, 2, 3)])
        if wk_out is None:
            raise KeyError(f"no ff output linear under {f}.1")
        ff["wo"] = {"kernel": convert_linear(sd[wk_out]),
                    "bias": _np(sd[wk_out.replace(".weight", ".bias")])}
        blk["ff"] = ff
        p[f"block_{i}"] = blk

    fk = _first_key(sd, f"{prefix}final_norm.g", f"{prefix}norm.g",
                    f"{prefix}final_norm.weight", f"{prefix}norm.weight")
    if fk is not None:
        p["RMSNorm_0"] = {"scale": _np(sd[fk])}
    return p


def convert_lrw_word_model(sd: Dict[str, Any], depth: int = 12,
                           dim: int = 512, heads: int = 8,
                           use_word_boundary: bool = True,
                           prefix: str = "") -> Tuple[Dict, Dict]:
    """Released LRW transformer checkpoint (LRW_CKPT_epoch_167_step_213864
    layout: stem3d + timm resnet18 trunk + x-transformers encoder + heads,
    LRW/video/src/lightning.py:36-110) -> WordVSRModel (params, batch_stats).

    Load into ``lrw_video_config()`` overridden with ``encoder.rope_dim=32``
    and ``encoder.hidden=<4 * (dim+1)>`` (x-transformers sizes the FF from the
    widened dim_backbone).
    """
    dim_in = dim + (1 if use_word_boundary else 0)
    p: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    fe_p, fe_s = convert_frontend(sd, f"{prefix}stem3d.", f"{prefix}resnet.")
    p["frontend"] = fe_p
    stats["frontend"] = fe_s
    p["encoder"] = convert_xtransformers_encoder(
        sd, f"{prefix}encoder.", depth, dim, heads, dim_in=dim_in)
    p["cls_token"] = _np(sd[f"{prefix}cls_token"]).reshape(1, 1, dim_in)
    p["category_classifier"] = convert_word_classifier(
        sd, f"{prefix}category_classifier.")
    key = _first_key(sd, f"{prefix}audio_projection.weight",
                     f"{prefix}audio_classifier.weight")
    if key:
        p["audio_classifier"] = convert_sync_head(sd, key[: -len("weight")])
    return p, stats


# ---------------------------------------------------------------------------
# Full LRS E2E checkpoint (the released Vox+LRS2+LRS3.ckpt layout)
# ---------------------------------------------------------------------------

def _dgen_in(sd, key, dim, heads):
    dk = dim // heads
    out = {"kernel": convert_linear(sd[f"{key}.weight"]).reshape(dim, heads, dk)}
    if f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"]).reshape(heads, dk)
    return out


def _dgen_out(sd, key, dim, heads):
    dk = dim // heads
    return {"kernel": convert_linear(sd[f"{key}.weight"]).reshape(heads, dk, dim),
            "bias": _np(sd[f"{key}.bias"])}


def _ln(sd, key):
    return {"LayerNorm_0": {"scale": _np(sd[f"{key}.weight"]),
                            "bias": _np(sd[f"{key}.bias"])}}


def convert_conformer_block(sd: Dict[str, Any], prefix: str, dim: int,
                            heads: int) -> Tuple[Dict, Dict]:
    """espnet EncoderLayer (rel-MHA + macaron + conv module) -> ConformerBlock.
    Mapping verified numerically in tests/test_conformer_oracle.py."""
    p: Dict[str, Any] = {"attn": {}, "ff": {}, "ff_macaron": {}, "conv": {}}
    p["attn"]["wq"] = _dgen_in(sd, f"{prefix}self_attn.linear_q", dim, heads)
    p["attn"]["wk"] = _dgen_in(sd, f"{prefix}self_attn.linear_k", dim, heads)
    p["attn"]["wv"] = _dgen_in(sd, f"{prefix}self_attn.linear_v", dim, heads)
    p["attn"]["wo"] = _dgen_out(sd, f"{prefix}self_attn.linear_out", dim, heads)
    lp = _dgen_in(sd, f"{prefix}self_attn.linear_pos", dim, heads)
    p["attn"]["linear_pos"] = {"kernel": lp["kernel"]}
    p["attn"]["pos_bias_u"] = _np(sd[f"{prefix}self_attn.pos_bias_u"])
    p["attn"]["pos_bias_v"] = _np(sd[f"{prefix}self_attn.pos_bias_v"])
    for ours, theirs in (("ff", "feed_forward"),
                         ("ff_macaron", "feed_forward_macaron")):
        p[ours]["w1"] = {"kernel": convert_linear(sd[f"{prefix}{theirs}.w_1.weight"]),
                         "bias": _np(sd[f"{prefix}{theirs}.w_1.bias"])}
        p[ours]["w2"] = {"kernel": convert_linear(sd[f"{prefix}{theirs}.w_2.weight"]),
                         "bias": _np(sd[f"{prefix}{theirs}.w_2.bias"])}
    p["conv"]["pw1"] = {"kernel": _np(sd[f"{prefix}conv_module.pointwise_cov1.weight"])[:, :, 0].T,
                        "bias": _np(sd[f"{prefix}conv_module.pointwise_cov1.bias"])}
    p["conv"]["dw"] = {"kernel": _np(sd[f"{prefix}conv_module.depthwise_conv.weight"]).transpose(2, 1, 0),
                       "bias": _np(sd[f"{prefix}conv_module.depthwise_conv.bias"])}
    p["conv"]["pw2"] = {"kernel": _np(sd[f"{prefix}conv_module.pointwise_cov2.weight"])[:, :, 0].T,
                        "bias": _np(sd[f"{prefix}conv_module.pointwise_cov2.bias"])}
    p["conv"]["bn"] = {"scale": _np(sd[f"{prefix}conv_module.norm.weight"]),
                       "bias": _np(sd[f"{prefix}conv_module.norm.bias"])}
    for n in ("norm_ff", "norm_mha", "norm_conv", "norm_final", "norm_ff_macaron"):
        p[n] = _ln(sd, f"{prefix}{n}")
    stats = {"conv": {"bn": {"mean": _np(sd[f"{prefix}conv_module.norm.running_mean"]),
                             "var": _np(sd[f"{prefix}conv_module.norm.running_var"])}}}
    return p, stats


def convert_decoder(sd: Dict[str, Any], prefix: str, dim: int, heads: int,
                    layers: int) -> Dict:
    """espnet Decoder -> TransformerDecoder (verified in the oracle test)."""
    p: Dict[str, Any] = {"embed": {"embedding": _np(sd[f"{prefix}embed.0.weight"])}}
    for i in range(layers):
        src = f"{prefix}decoders.{i}."
        blk: Dict[str, Any] = {}
        for ours in ("self_attn", "src_attn"):
            blk[ours] = {
                "wq": _dgen_in(sd, f"{src}{ours}.linear_q", dim, heads),
                "wk": _dgen_in(sd, f"{src}{ours}.linear_k", dim, heads),
                "wv": _dgen_in(sd, f"{src}{ours}.linear_v", dim, heads),
                "wo": _dgen_out(sd, f"{src}{ours}.linear_out", dim, heads),
            }
        blk["ff"] = {"w1": {"kernel": convert_linear(sd[f"{src}feed_forward.w_1.weight"]),
                            "bias": _np(sd[f"{src}feed_forward.w_1.bias"])},
                     "w2": {"kernel": convert_linear(sd[f"{src}feed_forward.w_2.weight"]),
                            "bias": _np(sd[f"{src}feed_forward.w_2.bias"])}}
        for n in ("norm1", "norm2", "norm3"):
            blk[n] = _ln(sd, f"{src}{n}")
        p[f"block_{i}"] = blk
    p["after_norm"] = _ln(sd, f"{prefix}after_norm")
    p["output"] = {"kernel": convert_linear(sd[f"{prefix}output_layer.weight"]),
                   "bias": _np(sd[f"{prefix}output_layer.bias"])}
    return p


def convert_lrs_e2e(sd: Dict[str, Any], adim: int, aheads: int, dlayers: int,
                    elayers: int, ddim: Optional[int] = None,
                    prefix: str = "") -> Tuple[Dict, Dict]:
    """Full reference E2E state dict -> SentenceVSRModel (params, batch_stats).

    ``prefix`` is "model." for Lightning checkpoints
    (LRS/video/lightning.py wraps E2E as self.model).
    """
    p: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    fe_p, fe_s = convert_stem3d(sd, f"{prefix}encoder.frontend.frontend3D.")
    tr_p, tr_s = convert_resnet_trunk(sd, f"{prefix}encoder.frontend.trunk.")
    fe_p["resnet"] = tr_p
    fe_s["resnet"] = tr_s
    p["frontend"] = fe_p
    stats["frontend"] = fe_s

    enc: Dict[str, Any] = {"embed": {
        "kernel": convert_linear(sd[f"{prefix}encoder.embed.0.weight"]),
        "bias": _np(sd[f"{prefix}encoder.embed.0.bias"])}}
    enc_stats: Dict[str, Any] = {}
    for i in range(elayers):
        bp, bs = convert_conformer_block(sd, f"{prefix}encoder.encoders.{i}.",
                                         adim, aheads)
        enc[f"block_{i}"] = bp
        enc_stats[f"block_{i}"] = bs
    enc["after_norm"] = _ln(sd, f"{prefix}encoder.after_norm")
    p["encoder"] = enc
    stats["encoder"] = enc_stats

    p["ctc_head"] = {"kernel": convert_linear(sd[f"{prefix}ctc.ctc_lo.weight"]),
                     "bias": _np(sd[f"{prefix}ctc.ctc_lo.bias"])}
    p["decoder"] = convert_decoder(sd, f"{prefix}decoder.", ddim or adim,
                                   aheads, dlayers)
    if f"{prefix}audio_classifier.weight" in sd:
        p["audio_classifier"] = convert_sync_head(sd, f"{prefix}audio_classifier.")
    elif f"{prefix}audio_projection.weight" in sd:
        p["audio_classifier"] = convert_sync_head(sd, f"{prefix}audio_projection.")
    if f"{prefix}proj_decoder.weight" in sd:
        p["proj_decoder"] = {
            "kernel": convert_linear(sd[f"{prefix}proj_decoder.weight"]),
            "bias": _np(sd[f"{prefix}proj_decoder.bias"])}
    return p, stats


# ---------------------------------------------------------------------------
# vq-wav2vec codec (in-step tokenizer, e2e_asr_transformer.py:138-144)
# ---------------------------------------------------------------------------

def convert_vq_wav2vec(sd: Dict[str, Any], args=None
                       ) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """fairseq vq-wav2vec (kmeans) state dict -> ``ops.codec`` param tree.

    Keys (fairseq wav2vec.py): ``feature_extractor.conv_layers.{i}.0``
    (Conv1d, no bias), ``.2`` (GroupNorm(1, C) affine),
    ``vector_quantizer.projection.0`` (grouped 1x1 Conv1d),
    ``.projection.1`` (GroupNorm(G, C)), ``vector_quantizer.embedding``
    [V, G(or 1 with combine_groups), d]. Returns (params, geometry)."""
    groups = int(getattr(args, "vq_groups", 2)) if args is not None else 2
    num_vars = int(getattr(args, "vq_vars", 320)) if args is not None else 320

    p: Dict[str, Any] = {}
    i = 0
    while f"feature_extractor.conv_layers.{i}.0.weight" in sd:
        base = f"feature_extractor.conv_layers.{i}"
        layer = {"kernel": _np(sd[f"{base}.0.weight"]).transpose(2, 1, 0)}
        if f"{base}.2.weight" in sd:  # affine GroupNorm
            layer["scale"] = _np(sd[f"{base}.2.weight"])
            layer["bias"] = _np(sd[f"{base}.2.bias"])
        p[f"conv_{i}"] = layer
        i += 1

    w = _np(sd["vector_quantizer.projection.0.weight"])   # [Co, Ci/G, 1]
    co, ci_g = w.shape[0], w.shape[1]
    so = co // groups
    # grouped 1x1 conv -> per-group [in, out] kernels: output group g reads
    # input group g (torch grouped-conv contract)
    kernel = np.stack([w[g * so:(g + 1) * so, :, 0].T for g in range(groups)])
    proj: Dict[str, Any] = {"kernel": kernel}             # [G, Ci/G, Co/G]
    if "vector_quantizer.projection.1.weight" in sd:
        proj["scale"] = _np(sd["vector_quantizer.projection.1.weight"])
        proj["bias"] = _np(sd["vector_quantizer.projection.1.bias"])
    p["projection"] = proj

    emb = _np(sd["vector_quantizer.embedding"])           # [V, G|1, d]
    if emb.shape[1] == 1 and groups > 1:                  # combine_groups
        emb = np.broadcast_to(emb, (emb.shape[0], groups, emb.shape[2]))
    p["embedding"] = np.ascontiguousarray(emb)

    import ast

    spec = ast.literal_eval(getattr(
        args, "conv_feature_layers",
        "[(512, 10, 5), (512, 8, 4), (512, 4, 2), (512, 4, 2), (512, 4, 2),"
        " (512, 1, 1), (512, 1, 1), (512, 1, 1)]")) if args is not None \
        else [(512, 10, 5), (512, 8, 4), (512, 4, 2), (512, 4, 2),
              (512, 4, 2), (512, 1, 1), (512, 1, 1), (512, 1, 1)]
    geometry = {"groups": groups, "num_vars": num_vars,
                "var_dim": emb.shape[2], "conv_layers": i,
                "strides": tuple(s for _, _, s in spec)}
    assert ci_g * groups == co, (ci_g, groups, co)
    assert len(spec) == i, (len(spec), i)
    return p, geometry


# ---------------------------------------------------------------------------
# espnet language models (shallow-fusion scorers, lrs3.yaml:64-71)
# ---------------------------------------------------------------------------

def _strip_lm_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Unwrap common espnet LM checkpoint framings: {"model": sd} payloads and
    "model."/"module." key prefixes."""
    if "model" in sd and not hasattr(sd["model"], "detach"):
        sd = sd["model"]
    for pre in ("model.", "module."):
        if any(k.startswith(pre) for k in sd):
            sd = {k[len(pre):] if k.startswith(pre) else k: v
                  for k, v in sd.items()}
    return sd


def convert_transformer_lm(sd: Dict[str, Any], dim: int, heads: int,
                           layers: int) -> Dict:
    """espnet TransformerLM (lm/transformer.py:18-250: Embedding -> encoder
    with "linear" input layer -> Linear decoder) -> models.lm.TransformerLM.
    Oracle-pinned in tests/test_lm_convert.py."""
    sd = _strip_lm_prefix(sd)
    p: Dict[str, Any] = {
        "embed": {"embedding": _np(sd["embed.weight"])},
        # encoder.embed = Sequential(Linear, LayerNorm, Dropout, ReLU, pos)
        "input_proj": {"kernel": convert_linear(sd["encoder.embed.0.weight"]),
                       "bias": _np(sd["encoder.embed.0.bias"])},
        "input_norm": _ln(sd, "encoder.embed.1"),
    }
    for i in range(layers):
        src = f"encoder.encoders.{i}."
        p[f"block_{i}"] = {
            "attn": {"wq": _dgen_in(sd, f"{src}self_attn.linear_q", dim, heads),
                     "wk": _dgen_in(sd, f"{src}self_attn.linear_k", dim, heads),
                     "wv": _dgen_in(sd, f"{src}self_attn.linear_v", dim, heads),
                     "wo": _dgen_out(sd, f"{src}self_attn.linear_out", dim, heads)},
            "ff": {"w1": {"kernel": convert_linear(sd[f"{src}feed_forward.w_1.weight"]),
                          "bias": _np(sd[f"{src}feed_forward.w_1.bias"])},
                   "w2": {"kernel": convert_linear(sd[f"{src}feed_forward.w_2.weight"]),
                          "bias": _np(sd[f"{src}feed_forward.w_2.bias"])}},
            "norm1": _ln(sd, f"{src}norm_mha"),
            "norm2": _ln(sd, f"{src}norm_ff"),
        }
    p["norm"] = _ln(sd, "encoder.after_norm")
    p["output"] = {"kernel": convert_linear(sd["decoder.weight"]),
                   "bias": _np(sd["decoder.bias"])}
    return p


def _convert_lstm_gates(w_ih, w_hh, b_ih, b_hh) -> Dict:
    """torch LSTM gate-stacked weights ([4H, in], gate order i,f,g,o) ->
    flax OptimizedLSTMCell per-gate denses (ii/if/ig/io kernels [in, H]
    without bias; hi/hf/hg/ho kernels [H, H] with the summed bias)."""
    h = w_hh.shape[1]
    out: Dict[str, Any] = {}
    for g, name in enumerate("ifgo"):
        rows = slice(g * h, (g + 1) * h)
        out[f"i{name}"] = {"kernel": _np(w_ih)[rows].T}
        out[f"h{name}"] = {"kernel": _np(w_hh)[rows].T,
                           "bias": _np(b_ih)[rows] + _np(b_hh)[rows]}
    return out


def convert_rnn_lm(sd: Dict[str, Any], layers: int) -> Dict:
    """espnet RNNLM state dicts -> models.lm.RNNLM. Handles both layouts:
    DefaultRNNLM/ClassifierWithState (predictor.embed / predictor.rnn.{k}
    nn.LSTMCell list / predictor.lo, lm/default.py:326-428) and
    SequentialRNNLM (encoder / rnn.weight_ih_l{k} nn.LSTM / decoder,
    lm/seq_rnn.py:10-178)."""
    sd = _strip_lm_prefix(sd)
    if "predictor.embed.weight" in sd:
        p: Dict[str, Any] = {"embed": {"embedding": _np(sd["predictor.embed.weight"])}}
        for k in range(layers):
            src = f"predictor.rnn.{k}."
            p[f"lstm_{k}"] = _convert_lstm_gates(
                sd[f"{src}weight_ih"], sd[f"{src}weight_hh"],
                sd[f"{src}bias_ih"], sd[f"{src}bias_hh"])
        p["output"] = {"kernel": convert_linear(sd["predictor.lo.weight"]),
                       "bias": _np(sd["predictor.lo.bias"])}
        return p
    p = {"embed": {"embedding": _np(sd["encoder.weight"])}}
    for k in range(layers):
        p[f"lstm_{k}"] = _convert_lstm_gates(
            sd[f"rnn.weight_ih_l{k}"], sd[f"rnn.weight_hh_l{k}"],
            sd[f"rnn.bias_ih_l{k}"], sd[f"rnn.bias_hh_l{k}"])
    p["output"] = {"kernel": convert_linear(sd["decoder.weight"]),
                   "bias": _np(sd["decoder.bias"])}
    return p


def convert_lm(sd: Dict[str, Any], kind: str, dim: int, heads: int,
               layers: int) -> Dict:
    """Reference espnet LM checkpoint -> flax LM params (kind:
    "transformer" | "rnn")."""
    if kind == "rnn":
        return convert_rnn_lm(sd, layers)
    return convert_transformer_lm(sd, dim, heads, layers)


# ---------------------------------------------------------------------------
# TCN family (LRW/video/src/tcn/models/tcn.py:121-254)
# ---------------------------------------------------------------------------

def _conv_bn(sd, conv_key, bn_key) -> Tuple[Dict, Dict]:
    p = {"conv": {"kernel": convert_conv(sd[f"{conv_key}.weight"])},
         "bn": {"scale": _np(sd[f"{bn_key}.weight"]),
                "bias": _np(sd[f"{bn_key}.bias"])}}
    if f"{conv_key}.bias" in sd:
        p["conv"]["bias"] = _np(sd[f"{conv_key}.bias"])
    s = {"bn": {"mean": _np(sd[f"{bn_key}.running_mean"]),
                "var": _np(sd[f"{bn_key}.running_var"])}}
    return p, s


def convert_tcn(sd: Dict[str, Any], layers: int, prefix: str = "network."
                ) -> Tuple[Dict, Dict]:
    """Reference TemporalConvNet (tcn.py:236-254, non-dwpw) ->
    models.tcn.TemporalConvNet (params, batch_stats). Oracle-pinned in
    tests/test_tcn_oracle.py."""
    p: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in range(layers):
        src = f"{prefix}{i}."
        blk: Dict[str, Any] = {}
        blk_s: Dict[str, Any] = {}
        for ours, conv, bn in (("conv1", "conv1", "batchnorm1"),
                               ("conv2", "conv2", "batchnorm2")):
            blk[ours], blk_s[ours] = _conv_bn(sd, f"{src}{conv}", f"{src}{bn}")
        if f"{src}downsample.weight" in sd:
            blk["downsample"] = {
                "kernel": convert_conv(sd[f"{src}downsample.weight"]),
                "bias": _np(sd[f"{src}downsample.bias"])}
        p[f"block_{i}"] = blk
        stats[f"block_{i}"] = blk_s
    return p, stats


def convert_mstcn(sd: Dict[str, Any], layers: int, num_kernels: int,
                  prefix: str = "network.") -> Tuple[Dict, Dict]:
    """Reference MultibranchTemporalConvNet (tcn.py:121-143, non-dwpw) ->
    models.tcn.MultibranchTemporalConvNet (params, batch_stats)."""
    p: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in range(layers):
        src = f"{prefix}{i}."
        blk: Dict[str, Any] = {}
        blk_s: Dict[str, Any] = {}
        for half in (0, 1):
            for k in range(num_kernels):
                ours = f"branch{half}_{k}"
                blk[ours], blk_s[ours] = _conv_bn(
                    sd, f"{src}cbcr{half}_{k}.conv",
                    f"{src}cbcr{half}_{k}.batchnorm")
        if f"{src}downsample.weight" in sd:
            blk["downsample"] = {
                "kernel": convert_conv(sd[f"{src}downsample.weight"]),
                "bias": _np(sd[f"{src}downsample.bias"])}
        p[f"block_{i}"] = blk
        stats[f"block_{i}"] = blk_s
    return p, stats

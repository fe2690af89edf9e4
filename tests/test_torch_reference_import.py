"""PyTorch port: the reference-checkpoint converters (``syncvsr_tpu_torch/
utils/torch_convert.py``, the port's own copy), ``tools/import_checkpoint``
and ``evaluate``'s espnet ``.pth`` LM route, against the JAX package's, on
the CPU: every converter's tree equal to the JAX copy's, leaf by leaf and
bitwise, on synthetic state dicts in the reference layouts (the helpers of
``tests/test_lrw_ckpt_import.py``, ``tests/test_import_checkpoint.py`` and
``tests/test_codec_instep.py``; the espnet ones from
``syncvsr_tpu_torch/data/synthetic_ckpt.py``, which writes the keys the
converters read); the msgpack each ``import_checkpoint`` mode writes equal
byte for byte to the JAX CLI's; and the hypotheses of ``evaluate`` with a
``.pth`` TransformerLM equal to those with the same LM converted by the JAX
package's ``import_checkpoint lm``, and to the JAX ``evaluate``'s."""

import json

import numpy as np
import pytest
import torch

from syncvsr_tpu.tools import import_checkpoint as jimport
from syncvsr_tpu.utils import torch_convert as jconv
from syncvsr_tpu_torch import config as tcfg
from syncvsr_tpu_torch.data.synthetic_ckpt import (
    espnet_e2e_state_dict,
    espnet_transformer_lm_state_dict,
)
from syncvsr_tpu_torch.tools import import_checkpoint as timport
from syncvsr_tpu_torch.utils import torch_convert as tconv
from tests.test_codec_instep import _synthetic_fairseq_ckpt
from tests.test_import_checkpoint import _lrw_released_sd
from tests.test_lrw_ckpt_import import _timm_resnet18_sd, xt_state_dict

# the tiny lrs3 E2E: a 16-wide ResNet trunk, 2 x 32 Conformer, 2 x 32 decoder,
# 11 labels (import_checkpoint's lrs mode takes the encoder's width for the
# decoder's, as the released model has); E2E_PROJ's 16-wide decoder takes
# proj_decoder
E2E = tcfg.lrs3_config().override(**{
    "model.frontend.stem_channels": 16, "model.frontend.resnet_width": 16,
    "model.encoder.layers": 2, "model.encoder.dim": 32, "model.encoder.heads": 2,
    "model.encoder.conv_kernel": 7, "model.decoder.layers": 2, "model.decoder.dim": 32,
    "model.decoder.heads": 2, "model.decoder.hidden": 24, "model.labels": 11,
    "model.codec.audio_vocab_size": 13})
E2E_PROJ = E2E.override(**{"model.decoder.dim": 16})


def _t(rng, *shape):
    return torch.tensor(rng.randn(*shape).astype(np.float32) * 0.1)


def _bn(sd, key, c, rng):
    for n in ("weight", "bias", "running_mean"):
        sd[f"{key}.{n}"] = _t(rng, c)
    sd[f"{key}.running_var"] = torch.ones(c) + _t(rng, c).abs()


def _tcn_sd(rng, layers=3, cin=16, width=24, k=3):
    """Reference TemporalConvNet keys (tcn.py:236-254): conv/BN pairs and a
    downsample where the width changes."""
    sd = {}
    for i in range(layers):
        c_in = cin if i == 0 else width
        for conv, bn, ci in (("conv1", "batchnorm1", c_in), ("conv2", "batchnorm2", width)):
            sd[f"network.{i}.{conv}.weight"] = _t(rng, width, ci, k)
            sd[f"network.{i}.{conv}.bias"] = _t(rng, width)
            _bn(sd, f"network.{i}.{bn}", width, rng)
        if c_in != width:
            sd[f"network.{i}.downsample.weight"] = _t(rng, width, c_in, 1)
            sd[f"network.{i}.downsample.bias"] = _t(rng, width)
    return sd


def _mstcn_sd(rng, layers=2, cin=16, width=24, kernels=(3, 5)):
    """Reference MultibranchTemporalConvNet keys (tcn.py:121-143)."""
    sd = {}
    branch = width // len(kernels)
    for i in range(layers):
        c_in = cin if i == 0 else width
        for half in (0, 1):
            for j, k in enumerate(kernels):
                key = f"network.{i}.cbcr{half}_{j}"
                sd[f"{key}.conv.weight"] = _t(rng, branch, c_in if half == 0 else width, k)
                _bn(sd, f"{key}.batchnorm", branch, rng)
        if c_in != width:
            sd[f"network.{i}.downsample.weight"] = _t(rng, width, c_in, 1)
            sd[f"network.{i}.downsample.bias"] = _t(rng, width)
    return sd


def _lstm_sd(rng, layout, vocab=13, embed=8, dim=16, layers=2):
    """espnet RNNLM keys: DefaultRNNLM's ``predictor.*`` LSTMCell list or
    SequentialRNNLM's ``rnn.*_l{k}``."""
    sd = {}
    for k in range(layers):
        cin = embed if k == 0 else dim
        names = ({f"predictor.rnn.{k}.{n}": s for n, s in (
            ("weight_ih", (4 * dim, cin)), ("weight_hh", (4 * dim, dim)),
            ("bias_ih", (4 * dim,)), ("bias_hh", (4 * dim,)))} if layout == "default" else
                 {f"rnn.{n}_l{k}": s for n, s in (
                     ("weight_ih", (4 * dim, cin)), ("weight_hh", (4 * dim, dim)),
                     ("bias_ih", (4 * dim,)), ("bias_hh", (4 * dim,)))})
        sd.update({n: _t(rng, *s) for n, s in names.items()})
    pre, emb, out = (("predictor.", "embed", "lo") if layout == "default"
                     else ("", "encoder", "decoder"))
    sd[f"{pre}{emb}.weight"] = _t(rng, vocab, embed)
    sd[f"{pre}{out}.weight"] = _t(rng, vocab, dim)
    sd[f"{pre}{out}.bias"] = _t(rng, vocab)
    return sd


def _fairseq_vq(rng):
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "vq.pt")
        _synthetic_fairseq_ckpt(rng, path)
        blob = torch.load(path, map_location="cpu", weights_only=False)
    return blob["model"], blob["args"]


def _lrs_sd(rng, prefix=""):
    return espnet_e2e_state_dict(E2E_PROJ, seed=int(rng.randint(1000)), prefix=prefix)


# (name, call(module, rng)): each converter on its reference-layout input
CASES = {
    "convert_conv_3d": lambda m, r: m.convert_conv(_t(r, 8, 1, 5, 7, 7)),
    "convert_conv_2d": lambda m, r: m.convert_conv(_t(r, 8, 4, 3, 3)),
    "convert_conv_1d": lambda m, r: m.convert_conv(_t(r, 8, 4, 3)),
    "convert_linear": lambda m, r: m.convert_linear(_t(r, 8, 5)),
    "convert_bn": lambda m, r: m.convert_bn(_timm_resnet18_sd(r), "resnet.layer1.0.bn1"),
    "convert_resnet_trunk": lambda m, r: m.convert_resnet_trunk(_timm_resnet18_sd(r)),
    "convert_stem3d": lambda m, r: m.convert_stem3d(_lrw_released_sd(r)),
    "convert_frontend": lambda m, r: m.convert_frontend(_lrw_released_sd(r)),
    "convert_sync_head": lambda m, r: m.convert_sync_head(_lrw_released_sd(r)),
    "convert_word_classifier": lambda m, r: m.convert_word_classifier(_lrw_released_sd(r)),
    "convert_xtransformers_encoder": lambda m, r: m.convert_xtransformers_encoder(
        xt_state_dict(r, prefix="encoder."), "encoder.", 2, 64, 2),
    "convert_lrw_word_model": lambda m, r: m.convert_lrw_word_model(
        _lrw_released_sd(r), depth=2, dim=64, heads=2),
    "convert_conformer_block": lambda m, r: m.convert_conformer_block(
        _lrs_sd(r), "encoder.encoders.1.", 32, 2),
    "convert_decoder": lambda m, r: m.convert_decoder(_lrs_sd(r), "decoder.", 16, 2, 2),
    "convert_lrs_e2e": lambda m, r: m.convert_lrs_e2e(
        _lrs_sd(r, "model."), 32, 2, 2, 2, ddim=16, prefix="model."),
    "convert_vq_wav2vec": lambda m, r: m.convert_vq_wav2vec(*_fairseq_vq(r)),
    "convert_vq_wav2vec_defaults": lambda m, r: m.convert_vq_wav2vec(_fairseq_vq(r)[0]),
    "convert_transformer_lm": lambda m, r: m.convert_transformer_lm(
        {f"module.{k}": v for k, v in espnet_transformer_lm_state_dict(
            13, 2, 16, 32, 8, seed=int(r.randint(1000))).items()}, 16, 2, 2),
    "convert_rnn_lm_default": lambda m, r: m.convert_rnn_lm(_lstm_sd(r, "default"), 2),
    "convert_rnn_lm_sequential": lambda m, r: m.convert_rnn_lm(_lstm_sd(r, "seq"), 2),
    "convert_lm": lambda m, r: m.convert_lm(
        {"model": espnet_transformer_lm_state_dict(13, 1, 16, 32, 8)}, "transformer", 16, 2,
        1),
    "convert_tcn": lambda m, r: m.convert_tcn(_tcn_sd(r), 3),
    "convert_mstcn": lambda m, r: m.convert_mstcn(_mstcn_sd(r), 2, 2),
}


def _assert_same_tree(got, want, path="tree"):
    """Equal structure (keys in the same order), leaves equal in dtype,
    shape and every bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        assert got.shape == want.shape and np.array_equal(got, want, equal_nan=True), path
    else:
        assert got == want and type(got) is type(want), path


@pytest.mark.parametrize("name", sorted(CASES))
def test_converter_matches_jax(name):
    call = CASES[name]
    want = call(jconv, np.random.RandomState(7))
    got = call(tconv, np.random.RandomState(7))
    _assert_same_tree(got, want)


def test_every_converter_is_covered():
    public = {n for n in dir(jconv) if n.startswith("convert_")}
    assert public == {n for n in dir(tconv) if n.startswith("convert_")}
    covered = {n for n in public if any(c == n or c.startswith(n + "_") for c in CASES)}
    assert covered == public


def _import_inputs(tmp_path):
    """(mode, source file, overrides) of each import mode, in the
    checkpoints' released envelopes."""
    rng = np.random.RandomState(3)
    lrw = tmp_path / "LRW_CKPT_epoch_167_step_213864.ckpt"
    torch.save({"state_dict": _lrw_released_sd(rng, 2, 512, 8), "epoch": 167}, lrw)
    lrs = tmp_path / "Vox+LRS2+LRS3.ckpt"
    torch.save({"state_dict": espnet_e2e_state_dict(E2E, seed=4), "epoch": 1}, lrs)
    lm = tmp_path / "lm.pth"
    torch.save(espnet_transformer_lm_state_dict(13, 2, 16, 32, 8, seed=5), lm)
    rnn = tmp_path / "rnnlm.pth"
    torch.save({f"module.{k}": v for k, v in _lstm_sd(rng, "seq").items()}, rnn)
    return {
        "lrw": ("lrw", lrw, ["depth=2", "dim=512", "heads=8"]),
        "lrs": ("lrs", lrs, ["adim=32", "aheads=2", "elayers=2", "dlayers=2"]),
        "lm_transformer": ("lm", lm, ["kind=transformer", "dim=16", "heads=2", "layers=2"]),
        "lm_rnn": ("lm", rnn, ["kind=rnn", "dim=16", "layers=2"]),
    }


@pytest.mark.parametrize("case", ["lrw", "lrs", "lm_transformer", "lm_rnn"])
def test_import_checkpoint_writes_the_jax_bytes(case, tmp_path, capsys):
    mode, src, over = _import_inputs(tmp_path)[case]
    jimport.main([mode, str(src), str(tmp_path / "jax.msgpack"), *over])
    timport.main([mode, str(src), str(tmp_path / "port.msgpack"), *over])
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("jax.msgpack", "") == out[1].replace("port.msgpack", "")
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()


def test_import_lrs_then_load_into_the_port_model(tmp_path):
    """The imported E2E covers every leaf of the port's model of that config
    (its params and BatchNorm statistics), and loads."""
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.utils import checkpoint as tckpt

    _, src, over = _import_inputs(tmp_path)["lrs"]
    dst = tmp_path / "lrs.msgpack"
    timport.main(["lrs", str(src), str(dst), *over])
    payload = tckpt.load_msgpack(str(dst))
    model = build_model(E2E, device="cpu")
    own, own_stats = tckpt.model_variables(model)
    shapes = lambda tree: {k: np.shape(v) for k, v in tckpt.flatten(tree).items()}
    assert shapes(payload["params"]) == shapes(own)
    assert shapes(payload["batch_stats"]) == shapes(own_stats)
    assert tckpt.load_params(model, payload["params"], payload["batch_stats"]) == \
        len(tckpt.flatten(own))


def test_evaluate_with_a_pth_lm(tmp_path, monkeypatch, capsys):
    """``lm_ckpt=lm.pth`` (an espnet TransformerLM, converted on load): the
    port's hypotheses and scores equal those with the LM the JAX
    package's ``import_checkpoint lm`` wrote, and the JAX ``evaluate``'s
    on the ``.pth`` (scores to 1e-4 relative, as ``test_torch_cli.py``)."""
    from syncvsr_tpu import evaluate as jevaluate
    from syncvsr_tpu_torch import evaluate as tevaluate
    from test_torch_cli import SENT_ARGS, _hypotheses, _jax_checkpoint

    from syncvsr_tpu.data.synthetic import sentence_batch

    monkeypatch.chdir(tmp_path)
    model_ckpt = _jax_checkpoint(SENT_ARGS, tmp_path / "best.msgpack",
                                 lambda cfg: sentence_batch(cfg, num_frames=32), seed=1)
    torch.save({"state_dict": espnet_transformer_lm_state_dict(13, 2, 16, 32, 8, seed=6)},
               tmp_path / "lm.pth")
    jimport.main(["lm", str(tmp_path / "lm.pth"), str(tmp_path / "lm.msgpack"),
                  "kind=transformer", "dim=16", "heads=2", "layers=2"])
    base = SENT_ARGS + [f"ckpt={json.dumps(model_ckpt)}", "decode=beam_batched",
                        "beam_size=4", 'decode_pad="bucket"', "lm_weight=0.7",
                        "lm_layers=2", "lm_dim=16", "lm_heads=2", "lm_hidden=32",
                        "lm_embed_dim=8"]
    pth = [f"lm_ckpt={json.dumps(str(tmp_path / 'lm.pth'))}"]
    converted = [f"lm_ckpt={json.dumps(str(tmp_path / 'lm.msgpack'))}"]
    _, got = _hypotheses(tevaluate.main, base + pth, monkeypatch, capsys, device="cpu")
    _, via_jax = _hypotheses(tevaluate.main, base + converted, monkeypatch, capsys,
                             device="cpu")
    _, want = _hypotheses(jevaluate.main, base + pth, monkeypatch, capsys)
    assert got == via_jax
    assert [g["hyp"] for g in got] == [w["hyp"] for w in want]
    for g, w in zip(got, want):
        assert g["score"] == pytest.approx(w["score"], rel=1e-4)
    _, plain = _hypotheses(tevaluate.main, base[:-6], monkeypatch, capsys, device="cpu")
    assert [p["score"] for p in plain] != [g["score"] for g in got]

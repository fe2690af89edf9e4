"""PyTorch port: config and synthetic-data copies, the flax <-> torch weight
bridge, import isolation from JAX, and the entry points' device rule."""

import ast
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (kept on the CPU by conftest)
import numpy as np
import pytest
import torch

from syncvsr_tpu import config as jcfg
from syncvsr_tpu.data.synthetic import word_batch as jax_word_batch
from syncvsr_tpu_torch import config as tcfg
from syncvsr_tpu_torch.data.synthetic import sentence_batch, word_batch
from syncvsr_tpu_torch.engine import create_train_state
from syncvsr_tpu_torch.models import build_model
from syncvsr_tpu_torch.utils.bridge import flax_leaf, from_flax, to_flax
from torch_parity import configs, jax_model_and_vars, sentence_configs, torch_model
import torch_threads  # one torch thread a test process

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_config_copy_matches(name):
    assert tcfg.PRESETS[name]().to_dict() == jcfg.PRESETS[name]().to_dict()
    over = {"optim.lr": 3e-4, "data.rrc_scale": [0.5, 1.0]}
    assert (tcfg.PRESETS[name]().override(**over).to_dict()
            == jcfg.PRESETS[name]().override(**over).to_dict())


@pytest.mark.parametrize("name", ["lrw_video", "lrw1000", "lrw_landmark"])
def test_synthetic_word_batch_matches(name):
    a = word_batch(tcfg.PRESETS[name](), batch_size=3, seed=5)
    b = jax_word_batch(jcfg.PRESETS[name](), batch_size=3, seed=5)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_bridge_round_trip_is_exact_and_total():
    cfg_j, cfg_t = configs()
    batch = word_batch(cfg_t)
    _, params, stats = jax_model_and_vars(cfg_j, batch)
    model = torch_model(cfg_t, params, stats)  # strict load: every entry mapped
    sd = model.state_dict()
    assert set(sd) == set(from_flax(params, stats))
    p2, s2 = to_flax(sd)
    for tree, back in ((params, p2), (stats, s2)):
        a, b = dict(_leaves(tree)), dict(_leaves(back))
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg="/".join(k))
    # decay mask: exactly the flax leaves named "kernel"
    decayed = {n for n, p in model.named_parameters() if flax_leaf(n, p.dim()) == "kernel"}
    kernels = {".".join(k[:-1]) for k, _ in _leaves(params) if k[-1] == "kernel"}
    assert {n.rsplit(".", 1)[0] for n in decayed} == kernels
    assert "frontend.stem_conv_kernel" not in decayed and "cls_token" not in decayed


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import syncvsr_tpu_torch\n"
        "for m in pkgutil.walk_packages(syncvsr_tpu_torch.__path__, 'syncvsr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'syncvsr_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = torch_threads.env(PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    # chip_smoke.py imports only the port (it cannot run here: no card)
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "syncvsr_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "optax", "syncvsr_tpu"}


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_the_card_or_the_port(where, tmp_path):
    """chip_smoke.py has no CPU path: without a card (and, copied alone into
    an empty directory, without the port either) it exits non-zero and
    prints no ok line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = tmp_path / "chip_smoke.py"
        script.write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in torch_threads.env().items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_entry_points_need_a_card_or_cpu():
    cfg = tcfg.lrw_video_config().override(**{
        "model.encoder.layers": 1, "model.encoder.dim": 32, "model.encoder.heads": 2,
        "model.frontend.resnet_width": 8, "data.batch_size": 2, "data.num_frames": 2,
        "data.crop_size": 16})
    batch = {k: torch.from_numpy(v) for k, v in word_batch(cfg).items()}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
    model = build_model(cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_train_state(cfg, model, batch)
    state = create_train_state(cfg, model, batch, device="cpu")
    assert state.dropout_gen.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in state.params)
    # model.remat is ported (the transformer's blocks recompute); the TCN
    # path ignores it, as the JAX package's does
    assert build_model(cfg.override(**{"model.remat": True}), device="cpu").encoder.remat
    # as in the JAX package, a word model over any non-TCN kind is a
    # transformer (tests/test_torch_bridge.py::test_other_encoder_kinds_build_jax_trees)
    other = build_model(cfg.override(**{"model.encoder.kind": "conformer"}), device="cpu")
    assert type(other.encoder).__name__ == "TransformerEncoder"
    with pytest.raises(ValueError, match="unknown task"):
        build_model(cfg.override(**{"model.task": "phoneme"}), device="cpu")
    # the split kernel (K2) at 640 tokens a slot is ported: a DC-TCN head
    # (1664 wide) with the wav2vec2 codec builds
    head = build_model(tcfg.lrw_dctcn_config().override(**{
        "model.codec.audio_alignment": 2, "model.codec.vq_groups": 2,
        "model.codec.audio_vocab_size": 640}), device="cpu").audio_classifier
    assert head.vocab == 640 and head.weight.shape == (4 * 640, 1664)


@pytest.mark.parametrize("task,kind", [("word", "conformer"), ("sentence", "transformer")])
def test_other_encoder_kinds_build_jax_trees(task, kind):
    """The JAX package reads no ``encoder.kind`` outside the TCN family: a
    word model of another kind is a transformer and a sentence model of any
    kind a Conformer. The port builds the same trees: every flax leaf maps
    onto the port model (a strict load) with its shape, and back bitwise."""
    if task == "word":
        cfg_j, cfg_t = configs(**{"model.encoder.kind": kind})
        batch = word_batch(cfg_t)
    else:
        cfg_j, cfg_t = sentence_configs(**{"model.encoder.kind": kind})
        batch = sentence_batch(cfg_t, num_frames=4, label_len=2)
    _, params, stats = jax_model_and_vars(cfg_j, batch)
    model = torch_model(cfg_t, params, stats)
    sd = model.state_dict()
    ref = from_flax(params, stats)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == v.shape, k
    p2, s2 = to_flax(sd)
    for tree, back in ((params, p2), (stats, s2)):
        a, b = dict(_leaves(tree)), dict(_leaves(back))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg="/".join(k))

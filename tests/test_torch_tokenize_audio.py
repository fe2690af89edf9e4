"""PyTorch port: the offline audio tokenizer (``syncvsr_tpu_torch/tools/
tokenize_audio.py``) against the JAX package's (``syncvsr_tpu/tools/
tokenize_audio.py``), on the CPU (``device="cpu"``): tokens equal on both
routes. ``vq``: fairseq checkpoints with and without skip connections and
GELU, through the port's in-step ``vq_tokens``. ``wav2vec2``: tiny HF
models saved by ``transformers`` (the JAX tool's loader) as safetensors and
as ``pytorch_model.bin``, with GroupNorm and LayerNorm feature extractors,
and a directory the port's ``synthetic_ckpt.write_hf_wav2vec2`` writes
without ``transformers`` (which ``transformers`` loads); the port never
imports ``transformers``. Then ``tokenize_tree`` over an LRW pkl tree (the
same token pkls), the waveform readers, and the CLI."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from syncvsr_tpu.tools import tokenize_audio as jtok
from syncvsr_tpu_torch.data.synthetic_ckpt import write_fairseq_vq, write_hf_wav2vec2
from syncvsr_tpu_torch.tools import tokenize_audio as ttok
from tests.conftest import make_lrw_tree
from tests.test_tokenize_audio import _fake_vq_checkpoint
import torch_threads  # one torch thread a test process

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CONVS = [(8, 10, 5), (8, 8, 4), (8, 4, 2), (8, 4, 2), (8, 4, 2), (8, 1, 1)]


def _hf_dir(tmp, name, **over):
    """A tiny ``Wav2Vec2ForPreTraining`` saved by ``transformers``."""
    from transformers import Wav2Vec2Config, Wav2Vec2ForPreTraining

    cfg = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
               intermediate_size=32, conv_dim=(8, 8), conv_kernel=(10, 8),
               conv_stride=(80, 4), num_codevector_groups=2, num_codevectors_per_group=7,
               codevector_dim=8, proj_codevector_dim=8, num_conv_pos_embeddings=16,
               num_conv_pos_embedding_groups=2)
    safe = over.pop("safe", True)
    cfg.update(over)
    torch.manual_seed(0)
    model = Wav2Vec2ForPreTraining(Wav2Vec2Config(**cfg))
    d = str(tmp / name)
    model.save_pretrained(d, safe_serialization=safe)
    return d


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("w2v2")
    dirs = {"group_safetensors": _hf_dir(tmp, "group"),
            "group_bin": _hf_dir(tmp, "bin", safe=False),
            "layer_bias": _hf_dir(tmp, "layer", feat_extract_norm="layer", conv_bias=True,
                                  do_stable_layer_norm=True)}
    dirs["written"] = str(tmp / "written")
    write_hf_wav2vec2(dirs["written"], seed=3, conv_dim=(16, 16, 16),
                      conv_kernel=(10, 3, 2), conv_stride=(5, 4, 16), vocab=11)
    return dirs


@pytest.fixture(scope="module")
def vq_ckpts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vq")
    paths = {"skip": str(tmp / "skip.pt"), "gelu": str(tmp / "gelu.pt")}
    _fake_vq_checkpoint(paths["skip"])   # 5 layers 4 wide, skip connections
    write_fairseq_vq(paths["gelu"], seed=2, conv_layers=SMALL_CONVS, num_vars=9,
                     separation=3.0, activation="gelu")
    return paths


WAVS = [np.random.RandomState(i).randn(n).astype(np.float32) * 0.3
        for i, n in ((0, 16000), (1, 7351))]


@pytest.mark.parametrize("which", ["group_safetensors", "group_bin", "layer_bias", "written"])
def test_wav2vec2_tokens_match_jax(hf_dirs, which):
    want_q = jtok.build_quantizer("wav2vec2", hf_dirs[which])
    got_q = ttok.build_quantizer("wav2vec2", hf_dirs[which], device="cpu")
    for wav in WAVS:
        want, got = want_q(wav), got_q(wav)
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            ttok.tokenize_waveform(got_q, wav, 25, 2),
            jtok.tokenize_waveform(want_q, wav, 25, 2))
    batch = np.stack([WAVS[0][:7351], WAVS[1]])
    np.testing.assert_array_equal(got_q(batch), want_q(batch))


@pytest.mark.parametrize("which", ["skip", "gelu"])
def test_vq_tokens_match_jax_tool(vq_ckpts, which):
    """The JAX tool's own torch VQWav2Vec (explicit distances) against the
    port's ``vq_tokens`` (the codebook product)."""
    want_q = jtok.build_quantizer("vq", vq_ckpts[which])
    got_q = ttok.build_quantizer("vq", vq_ckpts[which], device="cpu")
    for wav in WAVS:
        np.testing.assert_array_equal(got_q(wav), want_q(wav))
        np.testing.assert_array_equal(ttok.tokenize_waveform(got_q, wav, 25, 4),
                                      jtok.tokenize_waveform(want_q, wav, 25, 4))


def test_the_port_never_imports_transformers(hf_dirs, vq_ckpts):
    """Both routes in a fresh interpreter: ``transformers`` stays out of
    ``sys.modules``; without ``device`` the tool asks for the card."""
    code = (
        "import sys, numpy as np\n"
        "from syncvsr_tpu_torch.tools.tokenize_audio import build_quantizer\n"
        "wav = np.zeros(16000, np.float32)\n"
        f"build_quantizer('wav2vec2', {hf_dirs['written']!r}, device='cpu')(wav)\n"
        f"build_quantizer('vq', {vq_ckpts['gelu']!r}, device='cpu')(wav)\n"
        "assert 'transformers' not in sys.modules, 'transformers imported'\n"
        "try:\n"
        f"    build_quantizer('vq', {vq_ckpts['gelu']!r})\n"
        "except RuntimeError as e:\n"
        "    assert 'no CUDA device' in str(e)\n"
        "else:\n"
        "    import torch; assert torch.cuda.is_available()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env=torch_threads.env(PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]


@pytest.mark.parametrize("codec", ["wav2vec2", "vq"])
def test_tokenize_tree_matches_jax(hf_dirs, vq_ckpts, codec, tmp_path):
    root = make_lrw_tree(tmp_path / "LRW", words=("ABOUT",), n=2, with_audio=True,
                         with_tokens=False)
    model = hf_dirs["group_safetensors"] if codec == "wav2vec2" else vq_ckpts["gelu"]
    want = jtok.tokenize_tree(str(root), str(tmp_path / "jax"), codec, model)
    got = ttok.tokenize_tree(str(root), str(tmp_path / "port"), codec, model, device="cpu")
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want]
    assert len(got) == 4
    for g, w in zip(got, want):
        gt = torch.load(g, weights_only=False)[f"{codec}_tokens"]
        wt = torch.load(w, weights_only=False)[f"{codec}_tokens"]
        assert gt.dtype == wt.dtype and gt.shape == (29 * (2 if codec == "wav2vec2" else 4), 2)
        np.testing.assert_array_equal(gt, wt)
    # resumable: a second run writes nothing
    assert ttok.tokenize_tree(str(root), str(tmp_path / "port"), codec, model,
                              device="cpu") == []
    # the CLI, --overwrite, over the wav route too
    from scipy.io import wavfile

    wavfile.write(str(root / "extra.wav"), 16000, (WAVS[0] * 20000).astype(np.int16))
    written = ttok.main(["--src", str(root), "--dst", str(tmp_path / "cli"), "--codec", codec,
                         "--model", model, "--device", "cpu"])
    assert len(written) == 5 and written[-1].endswith("extra.pkl")
    extra = torch.load(written[-1], weights_only=False)[f"{codec}_tokens"]
    want_q = jtok.build_quantizer(codec, model)
    np.testing.assert_array_equal(extra, jtok.tokenize_waveform(
        want_q, jtok.read_wav(str(root / "extra.wav")), 25, 2 if codec == "wav2vec2" else 4))


def test_to_waveform_matches_jax():
    mono = (np.sin(np.linspace(0, 100, 1600)) * 20000).astype(np.int16)
    for payload in (mono, np.stack([mono, mono]), np.stack([mono, mono]).T,
                    mono.astype(np.float64) / 7e4, {"array": mono, "sample_rate": 16000}):
        got, want = ttok.to_waveform(payload), jtok.to_waveform(payload)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        ttok.to_waveform({"array": np.zeros(4), "sample_rate": 8000})

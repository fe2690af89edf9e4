"""PyTorch port: the in-step vq-wav2vec tokenizer (``syncvsr_tpu_torch/ops/
codec.py``) against the JAX package's (``syncvsr_tpu/ops/codec.py``), on
the CPU, from the same seeded fairseq checkpoints: the tokens (equal, at the
JAX tests' 8-wide geometry and at vq-wav2vec's 512-wide one), the batch
hook (shape, the -1 tail past each clip's length, the -1 pad of a
conv-arithmetic shortfall), a small ``lrs3`` train step that tokenizes in
the step (the losses of both packages within 1e-4 relative: f32 sums in
other orders, as ``test_torch_sentence_step.py``), and ``train.py``
with ``model.codec.in_step=true`` (its checkpoints hold no codec leaf: the
same tree as without it, the JAX model's)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu import config as jcfg
from syncvsr_tpu.engine import build_train_step as jax_build_train_step
from syncvsr_tpu.engine import create_train_state as jax_create_train_state
from syncvsr_tpu.models import build_model as jax_build_model
from syncvsr_tpu.ops import codec as jcodec
from syncvsr_tpu.ops.image import build_sentence_eval_transform as jax_eval_transform
from syncvsr_tpu_torch import train as ttrain
from syncvsr_tpu_torch.data.synthetic import sentence_batch
from syncvsr_tpu_torch.data.synthetic_ckpt import write_fairseq_vq
from syncvsr_tpu_torch.data.synthetic_tree import write_lrs_tree
from syncvsr_tpu_torch.engine import build_train_step, create_train_state
from syncvsr_tpu_torch.ops import codec
from syncvsr_tpu_torch.ops.image import batch_hook, build_sentence_eval_transform
from syncvsr_tpu_torch.utils import checkpoint as tckpt
from torch_parity import JitInit, close, sentence_configs, to_np, torch_model, tt
import torch_threads  # noqa: F401  (one torch thread a test process)

# tests/test_codec_instep.py's geometry: 8 convs 8 wide, G = 2
NARROW = [(8, 10, 5), (8, 8, 4), (8, 4, 2), (8, 4, 2), (8, 4, 2), (8, 1, 1), (8, 1, 1),
          (8, 1, 1)]
METRICS = ("loss", "loss_ctc", "loss_att", "loss_audio", "grad_norm")


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Seeded fairseq checkpoints: the 8-wide geometry at 13 codes (the tiny
    sentence model's sync vocabulary) and vq-wav2vec's own (512 wide, 320
    codes), each codebook drawn at 3x scale (argmins clear of rounding)."""
    d = tmp_path_factory.mktemp("vq")
    paths = {"narrow": str(d / "narrow.pt"), "wide": str(d / "wide.pt")}
    write_fairseq_vq(paths["narrow"], seed=0, conv_layers=NARROW, num_vars=13, separation=3.0)
    write_fairseq_vq(paths["wide"], seed=1, separation=3.0)
    return paths


@pytest.mark.parametrize("which,samples", [("narrow", 16000), ("wide", 4000)])
def test_vq_tokens_match_jax(ckpts, which, samples):
    jp, jg = jcodec.load_vq_codec(ckpts[which])
    tp, tg = codec.load_vq_codec(ckpts[which], "cpu")
    assert {k: tg[k] for k in jg} == jg
    wav = np.random.RandomState(2).randn(3, samples).astype(np.float32) * 0.1
    want = np.asarray(jax.jit(lambda p, w: jcodec.vq_tokens(p, w, strides=jg["strides"]))(
        jp, jnp.asarray(wav)))
    got = codec.vq_tokens(tp, tt(wav), strides=tg["strides"], **tg["features"])
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the codec's tensors are built once a process
    assert codec.load_vq_codec(ckpts[which], "cpu")[0] is tp


@pytest.mark.parametrize("frames,samples", [(6, 6 * 640), (20, 2000)],
                         ids=["full", "shortfall"])
def test_instep_hook_matches_jax(ckpts, frames, samples):
    """[B, frames * 4, G] tokens, -1 past each clip's length; with 2000
    samples for 20 frames the codec gives fewer rows than 80, and the rest
    are -1."""
    jp, jg = jcodec.load_vq_codec(ckpts["narrow"])
    tp, tg = codec.load_vq_codec(ckpts["narrow"], "cpu")
    rng = np.random.RandomState(3)
    batch = {"videos": np.zeros((2, frames, 8, 8, 1), np.float32),
             "lengths": np.array([frames, frames // 2], np.int32),
             "audio": rng.randn(2, samples).astype(np.float32) * 0.1}
    want = jax.jit(jcodec.make_instep_tokenizer(jp, alignment=4, strides=jg["strides"]))(
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = codec.make_instep_tokenizer(tp, alignment=4, strides=tg["strides"],
                                      **tg["features"])({k: tt(v) for k, v in batch.items()})
    assert "audio" not in got and set(got) == set(want)
    toks = got["audio_tokens"].numpy()
    np.testing.assert_array_equal(toks, np.asarray(want["audio_tokens"]))
    assert toks.shape == (2, frames * 4, 2)
    assert (toks[1, frames // 2 * 4:] == -1).all()
    # the full-length clip: the codec's rows, then the shortfall's -1 pad
    made = int((toks[0, :, 0] >= 0).sum())
    assert (toks[0, :made] >= 0).all() and (toks[0, made:] == -1).all()
    assert (made < frames * 4) == (samples < frames * 640)


def test_instep_train_step_matches_jax(ckpts):
    """Two f32 steps of the tiny lrs3 model whose sync targets come from
    the codec inside the step (the eval transform stands in for the
    augmentation on both sides: no random draw), from bridged weights:
    every loss within 1e-4 relative of the JAX step's."""
    cfg_j, cfg_t = sentence_configs(**{"model.codec.in_step": True,
                                       "model.codec.ckpt": ckpts["narrow"]})
    frames = 10
    batch = sentence_batch(cfg_t, num_frames=frames, label_len=3, seed=0)
    rng = np.random.RandomState(5)
    b = cfg_t.data.batch_size
    batch["videos"] = rng.randint(0, 256, (b, frames, 20, 20, 1)).astype(np.uint8)
    batch["audio"] = (rng.randn(b, frames * 640) * 0.1).astype(np.float32)
    del batch["audio_tokens"]

    jp, jg = jcodec.load_vq_codec(ckpts["narrow"])
    tok_j = jcodec.make_instep_tokenizer(jp, alignment=4, strides=jg["strides"])
    ev_j = jax_eval_transform(cfg_j.data)
    tok_t = ttrain.instep_tokenizer(cfg_t, torch.device("cpu"))
    ev_t = build_sentence_eval_transform(cfg_t.data)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    init = jax.jit(lambda b: ev_j(tok_j(b)))(jb)   # shapes for the init: jitted
    model_j = jax_build_model(cfg_j)
    state_j = jax_create_train_state(cfg_j, JitInit(model_j), init)
    model = torch_model(cfg_t, to_np(state_j.params), to_np(state_j.batch_stats))
    tb = {k: tt(v) for k, v in batch.items()}
    state = create_train_state(cfg_t, model, ev_t(tok_t(tb)), device="cpu")
    step_j = jax_build_train_step(donate=False, aug_fn=lambda r, x: ev_j(tok_j(x)))
    step = build_train_step(aug_fn=batch_hook(lambda x: ev_t(tok_t(x))))
    for i in range(2):
        state_j, m_j = step_j(state_j, jb)
        state, m = step(state, tb)
        for k in METRICS:
            close(m[k], float(m_j[k]), 1e-4, 1e-7, f"step {i + 1} {k}")
    # the sync loss scored the codec's tokens, not nothing
    assert float(m["loss_audio"]) > 0.1


def test_train_cli_instep_checkpoint_has_no_codec_leaf(ckpts, tmp_path, monkeypatch):
    """``python -m syncvsr_tpu_torch.train model.codec.in_step=true`` from a
    pkl tree with waveforms trains; its checkpoint has the same tree as a
    run that reads the pkls' offline tokens, and that tree is the JAX
    model's."""
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "data")
    write_lrs_tree(root, "LRS3", {"train": [5, 7, 3, 12, 16, 9], "val": [6, 11]},
                   seed=4, size=20, vocab=13)
    common = ["preset=lrs3", 'data.dataset="lrs3"', f"data.root={json.dumps(root)}",
              "model.encoder.layers=1", "model.encoder.dim=16", "model.encoder.heads=2",
              "model.encoder.conv_kernel=7", "model.decoder.layers=1", "model.decoder.dim=16",
              "model.decoder.heads=2", "model.decoder.hidden=32",
              "model.frontend.resnet_width=8", "model.codec.audio_vocab_size=13",
              'model.dtype="float32"', "data.crop_size=16", "data.length_buckets=[8,16]",
              "data.max_frames=16", "data.max_frames_val=16", "data.batch_size=4",
              "data.eval_batch_size=4", "data.max_label_len=24", "data.num_workers=1",
              "optim.total_steps=2", "train.log_every=1", "train.eval_every=2",
              "train.ckpt_every=2"]
    trees = {}
    for in_step in (True, False):
        ck = str(tmp_path / f"ck_{in_step}")
        over = [f"model.codec.in_step={str(in_step).lower()}",
                f"model.codec.ckpt={json.dumps(ckpts['narrow'])}"]
        final = ttrain.main(common + over + [f"train.ckpt_dir={json.dumps(ck)}"],
                            device="cpu")
        assert np.isfinite(final["val/loss"])
        payload = tckpt.load_msgpack(os.path.join(ck, "step_2.msgpack"))
        trees[in_step] = {k: np.shape(v) for k, v in tckpt.flatten(payload).items()
                          if k.startswith(("params.", "batch_stats.", "opt_state."))}
    assert trees[True] == trees[False]
    assert not any("codec" in k or "embedding_sq" in k for k in trees[True])
    cfg_j = jcfg.PRESETS["lrs3"]().override(**jcfg.parse_cli_overrides(common[1:]))
    init = {"videos": jnp.zeros((2, 8, 16, 16, 1)), "lengths": jnp.array([8, 8]),
            "labels": jnp.zeros((2, 3), jnp.int32),
            "audio_tokens": jnp.zeros((2, 32, 2), jnp.int32)}
    variables = JitInit(jax_build_model(cfg_j)).init(
        {"params": jax.random.PRNGKey(0), "mixup": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, **init, det=True)
    want = {f"params.{k}": np.shape(v) for k, v in tckpt.flatten(to_np(
        variables["params"])).items()}
    assert {k: v for k, v in trees[True].items() if k.startswith("params.")} == want

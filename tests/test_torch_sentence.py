"""PyTorch port: the lrs3 sentence-level model (conv3d frontend + Conformer
+ CTC + attention decoder + sync head) against the JAX SentenceVSRModel
from bridged weights, on the CPU, in f32; its synthetic batch, weight
bridge, decay mask and factory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu import config as jcfg
from syncvsr_tpu.data.synthetic import sentence_batch as jax_sentence_batch
from syncvsr_tpu.engine.state import _decay_mask
from syncvsr_tpu_torch import config as tcfg
from syncvsr_tpu_torch.data.synthetic import sentence_batch
from syncvsr_tpu_torch.engine import create_train_state
from syncvsr_tpu_torch.models import build_model
from syncvsr_tpu_torch.models.e2e import SentenceVSRModel
from syncvsr_tpu_torch.utils.bridge import flax_leaf, from_flax, to_flax
from torch_parity import close, jax_model_and_vars, sentence_configs, to_np, torch_model, tt
import torch_threads  # noqa: F401  (one torch thread a test process)

KEYS = ("loss", "loss_ctc", "loss_att", "loss_audio", "decoder_acc")
FRAMES, LABEL_LEN = 10, 3   # every clip keeps >= 5 frames: CTC stays feasible


@pytest.fixture(scope="module")
def pair():
    """The tiny lrs3 model initialised once in JAX, and its batch."""
    cfg_j, cfg_t = sentence_configs()
    batch = sentence_batch(cfg_t, num_frames=FRAMES, label_len=LABEL_LEN, seed=0)
    batch["audio_tokens"][0, :3] = -1   # some ignored sync slots
    model_j, params, stats = jax_model_and_vars(cfg_j, batch)
    return cfg_j, cfg_t, batch, model_j, params, stats


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("name", ["lrs3", "lrs3_audio", "vox2"])
def test_sentence_batch_matches(name):
    over = {"data.crop_size": 16}
    a = sentence_batch(tcfg.PRESETS[name]().override(**over), batch_size=3, num_frames=6,
                       label_len=4, seed=5)
    b = jax_sentence_batch(jcfg.PRESETS[name]().override(**over), batch_size=3,
                           num_frames=6, label_len=4, seed=5)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


# f32: the 20-BN trunk, the Conformer and the decoder agree to ~1e-6
@pytest.mark.parametrize("weighted", [False, True])
def test_sentence_model_eval_matches_jax(pair, weighted):
    cfg_j, cfg_t, batch, model_j, params, stats = pair
    if weighted:
        batch = dict(batch, sample_weight=np.array([1.0, 0.0], np.float32))
    out_j = jax.jit(lambda v, b: model_j.apply(v, **b, det=True))(
        {"params": params, "batch_stats": stats}, {k: jnp.asarray(v) for k, v in batch.items()})
    model = torch_model(cfg_t, params, stats)
    assert isinstance(model, SentenceVSRModel) and hasattr(model, "proj_decoder")
    with torch.no_grad():
        out = model(**{k: tt(v) for k, v in batch.items()}, det=True)
    assert set(out) == set(out_j) == set(KEYS) | {"_tokens", "_slots"}
    for k in out_j:
        close(out[k], out_j[k], 2e-5, 2e-5, k)


def test_sentence_model_train_mode_matches_jax(pair):
    """det=False with dropout 0: train-mode BatchNorm in the trunk and in
    every Conformer block, the losses, every gradient and the running
    statistics."""
    cfg_j, cfg_t, batch, model_j, params, stats = pair

    def loss(p, b):
        out, mut = model_j.apply({"params": p, "batch_stats": stats}, **b, det=False,
                                 mutable=["batch_stats"])
        return out["loss"], (out, mut["batch_stats"])

    (_, (out_j, stats_j)), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = torch_model(cfg_t, params, stats)
    out = model(**{k: tt(v) for k, v in batch.items()}, det=False)
    out["loss"].backward()
    for k in KEYS:
        close(out[k], out_j[k], 2e-5, 2e-5, k)
    grads, _ = to_flax({n: p.grad for n, p in model.named_parameters()})
    want_g = dict(_leaves(to_np(g_j)))
    got_g = dict(_leaves(grads))
    assert want_g.keys() == got_g.keys()
    # 1e-4 of each leaf's largest element, and an absolute 1e-6 for the leaves
    # whose true gradient is zero (the depthwise conv's bias, which the
    # train-mode BatchNorm right after it cancels) and carry only f32 noise
    # (~2e-7 against gradients of O(1))
    for path, want in want_g.items():
        scale = float(np.abs(want).max())
        close(got_g[path], want, 1e-3, 1e-4 * scale + 1e-6, "/".join(path))
    _, stats_t = to_flax(model.state_dict())
    for path, want in _leaves(to_np(stats_j)):
        got = dict(_leaves(stats_t))[path]
        close(got, want, 1e-4, 1e-5, "/".join(path))


def test_sentence_bridge_round_trip_and_decay_mask(pair):
    """Every flax leaf maps (the depthwise ``dw`` kernel, ``pos_bias_u/v``,
    ``embedding``) and back exactly; the port decays exactly the leaves JAX's
    ``_decay_mask`` decays."""
    cfg_j, cfg_t, batch, model_j, params, stats = pair
    model = torch_model(cfg_t, params, stats)   # strict load: every entry mapped
    sd = model.state_dict()
    assert set(sd) == set(from_flax(params, stats))
    w = sd["encoder.block_0.conv.dw.weight"].numpy()
    np.testing.assert_array_equal(w[:, 0, :],
                                  params["encoder"]["block_0"]["conv"]["dw"]["kernel"][:, 0].T)
    p2, s2 = to_flax(sd)
    for tree, back in ((params, p2), (stats, s2)):
        a, b = dict(_leaves(tree)), dict(_leaves(back))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg="/".join(k))
    state = create_train_state(cfg_t, model, {k: tt(v) for k, v in batch.items()},
                               device="cpu")
    mask = dict(_leaves(jax.tree_util.tree_map(bool, _decay_mask(params))))
    flags = {tuple(n.split(".")[:-1]) + (flax_leaf(n, p.dim()),): d
             for n, p, d in zip(state.names, state.params, state.decay)}
    assert flags == mask
    for leaf in ("pos_bias_u", "pos_bias_v", "embedding"):
        assert any(k[-1] == leaf and not v for k, v in flags.items())


def test_sentence_factory_and_batch_checks():
    cfg = sentence_configs()[1]
    model = build_model(cfg, device="cpu")
    assert isinstance(model, SentenceVSRModel)
    batch = {k: tt(v) for k, v in sentence_batch(cfg, num_frames=4, label_len=2).items()}
    create_train_state(cfg, model, batch, device="cpu")
    with pytest.raises(ValueError, match="videos and lengths"):
        create_train_state(cfg, model, {k: v for k, v in batch.items() if k != "lengths"},
                           device="cpu")
    # model.remat is ported: its blocks recompute (tests/test_torch_remat.py);
    # as in the JAX package, a sentence model of any encoder kind is a Conformer
    assert build_model(cfg.override(**{"model.remat": True}), device="cpu").encoder.remat
    other = build_model(cfg.override(**{"model.encoder.kind": "transformer"}), device="cpu")
    assert type(other.encoder).__name__ == "ConformerEncoder"

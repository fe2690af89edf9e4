"""PyTorch port: ``model.remat`` (flax ``nn.remat`` of the encoder blocks,
and of the sentence model's frontend in training) on the CPU. The port's
remat train step against the JAX package's remat step from bridged weights
(f32, dropout 0: loss, Adam's moments and the BatchNorm statistics, at
``test_torch_sentence_step``'s and ``test_torch_landmark``'s tolerances);
within the port, remat and plain steps bitwise equal with dropout on (the
recompute replays each region's dropout masks from its generator's state at
the forward), the recompute really running (each BatchNorm's forward twice
a step), and the running statistics moved once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.engine import build_train_step as jax_build_train_step
from syncvsr_tpu.engine import create_train_state as jax_create_train_state
from syncvsr_tpu.models import build_model as jax_build_model
from syncvsr_tpu_torch.data.synthetic import word_batch
from syncvsr_tpu_torch.engine import build_train_step, create_train_state
from syncvsr_tpu_torch.models import build_model
from syncvsr_tpu_torch.ops.cuda_bn import FastBatchNorm
from syncvsr_tpu_torch.utils.bridge import to_flax
from test_torch_sentence_step import METRICS, _compare, _uint8_batch
from test_torch_step import _adam_moments
from torch_parity import JitInit, close, landmark_configs, sentence_configs, to_np, torch_model, tt
import torch_threads  # noqa: F401  (one torch thread a test process)

REMAT = {"model.remat": True, "optim.lr": 1e-4}
DROPOUT_ON = {"model.encoder.mlp_dropout": 0.1, "model.encoder.msa_dropout": 0.1,
              "model.decoder.dropout": 0.1}
WORD_DROPOUT_ON = {"model.encoder.emb_dropout": 0.1, "model.encoder.msa_dropout": 0.1,
                   "model.encoder.mlp_dropout": 0.1, "model.encoder.droppath": 0.1}


def _snapshot(state, metrics):
    params, stats = to_flax(state.model.state_dict())
    return {"params": params, "batch_stats": stats,
            "mu": to_flax(dict(zip(state.names, state.mu)))[0],
            "nu": to_flax(dict(zip(state.names, state.nu)))[0],
            "metrics": {k: float(metrics[k]) for k in metrics}}


def _jax_steps(cfg_j, batch, n):
    """``n`` JAX train steps (no augmentation) from a jitted init; returns
    (the initial params and batch_stats, the snapshot after the steps)."""
    state_j = jax_create_train_state(cfg_j, JitInit(jax_build_model(cfg_j)),
                                     {k: jnp.asarray(v) for k, v in batch.items()})
    init = to_np(state_j.params), to_np(state_j.batch_stats)
    step = jax_build_train_step(donate=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(n):
        state_j, m = step(state_j, jb)
    mu, nu = _adam_moments(state_j.opt_state)
    return init, {"params": to_np(state_j.params), "batch_stats": to_np(state_j.batch_stats),
                  "mu": to_np(mu), "nu": to_np(nu),
                  "metrics": {k: float(m[k]) for k in m}}


def _port_steps(cfg_t, batch, n, params=None, batch_stats=None):
    """``n`` port train steps (no augmentation); returns (snapshot, state,
    the BatchNorms' forward calls a step)."""
    model = (torch_model(cfg_t, params, batch_stats) if params is not None
             else build_model(cfg_t, device="cpu"))
    calls = [0]
    for m in model.modules():
        if isinstance(m, FastBatchNorm):
            m.register_forward_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
    tb = {k: tt(v) for k, v in batch.items()}
    state = create_train_state(cfg_t, model, tb, device="cpu")
    step = build_train_step()
    for _ in range(n):
        state, m = step(state, tb)
    return _snapshot(state, m), state, calls[0] / n


def _sentence_batch(cfg_t):
    """_uint8_batch's clips, cropped to the model's size as f32 (the step
    takes no augmentation here)."""
    batch = _uint8_batch(cfg_t)
    s = cfg_t.data.crop_size
    batch["videos"] = batch["videos"][:, :, :s, :s].astype(np.float32) / 255.0
    return batch


@pytest.fixture(scope="module")
def sentence_runs():
    cfg_j, cfg_t = sentence_configs(**REMAT)
    batch = _sentence_batch(cfg_t)
    (params, stats), want = _jax_steps(cfg_j, batch, 2)
    got, _, _ = _port_steps(cfg_t, batch, 2, params, stats)
    return want, got


def test_sentence_remat_step_matches_jax(sentence_runs):
    """Two remat steps: the metrics, batch_stats and Adam's moments with
    test_torch_sentence_step's tolerances and reasons."""
    j, t = sentence_runs
    for k in METRICS:
        close(t["metrics"][k], j["metrics"][k], 1e-4, 1e-7, k)
    _compare(t["batch_stats"], j["batch_stats"], 1e-4, 1e-5, "batch_stats")
    _compare(t["mu"], j["mu"], 1e-3, 5e-4, "mu")
    _compare(t["nu"], j["nu"], 1e-3, 1e-3, "nu")


def test_word_remat_step_matches_jax():
    """The word transformer's remat blocks (the landmark model): two steps,
    with test_torch_landmark's tolerances."""
    over = dict(REMAT, **{"model.frontend.input_features": 12})
    cfg_j, cfg_t = landmark_configs(**over)
    batch = word_batch(cfg_t, seed=0)
    (params, _), j = _jax_steps(cfg_j, batch, 2)
    t, _, _ = _port_steps(cfg_t, batch, 2, params, {})
    for k in ("loss", "loss_word", "loss_audio", "grad_norm", "learning_rate"):
        close(t["metrics"][k], j["metrics"][k], 1e-4, 1e-7, k)
    _compare(t["mu"], j["mu"], 1e-3, 5e-4, "mu")
    _compare(t["nu"], j["nu"], 1e-3, 1e-3, "nu")


def _assert_trees_bitwise(a, b, what):
    for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a),
                            jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=what + jax.tree_util.keystr(path))


@pytest.mark.parametrize("kind", ["sentence", "word"])
def test_remat_is_bitwise_in_the_port(kind):
    """Dropout (and drop-path) on: three steps with remat equal three without,
    bitwise (params, Adam's moments, running statistics, metrics, and the
    generators' states after them); the recompute runs (every BatchNorm's
    forward twice a sentence step) and leaves the running statistics as
    the forward set them."""
    if kind == "sentence":
        over = DROPOUT_ON
        cfg = lambda r: sentence_configs(**over, **{"model.remat": r})[1]
        batch = _sentence_batch(cfg(False))
    else:
        over = dict(WORD_DROPOUT_ON, **{"model.frontend.input_features": 12})
        cfg = lambda r: landmark_configs(**over, **{"model.remat": r})[1]
        batch = word_batch(cfg(False), seed=1)
    plain, s_plain, calls_plain = _port_steps(cfg(False), batch, 3)
    remat, s_remat, calls_remat = _port_steps(cfg(True), batch, 3)
    assert plain["metrics"] == remat["metrics"]
    for key in ("params", "mu", "nu", "batch_stats"):
        _assert_trees_bitwise(remat[key], plain[key], key)
    assert torch.equal(s_plain.dropout_gen.get_state(), s_remat.dropout_gen.get_state())
    if kind == "sentence":
        n_bn = sum(isinstance(m, FastBatchNorm) for m in s_plain.model.modules())
        assert calls_plain == n_bn and calls_remat == 2 * n_bn

"""PyTorch port: checkpoints in the JAX package's format, on the CPU. The
msgpack codec against flax's (the same bytes both ways); a JAX
``save_train_state`` checkpoint restored into the port (params, BatchNorm
statistics, Adam's moments and count, step: bitwise after the bridge); a
port checkpoint restored by JAX's ``restore_train_state``, both packages'
eval metrics equal on it (f32, 1e-5 relative: sums in other orders); and
``partial_load``/``rename``, ``latest_checkpoint``/``_prune`` and the async
saver as the JAX package's tests hold them."""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.engine import build_eval_step as jax_build_eval_step
from syncvsr_tpu.engine import create_train_state as jax_create_train_state
from syncvsr_tpu.models import build_model as jax_build_model
from syncvsr_tpu.ops.image import build_eval_transform as jax_eval_transform
from syncvsr_tpu.utils import checkpoint as jckpt
from syncvsr_tpu_torch.data.synthetic import word_batch
from syncvsr_tpu_torch.engine import build_eval_step, build_train_step, create_train_state
from syncvsr_tpu_torch.ops.image import build_eval_transform
from syncvsr_tpu_torch.utils import checkpoint as tckpt
from syncvsr_tpu_torch.utils import msgpack as tmsgpack
from syncvsr_tpu_torch.utils.bridge import to_flax
from test_torch_step import _adam_moments
from torch_parity import JitInit, close, configs, to_np, torch_model, tt
import torch_threads  # noqa: F401  (one torch thread a test process)


def assert_trees_equal(got, want, what=""):
    """The same nested dicts, every leaf of the same dtype, shape and value."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), what
        for k in want:
            assert_trees_equal(got[k], want[k], f"{what}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, what
    np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.fixture(scope="module")
def jax_model():
    """The tiny lrw_video model of the JAX package, its init jitted once for
    the module (the optimizer settings the tests vary leave it as it is)."""
    return JitInit(jax_build_model(configs()[0]))


def _jax_state(cfg_j, batch, model, grad_steps=2, seed=0):
    """A JAX train state whose Adam moments, step and BatchNorm statistics
    are not their initial values: ``grad_steps`` updates with random
    gradients, and random running statistics."""
    state = jax_create_train_state(cfg_j, model,
                                   {k: jnp.asarray(v) for k, v in batch.items()})
    rng = np.random.RandomState(seed)
    apply = jax.jit(lambda st, g: st.apply_gradients(grads=g))   # eager optax is slow
    for _ in range(grad_steps):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32) * 0.1), state.params)
        state = apply(state, grads)
    stats = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.uniform(0.5, 1.5, s.shape).astype(np.float32)),
        state.batch_stats)
    return state.replace(batch_stats=stats)


def test_msgpack_matches_flax_bytes(jax_model):
    """Every leaf type flax writes, nested maps in and out of key order, an
    empty map, sizes past each header's short form; and a JAX train-state
    payload."""
    rng = np.random.RandomState(0)
    tree = {"params": {"b": {"kernel": rng.randn(3, 4).astype(np.float32),
                             "bias": np.zeros(4, np.float32)},
                       "a": rng.randint(0, 5, (2,)).astype(np.int32)},
            "step": np.asarray(7, np.int32), "n": 7, "neg": -3, "big": 2 ** 40,
            "negbig": -2 ** 33, "i8": -100, "i16": -40000, "u16": 40000, "f": 1.5,
            "t": True, "fa": False, "none": None, "s": "x" * 40, "long": "y" * 300,
            "bytes": b"\x00\x01" * 200, "sc": np.float32(2.5), "i64": np.int64(-5),
            "u8": np.arange(300, dtype=np.uint8), "bool": np.array([True, False]),
            "f16": np.ones((2, 2), np.float16), "u32": np.uint32(5), "e": {},
            "many": {str(i): i * 1000 for i in range(40)},
            "rng": np.array([0, 42], np.uint32), "empty": np.zeros((0, 3), np.float64),
            "transposed": rng.randn(3, 4).astype(np.float32).T}
    blob = flax.serialization.msgpack_serialize(tree)
    assert tmsgpack.dumps(tree) == blob
    assert_trees_equal(tmsgpack.loads(blob), flax.serialization.msgpack_restore(blob))
    cfg_j, cfg_t = configs()
    payload = jckpt._state_payload(_jax_state(cfg_j, word_batch(cfg_t), jax_model,
                                              grad_steps=1))
    payload = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(payload))
    blob = flax.serialization.msgpack_serialize(payload)
    assert tmsgpack.dumps(payload) == blob
    assert_trees_equal(tmsgpack.loads(blob), flax.serialization.msgpack_restore(blob))
    with pytest.raises(ValueError, match="truncated"):
        tmsgpack.loads(blob[:-3])
    with pytest.raises(TypeError):
        tmsgpack.dumps({"x": (1, 2)})


@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clipped", "unclipped"])
def test_jax_checkpoint_restores_into_the_port(tmp_path, clip, jax_model):
    """Params, batch_stats, Adam mu/nu and step bitwise after the bridge;
    the generators re-seeded from the config (the file has no torch
    generator state)."""
    cfg_j, cfg_t = configs(**{"optim.clip_norm": clip})
    batch = word_batch(cfg_t)
    state_j = _jax_state(cfg_j, batch, jax_model)
    path = jckpt.save_train_state(str(tmp_path), state_j, int(state_j.step))
    params0, stats0 = to_np(state_j.params), to_np(state_j.batch_stats)
    model = torch_model(cfg_t, params0, stats0)
    state = create_train_state(cfg_t, model, batch, device="cpu")
    state.mixup_gen.manual_seed(99)
    torch.rand(3, generator=state.dropout_gen)
    tckpt.restore_train_state(path, state)
    assert state.step == 2
    params, stats = to_flax(model.state_dict())
    assert_trees_equal(params, to_np(state_j.params), "params")
    assert_trees_equal(stats, to_np(state_j.batch_stats), "batch_stats")
    mu_j, nu_j = _adam_moments(state_j.opt_state)
    assert_trees_equal(to_flax(dict(zip(state.names, state.mu)))[0], to_np(mu_j), "mu")
    assert_trees_equal(to_flax(dict(zip(state.names, state.nu)))[0], to_np(nu_j), "nu")
    for gen, seed in ((state.mixup_gen, cfg_t.train.mixup_seed),
                      (state.dropout_gen, cfg_t.train.dropout_seed)):
        assert torch.equal(gen.get_state(), torch.Generator().manual_seed(seed).get_state())


@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clipped", "unclipped"])
def test_port_checkpoint_restores_into_jax(tmp_path, clip, jax_model):
    """A port checkpoint after one train step: JAX's restore_train_state
    takes it (optax's layout: count, lr, Adam's count/mu/nu), and both
    packages' eval metrics on it agree (f32, 1e-5 relative); the port
    restores its own generators' states."""
    cfg_j, cfg_t = configs(**{"optim.clip_norm": clip})
    batch = word_batch(cfg_t)
    state_j = _jax_state(cfg_j, batch, jax_model, grad_steps=0)
    model = torch_model(cfg_t, to_np(state_j.params), to_np(state_j.batch_stats))
    state = create_train_state(cfg_t, model, batch, device="cpu")
    state, _ = build_train_step()(state, {k: tt(v) for k, v in batch.items()})
    path = tckpt.save_train_state(str(tmp_path), state, state.step)
    assert os.path.basename(path) == "step_1.msgpack"

    restored = jckpt.restore_train_state(path, state_j)
    assert int(restored.step) == 1
    opt = flax.serialization.to_state_dict(restored.opt_state)
    assert int(opt["count"]) == 1
    assert float(opt["hyperparams"]["lr"]) == np.float32(state.schedule(0))
    params, stats = to_flax(model.state_dict())
    assert_trees_equal(flax.core.unfreeze(restored.params), params, "params")
    mu_j, nu_j = _adam_moments(restored.opt_state)
    assert_trees_equal(to_np(mu_j), to_flax(dict(zip(state.names, state.mu)))[0], "mu")
    assert_trees_equal(to_np(nu_j), to_flax(dict(zip(state.names, state.nu)))[0], "nu")

    eval_j = jax_build_eval_step()(restored, jax_eval_transform(cfg_j.data)(
        {k: jnp.asarray(v) for k, v in batch.items()}))
    eval_t = build_eval_step()(state, build_eval_transform(cfg_t.data)(
        {k: tt(v) for k, v in batch.items()}))
    assert set(eval_t) == set(eval_j)
    for k in eval_j:
        close(eval_t[k], eval_j[k], 1e-5, 1e-6, k)

    # the port's own file brings its generators back
    mixup, dropout = state.mixup_gen.get_state(), state.dropout_gen.get_state()
    state.mixup_gen.manual_seed(5)
    state.dropout_gen.manual_seed(6)
    tckpt.restore_train_state(path, state)
    assert torch.equal(state.mixup_gen.get_state(), mixup)
    assert torch.equal(state.dropout_gen.get_state(), dropout)


def test_save_msgpack_is_atomic(tmp_path):
    path = str(tmp_path / "x.msgpack")
    tckpt.save_msgpack(path, {"a": np.arange(5), "t": torch.ones(2)})
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    got = tckpt.load_msgpack(path)
    np.testing.assert_array_equal(got["a"], np.arange(5))
    np.testing.assert_array_equal(got["t"], np.ones(2, np.float32))
    assert jckpt.load_msgpack(path)["a"].tolist() == [0, 1, 2, 3, 4]


def test_async_checkpointer_roundtrip(tmp_path, jax_model):
    """The JAX test's contract: the host copy is taken in save(), so a
    change to the state afterwards does not reach the file; keep-N pruning;
    the async best file."""
    cfg_j, cfg_t = configs()
    batch = word_batch(cfg_t)
    state = create_train_state(cfg_t, torch_model(cfg_t, *_jax_vars(cfg_j, batch, jax_model)),
                               batch, device="cpu")
    saver = tckpt.AsyncCheckpointer()
    path = saver.save(str(tmp_path), state, step=7, keep=2)
    first = to_flax(state.model.state_dict())[0]
    with torch.no_grad():
        for p in state.params:
            p.add_(1.0)
    saver.wait()
    assert int(tckpt.load_msgpack(path)["step"]) == 0
    assert_trees_equal(tckpt.load_msgpack(path)["params"], first, "params")
    for s in (9, 10, 11):
        saver.save(str(tmp_path), state, step=s, keep=2)
    saver.wait()
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".msgpack"))
    assert files == ["step_10.msgpack", "step_11.msgpack"]
    assert tckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "step_11.msgpack")
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None
    saver.save_msgpack(str(tmp_path / "best.msgpack"), {"b": np.eye(2), "step": 3})
    saver.close()
    best = tckpt.load_msgpack(str(tmp_path / "best.msgpack"))
    np.testing.assert_array_equal(best["b"], np.eye(2))
    assert best["step"] == 3


def _jax_vars(cfg_j, batch, model):
    state = jax_create_train_state(cfg_j, model, {k: jnp.asarray(v) for k, v in batch.items()})
    return to_np(state.params), to_np(state.batch_stats)


def test_prune_keeps_the_newest(tmp_path):
    for s in (1, 2, 10, 3):
        (tmp_path / f"step_{s}.msgpack").write_bytes(b"\x80")
    (tmp_path / "best.msgpack").write_bytes(b"\x80")
    tckpt._prune(str(tmp_path), 2)
    assert sorted(os.listdir(tmp_path)) == ["best.msgpack", "step_10.msgpack",
                                            "step_3.msgpack"]


def test_partial_load_and_rename_match_jax():
    params = {"a": {"kernel": np.zeros((2, 2))}, "b": {"bias": np.zeros(3)}}
    pre = {"a_old": {"kernel": np.ones((2, 2))}, "b": {"bias": np.ones(3)},
           "c": {"x": np.ones(1)}, "d": {"bias": np.ones(4)}}
    for mod in (jckpt, tckpt):
        merged, n = mod.partial_load(params, pre, rename={"a_old": "a"}, verbose=False)
        assert n == 2
        np.testing.assert_allclose(merged["a"]["kernel"], 1.0)
        np.testing.assert_allclose(merged["b"]["bias"], 1.0)


def test_load_ssl_pretrained_and_load_params(tmp_path, jax_model):
    """The SSL landmark warm start ({"student": {"encoder": ...}}) merges
    the student encoder by intersection, as the JAX package does; and
    load_params merges a flax tree into a port model."""
    params = {"encoder": {"w": {"kernel": np.zeros((2, 3), np.float32)}},
              "head": {"bias": np.zeros(2, np.float32)}}
    path = str(tmp_path / "ssl.msgpack")
    jckpt.save_msgpack(path, {"student": {"encoder": {"w": {"kernel": np.ones((2, 3),
                                                                              np.float32)}}}})
    for mod in (jckpt, tckpt):
        merged = mod.load_ssl_pretrained(path, params)
        np.testing.assert_array_equal(merged["encoder"]["w"]["kernel"], 1.0)
        np.testing.assert_array_equal(merged["head"]["bias"], 0.0)
    cfg_j, cfg_t = configs()
    batch = word_batch(cfg_t)
    p, s = _jax_vars(cfg_j, batch, jax_model)
    model = torch_model(cfg_t, p, s)
    want = jax.tree_util.tree_map(lambda a: a + 1.0, p)
    assert tckpt.load_params(model, {"encoder": want["encoder"], "extra": {"bias": 0.0}}) \
        == len(jax.tree_util.tree_leaves(want["encoder"]))
    got = to_flax(model.state_dict())
    assert_trees_equal(got[0]["encoder"], want["encoder"], "encoder")
    assert_trees_equal(got[0]["frontend"], p["frontend"], "frontend")
    assert_trees_equal(got[1], s, "batch_stats")

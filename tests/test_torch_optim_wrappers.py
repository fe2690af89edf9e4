"""PyTorch port: the optimizer wrappers (``optim.accum_steps``: optax
``MultiSteps``; ``optim.skip_nonfinite``: ``apply_if_finite`` with at most 10
errors in a row) against the JAX package's optax chain, on the CPU. The same
numpy-seeded gradients go through both packages' updates; after every step
the whole optimizer state (counts, rate, Adam's moments, the running mean
of the gradients, the non-finite counters) and the parameters agree at
rtol 2e-5, atol 2e-6 (``tests/test_train_driver.py``'s accumulation
tolerance), NaN where optax holds NaN. Checkpoints with the wrapped states
go both ways, bitwise. The port's train step accumulates as one full-batch
step, and moves the BatchNorm statistics on every mini-step."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.engine import create_train_state as jax_create_train_state
from syncvsr_tpu.engine.state import current_lr
from syncvsr_tpu.models import build_model as jax_build_model
from syncvsr_tpu.utils import checkpoint as jckpt
from syncvsr_tpu_torch.data.synthetic import word_batch
from syncvsr_tpu_torch.engine import build_train_step, create_train_state
from syncvsr_tpu_torch.engine.state import apply_gradients
from syncvsr_tpu_torch.utils import checkpoint as tckpt
from syncvsr_tpu_torch.utils import msgpack as tmsgpack
from syncvsr_tpu_torch.utils.bridge import from_flax, to_flax
from test_torch_checkpoint import assert_trees_equal
from torch_parity import JitInit, configs, landmark_configs, to_np, torch_model, tt
import torch_threads  # noqa: F401  (one torch thread a test process)

RTOL, ATOL = 2e-5, 2e-6
SMALL = {"model.frontend.input_features": 12, "optim.total_steps": 40,
         "optim.warmup_steps": 3}


@pytest.fixture(scope="module")
def jax_model():
    return JitInit(jax_build_model(landmark_configs(**SMALL)[0]))


def _states(jax_model, accum, skip):
    """(JAX train state, port train state) of the tiny landmark model with
    the same weights, under ``accum`` and ``skip``."""
    over = dict(SMALL, **{"optim.accum_steps": accum, "optim.skip_nonfinite": skip})
    cfg_j, cfg_t = landmark_configs(**over)
    batch = word_batch(cfg_t, seed=0)
    state_j = jax_create_train_state(cfg_j, jax_model,
                                     {k: jnp.asarray(v) for k, v in batch.items()})
    model = torch_model(cfg_t, to_np(state_j.params), {})
    return state_j, create_train_state(cfg_t, model, batch, device="cpu")


_apply = jax.jit(lambda st, g: st.apply_gradients(grads=g))


def _grads(state_j, rng, bad):
    """Random gradients in flax layout; NaN in one leaf's first entry when
    ``bad``."""
    grads = to_np(jax.tree_util.tree_map(
        lambda p: rng.randn(*p.shape).astype(np.float32) * 0.1, state_j.params))
    if bad:
        leaf = grads["encoder"]["block_0"]["attn"]["wq"]["kernel"]
        leaf.reshape(-1)[0] = np.nan
    return grads


def _step_both(state_j, state_t, grads):
    state_j = _apply(state_j, jax.tree_util.tree_map(jnp.asarray, grads))
    flat = from_flax(grads)
    lr = apply_gradients(state_t, [torch.from_numpy(np.array(flat[n])) for n in state_t.names])
    return state_j, lr


def _assert_close_trees(got, want, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_close_trees(got[k], want[k], f"{what}/{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, what
    if g.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, equal_nan=True, err_msg=what)


def _assert_states_close(state_j, state_t, lr, what):
    assert state_t.step == int(state_j.step), what
    # optax's schedule inside the jitted update rounds ~1 ulp off the eager
    # one (XLA fuses it), as the rate in opt_state below
    np.testing.assert_allclose(lr, np.asarray(current_lr(state_j)), rtol=RTOL, err_msg=what)
    _assert_close_trees(tckpt._opt_state(state_t),
                        to_np(flax.serialization.to_state_dict(state_j.opt_state)),
                        f"{what} opt_state")
    _assert_close_trees(to_flax(state_t.model.state_dict())[0], to_np(state_j.params),
                        f"{what} params")


# (accum_steps, skip_nonfinite, the steps whose gradient holds a NaN, steps)
CASES = {
    "accum2": (2, False, (), 4),
    "skip": (1, True, (), 4),
    "accum2_skip": (2, True, (), 4),
    # optax adds every mini-step's inner update times 0: NaN already at the
    # mini-step whose gradient is NaN
    "accum2_one_nan": (2, False, (3,), 5),
    "skip_one_nan": (1, True, (2,), 5),
    # eleven in a row: the tenth is still skipped, the eleventh applied
    "skip_eleven_nan": (1, True, tuple(range(2, 13)), 14),
    # a non-finite mini-batch poisons optax's running mean for good (it is
    # reset by a multiplication by 0): every later inner update is skipped,
    # until the eleventh in a row, whose 0-times update on the mini-step
    # before it already writes NaN
    "accum2_skip_one_nan": (2, True, (3,), 8),
    "accum2_skip_eleven_nan": (2, True, (3,), 26),
}


@pytest.mark.parametrize("case", list(CASES))
def test_wrapped_updates_match_optax(case, jax_model):
    accum, skip, bad, n = CASES[case]
    state_j, state_t = _states(jax_model, accum, skip)
    rng = np.random.RandomState(7)
    applied = 0
    for i in range(1, n + 1):
        state_j, lr = _step_both(state_j, state_t, _grads(state_j, rng, i in bad))
        _assert_states_close(state_j, state_t, lr, f"{case} step {i}")
        applied = state_t.count
    if case == "skip_eleven_nan":
        assert state_t.total_notfinite == 11 and state_t.last_finite
        assert any(bool(torch.isnan(p).any()) for p in state_t.params)
    if case in ("accum2_skip_eleven_nan", "accum2_one_nan"):
        assert all(bool(torch.isnan(p).all()) for p in state_t.params)
    if case == "accum2_skip_one_nan":
        assert not any(bool(torch.isnan(p).any()) for p in state_t.params)
        assert state_t.notfinite_count == 3 and state_t.count == 1
    if case == "accum2":
        assert applied == 2 and state_t.gradient_step == 2 and state_t.mini_step == 0


@pytest.mark.parametrize("accum, skip", [(2, True), (2, False), (1, True)],
                         ids=["accum2_skip", "accum2", "skip"])
def test_wrapped_checkpoints_both_ways(tmp_path, accum, skip, jax_model):
    """A JAX checkpoint with the wrapped states restores into the port, and
    a port checkpoint into JAX, each bitwise; the port's payload is flax's
    bytes."""
    state_j, state_t = _states(jax_model, accum, skip)
    rng = np.random.RandomState(3)
    for i in range(3):     # mid-accumulation, one NaN mini-batch
        state_j, _ = _step_both(state_j, state_t, _grads(state_j, rng, skip and i == 0))

    path = jckpt.save_train_state(str(tmp_path / "jax"), state_j, int(state_j.step))
    _, fresh = _states(jax_model, accum, skip)
    tckpt.restore_train_state(path, fresh)
    want = to_np(flax.serialization.to_state_dict(state_j.opt_state))
    assert_trees_equal(tckpt._opt_state(fresh), want, "JAX -> port opt_state")
    assert fresh.step == int(state_j.step) == 3
    assert_trees_equal(to_flax(fresh.model.state_dict())[0], to_np(state_j.params),
                       "JAX -> port params")

    path = tckpt.save_train_state(str(tmp_path / "port"), state_t, state_t.step)
    template, _ = _states(jax_model, accum, skip)
    restored = jckpt.restore_train_state(path, template)
    assert int(restored.step) == 3
    assert_trees_equal(to_np(flax.serialization.to_state_dict(restored.opt_state)),
                       tckpt._opt_state(state_t), "port -> JAX opt_state")
    payload = tckpt.state_payload(state_t)
    assert tmsgpack.dumps(payload) == flax.serialization.msgpack_serialize(payload)

    # a file without the configured wrappers is refused, naming them
    _, other = _states(jax_model, 1, not skip) if accum > 1 else _states(jax_model, 2, skip)
    with pytest.raises(KeyError, match="accum_steps|skip_nonfinite"):
        tckpt.restore_train_state(path, other)


def test_accumulated_step_equals_full_batch_step():
    """optim.accum_steps=2 over two half batches == one full-batch step (the
    JAX package's test_grad_accum_equivalence, in the port): MultiSteps
    averages the mini-batch gradients and every loss is a mean."""
    base = dict(SMALL, **{"data.batch_size": 16, "optim.total_steps": 100,
                          "optim.warmup_steps": 1})
    _, cfg1 = landmark_configs(**base)
    _, cfg2 = landmark_configs(**dict(base, **{"optim.accum_steps": 2}))
    full = word_batch(cfg1, 16, seed=0)
    states = []
    for cfg, batches in ((cfg1, [full]),
                         (cfg2, [{k: v[:8] for k, v in full.items()},
                                 {k: v[8:] for k, v in full.items()}])):
        from syncvsr_tpu_torch.models import build_model

        state = create_train_state(cfg, build_model(cfg, device="cpu"), full, device="cpu")
        step = build_train_step()
        for b in batches:
            state, m = step(state, {k: tt(v) for k, v in b.items()})
        states.append(state)
    s1, s2 = states
    assert s1.count == s2.count == 1 and s2.step == 2
    for a, b in zip(s1.params, s2.params):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=RTOL, atol=ATOL)


def test_batchnorm_statistics_move_every_mini_step():
    """Under accumulation the parameters move once every k mini-steps, the
    BatchNorm running statistics on every one (the JAX step takes them from
    each mini-step's mutation); learning_rate is the last applied rate."""
    from syncvsr_tpu_torch.models import build_model
    from torch_parity import uint8_batch

    _, cfg = configs(**{"optim.accum_steps": 2})
    batch = {k: tt(v) for k, v in uint8_batch(cfg).items()}
    state = create_train_state(cfg, build_model(cfg, device="cpu"), batch, device="cpu")
    step = build_train_step()
    stats = lambda: [b.clone() for n, b in state.model.named_buffers() if "running" in n]
    params0, stats0 = [p.detach().clone() for p in state.params], stats()
    state, m1 = step(state, batch)
    stats1 = stats()
    assert all(torch.equal(a, b) for a, b in zip(params0, state.params))
    assert not any(torch.equal(a, b) for a, b in zip(stats0, stats1))
    assert float(m1["learning_rate"]) == np.float32(state.schedule(0))
    state, m2 = step(state, batch)
    assert not any(torch.equal(a, b) for a, b in zip(stats1, stats()))
    assert not all(torch.equal(a, b) for a, b in zip(params0, state.params))
    assert (state.step, state.count, state.mini_step) == (2, 1, 0)
    assert float(m2["learning_rate"]) == np.float32(state.schedule(0))

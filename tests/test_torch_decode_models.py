"""The port's incremental decoder (``TransformerDecoder.step``,
``precompute_memory``, ``grow_cache``) and language models
(``models/lm.py``) against the JAX package's, with the same weights through
the bridge: step by step to 1e-5 (JAX's steps jitted), and the port's
steps against its own teacher-forced forward."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.models import decoder as jdec
from syncvsr_tpu.models import lm as jlm
from syncvsr_tpu_torch.models import decoder as tdec
from syncvsr_tpu_torch.models import lm as tlm
from syncvsr_tpu_torch.utils.bridge import from_flax, load_flax, to_flax
from tests.torch_parity import close, to_np, tt
import torch_threads  # noqa: F401  (one torch thread a test process)

VOCAB, DIM, HEADS, HIDDEN, LAYERS = 11, 32, 2, 24, 2


@pytest.fixture(scope="module")
def decoders():
    jm = jdec.TransformerDecoder(vocab=VOCAB, layers=LAYERS, dim=DIM, heads=HEADS,
                                 hidden=HIDDEN, dropout=0.0)
    ys = jnp.zeros((2, 3), jnp.int32)
    mem = jnp.zeros((2, 5, DIM))
    params = to_np(jax.jit(lambda: jm.init(jax.random.PRNGKey(0), ys, jnp.asarray([3, 3]),
                                           mem, None))()["params"])
    tm = tdec.TransformerDecoder(VOCAB, LAYERS, DIM, HEADS, HIDDEN, dropout=0.0)
    load_flax(tm, params)
    return jm, {"params": params}, tm


def _memory(b=2, t=7, seed=0):
    rng = np.random.RandomState(seed)
    memory = rng.randn(b, t, DIM).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([t, t - 3])[:b, None]
    return memory, mask


@pytest.mark.parametrize("shared", [True, False], ids=["mem_kv", "memory"])
def test_decoder_step_matches_jax(decoders, shared):
    """B = 2 utterances x W = 3 hypotheses, 5 steps: the port decodes the
    six rows together (each utterance's memory K/V shared by its three),
    JAX one utterance at a time, as its vmap does."""
    jm, variables, tm = decoders
    memory, mask = _memory()
    b, w, steps, cap = 2, 3, 5, 8
    rng = np.random.RandomState(1)
    ys = rng.randint(0, VOCAB, (steps, b * w)).astype(np.int32)
    if shared:
        t_kv = tm.precompute_memory(tt(memory))
        t_mem, t_mask = None, tt(mask)
    else:
        t_kv = None
        t_mem = tt(np.repeat(memory, w, 0))
        t_mask = tt(np.repeat(mask, w, 0))
    t_cache = tm.init_cache(b * w, cap)
    with torch.no_grad():
        t_out = []
        for pos in range(steps):
            logp, t_cache = tm.step(tt(ys[pos]), pos, t_cache, t_mem, t_mask, mem_kv=t_kv)
            t_out.append(logp.numpy())
    step = jax.jit(functools.partial(jm.apply, method="step"))
    for u in range(b):
        rows = slice(u * w, (u + 1) * w)
        mem_u = jnp.broadcast_to(jnp.asarray(memory[u])[None], (w,) + memory[u].shape)
        mask_u = jnp.broadcast_to(jnp.asarray(mask[u])[None], (w, mask.shape[1]))
        kv = (jm.apply(variables, jnp.asarray(memory[u]), method="precompute_memory")
              if shared else None)
        cache = jm.apply(variables, w, cap, method="init_cache")
        for pos in range(steps):
            logp, cache = step(variables, jnp.asarray(ys[pos, rows]), jnp.asarray(pos),
                               cache, mem_u, mask_u, mem_kv=kv)
            close(t_out[pos][rows], logp, 1e-5, 1e-5, f"utterance {u} step {pos}")
        for k in ("k", "v"):
            close(t_cache[k][rows], cache[k], 1e-5, 1e-5, f"cache {k}")


def test_decoder_step_matches_teacher_forced(decoders):
    _, _, tm = decoders
    memory, mask = _memory(seed=2)
    ys = np.random.RandomState(3).randint(0, VOCAB, (2, 6))
    with torch.no_grad():
        want = torch.log_softmax(tm(tt(ys), torch.tensor([6, 6]), tt(memory), tt(mask)), -1)
        kv = tm.precompute_memory(tt(memory))
        cache = tm.init_cache(2, 6)
        got = []
        for pos in range(6):
            logp, cache = tm.step(tt(ys[:, pos]), pos, cache, None, tt(mask), mem_kv=kv)
            got.append(logp)
    close(torch.stack(got, 1), want.numpy(), 1e-5, 1e-5)


@pytest.mark.parametrize("new_len", [5, 6, 9])
def test_grow_cache_exact(new_len):
    rng = np.random.RandomState(4)
    cache = {k: rng.randn(2, 3, 5, 2, 4).astype(np.float32) for k in ("k", "v")}
    want = jdec.grow_cache({k: jnp.asarray(v) for k, v in cache.items()}, new_len)
    got = tdec.grow_cache({k: tt(v) for k, v in cache.items()}, new_len)
    for k in cache:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _lm_pair(kind, **kw):
    ys = jnp.zeros((1, 4), jnp.int32)
    if kind == "rnn":
        jm = jlm.RNNLM(vocab=VOCAB, layers=2, dim=16, embed_dim=8)
        tm = tlm.RNNLM(VOCAB, layers=2, dim=16, embed_dim=8)
    else:
        jm = jlm.TransformerLM(vocab=VOCAB, layers=2, dim=16, heads=2, hidden=32,
                               embed_dim=8, **kw)
        tm = tlm.TransformerLM(VOCAB, layers=2, dim=16, heads=2, hidden=32, embed_dim=8, **kw)
    params = to_np(jax.jit(lambda: jm.init(jax.random.PRNGKey(5), ys))()["params"])
    load_flax(tm, params)
    return jm, {"params": params}, tm


LMS = [("transformer", {}), ("transformer", {"pos_enc": "sinusoidal"}), ("rnn", {})]


@pytest.mark.parametrize("kind,kw", LMS, ids=["transformer", "sinusoidal", "rnn"])
def test_lm_matches_jax(kind, kw):
    """Teacher-forced forward and 5 steps, to 1e-5 (the sinusoidal
    TransformerLM steps at position 0 in both packages)."""
    jm, variables, tm = _lm_pair(kind, **kw)
    ys = np.random.RandomState(6).randint(0, VOCAB, (3, 5)).astype(np.int32)
    with torch.no_grad():
        close(tm(tt(ys)), jm.apply(variables, jnp.asarray(ys)), 1e-5, 1e-5, "forward")
        t_state = tm.init_cache(3, 8) if kind != "rnn" else tm.init_cache(3)
        j_state = jm.apply(variables, 3, *(() if kind == "rnn" else (8,)),
                           method="init_cache")
        step = jax.jit(functools.partial(jm.apply, method="step"))
        for pos in range(5):
            t_logp, t_state = tm.step(tt(ys[:, pos]), pos, t_state)
            j_logp, j_state = step(variables, jnp.asarray(ys[:, pos]), jnp.asarray(pos),
                                   j_state)
            close(t_logp, j_logp, 1e-5, 1e-5, f"step {pos}")
    if kind == "transformer" and not kw:
        # the published shape: steps equal the teacher-forced forward
        with torch.no_grad():
            want = torch.log_softmax(tm(tt(ys)), -1)
            cache = tm.init_cache(3, 5)
            got = torch.stack([tm.step(tt(ys[:, p]), p, cache)[0] for p in range(5)], 1)
        close(got, want.numpy(), 1e-5, 1e-5)


@pytest.mark.parametrize("kind,kw", LMS[::2], ids=["transformer", "rnn"])
def test_lm_bridge_round_trip(kind, kw):
    _, variables, tm = _lm_pair(kind, **kw)
    params, stats = to_flax(tm.state_dict())
    assert stats == {}
    flat = dict(jax.tree_util.tree_flatten_with_path(variables["params"])[0])
    back = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert flat.keys() == back.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    assert from_flax(params).keys() == tm.state_dict().keys()

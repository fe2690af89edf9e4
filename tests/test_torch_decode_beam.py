"""The port's CTC prefix scorer and batched beam search
(``syncvsr_tpu_torch/decode/``) against the JAX package's, on the
posteriors of ``tests/test_beam_search.py`` (random CTC log-probs and a
Markov-table decoder): equal tokens, lengths and alive/finished pools,
scores to 1e-4 relative.

JAX's search returns only the best hypothesis; its pools are read from the
last carry of its while-loop (``jax.lax.while_loop`` wrapped for the test,
the search run without ``jit``)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.decode.ctc_prefix import CTCPrefixScorer as JaxScorer
from syncvsr_tpu.models import decoder as jdec
from syncvsr_tpu_torch.decode.ctc_prefix import LOGZERO, CTCPrefixScorer
from syncvsr_tpu_torch.models import decoder as tdec
from tests.torch_parity import tt
import torch_threads  # noqa: F401  (one torch thread a test process)

# the modules (each package's ``decode`` exports a function of the same name)
jbs = importlib.import_module("syncvsr_tpu.decode.beam_search")
tbs = importlib.import_module("syncvsr_tpu_torch.decode.beam_search")


def _log_softmax(x):
    return np.asarray(jax.nn.log_softmax(jnp.asarray(x), axis=-1))


def _posteriors(seed, vocab, t_max, scale=2.0, b=1):
    """(CTC log-probs [b, T, V], decoder table [V, V]) as the JAX tests
    draw them (the first utterance's), further utterances after."""
    rng = np.random.RandomState(seed)
    ctc = _log_softmax(rng.randn(t_max, vocab).astype(np.float32) * 2)
    table = _log_softmax(rng.randn(vocab, vocab).astype(np.float32) * scale)
    more = [_log_softmax(rng.randn(t_max, vocab).astype(np.float32) * 2) for _ in range(b - 1)]
    return np.stack([ctc] + more), table


def _close_scores(got, want, what):
    """LOGZERO at the same places; the other entries to 1e-4 relative."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got <= 0.5 * LOGZERO, want <= 0.5 * LOGZERO, err_msg=what)
    real = want > 0.5 * LOGZERO
    np.testing.assert_allclose(got[real], want[real], rtol=1e-4, atol=1e-5, err_msg=what)


# ---- (d) the prefix scorer ---------------------------------------------------

def test_prefix_scorer_matches_jax():
    """Two utterances of 9 and 6 valid frames, W = 3, P = 4: five steps of
    score_partial and select_state on candidates with blank, eos and the
    last token among them, and winners outside their candidates."""
    b, t, v, w, p = 2, 9, 7, 3, 4
    blank, eos = 0, v - 1
    rng = np.random.RandomState(0)
    lp = _log_softmax(rng.randn(b, t, v).astype(np.float32) * 2)
    lengths = np.array([9, 6], np.int32)
    port = CTCPrefixScorer(tt(lp), tt(lengths), blank, eos)
    t_state = port.init_state(w)
    jax_sc = [JaxScorer(jnp.asarray(lp[u]), jnp.asarray(lengths[u]), blank, eos)
              for u in range(b)]
    j_states = [s.init_state(w) for s in jax_sc]
    last = np.full((b, w), eos, np.int64)
    for i in range(5):
        part = np.stack([[rng.permutation(v)[:p] for _ in range(w)] for _ in range(b)])
        part[0, 0, 0] = last[0, 0]                          # a repeat of the last token
        hyp = rng.randint(0, w, (b, w))
        pick = part[np.arange(b)[:, None], hyp, rng.randint(0, p, (b, w))]
        # most winners among their hypothesis' candidates, some outside
        tok = np.where(rng.rand(b, w) < 0.8, pick, rng.randint(0, v, (b, w)))
        flat_hyp = (hyp + np.arange(b)[:, None] * w).reshape(-1)
        t_psi, t_rnew, _ = port.score_partial(t_state, tt(last.reshape(-1)),
                                              tt(part.reshape(b * w, p)), i)
        t_state = port.select_state(t_state, t_rnew, t_psi, tt(part.reshape(b * w, p)),
                                    tt(flat_hyp), tt(tok.reshape(-1)))
        for u in range(b):
            rows = slice(u * w, (u + 1) * w)
            j_psi, j_rnew, _ = jax_sc[u].score_partial(
                j_states[u], jnp.asarray(last[u]), jnp.asarray(part[u]), i)
            _close_scores(t_psi[rows].numpy(), j_psi, f"step {i} log_psi {u}")
            _close_scores(t_rnew[:, :, rows].permute(2, 0, 1, 3).numpy(), j_rnew,
                          f"step {i} r_new {u}")
            j_states[u] = jax_sc[u].select_state(j_states[u], j_rnew, j_psi,
                                                 jnp.asarray(part[u]), jnp.asarray(hyp[u]),
                                                 jnp.asarray(tok[u]))
            _close_scores(t_state.s[rows].numpy(), j_states[u].s, f"step {i} s {u}")
            _close_scores(t_state.r[:, :, rows].permute(2, 0, 1).numpy(), j_states[u].r,
                          f"step {i} r {u}")
        last = tok


# ---- (e) the beam search -----------------------------------------------------

def _markov(table):
    def jax_step(last, pos, cache, mem, mem_mask):
        return jnp.asarray(table)[last], cache

    def port_step(last, pos, cache):
        return tt(table)[last], cache

    return jax_step, port_step


def _dummy_caches(staged):
    """A decoder cache of the stacked layout, so grow_cache stages it."""
    def jax_init(w, l):
        return {"k": jnp.zeros((w, 1, l, 1, 1)), "v": jnp.zeros((w, 1, l, 1, 1))}

    def port_init(n, l):
        return {"k": torch.zeros(n, 1, l, 1, 1), "v": torch.zeros(n, 1, l, 1, 1)}

    return (jax_init, port_init, jdec.grow_cache if staged else None,
            tdec.grow_cache if staged else None)


@pytest.fixture
def jax_pools(monkeypatch):
    """Runs JAX's beam_search un-jitted and returns (result, last carry's state)."""
    carries = []
    while_loop = jax.lax.while_loop

    def recording(cond, body, init):
        out = while_loop(cond, body, init)
        carries.append(out)
        return out

    monkeypatch.setattr(jax.lax, "while_loop", recording)

    def run(*args, **kwargs):
        carries.clear()
        out = jbs.beam_search(*args, **kwargs)
        return out, carries[-1][1]

    return run


def _compare(jax_run, ctc, lengths, table, vocab, cfg, max_len, staged=False, early=True,
             lm=None):
    """The port's search over all utterances at once against JAX's over
    each; returns the port's step count."""
    jax_step, port_step = _markov(table)
    j_init, p_init, j_grow, p_grow = _dummy_caches(staged)
    j_lm = p_lm = {}
    if lm is not None:
        j_lm = {"lm_step": lm[0], "lm_init": lm[1], "grow_lm_state": lm[2]}
        p_lm = {"lm_step": lm[3], "lm_init": lm[4], "grow_lm_state": lm[5]}
    with torch.no_grad():
        state, steps = tbs.search(port_step, p_init, tt(lengths), tt(ctc), vocab, cfg,
                                  max_len=max_len, early_exit=early, grow_cache=p_grow, **p_lm)
        toks, n, score = tbs.best_hypothesis(state)
    for u in range(ctc.shape[0]):
        (j_toks, j_n, j_score), j_state = jax_run(
            jax_step, j_init, jnp.zeros((ctc.shape[1], 4)), jnp.asarray(lengths[u]),
            jnp.asarray(ctc[u]), vocab, cfg, max_len=max_len, early_exit=early,
            grow_cache=j_grow, **j_lm)
        what = f"utterance {u}"
        assert int(n[u]) == int(j_n), what
        np.testing.assert_array_equal(toks[u].numpy(), np.asarray(j_toks), err_msg=what)
        np.testing.assert_allclose(float(score[u]), float(j_score), rtol=1e-4, err_msg=what)
        for f in ("alive_seq", "fin_seq", "fin_len", "alive_last"):
            np.testing.assert_array_equal(getattr(state, f)[u].numpy(),
                                          np.asarray(getattr(j_state, f)), err_msg=f"{what} {f}")
        for f in ("alive_score", "fin_score"):
            _close_scores(getattr(state, f)[u].numpy(), getattr(j_state, f), f"{what} {f}")
    return steps, state


def test_beam_pools_match_jax_with_logzero_ties(jax_pools, monkeypatch):
    """The exhaustive test's posteriors at beam 25 over 5 tokens: most of
    the beam is tied at LOGZERO. ``torch.topk`` in place of the stable
    top-k picks other rows there, and the pools differ from JAX's."""
    ctc, table = _posteriors(3, 5, 6)
    cfg = tbs.BeamSearchConfig(beam_size=25, ctc_weight=0.3)
    args = (ctc, np.array([6], np.int32), table, 5, cfg, 4)
    _compare(jax_pools, *args)
    monkeypatch.setattr(tbs, "stable_topk", lambda x, k: torch.topk(x, k))
    with pytest.raises(AssertionError):
        _compare(jax_pools, *args)


def test_early_exit_matches_full_loop(jax_pools):
    """The JAX early-exit test's posteriors, with two more utterances of
    other lengths: early exit fires (fewer steps), and the answers equal
    the full loop's and JAX's."""
    ctc, table = _posteriors(11, 6, 12, scale=3.0, b=3)
    lengths = np.array([12, 9, 5], np.int32)
    cfg = tbs.BeamSearchConfig(beam_size=8, ctc_weight=0.3)
    steps_e, early = _compare(jax_pools, ctc, lengths, table, 6, cfg, 12, early=True)
    steps_f, full = _compare(jax_pools, ctc, lengths, table, 6, cfg, 12, early=False)
    assert steps_e < steps_f == 12
    for a, b in zip(tbs.best_hypothesis(early), tbs.best_hypothesis(full)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("maxlenratio,minlenratio", [(0.99, 0.0), (0.34, 0.0), (0.0, 0.5),
                                                     (0.5, 0.25)])
def test_length_ratio_knobs_match_jax(jax_pools, maxlenratio, minlenratio):
    ctc, table = _posteriors(3, 5, 6, b=2)
    cfg = tbs.BeamSearchConfig(beam_size=25, ctc_weight=0.3, maxlenratio=maxlenratio,
                               minlenratio=minlenratio)
    _compare(jax_pools, ctc, np.array([6, 4], np.int32), table, 5, cfg, 4)

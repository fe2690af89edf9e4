"""The port's batched beam search against the JAX package's across the
staged cache growth (64 -> max_len + 2) and with shallow fusion of both
language models: equal tokens, lengths and pools, scores to 1e-4
(the comparison and its posteriors are ``test_torch_decode_beam.py``'s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.models import decoder as jdec
from syncvsr_tpu.models import lm as jlm
from syncvsr_tpu_torch.models import decoder as tdec
from syncvsr_tpu_torch.models import lm as tlm
from syncvsr_tpu_torch.utils.bridge import load_flax
from tests.test_torch_decode_beam import (  # noqa: F401  (jax_pools is a fixture)
    _compare,
    _dummy_caches,
    _markov,
    _posteriors,
    jax_pools,
    tbs,
)
from tests.torch_parity import to_np, tt
import torch_threads  # noqa: F401  (one torch thread a test process)


@pytest.mark.parametrize("early", [True, False], ids=["early_exit", "full_loop"])
def test_staged_beam_matches_jax(jax_pools, early):
    """70 frames: two stages (64, 72). Three utterances of 70, 66 and 52
    valid frames decode together; staged equals unstaged."""
    ctc, table = _posteriors(5, 6, 70, scale=3.0, b=3)
    lengths = np.array([70, 66, 52], np.int32)
    cfg = tbs.BeamSearchConfig(beam_size=4, ctc_weight=0.3)
    steps, staged = _compare(jax_pools, ctc, lengths, table, 6, cfg, 70, staged=True,
                             early=early)
    if not early:
        assert steps == 70
    with torch.no_grad():
        unstaged, _ = tbs.search(_markov(table)[1], _dummy_caches(False)[1], tt(lengths),
                                 tt(ctc), 6, cfg, max_len=70, early_exit=early)
    for f in ("fin_seq", "fin_score", "fin_len", "alive_seq", "alive_score"):
        torch.testing.assert_close(getattr(staged, f), getattr(unstaged, f), rtol=0, atol=0)



def _lm_hooks(kind, vocab):
    """(JAX lm_step, lm_init, grow, port lm_step, lm_init, grow) of a tiny
    LM with the same weights in both packages."""
    if kind == "rnn":
        jm = jlm.RNNLM(vocab=vocab, layers=2, dim=16, embed_dim=8)
        tm = tlm.RNNLM(vocab, layers=2, dim=16, embed_dim=8)
    else:
        jm = jlm.TransformerLM(vocab=vocab, layers=2, dim=16, heads=2, hidden=32, embed_dim=8)
        tm = tlm.TransformerLM(vocab, layers=2, dim=16, heads=2, hidden=32, embed_dim=8)
    params = to_np(jax.jit(lambda: jm.init(jax.random.PRNGKey(7),
                                           jnp.zeros((1, 3), jnp.int32)))()["params"])
    load_flax(tm, params)
    v = {"params": params}
    rnn = kind == "rnn"
    return (lambda y, pos, s: jm.apply(v, y, pos, s, method="step"),
            lambda w: jm.apply(v, w, method="init_cache"),
            None if rnn else jdec.grow_cache,
            tm.step,
            (lambda n, l: tm.init_cache(n)) if rnn else tm.init_cache,
            None if rnn else tdec.grow_cache)


@pytest.mark.parametrize("kind", ["transformer", "rnn"])
def test_lm_fusion_matches_jax(jax_pools, kind):
    """Shallow fusion at lm_weight 0.5 over 70 frames (staged: the
    TransformerLM's cache grows with the decoder's), two utterances."""
    ctc, table = _posteriors(13, 6, 70, scale=1.0, b=2)
    cfg = tbs.BeamSearchConfig(beam_size=4, ctc_weight=0.3, lm_weight=0.5)
    _compare(jax_pools, ctc, np.array([70, 40], np.int32), table, 6, cfg, 70,
             staged=True, lm=_lm_hooks(kind, 6))

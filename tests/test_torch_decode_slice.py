"""The decoding slice as a whole: the tiny lrs3 model with equal encoder and
decoder widths, its JAX weights bridged into the port, decoded by both
packages' entry points (``decode/api.py``) on a batch of three clips of
unequal lengths: the batched beam search with and without a TransformerLM
(equal tokens, scores to 1e-4), the single-utterance decoder (equal to the
batched row 0), greedy CTC and forced alignment (equal), and the WER of
the hypotheses through each package's text transform."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.data.tokenizer import TextTransform as JaxText
from syncvsr_tpu.decode.api import make_batched_beam_decoder as jax_batched
from syncvsr_tpu.decode.api import make_forced_aligner as jax_aligner
from syncvsr_tpu.decode.api import make_greedy_ctc_decoder as jax_greedy
from syncvsr_tpu.decode.beam_search import BeamSearchConfig as JaxBeamConfig
from syncvsr_tpu.models.lm import TransformerLM as JaxLM
from syncvsr_tpu.utils.text import WordErrorRate as JaxWER
from syncvsr_tpu_torch.data.synthetic import sentence_batch
from syncvsr_tpu_torch.data.tokenizer import TextTransform
from syncvsr_tpu_torch.decode import BeamSearchConfig
from syncvsr_tpu_torch.decode.api import (
    make_batched_beam_decoder,
    make_beam_decoder,
    make_forced_aligner,
    make_greedy_ctc_decoder,
)
from syncvsr_tpu_torch.models.lm import TransformerLM
from syncvsr_tpu_torch.utils.bridge import load_flax
from syncvsr_tpu_torch.utils.text import WordErrorRate
from tests.torch_parity import (
    jax_model_and_vars,
    sentence_decode_configs,
    to_np,
    torch_model,
    tt,
)
import torch_threads  # noqa: F401  (one torch thread a test process)

FRAMES = 12
BEAM = dict(beam_size=5, ctc_weight=0.1)
LM = dict(layers=2, dim=16, heads=2, hidden=32, embed_dim=8)


@pytest.fixture(scope="module")
def setup():
    cfg_j, cfg_t = sentence_decode_configs(**{"data.batch_size": 3})
    batch = sentence_batch(cfg_t, num_frames=FRAMES, label_len=5, seed=4)
    batch["lengths"] = np.array([FRAMES, 9, 6], np.int32)
    jm, params, stats = jax_model_and_vars(cfg_j, batch)
    # at random init both heads are near uniform and the empty hypothesis
    # wins: sharpen them and lower eos and blank (the same weights in both
    # packages), so the hypotheses hold tokens
    v = cfg_t.model.labels
    out, ctc = params["decoder"]["output"], params["ctc_head"]
    out["kernel"] = out["kernel"] * 8.0
    out["bias"] = out["bias"] - 3.0 * (np.arange(v) == v - 1)
    ctc["kernel"] = ctc["kernel"] * 4.0
    ctc["bias"] = ctc["bias"] - 2.0 * (np.arange(v) == 0)
    variables = {"params": params, "batch_stats": stats}
    tm = torch_model(cfg_t, params, stats)
    return cfg_t, batch, jm, variables, tm


def _lms(vocab):
    import jax

    jlm = JaxLM(vocab=vocab, **LM)
    lm_params = to_np(jax.jit(lambda: jlm.init(jax.random.PRNGKey(9),
                                               jnp.zeros((1, 3), jnp.int32)))()["params"])
    tlm = TransformerLM(vocab, **LM)
    load_flax(tlm, lm_params)
    return jlm, {"params": lm_params}, tlm


def _wer(text, wer, hyps, labels):
    for hyp, ref in zip(hyps, labels):
        wer.update(text.post_process(ref), text.post_process(hyp))
    return wer.wer, wer.total_edit_distance


@pytest.mark.parametrize("lm_weight", [0.0, 0.3], ids=["no_lm", "transformer_lm"])
def test_batched_beam_decoder_matches_jax(setup, lm_weight):
    cfg_t, batch, jm, variables, tm = setup
    vocab = cfg_t.model.labels
    videos, lengths = batch["videos"], batch["lengths"]
    j_lm = j_lm_vars = t_lm = None
    if lm_weight:
        j_lm, j_lm_vars, t_lm = _lms(vocab)
    j_toks, j_n, j_score = jax_batched(jm, variables, JaxBeamConfig(**BEAM, lm_weight=lm_weight),
                                       max_len=FRAMES, lm=j_lm, lm_variables=j_lm_vars)(
        jnp.asarray(videos), jnp.asarray(lengths))
    cfg = BeamSearchConfig(**BEAM, lm_weight=lm_weight)
    toks, n, score = make_batched_beam_decoder(tm, cfg, FRAMES, lm=t_lm)(tt(videos), tt(lengths))
    np.testing.assert_array_equal(n.numpy(), np.asarray(j_n))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(j_toks))
    np.testing.assert_allclose(score.numpy(), np.asarray(j_score), rtol=1e-4)
    assert toks.shape == (3, FRAMES + 1)

    # the single-utterance decoder is the batched search at B = 1
    one = make_beam_decoder(tm, cfg, FRAMES, lm=t_lm)(tt(videos[:1]), int(lengths[0]))
    np.testing.assert_array_equal(one[0].numpy(), toks[0].numpy())
    assert int(one[1]) == int(n[0])
    torch.testing.assert_close(one[2], score[0], rtol=1e-6, atol=0)

    hyps = [toks[i, :int(n[i])].numpy() for i in range(3)]
    j_hyps = [np.asarray(j_toks)[i, :int(j_n[i])] for i in range(3)]
    assert lm_weight or sum(map(len, hyps)) > 0   # the random LM favours short ones
    assert _wer(TextTransform(), WordErrorRate(), hyps, batch["labels"]) == \
        _wer(JaxText(), JaxWER(), j_hyps, batch["labels"])


def test_greedy_and_align_match_jax(setup):
    cfg_t, batch, jm, variables, tm = setup
    videos, lengths, labels = batch["videos"], batch["lengths"], batch["labels"]
    j_toks, j_lens = jax_greedy(jm, variables)(jnp.asarray(videos), jnp.asarray(lengths))
    toks, lens = make_greedy_ctc_decoder(tm)(tt(videos), tt(lengths))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(j_lens))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(j_toks))
    j_al = jax_aligner(jm, variables)(jnp.asarray(videos), jnp.asarray(lengths),
                                      jnp.asarray(labels))
    al = make_forced_aligner(tm)(tt(videos), tt(lengths), tt(labels))
    np.testing.assert_array_equal(al.numpy(), np.asarray(j_al))
    assert (al[2, 6:] == -1).all() and (al[2, :6] >= 0).all()


def test_unequal_widths_cannot_decode():
    """Encoder 32 wide, decoder 16: the JAX decoder's cross-attention
    projections fail on the 32-wide memory the hooks give it; the port's
    hooks raise a ValueError naming both widths."""
    import jax
    from flax.errors import ScopeParamShapeError

    from syncvsr_tpu.models.decoder import TransformerDecoder
    from syncvsr_tpu_torch.models import build_model
    from tests.torch_parity import sentence_configs

    jdec = TransformerDecoder(vocab=11, layers=1, dim=16, heads=2, hidden=24)
    v = jdec.init(jax.random.PRNGKey(0), jnp.zeros((1, 2), jnp.int32), jnp.asarray([2]),
                  jnp.zeros((1, 4, 16)), None)
    with pytest.raises(ScopeParamShapeError):
        jdec.apply(v, jnp.zeros((4, 32)), method="precompute_memory")
    _, cfg_t = sentence_configs()
    model = build_model(cfg_t, device="cpu")
    with pytest.raises(ValueError, match="encoder is 32 wide and the decoder 16"):
        model.decoder_precompute_memory(torch.zeros(1, 4, 32))
    with pytest.raises(ValueError, match="encoder is 32 wide and the decoder 16"):
        make_batched_beam_decoder(model, BeamSearchConfig(beam_size=2), 4)(
            torch.zeros(1, 4, 16, 16, 1), torch.tensor([4]))

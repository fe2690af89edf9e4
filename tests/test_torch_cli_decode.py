"""PyTorch port: the evaluate CLI's sentence decode modes (greedy, beam,
batched beam with and without a fused LM, forced alignment) on one
JAX-written checkpoint, by both packages, on the CPU: equal hypotheses and
alignments, scores within 1e-4 relative (the prefix scorer's scans agree
to ~1e-4, ``tests/test_torch_decode_beam.py``). The drivers' other tests
and the shared arguments and helpers are ``test_torch_cli.py``'s (the two
files are one file split in two, so that ``--dist loadfile`` can put them
on different workers)."""

import json

import jax
import jax.numpy as jnp
import pytest

from syncvsr_tpu import evaluate as jevaluate
from syncvsr_tpu.data.synthetic import sentence_batch
from syncvsr_tpu.utils import checkpoint as jckpt
from syncvsr_tpu_torch import evaluate as tevaluate
from test_torch_cli import SENT_ARGS, _hypotheses, _jax_checkpoint
import torch_threads  # noqa: F401  (one torch thread a test process)


@pytest.fixture(scope="module")
def sentence_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("sent") / "best.msgpack"
    return _jax_checkpoint(SENT_ARGS, path,
                           lambda cfg: sentence_batch(cfg, num_frames=32), seed=1)


@pytest.mark.parametrize("mode", [["decode=greedy"], ["decode=beam", "beam_size=4"],
                                  ["decode=beam_batched", "beam_size=4"], ["decode=align"]],
                         ids=["greedy", "beam", "beam_batched", "align"])
def test_sentence_decode_matches_jax(sentence_ckpt, mode, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    args = SENT_ARGS + [f"ckpt={json.dumps(sentence_ckpt)}", 'decode_pad="bucket"'] + mode
    want_sum, want = _hypotheses(jevaluate.main, args, monkeypatch, capsys)
    got_sum, got = _hypotheses(tevaluate.main, args, monkeypatch, capsys, device="cpu")
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k == "score":
                assert g[k] == pytest.approx(w[k], rel=1e-4)
            else:
                assert g[k] == w[k], k
    assert got_sum == want_sum


def test_beam_batched_lm_fusion_matches_jax(sentence_ckpt, tmp_path, monkeypatch, capsys):
    """lm_ckpt (a JAX-written TransformerLM msgpack) fused at lm_weight 0.7:
    the same hypotheses as JAX's, and other scores than without it."""
    from syncvsr_tpu.models.lm import TransformerLM

    monkeypatch.chdir(tmp_path)
    lm = TransformerLM(vocab=13, layers=1, dim=16, heads=2, hidden=32, embed_dim=8)
    params = lm.init(jax.random.PRNGKey(3), jnp.zeros((1, 4), jnp.int32))["params"]
    jckpt.save_msgpack(str(tmp_path / "lm.msgpack"), {"params": jax.device_get(params)})
    base = SENT_ARGS + [f"ckpt={json.dumps(sentence_ckpt)}", "decode=beam_batched",
                        "beam_size=4", 'decode_pad="bucket"']
    lm_args = [f"lm_ckpt={json.dumps(str(tmp_path / 'lm.msgpack'))}", "lm_weight=0.7",
               "lm_layers=1", "lm_dim=16", "lm_heads=2", "lm_hidden=32", "lm_embed_dim=8"]
    _, want = _hypotheses(jevaluate.main, base + lm_args, monkeypatch, capsys)
    _, got = _hypotheses(tevaluate.main, base + lm_args, monkeypatch, capsys, device="cpu")
    assert [g["hyp"] for g in got] == [w["hyp"] for w in want]
    for g, w in zip(got, want):
        assert g["score"] == pytest.approx(w["score"], rel=1e-4)
    _, plain = _hypotheses(tevaluate.main, base, monkeypatch, capsys, device="cpu")
    assert [p["score"] for p in plain] != [g["score"] for g in got]

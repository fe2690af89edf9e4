"""Greedy CTC decoding and CTC forced alignment of the port
(``syncvsr_tpu_torch/ops/ctc.py``) against the JAX package's, on the same
logits from a numpy seed: exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest

from syncvsr_tpu.ops.ctc import ctc_forced_align as jax_align
from syncvsr_tpu.ops.ctc import ctc_greedy_decode as jax_greedy
from syncvsr_tpu_torch.ops.ctc import ctc_forced_align, ctc_greedy_decode
from tests.torch_parity import tt
import torch_threads  # noqa: F401  (one torch thread a test process)


def _logits(seed, b, t, v, blank_bias=0.0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, v).astype(np.float32) * 2
    x[..., 0] += blank_bias
    return x


@pytest.mark.parametrize("blank_bias", [0.0, 2.0, -20.0])
def test_greedy_decode_equal(blank_bias):
    """Frames past the length; rows of mostly blanks, and (bias -20) a row
    whose every frame is kept; repeats merged."""
    b, t, v = 4, 12, 5
    x = _logits(0, b, t, v, blank_bias)
    # a run of one token (merged) and an alternation (every frame kept)
    x[1, :, 3] += 50.0
    x[2, ::2, 1] += 50.0
    x[2, 1::2, 2] += 50.0
    lengths = np.array([12, 7, 12, 0], np.int32)
    j_tok, j_len = jax_greedy(jnp.asarray(x), jnp.asarray(lengths))
    t_tok, t_len = ctc_greedy_decode(tt(x), tt(lengths))
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(j_len))
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    assert int(t_len[2]) == t  # every frame kept
    assert int(t_len[1]) == 1 and int(t_len[3]) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forced_align_equal(seed):
    """Label length 0, repeated labels (the skip is barred), frames past the
    length, padded labels that are not -1, and a tight row (labels +
    repeats == frames)."""
    b, t, v, n = 5, 10, 6, 5
    x = _logits(seed, b, t, v)
    labels = np.array([[1, 2, 3, 9, 9],
                       [2, 2, 2, 0, 0],
                       [0, 0, 0, 0, 0],
                       [4, 5, 4, 5, 1],
                       [3, 3, 1, 1, 1]], np.int32)
    label_lengths = np.array([3, 3, 0, 5, 5], np.int32)
    labels = np.minimum(labels, v - 1)
    lengths = np.array([10, 6, 8, 10, 8], np.int32)
    want = np.asarray(jax_align(jnp.asarray(x), jnp.asarray(lengths), jnp.asarray(labels),
                                jnp.asarray(label_lengths)))
    got = ctc_forced_align(tt(x), tt(lengths), tt(labels), tt(label_lengths)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[2, :8] == 0).all() and (got[lengths <= 8, 8:] == -1).all()


def test_forced_align_follows_a_dominant_path():
    """Logits that favour one path strongly: the alignment is that path."""
    t, v = 8, 4
    path = [0, 1, 1, 0, 2, 2, 3, 0]
    x = np.full((1, t, v), -10.0, np.float32)
    x[0, np.arange(t), path] = 10.0
    got = ctc_forced_align(tt(x), tt(np.array([t], np.int32)),
                           tt(np.array([[1, 2, 3]], np.int32)),
                           tt(np.array([3], np.int32))).numpy()
    np.testing.assert_array_equal(got[0], path)

"""PyTorch port: the sentence-level loss helpers (padding masks, the
teacher-forcing io pair, the label-smoothed KL, decoder accuracy and the CTC
loss) against the JAX package, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.ops import masking as jm
from syncvsr_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from syncvsr_tpu_torch.ops import masking as tm
from syncvsr_tpu_torch.ops.ctc import ctc_loss
from torch_parity import close, tt

VOCAB = 11


def _labels(seed, b=4, l=6):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(1, l + 1, b)
    lengths[0] = l
    labels = np.full((b, l), -1, np.int32)
    for i, n in enumerate(lengths):
        labels[i, :n] = rng.randint(1, VOCAB - 1, n)
    return labels


def test_length_mask():
    lengths = np.array([3, 0, 5], np.int32)
    got = tm.length_mask(tt(lengths), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.length_mask(jnp.asarray(lengths), 5)))


@pytest.mark.parametrize("seed", [0, 1])
def test_add_sos_eos_exact(seed):
    labels = _labels(seed)
    got = tm.add_sos_eos(tt(labels), VOCAB - 1, VOCAB - 1, -1)
    want = jm.add_sos_eos(jnp.asarray(labels), VOCAB - 1, VOCAB - 1, -1)
    assert got[0].dtype == got[1].dtype == torch.int32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# f32 log-softmax and sums in other orders, and the constant terms' logs
# taken in double before rounding: 1e-6 relative
@pytest.mark.parametrize("weighted,normalize", [(False, False), (True, False), (False, True),
                                                (True, True)])
def test_label_smoothing_kl_matches_jax(weighted, normalize):
    rng = np.random.RandomState(2)
    labels = _labels(3)
    _, ys_out, _ = jm.add_sos_eos(jnp.asarray(labels), VOCAB - 1, VOCAB - 1, -1)
    ys_out = np.asarray(ys_out)
    logits = (rng.randn(*ys_out.shape, VOCAB) * 3).astype(np.float32)
    w = np.array([1.0, 0.0, 0.5, 1.0], np.float32) if weighted else None
    want = jm.label_smoothing_kl(jnp.asarray(logits), jnp.asarray(ys_out), VOCAB, 0.1, -1,
                                 normalize, None if w is None else jnp.asarray(w))
    got = tm.label_smoothing_kl(tt(logits), tt(ys_out), VOCAB, 0.1, -1, normalize,
                                None if w is None else tt(w))
    close(got, want, 1e-6, 0.0, "kl")


@pytest.mark.parametrize("weighted", [False, True])
def test_decoder_accuracy_exact(weighted):
    rng = np.random.RandomState(4)
    labels = _labels(5)
    logits = rng.randn(*labels.shape, VOCAB).astype(np.float32)
    logits[0, 0, labels[0, 0]] = 10.0   # at least one hit
    w = np.array([1.0, 0.0, 1.0, 1.0], np.float32) if weighted else None
    want = jm.decoder_accuracy(jnp.asarray(logits), jnp.asarray(labels), -1,
                               None if w is None else jnp.asarray(w))
    got = tm.decoder_accuracy(tt(logits), tt(labels), -1, None if w is None else tt(w))
    assert float(got) == float(want) and float(got) > 0


# f32 alpha recursions in two libraries: 1e-4 relative on the loss and on
# each logit's gradient (as a share of the largest)
@pytest.mark.parametrize("weighted", [False, True])
def test_ctc_loss_value_and_logit_grad_match_optax(weighted):
    rng = np.random.RandomState(6)
    b, t = 4, 12
    logits = (rng.randn(b, t, VOCAB) * 2).astype(np.float32)
    logit_lengths = np.array([12, 9, 7, 10], np.int32)       # padded frames
    labels = _labels(7, b, 5)                               # padded labels (-1)
    label_lengths = (labels != -1).sum(1).astype(np.int32)
    w = np.array([1.0, 0.5, 0.0, 2.0], np.float32) if weighted else None

    def jax_fn(x):
        return jax_ctc_loss(x, jnp.asarray(logit_lengths), jnp.asarray(labels),
                            jnp.asarray(label_lengths), 0,
                            None if w is None else jnp.asarray(w))

    want, want_g = jax.value_and_grad(jax_fn)(jnp.asarray(logits))
    x = tt(logits).requires_grad_()
    got = ctc_loss(x, tt(logit_lengths), tt(labels), tt(label_lengths), 0,
                   None if w is None else tt(w))
    got.backward()
    close(got, want, 1e-4, 0.0, "ctc")
    want_g = np.asarray(want_g)
    close(x.grad, want_g, 1e-4, 1e-4 * float(np.abs(want_g).max()), "dlogits")
    # padded frames get no gradient
    assert float(x.grad[2, 7:].abs().max()) == 0.0

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
import torch_threads  # noqa: F401  (one torch thread a test process)

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


# the JAX package's own test of the form (tests/test_masking_ctc.py) holds
# it to the logq form at rtol 1e-5, atol 1e-5 (value) and 1e-6 (gradient)
@pytest.mark.parametrize("smoothing,weighted,normalize", [
    (0.1, False, False), (0.0, False, False), (0.1, False, True), (0.1, True, False),
    (0.1, True, True)])
def test_label_smoothing_v2_matches_jax(smoothing, weighted, normalize, monkeypatch):
    """SYNCVSR_LSM_V2's reassociated form (logsumexp, row sum and target
    logit of the raw logits): value and logit gradient equal to the JAX
    package's V2 form and to the port's logq form."""
    rng = np.random.RandomState(7)
    b, l, v = 3, 5, 37
    logits = (rng.randn(b, l, v) * 4).astype(np.float32)
    targets = rng.randint(-1, v, (b, l)).astype(np.int32)
    w = np.array([1.0, 0.0, 1.0], np.float32) if weighted else None

    def port():
        x = tt(logits).requires_grad_()
        loss = tm.label_smoothing_kl(x, tt(targets), v, smoothing, -1, normalize,
                                     None if w is None else tt(w))
        loss.backward()
        return loss.detach(), x.grad

    v1 = port()
    monkeypatch.setenv("SYNCVSR_LSM_V2", "1")
    v2 = port()
    want = jax.jit(jax.value_and_grad(lambda lg: jm.label_smoothing_kl(
        lg, jnp.asarray(targets), v, smoothing, -1, normalize,
        None if w is None else jnp.asarray(w))))(jnp.asarray(logits))
    close(v2[0], want[0], 1e-5, 1e-5, "value")
    close(v2[1], want[1], 1e-5, 1e-6, "gradient")
    close(v2[0], v1[0].numpy(), 1e-5, 1e-5, "value against the logq form")
    close(v2[1], v1[1].numpy(), 1e-5, 1e-6, "gradient against the logq form")


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
# each logit's gradient (as a share of the largest). Rows 4 and 5 have no
# alignment (6 labels over 4 frames; [1, 1] over 2 frames, which needs a
# blank between the two), so optax's log_epsilon sets their loss, ~1e5.
# There f32's spacing (2^-7 at 1e5) rounds each path score the recursion
# adds to log_epsilon, and the two libraries round in other places: the
# weights of the near-alignments, which are those rows' gradient, differ by
# up to ~1%, so their gradient is held to 1e-2 of its largest
INFEASIBLE_GRAD_TOL = 1e-2
@pytest.mark.parametrize("weighted", [False, True])
def test_ctc_loss_value_and_logit_grad_match_optax(weighted):
    rng = np.random.RandomState(6)
    b, t = 6, 12
    logits = (rng.randn(b, t, VOCAB) * 2).astype(np.float32)
    logit_lengths = np.array([12, 9, 7, 10, 4, 2], np.int32)   # padded frames
    labels = np.full((b, 6), -1, np.int32)
    labels[:4, :5] = _labels(7, 4, 5)                        # padded labels (-1)
    labels[4] = rng.randint(1, VOCAB - 1, 6)
    labels[5, :2] = 1
    label_lengths = (labels != -1).sum(1).astype(np.int32)
    w = np.array([1.0, 0.5, 0.0, 2.0, 1.0, 0.5], np.float32) if weighted else None

    def jax_fn(x):
        return jax_ctc_loss(x, jnp.asarray(logit_lengths), jnp.asarray(labels),
                            jnp.asarray(label_lengths), 0,
                            None if w is None else jnp.asarray(w))

    want, want_g = jax.jit(jax.value_and_grad(jax_fn))(jnp.asarray(logits))
    x = tt(logits).requires_grad_()
    got = ctc_loss(x, tt(logit_lengths), tt(labels), tt(label_lengths), 0,
                   None if w is None else tt(w))
    got.backward()
    assert float(want) > 1e4 and torch.isfinite(x.grad).all()
    close(got, want, 1e-4, 0.0, "ctc")
    want_g = np.asarray(want_g)
    close(x.grad[:4], want_g[:4], 1e-4, 1e-4 * float(np.abs(want_g[:4]).max()), "dlogits")
    close(x.grad[4:], want_g[4:], 0.0, INFEASIBLE_GRAD_TOL * float(np.abs(want_g[4:]).max()),
          "dlogits of the infeasible rows")
    # padded frames get no gradient
    assert float(x.grad[2, 7:].abs().max()) == 0.0


def _per_row(fn, b):
    """Each row's loss, through a batch mean weighted by a one-hot row."""
    return [float(fn(np.eye(b, dtype=np.float32)[i])) for i in range(b)]


def test_ctc_infeasible_rows_match_optax_per_row():
    """Logits [3, 4, 7] from seed 0: 6 labels over 4 frames, a feasible row,
    and [1, 1] over 2 frames. Each row's loss (1e-4 relative, f32
    recursions) and the whole batch's logit gradient (1e-4 of its largest)
    match optax, and are finite (the feasible row's to 1e-4 of the largest,
    the others' to ``INFEASIBLE_GRAD_TOL``); ``infeasible_rows`` names rows
    0 and 2."""
    from syncvsr_tpu_torch.ops.ctc import infeasible_rows

    rng = np.random.RandomState(0)
    logits = rng.randn(3, 4, 7).astype(np.float32)
    labels = np.array([[1, 2, 3, 4, 5, 6], [2, 3, -1, -1, -1, -1],
                       [1, 1, -1, -1, -1, -1]], np.int32)
    label_lengths = np.array([6, 2, 2], np.int32)
    logit_lengths = np.array([4, 4, 2], np.int32)
    args_j = [jnp.asarray(a) for a in (logit_lengths, labels, label_lengths)]
    args_t = [tt(a) for a in (logit_lengths, labels, label_lengths)]
    want = _per_row(lambda w: jax_ctc_loss(jnp.asarray(logits), *args_j, 0, jnp.asarray(w)), 3)
    got = _per_row(lambda w: ctc_loss(tt(logits), *args_t, 0, tt(w)), 3)
    assert want[0] > 1e4 and want[2] > 1e4 and want[1] < 100
    close(np.array(got), np.array(want), 1e-4, 0.0, "per-row ctc")
    label_pad = torch.arange(6)[None, :] >= args_t[2][:, None]
    assert infeasible_rows(*args_t, label_pad).tolist() == [True, False, True]
    want_g = np.asarray(jax.grad(lambda x: jax_ctc_loss(x, *args_j, 0))(jnp.asarray(logits)))
    x = tt(logits).requires_grad_()
    ctc_loss(x, *args_t, 0).backward()
    assert torch.isfinite(x.grad).all()
    top = float(np.abs(want_g).max())
    close(x.grad[1], want_g[1], 1e-4, 1e-4 * top, "dlogits")
    close(x.grad[::2], want_g[::2], 0.0, INFEASIBLE_GRAD_TOL * top, "dlogits, infeasible")


def test_ctc_recursion_matches_optax_in_f64():
    """``ctc_loss_optax`` against ``optax.ctc_loss`` in float64 on both
    sides: padded frames and labels, a repeated label, and two rows with no
    alignment (6 labels over 4 frames; [1, 1] over 2 frames). Each row's
    loss to 1e-9 relative and the logit gradient to 1e-9 of its largest:
    so the f32 gap on the infeasible rows (``INFEASIBLE_GRAD_TOL``) is
    rounding at 1e5, not a difference in the recursion."""
    import optax

    from syncvsr_tpu_torch.ops.ctc import ctc_loss_optax

    rng = np.random.RandomState(6)
    b, t, n = 6, 12, 6
    logits = rng.randn(b, t, VOCAB) * 2
    logit_lengths = np.array([12, 9, 7, 10, 4, 2])
    label_lengths = np.array([5, 3, 4, 2, 6, 2])
    labels = np.zeros((b, n), np.int64)
    for i, k in enumerate(label_lengths):
        labels[i, :k] = rng.randint(1, VOCAB - 1, k)
    labels[1, 1] = labels[1, 0]
    labels[5, :2] = 1
    logit_pad = (np.arange(t)[None, :] >= logit_lengths[:, None]).astype(np.float64)
    label_pad = (np.arange(n)[None, :] >= label_lengths[:, None]).astype(np.float64)
    jax.config.update("jax_enable_x64", True)
    try:
        def optax_rows(x):
            return optax.ctc_loss(x, jnp.asarray(logit_pad), jnp.asarray(labels),
                                  jnp.asarray(label_pad))

        want = np.asarray(optax_rows(jnp.asarray(logits)))
        want_g = np.asarray(jax.grad(lambda x: optax_rows(x).sum())(jnp.asarray(logits)))
    finally:
        jax.config.update("jax_enable_x64", False)
    assert want.dtype == np.float64 and want[4] > 1e4 and want[5] > 1e4
    x = torch.tensor(logits, requires_grad=True)
    got = ctc_loss_optax(torch.log_softmax(x, -1), tt(logit_lengths), tt(labels),
                         tt(label_lengths))
    got.sum().backward()
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-9, atol=0.0,
                               err_msg="ctc rows, f64")
    np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=0.0,
                               atol=1e-9 * float(np.abs(want_g).max()), err_msg="dlogits, f64")


def test_ctc_feasible_batch_skips_the_recursion(monkeypatch):
    """A batch whose rows all have an alignment never runs the Python
    recursion (the step's cost stays F.ctc_loss plus the feasibility test)."""
    from syncvsr_tpu_torch.ops import ctc

    def boom(*a, **k):
        raise AssertionError("the recursion ran on a feasible batch")

    monkeypatch.setattr(ctc, "ctc_loss_optax", boom)
    rng = np.random.RandomState(1)
    labels = _labels(3, 4, 5)
    label_lengths = (labels != -1).sum(1).astype(np.int32)
    out = ctc.ctc_loss(tt(rng.randn(4, 12, VOCAB).astype(np.float32)),
                       tt(np.full(4, 12, np.int32)), tt(labels), tt(label_lengths))
    assert torch.isfinite(out)

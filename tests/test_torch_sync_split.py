"""PyTorch port: the wide sync head (kernel K2's plain version against the
Pallas slot-split kernel in interpret mode, the K1/K2 dispatch rule, and the
fused sync CE at T = 160 with a ragged backward chunk), on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.ops import pallas_sync as ps
from syncvsr_tpu_torch.ops import cuda_sync
from torch_parity import close, tt
import torch_threads  # noqa: F401  (one torch thread a test process)

A, G, V = 4, 2, 320


def _head(seed, n_or_bt, d, v=V):
    rng = np.random.RandomState(seed)
    x = rng.randn(*n_or_bt, d).astype(np.float32)
    w = (rng.randn(d, A * G * v) * 0.02).astype(np.float32)
    b = (rng.randn(A * G * v) * 0.1).astype(np.float32)
    return rng, x, w, b


# the cases chip_smoke.py holds kernel K2 to (SPLIT_CASES): lrs3's D = 768
# and V = 320 at ragged row counts, a D past the 64-deep stage, a V below
# the 320 columns a block holds
@pytest.mark.parametrize("n,d,v", [(300, 768, V), (37, 768, V), (1, 768, V), (33, 768, V),
                                   (300, 776, V), (300, 768, 256)],
                         ids=["300", "37", "1", "33", "d776", "v256"])
def test_k2_plain_matches_pallas_split_interpret(n, d, v, monkeypatch):
    # both cast features and weight to bf16 and accumulate in f32; only the
    # summation order differs: 2e-6 relative, the count exact
    s = A * G
    if v == V:
        assert ps._round_up(d, 128) * s * ps._round_up(v, 128) * 2 > ps._MONO_W_BYTES
        assert cuda_sync.uses_split_kernel(d, s, v)
    else:
        # a 256-wide vocabulary's weight is under the 4 MiB rule: lower the
        # threshold so that _pallas_forward takes the slot-split kernel
        monkeypatch.setattr(ps, "_MONO_W_BYTES", 0)
    traced = []   # the Pallas kernel bodies _pallas_forward traces

    def spy(name, body):
        def kernel(*refs, **kw):
            traced.append(name)
            return body(*refs, **kw)
        monkeypatch.setattr(ps, name, kernel)

    spy("_kernel_split", ps._kernel_split)
    spy("_kernel", ps._kernel)
    rng, x, w, b = _head(0, (n,), d, v)
    tok = rng.randint(0, v, (n, s)).astype(np.int32)
    tok[rng.rand(n, s) < 0.1] = -1
    ce, cnt = cuda_sync.sync_ce_partials_plain(tt(x), tt(w), tt(b), tt(tok))
    jce, jcnt = ps._pallas_forward(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                   jnp.asarray(tok), s, v, interpret=True)
    assert traced and set(traced) == {"_kernel_split"}
    assert float(cnt) == float(jcnt) == float((tok >= 0).sum())
    close(ce, jce, 2e-6, 0.0, "ce_sum")


@pytest.mark.parametrize("d,split", [(513, False), (640, False), (641, True), (768, True),
                                     (64, False)])
def test_dispatch_follows_the_jax_rule(d, split):
    """K1 at lrw_video's 513, K2 at the Conformer's 768: the padded bf16
    weight against the 4 MiB threshold, as _pallas_forward decides."""
    s = A * G
    jax_split = ps._round_up(d, 128) * s * ps._round_up(V, 128) * 2 > ps._MONO_W_BYTES
    assert cuda_sync.uses_split_kernel(d, s, V) == jax_split == split
    # on CPU tensors the dispatcher and both wrappers give the plain version,
    # and no kernel counts a launch
    rng, x, w, b = _head(1, (5,), d)
    tok = tt(rng.randint(-1, V, (5, s)).astype(np.int32))
    before = (cuda_sync.sync_ce_mono_partials.launches,
              cuda_sync.sync_ce_split_partials.launches)
    want = cuda_sync.sync_ce_partials_plain(tt(x), tt(w), tt(b), tok)
    for fn in (cuda_sync.sync_ce_partials, cuda_sync.sync_ce_mono_partials,
               cuda_sync.sync_ce_split_partials):
        got = fn(tt(x), tt(w), tt(b), tok)
        assert [float(g) for g in got] == [float(e) for e in want]
    assert (cuda_sync.sync_ce_mono_partials.launches,
            cuda_sync.sync_ce_split_partials.launches) == before


def test_fused_sync_ce_t160_matches_pallas_split_interpret():
    """The lrs3 sync head at T = 160 (> the 128-frame backward chunk, so two
    chunks with a ragged tail): forward through K2's plain version, backward
    through the f32 chunked recompute on both sides."""
    b, t, d = 2, 160, 768
    rng, x, w, bias = _head(2, (b, t), d)
    tokens = rng.randint(0, V, (b, t * A + 4, G)).astype(np.int32)
    tokens[1, t * A // 2:] = -1   # a padded clip
    tokens[rng.rand(*tokens.shape) < 0.05] = -1
    xs, ws, bs = (tt(a).requires_grad_() for a in (x, w, bias))
    loss = cuda_sync.fused_sync_cross_entropy(xs, ws, bs, tt(tokens), A, G, V, 128)
    loss.backward()

    def jax_loss(f, k, bb):
        return ps.pallas_sync_cross_entropy(f, k, bb, jnp.asarray(tokens), A, G, V, 128, True)

    jl, jg = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (x, w, bias)))
    close(loss, jl, 1e-5, 1e-6, "loss")
    for name, got, want in zip(("dfeatures", "dkernel", "dbias"),
                               (xs.grad, ws.grad, bs.grad), jg):
        want = np.asarray(want)
        close(got, want, 1e-4, 1e-5 * float(np.abs(want).max()), name)
    assert torch.isfinite(xs.grad).all()


# K2 at V = 640 (the wav2vec2 codec's 4 slots): D past 819, where the bf16
# weight passes the 4 MiB rule, at ragged rows and a D that is no multiple
# of the 64-deep stage; and a second pass of 80 columns (V = 400, whose
# padded weight is under the rule: the threshold is lowered, as for V = 256)
@pytest.mark.parametrize("n,d,v", [(130, 896, 640), (37, 896, 640), (130, 904, 640),
                                   (130, 896, 400)],
                         ids=["130", "37", "d904", "v400"])
def test_k2_plain_at_v640_matches_pallas_split_interpret(n, d, v, monkeypatch):
    # as at V = 320: the same bf16 operands, f32 sums in other orders
    s = 4
    if v == 640:
        assert 819 < d and cuda_sync.uses_split_kernel(d, s, v)
        assert ps._round_up(d, 128) * s * ps._round_up(v, 128) * 2 > ps._MONO_W_BYTES
    else:
        monkeypatch.setattr(ps, "_MONO_W_BYTES", 0)
    traced = []
    body = ps._kernel_split

    def kernel(*refs, **kw):
        traced.append("_kernel_split")
        return body(*refs, **kw)

    monkeypatch.setattr(ps, "_kernel_split", kernel)
    rng = np.random.RandomState(n + d + v)
    x = rng.randn(n, d).astype(np.float32)
    w = (rng.randn(d, s * v) * 0.02).astype(np.float32)
    b = (rng.randn(s * v) * 0.1).astype(np.float32)
    tok = rng.randint(0, v, (n, s)).astype(np.int32)
    tok[rng.rand(n, s) < 0.1] = -1
    ce, cnt = cuda_sync.sync_ce_partials_plain(tt(x), tt(w), tt(b), tt(tok))
    jce, jcnt = ps._pallas_forward(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                   jnp.asarray(tok), s, v, interpret=True)
    assert traced
    assert float(cnt) == float(jcnt) == float((tok >= 0).sum())
    close(ce, jce, 2e-6, 0.0, "ce_sum")


def test_registry_builds_lrw1000_dense_tcn_at_full_width():
    """lrw1000 with the DC-TCN, which the JAX package builds: a 1664-wide
    head over the wav2vec2 codec's 4 slots of 640, an 8.5 MB bf16 weight, so
    K2 by the JAX rule, in two 320-column passes over 60 row tiles a slot."""
    from syncvsr_tpu_torch import config as tcfg
    from syncvsr_tpu_torch.models import build_model

    cfg = tcfg.lrw1000_config().override(**{"model.encoder.kind": "dense_tcn"})
    head = build_model(cfg, device="cpu").audio_classifier
    assert head.weight.shape == (4 * 640, 1664) and (head.alignment, head.groups) == (2, 2)
    assert 1664 * 4 * 640 * 2 == 8519680
    assert cuda_sync.uses_split_kernel(1664, 4, 640) and 640 <= cuda_sync.SPLIT_MAX_VOCAB
    geo = cuda_sync.split_geometry(40 * 96, 4, 640)
    assert geo["passes"] == 2 and geo["grid"] == (60, 4)
    assert cuda_sync.split_geometry(40 * 96, 8)["passes"] == 1


def test_lrw1000_dctcn_train_step_matches_jax(monkeypatch):
    """One train step of a tiny lrw1000 model with the DC-TCN (wav2vec2
    codec, 4 slots of 640 tokens, no word boundary) from the same weights
    in both packages, the mixup weight injected: metrics, batch_stats, Adam
    moments and params, with test_torch_dctcn's tolerances."""
    import functools

    import syncvsr_tpu.models.word as jword
    from syncvsr_tpu import config as jcfg
    from syncvsr_tpu.engine import build_train_step as jax_build_train_step
    from syncvsr_tpu.engine import create_train_state as jax_create_train_state
    from syncvsr_tpu.models import build_model as jax_build_model
    from syncvsr_tpu.models import dense_tcn as jdt
    from syncvsr_tpu_torch import config as tcfg
    from syncvsr_tpu_torch.engine import build_train_step, create_train_state
    from syncvsr_tpu_torch.models import word as tword
    from syncvsr_tpu_torch.utils.bridge import to_flax
    from test_torch_dctcn import (LAM, METRICS, TOY_TCN, _batch, _fixed_mixup, _no_dropout,
                                  _zero_gradient)
    from test_torch_step import _adam_moments, _compare
    from torch_parity import TINY, JitInit, to_np, torch_model

    over = dict(TINY, **TOY_TCN, **{"data.batch_size": 4, "model.encoder.kind": "dense_tcn",
                                    "model.codec.audio_vocab_size": 640})
    cfg_j = jcfg.lrw1000_config().override(**over)
    cfg_t = tcfg.lrw1000_config().override(**over)
    assert cfg_t.model.codec.audio_alignment == 2 and not cfg_t.model.use_word_boundary
    batch = _batch(cfg_t)
    monkeypatch.setattr(jword, "DenseTCN", functools.partial(jdt.DenseTCN, dropout=0.0))
    monkeypatch.setattr(jword, "batch_mixup", _fixed_mixup)
    state_j = jax_create_train_state(cfg_j, JitInit(jax_build_model(cfg_j)),
                                     {k: jnp.asarray(v) for k, v in batch.items()})
    params, stats = to_np(state_j.params), to_np(state_j.batch_stats)
    state_j, m_j = jax_build_train_step(donate=False)(
        state_j, {k: jnp.asarray(v) for k, v in batch.items()})
    mu_j, nu_j = (to_np(t) for t in _adam_moments(state_j.opt_state))

    monkeypatch.setattr(tword, "sample_mixup", lambda gen, alpha: torch.tensor(LAM))
    model = _no_dropout(torch_model(cfg_t, params, stats))
    assert model.audio_classifier.vocab == 640
    state = create_train_state(cfg_t, model, batch, device="cpu")
    state, m = build_train_step()(state, {k: tt(v) for k, v in batch.items()})
    for k in METRICS:
        close(float(m[k]), float(m_j[k]), 1e-4, 1e-7, k)
    sd = model.state_dict()
    _compare(to_flax(sd)[1], to_np(state_j.batch_stats), 1e-4, 1e-5, "batch_stats")
    # Adam moments: test_torch_dctcn's per-leaf tolerances, plus a floor of
    # 1e-7 of the tree's largest moment: at V = 640 the squeeze-excitation's
    # one-unit Dense_0 bias has a gradient ~1e-5 of the largest, and f32
    # sums in other orders leave an error at the scale of the whole
    # backward there (3.8e-3 of that leaf, 6e-8 of the largest, measured)
    for name, got, want, atol_rel in (("mu", state.mu, mu_j, 5e-4), ("nu", state.nu, nu_j, 1e-3)):
        got = to_flax(dict(zip(state.names, got)))[0]
        top = max(float(np.abs(w).max()) for w in jax.tree_util.tree_leaves(want))
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree_util.tree_leaves(got)):
            if _zero_gradient(path):   # true gradient 0: noise on both sides
                assert max(float(np.abs(w).max()), float(np.abs(g).max())) <= 1e-6 * top
                continue
            close(g, w, 1e-3, atol_rel * float(np.abs(w).max()) + 1e-7 * top,
                  name + jax.tree_util.keystr(path))
    # params: test_torch_dctcn's bounds (0.05 of the rate, 2x where the true
    # gradient is 0), and the rate itself where the gradient is under 100x
    # Adam's eps: the first update is lr * g / (|g| + eps), which moves by
    # lr * dg / eps there (one element of transition0's BatchNorm bias, 0.15
    # of the rate apart, measured)
    lr, eps, b2 = float(m_j["learning_rate"]), cfg_t.optim.eps, cfg_t.optim.b2
    nu_t = to_flax(dict(zip(state.names, state.nu)))[0]
    for (path, w), g, v in zip(jax.tree_util.tree_leaves_with_path(to_np(state_j.params)),
                               jax.tree_util.tree_leaves(to_flax(sd)[0]),
                               jax.tree_util.tree_leaves(nu_t)):
        near_eps = np.sqrt(v / (1 - b2)) < 100 * eps
        extra = 2 * lr if _zero_gradient(path) else np.where(near_eps, lr, 0.05 * lr)
        bound = 1e-4 * np.abs(w) + 1e-4 * float(np.abs(w).max()) + extra
        assert (np.abs(g - w) <= bound).all(), "params" + jax.tree_util.keystr(path)

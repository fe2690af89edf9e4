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

    jl, jg = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (x, w, bias)))
    close(loss, jl, 1e-5, 1e-6, "loss")
    for name, got, want in zip(("dfeatures", "dkernel", "dbias"),
                               (xs.grad, ws.grad, bs.grad), jg):
        want = np.asarray(want)
        close(got, want, 1e-4, 1e-5 * float(np.abs(want).max()), name)
    assert torch.isfinite(xs.grad).all()

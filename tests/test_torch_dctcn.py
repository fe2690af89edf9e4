"""PyTorch port: the TCN family (``encoder.kind`` "dense_tcn", "tcn",
"mstcn") against the JAX package, on the CPU, from bridged weights:
``SELayer1D``, the "prelu" activation, the flax-semantics BatchNorm, the
DC-TCN and both TCNs (with and without the depthwise-pointwise split),
batch mixup with an injected lambda, the TCNs' bridge and the ``lrw_dctcn``
preset at full width; and the tiny ``lrw_dctcn`` model's configs and batch,
which ``test_torch_dctcn_model.py`` (its eval and train steps against JAX's)
and the multi-process files share. f32 throughout; dropout 0 where a
comparison runs in train mode."""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.models import dense_tcn as jdt
from syncvsr_tpu.models import layers as jl
from syncvsr_tpu.models import tcn as jtcn
from syncvsr_tpu.ops.cutmix import batch_mixup
from syncvsr_tpu_torch import config as tcfg
from syncvsr_tpu_torch.models import dense_tcn as tdt
from syncvsr_tpu_torch.models import layers as tl
from syncvsr_tpu_torch.models import tcn as ttcn
from syncvsr_tpu_torch.ops.cutmix import batch_mixup_apply, sample_mixup
from syncvsr_tpu_torch.utils.bridge import from_flax, to_flax
from test_torch_layers import _init, _load, _x
from test_torch_step import _compare
from torch_parity import TINY, close, to_np, tt
import torch_threads  # noqa: F401  (one torch thread a test process)

METRICS = ("loss", "loss_word", "loss_audio", "learning_rate", "grad_norm")
# a DC-TCN small enough for the CPU: two blocks (2 and 1 layers) of growth
# 12 over a 16-wide transition, SE on, so the head sees 16 + 12 = 28
TOY_TCN = {"model.encoder.tcn_growth_rates": (12, 12), "model.encoder.tcn_blocks": (2, 1),
           "model.encoder.tcn_reduced_size": 16}
LAM = 0.3125   # the mixup weight both frameworks are given


def _load_all(module, params, stats):
    sd = {k: torch.from_numpy(v) for k, v in from_flax(params, stats).items()}
    module.load_state_dict(sd, strict=True)
    return module


def _randomise(params, seed):
    """Norm scales and biases away from 1 and 0, so that they are tested."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = _randomise(v, seed + len(out) + 1)
        elif k in ("scale", "bias"):
            out[k] = (v + rng.uniform(-0.3, 0.3, v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


# f32 against f32: ~1e-6 relative
def test_prelu_is_flax_leaky_relu():
    x = _x((3, 7), 1) * 3
    close(tl.activation("prelu")(tt(x)), jl.activation("prelu")(jnp.asarray(x)), 1e-6, 0.0)


def test_se_layer_matches_jax():
    x = _x((2, 5, 48), 2)
    mod = jl.SELayer1D(48)
    params = _randomise(_init(mod, jnp.asarray(x)), 3)
    assert set(params) == {"Dense_0", "Dense_1"}
    assert params["Dense_0"]["kernel"].shape == (48, 3)
    y = _load(tl.SELayer1D(48), params)(tt(x))
    close(y, mod.apply({"params": params}, jnp.asarray(x)), 1e-5, 1e-6)


def test_flax_batchnorm_matches_jax():
    """Outputs of two train calls on different inputs, the running mean and
    variance after them (flax's 0.9 momentum, biased variance), and the eval
    output on those statistics: 1e-5 relative (f32 means in other orders)."""
    mod = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    x1, x2 = _x((3, 6, 10), 4) * 2 + 1, _x((3, 6, 10), 5) * 0.5 - 2
    variables = to_np(mod.init(jax.random.PRNGKey(0), jnp.asarray(x1)))
    params = _randomise(variables["params"], 6)
    stats = variables["batch_stats"]
    bn = _load_all(tl.FlaxBatchNorm(10), params, stats)
    for x in (x1, x2):
        y_j, upd = mod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                             mutable=["batch_stats"])
        stats = to_np(upd["batch_stats"])
        close(bn(tt(x), True), y_j, 1e-5, 1e-5, "train output")
    close(bn.running_mean, stats["mean"], 1e-5, 1e-6, "running mean")
    close(bn.running_var, stats["var"], 1e-5, 1e-6, "running var")
    eval_j = fnn.BatchNorm(use_running_average=True).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x1))
    close(bn(tt(x1), False), eval_j, 1e-5, 1e-5, "eval output")


def _zero_gradient(path):
    """A conv bias that a train-mode BatchNorm follows (the TCN layers'
    ``conv``, ``dw`` and ``pw``): the BatchNorm subtracts the batch mean, so
    its true gradient is 0 and both frameworks hold f32 rounding noise."""
    keys = [getattr(k, "key", k) for k in path]
    return keys[-1] == "bias" and keys[-2] in ("conv", "dw", "pw")


def _compare_split(got, want, rtol, atol_rel, noise, what):
    """``_compare`` over the leaves whose true gradient is not 0; the others
    hold at most ``noise`` of the tree's largest element, on both sides."""
    top = max(float(np.abs(w).max()) for w in jax.tree_util.tree_leaves(want))
    n_zero = 0
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        name = what + jax.tree_util.keystr(path)
        if _zero_gradient(path):
            n_zero += 1
            assert max(float(np.abs(w).max()), float(np.abs(np.asarray(g)).max())) <= \
                noise * top, name
            continue
        close(g, w, rtol, atol_rel * float(np.abs(w).max()) + 1e-12, name)
    return n_zero


def _train_compare(jmod, tmod, x, seed, rtol=1e-4):
    """One train-mode forward (batch statistics) and the gradient of
    sum(y * r) in both frameworks, from the same weights: outputs, running
    statistics and every parameter's gradient to ``rtol`` of each leaf's
    largest (f32 sums in other orders through chained BatchNorms), but the
    conv biases whose true gradient is 0 (``_zero_gradient``): those hold
    under 1e-5 of the largest gradient on both sides. The JAX side runs
    jitted (un-jitted, flax runs it op by op)."""
    init = jax.jit(functools.partial(jmod.init, train=False))
    variables = to_np(init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = _randomise(variables["params"], seed)
    stats = variables["batch_stats"]
    _load_all(tmod, params, stats)
    evaluate = jax.jit(lambda v: jmod.apply(v, jnp.asarray(x), train=False))
    r = np.random.RandomState(seed).randn(*jax.eval_shape(
        evaluate, {"params": params, "batch_stats": stats}).shape)
    r = r.astype(np.float32)

    def loss(p):
        y, upd = jmod.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return (y * r).sum(), (y, upd["batch_stats"])

    (_, (y_j, stats_j)), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    y = tmod(tt(x), True)
    (y * tt(r)).sum().backward()
    scale = float(np.abs(np.asarray(y_j)).max())
    close(y, y_j, rtol, rtol * scale, "output")
    got_stats = to_flax({k: v for k, v in tmod.state_dict().items() if "running" in k})[1]
    _compare(got_stats, to_np(stats_j), rtol, rtol, "batch_stats")
    grads = to_flax({n: p.grad for n, p in tmod.named_parameters()})[0]
    assert _compare_split(grads, to_np(g_j), rtol, rtol, 1e-5, "grad") > 0
    y_eval = tmod(tt(x), False)
    y_eval_j = evaluate({"params": params, "batch_stats": to_np(stats_j)})
    close(y_eval, y_eval_j, rtol, rtol * float(np.abs(np.asarray(y_eval_j)).max()), "eval")


def test_dense_tcn_matches_jax():
    """Two blocks (2 and 1 layers), SE on, 9 frames: the dilation-5 k = 7
    branch's SAME window (31 frames) is wider than the clip."""
    x = _x((3, 9, 20), 7)
    jmod = jdt.DenseTCN(growth_rates=(12, 12), blocks=(2, 1), reduced_size=16, dropout=0.0)
    tmod = tdt.DenseTCN(20, (12, 12), (2, 1), reduced_size=16, rate=0.0)
    assert tmod.out_dim == 28
    _train_compare(jmod, tmod, x, 8)


@pytest.mark.parametrize("dwpw", [False, True], ids=["conv", "dwpw"])
@pytest.mark.parametrize("kind", ["tcn", "mstcn"])
def test_tcn_matches_jax(kind, dwpw):
    """Three levels (dilations 1, 2, 4) of widths 12, 12, 18 over 7 frames."""
    x = _x((2, 7, 10), 9)
    if kind == "tcn":
        jmod = jtcn.TemporalConvNet(channels=(12, 12, 18), kernel=3, dropout=0.0, dwpw=dwpw)
        tmod = ttcn.TemporalConvNet(10, (12, 12, 18), 3, 0.0, dwpw=dwpw)
    else:
        jmod = jtcn.MultibranchTemporalConvNet(channels=(12, 12, 18), kernel_sizes=(3, 5),
                                               dropout=0.0, dwpw=dwpw)
        tmod = ttcn.MultibranchTemporalConvNet(10, (12, 12, 18), (3, 5), 0.0, dwpw=dwpw)
    _train_compare(jmod, tmod, x, 10)
    # the reference's downsample condition: every multibranch block has one
    if kind == "mstcn":
        assert all(hasattr(getattr(tmod, f"block_{i}"), "downsample") for i in range(3))


def test_batch_mixup_apply_matches_jax():
    """The apply part, given JAX's lambda: bitwise up to f32 rounding of the
    lerp; the sampling part folds into [0, 0.5] (mean 0.25 at alpha 1)."""
    x = _x((4, 3, 5, 5, 1), 11)
    mixed_j, lam_j = batch_mixup(jax.random.PRNGKey(3), jnp.asarray(x), 1.0)
    mixed = batch_mixup_apply(tt(x), torch.tensor(float(lam_j)))
    close(mixed, mixed_j, 1e-6, 1e-6)
    gen = torch.Generator().manual_seed(0)
    lams = torch.stack([sample_mixup(gen, 1.0) for _ in range(4000)])
    assert lams.dtype == torch.float32 and float(lams.min()) >= 0.0
    assert float(lams.max()) <= 0.5 and abs(float(lams.mean()) - 0.25) < 0.01


def dctcn_configs(**over):
    """(JAX config, port config) of a tiny lrw_dctcn model: TINY's frontend
    and widths, the toy DC-TCN, a batch of 4, mixup weight 1 (the TCN path
    mixes whatever ``data.use_cutmix`` says)."""
    from syncvsr_tpu import config as jcfg

    o = dict(TINY, **TOY_TCN, **{"data.batch_size": 4}, **over)
    return jcfg.lrw_dctcn_config().override(**o), tcfg.lrw_dctcn_config().override(**o)


def _batch(cfg_t, seed=0):
    """word_batch with a ragged attention_mask (the loader pads clips
    shorter than the preset's frames) and a padded row's sync tokens."""
    from syncvsr_tpu_torch.data.synthetic import word_batch

    batch = word_batch(cfg_t, seed=seed)
    b, t = batch["inputs"].shape[:2]
    am = np.ones((b, t), np.float32)
    am[1, -1:] = 0.0
    am[2, -2:] = 0.0
    batch["attention_mask"] = am
    return batch


def _fixed_mixup(rng, videos, alpha):
    """batch_mixup with the test's lambda in place of the drawn one."""
    lam = jnp.asarray(LAM, jnp.float32)
    return videos + lam.astype(videos.dtype) * (jnp.roll(videos, 1, axis=0) - videos), lam


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, tdt.MultiKernelLayer):
            m.rate = 0.0
    return model


@pytest.mark.parametrize("dwpw", [False, True], ids=["conv", "dwpw"])
def test_tcn_bridge_round_trip(dwpw):
    """The TCNs' leaves, the depthwise [k, 1, C] kernel among them, both ways."""
    x = _x((2, 5, 6), 12)
    jmod = jtcn.MultibranchTemporalConvNet(channels=(8, 8), kernel_sizes=(3, 5), dwpw=dwpw)
    init = jax.jit(functools.partial(jmod.init, train=False))
    variables = to_np(init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tmod = _load_all(ttcn.MultibranchTemporalConvNet(6, (8, 8), (3, 5), dwpw=dwpw),
                     variables["params"], variables["batch_stats"])
    back, back_stats = to_flax(tmod.state_dict())
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(variables),
                            jax.tree_util.tree_leaves({"batch_stats": back_stats,
                                                       "params": back})):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    if dwpw:
        assert variables["params"]["block_0"]["branch0_1"]["dw"]["kernel"].shape == (5, 1, 6)
        assert tmod.block_0.branch0_1.dw.weight.shape == (6, 1, 5)


def test_dctcn_preset_builds_at_full_width():
    """build_model takes lrw_dctcn_config() as it is on the CPU: the DC-TCN
    ends 512 + 3 x 384 = 1664 wide over the 513-wide (boundary) stream, so
    its sync head is the split kernel's (K2) by the JAX rule."""
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.ops.cuda_sync import uses_split_kernel

    model = build_model(tcfg.lrw_dctcn_config(), device="cpu")
    assert model.encoder.out_dim == 1664
    assert model.encoder.transition0.conv.weight.shape == (512, 513, 1)
    assert model.audio_classifier.weight.shape == (8 * 320, 1664)
    assert uses_split_kernel(1664, 8, 320)

"""PyTorch port: the lrs3_audio sentence model against the JAX package, on
the CPU, from bridged weights: flax's SAME padding, ResNet1D (eval and
train mode, batch_stats) at an even and an odd length at every stride,
the Conv1D-ResNet frontend, every output key, three train steps (params,
Adam moments, batch_stats) and the bridge round trip. f32, dropout 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.engine import build_train_step as jax_build_train_step
from syncvsr_tpu.engine import create_train_state as jax_create_train_state
from syncvsr_tpu.models import build_model as jax_build_model
from syncvsr_tpu.models.frontend import Conv1DResNetFrontend as JaxConv1DFrontend
from syncvsr_tpu.models.resnet import ResNet1D as JaxResNet1D
from syncvsr_tpu_torch.data.synthetic import sentence_batch
from syncvsr_tpu_torch.engine import build_eval_step, build_train_step, create_train_state
from syncvsr_tpu_torch.models import build_model
from syncvsr_tpu_torch.models.frontend import Conv1DResNetFrontend
from syncvsr_tpu_torch.models.resnet import ResNet1D, same_padding
from syncvsr_tpu_torch.utils.bridge import from_flax, to_flax
from test_torch_step import _adam_moments
from torch_parity import JitInit, audio_configs, close, to_np, torch_model, tt

METRICS = ("loss", "loss_ctc", "loss_att", "loss_audio", "learning_rate", "grad_norm")
FRAMES = 8       # 8 x 640 samples a clip
LR = 1e-4        # the sentence step test's rate, for its reason
WIDTH = 8


def _vars(module, x, **kw):
    v = jax.jit(lambda a: module.init(jax.random.PRNGKey(0), a, **kw))(jnp.asarray(x))
    return to_np(v["params"]), to_np(v["batch_stats"])


def _perturbed(stats, seed):
    """Running statistics away from their (0, 1) start, so that eval mode
    reads them."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.randn(*a.shape)).astype(np.float32) if a.ndim else a, stats)


def _load(module, params, stats):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in from_flax(params, stats).items()},
                           strict=True)
    return module


@pytest.mark.parametrize("length,kernel,stride", [
    (102400, 80, 4), (643, 80, 4), (644, 80, 4), (160, 3, 2), (161, 3, 2), (9, 3, 1),
    (160, 1, 2), (161, 1, 2)])
def test_same_padding_matches_flax(length, kernel, stride):
    """(before, after) as lax's SAME: (38, 38) for the stem at 102400
    samples, (0, 1) for a stride-2 k = 3 conv over an even length."""
    want = jax.lax.padtype_to_pads((length,), (kernel,), (stride,), "SAME")[0]
    assert same_padding(length, kernel, stride) == tuple(want)


# the stride-2 convs see lengths 320, 160, 80 at 1280 samples (all even; 2
# windows of 20 at the end) and 161, 81, 41 at 643 (all odd, the stem's
# padding uneven too; 1 window, 1 sample cut)
@pytest.mark.parametrize("samples", [1280, 643], ids=["even", "odd"])
def test_resnet1d_matches_jax(samples):
    """Eval mode on perturbed running statistics, then one train-mode
    forward: its output and the updated batch_stats. f32 through 17 convs
    and 20 BatchNorms: ~1e-6 relative, held at 1e-5 (a BatchNorm's batch
    variance over few samples sits at 1e-4 of the output scale)."""
    x = np.random.RandomState(samples).randn(2, samples, 1).astype(np.float32)
    mod = JaxResNet1D(WIDTH)
    params, stats = _vars(mod, x)
    stats = _perturbed(stats, 1)
    y_j = mod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    net = _load(ResNet1D(WIDTH), params, stats)
    with torch.no_grad():
        y = net(tt(x), train=False)
    assert y.shape == y_j.shape == (2, samples // 640, 8 * WIDTH)
    close(y, y_j, 1e-5, 1e-5, "eval")
    yt_j, upd = mod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    with torch.no_grad():
        yt = net(tt(x), train=True)
    close(yt, yt_j, 1e-5, 1e-5, "train")
    new_stats = to_flax(net.state_dict())[1]
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(to_np(upd["batch_stats"])),
                            jax.tree_util.tree_leaves(new_stats)):
        close(g, w, 1e-5, 1e-6, "batch_stats" + jax.tree_util.keystr(path))


@pytest.mark.parametrize("rank", [2, 3])
def test_conv1d_frontend_matches_jax(rank):
    """[B, S] and [B, S, 1] waveforms, cut to a multiple of 640 samples."""
    x = np.random.RandomState(rank).randn(2, 1290).astype(np.float32)
    if rank == 3:
        x = x[..., None]
    mod = JaxConv1DFrontend(width=WIDTH)
    params, stats = _vars(mod, x)
    stats = _perturbed(stats, 2)
    y_j = mod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    fe = _load(Conv1DResNetFrontend(WIDTH), params, stats)
    with torch.no_grad():
        y = fe(tt(x))
    assert y.shape == (2, 2, 8 * WIDTH)
    close(y, y_j, 1e-5, 1e-5)


@pytest.fixture(scope="module")
def pair():
    """The tiny lrs3_audio model in both packages, the same weights; the
    batch is 2 waveforms of 8 x 640 samples, lengths in samples."""
    cfg_j, cfg_t = audio_configs(**{"optim.lr": LR})
    batch = sentence_batch(cfg_t, num_frames=FRAMES, label_len=3)
    assert batch["videos"].shape == (2, FRAMES * 640) and batch["lengths"].max() == FRAMES * 640
    model_j = jax_build_model(cfg_j)
    state_j = jax_create_train_state(cfg_j, JitInit(model_j),
                                     {k: jnp.asarray(v) for k, v in batch.items()})
    return cfg_j, cfg_t, batch, model_j, state_j


def test_audio_model_eval_matches_jax(pair):
    """Every output key, with perturbed running statistics and a padded
    sample: f32, 1e-5 relative."""
    _, cfg_t, batch, model_j, state_j = pair
    params, stats = to_np(state_j.params), _perturbed(to_np(state_j.batch_stats), 3)
    batch = dict(batch, sample_weight=np.array([1.0, 0.0], np.float32))
    out_j = jax.jit(lambda v, b: model_j.apply(v, **b, det=True))(
        {"params": params, "batch_stats": stats}, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        out = torch_model(cfg_t, params, stats)(**{k: tt(v) for k, v in batch.items()},
                                                det=True)
    assert set(out) == set(out_j)
    for k in out_j:
        close(out[k], out_j[k], 1e-5, 1e-6, k)


@pytest.fixture(scope="module")
def runs(pair):
    """Three steps in each framework (no augmentation: the audio recipe's
    step has none); snapshots after steps 1 and 3."""
    cfg_j, cfg_t, batch, _, state_j = pair
    model = torch_model(cfg_t, to_np(state_j.params), to_np(state_j.batch_stats))
    state = create_train_state(cfg_t, model, batch, device="cpu")
    step_j = jax_build_train_step(donate=False)
    step = build_train_step()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: tt(v) for k, v in batch.items()}
    snaps, lr_sum = {}, 0.0
    for i in range(1, 4):
        state_j, m_j = step_j(state_j, jb)
        state, m = step(state, tb)
        lr_sum += float(m_j["learning_rate"])
        if i in (1, 3):
            mu_j, nu_j = _adam_moments(state_j.opt_state)
            snaps[i] = {
                "jax": {"params": to_np(state_j.params), "mu": to_np(mu_j),
                        "nu": to_np(nu_j), "batch_stats": to_np(state_j.batch_stats),
                        "metrics": {k: float(m_j[k]) for k in METRICS}},
                "torch": {"params": to_flax(model.state_dict())[0],
                          "mu": to_flax(dict(zip(state.names, state.mu)))[0],
                          "nu": to_flax(dict(zip(state.names, state.nu)))[0],
                          "batch_stats": to_flax(model.state_dict())[1],
                          "metrics": {k: float(m[k]) for k in METRICS}},
                "lr_sum": lr_sum,
            }
    return snaps, build_eval_step()(state, tb)


def _zero_gradient(path):
    """The leaves whose true gradient is 0: every attention's key bias (the
    softmax over keys cancels it) and the depthwise conv's bias (the
    BatchNorm after it cancels it)."""
    names = [getattr(k, "key", None) for k in path]
    return names[-1] == "bias" and names[-2] in ("wk", "dw")


def _compare(got, want, rtol, atol_rel, what):
    """Each leaf within ``rtol`` and ``atol_rel`` of its largest element,
    plus 1e-7 of the tree's largest element; a leaf whose true gradient is
    0 holds f32 noise alone, below 1e-6 of the tree's largest element on
    both sides."""
    leaves = jax.tree_util.tree_leaves_with_path(want)
    top = max(float(np.abs(w).max()) for _, w in leaves)
    got_leaves = jax.tree_util.tree_leaves(got)
    assert len(got_leaves) == len(leaves)
    for (path, w), g in zip(leaves, got_leaves):
        where = what + jax.tree_util.keystr(path)
        if _zero_gradient(path):
            assert max(float(np.abs(w).max()), float(np.abs(g).max())) <= 1e-6 * top, where
            continue
        close(g, w, rtol, atol_rel * float(np.abs(w).max()) + 1e-7 * top, where)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_audio_train_steps_match_jax(runs, n_steps):
    """Params, Adam moments and batch_stats with the sentence step test's
    tolerances and reasons (f32 sums in other orders through 22 BatchNorm
    backwards, 20 of them in ResNet1D); the leaves of zero gradient as
    ``_compare`` says."""
    snap = runs[0][n_steps]
    j, t = snap["jax"], snap["torch"]
    for k in METRICS:
        close(t["metrics"][k], j["metrics"][k], 1e-4, 1e-7, k)
    _compare(t["batch_stats"], j["batch_stats"], 1e-4, 1e-5, "batch_stats")
    _compare(t["mu"], j["mu"], 1e-3, 5e-4, "mu")
    _compare(t["nu"], j["nu"], 1e-3, 1e-3, "nu")
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(j["params"]),
                            jax.tree_util.tree_leaves(t["params"])):
        where = "params" + jax.tree_util.keystr(path)
        if _zero_gradient(path):
            # from 0, each update of a noise gradient moves an element by up
            # to about the rate, of either sign
            assert max(float(np.abs(w).max()), float(np.abs(g).max())) <= 2 * snap["lr_sum"], where
            continue
        close(g, w, 1e-4, 1e-4 * float(np.abs(w).max()) + 0.05 * snap["lr_sum"], where)


def test_audio_eval_after_steps(runs):
    snaps, eval_out = runs
    assert snaps[1]["torch"]["metrics"]["learning_rate"] == pytest.approx(1e-6, rel=1e-5)
    assert snaps[3]["torch"]["metrics"]["learning_rate"] == pytest.approx(LR, rel=1e-6)
    assert all(np.isfinite(float(v)) for v in eval_out.values())
    assert {"_tokens", "_slots"} <= set(eval_out)


def test_audio_bridge_round_trip(pair):
    """flax -> torch -> flax is bitwise and total on params and batch_stats
    (the 1-D conv kernels [K, I, O] <-> [O, I, K] among them)."""
    _, cfg_t, _, _, state_j = pair
    params, stats = to_np(state_j.params), to_np(state_j.batch_stats)
    model = torch_model(cfg_t, params, stats)
    w = model.frontend.resnet1d.stem_conv.weight
    assert w.shape == (WIDTH, 1, 80)
    kernel = params["frontend"]["resnet1d"]["stem_conv"]["kernel"]     # [80, 1, WIDTH]
    np.testing.assert_array_equal(w.detach().numpy(), kernel.transpose(2, 1, 0))
    back = to_flax(model.state_dict())
    for tree, got in zip((params, stats), back):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(tree)
        for (path, a), g in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(g, a, err_msg=jax.tree_util.keystr(path))


def test_audio_preset_builds_and_takes_waveforms():
    """build_model takes lrs3_audio_config() (here with its Conformer and
    decoder cut to one layer) on the CPU when asked; create_train_state
    takes a [B, S] waveform batch and refuses a video one."""
    from syncvsr_tpu_torch.config import lrs3_audio_config

    cfg = lrs3_audio_config().override(**{"model.encoder.layers": 1,
                                          "model.decoder.layers": 1})
    model = build_model(cfg, device="cpu")
    assert model.frontend.out_dim == 512 and len(model.frontend.resnet1d.names) == 8
    batch = {"videos": torch.zeros(1, 1280), "lengths": torch.tensor([1280])}
    create_train_state(cfg, model, batch, device="cpu")
    with pytest.raises(ValueError, match=r"\[B, S\] or \[B, S, 1\]"):
        create_train_state(cfg, model, dict(batch, videos=torch.zeros(1, 2, 8, 8, 1)),
                           device="cpu")

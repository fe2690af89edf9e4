"""PyTorch port: the lrs3 sentence-level train step (length-aware
augmentation, forward, backward, clipped AdamW, BatchNorm running stats)
against the JAX package's, from bridged weights, on the CPU; the sentence
augmentation and eval transform. f32, dropout 0; the augmentation's draws
come from one fixed JAX key and are injected into the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.engine import build_train_step as jax_build_train_step
from syncvsr_tpu.engine import create_train_state as jax_create_train_state
from syncvsr_tpu.models import build_model as jax_build_model
from syncvsr_tpu.ops.image import build_sentence_eval_transform as jax_eval_transform
from syncvsr_tpu.ops.image import fused_train_aug
from syncvsr_tpu_torch.data.synthetic import sentence_batch
from syncvsr_tpu_torch.engine import build_eval_step, build_train_step, create_train_state
from syncvsr_tpu_torch.ops.image import (
    build_sentence_aug,
    build_sentence_eval_transform,
    fused_train_aug_apply,
    sample_train_aug,
)
from syncvsr_tpu_torch.utils.bridge import to_flax
from test_torch_step import _adam_moments
from torch_f64_frames import f64_casts, flat, jax_f64_step
from torch_parity import (
    JitInit,
    close,
    jax_aug_sample,
    sentence_configs,
    to_np,
    torch_model,
    tt,
)
import torch_threads  # noqa: F401  (one torch thread a test process)

AUG_KEY = jax.random.PRNGKey(11)
METRICS = ("loss", "loss_ctc", "loss_att", "loss_audio", "learning_rate", "grad_norm")
FRAMES, SRC = 10, 20
# test_torch_step's tolerances were set at lrw_video's peak rate, 1e-4; at
# lrs3's 1e-3 Adam's first full-rate update (each element moves by ~lr
# whatever its gradient's size) turns f32 noise in the smallest gradients
# into differences ten times larger
LR = 1e-4


def _compare(got, want, rtol, atol_rel, what):
    """Each leaf within ``rtol`` and ``atol_rel`` of its largest element,
    plus 1e-7 of the whole tree's largest element: the leaves whose true
    gradient is zero (every attention's key bias, which the softmax over
    keys cancels, and the depthwise conv's bias, which the BatchNorm after it
    cancels) hold only f32 noise, ~1e-10 against moments of ~1e-2."""
    leaves = jax.tree_util.tree_leaves_with_path(want)
    floor = 1e-7 * max(float(np.abs(w).max()) for _, w in leaves)
    got_leaves = jax.tree_util.tree_leaves(got)
    assert len(got_leaves) == len(leaves)
    for (path, w), g in zip(leaves, got_leaves):
        close(g, w, rtol, atol_rel * float(np.abs(w).max()) + floor,
              what + jax.tree_util.keystr(path))


def _jax_sentence_aug(d, key=AUG_KEY, dtype=jnp.bfloat16):
    def aug(rng, bt):   # the fixed key replaces the step's aug stream
        return dict(bt, videos=fused_train_aug(
            key, bt["videos"], d.crop_size, (0.7, 1.0), hflip_prob=0.5, time_mask_span=10,
            time_mask_n=2, mean=d.mean, std=d.std, lengths=bt["lengths"], dtype=dtype))
    return aug


def _uint8_batch(cfg_t, seed=0):
    batch = sentence_batch(cfg_t, num_frames=FRAMES, label_len=3, seed=seed)
    b = cfg_t.data.batch_size
    rng = np.random.RandomState(seed + 100)
    batch["videos"] = rng.randint(0, 256, (b, FRAMES, SRC, SRC, 1)).astype(np.uint8)
    return batch


@pytest.fixture(scope="module")
def runs():
    """Three steps in each framework; snapshots after steps 1 and 3."""
    cfg_j, cfg_t = sentence_configs(**{"optim.lr": LR})
    batch = _uint8_batch(cfg_t)
    b, t, h, w, _ = batch["videos"].shape
    drawn = jax_aug_sample(AUG_KEY, b, t, h, w, cfg_t.data, sentence=True,
                           lengths=batch["lengths"])

    # the clips stay f32, like the model: no bf16 rounding of the inputs that
    # the two libraries may place on either side of a tie
    def torch_aug(gen, bt):
        return dict(bt, videos=fused_train_aug_apply(
            bt["videos"], drawn, cfg_t.data.crop_size, cfg_t.data.mean, cfg_t.data.std,
            torch.float32))

    model_j = jax_build_model(cfg_j)
    s = cfg_j.data.crop_size
    init = dict(batch, videos=np.zeros((b, t, s, s, 1), np.float32))
    state_j = jax_create_train_state(cfg_j, JitInit(model_j),
                                     {k: jnp.asarray(v) for k, v in init.items()})
    model = torch_model(cfg_t, to_np(state_j.params), to_np(state_j.batch_stats))
    state = create_train_state(cfg_t, model, batch, device="cpu")

    step_j = jax_build_train_step(donate=False,
                                  aug_fn=_jax_sentence_aug(cfg_j.data, dtype=jnp.float32))
    step = build_train_step(aug_fn=torch_aug)
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
                "torch": {
                    "params": to_flax(model.state_dict())[0],
                    "mu": to_flax(dict(zip(state.names, state.mu)))[0],
                    "nu": to_flax(dict(zip(state.names, state.nu)))[0],
                    "batch_stats": to_flax(model.state_dict())[1],
                    "metrics": {k: float(m[k]) for k in METRICS}},
                "lr_sum": lr_sum,
            }
    eval_batch = build_sentence_eval_transform(cfg_t.data)(tb)
    eval_out = build_eval_step()(state, eval_batch)
    return snaps, eval_out


@pytest.mark.parametrize("n_steps", [1, 3])
def test_sentence_train_steps_match_jax(runs, n_steps):
    """Params, Adam moments and batch_stats to a small share of each leaf's
    scale, with test_torch_step's tolerances and reasons (f32 sums in other
    orders through 32 BatchNorm backwards; the parameters of near-zero
    gradients drift by up to the learning rate)."""
    snap = runs[0][n_steps]
    j, t = snap["jax"], snap["torch"]
    for k in METRICS:
        close(t["metrics"][k], j["metrics"][k], 1e-4, 1e-7, k)
    _compare(t["batch_stats"], j["batch_stats"], 1e-4, 1e-5, "batch_stats")
    _compare(t["mu"], j["mu"], 1e-3, 5e-4, "mu")
    _compare(t["nu"], j["nu"], 1e-3, 1e-3, "nu")
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(j["params"]),
                            jax.tree_util.tree_leaves(t["params"])):
        close(g, w, 1e-4, 1e-4 * float(np.abs(w).max()) + 0.05 * snap["lr_sum"],
              "params" + jax.tree_util.keystr(path))


def test_sentence_schedule_and_eval(runs):
    snaps, eval_out = runs
    # warmup 2 of 10 steps: step 1 uses init_lr, step 3 the peak rate
    assert snaps[1]["torch"]["metrics"]["learning_rate"] == pytest.approx(1e-6, rel=1e-5)
    assert snaps[3]["torch"]["metrics"]["learning_rate"] == pytest.approx(LR, rel=1e-6)
    assert all(np.isfinite(float(v)) for v in eval_out.values())
    assert {"_tokens", "_slots"} <= set(eval_out)


@pytest.mark.parametrize("seed", [0, 1])
def test_sentence_aug_apply_matches_jax(seed):
    """The sentence recipe's draws (scale 0.7-1.0, two masks bounded by each
    clip's length) replayed into the port's apply part: one bf16 rounding
    step apart."""
    _, cfg_t = sentence_configs()
    rng = np.random.RandomState(seed)
    b, t = 3, 12
    videos = rng.randint(0, 256, (b, t, SRC, SRC + 4, 1)).astype(np.uint8)
    lengths = np.array([12, 6, 3], np.int32)
    key = jax.random.PRNGKey(20 + seed)
    want = _jax_sentence_aug(cfg_t.data, key)(None, {"videos": jnp.asarray(videos),
                                                    "lengths": jnp.asarray(lengths)})["videos"]
    p = jax_aug_sample(key, b, t, SRC, SRC + 4, cfg_t.data, sentence=True, lengths=lengths)
    got = fused_train_aug_apply(tt(videos), p, cfg_t.data.crop_size, cfg_t.data.mean,
                                cfg_t.data.std)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    close(got, np.asarray(want.astype(jnp.float32)), 8e-3, 8e-3)


def test_sentence_aug_masks_stay_inside_each_clip():
    """The port's own sampling: every time mask starts before the clip's
    length, and the aug_fn returns normalised bf16 clips at the crop size."""
    _, cfg_t = sentence_configs()
    gen = torch.Generator().manual_seed(0)
    lengths = torch.tensor([30, 12, 11, 1])
    for _ in range(20):
        p = sample_train_aug(gen, 4, 30, SRC, SRC, (0.7, 1.0), time_mask_span=10,
                             time_mask_n=2, lengths=lengths)
        first = torch.where(p["hit"].any(1), p["hit"].float().argmax(1), torch.zeros(4).long())
        assert bool((first < torch.clamp(lengths - 0, min=1)).all())
    batch = {"videos": torch.randint(0, 256, (4, 30, SRC, SRC, 1), dtype=torch.uint8),
             "lengths": lengths}
    out = build_sentence_aug(cfg_t.data)(gen, batch)["videos"]
    assert out.shape == (4, 30, cfg_t.data.crop_size, cfg_t.data.crop_size, 1)
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("dataset", ["lrs3", "lrs2"])
def test_sentence_eval_transform_matches_jax(dataset):
    cfg_j, cfg_t = sentence_configs()
    videos = np.random.RandomState(4).randint(0, 256, (2, 3, SRC, SRC, 1)).astype(np.uint8)
    want = jax_eval_transform(cfg_j.data, dataset)({"videos": jnp.asarray(videos)})["videos"]
    got = build_sentence_eval_transform(cfg_t.data, dataset)({"videos": tt(videos)})["videos"]
    close(got, want, 1e-5, 1e-5)


# One step at 16 frames, the seq test's inputs (clips of 16 and 11 frames):
# the JAX package's f32 step lands up to 7.45e-5 from the float64 answer
# in the stem's first moment, the port's f32 step 1.8e-7; the port's and
# the JAX package's float64 steps agree to 4e-16. At 10, 12 and 14 frames
# JAX's f32 step is at most 1.48e-6 from the float64 answer in the
# moments, and 1.6e-7 and 2.2e-5 (relative) in the loss and gradient norm
# (tests/torch_f64_frames.py prints the table; ROADMAP.md §3). So the
# port's f32 step is held to the float64 answer at JAX's own distance over
# 10-14 frames, and the port's float64 step to JAX's float64 step.
F64_FRAMES = 16
F64_ATOL = 2e-6
F64_RTOL = {"loss": 1e-6, "grad_norm": 3e-5}
X64_ATOL = 1e-12


def test_sentence_step_f32_matches_f64_at_16_frames(monkeypatch):
    """The port's f32 step against the same step in float64 (the model,
    the augmented clips and every intermediate), one step from the same
    weights: the first moment (0.1 x the clipped gradient), the second and
    the parameters within ``F64_ATOL``, the loss and gradient norm within
    ``F64_RTOL``.
    The float64 answer is the JAX package's too: its float64 step from the
    same weights and clips gives the same moments, parameters and metrics
    within ``X64_ATOL``."""
    from syncvsr_tpu_torch.models import build_model

    cfg_j, cfg = sentence_configs(**{"optim.lr": LR})
    batch = sentence_batch(cfg, num_frames=F64_FRAMES, label_len=3, seed=0)
    b = cfg.data.batch_size
    batch["videos"] = np.random.RandomState(100).randint(
        0, 256, (b, F64_FRAMES, SRC, SRC, 1)).astype(np.uint8)
    batch["lengths"] = np.array([F64_FRAMES, 11], np.int32)
    drawn = jax_aug_sample(AUG_KEY, b, F64_FRAMES, SRC, SRC, cfg.data, sentence=True,
                           lengths=batch["lengths"])
    torch.manual_seed(0)
    weights = build_model(cfg, device="cpu").state_dict()
    out = {}
    for dtype in (torch.float32, torch.float64):
        c = cfg.override(**{"model.dtype": str(dtype).split(".")[1]})
        model = build_model(c, device="cpu")
        model.load_state_dict(weights)
        if dtype == torch.float64:
            model = model.double()
            f64_casts(monkeypatch)
        tb = {k: tt(v) for k, v in batch.items()}

        def aug(gen, bt, c=c, dtype=dtype):
            return dict(bt, videos=fused_train_aug_apply(
                bt["videos"], drawn, c.data.crop_size, c.data.mean, c.data.std, dtype))

        if dtype == torch.float64:
            clips = aug(None, tb)["videos"].numpy()
        state = create_train_state(c, model, tb, device="cpu")
        state, m = build_train_step(aug_fn=aug)(state, tb)
        out[dtype] = ({"mu": [x.double() for x in state.mu],
                       "nu": [x.double() for x in state.nu],
                       "params": [p.detach().double() for p in state.params]},
                      {k: float(m[k]) for k in ("loss", "grad_norm")}, state.names)
        monkeypatch.undo()
    (got, m32, names), (want, m64, _) = out[torch.float32], out[torch.float64]
    for k in m64:
        close(m32[k], m64[k], F64_RTOL[k], 0, k)
    for key in ("mu", "nu", "params"):
        for name, g, w in zip(names, got[key], want[key]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=F64_ATOL,
                                       err_msg=f"{key} {name}")
    jax64 = jax_f64_step(cfg_j, *to_flax(weights), dict(batch, videos=clips))
    for k in m64:
        np.testing.assert_allclose(jax64["metrics"][k], m64[k], rtol=1e-12, err_msg=k)
    for key in ("mu", "nu", "params"):
        mine = flat(to_flax(dict(zip(names, want[key])))[0])
        assert mine.keys() == jax64[key].keys()
        for name, w in mine.items():
            np.testing.assert_allclose(jax64[key][name], w, rtol=0, atol=X64_ATOL,
                                       err_msg=f"jax f64 {key} {name}")

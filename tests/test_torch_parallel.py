"""PyTorch port: data-parallel training over two processes (gloo on the
CPU) against the JAX package's step on a two-device mesh, from bridged
weights, and against the port's own one-process step; the shared helpers
of the other two-process tests (``test_torch_parallel_sentence.py``,
``test_torch_parallel_cli.py``, ``test_torch_fsdp.py``).

Each case gives the shards unequal denominators or partners across the
shard boundary, so a per-replica mean or partner would differ. Here
``lrw_video``: rank 0 holds the zero-weight rows and the masked sync
slots, and CutMix swaps with the globally flipped batch. f32, dropout 0,
the draws injected on both sides. The tolerances: against the one-process
port step, ``tests/test_spmd.py``'s (loss rtol 1e-5; params rtol 1e-4 and
atol 1e-6, and the moments likewise); against JAX, the port's
single-device parity tests' for the same model (``test_torch_step.py``,
``test_torch_sentence_step.py``, ``test_torch_dctcn.py``), whose reasons
(f32 sums through the BatchNorm backwards in another order) hold at any
world size; and the two ranks bitwise equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import syncvsr_tpu.models.word as jword
from syncvsr_tpu.engine import build_train_step as jax_build_train_step
from syncvsr_tpu.engine import create_train_state as jax_create_train_state
from syncvsr_tpu.models import build_model as jax_build_model
from syncvsr_tpu.ops.image import fused_train_aug
from syncvsr_tpu.parallel import create_mesh as jax_create_mesh
from syncvsr_tpu.parallel import shard_batch as jax_shard_batch
from syncvsr_tpu.parallel import shard_state as jax_shard_state
from syncvsr_tpu_torch import evaluate as tevaluate
from syncvsr_tpu_torch.models import build_model
from syncvsr_tpu_torch.ops.image import sample_train_aug
from syncvsr_tpu_torch.parallel import create_mesh, host_local_batch, shard_batch
from syncvsr_tpu_torch.utils.bridge import to_flax
from test_torch_step import _adam_moments
from torch_multiproc import spawn, train_steps
from torch_parity import (
    JitInit,
    close,
    configs,
    jax_aug_sample,
    replicated,
    to_np,
    uint8_batch,
)
import torch_threads  # noqa: F401  (one torch thread a test process)

STEPS = 3
# seconds for the file's two-process group: 3x the most measured (15.7 s), at least 60
SPAWN_TIMEOUT = 60
RATIO, START = 0.4, 0.2     # the CutMix draw both packages are given
AUG_KEY = jax.random.PRNGKey(7)


def _fixed_cutmix(rng, inputs, labels, audio_tokens, word_mask=None, alpha=1.0):
    """``syncvsr_tpu.ops.cutmix.temporal_cutmix`` with the test's draw."""
    t = inputs.shape[1]
    grid = jnp.linspace(0.0, 1.0, t)
    keep = ~((np.float32(START) < grid) & (grid <= np.float32(START) + np.float32(RATIO)))
    lam = keep.mean()
    audio_keep = jnp.repeat(keep, audio_tokens.shape[1] // t, axis=0)
    kshape = (1, t) + (1,) * (inputs.ndim - 2)
    flip = functools.partial(jnp.flip, axis=0)
    inputs = jnp.where(keep.reshape(kshape), inputs, flip(inputs))
    labels = lam * labels + (1.0 - lam) * flip(labels)
    audio_tokens = jnp.where(audio_keep[None, :, None], audio_tokens, flip(audio_tokens))
    if word_mask is not None:
        word_mask = lam * word_mask + (1.0 - lam) * flip(word_mask)
    return inputs, labels, audio_tokens, word_mask


def jax_mesh_steps(cfg_j, batch, init, aug_fn=None, fsdp=None, steps=STEPS):
    """``steps`` JAX train steps on a two-device mesh (``fsdp``: the
    min size of ``shard_state``'s ZeRO split); the initial variables as
    numpy trees and the state after, as the port's workers report it."""
    model = jax_build_model(cfg_j)
    state = jax_create_train_state(cfg_j, JitInit(model),
                                   {k: jnp.asarray(v) for k, v in init.items()})
    params, stats = to_np(state.params), to_np(state.batch_stats)
    mesh = jax_create_mesh(data=2, devices=jax.devices()[:2])
    state = (jax_shard_state(mesh, state, fsdp=True, fsdp_min_size=fsdp) if fsdp
             else replicated(mesh, state))
    step = jax_build_train_step(mesh, donate=False, aug_fn=aug_fn, fsdp=bool(fsdp))
    def snapshot(state):
        mu, nu = _adam_moments(state.opt_state)
        return {"params": to_np(state.params), "mu": to_np(mu), "nu": to_np(nu),
                "batch_stats": to_np(state.batch_stats)}

    metrics, first = [], None
    for i in range(steps):
        state, m = step(state, jax_shard_batch(mesh, batch))
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            first = snapshot(state)
    return params, stats, dict(snapshot(state), metrics=metrics, first=first)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def assert_ranks_equal(outs):
    """Every rank ends with the same parameters, statistics and moments,
    bitwise."""
    for key in ("params", "batch_stats", "mu", "nu"):
        for (path, a), b in zip(_leaves(outs[0][key]), jax.tree_util.tree_leaves(outs[1][key])):
            np.testing.assert_array_equal(a, b, err_msg=key + jax.tree_util.keystr(path))
    assert outs[0]["metrics"] == outs[1]["metrics"]


def assert_spmd_close(got, want, metrics):
    """``tests/test_spmd.py``'s tolerances: each step's metrics rtol 1e-5
    (atol 1e-7), every element of the params, statistics and moments rtol
    1e-4, atol 1e-6."""
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k in metrics:
            close(g[k], w[k], 1e-5, 1e-7, f"step {i + 1} {k}")
    for key in ("params", "batch_stats", "mu", "nu"):
        leaves = _leaves(want[key])
        assert len(leaves) == len(jax.tree_util.tree_leaves(got[key]))
        for (path, w), g in zip(leaves, jax.tree_util.tree_leaves(got[key])):
            close(g, w, 1e-4, 1e-6, key + jax.tree_util.keystr(path))


def assert_jax_close(got, want, metrics, lr_sum, floor=0.0, later_norm=1e-4,
                     rate_share=0.05):
    """The single-device parity tests' tolerances against JAX: metrics 1e-4
    (``later_norm`` for the grad norm after the first update), and after
    the first step batch_stats 1e-4 / 1e-5 of the leaf's scale, mu 1e-3 /
    5e-4, nu 1e-3 / 1e-3 (``floor``, a share of the tree's largest element,
    for trees whose true-zero gradients hold only noise); after the last,
    params 1e-4 + 1e-4 of the scale + ``rate_share`` of the summed rates
    (the sign of Adam's update on a gradient at f32's noise floor). The moments are held
    after one step: each later update moves the parameters of near-zero
    gradients by up to the rate either way, and the next gradients with
    them, in either package."""
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k in metrics:
            rtol = later_norm if i and k == "grad_norm" else 1e-4
            close(g[k], w[k], rtol, 1e-7, f"step {i + 1} {k}")
    for key, rtol, atol in (("batch_stats", 1e-4, 1e-5), ("mu", 1e-3, 5e-4),
                            ("nu", 1e-3, 1e-3)):
        leaves = _leaves(want["first"][key])
        top = floor * max(float(np.abs(w).max()) for _, w in leaves) if leaves else 0.0
        for (path, w), g in zip(leaves, jax.tree_util.tree_leaves(got["first"][key])):
            close(g, w, rtol, atol * float(np.abs(w).max()) + top + 1e-12,
                  key + jax.tree_util.keystr(path))
    for (path, w), g in zip(_leaves(want["params"]), jax.tree_util.tree_leaves(got["params"])):
        close(g, w, 1e-4, 1e-4 * float(np.abs(w).max()) + rate_share * lr_sum,
              "params" + jax.tree_util.keystr(path))


# --- lrw_video ------------------------------------------------------------

WORD_METRICS = ("loss", "loss_word", "loss_audio", "acc1", "acc5", "learning_rate",
                "grad_norm")
SENTENCE_METRICS = ("loss", "loss_ctc", "loss_att", "loss_audio", "decoder_acc",
                    "learning_rate", "grad_norm")


def word_case():
    """The tiny lrw_video model, a global batch of 4 (2 a rank), CutMix on:
    rank 0's rows 0 and 1 have weights 0 and 1 and row 1 has masked sync
    slots; rank 1's rows are whole."""
    cfg_j, cfg_t = configs(**{"data.batch_size": 4, "data.use_cutmix": True})
    batch = uint8_batch(cfg_t)
    batch["sample_weight"] = np.array([0.0, 1.0, 1.0, 1.0], np.float32)
    batch["audio_tokens"][1, :5] = -1
    b, t, h, w, _ = batch["inputs"].shape
    d = cfg_j.data
    drawn = {k: v.numpy() for k, v in jax_aug_sample(AUG_KEY, b, t, h, w, cfg_t.data).items()}

    def jax_aug(rng, bt):
        return dict(bt, inputs=fused_train_aug(
            AUG_KEY, bt["inputs"], d.crop_size, d.rrc_scale, hflip_prob=d.hflip_prob,
            time_mask_span=d.time_mask_window, time_mask_n=d.time_mask_stride,
            mean=d.mean, std=d.std))

    init = dict(batch, inputs=np.zeros((b, t, h, h, 1), np.float32))
    return cfg_j, cfg_t, batch, init, jax_aug, drawn


def dropout_job():
    """The preset's dropout on, from the port's own initial weights."""
    _, cfg_t = configs(**{"data.batch_size": 4, "model.encoder.mlp_dropout": 0.1,
                          "model.encoder.msa_dropout": 0.1, "model.encoder.emb_dropout": 0.1})
    params, stats = to_flax(build_model(cfg_t, device="cpu").state_dict())
    batch = uint8_batch(cfg_t)
    b, t, h = batch["inputs"].shape[:3]
    drawn = {k: v.numpy() for k, v in jax_aug_sample(AUG_KEY, b, t, h, h + 4,
                                                      cfg_t.data).items()}
    return {"kind": "train", "config": cfg_t.to_dict(), "params": params,
            "batch_stats": stats, "batch": batch, "steps": STEPS, "aug": drawn}


@pytest.fixture(scope="module")
def two_process_runs(tmp_path_factory):
    """The word case and the dropout case, in one two-process group."""
    cfg_j, cfg_t, batch, init, jax_aug, drawn = word_case()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jword, "temporal_cutmix", _fixed_cutmix)
        params, stats, want = jax_mesh_steps(cfg_j, batch, init, jax_aug)
    job = {"kind": "train", "config": cfg_t.to_dict(), "params": params,
           "batch_stats": stats, "batch": batch, "steps": STEPS, "aug": drawn,
           "cutmix": (RATIO, START)}
    one = train_steps(job)
    two, dropout = spawn([job, dropout_job()], 2, tmp_path_factory.mktemp("word"),
                         timeout=SPAWN_TIMEOUT)
    return {"word": (want, one, two, job), "dropout": dropout}


def test_word_dp_step_matches_one_process_and_jax(two_process_runs):
    want, one, two, _ = two_process_runs["word"]
    assert_ranks_equal(two)
    assert_spmd_close(two[0], one, WORD_METRICS)
    lr_sum = sum(m["learning_rate"] for m in want["metrics"])
    assert_jax_close(two[0], want, WORD_METRICS, lr_sum)


def test_word_dp_shards_need_global_means(two_process_runs):
    """The case has teeth: rank 0's rows alone, with their own flip
    partners and means, give another loss and gradient."""
    want, _, _, job = two_process_runs["word"]
    half = dict(job, steps=1, batch={k: v[:2] for k, v in job["batch"].items()},
                aug={k: v[:2] for k, v in job["aug"].items()})
    local = train_steps(half)["metrics"][0]
    for k in ("loss", "grad_norm"):
        assert abs(local[k] - want["metrics"][0][k]) > 1e-3 * abs(want["metrics"][0][k])


# --- dropout, draws, mesh ----------------------------------------------------

def test_dropout_streams_differ_but_ranks_stay_in_sync(two_process_runs):
    """The preset's dropout on (``dropout_job``): each rank draws its own
    masks, and the ranks still end with bitwise-equal parameters,
    statistics and moments."""
    two = two_process_runs["dropout"]
    assert_ranks_equal(two)
    assert two[0]["dropout_draw"] != two[1]["dropout_draw"]


@pytest.mark.parametrize("sentence", [False, True])
def test_aug_draws_are_the_global_batch_rows(sentence):
    """Each rank's draws are its rows of the draws for the global batch,
    so a clip is augmented alike at any world size."""
    lengths = torch.tensor([9, 3, 12, 5, 7, 1]) if sentence else None
    kw = dict(time_mask_span=4, time_mask_n=2)
    whole = sample_train_aug(torch.Generator().manual_seed(3), 6, 12, 20, 24,
                             lengths=lengths, **kw)
    for rank in range(3):
        rows = slice(2 * rank, 2 * rank + 2)
        part = sample_train_aug(torch.Generator().manual_seed(3), 2, 12, 20, 24,
                                lengths=None if lengths is None else lengths[rows],
                                shard=(rank, 3), **kw)
        for k, v in whole.items():
            assert torch.equal(part[k], v[rows]), k


def test_mesh_checks(capsys):
    mesh = create_mesh(device="cpu")
    assert (mesh.size, mesh.rank) == (1, 0)
    assert create_mesh(data=1, device="cpu") == mesh
    with pytest.raises(ValueError, match="mesh 2x1x1 != 1 processes"):
        create_mesh(data=2, device="cpu")
    with pytest.raises(ValueError, match="mesh 1x1x2 != 1 processes"):
        create_mesh(model=2, device="cpu")   # tensor parallel needs a model axis's ranks
    with pytest.raises(ValueError, match="mesh 1x4x1 != 1 processes"):
        create_mesh(device="cpu", seq=4)   # sequence parallel needs a seq axis's ranks
    assert host_local_batch(8, mesh) == 8
    two = mesh.__class__(size=2, rank=1, device=torch.device("cpu"))
    assert host_local_batch(8, two) == 4
    with pytest.raises(ValueError, match="does not split"):
        host_local_batch(7, two)
    rows = shard_batch(two, {"x": np.arange(8), "y": torch.arange(16).view(8, 2)})
    assert rows["x"].tolist() == [4, 5, 6, 7] and rows["y"][:, 0].tolist() == [8, 10, 12, 14]
    # evaluate decodes unsharded where the mesh config does not fit, as JAX's does
    cfg = tevaluate.PRESETS["lrs3"]().override(**{"mesh.data": 8})
    assert tevaluate.eval_mesh(cfg, torch.device("cpu")).size == 1
    assert "eval: mesh config unusable here (mesh 8x1x1 != 1 processes); decoding " \
           "unsharded" in capsys.readouterr().err

"""PyTorch port: data-parallel training of the sentence model and the
DC-TCN over two gloo processes on the CPU, against the JAX package's step
on a two-device mesh and the port's one-process step, with
``test_torch_parallel.py``'s helpers and tolerances: ``lrs3`` with unequal
label lengths across the shards (CTC, the decoder's KL and accuracy, 32
BatchNorms), and the DC-TCN, whose mixup roll crosses the shard
boundary."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import syncvsr_tpu.models.word as jword
from syncvsr_tpu.models import dense_tcn as jdt
from test_torch_dctcn import LAM, _batch as dctcn_batch, _fixed_mixup, dctcn_configs
from test_torch_parallel import (
    AUG_KEY,
    SENTENCE_METRICS,
    STEPS,
    _leaves,
    assert_jax_close,
    assert_ranks_equal,
    assert_spmd_close,
    jax_mesh_steps,
)
from test_torch_sentence_step import FRAMES, _jax_sentence_aug, _uint8_batch
from torch_multiproc import spawn, train_steps
from torch_parity import close, jax_aug_sample, sentence_configs
import torch_threads  # noqa: F401  (one torch thread a test process)

# seconds for the file's two-process group: 3x the most measured (6.1 s), at least 60
SPAWN_TIMEOUT = 60


def sentence_case():
    """The tiny lrs3 model at lr 1e-4 (``test_torch_sentence_step``'s), a
    global batch of 4: rank 0's clips carry 1 and 3 labels and one short
    clip, rank 1's 3 and 2. The JAX steps, the job and one process's run."""
    cfg_j, cfg_t = sentence_configs(**{"optim.lr": 1e-4, "data.batch_size": 4})
    batch = _uint8_batch(cfg_t)
    batch["labels"][0, 1:] = -1
    batch["labels"][3, 2:] = -1
    batch["lengths"] = np.array([FRAMES, 7, FRAMES, FRAMES - 1], np.int32)
    b, t, h, w, _ = batch["videos"].shape
    drawn = {k: v.numpy() for k, v in jax_aug_sample(
        AUG_KEY, b, t, h, w, cfg_t.data, sentence=True, lengths=batch["lengths"]).items()}
    s = cfg_j.data.crop_size
    init = dict(batch, videos=np.zeros((b, t, s, s, 1), np.float32))
    params, stats, want = jax_mesh_steps(
        cfg_j, batch, init, _jax_sentence_aug(cfg_j.data, AUG_KEY, jnp.float32))
    job = {"kind": "train", "config": cfg_t.to_dict(), "params": params,
           "batch_stats": stats, "batch": batch, "steps": STEPS, "aug": drawn,
           "aug_dtype": "float32"}
    return want, train_steps(job), job


def dctcn_case():
    """The tiny DC-TCN with mixup (lambda injected, the DenseTCN's dropout 0
    on both sides), a global batch of 4: the JAX step, the job and one
    process's run."""
    cfg_j, cfg_t = dctcn_configs()
    batch = dctcn_batch(cfg_t)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jword, "DenseTCN", functools.partial(jdt.DenseTCN, dropout=0.0))
        mp.setattr(jword, "batch_mixup", _fixed_mixup)
        params, stats, want = jax_mesh_steps(cfg_j, batch, batch, steps=1)
    job = {"kind": "train", "config": cfg_t.to_dict(), "params": params,
           "batch_stats": stats, "batch": batch, "steps": 1, "lam": LAM,
           "no_dropout": True}
    return want, train_steps(job), job


@pytest.fixture(scope="module")
def two_process_runs(tmp_path_factory):
    """Both cases' references, and their two-process runs in one group."""
    cases = {"sentence": sentence_case(), "dctcn": dctcn_case()}
    outs = spawn([job for _, _, job in cases.values()], 2,
                 tmp_path_factory.mktemp("sentence"), timeout=SPAWN_TIMEOUT)
    return {name: (want, one, two) for (name, (want, one, _)), two in zip(cases.items(), outs)}


# --- lrs3 -----------------------------------------------------------------

def test_sentence_dp_step_matches_one_process_and_jax(two_process_runs):
    want, one, two = two_process_runs["sentence"]
    assert_ranks_equal(two)
    assert_spmd_close(two[0], one, SENTENCE_METRICS)
    lr_sum = sum(m["learning_rate"] for m in want["metrics"])
    # the sentence test's floor: 1e-7 of the tree's largest element, for
    # the leaves whose true gradient is 0. Adam's first update moves the
    # parameters of near-zero gradients by up to the rate, either way, and
    # the grad norm of the next steps follows: on this batch the port's
    # one-process step and JAX's one-device step differ by 1.8e-4 at step 2,
    # as the two-process and two-device steps do; such a parameter may end
    # up to twice the summed rates away (test_torch_dctcn.py's bound)
    assert_jax_close(two[0], want, SENTENCE_METRICS, lr_sum, floor=1e-7, later_norm=1e-3,
                     rate_share=2.0)


# --- the DC-TCN ------------------------------------------------------------

DCTCN_METRICS = ("loss", "loss_word", "loss_audio", "learning_rate", "grad_norm")


def test_dctcn_dp_step_matches_jax(two_process_runs):
    """One train step of the tiny DC-TCN (``dctcn_case``): the roll
    brings rank 1's last clip to rank 0's first row and rank 0's last to
    rank 1's first. ``test_torch_dctcn.py``'s tolerances: the conv biases
    before a train-mode BatchNorm have a true gradient of 0 and hold noise
    that Adam turns into an update of either sign up to the rate."""
    want, one, two = two_process_runs["dctcn"]
    assert_ranks_equal(two)
    assert_spmd_close(two[0], one, DCTCN_METRICS)
    lr = want["metrics"][0]["learning_rate"]
    for i, k in enumerate(DCTCN_METRICS):
        close(two[0]["metrics"][0][k], want["metrics"][0][k], 1e-4, 1e-7, k)
    for key, rtol, atol in (("batch_stats", 1e-4, 1e-5), ("mu", 1e-3, 5e-4)):
        leaves = _leaves(want[key])
        top = 1e-6 * max(float(np.abs(w).max()) for _, w in leaves)
        for (path, w), g in zip(leaves, jax.tree_util.tree_leaves(two[0][key])):
            close(g, w, rtol, atol * float(np.abs(w).max()) + top,
                  key + jax.tree_util.keystr(path))
    for (path, w), g in zip(_leaves(want["params"]),
                            jax.tree_util.tree_leaves(two[0]["params"])):
        close(g, w, 1e-4, 1e-4 * float(np.abs(w).max()) + 2 * lr,
              "params" + jax.tree_util.keystr(path))

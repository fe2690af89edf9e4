"""PyTorch port: FSDP (``mesh.fsdp``, ZeRO over ``data``) over two gloo
processes on the CPU, against the JAX package's FSDP step on a two-device
mesh and against the port's own data-parallel step: the leaf rule, the
step, the resident bytes and a checkpoint written under FSDP."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu.models import build_model as jax_build_model
from syncvsr_tpu.parallel import create_mesh as jax_create_mesh
from syncvsr_tpu.parallel import state_shardings as jax_state_shardings
from syncvsr_tpu_torch.engine import create_train_state
from syncvsr_tpu_torch.models import build_model
from syncvsr_tpu_torch.parallel import Mesh, state_shardings
from syncvsr_tpu_torch.utils import checkpoint as ckpt
from syncvsr_tpu_torch.utils.bridge import flax_leaf, from_flax, to_flax
from test_torch_parallel import (
    AUG_KEY,
    SENTENCE_METRICS,
    STEPS,
    assert_jax_close,
    assert_ranks_equal,
    assert_spmd_close,
    jax_mesh_steps,
)
from test_torch_sentence_step import FRAMES, _jax_sentence_aug, _uint8_batch
from torch_multiproc import spawn, train_steps
from torch_parity import configs, jax_aug_sample, sentence_configs, torch_model, tt, uint8_batch
import torch_threads  # noqa: F401  (one torch thread a test process)

MIN_SIZE = 256    # the JAX package's tests' fsdp_min_size at toy widths
# seconds for the file's two-process group: 3x the most measured (14.1 s), at least 60
SPAWN_TIMEOUT = 60


def _sentence_case():
    cfg_j, cfg_t = sentence_configs(**{"optim.lr": 1e-4, "data.batch_size": 4})
    batch = _uint8_batch(cfg_t)
    batch["labels"][0, 1:] = -1
    batch["lengths"] = np.array([FRAMES, 7, FRAMES, FRAMES - 1], np.int32)
    b, t, h, w, _ = batch["videos"].shape
    drawn = {k: v.numpy() for k, v in jax_aug_sample(
        AUG_KEY, b, t, h, w, cfg_t.data, sentence=True, lengths=batch["lengths"]).items()}
    s = cfg_j.data.crop_size
    init = dict(batch, videos=np.zeros((b, t, s, s, 1), np.float32))
    return cfg_j, cfg_t, batch, drawn, init


@pytest.mark.parametrize("task", ["word", "sentence"])
def test_leaf_rule_matches_jax_state_shardings(task):
    """Each parameter's spec over its flax layout, through the bridge's
    names, equals the JAX package's ``state_shardings`` at data=2 (the
    ``params`` subtree; the moments share it)."""
    if task == "word":
        cfg_j, cfg_t = configs()
        batch = uint8_batch(cfg_t)
        b, t, h = batch["inputs"].shape[:3]
        init = dict(batch, inputs=np.zeros((b, t, h, h, 1), np.float32))
    else:
        cfg_j, cfg_t, _, _, init = _sentence_case()
    # the leaves' shapes, traced without compiling
    model_j = jax_build_model(cfg_j)
    shapes = jax.eval_shape(lambda b: model_j.init(
        {"params": jax.random.PRNGKey(0), "mixup": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, **b, det=True),
        {k: jnp.asarray(v) for k, v in init.items()})["params"]
    mesh_j = jax_create_mesh(data=2, devices=jax.devices()[:2])
    want = jax_state_shardings(mesh_j, shapes, fsdp=True, fsdp_min_size=MIN_SIZE)
    want = {tuple(k.key for k in path): tuple(sh.spec) + (None,) * (leaf.ndim - len(sh.spec))
            for (path, sh), leaf in zip(jax.tree_util.tree_leaves_with_path(want),
                                        jax.tree_util.tree_leaves(shapes))}
    model = build_model(cfg_t, device="cpu")
    state = create_train_state(cfg_t, model, {k: tt(v) for k, v in init.items()},
                               device="cpu")
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)
    assert {n: tuple(p.shape) for n, p in zip(state.names, state.params)} == {
        n: a.shape for n, a in from_flax(zeros).items()}
    got = state_shardings(Mesh(size=2, rank=0, device=torch.device("cpu")), state,
                          fsdp=True, fsdp_min_size=MIN_SIZE)
    # the bridge's name of each leaf
    got = {tuple(n.split(".")[:-1]) + (flax_leaf(n, len(spec)),): spec
           for n, spec in got.items()}
    assert got == want
    assert sum("data" in v for v in got.values()) >= 10


@pytest.fixture(scope="module")
def fsdp_runs(tmp_path_factory):
    """Three steps of the tiny lrs3 model: JAX's FSDP step on two devices,
    the port's FSDP and data-parallel steps on two processes (the FSDP
    run writes a checkpoint from rank 0) and its one-process step."""
    cfg_j, cfg_t, batch, drawn, init = _sentence_case()
    params, stats, want = jax_mesh_steps(
        cfg_j, batch, init, _jax_sentence_aug(cfg_j.data, AUG_KEY, jnp.float32),
        fsdp=MIN_SIZE)
    tmp = tmp_path_factory.mktemp("fsdp")
    job = {"kind": "train", "config": cfg_t.to_dict(), "params": params,
           "batch_stats": stats, "batch": batch, "steps": STEPS, "aug": drawn,
           "aug_dtype": "float32"}
    fsdp, dp = spawn([dict(job, fsdp=MIN_SIZE, save=str(tmp / "ck")), job], 2, tmp,
                     timeout=SPAWN_TIMEOUT)
    one = train_steps(job)
    return cfg_t, init, want, fsdp, dp, one, tmp / "ck"


def test_fsdp_step_matches_dp_and_jax(fsdp_runs):
    """The FSDP step is the data-parallel step with the state at rest
    split: equal to it within ``tests/test_spmd.py``'s tolerances, and to
    JAX's FSDP step within test_torch_parallel's sentence tolerances."""
    _, _, want, fsdp, dp, one, _ = fsdp_runs
    assert_ranks_equal(fsdp)
    assert_spmd_close(fsdp[0], dp[0], SENTENCE_METRICS)
    assert_spmd_close(fsdp[0], one, SENTENCE_METRICS)
    lr_sum = sum(m["learning_rate"] for m in want["metrics"])
    assert_jax_close(fsdp[0], want, SENTENCE_METRICS, lr_sum, floor=1e-7, later_norm=1e-3,
                     rate_share=2.0)


def test_fsdp_halves_the_resident_state(fsdp_runs):
    """Each rank holds half of every split leaf's parameter and moments
    and all of the rest: its bytes are the data-parallel rank's less half
    of the split leaves'."""
    cfg_t, init, _, fsdp, dp, _, _ = fsdp_runs
    model = torch_model(cfg_t, fsdp[0]["params"], fsdp[0]["batch_stats"])
    state = create_train_state(cfg_t, model, {k: tt(v) for k, v in init.items()},
                               device="cpu")
    specs = state_shardings(Mesh(size=2, rank=0, device=torch.device("cpu")), state,
                            fsdp=True, fsdp_min_size=MIN_SIZE)
    split = sum(p.numel() * 4 for n, p in zip(state.names, state.params)
                if "data" in specs[n])
    assert split > 0.5 * sum(p.numel() * 4 for p in state.params)
    for r in range(2):
        got, full = fsdp[r]["resident"], dp[r]["resident"]
        assert got["params"] == full["params"] - split // 2
        assert got["moments"] == full["moments"] - split


def test_fsdp_checkpoint_loads_whole_at_one_process(fsdp_runs):
    """Rank 0's checkpoint of the FSDP state (every rank joined the
    gather) restores into a one-process state with every leaf equal to
    the gathered state's."""
    cfg_t, init, _, fsdp, _, _, ck = fsdp_runs
    path = ckpt.latest_checkpoint(str(ck))
    assert path and path.endswith(f"step_{STEPS}.msgpack")
    model = torch_model(cfg_t, fsdp[0]["params"], fsdp[0]["batch_stats"])
    state = create_train_state(cfg_t, model, {k: tt(v) for k, v in init.items()},
                               device="cpu")
    with torch.no_grad():
        for p in state.params:
            p.zero_()
    ckpt.restore_train_state(path, state)
    assert state.step == STEPS and state.count == STEPS
    params, stats = ckpt.state_variables(state)
    got = {"params": params, "batch_stats": stats,
           "mu": to_flax(dict(zip(state.names, state.mu)))[0],
           "nu": to_flax(dict(zip(state.names, state.nu)))[0]}
    for key, tree in got.items():
        for (path_, a), b in zip(jax.tree_util.tree_leaves_with_path(fsdp[0][key]),
                                 jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(a, b, err_msg=key + jax.tree_util.keystr(path_))

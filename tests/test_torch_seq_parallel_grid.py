"""PyTorch port: sequence parallel for the word models, and the seq axis in
a grid with the data and model axes.

* The tiny ``lrw_video`` model (Conv3D frontend, its stem's halo) with the
  port's augmentation, CutMix and dropout on, at 8 frames (split 4 + 4)
  and 7 (indivisible: the seq ranks repeat the rows), on two gloo
  processes at seq=2 against the port's one-process step: the keep mask
  covers the whole clip and each rank its frames of it.
* ``tests/test_word_model.py``'s ``tiny_landmark_config`` at 8 and 7
  frames (dropout and CutMix off: torch cannot draw JAX's) against the JAX
  package's one-device step from bridged weights.
* Four processes as (data=2, seq=2) under FSDP and as (seq=2, model=2)
  (``state_shardings`` at ``min_dim`` 16), the tiny ``lrs3`` model with
  the augmentation's draws injected, against the port's one process.
* The train and evaluate drivers with ``mesh.seq=2`` against one process.

The tolerances are ``tests/test_spmd.py``'s (loss and metrics rtol 1e-5,
the word model's grad norm after the first update 1e-4;
params, statistics and moments rtol 1e-4 and atol 1e-6, 1e-5 for the
sentence model and against JAX; a zero-gradient conv bias within the
summed rates, as ``tests/test_torch_tensor_parallel_models.py`` holds
it); every rank ends bitwise alike."""

import json

import pytest

from syncvsr_tpu.data.synthetic import word_batch
from syncvsr_tpu_torch import config as tcfg
from test_torch_parallel import AUG_KEY, SENTENCE_METRICS, WORD_METRICS, assert_ranks_equal
from test_torch_parallel_cli import SENT_ARGS, WORD_ARGS
from test_torch_seq_parallel_sentence import _uint8_clips, assert_steps_close, jax_steps
from test_torch_tensor_parallel_grid import LANDMARK_METRICS, MIN_SIZE, NO_DRAWS
from test_torch_tensor_parallel_models import MIN_DIM, assert_tp_close
from test_word_model import tiny_landmark_config
from torch_multiproc import cli, spawn, train_steps
from torch_parity import close, configs, jax_aug_sample, sentence_configs, uint8_batch
import torch_threads  # noqa: F401  (one torch thread a test process)

STEPS = 2
# seconds for the file's two-process group: 3x the most measured (11.1 s), at least 60
SPAWN_TIMEOUT = 60
# seconds for the file's four-process group: 3x the most measured (17.5 s), at least 60
GRID_TIMEOUT = 60
DROPOUT = {"model.encoder.emb_dropout": 0.1, "model.encoder.msa_dropout": 0.1,
           "model.encoder.mlp_dropout": 0.1}


def word_cases():
    """The video word model (port draws) and the landmark one (JAX
    reference) at 8 and 7 frames: the two-process jobs and their
    references."""
    jobs, refs = [], []
    for frames in (8, 7):
        _, cfg = configs(**{"data.batch_size": 4, "data.num_frames": frames,
                            "data.use_cutmix": True, **DROPOUT})
        batch = uint8_batch(cfg)
        job = {"kind": "train", "config": cfg.to_dict(), "params": None,
               "batch_stats": None, "batch": batch, "steps": STEPS, "port_aug": True,
               "seq": 2}
        job["params"], job["batch_stats"] = _fresh_variables(cfg)
        jobs.append(job)
        refs.append(train_steps(job))
    for frames in (8, 7):
        cfg_j = tiny_landmark_config().override(**NO_DRAWS, **{"data.num_frames": frames})
        batch = word_batch(cfg_j)
        params, stats, want = jax_steps(cfg_j, batch, batch)
        jobs.append({"kind": "train", "config": tcfg.Config.from_dict(cfg_j.to_dict()).to_dict(),
                     "params": params, "batch_stats": stats, "batch": batch, "steps": STEPS,
                     "seq": 2})
        refs.append(want)
    return jobs, refs


DRIVER_RUNS = {"train": "train", "greedy": "evaluate", "word": "evaluate"}


def driver_cases(tmp_path):
    """The drivers' runs at one process (here; their summaries) and their
    ``mesh.seq=2`` jobs, each in a working directory of its own."""
    train_args = SENT_ARGS + ["optim.total_steps=3", "optim.lr=1e-3", "train.log_every=3",
                              "train.eval_every=3", "train.ckpt_every=3",
                              "model.encoder.mlp_dropout=0.0",
                              "model.encoder.msa_dropout=0.0", "model.decoder.dropout=0.0"]
    args_of = {"train": train_args, "greedy": SENT_ARGS + ["decode=greedy"], "word": WORD_ARGS}
    one, jobs = {}, []
    for name, module in DRIVER_RUNS.items():
        for world in ("one", "two"):
            extra = ([f"train.ckpt_dir={json.dumps(str(tmp_path / f'ck_{world}'))}"]
                     if module == "train" else [])
            cwd = tmp_path / f"{name}_{world}"
            cwd.mkdir()
            job = {"kind": "cli", "module": module, "cwd": str(cwd), "capture": True,
                   "args": args_of[name] + extra + (["mesh.seq=2"] if world == "two" else [])}
            if world == "one":
                one[name] = cli(job)
            else:
                jobs.append(job)
    return one, jobs


@pytest.fixture(scope="module")
def two_process_runs(tmp_path_factory):
    """The word cases and the drivers' runs, every two-process run in one
    group."""
    jobs, refs = word_cases()
    tmp = tmp_path_factory.mktemp("seq_drivers")
    one, driver_jobs = driver_cases(tmp)
    outs = spawn(jobs + driver_jobs, 2, tmp_path_factory.mktemp("seq_word"),
                 timeout=SPAWN_TIMEOUT)
    word = dict(zip(("video8", "video7", "landmark8", "landmark7"), zip(refs, outs)))
    two = dict(zip(DRIVER_RUNS, (ranks[0] for ranks in outs[len(jobs):])))
    return {"word": word, "drivers": (tmp, one, two)}


def _fresh_variables(cfg):
    """The port's own initial variables of ``cfg`` as flax trees."""
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.utils.bridge import to_flax

    return to_flax(build_model(cfg, device="cpu").state_dict())


@pytest.mark.parametrize("frames", [8, 7])
def test_word_seq_step_draws_as_one_process(two_process_runs, frames):
    """The grad norm after the first update at 1e-4 (``test_torch_parallel.
    assert_jax_close``'s reason: the update moves the parameters of
    near-zero gradients, the attention key biases, by up to the rate either
    way, and the next gradients with them)."""
    one, two = two_process_runs["word"][f"video{frames}"]
    assert_ranks_equal(two)
    assert two[0]["dropout_draw"] == one["dropout_draw"]
    lr_sum = sum(m["learning_rate"] for m in one["metrics"])
    assert_tp_close(two[0], one, [m for m in WORD_METRICS if m != "grad_norm"], 1e-6, lr_sum)
    for i, (g, w) in enumerate(zip(two[0]["metrics"], one["metrics"])):
        close(g["grad_norm"], w["grad_norm"], 1e-4 if i else 1e-5, 1e-7, f"step {i + 1}")


@pytest.mark.parametrize("frames", [8, 7])
def test_landmark_word_seq_step_matches_jax(two_process_runs, frames):
    want, two = two_process_runs["word"][f"landmark{frames}"]
    assert_ranks_equal(two)
    assert_steps_close(two[0], want, LANDMARK_METRICS, 1e-5)


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    """The tiny lrs3 model (draws injected) at one process, and on four
    processes as (data=2, seq=2) with FSDP and as (seq=2, model=2)."""
    cfg_j, cfg = sentence_configs(**{"optim.lr": 1e-4})
    batch = _uint8_clips(cfg_j)
    b, t, h, w, _ = batch["videos"].shape
    drawn = {k: v.numpy() for k, v in jax_aug_sample(
        AUG_KEY, b, t, h, w, cfg.data, sentence=True, lengths=batch["lengths"]).items()}
    params, stats = _fresh_variables(cfg)
    job = {"kind": "train", "config": cfg.to_dict(), "params": params,
           "batch_stats": stats, "batch": batch, "steps": STEPS, "aug": drawn,
           "aug_dtype": "float32"}
    fsdp, tp = spawn([dict(job, seq=2, fsdp=MIN_SIZE),
                      dict(job, seq=2, model=2, min_dim=MIN_DIM)], 4,
                     tmp_path_factory.mktemp("seq_grid"), timeout=GRID_TIMEOUT)
    return train_steps(job), {"data_seq_fsdp": fsdp, "seq_model": tp}


@pytest.mark.parametrize("grid", ["data_seq_fsdp", "seq_model"])
def test_seq_grid_matches_one_process(grid_runs, grid):
    one, runs = grid_runs
    outs = runs[grid]
    for r in range(1, 4):
        assert_ranks_equal([outs[0], outs[r]])
    lr_sum = sum(m["learning_rate"] for m in one["metrics"])
    assert_tp_close(outs[0], one, SENTENCE_METRICS, 1e-5, lr_sum)
    # the state a rank holds: half of it under FSDP over data=2, less than
    # the whole under the model split
    whole = one["resident"]["params"]
    assert outs[0]["resident"]["params"] < (0.6 if grid == "data_seq_fsdp" else 0.9) * whole


def test_drivers_seq_axis_match_one_process(two_process_runs):
    """``python -m syncvsr_tpu_torch.train`` and ``.evaluate`` with
    ``mesh.seq=2`` over two processes (``driver_cases``): the sentence model
    trains on each rank's frames to one process's metrics, and the greedy
    hypotheses and the word meter equal one process's, each row written
    once."""
    tmp_path, one, two = two_process_runs["drivers"]
    runs = DRIVER_RUNS
    # the synthetic sentence batches' 32 frames split 16 + 16
    assert "mesh data 1 x seq 2 x model 1" in two["train"]["stdout"]
    one, two = ({k: v["summary"] for k, v in d.items()} for d in (one, two))
    for name in runs:
        assert set(one[name]) == set(two[name]), name
        for k, v in one[name].items():
            if isinstance(v, float):
                close(two[name][k], v, 1e-5, 1e-6, f"{name} {k}")
            else:
                assert two[name][k] == v, (name, k)
    hyps = [(tmp_path / f"greedy_{w}" / "hypotheses.jsonl").read_text() for w in ("one", "two")]
    assert hyps[0] == hyps[1] and hyps[0].count("\n") == 16

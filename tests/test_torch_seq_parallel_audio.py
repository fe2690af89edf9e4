"""PyTorch port: sequence-parallel training of the ``lrs3_audio`` model
(the Conv1D ResNet frontend on a waveform split over the seq ranks), on
gloo processes on the CPU.

* ResNet1D alone (float64 weights and clips, train mode: its 20
  BatchNorms reduce over the seq ranks, their statistics f32 sums in
  another order, so f32's tolerances: rtol 1e-5, atol 1e-6, and for the
  parameters' gradients, sums of the ranks' partials, atol 1e-5 of each
  leaf's largest) at seq = 2 and 4, over clips whose frames divide seq (the
  waveform splits at frame boundaries: each conv reads a halo at its own
  stage, 38 samples at the k = 80 stem, 1 at each k = 3 conv, on the
  right only at stride 2) and clips whose frames do not (it stays whole):
  a rank's frames of the whole clip's output, its samples' input
  gradient, and the parameters' gradients summed over the ranks, against
  one process.
* The tiny ``lrs3_audio`` model (``torch_parity.audio_configs`` at
  ``tests/test_torch_audio.py``'s rate; dropout 0: torch cannot draw
  JAX's masks), 16 frames a clip (8 a rank), two
  steps at seq = 2 against the JAX package's step on a (data=1, seq=2)
  mesh of two CPU devices from bridged weights, and against the port's
  one process, at ``tests/test_torch_seq_parallel_sentence.py``'s
  tolerances (``tests/test_spmd.py``'s: each step's metrics rtol 1e-5;
  every parameter, statistic and moment rtol 1e-4, atol 1e-5 against
  JAX and 1e-6 against one process); the two ranks end bitwise alike.
  The leaves whose true gradient is 0 are held by size, as
  ``tests/test_torch_dctcn.py`` holds them: the Conformer's depthwise-conv
  biases (the BatchNorm after the conv subtracts the batch mean) and the
  attention key biases (the softmax over keys cancels them). Each side
  holds f32 noise there, summed in another order on two ranks, which
  Adam turns into steps of up to the rate in either sign: those
  parameters within 2 x the rates' sum, their moments under 1e-5 of the
  tree's largest on both sides."""

import jax
import numpy as np
import pytest
import torch

from syncvsr_tpu.data.synthetic import sentence_batch
from syncvsr_tpu.parallel import create_mesh as jax_create_mesh
from syncvsr_tpu_torch.models.resnet import ResNet1D
from test_torch_audio import _zero_gradient
from test_torch_parallel import SENTENCE_METRICS, assert_ranks_equal
from test_torch_seq_parallel_sentence import assert_steps_close, jax_steps
from torch_multiproc import spawn, train_steps
from torch_parity import audio_configs, close
import torch_threads  # noqa: F401  (one torch thread a test process)

FRAMES = 16
WIDTH = 4
# (seq, frames a clip): frames that divide seq split, the others stay whole
CLIPS = {2: (2, 3, 6), 4: (4, 6, 8)}
RTOL, ATOL = 1e-5, 1e-6
LR = 1e-4   # tests/test_torch_audio.py's rate, for its reason
# seconds for the two- and four-process groups: 3x the most measured
# (12.5 and 12.7 s), at least 60
SPAWN_TIMEOUT = {2: 60, 4: 60}


def _resnet_job(seq, frames):
    rng = np.random.RandomState(seq * 10 + frames)
    return {"kind": "resnet1d", "seq": seq, "width": WIDTH,
            "audio": rng.randn(2, frames * 640),
            "cot": rng.randn(2, frames, 8 * WIDTH)}


def _whole(job):
    """One process's ResNet1D on the whole clip: output and gradients."""
    torch.manual_seed(0)
    net = ResNet1D(job["width"], dtype=torch.float64).double()
    x = torch.from_numpy(job["audio"]).requires_grad_(True)
    y = net(x[..., None], True)
    (y * torch.from_numpy(job["cot"])).sum().backward()
    return y.detach().numpy(), x.grad.numpy(), {n: p.grad.numpy()
                                                for n, p in net.named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ResNet1D cases at seq = 4 in one four-process group; at seq = 2
    the ResNet1D cases and the model's steps in one two-process group."""
    tmp = tmp_path_factory.mktemp("seq_audio")
    cfg_j, cfg_t = audio_configs(**{"optim.lr": LR})
    batch = sentence_batch(cfg_j, num_frames=FRAMES, label_len=5)
    mesh = jax_create_mesh(data=1, seq=2, devices=jax.devices()[:2])
    params, stats, want = jax_steps(cfg_j, batch, batch, mesh=mesh)
    job = {"kind": "train", "config": cfg_t.to_dict(), "params": params,
           "batch_stats": stats, "batch": batch, "steps": 2}
    one = train_steps(job)
    jobs = {seq: [_resnet_job(seq, f) for f in CLIPS[seq]] for seq in CLIPS}
    two = spawn(jobs[2] + [dict(job, seq=2)], 2, tmp, timeout=SPAWN_TIMEOUT[2])
    four = spawn(jobs[4], 4, tmp, timeout=SPAWN_TIMEOUT[4])
    resnet = {(seq, f): (jobs[seq][i], outs) for seq, outs_all in ((2, two), (4, four))
              for i, (f, outs) in enumerate(zip(CLIPS[seq], outs_all))}
    return {"resnet": resnet, "step": (want, one, two[-1])}


@pytest.mark.parametrize("seq,frames", [(s, f) for s in CLIPS for f in CLIPS[s]])
def test_resnet1d_halos_match_the_whole_clip(runs, seq, frames):
    job, outs = runs["resnet"][(seq, frames)]
    y, gx, gw = _whole(job)
    split = frames % seq == 0
    total = {n: 0.0 for n in gw}
    for r, out in enumerate(outs):
        if split:
            t0, tl, t = out["time"]
            assert (t0, tl, t) == (r * frames // seq, frames // seq, frames)
        else:   # whole on every rank
            assert out["time"] is None
            t0, tl = 0, frames
        np.testing.assert_allclose(out["y"], y[:, t0:t0 + tl], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out["gx"], gx[:, t0 * 640:(t0 + tl) * 640],
                                   rtol=RTOL, atol=ATOL)
        for n in gw:
            total[n] = total[n] + out["gw"][n]
            if not split:
                np.testing.assert_allclose(out["gw"][n], gw[n], rtol=RTOL,
                                           atol=1e-5 * np.abs(gw[n]).max(), err_msg=n)
    if split:   # a parameter's gradient is the sum of the ranks' frames' shares
        for n in gw:
            np.testing.assert_allclose(total[n], gw[n], rtol=RTOL,
                                       atol=1e-5 * np.abs(gw[n]).max(), err_msg=n)


def _split_zero_gradient(got, want):
    """(got, want) without the zero-gradient leaves, which are checked
    here by size."""
    lr_sum = sum(m["learning_rate"] for m in want["metrics"])
    kept = []
    for g_all, w_all in ((got["first"], want["first"]), (got, want)):
        pair = ({}, {})
        for key in ("params", "batch_stats", "mu", "nu"):
            flat_w = jax.tree_util.tree_leaves_with_path(w_all[key])
            flat_g = jax.tree_util.tree_leaves(g_all[key])
            top = max(float(np.abs(w).max()) for _, w in flat_w)
            for (path, w), g in zip(flat_w, flat_g):
                if not _zero_gradient(path):
                    continue
                name = key + jax.tree_util.keystr(path)
                if key == "params":
                    close(g, w, 0, 2 * lr_sum, name)
                else:
                    assert max(float(np.abs(w).max()), float(np.abs(g).max())) <= 1e-5 * top, name
            pair[0][key] = [g for (path, _), g in zip(flat_w, flat_g) if not _zero_gradient(path)]
            pair[1][key] = [w for path, w in flat_w if not _zero_gradient(path)]
        kept.append(pair)
    return kept


def test_audio_seq_step_matches_jax_and_one_process(runs):
    want, one, two = runs["step"]
    assert_ranks_equal(two)
    for ref, atol in ((one, 1e-6), (want, 1e-5)):
        (first_g, first_w), (last_g, last_w) = _split_zero_gradient(two[0], ref)
        n = sum(len(v) for v in last_w.values())
        assert 0 < n < sum(len(jax.tree_util.tree_leaves(ref[k]))
                           for k in ("params", "batch_stats", "mu", "nu"))
        assert_steps_close(dict(last_g, metrics=two[0]["metrics"], first=first_g),
                           dict(last_w, metrics=ref["metrics"], first=first_w),
                           SENTENCE_METRICS, atol)

"""PyTorch port: the sequence-parallel (``mesh.seq``) bookkeeping and
primitives.

* The ``data`` x ``seq`` x ``model`` rank layout against JAX's
  ``create_mesh`` (``reshape(data, seq, model)``), the sub-groups' members,
  and ``batch_shardings`` against the JAX package's on a (data=4, seq=2)
  mesh of the ``mesh8`` fixture's devices (no JAX compile): divisible and
  indivisible clip lengths, ``audio_tokens`` never split.
* ``shard_batch`` and ``split_time``: a rank's rows, then its frames.
* ``rel_shift`` at a query offset against the square shift of the whole.
* ``halo`` (narrower and wider than a rank's frames), ``gather_kv`` and
  ``gather_time`` on four gloo processes (seq=4), with their gradients,
  against the one-process function of the whole clip: ``gather_kv``'s
  cotangent of a frame is every rank's, ``gather_time``'s (under the
  1/S weight of ``replicated``) the whole loss's once.
* ``evaluate.gather_records`` keys records by the data index: under
  seq=2 the keying by ``rank // model`` counted each row twice."""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from syncvsr_tpu import config as jcfg
from syncvsr_tpu.data.synthetic import sentence_batch as jax_sentence_batch
from syncvsr_tpu.data.synthetic import word_batch as jax_word_batch
from syncvsr_tpu.parallel import batch_shardings as jax_batch_shardings
from syncvsr_tpu.parallel import create_mesh as jax_create_mesh
from syncvsr_tpu_torch import evaluate as tevaluate
from syncvsr_tpu_torch.models.conformer import rel_shift
from syncvsr_tpu_torch.parallel import Mesh, batch_shardings, shard_batch, split_time
from syncvsr_tpu_torch.parallel.mesh import AXES
from torch_multiproc import spawn
import torch_threads  # noqa: F401  (one torch thread a test process)

GRIDS = [(1, 2, 1), (2, 2, 1), (1, 2, 2), (2, 2, 2), (1, 4, 2), (4, 2, 1), (1, 8, 1)]


@pytest.mark.parametrize("data,seq,model", GRIDS)
def test_mesh_layout_matches_jax(data, seq, model):
    """Rank r's (data, seq, model) indices are the position of device r in
    JAX's mesh array, and each axis's group holds the ranks that differ
    from r on that axis only."""
    n = data * seq * model
    devices = jax.devices()[:n]
    grid = np.asarray(jax_create_mesh(data=data, model=model, seq=seq,
                                      devices=devices).devices)
    where = {d.id: idx for idx, d in np.ndenumerate(grid)}
    meshes = [Mesh(size=n, rank=r, device=torch.device("cpu"), model=model, seq=seq)
              for r in range(n)]
    for r, m in enumerate(meshes):
        assert (m.data, m.seq, m.model) == (data, seq, model)
        assert (m.data_index, m.seq_index, m.model_index) == where[devices[r].id]
    for axis in AXES:
        for r, m in enumerate(meshes):
            coords = {a: getattr(m, f"{a}_index") for a in AXES}
            members = [q for q, o in enumerate(meshes)
                       if all(getattr(o, f"{a}_index") == coords[a] for a in AXES if a != axis)]
            want = [q for q, o in enumerate(meshes)
                    if all(where[devices[q].id][i] == where[devices[r].id][i]
                           for i, a in enumerate(AXES) if a != axis)]
            assert members == want and len(members) == m.axis_size(axis)


def _spec(sharding):
    return tuple(a for a in sharding.spec if a is not None)


@pytest.mark.parametrize("frames", [16, 13, 29])
@pytest.mark.parametrize("task", ["sentence", "word"])
def test_batch_shardings_match_jax(mesh8, task, frames):
    """Every key's spec equals the JAX package's ``batch_shardings`` on a
    (data=4, seq=2) mesh: ``videos``/``inputs`` split on time where the
    length divides, never ``audio_tokens``, ``lengths`` or ``labels``."""
    mesh_j = jax_create_mesh(data=4, seq=2, devices=list(mesh8.devices.flat))
    if task == "sentence":
        cfg = jcfg.lrs3_config().override(**{"data.batch_size": 8,
                                             "model.frontend.kind": "landmark",
                                             "model.frontend.input_features": 4})
        batch = jax_sentence_batch(cfg, num_frames=frames, label_len=3)
    else:
        cfg = jcfg.lrw_landmark_config().override(**{
            "data.batch_size": 8, "data.num_frames": frames,
            "model.frontend.input_features": 4})
        batch = jax_word_batch(cfg)
    want = {k: _spec(s) for k, s in jax_batch_shardings(mesh_j, batch).items()}
    got = batch_shardings(Mesh(size=8, rank=0, device=torch.device("cpu"), seq=2), batch)
    assert got == want
    key = "videos" if task == "sentence" else "inputs"
    assert got[key] == (("data", "seq") if frames % 2 == 0 else ("data",))
    assert got["audio_tokens"] == ("data",)
    # one seq rank: nothing splits
    assert set(batch_shardings(Mesh(size=8, rank=0, device=torch.device("cpu")),
                               batch).values()) == {("data",)}


def test_shard_batch_takes_rows_then_frames():
    """Rank r of a (data=2, seq=2) mesh holds its data index's rows and its
    seq index's frames of the time-split leaves, the whole of the rest;
    an indivisible clip stays whole (no slice)."""
    batch = {"videos": np.arange(4 * 6).reshape(4, 6), "lengths": np.arange(4),
             "audio_tokens": np.arange(4 * 8).reshape(4, 8)}
    got = []
    for r in range(4):
        part = shard_batch(Mesh(size=4, rank=r, device=torch.device("cpu"), seq=2), batch)
        got.append((part["videos"].tolist(), part["lengths"].tolist(),
                    part["audio_tokens"].shape, (part.time.start, part.time.length,
                                                 part.time.total)))
    assert got == [([[0, 1, 2], [6, 7, 8]], [0, 1], (2, 8), (0, 3, 6)),
                   ([[3, 4, 5], [9, 10, 11]], [0, 1], (2, 8), (3, 3, 6)),
                   ([[12, 13, 14], [18, 19, 20]], [2, 3], (2, 8), (0, 3, 6)),
                   ([[15, 16, 17], [21, 22, 23]], [2, 3], (2, 8), (3, 3, 6))]
    odd = split_time(Mesh(size=2, rank=1, device=torch.device("cpu"), seq=2),
                     {"inputs": torch.zeros(2, 7, 3)})
    assert odd.time is None and odd["inputs"].shape == (2, 7, 3)
    # a split batch passes through, a mesh without a seq axis leaves it be
    assert split_time(Mesh(size=2, rank=1, device=torch.device("cpu"), seq=2), odd) is odd
    plain = {"inputs": torch.zeros(2, 8, 3)}
    assert split_time(Mesh(size=2, rank=1, device=torch.device("cpu")), plain) is plain


@pytest.mark.parametrize("t,parts", [(1, 1), (6, 1), (6, 2), (6, 3), (6, 6), (16, 4)])
def test_rel_shift_at_an_offset_matches_the_whole(t, parts):
    """A rank's query rows shifted at their offset equal its rows of the
    square shift of the whole clip, with equal gradients."""
    torch.manual_seed(t * 10 + parts)
    x = torch.randn(2, 3, t, 2 * t - 1, dtype=torch.float64, requires_grad=True)
    g = torch.randn(2, 3, t, t, dtype=torch.float64)
    whole = rel_shift(x)
    # the square shift: column j of row i holds the table's column T-1-i+j
    i, j = torch.meshgrid(torch.arange(t), torch.arange(t), indexing="ij")
    assert torch.equal(whole, x[:, :, i, t - 1 - i + j])
    (gx,) = torch.autograd.grad((whole * g).sum(), x)
    tl = t // parts
    for s in range(parts):
        rows = x[:, :, s * tl:(s + 1) * tl].detach().clone().requires_grad_(True)
        part = rel_shift(rows, s * tl)
        assert torch.equal(part, whole[:, :, s * tl:(s + 1) * tl])
        (gr,) = torch.autograd.grad((part * g[:, :, s * tl:(s + 1) * tl]).sum(), rows)
        assert torch.equal(gr, gx[:, :, s * tl:(s + 1) * tl])


HALOS = [(2, 2), (3, 1), (0, 2), (5, 3)]   # (5, 3): wider than a rank's 2 frames
# seconds for the file's four-process group: 3x the most measured (6.1 s), at least 60
SPAWN_TIMEOUT = 60


@pytest.fixture(scope="module")
def ops_runs(tmp_path_factory):
    rng = np.random.RandomState(0)
    seq, t = 4, 8
    x = rng.randn(2, t, 3).astype(np.float64)
    cot = rng.randn(seq, 2, t + 16, 3).astype(np.float64)
    job = {"kind": "seq_ops", "seq": seq, "x": x, "cot": cot, "halos": HALOS}
    return x, cot, spawn(job, seq, tmp_path_factory.mktemp("seq_ops"), timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("left,right", HALOS)
def test_halo_matches_the_padded_clip(ops_runs, left, right):
    """A rank's halo is its window of the zero-padded clip, and its
    gradient, summed from every rank's window, the padded clip's."""
    x, cot, outs = ops_runs
    xt = torch.from_numpy(x).requires_grad_(True)
    padded = F.pad(xt, (0, 0, left, right))
    loss = 0.0
    for r, out in enumerate(outs):
        t0, tl = out["time"]
        window = padded[:, t0:t0 + tl + left + right]
        np.testing.assert_array_equal(out[f"halo{left}_{right}"][0], window.detach().numpy())
        loss = loss + (window * torch.from_numpy(cot[r][:, :window.shape[1]])).sum()
    (grad,) = torch.autograd.grad(loss, xt)
    for out in outs:
        t0, tl = out["time"]
        np.testing.assert_allclose(out[f"halo{left}_{right}"][1], grad[:, t0:t0 + tl].numpy(),
                                   rtol=1e-12, atol=1e-12)


def test_gather_kv_sums_every_ranks_cotangent(ops_runs):
    """Every rank holds the whole clip; a frame's gradient is the sum of
    every rank's cotangent of it (every rank's queries read every key)."""
    x, cot, outs = ops_runs
    total = cot[:, :, :x.shape[1]].sum(0)
    for out in outs:
        t0, tl = out["time"]
        y, gx = out["gather_kv"]
        np.testing.assert_array_equal(y, x)
        np.testing.assert_allclose(gx, total[:, t0:t0 + tl], rtol=1e-12, atol=1e-12)


def test_gather_time_counts_the_replicated_loss_once(ops_runs):
    """Every rank holds the whole clip; under ``replicated``'s 1/S weight
    the reduce-scatter backward gives each frame the one-process gradient
    of the (alike) loss, not S times it."""
    x, cot, outs = ops_runs
    for out in outs:
        t0, tl = out["time"]
        y, gx = out["gather_time"]
        np.testing.assert_array_equal(y, x)
        np.testing.assert_allclose(gx, cot[0][:, t0:t0 + tl], rtol=1e-12, atol=1e-12)


def test_gather_records_counts_each_row_once(monkeypatch):
    """On a (data=2, seq=2) mesh the two seq ranks of a data index decode
    the same rows: rank 0 keeps seq index 0's and orders the rows as one
    process does (batch, row, data index). Keying by ``rank // model`` and
    keeping every ``model``-th rank, as before sequence parallel, takes
    each row twice."""
    per_rank = []
    for r in range(4):
        d = r // 2   # the data index of rank r (seq index r % 2)
        per_rank.append([((k, i), {"hyp": f"b{k} r{i} d{d}"}) for k in range(2)
                         for i in range(2)])

    def all_gather_object(out, records):
        out[:] = per_rank

    monkeypatch.setattr(tevaluate.dist, "all_gather_object", all_gather_object)
    mesh = Mesh(size=4, rank=0, device=torch.device("cpu"), seq=2)
    got = [r["hyp"] for r in tevaluate.gather_records(per_rank[0], mesh)]
    assert got == [f"b{k} r{i} d{d}" for k in range(2) for i in range(2) for d in range(2)]
    old = [(key + (r // mesh.model,), rec) for r, recs in enumerate(per_rank)
           if r % mesh.model == 0 for key, rec in recs]
    assert len(old) == 2 * len(got)   # what the fix removes
    # the ranks of a (data=2, seq=2, model=2) mesh: rank 0 of each data index
    mesh = Mesh(size=8, rank=0, device=torch.device("cpu"), seq=2, model=2)
    per_rank[:] = [[((0, 0), {"hyp": f"d{r // 4} s{(r // 2) % 2} m{r % 2}"})]
                   for r in range(8)]
    assert [r["hyp"] for r in tevaluate.gather_records(per_rank[0], mesh)] == [
        "d0 s0 m0", "d1 s0 m0"]

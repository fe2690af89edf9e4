"""PyTorch port: the tensor-parallel (``mesh.model``) leaf rule against the
JAX package's ``state_shardings`` on the full-width trees of five presets
(shapes only: ``jax.eval_shape`` on the JAX side, a model on the ``meta``
device on the port's, so nothing full-width is allocated or compiled),
the split shares it gives at model=2, and the 2-D mesh's bookkeeping."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncvsr_tpu import config as jcfg
from syncvsr_tpu.data.synthetic import sentence_batch, word_batch
from syncvsr_tpu.models import build_model as jax_build_model
from syncvsr_tpu.parallel import create_mesh as jax_create_mesh
from syncvsr_tpu.parallel import state_shardings as jax_state_shardings
from syncvsr_tpu_torch import config as tcfg
from syncvsr_tpu_torch.models import build_model
from syncvsr_tpu_torch.parallel import Mesh, create_mesh, host_local_batch, shard_batch
from syncvsr_tpu_torch.parallel import state_shardings
from syncvsr_tpu_torch.utils.bridge import flax_leaf, flax_perm
import torch_threads  # noqa: F401  (one torch thread a test process)

PRESETS = ("lrs3", "lrw_video", "lrw_dctcn", "lrw_landmark", "lrw1000")


class _Shapes:
    """What ``state_shardings`` reads of a train state: names and params."""

    def __init__(self, model):
        self.names, self.params = zip(*model.named_parameters())


@functools.lru_cache(maxsize=None)
def _trees(preset):
    """(JAX params tree of ShapeDtypeStructs, the port's names and meta
    parameters) of the preset at full width."""
    cfg_j = jcfg.PRESETS[preset]().override(**{"data.batch_size": 2})
    if cfg_j.model.task == "sentence":
        batch = sentence_batch(cfg_j, num_frames=8, label_len=4)
    else:
        batch = word_batch(cfg_j)
    model_j = jax_build_model(cfg_j)
    shapes = jax.eval_shape(lambda b: model_j.init(
        {"params": jax.random.PRNGKey(0), "mixup": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, **b, det=True),
        {k: jnp.asarray(v) for k, v in batch.items()})["params"]
    with torch.device("meta"):
        model = build_model(tcfg.PRESETS[preset](), device="meta")
    return shapes, _Shapes(model)


def _flax_key(name, ndim):
    return tuple(name.split(".")[:-1]) + (flax_leaf(name, ndim),)


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "tp_fsdp"])
@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("preset", PRESETS)
def test_rule_matches_jax_state_shardings(preset, model, fsdp):
    """Every parameter's spec over its flax layout, through the bridge's
    names, equals the JAX package's ``state_shardings`` on a (data=2,
    model) mesh (the default ``min_dim`` 512 and ``fsdp_min_size``)."""
    shapes, state = _trees(preset)
    mesh_j = jax_create_mesh(data=2, model=model, devices=jax.devices()[:2 * model])
    want = jax_state_shardings(mesh_j, shapes, fsdp=fsdp)
    want = {tuple(k.key for k in path): tuple(sh.spec) + (None,) * (leaf.ndim - len(sh.spec))
            for (path, sh), leaf in zip(jax.tree_util.tree_leaves_with_path(want),
                                        jax.tree_util.tree_leaves(shapes))}
    flat = {tuple(k.key for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    # the same leaves at the same (flax-layout) shapes
    assert {_flax_key(n, p.dim()): tuple(p.shape[i] for i in flax_perm(n, p.dim()))
            for n, p in zip(state.names, state.params)} == flat
    got = state_shardings(Mesh(size=2 * model, rank=0, device=torch.device("cpu"),
                               model=model), state, fsdp=fsdp)
    got = {_flax_key(n, len(spec)): spec for n, spec in got.items()}
    assert got == want
    assert any("model" in s for s in got.values())
    if fsdp:
        assert any("model" in s and "data" in s for s in got.values())


# the split share of the parameters and the count of split leaves at
# model=2 (the JAX rule applied to the full-width trees)
SHARES = {"lrs3": (0.760, 128), "lrw_video": (0.552, 30), "lrw_dctcn": (0.308, 46),
          "lrw_landmark": (0.362, 9)}


@pytest.mark.parametrize("preset", sorted(SHARES))
def test_split_shares_at_model_2(preset):
    """At model=2 the rule splits 0.760 of ``lrs3``'s parameters (every
    FFN, attention output, pointwise and depthwise conv, both embeddings,
    ``layer4``, the sync head), 0.552 of ``lrw_video``'s, 0.308 of
    ``lrw_dctcn``'s and 0.362 of ``lrw_landmark``'s; q/k/v (trailing head
    dim 64) and the 5049-way heads stay whole."""
    _, state = _trees(preset)
    specs = state_shardings(Mesh(size=2, rank=0, device=torch.device("cpu"), model=2),
                            state)
    sizes = {n: p.numel() for n, p in zip(state.names, state.params)}
    split = [n for n, s in specs.items() if "model" in s]
    share = sum(sizes[n] for n in split) / sum(sizes.values())
    assert (round(share, 3), len(split)) == SHARES[preset]
    if preset == "lrs3":
        assert "audio_classifier.weight" in split and "decoder.embed.embedding" in split
        assert "encoder.block_0.conv.dw.weight" in split
        assert not any(n.endswith(("wq.weight", "wk.weight", "wv.weight")) for n in split)
        assert "ctc_head.weight" not in split and "decoder.output.weight" not in split


def test_mesh_grid():
    """Rank r of a data x model grid sits at data index r // model and
    model index r % model (JAX's ``reshape(data, seq, model)``); the batch
    splits over the data axis only, so a model group holds the same rows;
    one process cannot make a model or a seq axis."""
    grid = [Mesh(size=4, rank=r, device=torch.device("cpu"), model=2) for r in range(4)]
    assert [(m.data, m.data_index, m.model_index) for m in grid] == [
        (2, 0, 0), (2, 0, 1), (2, 1, 0), (2, 1, 1)]
    assert host_local_batch(8, grid[1]) == 4
    batch = {"x": np.arange(8)}
    assert [shard_batch(m, batch)["x"].tolist() for m in grid] == [
        [0, 1, 2, 3], [0, 1, 2, 3], [4, 5, 6, 7], [4, 5, 6, 7]]
    with pytest.raises(ValueError, match="mesh 1x1x2 != 1 processes"):
        create_mesh(model=2, device="cpu")
    with pytest.raises(ValueError, match="mesh 1x2x1 != 1 processes"):
        create_mesh(seq=2, device="cpu")

"""PyTorch port: the LRW landmark data path against the JAX package's, on
the CPU. Each landmark transform (``data/landmark_transforms.py``) and both
``create_transform`` recipes give equal arrays for equal ``RandomState``
seeds; ``LRWLandmarkDataset`` gives equal samples on a synthetic ``.npy``
tree with ``durations.csv`` (``syncvsr_tpu_torch/data/synthetic_tree.py``);
the factory's ``lrw_landmark`` eval loader gives equal batches."""

import numpy as np
import pytest

from syncvsr_tpu import config as jcfg
from syncvsr_tpu.data import factory as jfactory
from syncvsr_tpu.data import landmark_transforms as jlt
from syncvsr_tpu.data import lrw as jlrw
from syncvsr_tpu_torch import config as tcfg
from syncvsr_tpu_torch.data import factory as tfactory
from syncvsr_tpu_torch.data import landmark_transforms as tlt
from syncvsr_tpu_torch.data import lrw as tlrw
from syncvsr_tpu_torch.data.synthetic_tree import write_landmark_tree
from test_torch_data import assert_same
import torch_threads  # noqa: F401  (one torch thread a test process)

# name -> (constructor keyword arguments, p); p = None applies always
TRANSFORMS = {
    "Identity": ({}, None), "LeftCrop": ({"length": 9}, None),
    "Normalize": ({}, None), "NormalizeMax": ({"max_value": 3.0}, None),
    "CenterCrop": ({"length": 9}, None), "RandomCrop": ({"length": 9}, None),
    "Pad": ({"length": 40}, None), "HorizontalFlip": ({}, 0.5), "TimeFlip": ({}, 0.5),
    "RandomResample": ({"limit": 0.3}, 0.5), "CoordinateJitter": ({"stdev": 0.05}, None),
    "RandomShift": ({}, None), "RandomScale": ({"limit": 0.2}, None),
    "RandomShear": ({"limit": 0.2}, None),
    "RandomInterpolatedRotation": ({"center_stdev": 0.2}, 0.5),
    "FrameBlockMask": ({"ratio": 0.3, "block_size": 3}, None),
    "FrameNoise": ({"ratio": 0.3}, None), "FeatureMask": ({"ratio": 0.2}, None),
}


def _clip(seed, t=21):
    x = np.random.RandomState(seed).randn(t, 478, 3).astype(np.float32)
    x[np.random.RandomState(seed + 1).rand(t, 478) < 0.05] = np.nan
    return x


def _build(module, name, seed):
    kw, p = TRANSFORMS[name]
    cls = getattr(module, "Normalize" if name == "NormalizeMax" else name)
    return cls(**kw, p=p, rng=np.random.RandomState(seed))


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_matches_jax(name):
    """Five calls on three clips each (the draws of one RandomState run
    on), NaN where the JAX transform has NaN."""
    t, j = _build(tlt, name, 3), _build(jlt, name, 3)
    for seed in range(3):
        x = _clip(seed)
        for _ in range(5):
            np.testing.assert_array_equal(t(x.copy()), j(x.copy()), err_msg=name)


def test_group_apply_and_sequential_match_jax():
    for mod in (tlt, jlt):
        mod._pair = mod.Sequential(
            mod.GroupApply([mod.HorizontalFlip(), mod.RandomShift(rng=np.random.RandomState(4))],
                           [200, 278]),
            mod.TimeFlip(p=0.5, rng=np.random.RandomState(5)), p=0.9,
            rng=np.random.RandomState(6))
    try:
        for seed in range(4):
            x = _clip(seed)
            np.testing.assert_array_equal(tlt._pair(x), jlt._pair(x))
    finally:
        del tlt._pair, jlt._pair


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_create_transform_matches_jax(train):
    t = tlt.create_transform(train, rng=np.random.RandomState(8))
    j = jlt.create_transform(train, rng=np.random.RandomState(8))
    for seed in range(6):
        x = _clip(seed, t=[12, 29, 35][seed % 3])
        out = t(x)
        np.testing.assert_array_equal(out, j(x))
        assert out.shape == (29, 478, 3)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lrw_landmark") / "LRW")
    return write_landmark_tree(root, ("ABOUT", "WORLD"), ("train", "val"), n=5, seed=1)


def test_landmark_dataset_matches_jax(tree):
    """Samples (flattened features, NaN -> 0, word masks, zero tokens)
    under seeded train transforms, and with no transform."""
    labels = tlrw.discover_labels(tree)
    files = tlrw.glob_lrw_files(tree, "train", ext="npy")
    assert files == jlrw.glob_lrw_files(tree, "train", ext="npy") and len(files) == 10
    for make in (lambda m: m.create_transform(True, rng=np.random.RandomState(2)),
                 lambda m: None):
        t = tlrw.LRWLandmarkDataset(files, labels, transform=make(tlt),
                                    durations=tlrw.load_durations(f"{tree}/durations.csv"))
        j = jlrw.LRWLandmarkDataset(files, labels, transform=make(jlt),
                                    durations_df=jlrw.load_durations(f"{tree}/durations.csv"))
        for i in range(len(files)):
            a, b = t[i], j[i]
            assert_same(a, b, f"sample {i}")
            assert a["inputs"].shape[1] == 1434 and "word_mask" in a


def test_landmark_eval_loader_matches_jax(tree):
    """The factory's lrw_landmark loaders: equal eval batches (the eval
    transform draws nothing; the train transform draws from numpy's global
    state on the loader's threads, so only its batch shapes are held)."""
    o = {"data.dataset": "lrw_landmark", "data.root": tree, "data.batch_size": 4,
         "data.eval_batch_size": 3, "data.num_workers": 2}
    cj, ct = jcfg.lrw_landmark_config().override(**o), tcfg.lrw_landmark_config().override(**o)
    (jt, je), (tt_, te) = jfactory.build_loaders(cj), tfactory.build_loaders(ct)
    assert len(te) == len(je) == 4 and len(tt_) == len(jt) == 2
    for g, w in zip(te, je, strict=True):
        assert_same(g, w, "eval")
    for g, w in zip(tt_, jt, strict=True):
        assert {k: v.shape for k, v in g.items()} == {k: v.shape for k, v in w.items()}

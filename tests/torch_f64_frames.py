"""One train step of the tiny Conv3D ``lrs3`` model of
``tests/test_torch_seq_parallel_sentence.py`` (clips of N and N - 5
frames, the augmentation's draws injected) four ways, on the CPU: the JAX
package in f32, the port in f32, the port in float64 (``f64_casts``) and
the JAX package in float64 (``jax_f64_step``, from the port's float64
clips). Prints, for N = 10, 12, 14, 16, each step's distance from the
port's float64 answer: in the loss and gradient norm (relative), and the
largest in the first moment (0.1 x the clipped gradient), the second, and
the stem's first moment alone.

    JAX_PLATFORMS=cpu python tests/torch_f64_frames.py

``--jax64 IN OUT`` is the float64 JAX step's own process (``jax_f64_step``).
"""

import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch_threads

STEM = "['frontend']['stem_conv_kernel']"


def f64_casts(monkeypatch):
    """Make every f32 the port asks for float64: ``.float()``, ``.to()``
    and ``.type()`` to f32 (LayerNorm, softmax, losses, the augmentation's
    uint8 frames), and the tensor factories given ``dtype=torch.float32``
    (position tables, the sync loss's accumulators). Random draws keep
    their dtype: their streams depend on it."""
    f32, f64 = torch.float32, torch.float64

    def wide(x):
        return f64 if x is f32 else x

    for name in ("to", "type"):
        def cast(self, *a, _orig=getattr(torch.Tensor, name), **k):
            return _orig(self, *map(wide, a), **{n: wide(x) for n, x in k.items()})
        monkeypatch.setattr(torch.Tensor, name, cast)
    monkeypatch.setattr(torch.Tensor, "float", lambda self, *a, **k: self.to(f64))
    for name in ("arange", "zeros", "ones", "full", "empty", "tensor", "as_tensor",
                 "linspace", "zeros_like", "ones_like", "full_like", "empty_like"):
        def make(*a, _orig=getattr(torch, name), **k):
            return _orig(*a, **{n: wide(x) for n, x in k.items()})
        monkeypatch.setattr(torch, name, make)


def jax_f64_step(cfg_j, params, stats, batch):
    """One step of the JAX package's train step in float64, without
    augmentation (``batch["videos"]`` holds the augmented float64 clips),
    from flax ``params``/``stats``: {"mu", "nu", "params"} as flat numpy
    trees (``flat``) and the metrics. It runs in a process of its own, with
    ``jax_enable_x64`` and the package's f32 casts made float64."""
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "in.pkl"), os.path.join(d, "out.pkl")
        with open(src, "wb") as f:
            pickle.dump({"cfg": cfg_j, "params": params, "stats": stats, "batch": batch}, f)
        env = torch_threads.env(JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1")
        subprocess.run([sys.executable, __file__, "--jax64", src, dst], check=True, env=env,
                       timeout=600)
        with open(dst, "rb") as f:
            return pickle.load(f)


def _jax64_main(src, dst):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64   # every explicit f32 cast of the package

    from syncvsr_tpu.engine import build_train_step
    from syncvsr_tpu.engine.state import TrainState, make_optimizer
    from syncvsr_tpu.models import build_model
    from test_torch_step import _adam_moments

    with open(src, "rb") as f:
        d = pickle.load(f)
    cfg = d["cfg"].override(**{"model.dtype": "float64"})
    model = build_model(cfg)

    def f64(tree):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)

    state = TrainState.create(
        apply_fn=model.apply, params=f64(d["params"]), tx=make_optimizer(cfg.optim),
        mixup_rng=jax.random.PRNGKey(cfg.train.mixup_seed),
        dropout_rng=jax.random.PRNGKey(cfg.train.dropout_seed), batch_stats=f64(d["stats"]))
    batch = {k: jnp.asarray(v) for k, v in d["batch"].items()}
    state, m = build_train_step(None, donate=False)(state, batch)
    mu, nu = _adam_moments(state.opt_state)
    assert jax.tree_util.tree_leaves(mu)[0].dtype == jnp.float64
    with open(dst, "wb") as f:
        pickle.dump({"mu": flat(mu), "nu": flat(nu), "params": flat(state.params),
                     "metrics": {k: float(v) for k, v in m.items()}}, f)


def flat(tree):
    """A flax tree as {keystr: float64 array}."""
    import jax

    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def one_step(frames: int):
    """{"jax", "float32", "float64", "jax64"}: the moments after one step."""
    import jax.numpy as jnp
    import pytest

    import test_torch_seq_parallel_sentence as seq_test
    from syncvsr_tpu_torch.engine import build_train_step, create_train_state
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.ops.image import fused_train_aug_apply
    from syncvsr_tpu_torch.utils.bridge import load_flax, to_flax
    from torch_parity import jax_aug_sample, sentence_configs, tt

    seq_test.FRAMES = frames
    cfg_j, cfg_t = sentence_configs(**{"optim.lr": 1e-4})
    batch = seq_test._uint8_clips(cfg_j)
    batch["lengths"] = np.array([frames, frames - 5], np.int32)
    b, t, h, w, _ = batch["videos"].shape
    drawn = jax_aug_sample(seq_test.AUG_KEY, b, t, h, w, cfg_t.data, sentence=True,
                           lengths=batch["lengths"])
    s = cfg_j.data.crop_size
    init = dict(batch, videos=np.zeros((b, t, s, s, 1), np.float32))
    params, stats, want = seq_test.jax_steps(
        cfg_j, batch, init, seq_test._jax_sentence_aug(cfg_j.data, seq_test.AUG_KEY,
                                                       jnp.float32), steps=1)
    out = {"jax": {k: flat(want["first"][k]) for k in ("mu", "nu")}}
    out["jax"]["metrics"] = want["metrics"][0]
    for dtype in (torch.float32, torch.float64):
        c = cfg_t.override(**{"model.dtype": str(dtype).split(".")[1]})
        model = build_model(c, device="cpu")
        load_flax(model, params, stats)
        patch = pytest.MonkeyPatch()
        if dtype == torch.float64:
            model = model.double()
            f64_casts(patch)
        tb = {k: tt(v) for k, v in batch.items()}

        def aug(gen, bt, c=c, dtype=dtype):
            return dict(bt, videos=fused_train_aug_apply(
                bt["videos"], drawn, c.data.crop_size, c.data.mean, c.data.std, dtype))

        if dtype == torch.float64:
            clips = aug(None, tb)["videos"].numpy()
        state = create_train_state(c, model, tb, device="cpu")
        state, m = build_train_step(aug_fn=aug)(state, tb)
        patch.undo()
        out[str(dtype).split(".")[1]] = {
            k: flat(to_flax(dict(zip(state.names, getattr(state, k))))[0])
            for k in ("mu", "nu")}
        out[str(dtype).split(".")[1]]["metrics"] = {k: float(v) for k, v in m.items()}
    out["jax64"] = jax_f64_step(cfg_j, params, stats, dict(batch, videos=clips))
    return out


def main():
    for frames in (10, 12, 14, 16):
        o = one_step(frames)
        ref = o["float64"]["metrics"]
        for side in ("jax", "float32", "jax64"):
            print(f"frames {frames} metrics {side:>7}: " + ", ".join(
                f"{k} rel {abs(o[side]['metrics'][k] / ref[k] - 1):.4e}"
                for k in ("loss", "grad_norm")))
        for k in ("mu", "nu"):
            ref = o["float64"][k]
            for side in ("jax", "float32", "jax64"):
                got = o[side][k]
                worst = max(np.abs(got[n] - ref[n]).max() for n in ref)
                stem = np.abs(got[STEM] - ref[STEM]).max()
                name = {"jax": "jax f32", "float32": "port f32", "jax64": "jax f64"}[side]
                print(f"frames {frames} {k} {name:>8}: max |. - port f64| {worst:.4e} "
                      f"(stem {stem:.4e}, stem's largest {np.abs(ref[STEM]).max():.4e})")


if __name__ == "__main__":
    sys.path[:0] = [str(Path(__file__).resolve().parents[1])]
    if sys.argv[1:2] == ["--jax64"]:
        _jax64_main(*sys.argv[2:4])
    else:
        main()

"""Checkpointing and parameter surgery (port of
``syncvsr_tpu/utils/checkpoint.py``).

The files are the JAX package's: single-file msgpack trees in flax's wire
format (``utils/msgpack.py``), written atomically (tmp + fsync + rename) and
asynchronously (``AsyncCheckpointer``). A train-state checkpoint holds

* ``step`` (int32), ``params`` and ``batch_stats`` in flax naming and
  layout (``utils/bridge.to_flax``);
* ``opt_state`` as ``flax.serialization.to_state_dict`` lays out the JAX
  package's optax chain (``syncvsr_tpu/engine/state.py::make_optimizer``):
  ``inject_hyperparams``' ``count``, ``hyperparams.lr`` (the rate of the
  last update) and its schedule's ``count``, then ``inner_state``: global-
  norm clipping's empty state (when ``optim.clip_norm > 0``) and AdamW's
  chain, whose first entry is Adam's ``count``/``mu``/``nu``, the moments
  in flax layout (the bridge transposes them as it does the parameters);
  with ``optim.skip_nonfinite`` that state sits in ``ApplyIfFiniteState``'s
  ``inner_state`` beside ``notfinite_count``, ``last_finite`` and
  ``total_notfinite``, and with ``optim.accum_steps > 1`` the whole in
  ``MultiStepsState``'s ``inner_opt_state`` beside ``mini_step``,
  ``gradient_step``, ``acc_grads`` (in flax layout, as the moments) and an
  empty ``skip_state``;
* ``mixup_rng`` and ``dropout_rng``, the JAX package's PRNG keys, so that
  its ``restore_train_state`` takes a port checkpoint.

Torch cannot reproduce ``jax.random`` streams. The port saves its two
generators' states under keys of its own (``torch_mixup_gen``,
``torch_dropout_gen``; the JAX package ignores them) and writes
``jax.random.PRNGKey`` of the configured seeds as ``mixup_rng`` and
``dropout_rng``. Restoring a checkpoint without the port's keys (one the
JAX package wrote) re-seeds the generators from ``train.mixup_seed`` and
``train.dropout_seed``.

Partial warm starts (``partial_load``, with key-prefix ``rename``) and the
SSL-pretrained landmark encoder (``load_ssl_pretrained``) work on flax
trees too. ``gather_for_save`` gathers a state split over a mesh
(``mesh.fsdp``, ``mesh.model``); restore a checkpoint before splitting the
state (``parallel.shard_state``): every rank reads the whole file.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from syncvsr_tpu_torch.utils import msgpack
from syncvsr_tpu_torch.utils.bridge import from_flax, load_flax, to_flax


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> {dotted key: leaf} (empty dicts dropped, as flax's
    ``flatten_dict`` does)."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "."))
        else:
            out[key] = v
    return out


def unflatten(d: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in d.items():
        node = out
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor as a numpy array on the host."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


# ---------------------------------------------------------------------------
# msgpack single-file checkpoints
# ---------------------------------------------------------------------------

def save_msgpack(path: str, tree: Any) -> None:
    """Atomic write: serialize to <path>.tmp, fsync, then rename, so neither
    a crash mid-write nor a power loss after the rename leaves a corrupt file
    where ``resume=auto`` will look."""
    tree = _host(tree)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        msgpack.dump(tree, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_msgpack(path: str) -> Any:
    with open(path, "rb") as f:
        return msgpack.loads(f.read())


# ---------------------------------------------------------------------------
# full train-state checkpoints
# ---------------------------------------------------------------------------

def _prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` (threefry, the default) for 0 <= seed < 2**32."""
    return np.array([0, seed], np.uint32)


def _moments(state, which: List[torch.Tensor]) -> Dict[str, Any]:
    return to_flax(dict(zip(state.names, which)))[0]


def model_variables(model: torch.nn.Module) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The model's (params, batch_stats) as flax numpy trees."""
    return to_flax(model.state_dict())


def state_variables(state) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The state's (params, batch_stats) as flax numpy trees: its model's
    BatchNorm statistics with ``state.params`` (whole tensors: take them
    from ``gather_for_save`` under FSDP)."""
    sd = state.model.state_dict()
    sd.update(zip(state.names, state.params))
    return to_flax(sd)


def _opt_state(state) -> Dict[str, Any]:
    """``flax.serialization.to_state_dict`` of the JAX package's optimizer
    state (``syncvsr_tpu/engine/state.py::make_optimizer``)."""
    count = np.asarray(state.count, np.int32)
    adam = {"count": count, "mu": _moments(state, state.mu),
            "nu": _moments(state, state.nu)}
    adamw = {"0": adam, "1": {"inner_state": {}}, "2": {}}
    opt = {"count": count, "hyperparams": {"lr": np.asarray(state.lr, np.float32)},
           "hyperparams_states": {"lr": {"count": count}},
           "inner_state": {"0": {}, "1": adamw} if state.optim.clip_norm > 0 else adamw}
    if state.optim.skip_nonfinite:
        opt = {"notfinite_count": np.asarray(state.notfinite_count, np.int32),
               "last_finite": np.asarray(state.last_finite, np.bool_),
               "total_notfinite": np.asarray(state.total_notfinite, np.int32),
               "inner_state": opt}
    if state.optim.accum_steps > 1:
        opt = {"mini_step": np.asarray(state.mini_step, np.int32),
               "gradient_step": np.asarray(state.gradient_step, np.int32),
               "inner_opt_state": opt, "acc_grads": _moments(state, state.acc),
               "skip_state": {}}
    return opt


def state_payload(state) -> Dict[str, Any]:
    """Host copy of the full train state, in the JAX package's layout. The
    copy is synchronous: the next train step updates the tensors in place."""
    params, batch_stats = state_variables(state)
    seeds = state.seeds
    return {
        "step": np.asarray(state.step, np.int32),
        "params": params,
        "opt_state": _opt_state(state),
        "batch_stats": batch_stats,
        "mixup_rng": _prng_key(seeds[0]),
        "dropout_rng": _prng_key(seeds[1]),
        "torch_mixup_gen": state.mixup_gen.get_state().numpy(),
        "torch_dropout_gen": state.dropout_gen.get_state().numpy(),
    }


def gather_for_save(state):
    """The state with whole tensors, ready for ``state_payload``. On a split
    state (``state.fsdp``, ``state.tp``) a collective that every rank of the
    mesh joins: it gathers the split parameters, Adam moments and
    accumulated gradient over the data group, then over the model group
    (the model keeps its shards); rank 0 then writes. Otherwise the state
    itself (each rank of a data-parallel mesh holds the whole state)."""
    if state.fsdp is None and state.tp is None:
        return state
    tensors = {"params": [p.data for p in state.params], "mu": state.mu, "nu": state.nu,
               "acc": state.acc}
    for layout in (state.fsdp, state.tp):
        if layout is not None:
            tensors = {k: None if v is None else layout.full(v) for k, v in tensors.items()}
    return dataclasses.replace(state, **tensors, fsdp=None, tp=None)


def save_train_state(ckpt_dir: str, state, step: int, keep: int = 5) -> str:
    """Writes <ckpt_dir>/step_<N>.msgpack with params/opt/batch_stats/rngs."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step}.msgpack")
    save_msgpack(path, state_payload(state))
    _prune(ckpt_dir, keep)
    return path


class AsyncCheckpointer:
    """Overlaps checkpoint serialization + disk IO with training.

    ``save`` copies the state to the host synchronously (the next step
    updates it in place), then hands msgpack-encode + atomic write + prune
    to a single worker thread. A pending save is awaited before the next one
    starts (one in flight). Call ``wait()`` before reading the file or
    exiting.
    """

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._future = None

    def save(self, ckpt_dir: str, state, step: int, keep: int = 5) -> str:
        self.wait()
        os.makedirs(ckpt_dir, exist_ok=True)
        payload = state_payload(state)
        path = os.path.join(ckpt_dir, f"step_{step}.msgpack")

        def write():
            save_msgpack(path, payload)
            _prune(ckpt_dir, keep)

        self._future = self._pool.submit(write)
        return path

    def save_msgpack(self, path: str, tree: Any) -> None:
        """Async variant of module-level ``save_msgpack`` (best-ckpt files)."""
        self.wait()
        host = _host(tree)
        self._future = self._pool.submit(save_msgpack, path, host)

    def wait(self) -> None:
        if self._future is not None:
            self._future.result()
            self._future = None

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()


def _unwrap(opt_state: Dict[str, Any], optim) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(the wrappers' fields, the ``inject_hyperparams`` state) of a saved
    ``opt_state`` laid out for ``optim``'s wrappers."""
    fields: Dict[str, Any] = {}
    for on, inner, keys in (
            (optim.accum_steps > 1, "inner_opt_state", ("mini_step", "gradient_step",
                                                        "acc_grads")),
            (optim.skip_nonfinite, "inner_state", ("notfinite_count", "last_finite",
                                                   "total_notfinite"))):
        if not on:
            continue
        if inner not in opt_state or any(k not in opt_state for k in keys):
            raise KeyError(f"opt_state: the checkpoint's optimizer state has no "
                           f"{keys[0]} ({sorted(opt_state)}); it was written without the "
                           "configured optim.accum_steps / optim.skip_nonfinite")
        fields.update((k, opt_state[k]) for k in keys)
        opt_state = opt_state[inner]
    if "hyperparams" not in opt_state:
        raise KeyError(f"opt_state: {sorted(opt_state)} is wrapped, but the config asks "
                       "for no optim.accum_steps / optim.skip_nonfinite")
    return fields, opt_state


def _adam_state(opt_state: Dict[str, Any], clipped: bool) -> Dict[str, Any]:
    inner = opt_state["inner_state"]
    return (inner["1"] if clipped else inner)["0"]


def _copy_into(tensors: List[torch.Tensor], names: List[str], flat: Dict[str, np.ndarray],
               what: str) -> None:
    missing = [n for n in names if n not in flat]
    if missing or len(flat) != len(names):
        raise KeyError(f"{what}: the checkpoint's leaves do not match the model's "
                       f"(missing {missing[:4]}, {len(flat)} against {len(names)})")
    with torch.no_grad():
        for t, n in zip(tensors, names):
            t.copy_(torch.from_numpy(np.array(flat[n])))


def restore_train_state(path: str, state):
    """Load a train-state checkpoint of either package into ``state`` (in
    place; also returned): step, parameters, BatchNorm statistics, Adam's
    moments, the schedule's count and last rate, the wrappers' states, and
    the generators (re-seeded from the config where the file has no torch
    generator states)."""
    payload = load_msgpack(path)
    load_flax(state.model, payload["params"], payload.get("batch_stats", {}))
    wrapped, opt = _unwrap(payload["opt_state"], state.optim)
    adam = _adam_state(opt, state.optim.clip_norm > 0)
    _copy_into(state.mu, state.names, from_flax(adam["mu"]), "Adam mu")
    _copy_into(state.nu, state.names, from_flax(adam["nu"]), "Adam nu")
    state.step = int(payload["step"])
    state.count = int(opt["count"])
    state.lr = float(np.float32(opt["hyperparams"]["lr"]))
    if "acc_grads" in wrapped:
        _copy_into(state.acc, state.names, from_flax(wrapped.pop("acc_grads")),
                   "acc_grads")
    for k, v in wrapped.items():
        setattr(state, k, bool(v) if k == "last_finite" else int(v))
    for key, gen, seed in (("torch_mixup_gen", state.mixup_gen, state.seeds[0]),
                           ("torch_dropout_gen", state.dropout_gen, state.seeds[1])):
        if key in payload:
            gen.set_state(torch.from_numpy(np.array(payload[key], np.uint8)))
        else:
            gen.manual_seed(seed)
    return state


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    files = [f for f in os.listdir(ckpt_dir)
             if f.startswith("step_") and f.endswith(".msgpack")]
    if not files:
        return None
    files.sort(key=lambda f: int(f.split("_")[1].split(".")[0]))
    return os.path.join(ckpt_dir, files[-1])


def _prune(ckpt_dir: str, keep: int):
    files = sorted((f for f in os.listdir(ckpt_dir)
                    if f.startswith("step_") and f.endswith(".msgpack")),
                   key=lambda f: int(f.split("_")[1].split(".")[0]))
    for f in files[:-keep]:
        os.remove(os.path.join(ckpt_dir, f))


# ---------------------------------------------------------------------------
# surgery
# ---------------------------------------------------------------------------

def partial_load(params: Any, pretrained: Any,
                 rename: Optional[Dict[str, str]] = None,
                 verbose: bool = True) -> Tuple[Any, int]:
    """Merge every pretrained leaf whose (renamed) key exists in params with a
    matching shape. Returns (merged params, n_loaded)."""
    flat = flatten(params)
    pre = flatten(pretrained)
    if rename:
        renamed = {}
        for k, v in pre.items():
            for old, new in rename.items():
                if k.startswith(old):
                    k = new + k[len(old):]
                    break
            renamed[k] = v
        pre = renamed
    loaded = 0
    for k, v in pre.items():
        if k in flat and np.shape(flat[k]) == np.shape(v):
            flat[k] = v
            loaded += 1
    if verbose:
        print(f"[ckpt] loaded {loaded}/{len(flat)} params from pretrained tree")
    return unflatten(flat), loaded


def load_ssl_pretrained(path: str, params: Any,
                        encoder_key: str = "encoder") -> Any:
    """Warm start from an SSL-pretrained landmark msgpack whose tree is
    {"student": {"encoder": ...}} (reference LRW/landmark/src/utils.py:59-71):
    the student encoder becomes the model subtree, merged by intersection."""
    pretrained = load_msgpack(path)
    if "student" in pretrained:
        pretrained = {encoder_key: pretrained["student"]["encoder"]}
    merged, _ = partial_load(params, pretrained)
    return merged


def load_params(model: torch.nn.Module, params: Any,
                batch_stats: Optional[Dict[str, Any]] = None) -> int:
    """Merge a flax ``params`` tree into ``model`` by ``partial_load`` (and
    replace its BatchNorm statistics with ``batch_stats`` when given);
    returns the number of leaves loaded."""
    own, own_stats = model_variables(model)
    merged, n = partial_load(own, params)
    load_flax(model, merged, own_stats if batch_stats is None else batch_stats)
    return n

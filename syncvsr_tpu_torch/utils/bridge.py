"""flax <-> torch weight bridge: a pure layout map.

The port's submodules carry the flax module names (``frontend.resnet.
layer1_0.conv1``, ``encoder.block_3.attn.wq``, ``audio_classifier``, ...), so
only the leaf name and the array layout change; the inverse of the rules in
``syncvsr_tpu/utils/torch_convert.py``:

==========================  ==============================  ===================
flax leaf                   flax layout                     torch leaf / layout
==========================  ==============================  ===================
conv ``kernel``             (T)HWIO                         ``weight`` OI(T)HW
Dense ``kernel``            [in, out]                       ``weight`` [out, in]
DenseGeneral wq/wk/wv       [in, H, Dh]                     ``weight`` [H, Dh, in]
DenseGeneral ``wo``         [H, Dh, out]                    ``weight`` [out, H, Dh]
depthwise conv ``dw``       (K, 1, C)                       ``weight`` [C, 1, K]
1-D conv (``stem_conv``,    (K, I, O)                       ``weight`` [O, I, K]
``conv1``, ``conv2``,
``downsample_conv``)
``stem_conv_kernel``        (5, 7, 7, 1, C) THWIO           same name, OITHW
norm ``scale``              [C]                             ``weight`` [C]
``bias``, ``cls_token``,    any                             same
``pos_bias_u/v``,
``embedding``
batch_stats ``mean/var``    [C]                             ``running_mean/var``
==========================  ==============================  ===================

Both directions take and return numpy arrays, so the bridge needs no JAX
(callers run ``np.asarray`` over a flax tree first).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_INV = {v: k for k, v in _STATS.items()}
# flax conv layouts -> torch: move the output axis first, the input axis second
_TO_TORCH = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_TO_FLAX = {n: tuple(np.argsort(p)) for n, p in _TO_TORCH.items()}
# leaves with the same name and layout on both sides (never decayed: only
# ``kernel`` is)
_SAME = ("bias", "cls_token", "pos_bias_u", "pos_bias_v", "embedding")


def flax_leaf(key: str, ndim: int) -> str:
    """The flax leaf name of torch state-dict entry ``key`` (the optimizer's
    decay mask reads it: only leaves named exactly ``kernel`` decay)."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "weight":
        return "kernel" if ndim >= 2 else "scale"
    return _STATS_INV.get(leaf, leaf)


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


# 3-D kernels by module name: DenseGeneral projections into heads and out
# of them, and 1-D convs (the depthwise one and ResNet1D's), whose
# permutations are their own inverses
_HEADS_IN = ("wq", "wk", "wv", "linear_pos")
_CONV_1D = ("dw", "stem_conv", "conv1", "conv2", "downsample_conv")


def _perm_3d(module: str, to_torch: bool) -> Tuple[int, int, int]:
    if module in _CONV_1D:
        return (2, 1, 0)
    if module in _HEADS_IN:
        return (1, 2, 0) if to_torch else (2, 0, 1)
    if module == "wo":
        return (2, 0, 1) if to_torch else (1, 2, 0)
    raise KeyError(f"no layout for the 3-D kernel of module {module!r}")


def _kernel_to_torch(path: Tuple[str, ...], a: np.ndarray) -> np.ndarray:
    if a.ndim == 3:
        return a.transpose(_perm_3d(path[-2], True))
    return a.transpose(_TO_TORCH[a.ndim])


def _kernel_to_flax(key: str, a: np.ndarray) -> np.ndarray:
    if a.ndim == 3:
        return a.transpose(_perm_3d(key.rsplit(".", 2)[-2], False))
    return a.transpose(_TO_FLAX[a.ndim])


def from_flax(params: Dict[str, Any], batch_stats: Dict[str, Any] | None = None
              ) -> Dict[str, np.ndarray]:
    """flax (params, batch_stats) nested dicts -> flat torch state dict."""
    out: Dict[str, np.ndarray] = {}
    for path, a in _flatten(params):
        leaf = path[-1]
        if leaf == "kernel":
            name, a = "weight", _kernel_to_torch(path, a)
        elif leaf == "stem_conv_kernel":
            name, a = leaf, a.transpose(_TO_TORCH[5])
        elif leaf == "scale":
            name = "weight"
        elif leaf in _SAME:
            name = leaf
        else:
            raise KeyError(f"no torch layout for flax leaf {'/'.join(path)}")
        out[".".join(path[:-1] + (name,))] = np.array(a)
    for path, a in _flatten(batch_stats or {}):
        out[".".join(path[:-1] + (_STATS[path[-1]],))] = np.array(a)
    return out


def to_flax(state_dict: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Flat torch state dict (tensors or arrays) -> flax (params, batch_stats)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, v in state_dict.items():
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        parts = key.split(".")
        leaf = parts[-1]
        if leaf in _STATS_INV:
            tree, name = stats, _STATS_INV[leaf]
        elif leaf == "stem_conv_kernel":
            tree, name, a = params, leaf, a.transpose(_TO_FLAX[5])
        elif leaf == "weight":
            name = flax_leaf(key, a.ndim)
            tree = params
            if name == "kernel":
                a = _kernel_to_flax(key, a)
        elif leaf in _SAME:
            tree, name = params, leaf
        else:
            raise KeyError(f"no flax layout for torch entry {key}")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[name] = np.array(a)  # a copy: never a view of a live tensor
    return params, stats


def load_flax(model: torch.nn.Module, params: Dict[str, Any],
              batch_stats: Dict[str, Any] | None = None) -> None:
    """Copy a flax tree into ``model`` in place; every entry must match."""
    sd = {k: torch.from_numpy(v) for k, v in from_flax(params, batch_stats).items()}
    model.load_state_dict(sd, strict=True)

"""Convert the reference's released torch checkpoints to the msgpack format
(port of ``syncvsr_tpu/tools/import_checkpoint.py``; both packages read
what it writes).

The reference's de-facto golden data is its released checkpoints
(reference README.md:60-88): the LRW word model
(``LRW_CKPT_epoch_167_step_213864.ckpt``), the LRS3 E2E
(``Vox+LRS2+LRS3.ckpt``, LRS/video/config/lrs3.yaml:102) and espnet LMs.
This tool is the one-command bridge: torch .ckpt in, ``{"params",
"batch_stats"}`` msgpack out (the flax tree ``utils/torch_convert.py``
makes, written by ``utils/checkpoint.save_msgpack``: the bytes the JAX
package's tool writes), directly consumable by ``evaluate.py ckpt=`` /
``train.py train.pretrained=`` / ``evaluate.py lm_ckpt=`` of either
package. It runs on the host: torch.load on the CPU, no card needed.

Usage (dotted k=v overrides, like every other CLI here):
    python -m syncvsr_tpu_torch.tools.import_checkpoint lrw  <in.ckpt> <out.msgpack> \
        [depth=12 dim=512 heads=8 word_boundary=true]
    python -m syncvsr_tpu_torch.tools.import_checkpoint lrs  <in.ckpt> <out.msgpack> \
        [adim=768 aheads=12 elayers=12 dlayers=6]
    python -m syncvsr_tpu_torch.tools.import_checkpoint lm   <in.pth>  <out.msgpack> \
        kind=rnn|transformer [dim=650 heads=8 layers=2]

Lightning checkpoints are unwrapped automatically (``state_dict`` key,
``model.`` / ``module.`` prefixes sniffed from the keys).
"""

from __future__ import annotations

import sys
from typing import Any, Dict

from syncvsr_tpu_torch.utils import checkpoint as ckpt
from syncvsr_tpu_torch.utils.torch_convert import (
    convert_lm,
    convert_lrs_e2e,
    convert_lrw_word_model,
)


def _load_sd(path: str) -> Dict[str, Any]:
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    # DDP wrapping ("module.") is always noise; Lightning's "model." is the
    # E2E attribute name and is handled by sniffing below
    if any(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return sd


def _sniff_prefix(sd: Dict[str, Any], probe: str) -> str:
    """'' or 'model.' depending on where the probe key lives."""
    if any(k.startswith(probe) for k in sd):
        return ""
    if any(k.startswith("model." + probe) for k in sd):
        return "model."
    raise SystemExit(
        f"cannot find '{probe}*' (with or without 'model.' prefix) among "
        f"{len(sd)} keys; first keys: {sorted(sd)[:5]}")


def _parse_kv(argv) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for a in argv:
        k, v = a.split("=", 1)
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                out[k] = v
    return out


def import_lrw(src: str, dst: str, depth: int = 12, dim: int = 512,
               heads: int = 8, word_boundary: bool = True) -> None:
    sd = _load_sd(src)
    prefix = _sniff_prefix(sd, "stem3d.")
    params, stats = convert_lrw_word_model(
        sd, depth=depth, dim=dim, heads=heads,
        use_word_boundary=word_boundary, prefix=prefix)
    ckpt.save_msgpack(dst, {"params": params, "batch_stats": stats})
    print(f"[import] lrw word model ({depth}L x {dim}d) -> {dst}")


def import_lrs(src: str, dst: str, adim: int = 768, aheads: int = 12,
               elayers: int = 12, dlayers: int = 6) -> None:
    sd = _load_sd(src)
    prefix = _sniff_prefix(sd, "encoder.frontend.")
    params, stats = convert_lrs_e2e(sd, adim, aheads, dlayers, elayers,
                                    prefix=prefix)
    ckpt.save_msgpack(dst, {"params": params, "batch_stats": stats})
    print(f"[import] lrs e2e ({elayers}L x {adim}d, {dlayers}L dec) -> {dst}")


def import_lm(src: str, dst: str, kind: str = "transformer", dim: int = 650,
              heads: int = 8, layers: int = 2) -> None:
    sd = _load_sd(src)
    params = convert_lm(sd, kind, dim, heads, layers)
    ckpt.save_msgpack(dst, {"params": params})
    print(f"[import] {kind} lm ({layers}L x {dim}d) -> {dst}")


_MODES = {"lrw": import_lrw, "lrs": import_lrs, "lm": import_lm}


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 3 or argv[0] not in _MODES:
        raise SystemExit(__doc__)
    mode, src, dst = argv[0], argv[1], argv[2]
    _MODES[mode](src, dst, **_parse_kv(argv[3:]))


if __name__ == "__main__":
    main()

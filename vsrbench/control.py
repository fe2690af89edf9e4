"""The readings that a cell's limits are set from, on the chip at the
cell's own sizes, many seeds in one process (set-up is paid once):

* ``program``: the port's three check steps against the reference, as a
  run compares them;
* ``fp8``: the control, the reference at the program's precision (the
  configuration's bf16) under ``check.Fp8`` in the program's place;
* ``plain_stated``: the reference at that precision without ``Fp8``, a
  second witness of what rounding alone gives;
* ``half``: the fault of a step that leaves out half of the batch and
  takes the mean over the rest, planted in the reference put in the
  program's place.

A step that returns its state unchanged reads 1 on ``grad_gap`` and
``change_gap`` by the measure itself and needs no run.

    python3 -m vsrbench.control --workload lrw_video.train --seeds 11,12,13 --control 3

prints one JSON line a seed, and writes them to ``--out`` too.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Any, Dict, List, Optional


def readings(cell_name: str, seed: int, device, control: bool, vectors: bool = False,
             config_overrides: Optional[Dict[str, Any]] = None,
             batch_overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    import torch

    from vsrbench import check, run, weights

    c = run.prepare(cell_name, seed, config_overrides, batch_overrides, pool=check.CHECK_STEPS)
    ref_cfg, batches, wseed = c["ref_cfg"], c["pool"], c["seeds"]["weights"]
    leaves = weights.make(weights.leaves(check.skeleton(ref_cfg)), wseed, device)
    prog = run.Program(c["conf"]["config"], c["overrides"], leaves, batches[0], device)
    del leaves
    prog_read = check.drive(prog.state, prog.step, batches, prog.to_device)
    dtype = prog.cfg.model.dtype
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = check.follow(ref_cfg, wseed, batches, device)
    read = {"program": prog_read}
    if control:
        stated = check.stated(ref_cfg, dtype)
        read["fp8"] = check.follow(stated, wseed, batches, device, control=True)
        read["half"] = check.follow(ref_cfg, wseed, batches, device,
                                    keep_rows=c["batch"]["batch_size"] // 2)
        read["plain_stated"] = check.follow(stated, wseed, batches, device)
    row = {"seed": seed}
    row.update({k: check.gaps(v, ref, detail=True) for k, v in read.items()})
    if vectors:
        row["vectors"] = {"names": ref.names, **{
            k: {"losses": v.losses, "grad": v.grad.tolist(), "change": v.change.tolist()}
            for k, v in dict(read, reference=ref).items()}}
    return row


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Readings of the program, the control and the "
                                             "faults over seeds.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3,
                    help="the first this many seeds also read the control and the fault")
    ap.add_argument("--out", default=None)
    ap.add_argument("--vectors", action="store_true",
                    help="every leaf's norms of every side, for a look at the numbers")
    args = ap.parse_args(argv)

    from vsrbench import run, spec

    run.set_cache_dirs(spec.CHECKOUT)
    import torch

    if not torch.cuda.is_available():
        print("vsrbench.control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        row = readings(args.workload, seed, device, control=i < args.control,
                       vectors=args.vectors)
        row["workload"] = args.workload
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

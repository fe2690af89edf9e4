"""What a run is made of, found by name: ``BENCHMARK.json`` at the
checkout's root, the cell's file ``cells/<cell>.json``, its configuration's
``configs/<config>.json`` and each metric's reader ``metrics/<metric>.py``.
A cell, a configuration or a metric is added by adding its file and its
entry in ``BENCHMARK.json``; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def _load(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = CHECKOUT) -> Dict[str, Any]:
    return _load(root / "BENCHMARK.json")


def cell(name: str, here: Path = HERE) -> Dict[str, Any]:
    """The cell's file, with its ``name``."""
    path = here / "cells" / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"no cell {name!r}: {path} is missing")
    return dict(_load(path), name=name)


def config(name: str, here: Path = HERE) -> Dict[str, Any]:
    return _load(here / "configs" / f"{name}.json")


def cell_metrics(bench: Dict[str, Any], cell_name: str, kind: str) -> List[Dict[str, Any]]:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those without ``workloads`` and those that list it."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def reader(name: str, here: Path = HERE) -> Callable[[Dict[str, Any]], Optional[float]]:
    """``read(record)`` of ``metrics/<name>.py``: the metric's value from a
    run's record, or None where the record holds nothing to read."""
    path = here / "metrics" / f"{name}.py"
    mod_name = "vsrbench_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

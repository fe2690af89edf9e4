"""The harness finds cells, configurations and metrics by name, and
``BENCHMARK.json`` keeps to the contract's shapes."""

import json
import re
import shutil

from vsrbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_a_new_cell_config_and_metric_are_found_with_no_code_edit(tmp_path):
    here = tmp_path / "vsrbench"
    shutil.copytree(spec.HERE / "cells", here / "cells")
    shutil.copytree(spec.HERE / "configs", here / "configs")
    shutil.copytree(spec.HERE / "metrics", here / "metrics")
    cell = dict(spec.cell("lrs3.train_long"), batch=dict(spec.cell("lrs3.train_long")["batch"],
                                                         frames=320))
    cell.pop("name")
    (here / "cells" / "lrs3.train_mid.json").write_text(json.dumps(cell))
    conf = spec.config("lrs3")
    (here / "configs" / "lrs3_copy.json").write_text(json.dumps(conf))
    (here / "metrics" / "frames_per_step.py").write_text(
        "def read(rec):\n    return rec['frames'] / rec['steps'] if rec.get('steps') else None\n")
    got = spec.cell("lrs3.train_mid", here=here)
    assert got["batch"]["frames"] == 320 and got["name"] == "lrs3.train_mid"
    assert spec.config("lrs3_copy", here=here) == conf
    assert spec.reader("frames_per_step", here=here)({"frames": 10, "steps": 4}) == 2.5
    assert spec.reader("frames_per_step", here=here)({}) is None
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}], "per_layer": []}
    assert [m["name"] for m in spec.cell_metrics(bench, "lrs3.train_mid", "end_to_end")] == ["a"]


def test_benchmark_json_keeps_to_the_contract():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("vsrbench/") and c["reduced"] == []
        assert spec.config(c["name"])["config"]["model"]
    cells = [w["name"] for w in bench["workloads"]]
    assert len(set(cells)) == len(cells)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and len(w["why"]) <= 200 and w["chips"] == 1
        cell = spec.cell(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert callable(spec.reader(m["name"]))
        for cell in m.get("workloads", []):
            assert cell in cells
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] == "train_frames_per_s" and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"

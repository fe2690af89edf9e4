"""The run's guards and the shape of its last line."""

import json
import math
import shutil
import subprocess
import sys

import pytest

from vsrbench import run, spec
from vsrbench.tests.conftest import SIZES


def test_jax_check_compares_whole_top_level_names():
    assert run.foreign_modules(["jax", "jax.numpy", "numpy"]) == ["jax"]
    assert run.foreign_modules(["syncvsr_tpu.models", "syncvsr_tpu_torch.models"]) == [
        "syncvsr_tpu"]
    assert run.foreign_modules(["syncvsr_tpu_torch", "syncvsr_tpu_torch.ops", "flaxen"]) == []
    assert run.foreign_modules(["jaxlib.xla_client", "flax.linen"]) == ["flax", "jaxlib"]


def test_a_run_without_a_card_fails_and_prints_nothing(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "lrw_video.train", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_a_run_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(spec.CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "vsrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch; from vsrbench import run; "
            "r = run.run('lrw_video.train', 1, 0.1, False, device='cpu')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode != 0 and "syncvsr_tpu_torch" in out.stderr


@pytest.mark.parametrize("trace", [0, 1])
def test_the_last_line(trace):
    co, bo = SIZES["lrw_video.train"]
    r = run.run("lrw_video.train", 2 ** 31 + 99, 0.5, bool(trace), device="cpu",
                config_overrides=co, batch_overrides=bo)
    line = json.loads(json.dumps(r))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    bench = spec.benchmark()
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in spec.cell_metrics(bench, "lrw_video.train", kind)}
    for name, m in line["metrics"].items():
        assert allowed[name] == m["unit"] and math.isfinite(m["value"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert all(len(line["breakdown"][k]) <= 10 for k in ("device_ops", "idle_gaps"))
    else:
        assert {"train_frames_per_s", "setup_s"} <= set(line["metrics"])
    for c in line["compared"].values():
        assert c["value"] <= c["limit"]

"""The plain reference against the port's plain path at toy widths on the
CPU: the same weights, batches and generator seeds give the same three
steps (the reference is a frozen copy of the port's plain paths)."""

import pytest
import torch

from vsrbench import check, run, weights
from vsrbench.tests.conftest import SIZES


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_reference_follows_the_port(cell):
    co, bo = SIZES[cell]
    c = run.prepare(cell, 2 ** 31 + 5, co, bo, pool=check.CHECK_STEPS)
    cpu = torch.device("cpu")
    wseed = c["seeds"]["weights"]
    leaves = weights.make(weights.leaves(check.skeleton(c["ref_cfg"])), wseed, cpu)
    prog = run.Program(c["conf"]["config"], c["overrides"], leaves, c["pool"][0], cpu)
    got = check.drive(prog.state, prog.step, c["pool"], prog.to_device)
    ref = check.follow(c["ref_cfg"], wseed, c["pool"], cpu)
    found = check.gaps(got, ref)
    assert found["loss_gap"] < 1e-6
    assert found["grad_gap"] < 1e-5
    assert found["change_gap"] < 1e-5
    assert all(x > 0 for x in ref.losses)


def test_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    root = Path(check.__file__).parent / "reference"
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("syncvsr_tpu_torch", "syncvsr_tpu", "jax",
                                                  "jaxlib", "flax"), (path, name)

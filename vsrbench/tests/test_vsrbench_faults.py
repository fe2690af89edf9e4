"""A run with the timed path broken underneath reads ``correct`` false: the
harness's look for a card skipped, the rest of the run driven on the CPU at
toy widths, against each cell's own limits. And the control, the
reference in float8 put in the program's place, fails them too."""

import pytest
import torch

from vsrbench import check, control, run, spec
from vsrbench.tests.conftest import SIZES, need_card


def _unchanged(build):
    """A step that returns its state unchanged (it computes, then puts the
    parameters and Adam's moments back)."""
    def factory(aug_fn=None):
        step = build(aug_fn=aug_fn)

        def broken(state, batch):
            keep = [t.detach().clone() for t in state.params + state.mu + state.nu]
            state, metrics = step(state, batch)
            with torch.no_grad():
                torch._foreach_copy_(state.params + state.mu + state.nu, keep)
            return state, metrics
        return broken
    return factory


def _half(build):
    """A step that leaves out half of the batch and takes the mean over the
    rest."""
    def factory(aug_fn=None):
        step = build(aug_fn=aug_fn)

        def broken(state, batch):
            n = next(iter(batch.values())).shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})
        return broken
    return factory


FAULTS = {"unchanged": _unchanged, "half": _half}


@pytest.mark.parametrize("cell", sorted(SIZES))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_step_is_not_correct(cell, fault):
    from syncvsr_tpu_torch.engine import build_train_step

    co, bo = SIZES[cell]
    r = run.run(cell, 2 ** 31 + 7, 0.3, False, device="cpu", config_overrides=co,
                batch_overrides=bo, step_factory=FAULTS[fault](build_train_step))
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["compared"].values())


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_the_control_is_not_correct(cell):
    co, bo = SIZES[cell]
    row = control.readings(cell, 2 ** 31 + 8, torch.device("cpu"), True,
                           config_overrides=co, batch_overrides=bo)
    limits = spec.cell(cell)["limits"]
    assert check.judge(row["program"], limits)[0]
    assert not check.judge(row["fp8"], limits)[0]
    assert not check.judge(row["half"], limits)[0]


@pytest.mark.chip
@pytest.mark.parametrize("cell", sorted(SIZES))
def test_the_control_is_not_correct_at_the_cells_size(cell):
    need_card()
    from vsrbench import spec as s

    run.set_cache_dirs(s.CHECKOUT)
    row = control.readings(cell, 2 ** 31 + 9, torch.device("cuda"), True)
    limits = spec.cell(cell)["limits"]
    assert check.judge(row["program"], limits)[0]
    assert not check.judge(row["fp8"], limits)[0]
    assert not check.judge(row["half"], limits)[0]

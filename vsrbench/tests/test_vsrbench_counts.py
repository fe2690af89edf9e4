"""The operation and byte counts against hand counts."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from vsrbench import check, counts, run, weights
from vsrbench.tests.conftest import SIZES


def test_sync_ce_by_hand():
    # [N=6, D=5] x [5, slots 2 * V 4]
    flops, nbytes = counts.sync_ce(6, 5, 2, 4, 2)
    assert flops == 2 * 6 * 5 * 8
    assert nbytes == 6 * 5 * 2 + 5 * 8 * 2 + 8 * 4 + 6 * 2 * 4 + 8


def test_bn_stats_by_hand():
    # one call over [N=10, C=3] in bf16: forward reads x, writes two sums;
    # backward reads g and x, mean and inv, writes two sums
    assert counts.bn_stats([(10, 3)], 2) == (30 * 2 + 24) + (2 * 30 * 2 + 24 + 24)


def test_bound_takes_the_larger():
    assert counts.bound_s(989e12, 0) == 1.0
    assert counts.bound_s(0, 3.35e12) == 1.0


def test_flop_counter_on_one_linear_layer():
    # forward 2 N I O, backward twice that (input and weight gradients)
    layer = torch.nn.Linear(7, 3)
    x = torch.randn(5, 7, requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        layer(x).sum().backward()
    assert fc.get_total_flops() == 3 * 2 * 5 * 7 * 3


def test_step_counts_scale_with_the_batch():
    co, bo = SIZES["lrs3.train_long"]
    c = run.prepare("lrs3.train_long", 11, co, bo, pool=1)
    cpu = torch.device("cpu")
    leaves = weights.make(weights.leaves(check.skeleton(c["ref_cfg"])), 3, cpu)
    got = counts.step_counts(c["ref_cfg"], leaves, c["pool"][0], cpu, bo["batch_size"])
    n_bn = sum(1 for m in check.skeleton(c["ref_cfg"]).modules()
               if type(m).__name__ == "FastBatchNorm")
    assert len(got["bn"]) == n_bn
    b, t = bo["batch_size"], bo["frames"]
    assert got["sync"][0][0] == b * t
    assert got["flops"] > 0 and got["flops"] % b == 0

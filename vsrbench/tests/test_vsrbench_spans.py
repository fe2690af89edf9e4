"""The span windows' attribution on hand-built traces: idle gaps by the step
phase that was dispatching, and kernels by phase, by span and by module (a
backward kernel by its autograd sequence number), each adding up exactly;
nothing where the windows ran other device ops."""

import json

import pytest
import torch

from vsrbench import spans as sp

B = 10 ** 12   # ns: a clock reading 1000 s after its epoch
US = 1000


def _ev(name, start, end, tid=1, seq=-1):
    return sp._Ev(name, start, end, tid, seq)


def _dev(name, a, b):
    """A device op over [a, b) us."""
    return (name, (B + a * US) * 1e-9, (B + b * US) * 1e-9)


def _idle_case():
    """The device-only window's ops, with gaps [95, 105), [190, 210),
    [240, 300) and [310, 330) us, over 2 steps, and their names; the
    host-and-device window launched b in the forward, c and d in the
    update, e outside any phase."""
    ops = [_dev("a", 0, 95), _dev("b", 105, 190), _dev("c", 210, 240), _dev("d", 300, 310),
           _dev("e", 330, 340)]
    launched = ["step.forward", "step.forward", "step.update", "step.update", sp.OUTSIDE]
    return ops, [op[0] for op in ops], launched


def test_idle_gaps_go_to_the_phase_that_launched_the_op_ending_them():
    ops, names, launched = _idle_case()
    got = sp.idle_by_phase(ops, 2, launched, names)
    assert got["idle_ms"] == pytest.approx({"step.forward": 10e-3 / 2, "step.backward": 0.0,
                                            "step.update": (20e-3 + 60e-3) / 2,
                                            sp.OUTSIDE: 20e-3 / 2}, rel=1e-6)
    assert sum(got["idle_ms"].values()) == pytest.approx(got["gaps_ms"], rel=1e-12)
    assert got["gaps_ms"] == pytest.approx(110e-3 / 2, rel=1e-6)
    assert got["busy_s"] == pytest.approx(230e-6, rel=1e-6)
    # a copy this window has and the other lacks takes the phase of the next
    # op placed: the gap [240, 300) split by a copy at [260, 261) stays the
    # update's; 40 back-to-back ops after e keep the lone copy under 5%
    tail = [_dev("f", 340 + k, 341 + k) for k in range(40)]
    extra = ops[:3] + [_dev("Memcpy DtoH (Device -> Pageable)", 260, 261)] + ops[3:] + tail
    got = sp.idle_by_phase(extra, 2, launched + [sp.OUTSIDE] * 40, names + ["f"] * 40)
    assert got["idle_ms"] == pytest.approx({"step.forward": 10e-3 / 2, "step.backward": 0.0,
                                            "step.update": (20e-3 + 59e-3) / 2,
                                            sp.OUTSIDE: 20e-3 / 2}, rel=1e-6)
    # a device-only trace that lost its last op: the other window's first
    # ops match it, and the lost op's gap is not seen
    lost = sp.idle_by_phase(extra[:-1], 2, launched + [sp.OUTSIDE] * 40, names + ["f"] * 40)
    assert lost["idle_ms"] == pytest.approx(got["idle_ms"], rel=1e-6)
    assert sp.idle_by_phase([], 1) == {}


def test_idle_by_phase_reads_nothing_where_the_windows_ran_other_ops():
    ops, names, launched = _idle_case()
    for other in (names[:-1], names[:2] + ["x", "y", "z"], None):
        got = sp.idle_by_phase(ops, 2, launched, other)
        assert "idle_ms" not in got
        assert got["gaps_ms"] == pytest.approx(110e-3 / 2, rel=1e-6)
        assert got["busy_s"] == pytest.approx(230e-6, rel=1e-6)
    assert "a kernel at 4 has no match" in sp.idle_by_phase(ops, 2, launched, names[:-1])[
        "matched"]


def _trace():
    """Main thread 1 and the autograd engine's thread 2; times in ns."""
    spans = [
        _ev("step.forward", 0, 100), _ev("step.augment", 0, 10), _ev("model.frontend", 10, 50),
        _ev("kernel.bn_stats", 20, 30), _ev("model.encoder", 50, 80),
        _ev("kernel.sync_ce", 85, 95), _ev("step.backward", 100, 200),
        _ev("step.update", 200, 250), _ev("train.host_metrics", 260, 270),
        _ev("kernel.bn_stats.bwd", 115, 125, tid=2),
        _ev(sp.EVALUATE + ": XBackward0", 110, 130, tid=2, seq=7),
        _ev(sp.EVALUATE + ": YBackward0", 140, 160, tid=2, seq=9),
        _ev(sp.EVALUATE + ": torch::autograd::AccumulateGrad", 170, 180, tid=2),
    ]
    numbered = [_ev("aten::mul", 5, 6, seq=9),          # under step.augment, then
                _ev("aten::mul", 22, 23, seq=7),        # the frontend's op 7
                _ev("aten::addmm", 60, 61, seq=9),      # the encoder's op 9 (the later)
                _ev("XBackward0", 111, 129, tid=2, seq=7)]
    # (name, launch thread, launch ns, device ns) a kernel; launch None: unlinked
    kernels = [("k_aug", 1, 5, 1000), ("k_bn", 1, 25, 2000), ("k_fe", 1, 40, 3000),
               ("k_enc", 1, 60, 4000), ("k_sync", 1, 90, 500), ("k_bn_bwd", 2, 120, 700),
               ("k_enc_bwd", 2, 150, 800), ("k_acc", 2, 175, 50), ("k_upd", 1, 220, 900),
               ("k_metrics", 1, 265, 30), ("k_lost", 1, None, 10), ("k_upd_op", 1, 230, 5)]
    launches, ops, rows = {}, {}, []
    for i, (name, tid, at, dur) in enumerate(kernels):
        corr, linked = 1000 + i, 0
        if name == "k_upd_op":            # no runtime call: through its op
            linked = 77
            ops[77] = _ev("aten::add_", at, at + 1, tid)
        elif at is not None:
            launches[corr] = _ev("cudaLaunchKernel", at, at + 1, tid)
        rows.append((name, 10 ** 6 + i, dur, corr, linked, False))
    # a copy, launched in the update: a device op, not a kernel
    launches[99] = _ev("cudaMemcpyAsync", 240, 241, 1)
    rows.append(("Memcpy DtoH (Device -> Pageable)", 10 ** 6 + 50, 777, 99, 0, True))
    return {"device": rows, "launches": launches, "ops": ops, "intervals": spans,
            "numbered": numbered}


def _own_times(recs):
    """A device-only window that ran the trace's kernels in the same times."""
    return [(d[0], d[2] * 1e-9) for d in recs["device"] if not d[5]]


def test_kernels_go_to_their_phase_span_and_module():
    recs = _trace()
    got = sp.attribute(recs, 1, _own_times(recs))
    ms = 1e-6
    assert got["phase_ms"] == pytest.approx({
        "step.forward": 10500 * ms, "step.backward": 1550 * ms, "step.update": 905 * ms,
        sp.OUTSIDE: 40 * ms})
    assert sum(got["phase_ms"].values()) == pytest.approx(got["kernel_ms"], rel=1e-12)
    assert got["kernel_ms"] == pytest.approx(12995 * ms)
    under = got["under_ms"]
    assert under["step.augment"] == pytest.approx(1000 * ms)
    assert under["model.frontend"] == pytest.approx((2000 + 3000 + 700) * ms)
    assert under["model.encoder"] == pytest.approx((4000 + 800) * ms)
    assert under["kernel.sync_ce"] == pytest.approx(500 * ms)
    assert under["kernel.bn_stats"] == pytest.approx(2000 * ms)
    assert under["kernel.bn_stats.bwd"] == pytest.approx(700 * ms)
    assert under["train.host_metrics"] == pytest.approx(30 * ms)
    # modules fit inside the phases they ran in
    assert under["model.frontend"] + under["model.encoder"] <= (
        got["phase_ms"]["step.forward"] + got["phase_ms"]["step.backward"])
    inner = got["innermost_ms"]
    assert sum(inner.values()) == pytest.approx(got["kernel_ms"], rel=1e-12)
    assert inner["kernel.bn_stats.bwd"] == pytest.approx(700 * ms)
    assert inner["step.backward"] == pytest.approx(850 * ms)   # thread 2, outside any span
    assert inner["model.frontend"] == pytest.approx(3000 * ms)
    assert got["unlinked"] == 1 and got["before_launch"] == 0
    assert got["launches"] == {"step.forward": 5, "step.backward": 3, "step.update": 2,
                               sp.OUTSIDE: 2}
    assert got["kernels_under"]["kernel.bn_stats.bwd"] == [["k_bn_bwd", pytest.approx(700 * ms)]]
    assert sp.attribute(dict(_trace(), device=[]), 1) == {}
    assert got["durations"] == ("12 ops against 12: 0 places differ in name, "
                                "0 copies in one window only, 0 left over")
    assert got["window4_kernel_ms"] == pytest.approx(got["kernel_ms"], rel=1e-12)
    assert got["op_names"][-1].startswith("Memcpy") and got["op_phases"] == [
        "step.forward"] * 5 + ["step.backward"] * 3 + ["step.update", sp.OUTSIDE, sp.OUTSIDE,
                                                         "step.update", "step.update"]


def test_kernels_take_the_device_only_windows_times_where_it_ran_the_same():
    recs = _trace()
    kernels = [d for d in recs["device"] if not d[5]]
    # the device-only window: the same twelve kernels, 2 us each
    window1 = [(k[0], 2e-6) for k in kernels]
    got = sp.attribute(recs, 1, window1)
    assert got["durations"] == ("12 ops against 12: 0 places differ in name, "
                                "0 copies in one window only, 0 left over")
    assert got["kernel_ms"] == pytest.approx(12 * 2e-3)
    assert got["window4_kernel_ms"] == pytest.approx(12995e-6)
    assert got["phase_ms"]["step.forward"] == pytest.approx(5 * 2e-3)
    assert got["under_ms"]["model.frontend"] == pytest.approx(3 * 2e-3)
    # another kernel name at a place (a vectorized against an unrolled
    # kernel of the same op) is taken while few places differ
    assert sp.matched(["a"] * 40, ["a"] * 38 + ["b"] * 2) == (list(range(40)), (
        "40 ops against 40: 2 places differ in name, 0 copies in one window only, 0 left over"))
    # a trace that lost its last ops matches the other's first ones as a prefix
    assert sp.matched(["a"] * 40, ["a"] * 41)[0] is None
    assert sp.matched(["a"] * 40, ["a"] * 41, prefix=True)[0] == list(range(40))
    assert sp.matched(["a"] * 40, ["a"] * 37 + ["b"] * 3)[0] is None
    # a copy or memset that one window lacks is passed over, a kernel is not
    copy, memset = "Memcpy HtoD (Pageable -> Device)", "Memset (Device)"
    assert sp.matched(["a", copy, "b"] + ["c"] * 60, ["a", "b", memset] + ["c"] * 60)[0] == (
        [0, None, 1] + list(range(3, 63)))
    assert sp.matched(["a", "b"] + ["c"] * 60, ["a", "x", "b"] + ["c"] * 60)[0] is None
    # where the windows ran other kernels: launches by phase, and no ms
    window1[3] = ("other", 2e-6)
    for w1, how in ((window1, "12 ops against 12: 1 places differ in name, 0 copies in one "
                              "window only, 0 left over"),
                    (window1[:-1], "12 ops against 11, a kernel at 11 has no match"),
                    (None, "12 ops against 0, a kernel at 0 has no match")):
        other = sp.attribute(recs, 1, w1)
        assert other["durations"] == how
        assert other["launches"] == got["launches"]
        assert other["window4_kernel_ms"] == pytest.approx(12995e-6)
        assert not {"kernel_ms", "phase_ms", "under_ms", "innermost_ms",
                    "kernels_under"} & set(other)


def test_runtime_calls_are_told_from_ops():
    for name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cudaMemcpyAsync",
                 "cuLaunchKernelEx"):
        assert sp._runtime(name)
    for name in ("aten::cumsum", "cumsum", "custom_op", "cuda_sync", "step.forward"):
        assert not sp._runtime(name)


def test_a_cpu_profile_gives_the_spans_and_the_numbered_ops():
    from torch.profiler import ProfilerActivity, profile

    from syncvsr_tpu_torch.utils import profiling

    x = torch.ones(4, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.spans():
        with profiling.span("step.forward"), profiling.span("model.encoder"):
            y = (x * 3).sum()
        with profiling.span("step.backward"):
            y.backward()
    recs = sp.kineto_records(prof, profiling.SPANS)
    names = [iv.name for iv in recs["intervals"]]
    assert {"step.forward", "model.encoder", "step.backward"} <= set(names)
    assert any(n.startswith(sp.EVALUATE) for n in names)
    assert any(ev.name == "aten::mul" and ev.seq >= 0 for ev in recs["numbered"])
    assert recs["device"] == [] and sp.attribute(recs, 1) == {}


def test_measure_runs_the_windows_of_a_toy_cell_on_the_cpu():
    from vsrbench.tests.conftest import SIZES

    co, bo = SIZES["lrw_video.train"]
    line = json.loads(json.dumps(sp.measure("lrw_video.train", 2 ** 31 + 99, 2, device="cpu",
                                            config_overrides=co, batch_overrides=bo)))
    assert line["steps"] == 2 and line["card"] is None
    # no device ops on the CPU: only the program's own counter reads
    assert line["metrics"] == {"host_reads_per_step.train": 6.0}
    assert line["spans"]["idle"]["host_reads_by_site"] == {"train.host_metrics": 6.0}
    assert line["spans"]["idle"]["spans"] > 0

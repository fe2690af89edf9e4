"""PyTorch port: each measurement tool (``syncvsr_tpu_torch/tools/``) runs
through its entry point at a toy size on the CPU (``--device cpu``) and
prints one JSON line with the device, the card (null here) and its
numbers; without a card and without ``--device cpu`` a tool raises, and the
two variants with no counterpart (``bench_bn ab``, ``bisect_bs16
att_barrier``) raise with the reason."""

import json

import pytest
import torch

from syncvsr_tpu_torch.tools import (
    bench_aux_workloads,
    bench_beam_parts,
    bench_bn,
    bench_decode,
    bench_loader,
    bench_stem,
    bisect_bs16,
    profile_step,
)
import torch_threads  # noqa: F401  (one torch thread a test process)

CPU = ["--device", "cpu"]
CASES = {
    "bench_loader": (bench_loader, ["--tiny", "--threads", "1,2"],
                     {"n_clips", "decoder", "results", "best_clips_per_sec", "batch"}),
    "bench_loader_sentence": (bench_loader, ["--tiny", "--sentence", "--threads", "2"],
                              {"n_clips", "decoder", "results", "task"}),
    "bench_decode_beam": (bench_decode, ["beam", "--tiny", "--frames", "10", "--beam", "3"],
                          {"mode", "sec_per_utt", "ms_per_step", "note", "vocab"}),
    "bench_decode_greedy": (bench_decode, ["greedy", "--tiny", "--frames", "10"],
                            {"mode", "sec_per_utt"}),
    "bench_decode_train1800": (bench_decode, ["train1800", "--tiny", "--frames", "12"],
                               {"mode", "sec_per_step", "loss_finite", "peak_bytes"}),
    "bench_decode_testset": (bench_decode, ["testset", "--tiny", "--beam", "2"],
                             {"mode", "padded", "per_bucket", "per_utt_sample"}),
    "bench_decode_trained": (bench_decode, ["trained", "--tiny", "--frames", "20", "--beam",
                                            "2", "--steps", "5"],
                             {"mode", "worst_case_random", "trained", "early_exit_speedup"}),
    "bench_beam_parts": (bench_beam_parts, ["16", "3", "--steps", "3", "--tiny"],
                         {"ms_scorer", "ms_decoder_memkv", "ms_decoder_reproject",
                          "ms_cache_gather", "ms_topk"}),
    "bench_stem": (bench_stem, ["--tiny", "--iters", "1"], {"bfloat16", "float32", "clips"}),
    "profile_step": (profile_step, ["lrw_landmark", "--tiny", "--steps", "1", "--top", "3"],
                     {"step_ms", "kernel_ms_per_step", "launches_per_step", "groups", "top",
                      "idle_share"}),
    "bench_bn_micro": (bench_bn, ["micro", "--tiny", "--iters", "1"],
                       {"mode", "shapes", "per_step"}),
    "bench_bn_step": (bench_bn, ["step", "--tiny", "--iters", "1"],
                      {"mode", "step_ms", "plain_bn_step_ms"}),
    "bench_aux_workloads": (bench_aux_workloads, ["--tiny", "--steps", "1"],
                            {"lrw_landmark", "lrs3_audio"}),
    "bisect_bs16": (bisect_bs16, ["model", "2", "--frames", "8", "--tiny", "--steps", "1"],
                    {"variant", "ms_per_step", "peak_bytes", "ok"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tool_prints_its_json_line_on_the_cpu(case, capsys):
    module, argv, keys = CASES[case]
    got = module.main(argv + CPU)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(got))
    assert line["tool"] == module.__name__.split(".")[-1]
    assert line["device"] == "cpu" and "card" in line
    assert keys <= set(line), keys - set(line)
    if case == "bench_aux_workloads":   # each path's kernels counted a step
        for path in ("lrw_landmark", "lrs3_audio"):
            assert line[path]["ms_per_step"] > 0
            assert set(line[path]["launches_per_step"]) == {
                "sync_ce_fwd", "sync_ce_split_fwd", "bn_stats_fwd", "bn_stats_bwd"}


@pytest.mark.parametrize("variant", bisect_bs16.VARIANTS)
def test_bisect_bs16_variants_run(variant):
    line = bisect_bs16.main([variant, "2", "--frames", "8", "--tiny", "--steps", "1"] + CPU)
    assert line["variant"] == variant and line["ms_per_step"] > 0


def test_no_counterpart_variants_raise():
    with pytest.raises(NotImplementedError, match="TPU layout levers"):
        bench_bn.main(["ab"] + CPU)
    with pytest.raises(NotImplementedError, match="no counterpart"):
        bisect_bs16.main(["att_barrier"] + CPU)


def test_tools_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the default on a machine without a card")
    for module, argv in ((bench_stem, ["--tiny"]), (bench_bn, ["micro", "--tiny"]),
                         (profile_step, ["--tiny"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main(argv)

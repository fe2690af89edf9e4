"""PyTorch port: the launch geometry of kernels K1, K2, K3 and K4 (pure
Python, as their wrappers compute it and the CUDA sources mirror it) at the shapes the
train steps give them, on the CPU: no idle thread, every row covered, the
scratch big enough, and a block on every SM of the H100 where the rows
allow."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from syncvsr_tpu_torch.ops import cuda_bn, cuda_sync  # noqa: E402

SMS = 132   # H100 SXM
SMEM_PER_SM = 233472          # bytes of shared memory an SM holds (228 KB)
SMEM_RESERVED = 1024          # the runtime's share per block

BN_SHAPES = sorted({(n, c) for shapes in chip_smoke.bn_shapes().values()
                    for n, c, _ in shapes} | {(n, c) for n, c, _ in chip_smoke.BN_EXTRA})


def _check_bn_geometry(geo, launch, n, c, elem_size, max_strips):
    tpr = c // (16 // elem_size)             # threads a row: one 16-byte load each
    threads, rpi, strips = geo["threads"], geo["rows_per_iter"], geo["strips"]
    # whole row groups, no idle thread, at most the 256 a block is built for
    assert threads == rpi * tpr <= 256 and threads % tpr == 0
    assert rpi == max(1, 256 // tpr)
    # the kernel's strips of ceil(n / strips) rows cover every row, none empty
    rows = -(-n // strips)
    assert geo["rows"] == rows and strips * rows >= n and (strips - 1) * rows < n
    assert 1 <= strips <= max_strips
    # the per-device scratch holds the partials and the groups' sums
    assert geo["scratch_floats"] >= (strips + -(-strips // 16)) * 2 * c
    assert geo["scratch_floats"] <= cuda_bn._SCRATCH_FLOATS
    # a block on every SM wherever the rows give each one a row group
    if -(-n // rpi) >= SMS:
        assert strips >= SMS
    # the wrapper's cached launch is this geometry; it refuses a C whose
    # 16-byte groups are not whole or overflow a block, and other dtypes
    dtype = torch.bfloat16 if elem_size == 2 else torch.float32
    assert launch(n, c, dtype) == (strips, geo["scratch_floats"], int(elem_size == 2))
    vec = 16 // elem_size
    assert launch(n, c + vec // 2, dtype) is None
    assert launch(n, 257 * vec, dtype) is None
    assert launch(n, c, torch.float16) is None


@pytest.mark.parametrize("elem_size", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,c", BN_SHAPES, ids=[f"{n}x{c}" for n, c in BN_SHAPES])
def test_k4_geometry(n, c, elem_size):
    _check_bn_geometry(cuda_bn.bwd_geometry(n, c, elem_size), cuda_bn._bwd_launch, n, c,
                       elem_size, 2 * SMS)


@pytest.mark.parametrize("elem_size", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,c", BN_SHAPES, ids=[f"{n}x{c}" for n, c in BN_SHAPES])
def test_k3_geometry(n, c, elem_size):
    _check_bn_geometry(cuda_bn.fwd_geometry(n, c, elem_size), cuda_bn._fwd_launch, n, c,
                       elem_size, cuda_bn._FWD_MAX_STRIPS)
    # what the wrapper refuses on a CUDA tensor, with the reason: a C of
    # partial 16-byte groups, and a dtype the kernel does not take
    vec = 16 // elem_size
    dtype = torch.bfloat16 if elem_size == 2 else torch.float32
    with pytest.raises(ValueError, match="multiple of"):
        cuda_bn._check_2d("bn_stats", torch.zeros(2, c + vec // 2, dtype=dtype))
    with pytest.raises(ValueError, match="bf16 or f32"):
        cuda_bn._check_2d("bn_stats", torch.zeros(2, c, dtype=torch.float16))


@pytest.mark.parametrize("n", [8 * chip_smoke.LRS3_FRAMES, 32 * chip_smoke.AUDIO_FRAMES, 1000,
                               33, 1])
def test_k2_geometry(n):
    geo = cuda_sync.split_geometry(n, 8)
    tiles, slots = geo["grid"]
    assert slots == 8 and tiles * geo["rows"] >= n > (tiles - 1) * geo["rows"]
    assert geo["blocks"] == tiles * slots
    # two warpgroups, each with half of the 320 columns: no idle thread at
    # lrs3's vocabulary of 320
    assert geo["threads"] == 2 * 128 and 2 * geo["columns_per_warpgroup"] == 320
    # two blocks share an SM, so the grid runs in one wave up to 264 blocks
    assert 2 * (geo["smem_bytes"] + SMEM_RESERVED) <= SMEM_PER_SM
    if n == 8 * chip_smoke.LRS3_FRAMES:
        assert SMS <= geo["blocks"] <= 2 * SMS


LRW_N = 29 * 96   # lrw_video's rows: 96 clips of 29 frames
LANDMARK_N = 29 * 1024   # lrw_landmark's: 1024 clips of 29 frames


@pytest.mark.parametrize("slots", [8, 3, 1])
@pytest.mark.parametrize("n", [LRW_N, LANDMARK_N, 1000, 33, 1])
def test_k1_geometry(n, slots):
    geo = cuda_sync.mono_geometry(n, slots)
    tiles, grid_slots = geo["grid"]
    # every row and every slot has a block, and no block is empty of rows
    assert tiles * geo["rows"] >= n > (tiles - 1) * geo["rows"] and geo["rows"] == 128
    assert grid_slots == slots and geo["blocks"] == tiles * slots
    # two warpgroups, each with half of the 320 columns of lrw_video's
    # vocabulary for both of the block's 64-row tiles: no idle thread
    assert geo["threads"] == 2 * 128
    assert geo["accumulators"] == 320 // 2 // 2 * (geo["rows"] // 64)
    # the blocks an SM should hold fit its shared memory, threads and
    # registers: the accumulators leave room in the registers a thread has
    # where the SM's 65536 are split over its four quarters by warp
    per_sm = geo["blocks_per_sm"]
    assert per_sm * (geo["smem_bytes"] + SMEM_RESERVED) <= SMEM_PER_SM
    assert per_sm * geo["threads"] <= 2048 and geo["stages"] >= 2
    warps_a_quarter = -(-per_sm * geo["threads"] // 32 // 4)
    regs = min(255, 65536 // 4 // (32 * warps_a_quarter) // 8 * 8)
    assert geo["accumulators"] + 32 <= regs
    assert geo["waves"] == pytest.approx(geo["blocks"] / (per_sm * SMS))
    if n == LRW_N and slots == 8:
        # the design's waves at lrw_video: 176 blocks of 128 rows, one a SM
        assert geo["blocks"] == 176 and per_sm == 1
        assert geo["waves"] == pytest.approx(4 / 3, abs=0.01)


@pytest.mark.parametrize("d", [513, 520, 7, 320])
def test_k1_pad_features(d):
    # the pad columns are zero, the rest the features in bf16, and the plain
    # version over the padded operands (zero weight rows below D) gives the
    # unpadded result; D a multiple of 8 in bf16 needs no copy
    rng = np.random.RandomState(d)
    n, s, v = 37, 8, 24
    x = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    w = torch.from_numpy((rng.randn(d, s * v) * 0.05).astype(np.float32))
    b = torch.from_numpy((rng.randn(s * v) * 0.1).astype(np.float32))
    tok = torch.from_numpy(rng.randint(-1, v, (n, s)).astype(np.int32))
    xp = cuda_sync.pad_features(x)
    ldx = -(-d // 8) * 8
    assert xp.shape == (n, ldx) and xp.dtype == torch.bfloat16 and xp.stride(0) == ldx
    assert torch.equal(xp[:, :d], x.to(torch.bfloat16))
    assert not bool(xp[:, d:].any())
    wp = torch.cat([w, torch.zeros(ldx - d, s * v)])
    ce, cnt = cuda_sync.sync_ce_partials_plain(xp, wp, b, tok)
    ce0, cnt0 = cuda_sync.sync_ce_partials_plain(x, w, b, tok)
    assert float(cnt) == float(cnt0) == float((tok >= 0).sum())
    assert abs(float(ce) - float(ce0)) <= 1e-6 * abs(float(ce0))
    xb = x.to(torch.bfloat16)
    assert (cuda_sync.pad_features(xb) is xb) == (d % 8 == 0)

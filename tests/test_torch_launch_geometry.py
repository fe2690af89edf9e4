"""PyTorch port: the launch geometry of kernels K2 and K4 (pure Python, as
their wrappers compute it and the CUDA sources mirror it) at the shapes the
train steps give them, on the CPU: no idle thread, every row covered, the
scratch big enough, and a block on every SM of the H100 where the rows
allow."""

import sys
from pathlib import Path

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


@pytest.mark.parametrize("elem_size", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,c", BN_SHAPES, ids=[f"{n}x{c}" for n, c in BN_SHAPES])
def test_k4_geometry(n, c, elem_size):
    geo = cuda_bn.bwd_geometry(n, c, elem_size)
    tpr = c // (16 // elem_size)             # threads a row: one 16-byte load each
    threads, rpi, strips = geo["threads"], geo["rows_per_iter"], geo["strips"]
    # whole row groups, no idle thread, at most the 256 a block is built for
    assert threads == rpi * tpr <= 256 and threads % tpr == 0
    assert rpi == max(1, 256 // tpr)
    # the kernel's strips of ceil(n / strips) rows cover every row, none empty
    rows = -(-n // strips)
    assert geo["rows"] == rows and strips * rows >= n and (strips - 1) * rows < n
    assert 1 <= strips <= 2 * SMS
    # the per-device scratch holds the partials and the groups' sums
    assert geo["scratch_floats"] >= (strips + -(-strips // 16)) * 2 * c
    assert geo["scratch_floats"] <= cuda_bn._BWD_SCRATCH_FLOATS
    # a block on every SM wherever the rows give each one a row group
    if -(-n // rpi) >= SMS:
        assert strips >= SMS
    # the wrapper's cached launch is this geometry; it refuses a C whose
    # 16-byte groups are not whole or overflow a block, and other dtypes
    dtype = torch.bfloat16 if elem_size == 2 else torch.float32
    assert cuda_bn._bwd_launch(n, c, dtype) == (strips, geo["scratch_floats"],
                                                int(elem_size == 2))
    vec = 16 // elem_size
    assert cuda_bn._bwd_launch(n, c + vec // 2, dtype) is None
    assert cuda_bn._bwd_launch(n, 257 * vec, dtype) is None
    assert cuda_bn._bwd_launch(n, c, torch.float16) is None


@pytest.mark.parametrize("n", [8 * chip_smoke.LRS3_FRAMES, 1000, 33, 1])
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

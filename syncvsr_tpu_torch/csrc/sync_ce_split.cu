// Fused sync-head projection + per-slot softmax cross-entropy, forward only,
// for wide features, on Hopper's TMA and warpgroup MMA (wgmma).
//
// Replaces the Pallas TPU kernel syncvsr_tpu/ops/pallas_sync.py::_kernel_split
// (chosen by _pallas_forward when the padded bf16 weight exceeds 4 MiB, e.g.
// D = 768 on lrs3). It computes what sync_ce.cu (K1) computes: for features
// x [N, D] (bf16), weight W [D, S*V] (bf16, slot s = columns s*V .. s*V+V-1),
// bias b [S*V] (f32) and tokens tok [N, S] (int32, < 0 = ignore),
//     sum over rows n and slots s with tok[n,s] >= 0 of
//         logsumexp_v(x[n] . W[:, s*V+v] + b[s*V+v]) - (label logit)
// and the count of such pairs.
//
// What bounds it on an H100: at the lrs3 shapes (N = 1280, D = 768, S = 8,
// V = 320) the product is 2*N*D*S*V = 5.03 GFLOP against ~5.95 MB of
// inputs, so the tensor cores (5.1 us at 989 TFLOP/s bf16), not memory. The
// first version (32-row tiles, the slots a loop inside the block, mma.sync
// with B built from scalar shared-memory loads) ran 40 blocks on 132 SMs at
// 3% of that bound, slower than cuBLAS + cross_entropy.
//
// Design:
//  - grid (64-row tile, slot): 160 blocks at lrs3; each makes the [64, V]
//    logits tile of its slot over the full D; x is re-read once per slot
//    and each slot's weight once per row tile, both from L2;
//  - 256 threads: two consumer warpgroups, warpgroup g owning columns
//    160g .. 160g+159 of the slot, an m64n160 f32 accumulator (80 registers
//    a thread); thread 0 also keeps the TMA loads in flight;
//  - a ring of kStages = 2 stages of 48 KB, ~97 KB of shared memory, so two
//    blocks share an SM and the 160 blocks run in one wave; "full"
//    mbarriers count the TMA bytes, "empty" ones the 256 consumers. A stage
//    holds the x tile [64 rows, 64 deep] at 128-byte swizzle (K-major) and
//    the slot's W tile [64 deep, 320 columns] as it lies in memory (MN-major,
//    N contiguous), as ten [64, 32] boxes at 64-byte swizzle: a 128-byte
//    swizzle atom is 64 columns wide, and 160 columns a warpgroup is no
//    multiple of it, while 64-byte atoms of 32 columns split 320 evenly.
//    So the weight needs no transposed copy;
//  - the products are wgmma.m64n160k16 (bf16 in, f32 accumulate, B by the
//    transpose bit), 4 per 64-deep stage;
//  - the epilogue stays in registers: in the accumulator layout a thread
//    holds rows 16w + lane/4 and +8 of warp w, and a row's columns sit on
//    the 4 threads of a quad, so row max, sum of exp and the label pick are
//    __shfl_xor by 1 and 2; the two warpgroups' (max, sum, label) merge
//    through 64 x 3 floats of shared memory. Columns >= V (the next slot's,
//    or TMA's zero fill past S*V) are masked to -inf and never match a
//    label; rows >= N and depths >= D are TMA's zero fill. The logits never
//    reach device memory, as on the TPU;
//  - each block writes its (sum, count) partial and takes a ticket; the
//    block that draws the last one sums the partials in block order (32
//    lanes in a fixed stride, then a fixed shuffle tree) and resets the
//    ticket. No float atomics, so the result is the same from run to run,
//    and the call is one launch. The ticket is one per device: one stream
//    at a time.
// Measured on an H100 80GB HBM3 at its 700 W power limit (chip_smoke.py) at
// the lrs3 shape: 0.02577 ms of device time, 20% of the bound; 0.03702 ms a
// call with the wrapper's host time, against 0.07008 for cuBLAS's addmm and
// cross_entropy on the same inputs. A stage's products wait for their
// completion (wgmma.wait_group 0) before its slot is handed back, so a
// block's loads and products overlap only across the two stages.
//
// D must be a multiple of 8 (16-byte rows for TMA), V a multiple of 8 and
// at most 320; x and W 16-byte aligned. A barrier wait that has not
// finished after ~2 s traps, so a fault ends the kernel instead of hanging.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                  // rows per block (one wgmma m64)
constexpr int kMaxVocab = 320;             // columns a block holds per slot
constexpr int kHalf = kMaxVocab / 2;       // columns per consumer warpgroup
constexpr int kAcc = kHalf / 2;            // f32 accumulators a thread (80)
constexpr int kDepth = 64;                 // D per stage: one 128-byte row
constexpr int kStages = 2;
constexpr int kThreads = 256;              // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kXBytes = kRows * kDepth * 2;            // 8 KB
constexpr int kWHalfBytes = kHalf * kDepth * 2;        // 20 KB, a warpgroup's W
constexpr int kStageBytes = kXBytes + 2 * kWHalfBytes;  // 48 KB
constexpr int kWBox = kDepth * 32 * 2;                 // 4 KB: a [64, 32] box of W
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + 1024-byte alignment
constexpr long long kHangCycles = 4000000000LL;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(addr), "r"(parity)
      : "memory");
  return ok != 0;
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > kHangCycles) __trap();
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets, swizzle (1 = 128-byte, 2 = 64-byte)
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)swizzle << 62);
}

// d (64 x 160 f32, wgmma accumulator layout) += A (64 x 16) * B (16 x 160);
// A K-major, B MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_m64n160k16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %82, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
      "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// tickets drawn by the blocks of the running call; the last block resets it
__device__ unsigned int g_split_tickets;

__global__ void __launch_bounds__(kThreads, 2)
sync_ce_split_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ bias,
                     const int* __restrict__ tok, float* __restrict__ partials, int n, int d,
                     int slots, int vocab) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ float merge[kRows][3];   // warpgroup 1's (max, sum of exp, label) per row
  __shared__ float red[kWarps][2];

  // 128-byte swizzle atoms are 1024 bytes: align the ring to them
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row0 = blockIdx.x * kRows;
  const int s = blockIdx.y;
  const int col0 = s * vocab;   // the slot's first column of W
  const int nk = (d + kDepth - 1) / kDepth;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int st, int kt) {
    unsigned char* base = ring + st * kStageBytes;
    mbar_expect_tx(&full[st], kStageBytes);
    tma_load(base, &tm_x, &full[st], kt * kDepth, row0);
    for (int b = 0; b < kMaxVocab / 32; ++b)
      tma_load(base + kXBytes + b * kWBox, &tm_w, &full[st], col0 + 32 * b, kt * kDepth);
  };
  if (tid == 0)
    for (int kt = 0; kt < kStages && kt < nk; ++kt) issue(kt, kt);

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % kStages;
    const uint32_t parity = (kt / kStages) & 1;
    mbar_wait(&full[st], parity);
    __syncwarp();   // wgmma is .aligned: the warp issues it together
    const unsigned char* sx = ring + st * kStageBytes;
    const unsigned char* sw = sx + kXBytes + wg * kWHalfBytes;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk) {
      // A (K-major, 128-byte swizzle): 16 bf16 = 32 bytes further along its
      // 128-byte rows, 8-row groups 1024 bytes apart. B (MN-major, 64-byte
      // swizzle): 16 rows of 64 bytes further down each [64, 32] box; its
      // 32-column groups are the boxes, kWBox apart, and its 8-row groups
      // 512 bytes apart
      wgmma_m64n160k16(acc, smem_desc(sx + 32 * kk, 16, 1024, 1),
                       smem_desc(sw + 1024 * kk, kWBox, 512, 2));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(acc[i])::"memory");
    mbar_arrive(&empty[st]);
    if (tid == 0 && kt + kStages < nk) {
      mbar_wait(&empty[st], parity);   // every consumer is done with the stage
      issue(st, kt + kStages);
    }
    __syncwarp();
  }

  // epilogue: thread holds rows ra and ra + 8; accumulators 4j, 4j+1 (row ra)
  // and 4j+2, 4j+3 (row ra + 8) are columns cb + 8j and cb + 8j + 1
  const int ra = warp * 16 + lane / 4;
  const int cb = wg * kHalf + 2 * (lane % 4);
  int ta = -1, tb = -1;
  if (row0 + ra < n) ta = tok[(long long)(row0 + ra) * slots + s];
  if (row0 + ra + 8 < n) tb = tok[(long long)(row0 + ra + 8) * slots + s];
  float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = cb + 8 * j + e;
      if (col < vocab) {
        const float bv = __ldg(bias + col0 + col);
        acc[4 * j + e] += bv;
        acc[4 * j + 2 + e] += bv;
        ma = fmaxf(ma, acc[4 * j + e]);
        mb = fmaxf(mb, acc[4 * j + 2 + e]);
      }
    }
  ma = quad_max(ma);
  mb = quad_max(mb);
  float sa = 0.f, sb = 0.f, la = 0.f, lb = 0.f;
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = cb + 8 * j + e;
      if (col < vocab) {
        sa += expf(acc[4 * j + e] - ma);
        sb += expf(acc[4 * j + 2 + e] - mb);
        if (col == ta) la = acc[4 * j + e];
        if (col == tb) lb = acc[4 * j + 2 + e];
      }
    }
  sa = quad_sum(sa);
  sb = quad_sum(sb);
  la = quad_sum(la);
  lb = quad_sum(lb);
  if (wg == 1 && lane % 4 == 0) {
    merge[ra][0] = ma;
    merge[ra][1] = sa;
    merge[ra][2] = la;
    merge[ra + 8][0] = mb;
    merge[ra + 8][1] = sb;
    merge[ra + 8][2] = lb;
  }
  __syncthreads();
  float ce = 0.f, cnt = 0.f;
  if (wg == 0 && lane % 4 == 0) {
    // warpgroup 0 always holds column 0, so its max is finite; a warpgroup
    // 1 with every column masked has max -inf and sum 0, and adds 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ra + 8 * h;
      const int t = h ? tb : ta;
      const float m0 = h ? mb : ma, s0 = h ? sb : sa, l0 = h ? lb : la;
      const float m1 = merge[r][0], s1 = merge[r][1], l1 = merge[r][2];
      const float m = fmaxf(m0, m1);
      const float se = s0 * expf(m0 - m) + s1 * expf(m1 - m);
      if (t >= 0) {
        ce += (m + logf(se)) - (l0 + l1);
        cnt += 1.f;
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    ce += __shfl_xor_sync(0xffffffffu, ce, o);
    cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  }
  if (lane == 0) {
    red[tid / 32][0] = ce;
    red[tid / 32][1] = cnt;
  }
  __syncthreads();
  if (tid >= 32) return;

  // warp 0: the block's partial, its ticket, and in the last block the sum
  // of all partials in block order
  const int blocks = gridDim.x * gridDim.y;
  unsigned int ticket = 0;
  if (tid == 0) {
    float a = 0.f, c = 0.f;
    for (int i = 0; i < kWarps / 2; ++i) {   // warpgroup 0's warps hold the rows
      a += red[i][0];
      c += red[i][1];
    }
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;
    partials[2 * blk] = a;
    partials[2 * blk + 1] = c;
    __threadfence();
    ticket = atomicAdd(&g_split_tickets, 1u);
  }
  ticket = __shfl_sync(0xffffffffu, ticket, 0);
  if (ticket != (unsigned int)blocks - 1) return;
  __threadfence();
  float a = 0.f, c = 0.f;
  for (int b = lane; b < blocks; b += 32) {
    a += __ldcg(partials + 2 * b);
    c += __ldcg(partials + 2 * b + 1);
  }
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    c += __shfl_xor_sync(0xffffffffu, c, o);
  }
  if (lane == 0) {
    partials[2 * blocks] = a;
    partials[2 * blocks + 1] = c;
    g_split_tickets = 0u;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the process has loaded (the
// library is not linked against libcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// a row-major bf16 [rows, cols] matrix in [box_rows, box_cols] boxes, zero
// fill past its edges
bool make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
              int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}



}  // namespace

// x [n, d] bf16; w [d, slots * vocab] bf16; bias [slots * vocab] f32; tok
// [n, slots] int32; partials [ceil(n/64) * slots + 1, 2] f32: block (tile,
// slot)'s (sum, count) at row slot * tiles + tile, their sum in block order
// in the last row. x and w 16-byte aligned; d and vocab multiples of 8,
// vocab <= 320. One launch.
extern "C" int sync_ce_split_fwd(const void* x, const void* w, const void* bias,
                                 const void* tok, void* partials, int n, int d, int slots,
                                 int vocab, void* stream) {
  if (n <= 0 || d <= 0 || d % 8 || slots <= 0 || vocab <= 0 || vocab > kMaxVocab ||
      vocab % 8 || ((uintptr_t)x % 16) || ((uintptr_t)w % 16))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // opt in to the dynamic shared memory once per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      sync_ce_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tm_x, tm_w;
  if (!make_map(&tm_x, x, n, d, kRows, kDepth, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&tm_w, w, d, slots * vocab, kDepth, 32, CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kRows - 1) / kRows, slots);
  sync_ce_split_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      tm_x, tm_w, (const float*)bias, (const int*)tok, (float*)partials, n, d, slots, vocab);
  return (int)cudaGetLastError();
}

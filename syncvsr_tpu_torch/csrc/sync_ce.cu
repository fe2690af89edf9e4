// Fused sync-head projection + per-slot softmax cross-entropy, forward only,
// on Hopper's TMA and warpgroup MMA (wgmma).
//
// Replaces the Pallas TPU kernel syncvsr_tpu/ops/pallas_sync.py::_kernel
// (launched by _pallas_forward when the padded bf16 weight is at most 4
// MiB: D = 513 on lrw_video, D = 512 and V = 640 on lrw1000). For features
// x [N, D] (bf16), the head's
// weight W [D, S*V] (bf16, slot s = columns s*V .. s*V+V-1), bias b [S*V]
// (f32) and tokens tok [N, S] (int32, < 0 = ignore), it computes
//     sum over rows n and slots s with tok[n,s] >= 0 of
//         logsumexp_v(x[n] . W[:, s*V+v] + b[s*V+v]) - (label logit)
// and the count of such (n, s) pairs. The [N, S, V] logits never reach
// device memory.
//
// What bounds it on an H100: at the lrw_video shapes (N = 2784, D = 513,
// S = 8, V = 320) the product is 2*N*D*S*V = 7.3 GFLOP against ~5.6 MB of
// inputs, so the tensor cores (7.4 us at 989 TFLOP/s bf16), not memory. In
// practice the reads from L2 weigh more: each row tile of a block reads its
// slots' [D, V] weight again (2.6 MB over all slots), so 64-row tiles read
// 115 MB of weight from L2 a call. The first version (32-row tiles x slot,
// mma.sync with B built from scalar shared-memory loads, one stage, a
// second launch to sum the partials) ran at 6.6% of the bound.
//
// Design, K2's (sync_ce_split.cu) with three changes:
//  - x at D = 513 has 1026-byte rows, and TMA needs 16-byte strides: the
//    wrapper copies x into a zero-filled bf16 buffer whose rows are ldx =
//    D rounded up to 8 apart, and the tensor map declares D columns with
//    that stride, so TMA fills the depth past D with zeros, as it does the
//    weight's rows past D (cuda_sync.pad_features);
//  - a stage is handed back only after the products of the next stage are
//    issued (wgmma.wait_group 1). The refill is warp 0's, in a branch
//    uniform across the warp (its index broadcast by a shuffle) with lane
//    0's TMA instructions predicated, not branched: with thread 0 alone in
//    a branch while a wgmma group is in flight, ptxas serialized every
//    wgmma (C7518). It still notes one warpgroup.wait of its own (C7517),
//    place unknown. A producer warp of its own would cost a consumer
//    warpgroup's registers, which are split over the SM's four quarters;
//  - a block holds two 64-row tiles of one slot (128 rows): two
//    warpgroups, warpgroup g owning columns 160 g .. +159 of the slot for
//    both tiles, two m64n160 f32 accumulators (80 registers each a thread),
//    so each weight tile a stage loads serves 128 rows, half the reads from
//    L2 of K2's 64-row tiles; a ring of 3 stages of 56 KB, one block a SM
//    (255 registers a thread): 176 blocks at lrw_video, 1.33 waves of 132.
//    Two other block layouts were measured on an H100 and dropped, both
//    slower (PERF.md): K2's grid (64 rows x slot, 2 stages of 48 KB, two
//    blocks a SM, 352 blocks) and (64 rows x two slots, 512 threads, 2
//    stages of 88 KB, 176 blocks: each x tile loaded once for two slots).
// The rest is K2's: a stage holds the x tile [128 rows, 64 deep] at
// 128-byte swizzle (K-major) and the slot's W tile [64 deep, 320 columns]
// as it lies (MN-major) in ten [64, 32] boxes at 64-byte swizzle; the
// softmax-CE epilogue stays in registers (quad shuffles), the two halves of
// a row's slot merge through shared memory; columns >= V are masked to
// -inf, rows >= N are TMA's zero fill and take no token.
//
// A slot wider than the 320 columns a block holds at once (lrw1000's
// wav2vec2 codec: V = 640) takes two column passes in the same block: the
// ring runs on over the passes as one sequence of (pass, depth tile) loads,
// so the second pass's first tiles arrive while the first pass ends; after
// each pass the two warpgroups merge their row statistics as above, and
// warpgroup 0 folds them into a running (max, sum of exp, label logit) per
// row in shared memory, the online logsumexp. The x tile is read again from
// L2 in the second pass; the accumulators, the ring and the grid stay as
// they are, so V <= 320 runs one pass, the code it ran before. (A wider,
// shorter block, 64 rows with 320 columns a warpgroup, would read x once but
// gives the 3840 rows of lrw1000 half the weight reuse a tile and needs a
// second layout of the ring; see PERF.md.) Each block writes
// its (sum, count) partial and takes a ticket of K1's own counter; the
// block that draws the last one sums the partials in block order into out
// and resets the counter: one launch, no float atomics, the same bits from
// run to run, one stream at a time.
//
// V must be a multiple of 8 and at most 640; ldx >= D a multiple of 8; x
// and W 16-byte aligned. A barrier wait that has not finished after ~2 s
// traps, so a fault ends the kernel instead of hanging.

#include <math.h>

#include "sync_ce_common.cuh"

namespace {

constexpr int kCols = 320;                 // columns a block holds of its slot a pass
constexpr int kMaxVocab = 2 * kCols;       // two passes
constexpr int kHalf = kCols / 2;           // columns per consumer warpgroup
constexpr int kAcc = kHalf / 2;            // f32 accumulators a thread and tile (80)
constexpr int kDepth = 64;                 // D per stage: one 128-byte row
constexpr int kTiles = 2;                  // m64 row tiles a block
constexpr int kRows = 64 * kTiles;         // 128 rows a block
constexpr int kThreads = 256;              // two consumer warpgroups
constexpr int kStages = 3;
constexpr int kTileBytes = 64 * kDepth * 2;            // 8 KB: x of one m64 tile
constexpr int kXBytes = kTiles * kTileBytes;           // 16 KB: x of a stage
constexpr int kWBytes = kCols * kDepth * 2;            // 40 KB: the slot's W of a stage
constexpr int kWHalfBytes = kWBytes / 2;               // a warpgroup's W
constexpr int kWBox = kDepth * 32 * 2;                 // 4 KB: a [64, 32] box of W
constexpr int kStageBytes = kXBytes + kWBytes;         // 56 KB
constexpr int kSmemBytes = kStages * kStageBytes + 1024;   // + 1024-byte alignment

// tickets drawn by the blocks of K1's running call; the last block resets it
__device__ unsigned int g_mono_tickets;

// The softmax-CE statistics of rows ra and ra + 8 over the warpgroup's 160
// columns of slot s in this pass (col0 = s * vocab): acc in the wgmma
// accumulator layout, where accumulators 4j, 4j+1 (row ra) and 4j+2, 4j+3
// (row ra + 8) are columns cb + 8j and cb + 8j + 1 of the slot. Returns (max, sum of exp, label logit) of
// each row, reduced over the quad that holds it; bias is added to acc.
__device__ __forceinline__ void row_stats(float* acc, const float* __restrict__ bias, int col0,
                                          int cb, int vocab, int ta, int tb,
                                          float (&st)[2][3]) {
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
  st[0][0] = ma;
  st[0][1] = quad_sum(sa);
  st[0][2] = quad_sum(la);
  st[1][0] = mb;
  st[1][1] = quad_sum(sb);
  st[1][2] = quad_sum(lb);
}

// the TMA loads of stage st for load j of the block's sequence (column pass
// j / nk, depth tile j % nk), issued by the threads with p set
__device__ __forceinline__ void issue(unsigned char* ring, uint64_t* full, int st, int j,
                                      int nk, const CUtensorMap* tm_x, const CUtensorMap* tm_w,
                                      int row0, int s, int vocab, uint32_t p) {
  unsigned char* base = ring + st * kStageBytes;
  const int kt = j % nk;
  const int c0 = s * vocab + (j / nk) * kCols;
  mbar_expect_tx_if(full + st, kStageBytes, p);
  tma_load_if(base, tm_x, full + st, kt * kDepth, row0, p);
#pragma unroll
  for (int b = 0; b < kCols / 32; ++b)
    tma_load_if(base + kXBytes + b * kWBox, tm_w, full + st, c0 + 32 * b, kt * kDepth, p);
}

__global__ void __launch_bounds__(kThreads, 1)
sync_ce_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
               const float* __restrict__ bias, const int* __restrict__ tok,
               float* __restrict__ partials, float* __restrict__ out, int n, int d, int slots,
               int vocab) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ float merge[kTiles][64][3];   // warpgroup 1's (max, sum of exp, label)
  __shared__ float rows[kTiles][64][3];    // each row's running (max, sum of exp, label)
  __shared__ float red[kThreads / 32][2];

  // 128-byte swizzle atoms are 1024 bytes: align the ring to them
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x;
  // the warp index, provably the same across the warp: the producer's
  // branch below is warp-uniform, so no warp diverges while wgmma runs
  const int warp_id = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  const int half = warp_id / 4;             // the warpgroup: which 160 columns
  const int warp = warp_id % 4;
  const int row0 = blockIdx.x * kRows;
  const int s = blockIdx.y;                 // the block's slot
  const int nk = (d + kDepth - 1) / kDepth;
  const int passes = (vocab + kCols - 1) / kCols;
  const int total = passes * nk;           // loads of the block's sequence
  const uint32_t leader = lane == 0;        // warp 0's lane 0 issues the loads

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp_id == 0)
    for (int j = 0; j < kStages && j < total; ++j)
      issue(ring, full, j, j, nk, &tm_x, &tm_w, row0, s, vocab, leader);

  float acc[kTiles][kAcc];
#pragma unroll
  for (int t = 0; t < kTiles; ++t)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[t][i] = 0.f;

  // epilogue of each pass: a consumer thread holds rows ra and ra + 8 of
  // each of its tiles, columns cb + 8j (+1) of the pass; warpgroup 1 hands
  // its row statistics to warpgroup 0 through merge, and warpgroup 0 folds
  // the block's into rows
  const int ra = warp * 16 + lane / 4;
  for (int i = 0; i < total; ++i) {
    const int st = i % kStages;
    mbar_wait(&full[st], (i / kStages) & 1);
    const unsigned char* sx = ring + st * kStageBytes;
    const unsigned char* sw = sx + kXBytes + half * kWHalfBytes;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk)
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        // A (K-major, 128-byte swizzle): 16 bf16 = 32 bytes further along
        // its 128-byte rows, 8-row groups 1024 bytes apart, tile t 8 KB on.
        // B (MN-major, 64-byte swizzle): 16 rows of 64 bytes further down
        // each [64, 32] box; its 32-column groups are the boxes, kWBox
        // apart, and its 8-row groups 512 bytes apart
        wgmma_m64n160k16(acc[t], smem_desc(sx + t * kTileBytes + 32 * kk, 16, 1024, 1),
                         smem_desc(sw + 1024 * kk, kWBox, 512, 2));
      }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the previous stage's products are done once at most this one's are
    // still in flight: hand that stage back, and warp 0 refills it
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int k = 0; k < kAcc; ++k) asm volatile("" : "+f"(acc[t][k])::"memory");
    if (i > 0) {
      const int prev = (i - 1) % kStages;
      mbar_arrive(&empty[prev]);
      if (warp_id == 0 && i - 1 + kStages < total) {
        mbar_wait(&empty[prev], ((i - 1) / kStages) & 1);   // every consumer is done
        issue(ring, full, prev, i - 1 + kStages, nk, &tm_x, &tm_w, row0, s, vocab, leader);
      }
    }
    if (i % nk != nk - 1) continue;

    const int pass = i / nk;
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int k = 0; k < kAcc; ++k) asm volatile("" : "+f"(acc[t][k])::"memory");
    const int cb = pass * kCols + half * kHalf + 2 * (lane % 4);
    float stats[kTiles][2][3];
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      const int rg = row0 + t * 64 + ra;
      const int ta = rg < n ? tok[(long long)rg * slots + s] : -1;
      const int tb = rg + 8 < n ? tok[(long long)(rg + 8) * slots + s] : -1;
      row_stats(acc[t], bias, s * vocab, cb, vocab, ta, tb, stats[t]);
      if (half == 1 && lane % 4 == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int k = 0; k < 3; ++k) merge[t][ra + 8 * h][k] = stats[t][h][k];
    }
    __syncthreads();
    if (half == 0 && lane % 4 == 0) {
      // warpgroup 0 always holds the pass's first column, so its max is
      // finite; warpgroup 1 with every column masked has max -inf and sum
      // 0, and adds 0
#pragma unroll
      for (int t = 0; t < kTiles; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* o = merge[t][ra + 8 * h];
          float* r = rows[t][ra + 8 * h];
          const float m0 = stats[t][h][0];
          float m = fmaxf(m0, o[0]);
          float se = stats[t][h][1] * expf(m0 - m) + o[1] * expf(o[0] - m);
          float lab = stats[t][h][2] + o[2];
          if (pass > 0) {   // the online logsumexp over the passes
            const float mr = fmaxf(r[0], m);
            se = r[1] * expf(r[0] - mr) + se * expf(m - mr);
            m = mr;
            lab += r[2];
          }
          r[0] = m;
          r[1] = se;
          r[2] = lab;
        }
    }
    if (pass + 1 < passes) {
      // merge is warpgroup 1's again in the next pass's epilogue
      __syncthreads();
#pragma unroll
      for (int t = 0; t < kTiles; ++t)
#pragma unroll
        for (int k = 0; k < kAcc; ++k) acc[t][k] = 0.f;
    }
  }

  float ce = 0.f, cnt = 0.f;
  if (half == 0 && lane % 4 == 0) {
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rg = row0 + t * 64 + ra + 8 * h;
        if (rg < n && tok[(long long)rg * slots + s] >= 0) {
          const float* r = rows[t][ra + 8 * h];
          ce += (r[0] + logf(r[1])) - r[2];
          cnt += 1.f;
        }
      }
  }
  for (int o = 16; o > 0; o >>= 1) {
    ce += __shfl_xor_sync(0xffffffffu, ce, o);
    cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  }
  if (lane == 0) {
    red[warp_id][0] = ce;
    red[warp_id][1] = cnt;
  }
  __syncthreads();
  if (tid >= 32) return;

  // warp 0: the block's partial, its ticket, and in the last block the sum
  // of all partials in block order
  const int blocks = gridDim.x * gridDim.y;
  unsigned int ticket = 0;
  if (tid == 0) {
    float a = 0.f, c = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) {   // warpgroup 1's hold 0
      a += red[i][0];
      c += red[i][1];
    }
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;
    partials[2 * blk] = a;
    partials[2 * blk + 1] = c;
    __threadfence();
    ticket = atomicAdd(&g_mono_tickets, 1u);
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
    out[0] = a;
    out[1] = c;
    g_mono_tickets = 0u;
  }
}

}  // namespace

// x [n, d] bf16 with rows ldx elements apart; w [d, slots * vocab] bf16;
// bias [slots * vocab] f32; tok [n, slots] int32; partials [blocks, 2] f32
// scratch, block (128-row tile, slot)'s (sum, count) at row slot * tiles +
// tile; out [2] f32 = their sum in block order. x and w 16-byte aligned;
// ldx >= d and vocab multiples of 8, vocab <= 640 (two column passes above
// 320). One launch.
extern "C" int sync_ce_fwd(const void* x, const void* w, const void* bias, const void* tok,
                           void* partials, void* out, int n, int d, int ldx, int slots,
                           int vocab, void* stream) {
  if (n <= 0 || d <= 0 || ldx < d || ldx % 8 || slots <= 0 || vocab <= 0 ||
      vocab > kMaxVocab || vocab % 8 || ((uintptr_t)x % 16) || ((uintptr_t)w % 16))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // opt in to the dynamic shared memory once per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      sync_ce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tm_x, tm_w;
  if (!make_map(&tm_x, x, n, d, ldx, kRows, kDepth, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&tm_w, w, d, slots * vocab, slots * vocab, kDepth, 32,
                CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kRows - 1) / kRows, slots);
  sync_ce_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      tm_x, tm_w, (const float*)bias, (const int*)tok, (float*)partials, (float*)out, n, d,
      slots, vocab);
  return (int)cudaGetLastError();
}

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
//    ticket, writing the sum to its own [2] result. No float atomics, so
//    the result is the same from run to run, and the call is one launch.
//    The ticket is one per device: one stream at a time.
// Measured on an H100 80GB HBM3 at its 700 W power limit (chip_smoke.py) at
// the lrs3 shape: 0.02577 ms of device time, 20% of the bound; 0.03702 ms a
// call with the wrapper's host time, against 0.07008 for cuBLAS's addmm and
// cross_entropy on the same inputs. A stage's products wait for their
// completion (wgmma.wait_group 0) before its slot is handed back, so a
// block's loads and products overlap only across the two stages.
//
// A slot wider than the 320 columns a block holds at once (the wav2vec2
// codec's V = 640 over the DC-TCN's 1664-wide head on lrw1000, an 8.5 MB
// weight) takes two column passes in the same block, as K1 does: the ring
// runs on over the passes as one sequence of (pass, depth tile) loads, so
// the second pass's first tiles arrive while the first pass ends; after
// each pass the two warpgroups merge their row statistics as above; the
// first pass's (max, sum of exp, label logit) of each row waits in shared
// memory, and warpgroup 0 folds the second's into it, the online
// logsumexp. The x tile is read again from L2 in the second pass. The two
// are instantiations of one template: V <= 320 runs the one-pass kernel
// as it was (a generic pass loop cost it 7-17% of its device time,
// measured on an H100; PERF.md). At 128 registers a thread ptxas spills 40
// bytes in the one-pass kernel and 168 in the two-pass one.
//
// D must be a multiple of 8 (16-byte rows for TMA), V a multiple of 8 and
// at most 640; x and W 16-byte aligned. A barrier wait that has not
// finished after ~2 s traps, so a fault ends the kernel instead of hanging.

#include <math.h>

#include "sync_ce_common.cuh"

namespace {

constexpr int kRows = 64;                  // rows per block (one wgmma m64)
constexpr int kCols = 320;                 // columns a block holds of its slot a pass
constexpr int kMaxVocab = 2 * kCols;       // two passes
constexpr int kHalf = kCols / 2;           // columns per consumer warpgroup
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

// tickets drawn by the blocks of the running call; the last block resets it
__device__ unsigned int g_split_tickets;

// kTwoPass: a slot of 320 < V <= 640 columns in two column passes; else one
// pass of V <= 320, the one-pass kernel as it was
template <bool kTwoPass>
__global__ void __launch_bounds__(kThreads, 2)
sync_ce_split_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ bias,
                     const int* __restrict__ tok, float* __restrict__ partials,
                     float* __restrict__ out, int n, int d, int slots, int vocab) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ float merge[kRows][3];   // warpgroup 1's (max, sum of exp, label) per row
  __shared__ float rows[kTwoPass ? kRows : 1][3];   // the first pass's, per row
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
  const int total = kTwoPass ? 2 * nk : nk;   // loads of the block's sequence

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // load j of the sequence: column pass j / nk, depth tile j % nk
  auto issue = [&](int st, int j) {
    unsigned char* base = ring + st * kStageBytes;
    const int kt = kTwoPass ? j % nk : j;
    const int c0 = kTwoPass ? col0 + (j / nk) * kCols : col0;
    mbar_expect_tx(&full[st], kStageBytes);
    tma_load(base, &tm_x, &full[st], kt * kDepth, row0);
    for (int b = 0; b < kCols / 32; ++b)
      tma_load(base + kXBytes + b * kWBox, &tm_w, &full[st], c0 + 32 * b, kt * kDepth);
  };
  if (tid == 0)
    for (int j = 0; j < kStages && j < total; ++j) issue(j, j);

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  // a thread holds rows ra and ra + 8; accumulators 4j, 4j+1 (row ra) and
  // 4j+2, 4j+3 (row ra + 8) are columns cb + 8j and cb + 8j + 1 of the slot
  const int ra = warp * 16 + lane / 4;
  // the softmax-CE statistics of rows ra and ra + 8 over the pass's columns,
  // the two warpgroups' merged: (max, sum of exp, label logit) of each row
  // in st, valid in warpgroup 0's quad leaders; adds the bias to acc
  auto pass_stats = [&](int pass, int ta, int tb, float (&st)[2][3]) {
    const int cb = pass * kCols + wg * kHalf + 2 * (lane % 4);
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
    if (wg == 0 && lane % 4 == 0) {
      // warpgroup 0 always holds the pass's first column, so its max is
      // finite; a warpgroup 1 with every column masked has max -inf and
      // sum 0, and adds 0
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ra + 8 * h;
        const float m0 = h ? mb : ma, s0 = h ? sb : sa, l0 = h ? lb : la;
        const float m1 = merge[r][0], s1 = merge[r][1], l1 = merge[r][2];
        const float m = fmaxf(m0, m1);
        st[h][0] = m;
        st[h][1] = s0 * expf(m0 - m) + s1 * expf(m1 - m);
        st[h][2] = l0 + l1;
      }
    }
  };
  int ta = -1, tb = -1;
  for (int i = 0; i < total; ++i) {
    const int st = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
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
    for (int k = 0; k < kAcc; ++k) asm volatile("" : "+f"(acc[k])::"memory");
    mbar_arrive(&empty[st]);
    if (tid == 0 && i + kStages < total) {
      mbar_wait(&empty[st], parity);   // every consumer is done with the stage
      issue(st, i + kStages);
    }
    __syncwarp();
    if (kTwoPass && i == nk - 1) {
      // the first pass's statistics wait in rows for the second's
      if (row0 + ra < n) ta = tok[(long long)(row0 + ra) * slots + s];
      if (row0 + ra + 8 < n) tb = tok[(long long)(row0 + ra + 8) * slots + s];
      float first[2][3];
      pass_stats(0, ta, tb, first);
      if (wg == 0 && lane % 4 == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int k = 0; k < 3; ++k) rows[ra + 8 * h][k] = first[h][k];
      __syncthreads();   // merge is warpgroup 1's again in the second pass
#pragma unroll
      for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
    }
  }

  if (!kTwoPass) {
    if (row0 + ra < n) ta = tok[(long long)(row0 + ra) * slots + s];
    if (row0 + ra + 8 < n) tb = tok[(long long)(row0 + ra + 8) * slots + s];
  }
  float last[2][3];
  pass_stats(kTwoPass ? 1 : 0, ta, tb, last);
  float ce = 0.f, cnt = 0.f;
  if (wg == 0 && lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = last[h][0], se = last[h][1], lab = last[h][2];
      if (kTwoPass) {   // the online logsumexp over the two passes
        const float* r = rows[ra + 8 * h];
        const float mr = fmaxf(r[0], m);
        se = r[1] * expf(r[0] - mr) + se * expf(m - mr);
        m = mr;
        lab += r[2];
      }
      if ((h ? tb : ta) >= 0) {
        ce += (m + logf(se)) - lab;
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
    out[0] = a;
    out[1] = c;
    g_split_tickets = 0u;
  }
}

// launch the kernel of kTwoPass (its dynamic shared memory opted in once a
// process)
template <bool kTwoPass>
int launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const void* bias, const void* tok,
           void* partials, void* out, int n, int d, int slots, int vocab, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      sync_ce_split_kernel<kTwoPass>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((n + kRows - 1) / kRows, slots);
  sync_ce_split_kernel<kTwoPass><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      tm_x, tm_w, (const float*)bias, (const int*)tok, (float*)partials, (float*)out, n, d,
      slots, vocab);
  return (int)cudaGetLastError();
}

}  // namespace

// x [n, d] bf16; w [d, slots * vocab] bf16; bias [slots * vocab] f32; tok
// [n, slots] int32; partials [ceil(n/64) * slots, 2] f32: block (tile,
// slot)'s (sum, count) at row slot * tiles + tile; out [2] f32 = their sum
// in block order. x and w 16-byte aligned; d and vocab multiples of 8,
// vocab <= 640 (two column passes above 320). One launch.
extern "C" int sync_ce_split_fwd(const void* x, const void* w, const void* bias,
                                 const void* tok, void* partials, void* out, int n, int d,
                                 int slots, int vocab, void* stream) {
  if (n <= 0 || d <= 0 || d % 8 || slots <= 0 || vocab <= 0 || vocab > kMaxVocab ||
      vocab % 8 || ((uintptr_t)x % 16) || ((uintptr_t)w % 16))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tm_x, tm_w;
  if (!make_map(&tm_x, x, n, d, d, kRows, kDepth, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&tm_w, w, d, slots * vocab, slots * vocab, kDepth, 32,
                CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  return vocab > kCols
             ? launch<true>(tm_x, tm_w, bias, tok, partials, out, n, d, slots, vocab, stream)
             : launch<false>(tm_x, tm_w, bias, tok, partials, out, n, d, slots, vocab, stream);
}

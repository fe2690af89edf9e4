// Fused sync-head projection + per-slot softmax cross-entropy, forward only.
//
// Replaces the Pallas TPU kernel syncvsr_tpu/ops/pallas_sync.py::_kernel
// (launched by _pallas_forward). For features x [N, D] (bf16), the head's
// weight W [D, S*V] (bf16, slot s = columns s*V .. s*V+V-1), bias b [S*V]
// (f32) and tokens tok [N, S] (int32, < 0 = ignore), it computes
//     sum over rows n and slots s with tok[n,s] >= 0 of
//         logsumexp_v(x[n] . W[:, s*V+v] + b[s*V+v]) - (label logit)
// and the count of such (n, s) pairs, as one (sum, count) partial per block.
// The [N, S, V] logits never reach device memory.
//
// What bounds it on an H100: at the lrw_video shapes (N=2784, D=513, S=8,
// V=320) the product is 2*N*D*S*V = 7.3 GFLOP against ~5.6 MB of inputs, so
// the bound is the tensor cores (7.4 us at 989 TFLOP/s bf16), not memory.
// This version runs the product on the tensor cores with warp-level
// mma.sync (m16n8k16, bf16 in, f32 accumulate), staged through shared
// memory with plain loads; the time goes to staging the slot's weight
// (each block reads its [D, V] slice from L2). wgmma/TMA are later work.
//
// Design: grid = (ceil(N/32) row tiles) x (S slots), 256 threads (8 warps).
// The block walks D in 32-wide steps, staging the x tile [32, 32] and the
// slot's W tile [32, V] in shared memory as bf16 (zero past N, D and V);
// warp w owns columns 40w .. 40w+39 of the slot's vocabulary (5 n8 tiles)
// for all 32 rows (2 m16 tiles), 40 f32 accumulators a thread. After the
// loop the logits tile [32, V] goes to shared memory (over the staging
// buffers); warp w then takes rows 4w..4w+3, lane l columns l, l+32, ...:
// the row max, sum of exp and label pick are warp shuffles, tokens < 0 and
// rows past N are skipped. Each block writes its (sum, count); the wrapper
// sums the partials in a fixed order, so the result is the same from run to
// run. D is ragged (513 = 16*32 + 1): the tail is zero-filled. V must be a
// multiple of 8 (16-byte staging loads) and at most 320.

#include <math.h>

#include "sync_ce_common.cuh"

namespace {

constexpr int kRows = 32;                  // rows per block
constexpr int kDepth = 32;                 // D step (two k16 mma steps)
constexpr int kThreads = 256;              // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVocab = 320;             // columns a block holds per slot
constexpr int kWarpCols = kMaxVocab / kWarps;   // 40 = 5 n8 tiles
constexpr int kNTiles = kWarpCols / 8;
constexpr int kMTiles = kRows / 16;
constexpr int kXStride = kDepth + 8;       // bf16, padded: conflict-free A loads
constexpr int kWStride = kMaxVocab + 8;    // bf16, padded: conflict-free B loads
constexpr int kLStride = kMaxVocab + 8;    // f32 logits row
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kColsPerLane = kMaxVocab / 32;

struct Staging {
  __nv_bfloat16 x[kRows][kXStride];
  __nv_bfloat16 w[kDepth][kWStride];
};

union Smem {
  Staging st;
  float logits[kRows][kLStride];
};

__global__ void __launch_bounds__(kThreads)
sync_ce_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias, const int* __restrict__ tok,
               float* __restrict__ partials, int n, int d, int slots, int vocab) {
  __shared__ __align__(16) Smem sm;
  __shared__ float red[kWarps][2];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = lane / 4;     // mma fragment row group
  const int tig = lane % 4;     // thread in group
  const int row0 = blockIdx.x * kRows;
  const int s = blockIdx.y;
  const long long ldw = (long long)slots * vocab;
  const __nv_bfloat16* wslot = w + (long long)s * vocab;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const int vchunks = vocab / 8;   // 16-byte chunks of a W row

  float acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kDepth) {
    // x[row0:row0+32, k0:k0+32] (rows of D bf16 are not 16-byte aligned)
    for (int e = tid; e < kRows * kDepth; e += kThreads) {
      const int r = e / kDepth, kk = e % kDepth;
      const int row = row0 + r, k = k0 + kk;
      sm.st.x[r][kk] = (row < n && k < d) ? x[(long long)row * d + k] : zero;
    }
    // W[k0:k0+32, s*V : s*V+V] in 16-byte chunks; zero past D and V
    for (int e = tid; e < kDepth * (kMaxVocab / 8); e += kThreads) {
      const int kk = e / (kMaxVocab / 8), c8 = e % (kMaxVocab / 8);
      const int k = k0 + kk;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < d && c8 < vchunks)
        v = *reinterpret_cast<const uint4*>(wslot + (long long)k * ldw + 8 * c8);
      *reinterpret_cast<uint4*>(&sm.st.w[kk][8 * c8]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kDepth; ks += 16) {
      uint32_t a[kMTiles][4];
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) {
        const int r = 16 * i + grp;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&sm.st.x[r][ks + 2 * tig]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&sm.st.x[r + 8][ks + 2 * tig]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&sm.st.x[r][ks + 2 * tig + 8]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(&sm.st.x[r + 8][ks + 2 * tig + 8]);
      }
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const int col = warp * kWarpCols + 8 * j + grp;
        const int kb = ks + 2 * tig;
        uint32_t b[2];
        b[0] = pack2(sm.st.w[kb][col], sm.st.w[kb + 1][col]);
        b[1] = pack2(sm.st.w[kb + 8][col], sm.st.w[kb + 9][col]);
#pragma unroll
        for (int i = 0; i < kMTiles; ++i) mma_bf16(acc[i][j], a[i], b);
      }
    }
    __syncthreads();
  }

  // accumulators -> logits tile in shared memory (over the staging buffers)
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      const int r = 16 * i + grp;
      const int c = warp * kWarpCols + 8 * j + 2 * tig;
      *reinterpret_cast<float2*>(&sm.logits[r][c]) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(&sm.logits[r + 8][c]) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();

  float ce_acc = 0.f, cnt = 0.f;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const int row = row0 + r;
    const int t = (row < n) ? tok[(long long)row * slots + s] : -1;
    float lg[kColsPerLane];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int col = lane + 32 * j;
      lg[j] = (col < vocab) ? sm.logits[r][col] + bias[s * vocab + col] : -INFINITY;
      m = fmaxf(m, lg[j]);
    }
    m = warp_max(m);
    float se = 0.f, lab = 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int col = lane + 32 * j;
      if (col < vocab) {
        se += expf(lg[j] - m);
        if (col == t) lab = lg[j];
      }
    }
    se = warp_sum(se);
    lab = warp_sum(lab);
    if (t >= 0) {
      ce_acc += (m + logf(se)) - lab;
      cnt += 1.f;
    }
  }
  if (lane == 0) {
    red[warp][0] = ce_acc;
    red[warp][1] = cnt;
  }
  __syncthreads();
  if (tid == 0) {
    float a = 0.f, c = 0.f;
    for (int i = 0; i < kWarps; ++i) {
      a += red[i][0];
      c += red[i][1];
    }
    const long long out = ((long long)blockIdx.x * slots + s) * 2;
    partials[out] = a;
    partials[out + 1] = c;
  }
}

}  // namespace

// partials: [ceil(n/32) * slots, 2] f32, written in full. w must be 16-byte
// aligned with slots * vocab and vocab multiples of 8.
extern "C" int sync_ce_fwd(const void* x, const void* w, const void* bias, const void* tok,
                           void* partials, int n, int d, int slots, int vocab, void* stream) {
  if (n <= 0 || d <= 0 || slots <= 0 || vocab <= 0 || vocab > kMaxVocab || vocab % 8 ||
      ((uintptr_t)w % 16))
    return (int)cudaErrorInvalidValue;
  dim3 grid((n + kRows - 1) / kRows, slots);
  sync_ce_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)bias, (const int*)tok,
      (float*)partials, n, d, slots, vocab);
  return (int)cudaGetLastError();
}

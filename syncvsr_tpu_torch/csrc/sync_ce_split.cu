// Fused sync-head projection + per-slot softmax cross-entropy, forward only,
// for wide features: the x tile is read from device memory once for all
// slots.
//
// Replaces the Pallas TPU kernel syncvsr_tpu/ops/pallas_sync.py::_kernel_split
// (chosen by _pallas_forward when the padded bf16 weight exceeds 4 MiB, e.g.
// D = 768 on lrs3). It computes what sync_ce.cu (K1) computes: for features
// x [N, D] (bf16), weight W [D, S*V] (bf16, slot s = columns s*V .. s*V+V-1),
// bias b [S*V] (f32) and tokens tok [N, S] (int32, < 0 = ignore),
//     sum over rows n and slots s with tok[n,s] >= 0 of
//         logsumexp_v(x[n] . W[:, s*V+v] + b[s*V+v]) - (label logit)
// and the count of such pairs, as one (sum, count) partial per row tile.
//
// What bounds it on an H100: at the lrs3 shapes (N = 1280, D = 768, S = 8,
// V = 320) the product is 2*N*D*S*V = 5.03 GFLOP against ~5.95 MB of
// inputs, so the tensor cores (5.1 us at 989 TFLOP/s bf16), not memory.
// This version multiplies with warp-level mma.sync (m16n8k16, bf16 in, f32
// accumulate); with 32-row tiles there are only ceil(N/32) = 40 blocks, so
// it runs far from that bound. wgmma, TMA and a vocab split across blocks
// are later work.
//
// Design: the TPU kernel's grid was (row tile, slot), the slot axis
// sequential and accumulating into one output block. Here the grid is the
// row tiles alone, 256 threads (8 warps) each; the slot axis is a loop
// inside the block:
//  - the block stages its x tile [32, D] once, in dynamic shared memory
//    (48 KB at D = 768; rows past N and columns past D are zero);
//  - for each slot it streams the slot's [D, V] weight in 32-deep steps
//    through shared memory (the next step's loads are issued into registers
//    before the current step's products), warp w owning columns 40w..40w+39
//    (5 n8 tiles) of all 32 rows (2 m16 tiles), 40 f32 accumulators a thread;
//  - the slot's logits tile [32, V] goes to shared memory (over the weight
//    buffer); warp w reduces rows 4w..4w+3 (row max, sum of exp and label
//    pick by warp shuffles) and adds (logsumexp - label, 1) for each valid
//    token to the (sum, count) it carries in registers across the slots;
//  - one (sum, count) partial per block, folded over the warps in a fixed
//    order; the wrapper sums the partials in a fixed order, so the result is
//    the same from run to run.
// D must be a multiple of 8 (16-byte x rows), V a multiple of 8 and at most
// 320; x and W 16-byte aligned.

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
constexpr int kWStride = kMaxVocab + 8;    // bf16, padded: conflict-free B loads
constexpr int kLStride = kMaxVocab + 8;    // f32 logits row
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kColsPerLane = kMaxVocab / 32;
constexpr int kWChunks = kDepth * (kMaxVocab / 8);            // uint4 per W step
constexpr int kWLoads = (kWChunks + kThreads - 1) / kThreads;  // per thread
constexpr int kWBytes = kDepth * kWStride * 2;
constexpr int kLBytes = kRows * kLStride * 4;
constexpr int kUnionBytes = kWBytes > kLBytes ? kWBytes : kLBytes;
// dynamic shared memory a block may opt into on sm_90, less a margin for
// the static reduction buffer
constexpr int kMaxDynSmem = 232448 - 1024;

// bf16 row stride of the staged x tile: D padded to the step, plus 8
// (16 bytes) so rows fall on different banks
__host__ __device__ __forceinline__ int x_stride(int d) {
  return (d + kDepth - 1) / kDepth * kDepth + 8;
}

size_t smem_bytes(int d) { return (size_t)kRows * x_stride(d) * 2 + kUnionBytes; }

__device__ __forceinline__ void load_w_step(uint4* v, const __nv_bfloat16* wslot,
                                            long long ldw, int k0, int d, int vchunks,
                                            int tid) {
#pragma unroll
  for (int i = 0; i < kWLoads; ++i) {
    const int e = tid + i * kThreads;
    const int kk = e / (kMaxVocab / 8), c8 = e % (kMaxVocab / 8);
    const int k = k0 + kk;
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (e < kWChunks && k < d && c8 < vchunks)
      v[i] = *reinterpret_cast<const uint4*>(wslot + (long long)k * ldw + 8 * c8);
  }
}

__global__ void __launch_bounds__(kThreads)
sync_ce_split_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias, const int* __restrict__ tok,
                     float* __restrict__ partials, int n, int d, int slots, int vocab) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps][2];

  const int xs = x_stride(d);
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem);           // [kRows][xs]
  unsigned char* uni = smem + (size_t)kRows * xs * 2;
  auto sw = reinterpret_cast<__nv_bfloat16 (*)[kWStride]>(uni);          // [kDepth][kWStride]
  auto lg = reinterpret_cast<float (*)[kLStride]>(uni);                  // [kRows][kLStride]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = lane / 4;     // mma fragment row group
  const int tig = lane % 4;     // thread in group
  const int row0 = blockIdx.x * kRows;
  const long long ldw = (long long)slots * vocab;
  const int vchunks = vocab / 8;   // 16-byte chunks of a W row

  // the x tile, once: [32, D] bf16 in 16-byte chunks, zero past N and D
  const int xchunks = (xs - 8) / 8;
  for (int e = tid; e < kRows * xchunks; e += kThreads) {
    const int r = e / xchunks, k = 8 * (e % xchunks);
    const int row = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < n && k < d) v = *reinterpret_cast<const uint4*>(x + (long long)row * d + k);
    *reinterpret_cast<uint4*>(sx + r * xs + k) = v;
  }

  float ce_acc = 0.f, cnt = 0.f;
  for (int s = 0; s < slots; ++s) {
    const __nv_bfloat16* wslot = w + (long long)s * vocab;
    float acc[kMTiles][kNTiles][4];
#pragma unroll
    for (int i = 0; i < kMTiles; ++i)
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    uint4 next[kWLoads];
    load_w_step(next, wslot, ldw, 0, d, vchunks, tid);
    for (int k0 = 0; k0 < d; k0 += kDepth) {
      // the previous step's products (and, at k0 = 0, the previous slot's
      // row reduction) are done with the buffer: store this step's weights
#pragma unroll
      for (int i = 0; i < kWLoads; ++i) {
        const int e = tid + i * kThreads;
        if (e < kWChunks)
          *reinterpret_cast<uint4*>(&sw[e / (kMaxVocab / 8)][8 * (e % (kMaxVocab / 8))]) =
              next[i];
      }
      __syncthreads();
      if (k0 + kDepth < d) load_w_step(next, wslot, ldw, k0 + kDepth, d, vchunks, tid);
#pragma unroll
      for (int ks = 0; ks < kDepth; ks += 16) {
        uint32_t a[kMTiles][4];
#pragma unroll
        for (int i = 0; i < kMTiles; ++i) {
          const __nv_bfloat16* xr = sx + (16 * i + grp) * xs + k0 + ks + 2 * tig;
          a[i][0] = *reinterpret_cast<const uint32_t*>(xr);
          a[i][1] = *reinterpret_cast<const uint32_t*>(xr + 8 * xs);
          a[i][2] = *reinterpret_cast<const uint32_t*>(xr + 8);
          a[i][3] = *reinterpret_cast<const uint32_t*>(xr + 8 * xs + 8);
        }
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
          const int col = warp * kWarpCols + 8 * j + grp;
          const int kb = ks + 2 * tig;
          uint32_t b[2];
          b[0] = pack2(sw[kb][col], sw[kb + 1][col]);
          b[1] = pack2(sw[kb + 8][col], sw[kb + 9][col]);
#pragma unroll
          for (int i = 0; i < kMTiles; ++i) mma_bf16(acc[i][j], a[i], b);
        }
      }
      __syncthreads();
    }

    // accumulators -> logits tile in shared memory (over the weight buffer)
#pragma unroll
    for (int i = 0; i < kMTiles; ++i)
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const int r = 16 * i + grp;
        const int c = warp * kWarpCols + 8 * j + 2 * tig;
        *reinterpret_cast<float2*>(&lg[r][c]) = make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(&lg[r + 8][c]) = make_float2(acc[i][j][2], acc[i][j][3]);
      }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const int row = row0 + r;
      const int t = (row < n) ? tok[(long long)row * slots + s] : -1;
      float l[kColsPerLane];
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int col = lane + 32 * j;
        l[j] = (col < vocab) ? lg[r][col] + bias[s * vocab + col] : -INFINITY;
        m = fmaxf(m, l[j]);
      }
      m = warp_max(m);
      float se = 0.f, lab = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int col = lane + 32 * j;
        if (col < vocab) {
          se += expf(l[j] - m);
          if (col == t) lab = l[j];
        }
      }
      se = warp_sum(se);
      lab = warp_sum(lab);
      if (t >= 0) {
        ce_acc += (m + logf(se)) - lab;
        cnt += 1.f;
      }
    }
    __syncthreads();   // the next slot's weights overwrite the logits
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
    partials[2 * blockIdx.x] = a;
    partials[2 * blockIdx.x + 1] = c;
  }
}

}  // namespace

// partials: [ceil(n/32), 2] f32, written in full. x and w 16-byte aligned;
// d, slots * vocab and vocab multiples of 8, vocab <= 320.
extern "C" int sync_ce_split_fwd(const void* x, const void* w, const void* bias,
                                 const void* tok, void* partials, int n, int d, int slots,
                                 int vocab, void* stream) {
  if (n <= 0 || d <= 0 || d % 8 || slots <= 0 || vocab <= 0 || vocab > kMaxVocab ||
      vocab % 8 || ((uintptr_t)x % 16) || ((uintptr_t)w % 16))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  if (smem > (size_t)kMaxDynSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sync_ce_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sync_ce_split_kernel<<<(n + kRows - 1) / kRows, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)bias, (const int*)tok,
      (float*)partials, n, d, slots, vocab);
  return (int)cudaGetLastError();
}

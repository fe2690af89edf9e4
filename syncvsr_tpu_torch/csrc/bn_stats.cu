// Per-channel BatchNorm statistics over a channels-last [N, C] view.
//
// bn_stats_fwd (K3) replaces the Pallas TPU kernel
//   syncvsr_tpu/ops/pallas_bn.py::_stats_kernel  (via pallas_batch_stats):
//     out[0, c] = sum_n x[n, c],  out[1, c] = sum_n x[n, c]^2   (f32)
// bn_stats_bwd (K4) replaces
//   syncvsr_tpu/ops/pallas_bn.py::_bwd_kernel    (via pallas_bn_bwd_stats):
//     out[0, c] = sum_n g[n, c],  out[1, c] = sum_n g[n, c] * (x[n, c] - mean[c]) * inv[c]
//
// What bounds them on an H100: one pass over the activation (bf16 in the
// train step) with a handful of flops per element, so device memory: the
// forward reads N*C*2 bytes (the stem's [6414336, 64] is 0.82 GB, ~245 us
// at 3.35 TB/s), the backward twice that.
//
// K3's design: the TPU kernel accumulated across a sequential grid in VMEM;
// here blocks run in parallel, so the reduction is two-stage.
//  Stage 1: each of n_strips blocks (256 threads) walks one strip of rows.
//   Thread t owns VEC neighbouring channels (one 16-byte load: 8 bf16 or 4
//   f32) of every rpi-th row, rpi = floor(256 / (C / VEC)), so a warp reads
//   whole rows of contiguous bytes, and keeps 2 * VEC f32 accumulators in
//   registers; where C / VEC does not divide 256 (the Conformer's C = 768)
//   the last 256 - rpi * C / VEC threads idle. The block folds its rpi row
//   groups in shared memory, in a fixed order, and writes a [2, C] partial.
//  Stage 2: 32 outputs per block of 32 x 8 threads; thread (i, j) sums the
//   partials of strips j, j + 8, ... for output i (coalesced rows of the
//   partials), then the 8 sums are folded in a fixed order.
//
// K4's design (one launch; its first version was K3's two, and at the 22
// small BatchNorm shapes of the lrs3 step the second launch and the
// wrapper's allocations cost more than the pass over the data): the block
// is sized to the row, rpi * C / VEC threads with rpi = floor(256 / (C /
// VEC)), so no thread idles (C = 768 bf16: 192 threads). Its strips are
// picked by the wrapper (cuda_bn.bwd_geometry) so that the small shapes
// still run a block on every SM and the large ones read >= 64K elements a
// strip, at most 2 blocks a SM (the registers allow 2). A thread issues the
// 16-byte loads of kUnroll = 8 rows of g and x (16 in flight, streaming,
// ld.cs) before it adds any, which the compiler's unrolling of the plain
// loop did not do. Where a warp holds several row groups (C / VEC < 32)
// they are folded with shuffles, then the rest in shared memory, in a fixed
// order; the block writes its [2, C] partial, fences, and takes a ticket of
// its group of 16 strips. The block that draws a group's last ticket sums
// the group's partials (float4 columns read through L2, ld.global.cg) and
// takes a ticket over the groups; the block that draws that last one sums
// the groups' sums into out. Each counter is reset to 0 by the block that
// drew its last ticket, for the next call. Two levels keep the serial fold
// short: at [1280, 768] one block folding all 143 partials (879 KB) took
// longer than the pass over the data. The fold order never depends on
// arrival order, and there are no float atomics, so both kernels give the
// same bits from run to run. The tickets are one set per device, so K4 runs
// on one stream at a time (the train step's); they need no reset from the
// host, so a CUDA graph may hold the kernel.
//
// K4 measured on H100 80GB HBM3 cards at their 700 W power limit
// (chip_smoke.py): 86-93% of the bound at the stem's [6414336, 64] and
// [2949120, 64], by card (0.52435-0.55497 and 0.24140-0.26087 ms against
// 0.49017 and 0.22537); over the lrs3 step's 32 calls 68% (1.05132 ms of
// device time against 0.71138), the small shapes far below it (12% at
// [1280, 768], 0.01021 ms, where launch and fold latency are the time).
//
// C must be a multiple of VEC with C / VEC <= 256 (every trunk width,
// 64..512, and the Conformer's 768), and the view must be contiguous and
// 16-byte aligned; the wrapper checks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Vec<float> {
  static constexpr int kWidth = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
  }
};

// Fold the block's rpi row groups: sm holds [2][rpi * c]; writes partial[2 * c].
template <int W>
__device__ __forceinline__ void fold_rows(float* sm, int rr, int lane, int rpi, int c,
                                          const float* a, const float* b,
                                          float* __restrict__ partial) {
  const int span = rpi * c;  // <= kThreads * W
  if (rr < rpi) {
#pragma unroll
    for (int v = 0; v < W; ++v) {
      sm[rr * c + W * lane + v] = a[v];
      sm[span + rr * c + W * lane + v] = b[v];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * c; i += kThreads) {
    const int which = i / c, ch = i % c;
    const float* col = sm + which * span + ch;
    float acc = 0.f;
    for (int k = 0; k < rpi; ++k) acc += col[k * c];
    partial[i] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_fwd_partial(const T* __restrict__ x, float* __restrict__ partials, int n, int c,
                  int rows_per_strip) {
  constexpr int W = Vec<T>::kWidth;
  __shared__ float sm[2 * kThreads * W];
  const int tpr = c / W;
  const int rpi = kThreads / tpr;
  const int lane = threadIdx.x % tpr, rr = threadIdx.x / tpr;
  const long long r0 = (long long)blockIdx.x * rows_per_strip;
  // threads past rpi whole row groups idle (their loop is empty)
  const long long r1 = rr < rpi ? min((long long)n, r0 + rows_per_strip) : r0;
  float s[W], q[W], v[W];
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = q[i] = 0.f;
  const T* p = x + W * lane;
#pragma unroll 4
  for (long long r = r0 + rr; r < r1; r += rpi) {
    Vec<T>::load(p + r * c, v);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      s[i] += v[i];
      q[i] = fmaf(v[i], v[i], q[i]);
    }
  }
  fold_rows<W>(sm, rr, lane, rpi, c, s, q, partials + (long long)blockIdx.x * 2 * c);
}

constexpr int kGroup = 16;        // strips a group of K4's first fold holds
constexpr int kMaxGroups = 1024;

// tickets of K4's running call: per group of kGroup strips, then over the
// groups; the block that draws a counter's last ticket resets it to 0
__device__ unsigned int g_bwd_group_tickets[kMaxGroups];
__device__ unsigned int g_bwd_tickets;

// threads of a K4 block: whole row groups of C / VEC threads, at most 256
__host__ __device__ __forceinline__ int bwd_threads(int tpr) {
  const int rpi = kThreads / tpr;
  return (rpi > 1 ? rpi : 1) * tpr;
}

constexpr int kBatch = 8;    // rows a thread of the fold loads at once, per column

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

// (a0, a1) = sums of the float4 columns i0 and i1 (i1 < 0: none) of the
// rows k0, k0 + step, ... < count of src (cols float4s a row), each in that
// order; the 16-byte loads of kBatch rows of both columns go out together,
// through L2 (ld.global.cg: other blocks wrote them)
__device__ __forceinline__ void sum_columns(const float4* src, int cols, int i0, int i1, int k0,
                                            int step, int count, float4& a0, float4& a1) {
  a0 = a1 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 zero = a0;
  for (; k0 < count; k0 += kBatch * step) {
    float4 v0[kBatch], v1[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u * step;
      const float4* row = src + (long long)k * cols;
      v0[u] = k < count ? __ldcg(row + i0) : zero;
      v1[u] = k < count && i1 >= 0 ? __ldcg(row + i1) : zero;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      add4(a0, v0[u]);
      add4(a1, v1[u]);
    }
  }
}

__device__ __forceinline__ void store4(float* dst, const float4& v) {
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// dst[i] = sum over k < count of src[k * width + i] by the whole block, in
// an order fixed by (count, width, blockDim); width is a multiple of 4 and
// src 16-byte aligned, so a thread owns float4 columns. Where the block has
// threads to spare, sub-sums j over k = j, j + split, ..., then the
// sub-sums in order; else two float4 columns a thread at a time. A [1280,
// 768] call's group fold is 2 rounds of 16 loads a thread.
__device__ __forceinline__ void fold_ordered(const float* src, int count, int width,
                                             float* __restrict__ dst, float* sm) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int cols = width / 4;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  float4 a0, a1;
  if (nt >= cols) {
    const int split = nt / cols;   // split * width <= 4 * nt floats of sm
    const int i = tid % cols, j = tid / cols;
    if (j < split) {
      sum_columns(src4, cols, i, -1, j, split, count, a0, a1);
      store4(sm + j * width + 4 * i, a0);
    }
    __syncthreads();
    for (int t = tid; t < width; t += nt) {
      float total = 0.f;
      for (int k = 0; k < split; ++k) total += sm[k * width + t];
      dst[t] = total;
    }
  } else {
    for (int i0 = tid; i0 < cols; i0 += 2 * nt) {
      const int i1 = i0 + nt < cols ? i0 + nt : -1;
      sum_columns(src4, cols, i0, i1, 0, 1, count, a0, a1);
      store4(dst + 4 * i0, a0);
      if (i1 >= 0) store4(dst + 4 * i1, a1);
    }
  }
}

// 16 bytes of T (8 bf16 or 4 f32) to f32
__device__ __forceinline__ void widen(const uint4& raw, __nv_bfloat16, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void widen(const uint4& raw, float, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

constexpr int kUnroll = 8;   // rows of g and x a K4 thread keeps in flight

template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_bwd_fused(const T* __restrict__ g, const T* __restrict__ x,
                const float* __restrict__ mean, const float* __restrict__ inv,
                float* __restrict__ partials, float* __restrict__ out, int n, int c,
                int rows_per_strip) {
  constexpr int W = Vec<T>::kWidth;
  __shared__ float sm[2 * kThreads * W];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int tpr = c / W;
  const int rpi = blockDim.x / tpr;
  const int lane = tid % tpr, rr = tid / tpr;
  const long long r0 = (long long)blockIdx.x * rows_per_strip;
  const long long r1 = min((long long)n, r0 + rows_per_strip);
  float m[W], iv[W], s[W], q[W], gv[W], xv[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    m[i] = mean[W * lane + i];
    iv[i] = inv[W * lane + i];
    s[i] = q[i] = 0.f;
  }
  const T* pg = g + W * lane;
  const T* px = x + W * lane;
  // kUnroll rows of g and x in flight (16 bytes each) before any arithmetic
  for (long long r = r0 + rr; r < r1; r += (long long)kUnroll * rpi) {
    uint4 rg[kUnroll], rx[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long ru = r + (long long)u * rpi;
      rg[u] = rx[u] = make_uint4(0u, 0u, 0u, 0u);
      if (ru < r1) {
        // streaming loads (ld.global.cs): each byte is read once
        rg[u] = __ldcs(reinterpret_cast<const uint4*>(pg + ru * c));
        rx[u] = __ldcs(reinterpret_cast<const uint4*>(px + ru * c));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + (long long)u * rpi >= r1) break;
      widen(rg[u], T(), gv);
      widen(rx[u], T(), xv);
#pragma unroll
      for (int i = 0; i < W; ++i) {
        s[i] += gv[i];
        q[i] = fmaf(gv[i], (xv[i] - m[i]) * iv[i], q[i]);
      }
    }
  }

  // fold the row groups: a warp's first (shuffles), then the block's
  const bool in_warp = tpr < 32 && 32 % tpr == 0;
  if (in_warp) {
    for (int o = tpr; o < 32; o <<= 1)
#pragma unroll
      for (int i = 0; i < W; ++i) {
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
        q[i] += __shfl_xor_sync(0xffffffffu, q[i], o);
      }
  }
  const int held = in_warp ? blockDim.x / 32 : rpi;   // row sums left to fold
  const int slot = in_warp ? tid / 32 : rr;
  const int span = held * c;
  if (!in_warp || tid % 32 < tpr) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      sm[slot * c + W * lane + i] = s[i];
      sm[span + slot * c + W * lane + i] = q[i];
    }
  }
  __syncthreads();
  const int width = 2 * c;
  float* partial = partials + (long long)blockIdx.x * width;
  for (int i = tid; i < width; i += blockDim.x) {
    const float* col = sm + (i / c) * span + i % c;
    float acc = 0.f;
    for (int k = 0; k < held; ++k) acc += col[k * c];
    partial[i] = acc;
  }

  // the partial is out. The last block of each group of kGroup strips
  // folds the group's partials; the last of those folds the groups' sums
  __threadfence();
  __syncthreads();
  const int strips = gridDim.x;
  const int groups = (strips + kGroup - 1) / kGroup;
  const int grp = blockIdx.x / kGroup;
  const int in_group = min(kGroup, strips - grp * kGroup);
  if (tid == 0) last = atomicAdd(&g_bwd_group_tickets[grp], 1u) == (unsigned int)in_group - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* group_sums = partials + (long long)strips * width;
  fold_ordered(partials + (long long)grp * kGroup * width, in_group, width,
               groups == 1 ? out : group_sums + (long long)grp * width, sm);
  if (tid == 0) g_bwd_group_tickets[grp] = 0u;
  if (groups == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&g_bwd_tickets, 1u) == (unsigned int)groups - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  fold_ordered(group_sums, groups, width, out, sm);
  if (tid == 0) g_bwd_tickets = 0u;
}

constexpr int kSumCols = 32;
constexpr int kSumRows = 8;

// out[i] = sum over strips of partials[strip, i]; block (32, 8), 32 outputs each
__global__ void __launch_bounds__(kSumCols * kSumRows)
sum_strips(const float* __restrict__ partials, float* __restrict__ out, int n_strips,
           int width) {
  __shared__ float sm[kSumRows][kSumCols];
  const int i = blockIdx.x * kSumCols + threadIdx.x;
  float acc = 0.f;
  if (i < width) {
#pragma unroll 4
    for (int s = threadIdx.y; s < n_strips; s += kSumRows)
      acc += partials[(long long)s * width + i];
  }
  sm[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && i < width) {
    float total = 0.f;
#pragma unroll
    for (int j = 0; j < kSumRows; ++j) total += sm[j][threadIdx.x];
    out[i] = total;
  }
}

bool valid_shape(int n, int c, int n_strips, int vec) {
  return n >= 0 && c >= vec && c % vec == 0 && c / vec <= kThreads && n_strips >= 1;
}

int launch_sum(const float* partials, float* out, int n_strips, int c, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = 2 * c;
  sum_strips<<<(width + kSumCols - 1) / kSumCols, dim3(kSumCols, kSumRows), 0, st>>>(
      partials, out, n_strips, width);
  return (int)cudaGetLastError();
}

}  // namespace

// x [n, c] bf16 (is_bf16=1) or f32; partials [n_strips, 2c] f32 scratch;
// out [2, c] f32 = (sum x, sum x^2)
extern "C" int bn_stats_fwd(const void* x, void* partials, void* out, int n, int c,
                            int n_strips, int is_bf16, void* stream) {
  const int vec = is_bf16 ? Vec<__nv_bfloat16>::kWidth : Vec<float>::kWidth;
  if (!valid_shape(n, c, n_strips, vec)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = (n + n_strips - 1) / n_strips;
  if (is_bf16)
    stats_fwd_partial<__nv_bfloat16><<<n_strips, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (float*)partials, n, c, rows);
  else
    stats_fwd_partial<float><<<n_strips, kThreads, 0, st>>>(
        (const float*)x, (float*)partials, n, c, rows);
  return launch_sum((const float*)partials, (float*)out, n_strips, c, st);
}

// g, x [n, c] (both bf16 or both f32); mean, inv [c] f32; partials
// [n_strips + ceil(n_strips / 16), 2c] f32 scratch (n_strips <= 16384); out
// [2, c] f32 = (sum g, sum g * (x - mean) * inv).
// One launch of n_strips blocks of bwd_threads(c / VEC) threads, strip i
// holding rows i * ceil(n / n_strips) onwards.
extern "C" int bn_stats_bwd(const void* g, const void* x, const void* mean, const void* inv,
                            void* partials, void* out, int n, int c, int n_strips,
                            int is_bf16, void* stream) {
  const int vec = is_bf16 ? Vec<__nv_bfloat16>::kWidth : Vec<float>::kWidth;
  if (!valid_shape(n, c, n_strips, vec) || n_strips > kGroup * kMaxGroups)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = (n + n_strips - 1) / n_strips;
  const int threads = bwd_threads(c / vec);
  if (is_bf16)
    stats_bwd_fused<__nv_bfloat16><<<n_strips, threads, 0, st>>>(
        (const __nv_bfloat16*)g, (const __nv_bfloat16*)x, (const float*)mean,
        (const float*)inv, (float*)partials, (float*)out, n, c, rows);
  else
    stats_bwd_fused<float><<<n_strips, threads, 0, st>>>(
        (const float*)g, (const float*)x, (const float*)mean, (const float*)inv,
        (float*)partials, (float*)out, n, c, rows);
  return (int)cudaGetLastError();
}

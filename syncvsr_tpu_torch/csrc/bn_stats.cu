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
// The TPU kernels accumulated across a sequential grid in VMEM; here blocks
// run in parallel, and both kernels share one design, one launch a call
// (their first versions made a second launch to sum the blocks' partials;
// at the 22 small BatchNorm shapes of the lrs3 step that launch and the
// wrapper's allocations cost more than the pass over the data):
//  - the block is sized to the row, rpi * C / VEC threads with rpi =
//    floor(256 / (C / VEC)), so no thread idles (C = 768 bf16: 192
//    threads). Thread t owns VEC neighbouring channels (one 16-byte load: 8
//    bf16 or 4 f32) of every rpi-th row of its strip, so a warp reads whole
//    rows of contiguous bytes, and keeps 2 * VEC f32 accumulators;
//  - the strips are picked by the wrapper (cuda_bn.fwd_geometry and
//    bwd_geometry), so that the small shapes still run a block on every SM
//    and the large ones read enough a strip;
//  - a thread issues the 16-byte loads of several rows before it adds any
//    (K3: kFwdUnroll = 16 rows of x; K4: kUnroll = 8 rows of g and x, 16
//    in flight either way), which the compiler's unrolling of the plain
//    loop did not do. K4 streams (ld.cs: each byte is read once); K3's x is
//    read again at once by the BatchNorm's affine, so it loads with the
//    default policy (ld.nc), under which the whole BN forward was faster on
//    an H100 than with ld.cs (PERF.md);
//  - fold_and_finish: where a warp holds several row groups (C / VEC < 32)
//    they are folded with shuffles, then the rest in shared memory, in a
//    fixed order; the block writes its [2, C] partial, fences, and takes a
//    ticket of its group of 16 strips. The block that draws a group's last
//    ticket sums the group's partials (float4 columns read through L2,
//    ld.global.cg) and takes a ticket over the groups; the block that draws
//    that last one sums the groups' sums into out. Each counter is reset to
//    0 by the block that drew its last ticket, for the next call. Two
//    levels keep the serial fold short: at [1280, 768] one block folding
//    all 143 partials (879 KB) took longer than the pass over the data.
//    The fold order never depends on arrival order, and there are no float
//    atomics, so both kernels give the same bits from run to run. Each
//    kernel has its own set of tickets, one set per device, so each runs on
//    one stream at a time (the train step's); they need no reset from the
//    host, so a CUDA graph may hold the kernel.
//
// Measured on H100 80GB HBM3 cards at their 700 W power limit
// (chip_smoke.py, tools/bn_shapes.py): K4 at 86-93% of the bound at the
// stem's [6414336, 64] and [2949120, 64], by card; over the lrs3 step's 32
// calls 68-70% (1.02-1.05 ms of device time against 0.71138). K3 at 91% and
// 85% of the bound at the same two shapes (0.26879 and 0.13238 ms against
// 0.24509 and 0.11268), 55% over the lrs3 step (0.648 ms against 0.35569)
// and 78% over lrw_video's (0.968 against 0.75824). At the small shapes
// launch and fold latency are the time (K3 at [1280, 768]: 0.00986 ms
// against 0.00059), and there the one launch's serial fold takes more
// device time than the first version's second launch, whose gap from the
// first the device time does not count; the call as a whole is 2-2.6x
// faster there.
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
};

template <>
struct Vec<float> {
  static constexpr int kWidth = 4;
};

constexpr int kGroup = 16;        // strips a group of the first fold holds
constexpr int kMaxGroups = 1024;

// tickets of the running call of each kernel: per group of kGroup strips,
// then over the groups; the block that draws a counter's last ticket resets
// it to 0
__device__ unsigned int g_fwd_group_tickets[kMaxGroups];
__device__ unsigned int g_fwd_tickets;
__device__ unsigned int g_bwd_group_tickets[kMaxGroups];
__device__ unsigned int g_bwd_tickets;

// threads of a block: whole row groups of C / VEC threads, at most 256
__host__ __device__ __forceinline__ int row_threads(int tpr) {
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

// The block's sums (s, q) of its strip -> out, as the header says: the row
// groups folded in a fixed order into the block's [2, c] partial, then the
// two-level last-block fold over partials [strips + groups, 2c] with the
// kernel's own tickets. sm holds 2 * kThreads * W floats.
template <int W>
__device__ __forceinline__ void fold_and_finish(float* s, float* q, float* sm, int c,
                                                float* __restrict__ partials,
                                                float* __restrict__ out,
                                                unsigned int* group_tickets,
                                                unsigned int* tickets) {
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int tpr = c / W;
  const int rpi = blockDim.x / tpr;
  const int lane = tid % tpr, rr = tid / tpr;
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
  if (tid == 0) last = atomicAdd(&group_tickets[grp], 1u) == (unsigned int)in_group - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* group_sums = partials + (long long)strips * width;
  fold_ordered(partials + (long long)grp * kGroup * width, in_group, width,
               groups == 1 ? out : group_sums + (long long)grp * width, sm);
  if (tid == 0) group_tickets[grp] = 0u;
  if (groups == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets, 1u) == (unsigned int)groups - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  fold_ordered(group_sums, groups, width, out, sm);
  if (tid == 0) *tickets = 0u;
}

constexpr int kFwdUnroll = 16;   // rows of x a K3 thread keeps in flight

template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_fwd_fused(const T* __restrict__ x, float* __restrict__ partials, float* __restrict__ out,
                int n, int c, int rows_per_strip) {
  constexpr int W = Vec<T>::kWidth;
  __shared__ float sm[2 * kThreads * W];
  const int tid = threadIdx.x;
  const int tpr = c / W;
  const int rpi = blockDim.x / tpr;
  const int lane = tid % tpr, rr = tid / tpr;
  const long long r0 = (long long)blockIdx.x * rows_per_strip;
  const long long r1 = min((long long)n, r0 + rows_per_strip);
  float s[W], q[W], v[W];
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = q[i] = 0.f;
  const T* px = x + W * lane;
  // kFwdUnroll rows of x in flight (16 bytes each) before any arithmetic
  for (long long r = r0 + rr; r < r1; r += (long long)kFwdUnroll * rpi) {
    uint4 raw[kFwdUnroll];
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) {
      const long long ru = r + (long long)u * rpi;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (ru < r1) {
        // the default policy (ld.global.nc): the affine reads x again
        raw[u] = __ldg(reinterpret_cast<const uint4*>(px + ru * c));
      }
    }
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) {
      if (r + (long long)u * rpi >= r1) break;
      widen(raw[u], T(), v);
#pragma unroll
      for (int i = 0; i < W; ++i) {
        s[i] += v[i];
        q[i] = fmaf(v[i], v[i], q[i]);
      }
    }
  }
  fold_and_finish<W>(s, q, sm, c, partials, out, g_fwd_group_tickets, &g_fwd_tickets);
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
  fold_and_finish<W>(s, q, sm, c, partials, out, g_bwd_group_tickets, &g_bwd_tickets);
}

bool valid_shape(int n, int c, int n_strips, int vec) {
  return n >= 0 && c >= vec && c % vec == 0 && c / vec <= kThreads && n_strips >= 1 &&
         n_strips <= kGroup * kMaxGroups;
}

}  // namespace

// Both entry points: n_strips blocks of row_threads(c / VEC) threads, strip
// i holding rows i * ceil(n / n_strips) onwards, one launch; partials
// [n_strips + ceil(n_strips / 16), 2c] f32 scratch (n_strips <= 16384); out
// [2, c] f32.

// x [n, c] bf16 (is_bf16=1) or f32; out = (sum x, sum x^2)
extern "C" int bn_stats_fwd(const void* x, void* partials, void* out, int n, int c,
                            int n_strips, int is_bf16, void* stream) {
  const int vec = is_bf16 ? Vec<__nv_bfloat16>::kWidth : Vec<float>::kWidth;
  if (!valid_shape(n, c, n_strips, vec)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = (n + n_strips - 1) / n_strips;
  const int threads = row_threads(c / vec);
  if (is_bf16)
    stats_fwd_fused<__nv_bfloat16><<<n_strips, threads, 0, st>>>(
        (const __nv_bfloat16*)x, (float*)partials, (float*)out, n, c, rows);
  else
    stats_fwd_fused<float><<<n_strips, threads, 0, st>>>((const float*)x, (float*)partials,
                                                         (float*)out, n, c, rows);
  return (int)cudaGetLastError();
}

// g, x [n, c] (both bf16 or both f32); mean, inv [c] f32; out = (sum g,
// sum g * (x - mean) * inv)
extern "C" int bn_stats_bwd(const void* g, const void* x, const void* mean, const void* inv,
                            void* partials, void* out, int n, int c, int n_strips,
                            int is_bf16, void* stream) {
  const int vec = is_bf16 ? Vec<__nv_bfloat16>::kWidth : Vec<float>::kWidth;
  if (!valid_shape(n, c, n_strips, vec)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = (n + n_strips - 1) / n_strips;
  const int threads = row_threads(c / vec);
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

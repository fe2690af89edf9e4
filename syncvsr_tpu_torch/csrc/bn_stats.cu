// Per-channel BatchNorm statistics over a channels-last [N, C] view.
//
// bn_stats_fwd replaces the Pallas TPU kernel
//   syncvsr_tpu/ops/pallas_bn.py::_stats_kernel  (via pallas_batch_stats):
//     out[0, c] = sum_n x[n, c],  out[1, c] = sum_n x[n, c]^2   (f32)
// bn_stats_bwd replaces
//   syncvsr_tpu/ops/pallas_bn.py::_bwd_kernel    (via pallas_bn_bwd_stats):
//     out[0, c] = sum_n g[n, c],  out[1, c] = sum_n g[n, c] * (x[n, c] - mean[c]) * inv[c]
//
// What bounds them on an H100: one pass over the activation (bf16 in the
// train step) with a handful of flops per element, so device memory: the
// forward reads N*C*2 bytes (the stem's [6414336, 64] is 0.82 GB, ~245 us
// at 3.35 TB/s), the backward twice that.
//
// Design: the TPU kernel accumulated across a sequential grid in VMEM; here
// blocks run in parallel, so the reduction is two-stage.
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
// No float atomics: the result is the same from run to run. The wrapper
// picks n_strips to fill the 132 SMs at every trunk shape. C must be a
// multiple of VEC with C / VEC <= 256 (every trunk width, 64..512, and the
// Conformer's 768), and the view must be contiguous and 16-byte aligned;
// the wrapper checks.

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_bwd_partial(const T* __restrict__ g, const T* __restrict__ x,
                  const float* __restrict__ mean, const float* __restrict__ inv,
                  float* __restrict__ partials, int n, int c, int rows_per_strip) {
  constexpr int W = Vec<T>::kWidth;
  __shared__ float sm[2 * kThreads * W];
  const int tpr = c / W;
  const int rpi = kThreads / tpr;
  const int lane = threadIdx.x % tpr, rr = threadIdx.x / tpr;
  const long long r0 = (long long)blockIdx.x * rows_per_strip;
  const long long r1 = rr < rpi ? min((long long)n, r0 + rows_per_strip) : r0;
  float m[W], iv[W], s[W], q[W], gv[W], xv[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    m[i] = rr < rpi ? mean[W * lane + i] : 0.f;
    iv[i] = rr < rpi ? inv[W * lane + i] : 0.f;
    s[i] = q[i] = 0.f;
  }
  const T* pg = g + W * lane;
  const T* px = x + W * lane;
#pragma unroll 4
  for (long long r = r0 + rr; r < r1; r += rpi) {
    Vec<T>::load(pg + r * c, gv);
    Vec<T>::load(px + r * c, xv);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      s[i] += gv[i];
      q[i] = fmaf(gv[i], (xv[i] - m[i]) * iv[i], q[i]);
    }
  }
  fold_rows<W>(sm, rr, lane, rpi, c, s, q, partials + (long long)blockIdx.x * 2 * c);
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

// g, x [n, c] (both bf16 or both f32); mean, inv [c] f32;
// out [2, c] f32 = (sum g, sum g * (x - mean) * inv)
extern "C" int bn_stats_bwd(const void* g, const void* x, const void* mean, const void* inv,
                            void* partials, void* out, int n, int c, int n_strips,
                            int is_bf16, void* stream) {
  const int vec = is_bf16 ? Vec<__nv_bfloat16>::kWidth : Vec<float>::kWidth;
  if (!valid_shape(n, c, n_strips, vec)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = (n + n_strips - 1) / n_strips;
  if (is_bf16)
    stats_bwd_partial<__nv_bfloat16><<<n_strips, kThreads, 0, st>>>(
        (const __nv_bfloat16*)g, (const __nv_bfloat16*)x, (const float*)mean,
        (const float*)inv, (float*)partials, n, c, rows);
  else
    stats_bwd_partial<float><<<n_strips, kThreads, 0, st>>>(
        (const float*)g, (const float*)x, (const float*)mean, (const float*)inv,
        (float*)partials, n, c, rows);
  return launch_sum((const float*)partials, (float*)out, n_strips, c, st);
}

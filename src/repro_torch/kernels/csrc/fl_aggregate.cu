// Masked pseudo-gradient aggregation, paper eq. (3), for Hopper (sm_90a).
//
//   out[m] = g[m] + inv_k * sum_r w[r] * d[r, m]        (fp32 accumulate)
//
// Replaces the Pallas TPU kernel src/repro/kernels/fl_aggregate.py
// (fl_aggregate, body _kernel): the same fused mask-scale-reduce-add, read
// once and written once.  All three modes of kernels/ops.py launch it: plain
// (w = 0/1 mask, inv_k = 1/R), participant subset (w = valid/K, inv_k = 1)
// and guarded/weighted (folded weights, inv_k = 1, GUARD on).
//
// What bounds it: bytes.  It does 2 flops per delta element it reads, so it
// is a streaming reduction bound by device-memory bandwidth: (R+2)*M
// elements moved.  At the main path's shape (R = K = 10, M = 159,012: the
// MLP's 159,010 fp32 parameters in a 16-byte-aligned row) that is ~7.6 MB,
// ~2.3 us at the H100 SXM's 3.35 TB/s, so a launch costs about as much as
// the work; at R = 100 it is ~64 MB, ~19 us.
//
// Design: each block owns a contiguous chunk of M and each thread keeps its
// fp32 accumulators in registers while it loops over the R rows, so every
// delta element is read exactly once and no partial sums leave the SM.  The
// row weights are staged in shared memory, WCHUNK at a time.  Threads read
// 16 bytes each (float4, or 8 bf16) where every row is 16-byte aligned,
// else one element at a time, neighbouring threads on neighbouring
// addresses.  inv_k is a runtime argument, so a new K needs no rebuild;
// GUARD and the element type are template parameters.
//
// Traps:
//  * Rows whose weight is 0 are NOT skipped: with GUARD off, 0 * NaN must
//    stay NaN (a poisoned row reaches the output, tests/test_kernels.py).
//    With GUARD on, non-finite delta elements are zeroed before the multiply.
//  * Build without --use_fast_math: it breaks isfinite() and NaN propagation.
//  * The ragged tail: M need not be a multiple of the vector width (77, 8193,
//    199,210), and a view into a flat buffer need not be 16-byte
//    aligned.  The host picks the vector path only when every pointer is
//    16-byte aligned and M is a multiple of the vector width; otherwise the
//    scalar path runs, which bounds-checks every element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WCHUNK = 1024;      // row weights staged per pass
constexpr int SCALAR_ITEMS = 4;   // elements per thread on the scalar path

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);  // round to nearest even
}

template <bool GUARD>
__device__ __forceinline__ float sanitize(float v) {
  return (GUARD && !isfinite(v)) ? 0.0f : v;
}

// Elements of T in one 16-byte vector.
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[Vec<T>::N]) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) v[i] = to_f32(e[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[Vec<T>::N]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) e[i] = from_f32<T>(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Stage weights [r0, r0 + n) into shared memory (all threads take part).
__device__ __forceinline__ void stage(float* sw, const float* w, int r0,
                                     int n) {
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) sw[i] = w[r0 + i];
  __syncthreads();
}

// Vector path: thread owns one 16-byte vector; requires M % N == 0 and
// 16-byte-aligned g, d, out.
template <typename T, bool GUARD>
__global__ void __launch_bounds__(THREADS)
fl_aggregate_vec(const T* __restrict__ g, const T* __restrict__ d,
                 const float* __restrict__ w, T* __restrict__ out, int R,
                 long long M, float inv_k) {
  constexpr int N = Vec<T>::N;
  __shared__ float sw[WCHUNK];
  const long long m = (static_cast<long long>(blockIdx.x) * THREADS +
                       threadIdx.x) * N;
  const bool live = m < M;
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
  for (int r0 = 0; r0 < R; r0 += WCHUNK) {
    const int n = min(WCHUNK, R - r0);
    stage(sw, w, r0, n);
    if (live) {
      const T* row = d + static_cast<long long>(r0) * M + m;
#pragma unroll 4
      for (int r = 0; r < n; ++r, row += M) {
        float v[N];
        load_vec(row, v);
        const float wr = sw[r];
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] += wr * sanitize<GUARD>(v[i]);
      }
    }
  }
  if (live) {
    float gv[N];
    load_vec(g + m, gv);
#pragma unroll
    for (int i = 0; i < N; ++i) gv[i] += inv_k * acc[i];
    store_vec(out + m, gv);
  }
}

// Scalar path: thread owns SCALAR_ITEMS elements THREADS apart (coalesced),
// each bounds-checked — any alignment, any M.
template <typename T, bool GUARD>
__global__ void __launch_bounds__(THREADS)
fl_aggregate_scalar(const T* __restrict__ g, const T* __restrict__ d,
                    const float* __restrict__ w, T* __restrict__ out, int R,
                    long long M, float inv_k) {
  __shared__ float sw[WCHUNK];
  const long long base = static_cast<long long>(blockIdx.x) * THREADS *
                             SCALAR_ITEMS + threadIdx.x;
  float acc[SCALAR_ITEMS];
#pragma unroll
  for (int i = 0; i < SCALAR_ITEMS; ++i) acc[i] = 0.0f;
  for (int r0 = 0; r0 < R; r0 += WCHUNK) {
    const int n = min(WCHUNK, R - r0);
    stage(sw, w, r0, n);
    for (int r = 0; r < n; ++r) {
      const T* row = d + static_cast<long long>(r0 + r) * M;
      const float wr = sw[r];
#pragma unroll
      for (int i = 0; i < SCALAR_ITEMS; ++i) {
        const long long m = base + static_cast<long long>(i) * THREADS;
        if (m < M) acc[i] += wr * sanitize<GUARD>(to_f32(row[m]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < SCALAR_ITEMS; ++i) {
    const long long m = base + static_cast<long long>(i) * THREADS;
    if (m < M) out[m] = from_f32<T>(to_f32(g[m]) + inv_k * acc[i]);
  }
}

template <typename T, bool GUARD>
cudaError_t launch(const void* g, const void* d, const void* w, void* out,
                   int R, long long M, float inv_k, int vec,
                   cudaStream_t stream) {
  const T* gp = static_cast<const T*>(g);
  const T* dp = static_cast<const T*>(d);
  const float* wp = static_cast<const float*>(w);
  T* op = static_cast<T*>(out);
  if (vec) {
    const long long per_block = static_cast<long long>(THREADS) * Vec<T>::N;
    const unsigned blocks = static_cast<unsigned>((M + per_block - 1) /
                                                  per_block);
    fl_aggregate_vec<T, GUARD><<<blocks, THREADS, 0, stream>>>(
        gp, dp, wp, op, R, M, inv_k);
  } else {
    const long long per_block = static_cast<long long>(THREADS) *
                                SCALAR_ITEMS;
    const unsigned blocks = static_cast<unsigned>((M + per_block - 1) /
                                                  per_block);
    fl_aggregate_scalar<T, GUARD><<<blocks, THREADS, 0, stream>>>(
        gp, dp, wp, op, R, M, inv_k);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fl_aggregate_launch(const void* g, const void* d,
                                   const void* w, void* out, int R,
                                   long long M, float inv_k, int dtype,
                                   int guard, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || R < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    return static_cast<int>(
        guard ? launch<float, true>(g, d, w, out, R, M, inv_k, vec, s)
              : launch<float, false>(g, d, w, out, R, M, inv_k, vec, s));
  }
  if (dtype == 1) {
    return static_cast<int>(
        guard ? launch<__nv_bfloat16, true>(g, d, w, out, R, M, inv_k, vec, s)
              : launch<__nv_bfloat16, false>(g, d, w, out, R, M, inv_k, vec,
                                             s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Mamba S6 selective scan, forward, for Hopper (sm_90a).
//
//   h_t = exp(dt_t * A) (.) h_{t-1} + (dt_t * x_t) * B_t     h_0 = 0
//   y_t = h_t . C_t + D (.) x_t
//
// per (batch b, channel c), with the state h[N] in fp32 carried across the
// whole sequence.  Inputs: x, dt [B, S, d] (fp32 or bf16, each on its own),
// Bm, Cm [B, S, N] fp32 with N 8 or 16, A [d, N] fp32, D [d] fp32.  Outputs: y [B, S, d]
// fp32 and the final state h_last [B, d, N] fp32 (the prefill's cache).
//
// Replaces the Pallas TPU kernel src/repro/kernels/selective_scan.py:66
// (selective_scan, body _kernel :31).  The TPU kernel walks the sequence
// as the last, sequential grid axis and carries the state in VMEM scratch
// between grid steps; here blocks run in parallel and in no order, so each
// thread walks the whole sequence in a loop and keeps its state in
// registers.  It takes any S and any d (ragged edges masked; the Pallas
// kernel asserts d % bd == 0 and S % sc == 0), reads x, dt, Bm and Cm
// through (batch, seq) strides (Bm and Cm are column slices of the x_proj
// output), and also writes the final state, which the TPU kernel leaves in
// its scratch.
//
// What bounds it: operations, on the special-function unit.  Each (b, t,
// c, n) needs one exponential; the SFU gives 16 a clock per SM.  At the
// main shape (B 4, S 1024, d 16,384, N 16, bf16 x) that is 1.07 G
// exponentials, 0.257 ms at 132 SMs x 1.98 GHz, against 677 MB moved
// (0.202 ms at 3.35 TB/s) and ~6.4 GFLOP of fp32 FMAs (0.096 ms).
//
// Design (simple and right first):
//  * One thread owns one (b, c) pair and keeps its N states and N values of
//    A * log2(e) in registers; exp(dt * A) is exp2f(dt * A2).  A block of
//    128 threads covers 128 neighbouring channels of one batch row, so
//    every load of x and dt and every store of y is coalesced along d.
//  * The sequence is walked in chunks of TC = 32 timesteps, software
//    pipelined: while a chunk is computed from shared memory, the next
//    one's x and dt (this thread's column) and Bm, Cm rows (the block's,
//    split across threads) are already loading into registers; at the top
//    of the next chunk they are written to shared memory (x, dt as fp32
//    columns; Bm, Cm read back as broadcasts).  A full chunk's loads take
//    no branch, so they issue back to back.  (A first version that loaded
//    each element under its own guard, with no prefetch, serialised the
//    loads: 2.55 ms at B 1 x S 4096 on an H100 SXM, 10 % of the bound.)
//  * Occupancy: at N 16 ptxas gives 182-204 registers a thread (the next
//    chunk's 2 x 32 values live across the compute loop), no spills,
//    and 36 KB of static shared memory, so 2 blocks (8 warps) fit an SM.
//    At B 4 the grid's 512 blocks take two waves; at B 1 it is d / 128 =
//    128 blocks, one per SM, 4 warps.  The exponentials of one step are
//    independent of the state, so a warp has N-fold ILP for the SFU, but
//    one warp per scheduler leaves its latencies uncovered.  Splitting N
//    across lanes or a chunked two-pass scan would put more warps on each
//    SM.
//
// Traps:
//  * Threads of channels past d still take part in the staging and the
//    barriers; they load and store nothing of their own.
//  * Build without --use_fast_math: exp2f stays within 2 ulp and NaN
//    propagates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // channels per block
constexpr int TC = 32;         // timesteps per staged chunk
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {               // in elements; the last dim has stride 1
  long long b, s;
};

struct Problem {
  int S, d;
  Strides x, dt, bm, cm;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Loads chunk [t0, t0 + len) into registers: this thread's x and dt, and
// its PER values of the block's Bm and Cm rows (flat index tid + k *
// THREADS over [len, N]).  A full chunk takes no branch per element, so all
// of its loads are issued back to back; only the last chunk is guarded.
template <int N, typename TX, typename TD>
__device__ __forceinline__ void fetch(const TX* xb, const TD* db,
                                      const float* bb, const float* cb,
                                      const Problem& p, int t0, int len,
                                      bool live, float (&xr)[TC],
                                      float (&dr)[TC],
                                      float (&br)[TC * N / THREADS],
                                      float (&cr)[TC * N / THREADS]) {
  constexpr int PER = TC * N / THREADS;
  if (len == TC) {
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      xr[i] = live ? to_f32(xb[(t0 + i) * p.x.s]) : 0.0f;
      dr[i] = live ? to_f32(db[(t0 + i) * p.dt.s]) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = threadIdx.x + k * THREADS, tt = i / N, n = i % N;
      br[k] = bb[(t0 + tt) * p.bm.s + n];
      cr[k] = cb[(t0 + tt) * p.cm.s + n];
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < TC; ++i) {
    const bool ok = live && i < len;
    xr[i] = ok ? to_f32(xb[(t0 + i) * p.x.s]) : 0.0f;
    dr[i] = ok ? to_f32(db[(t0 + i) * p.dt.s]) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * THREADS, tt = i / N, n = i % N;
    br[k] = tt < len ? bb[(t0 + tt) * p.bm.s + n] : 0.0f;
    cr[k] = tt < len ? cb[(t0 + tt) * p.cm.s + n] : 0.0f;
  }
}

template <int N, typename TX, typename TD>
__global__ void __launch_bounds__(THREADS)
selective_scan_fwd(const TX* __restrict__ x, const TD* __restrict__ dt,
                   const float* __restrict__ bm,
                   const float* __restrict__ cm,
                   const float* __restrict__ A, const float* __restrict__ D,
                   float* __restrict__ y, float* __restrict__ h_last,
                   Problem p) {
  static_assert(TC * N % THREADS == 0, "a chunk's B, C split evenly");
  constexpr int PER = TC * N / THREADS;
  __shared__ float Xs[TC][THREADS];
  __shared__ float Ds[TC][THREADS];
  __shared__ float Bs[TC * N];
  __shared__ float Cs[TC * N];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int c = blockIdx.x * THREADS + tid;
  const bool live = c < p.d;

  float a2[N], h[N];
  float dv = 0.0f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = live ? A[static_cast<long long>(c) * N + n] * LOG2E : 0.0f;
    h[n] = 0.0f;
  }
  if (live) dv = D[c];

  const TX* xb = x + b * p.x.b + c;
  const TD* db = dt + b * p.dt.b + c;
  const float* bb = bm + b * p.bm.b;
  const float* cb = cm + b * p.cm.b;
  float* yb = y + (static_cast<long long>(b) * p.S) * p.d + c;

  float xr[TC], dr[TC], br[PER], cr[PER];
  fetch<N>(xb, db, bb, cb, p, 0, min(TC, p.S), live, xr, dr, br, cr);
  for (int t0 = 0; t0 < p.S; t0 += TC) {
    const int len = min(TC, p.S - t0);
    __syncthreads();           // the previous chunk's reads of smem done
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      Xs[i][tid] = xr[i];
      Ds[i][tid] = dr[i];
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      Bs[tid + k * THREADS] = br[k];
      Cs[tid + k * THREADS] = cr[k];
    }
    __syncthreads();
    // the next chunk's loads are in flight while this one is computed
    if (t0 + TC < p.S)
      fetch<N>(xb, db, bb, cb, p, t0 + TC, min(TC, p.S - t0 - TC), live, xr,
               dr, br, cr);
    if (live) {
#pragma unroll 2
      for (int i = 0; i < len; ++i) {
        const float dti = Ds[i][tid], xi = Xs[i][tid];
        const float dtx = dti * xi;
        float acc = 0.0f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float dA = exp2f(dti * a2[n]);
          h[n] = fmaf(dA, h[n], dtx * Bs[i * N + n]);
          acc = fmaf(h[n], Cs[i * N + n], acc);
        }
        yb[static_cast<long long>(t0 + i) * p.d] = fmaf(dv, xi, acc);
      }
    }
  }

  if (live) {
    float* hb = h_last + (static_cast<long long>(b) * p.d + c) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) hb[n] = h[n];
  }
}

template <int N, typename TX, typename TD>
cudaError_t launch_typed(const void* x, const void* dt, const float* bm,
                         const float* cm, const float* A, const float* D,
                         float* y, float* h_last, int B, const Problem& p,
                         cudaStream_t stream) {
  const dim3 grid((p.d + THREADS - 1) / THREADS, B);
  selective_scan_fwd<N, TX, TD><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TD*>(dt), bm, cm, A, D, y,
      h_last, p);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch(const void* x, const void* dt, const float* bm,
                   const float* cm, const float* A, const float* D, float* y,
                   float* h_last, int B, const Problem& p, int x_dtype,
                   int dt_dtype, cudaStream_t s) {
  if (x_dtype == 0 && dt_dtype == 0)
    return launch_typed<N, float, float>(x, dt, bm, cm, A, D, y, h_last, B,
                                         p, s);
  if (x_dtype == 1 && dt_dtype == 0)
    return launch_typed<N, __nv_bfloat16, float>(x, dt, bm, cm, A, D, y,
                                                 h_last, B, p, s);
  if (x_dtype == 0 && dt_dtype == 1)
    return launch_typed<N, float, __nv_bfloat16>(x, dt, bm, cm, A, D, y,
                                                 h_last, B, p, s);
  if (x_dtype == 1 && dt_dtype == 1)
    return launch_typed<N, __nv_bfloat16, __nv_bfloat16>(x, dt, bm, cm, A, D,
                                                         y, h_last, B, p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes.  x_dtype, dt_dtype: 0 = float32,
// 1 = bfloat16.  strides: 8 element strides, (batch, seq) of x, dt, Bm, Cm
// in turn.  A [d, N], D [d], y [B, S, d] and h_last [B, d, N] are
// contiguous.  N is 8 or 16.  Returns cudaGetLastError() after the launch.
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* bm, const void* cm,
                                     const void* A, const void* D, void* y,
                                     void* h_last, int B, int S, int d, int N,
                                     const long long* strides, int x_dtype,
                                     int dt_dtype, void* stream) {
  if (B <= 0 || S <= 0 || d <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Problem p;
  p.S = S;
  p.d = d;
  Strides* all[4] = {&p.x, &p.dt, &p.bm, &p.cm};
  for (int i = 0; i < 4; ++i) {
    all[i]->b = strides[2 * i];
    all[i]->s = strides[2 * i + 1];
  }
  const float* fb = static_cast<const float*>(bm);
  const float* fc = static_cast<const float*>(cm);
  const float* fA = static_cast<const float*>(A);
  const float* fD = static_cast<const float*>(D);
  float* fy = static_cast<float*>(y);
  float* fh = static_cast<float*>(h_last);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 8:
      return static_cast<int>(launch<8>(x, dt, fb, fc, fA, fD, fy, fh, B, p,
                                        x_dtype, dt_dtype, s));
    case 16:
      return static_cast<int>(launch<16>(x, dt, fb, fc, fA, fD, fy, fh, B, p,
                                         x_dtype, dt_dtype, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

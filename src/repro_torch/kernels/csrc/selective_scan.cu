// Mamba S6 selective scan, forward, for Hopper (sm_90a).
//
//   h_t = exp(dt_t * A) (.) h_{t-1} + (dt_t * x_t) * B_t     h_0 = 0
//   y_t = h_t . C_t + D (.) x_t
//
// per (batch b, channel c), with the state h[N] in fp32 carried across the
// whole sequence.  Inputs: x, dt [B, S, d] (fp32 or bf16, each on its own),
// Bm, Cm [B, S, N] fp32 with N 8 or 16, A [d, N] fp32, D [d] fp32.  Outputs:
// y [B, S, d] fp32 and the final state h_last [B, d, N] fp32 (the prefill's
// cache).
//
// Replaces the Pallas TPU kernel src/repro/kernels/selective_scan.py:66
// (selective_scan, body _kernel :31).  The TPU kernel walks the sequence
// as the last, sequential grid axis and carries the state in VMEM scratch
// between grid steps; here blocks run in parallel and in no order, so each
// channel's lanes walk the whole sequence in a loop and keep its state in
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
// (0.202 ms at 3.35 TB/s) and ~6.6 GFLOP of fp32 FMAs (0.099 ms).  Close
// behind come the issue slots (an exponential is an FMUL, the SFU op, an
// FMUL, two FFMAs) and the shared-memory reads: every (t, n) of a channel
// reads B[t, n] and C[t, n], 8 bytes an exponential if each thread served
// one channel, against the 128 bytes a clock an SM reads (16 exponentials'
// worth).
//
// Design (many warps an SM, few registers; no prefetched value is held
// in a register):
//  * N is split across LANES = 4 neighbouring lanes of a warp, and each
//    lane serves PAIR = 2 neighbouring channels: it holds N / 4 states of
//    each and their A * log2(e), so a step is 2 N / 4 exponentials a lane
//    for one float4 (N 16) or float2 (N 8) read each of B and C, 4 bytes
//    an exponential.  A block of 128 threads covers 64 channels of one
//    batch row; 80-102 registers and 23-44 KB of static shared memory let
//    4 blocks (16 warps) share an SM.  B 4 x d 16,384 is 1024 blocks, one
//    wave; B 1 is 256 blocks, 2 an SM.
//  * y's sum over n is reduced across the 4 lanes once every 4 steps: each
//    lane holds its partial sums of 4 steps, and two exchange rounds (3
//    shuffles, not 8) leave lane q with the whole sum of step q, which it
//    stores.  D x enters through lane 0's partial.
//  * x, dt, Bm and Cm reach shared memory through a ring of 2 stages of 32
//    steps, the next chunk's cp.async copies in flight while this one is
//    computed.  x and dt rows
//    are copied as the 16-byte chunks that cover the block's 64 channels,
//    from the row's start rounded down to 16 bytes, so any stride and any
//    d take 16-byte copies; where channel 0 of each row landed is staged
//    beside it.  A 16-byte chunk that holds a wanted byte never crosses a
//    page, so the slack bytes read beside a row are mapped memory.  Bm and
//    Cm (fp32, any stride) go by 4-byte copies into aligned rows.
//  * A ragged last chunk runs as a full one: rows past S are zeros (dt = x
//    = B = 0, so exp(0) = 1 and the state is unchanged); their y is not
//    stored.
//  * The exponential is ex2.approx.ftz: exp2f's own SFU op without the
//    three instructions that keep results below 2^-126 subnormal.  Such a
//    factor exp(dt * A) flushes to 0, a change below 1.2e-38 in a state of
//    order 1.
//
// Traps:
//  * Lanes of channels past d still issue copies and reach every barrier;
//    they store nothing.
//  * The per-lane partial sums change the order of y's sum over n (held to
//    the plain version's float32 tolerance, as before).
//  * Build without --use_fast_math: NaN propagates through the state.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CPB = 64;                 // channels per block
constexpr int PAIR = 2;                 // channels per thread
constexpr int LANES = 4;                // lanes per channel (N split)
constexpr int THREADS = CPB / PAIR * LANES;   // 128
constexpr int TC = 32;                  // timesteps per staged chunk
constexpr int STAGES = 2;               // chunks in the shared-memory ring
constexpr int MIN_BLOCKS = 4;           // an SM's blocks: <= 128 registers
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

// One staged row of x or dt: the 16-byte chunks covering CPB channels from
// a start rounded down to 16 bytes.
template <typename T> struct Row {
  static constexpr int CHUNKS = CPB * static_cast<int>(sizeof(T)) / 16 + 1;
  static constexpr int BYTES = 16 * CHUNKS;
};

template <int N, typename TX, typename TD> struct __align__(16) Stage {
  uint8_t x[TC][Row<TX>::BYTES];
  uint8_t dt[TC][Row<TD>::BYTES];
  float bm[TC][N];
  float cm[TC][N];
  int2 off[TC];            // where channel 0 of a row sits: .x in x, .y in dt
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// 4 bytes; zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ring() {  // oldest chunk done
  asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2) : "memory");
}

// Rows [0, len) of a chunk of x or dt: row r starts at row0 + r * ss and
// holds `valid` channels; off[r] gets the element where channel 0 landed.
// Chunks holding none of them are skipped.  Rows past len are zeros.
template <typename T>
__device__ __forceinline__ void stage_rows(uint8_t (*dst)[Row<T>::BYTES],
                                           int* off, const T* row0,
                                           long long ss, int len, int valid) {
  constexpr int CH = Row<T>::CHUNKS;
  for (int i = threadIdx.x; i < TC * CH; i += THREADS) {
    const int r = i / CH, j = i % CH;
    if (r >= len) {
      *reinterpret_cast<uint4*>(&dst[r][16 * j]) = make_uint4(0, 0, 0, 0);
      if (j == 0) off[2 * r] = 0;
      continue;
    }
    const uintptr_t start = reinterpret_cast<uintptr_t>(row0 + r * ss);
    const uintptr_t src = (start & ~static_cast<uintptr_t>(15)) + 16 * j;
    if (j == 0) off[2 * r] = static_cast<int>((start & 15) / sizeof(T));
    if (src < start + valid * sizeof(T))
      cp_async16(&dst[r][16 * j], reinterpret_cast<const void*>(src));
  }
}

template <typename T>
__device__ __forceinline__ float staged(const uint8_t* row, int off, int ch) {
  return to_f32(reinterpret_cast<const T*>(row)[off + ch]);
}

// 2^x on the SFU.  exp2f adds three instructions that rescale results
// below 2^-126 to keep them subnormal; here they flush to 0, a change
// below 1.2e-38 in exp(dt * A), which multiplies a state of order 1.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int NL>
__device__ __forceinline__ void load_states(const float* p, float (&v)[NL]) {
  if constexpr (NL == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  }
}

template <int N, typename TX, typename TD>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
selective_scan_fwd(const TX* __restrict__ x, const TD* __restrict__ dt,
                   const float* __restrict__ bm,
                   const float* __restrict__ cm,
                   const float* __restrict__ A, const float* __restrict__ D,
                   float* __restrict__ y, float* __restrict__ h_last,
                   Problem p) {
  constexpr int NL = N / LANES;           // states per lane and channel
  static_assert(NL == 2 || NL == 4, "N is 8 or 16");
  __shared__ Stage<N, TX, TD> ring[STAGES];

  const int tid = threadIdx.x;
  const int q = tid % LANES;              // this lane's share of n
  const int ch = PAIR * (tid / LANES);    // its first channel in the block
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CPB;
  const int valid = min(CPB, p.d - c0);   // channels of this block

  float a2[PAIR][NL], h[PAIR][NL], dv[PAIR];
#pragma unroll
  for (int j = 0; j < PAIR; ++j) {
    const int c = c0 + ch + j;
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      a2[j][k] = c < p.d
          ? A[static_cast<long long>(c) * N + q * NL + k] * LOG2E : 0.0f;
      h[j][k] = 0.0f;
    }
    dv[j] = c < p.d && q == 0 ? D[c] : 0.0f;   // D x enters via lane 0
  }

  const TX* xb = x + b * p.x.b + c0;
  const TD* db = dt + b * p.dt.b + c0;
  const float* bb = bm + b * p.bm.b;
  const float* cb = cm + b * p.cm.b;
  float* yb = y + static_cast<long long>(b) * p.S * p.d + c0 + ch;

  const int nchunks = (p.S + TC - 1) / TC;
  auto issue = [&](int k) {
    if (k < nchunks) {
      Stage<N, TX, TD>& st = ring[k % STAGES];
      const int t0 = k * TC, len = min(TC, p.S - t0);
      stage_rows<TX>(st.x, &st.off[0].x, xb + t0 * p.x.s, p.x.s, len,
                     valid);
      stage_rows<TD>(st.dt, &st.off[0].y, db + t0 * p.dt.s, p.dt.s, len,
                     valid);
      for (int i = tid; i < TC * N; i += THREADS) {
        const int r = i / N, n = i % N;
        const bool ok = r < len;
        const long long t = ok ? t0 + r : 0;
        cp_async4(&st.bm[r][n], bb + t * p.bm.s + n, ok);
        cp_async4(&st.cm[r][n], cb + t * p.cm.s + n, ok);
      }
    }
    cp_async_commit();   // one group a chunk, empty past the end
  };

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) issue(k);
  for (int k = 0; k < nchunks; ++k) {
    cp_async_wait_ring();
    __syncthreads();     // chunk k visible; chunk k - 1's reads all done
    issue(k + STAGES - 1);
    const Stage<N, TX, TD>& st = ring[k % STAGES];
    const int t0 = k * TC, len = min(TC, p.S - t0);
#pragma unroll 1
    for (int i = 0; i < TC; i += LANES) {
      float part[PAIR][LANES];
#pragma unroll
      for (int u = 0; u < LANES; ++u) {
        const int r = i + u;
        const int2 off = st.off[r];
        float bv[NL], cv[NL];
        load_states<NL>(&st.bm[r][q * NL], bv);
        load_states<NL>(&st.cm[r][q * NL], cv);
#pragma unroll
        for (int j = 0; j < PAIR; ++j) {
          const float dti = staged<TD>(st.dt[r], off.y, ch + j);
          const float xi = staged<TX>(st.x[r], off.x, ch + j);
          const float dtx = dti * xi;
          float acc = dv[j] * xi;
#pragma unroll
          for (int k = 0; k < NL; ++k) {
            const float dA = ex2(dti * a2[j][k]);
            h[j][k] = fmaf(dA, h[j][k], dtx * bv[k]);
            acc = fmaf(h[j][k], cv[k], acc);
          }
          part[j][u] = acc;
        }
      }
#pragma unroll
      for (int j = 0; j < PAIR; ++j) {
        // lanes q ^ 2 swap halves: lane q keeps steps 2(q >> 1) + {0, 1}
        const bool hi = q & 2;
        const float s0 = __shfl_xor_sync(0xffffffffu,
                                         hi ? part[j][0] : part[j][2], 2);
        const float s1 = __shfl_xor_sync(0xffffffffu,
                                         hi ? part[j][1] : part[j][3], 2);
        const float k0 = (hi ? part[j][2] : part[j][0]) + s0;
        const float k1 = (hi ? part[j][3] : part[j][1]) + s1;
        // lanes q ^ 1 swap: lane q keeps step q
        const bool odd = q & 1;
        const float s2 = __shfl_xor_sync(0xffffffffu, odd ? k0 : k1, 1);
        if (ch + j < valid && i + q < len)
          yb[static_cast<long long>(t0 + i + q) * p.d + j] =
              (odd ? k1 : k0) + s2;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < PAIR; ++j) {
    if (ch + j < valid) {
      float* hb = h_last +
                  (static_cast<long long>(b) * p.d + c0 + ch + j) * N + q * NL;
#pragma unroll
      for (int k = 0; k < NL; ++k) hb[k] = h[j][k];
    }
  }
}

template <int N, typename TX, typename TD>
cudaError_t launch_typed(const void* x, const void* dt, const float* bm,
                         const float* cm, const float* A, const float* D,
                         float* y, float* h_last, int B, const Problem& p,
                         cudaStream_t stream) {
  const dim3 grid((p.d + CPB - 1) / CPB, B);
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

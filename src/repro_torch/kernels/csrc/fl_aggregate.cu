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
// the work; at R = 100 it is ~64 MB, ~19 us; at the dense baseline's
// R = 1000, ~636 MB, ~0.19 ms.
//
// Design: a persistent grid of at most one block an SM.  The host's launch
// plan (kernels/fl_aggregate.py: launch_plan) cuts M into tiles from M and
// the SM count, so every SM gets the same number of columns, and block b
// walks tiles b, b + grid, ...  Eight consumer warps keep a tile's fp32
// accumulators in registers (up to 8 columns a thread, column
// k * 256 + thread) and add the rows in order.  Where they come from:
//  * g's slice, and every row when R <= DIRECT_MAX (the main path's
//    R = 10): the consumers load them straight from global memory, every
//    load of the tile issued before the first add.  The ring is unused and
//    the block asks for almost no shared memory, so L1 keeps its room for
//    those loads in flight.
//  * Otherwise every row comes through a ring of stages in shared memory:
//    one producer thread requests each stage's `rows` row slices with 1-D
//    TMA bulk copies (cp.async.bulk) that complete on the stage's mbarrier
//    by byte count; the consumers add a stage once it lands and hand it
//    back through a second mbarrier.  The first pass through the ring goes
//    out before the block's only barrier.  Two stages of ~48 KB keep the
//    card's memory busy: more stages in flight measured slower.
// A consumer reads each stage's weights (uniform loads through the
// read-only path) before it waits for the stage.  inv_k is a runtime
// argument, so a new K needs no rebuild; GUARD and the element type are
// template parameters.
//
// Any alignment and any M: a bulk copy needs 16-byte-aligned addresses and
// sizes, so each row slice is copied as the 16-byte-aligned span that holds
// it and the consumers read it at its offset in that span.  The span never
// leaves the 16-byte chunks that hold the slice's own elements, so it
// touches no page the tensor does not.  The last tile may be narrower.
//
// Deterministic: each column is summed by one thread, rows in order, with
// no atomics, so two launches give the same bits whatever the plan.
//
// Traps:
//  * Rows whose weight is 0 are NOT skipped: with GUARD off, 0 * NaN must
//    stay NaN (a poisoned row reaches the output, tests/test_kernels.py).
//    With GUARD on, non-finite delta elements are zeroed before the multiply.
//  * Build without --use_fast_math: it breaks isfinite() and NaN propagation.
//  * Above 48 KB of dynamic shared memory needs an attribute: it is set once
//    a device, on the first launch, never per call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Mirrored by kernels/fl_aggregate.py (launch_plan); the entry point checks
// every plan against them.
constexpr int CONSUMER_WARPS = 8;
constexpr int CONSUMERS = 32 * CONSUMER_WARPS;    // threads holding columns
constexpr int THREADS = CONSUMERS + 32;           // + the producer warp
constexpr int MAX_COLS = 8;                       // columns a consumer holds
constexpr int MAX_TILE = CONSUMERS * MAX_COLS;    // elements of M a tile
constexpr int DIRECT_MAX = 11;                    // rows loaded directly
constexpr int ROWS_MAX = 16;                      // rows a ring stage
constexpr int MAX_STAGES = 64;
constexpr int RING_OFFSET = 16 * MAX_STAGES;      // full + empty barriers
constexpr int MAX_SMEM = 232448;                  // 227 KB, sm_90's opt-in
constexpr int MAX_DEVICES = 64;

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Until the phase of parity `parity` has completed.  A phase that never
// completes (a lost transaction) traps after ~10 s of clocks, so the launch
// fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 20000000000LL) __trap();
  }
}

// `bytes` (a multiple of 16) from 16-byte-aligned global `src` into
// shared `dst`; they complete a transaction on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, uintptr_t src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Bytes of the 16-byte-aligned span holding `len` bytes at `a`.
__device__ __forceinline__ uint32_t span_bytes(uintptr_t a, uint32_t len) {
  return static_cast<uint32_t>(((a + len + 15) & ~uintptr_t(15)) -
                               (a & ~uintptr_t(15)));
}

// One element through the read-only path, as fp32.
__device__ __forceinline__ float load_global(const float* p) {
  return __ldg(p);
}
__device__ __forceinline__ float load_global(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

// The producer's place in the block's stream of stages.
struct Producer {
  long long tile;     // tile of the next stage
  int r;              // its first row (direct <= r < R)
  int slot;           // ring stage it fills
  uint32_t phase;     // parity of the ring's current pass
};

// Fill the next stage: wait until the consumers have handed it back (the
// first pass through the ring waits on nothing), then request its rows.
template <typename T>
__device__ __forceinline__ void produce(Producer& p, const T* d, int R,
                                        long long M, int direct, int tile,
                                        int rows, int stages, int slot_bytes,
                                        uint64_t* full, uint64_t* empty,
                                        unsigned char* ring) {
  const long long m0 = p.tile * tile;
  const uint32_t len = static_cast<uint32_t>(
      (M - m0 < tile ? M - m0 : tile) * sizeof(T));
  const int n = min(rows, R - p.r);
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(
      d + static_cast<long long>(p.r) * M + m0);
  const uintptr_t row_bytes = static_cast<uintptr_t>(M) * sizeof(T);
  uint32_t bytes = 0;
  for (int i = 0; i < n; ++i) bytes += span_bytes(a0 + i * row_bytes, len);
  mbar_wait(&empty[p.slot], p.phase ^ 1);
  mbar_expect_tx(&full[p.slot], bytes);
  unsigned char* stage = ring + static_cast<size_t>(p.slot) * rows *
                                    slot_bytes;
  for (int i = 0; i < n; ++i) {
    const uintptr_t a = a0 + i * row_bytes;
    bulk_load(stage + i * slot_bytes, a & ~uintptr_t(15), span_bytes(a, len),
              &full[p.slot]);
  }
  p.r += n;
  if (p.r == R) {
    p.r = direct;
    p.tile += gridDim.x;
  }
  if (++p.slot == stages) {
    p.slot = 0;
    p.phase ^= 1;
  }
}

template <typename T, bool GUARD>
__global__ void __launch_bounds__(THREADS, 1)
fl_aggregate_tma(const T* __restrict__ g, const T* __restrict__ d,
                 const float* __restrict__ w, T* __restrict__ out, int R,
                 long long M, float inv_k, int tile, long long tiles,
                 int direct, int rows, int stages, int slot_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  unsigned char* ring = smem + RING_OFFSET;

  // the ring carries rows [direct, R) of each tile, if any
  Producer p{direct < R ? blockIdx.x : tiles, direct, 0, 0};
  if (threadIdx.x == CONSUMERS) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // the first pass through the ring needs no hand-back: request it now
    for (int s = 0; s < stages && p.tile < tiles; ++s)
      produce(p, d, R, M, direct, tile, rows, stages, slot_bytes, full,
              empty, ring);
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {                 // the producer warp
    if (threadIdx.x == CONSUMERS) {
      while (p.tile < tiles)
        produce(p, d, R, M, direct, tile, rows, stages, slot_bytes, full,
                empty, ring);
    }
    return;
  }

  const int stage_bytes = rows * slot_bytes;
  const uintptr_t row_bytes = static_cast<uintptr_t>(M) * sizeof(T);
  int slot = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long m0 = t * tile;
    const int tw = static_cast<int>(M - m0 < tile ? M - m0 : tile);
    // column k * CONSUMERS + threadIdx.x of the tile is this thread's
    bool live[MAX_COLS];
#pragma unroll
    for (int k = 0; k < MAX_COLS; ++k)
      live[k] = k * CONSUMERS + static_cast<int>(threadIdx.x) < tw;
    const T* gt = g + m0 + threadIdx.x;
    const T* dt = d + m0 + threadIdx.x;

    // g and rows [0, direct) straight from global memory, every load
    // issued before the first add
    float gv[MAX_COLS], acc[MAX_COLS], v[DIRECT_MAX][MAX_COLS];
    float wd[DIRECT_MAX];
#pragma unroll
    for (int k = 0; k < MAX_COLS; ++k) {
      gv[k] = live[k] ? load_global(gt + k * CONSUMERS) : 0.0f;
      acc[k] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < DIRECT_MAX; ++i) {
      if (i < direct) {
        wd[i] = __ldg(w + i);
#pragma unroll
        for (int k = 0; k < MAX_COLS; ++k)
          v[i][k] = live[k] ? load_global(dt + static_cast<long long>(i) * M +
                                          k * CONSUMERS)
                            : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < DIRECT_MAX; ++i) {
      if (i < direct) {
#pragma unroll
        for (int k = 0; k < MAX_COLS; ++k)
          acc[k] = fmaf(wd[i], sanitize<GUARD>(v[i][k]), acc[k]);
      }
    }

    // the rest through the ring, `rows` rows a stage
    for (int r0 = direct; r0 < R; r0 += rows) {
      const int n = min(rows, R - r0);
      float wr[ROWS_MAX];
#pragma unroll
      for (int i = 0; i < ROWS_MAX; ++i)
        wr[i] = i < n ? __ldg(w + r0 + i) : 0.0f;
      const uintptr_t a0 = reinterpret_cast<uintptr_t>(
          d + static_cast<long long>(r0) * M + m0);
      mbar_wait(&full[slot], phase);
      const unsigned char* stage = ring + static_cast<size_t>(slot) *
                                              stage_bytes;
#pragma unroll
      for (int i = 0; i < ROWS_MAX; ++i) {
        if (i < n) {
          const T* s = reinterpret_cast<const T*>(
                           stage + i * slot_bytes +
                           ((a0 + i * row_bytes) & 15)) + threadIdx.x;
#pragma unroll
          for (int k = 0; k < MAX_COLS; ++k)
            if (live[k])
              acc[k] = fmaf(wr[i], sanitize<GUARD>(to_f32(s[k * CONSUMERS])),
                            acc[k]);
        }
      }
      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive(&empty[slot]);
      if (++slot == stages) {
        slot = 0;
        phase ^= 1;
      }
    }
#pragma unroll
    for (int k = 0; k < MAX_COLS; ++k)
      if (live[k])
        out[m0 + k * CONSUMERS + threadIdx.x] =
            from_f32<T>(fmaf(inv_k, acc[k], gv[k]));
  }
}

template <typename T, bool GUARD>
cudaError_t launch(const void* g, const void* d, const void* w, void* out,
                   int R, long long M, float inv_k, int tile,
                   long long tiles, int grid, int direct, int rows,
                   int stages, int slot_bytes, cudaStream_t stream) {
  constexpr int vec = 16 / sizeof(T);
  if (tile < vec || tile % vec != 0 || tile > MAX_TILE ||
      tiles != (M + tile - 1) / tile || grid < 1 || grid > tiles ||
      direct < 0 || direct > DIRECT_MAX || direct > R || rows < 1 ||
      rows > ROWS_MAX || stages < 1 || stages > MAX_STAGES ||
      slot_bytes % 16 != 0 ||
      slot_bytes < tile * static_cast<int>(sizeof(T)) + 16 ||
      static_cast<long long>(stages) * rows * slot_bytes >
          MAX_SMEM - RING_OFFSET)
    return cudaErrorInvalidValue;
  // once a device: allow the ring above the 48 KB default
  static bool ready[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    err = cudaFuncSetAttribute(fl_aggregate_tma<T, GUARD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  const int smem = RING_OFFSET + stages * rows * slot_bytes;
  fl_aggregate_tma<T, GUARD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(d),
      static_cast<const float*>(w), static_cast<T*>(out), R, M, inv_k, tile,
      tiles, direct, rows, stages, slot_bytes);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// tile, tiles, grid, direct, rows, stages, slot_bytes: the launch plan
// (kernels/fl_aggregate.py: launch_plan).  Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for arguments or a
// plan the kernel does not take.
extern "C" int fl_aggregate_launch(const void* g, const void* d,
                                   const void* w, void* out, int R,
                                   long long M, float inv_k, int dtype,
                                   int guard, int tile, long long tiles,
                                   int grid, int direct, int rows, int stages,
                                   int slot_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || R < 0) return static_cast<int>(cudaErrorInvalidValue);
#define FL_LAUNCH(T, G)                                                   \
  launch<T, G>(g, d, w, out, R, M, inv_k, tile, tiles, grid, direct, rows, \
               stages, slot_bytes, s)
  if (dtype == 0)
    return static_cast<int>(guard ? FL_LAUNCH(float, true)
                                  : FL_LAUNCH(float, false));
  if (dtype == 1)
    return static_cast<int>(guard ? FL_LAUNCH(__nv_bfloat16, true)
                                  : FL_LAUNCH(__nv_bfloat16, false));
#undef FL_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

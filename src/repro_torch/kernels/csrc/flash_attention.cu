// Causal / sliding-window GQA flash attention, forward, for Hopper (sm_90a).
//
//   o[b, s, h, :] = softmax_t(q[b, s, h, :] . k[b, t, h / G, :] / sqrt(hd)
//                             over the kept keys t) @ v[b, t, h / G, :]
//
// with G = H / KV, a key t kept where t <= s (causal) and t > s - window
// (window > 0).  The softmax streams over key tiles with a running max, sum
// and accumulator in fp32; the output is written in the input type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:79
// (flash_attention, body _kernel :34): the same function, but where the TPU
// grid walks every (query block, key block) pair in order and lets masked
// blocks wash out of the softmax, each block here loops over only the key
// tiles its query rows can see: from the window's lower edge to the causal
// diagonal.  It reads q, k, v and writes o in their [B, S, heads, hd]
// layout through strides (no transposed copy), masks a ragged last tile
// itself (any S), and maps query head h to KV head h / G, so KV is never
// duplicated.
//
// What bounds it: operations.  Causal attention does 4*B*H*hd*S*(S+1)/2
// flops on q, k, v and o, which it reads and writes once; at the main
// path's shape (B 4, S 1024, H 32, KV 8, hd 64, bf16) that is 17.2 GFLOP
// against 41.9 MB: 17.4 us at the H100 SXM's 989 TFLOP/s bf16 tensor rate,
// 12.5 us at 3.35 TB/s.  Next to the tensor cores, the exponentials: a 128
// x 128 tile of scores is 16,384 of them at the SFU's 16 a clock per SM,
// 1,024 clocks, as long as the tile's two products take at hd 64 (at hd
// 128 the products take twice that).
//
// Design, bf16:
//  * A block is 3 warpgroups: warpgroup 0 is the producer (one thread
//    issues every TMA load; the group gives its registers away with
//    setmaxnreg, 24 a thread), warpgroups 1 and 2 are consumers (240
//    registers a thread), each owning 64 query rows of a 128-row tile.
//  * Persistent: one block an SM walks work items (a 128-row query tile of
//    one head and batch) in longest-first order, the last query tiles
//    (most keys under a causal mask) first, dealt to the blocks forwards
//    and backwards in turn so that every block's sum of key tiles is close
//    to the mean.  The producer runs ahead through the K/V ring across
//    items, so a block's next item finds its first tiles loaded.
//  * Loads: Q once an item (reloaded as soon as both consumers have issued
//    their last Q K^T), K and V through a ring of 128-key tiles (4 stages
//    at hd 64, 3 at hd 128; 145 and 225 KB of dynamic shared memory), each
//    stage with a full and an empty mbarrier.  The tensor maps span the
//    strided 4-D tensors as (hd, heads, S, B) with boxes of 64 columns (128
//    bytes, the widest a 128-byte swizzle takes) x 1 x rows x 1, so hd 128
//    is two boxes a tile.  TMA zero-fills rows past S, so the ragged last
//    tile needs no guarded load.
//  * S = Q K^T: wgmma.m64n128k16 with Q and K from shared memory, both
//    K-major as loaded; a k-step of 16 moves the descriptor 32 bytes
//    inside the swizzled row, and to the second box past dim 64.
//  * O += P V: P is rounded to bf16 in registers, which are an m64k16 A
//    operand as they lie (two 8-column accumulator tiles each); V is the
//    B operand from shared memory in its transposed (MN-major) form,
//    wgmma.m64n64k16 at hd 64 and m64n128k16 at hd 128 (the second box
//    reached through the descriptor's leading byte offset).
//  * Overlap: a consumer issues tile j's Q K^T and tile j-1's P V together,
//    runs tile j's softmax as soon as S is in (while P V finishes), then
//    rescales O and packs P.  The two consumers take turns issuing their
//    products (named barriers), so one's softmax runs while the other's
//    products hold the tensor cores.
//  * The softmax stays in registers in log2 units: p = 2^(s * scale *
//    log2 e - max) as one FFMA and ex2.approx.ftz (results below 2^-126
//    flush to 0; P is rounded to bf16 anyway); a row's max and sum run in
//    4 independent chains, then reduce over the 4 lanes that hold the row
//    with two shuffles; only tiles on the diagonal, the window's edge or
//    the ragged end evaluate the mask.
//  * Tried and dropped (PERF.md): a non-persistent grid, 1 block an SM (an
//    item's cold pipeline start is bare); an item's first Q K^T beside the
//    previous item's last P V, as one stream of tiles or item by item (no
//    gain, or slower); two Q buffers at hd 64 (no gain); 5 stages at hd 64
//    (no gain); 2 stages (slower).
//  * What holds it back (PERF.md): not the loads (dropping V's loads
//    changes nothing) but the consumers' chain of products, exponentials
//    and rescaling; dropping the exponentials speeds it up most.
//
// Design, fp32: plain fp32 FMAs (no TF32, so the result stays
// within 2e-5 of the plain version).  256 threads per 64-row tile, 4
// threads a row, each owning hd / 4 dims of q and of the accumulator; a
// score is the sum of the 4 partial dot products (two shuffles).  K and V
// tiles of 32 keys in shared memory, read as float4 broadcasts; keys past S
// are zero-filled (0 * garbage could be NaN) and masked; query rows past S
// are computed and not stored.  hd is a template parameter: 64 or 128.
//
// Traps:
//  * A row can see no key of a tile (window) or of any tile so far: its
//    running max is then -inf, and exp(-inf - -inf) would be NaN.  The
//    max used for the exponent is 0 in that case, so p = 0 and corr = 0.
//  * TMA needs 16-byte aligned rows and strides (the wrapper checks).  The
//    tensor-map encoder is a driver call, reached through
//    cudaGetDriverEntryPoint, so the library needs no -lcuda.
//  * Every wgmma operand tile starts on a 1,024-byte boundary (the 128-byte
//    swizzle's period); the dynamic shared memory is aligned by hand.
//  * A wgmma issued under a branch is serialised by ptxas (C7520): every
//    product in the loop is issued unconditionally.
//  * Build without --use_fast_math: exp and division stay IEEE-accurate
//    in the fp32 path.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block, fp32 path
constexpr int BK32 = 32;      // keys per tile, fp32 path

struct Strides {              // in elements; the last dim has stride 1
  long long b, s, h;
};

struct Problem {
  int S, H, KV;
  float scale;
  int causal, window;         // window <= 0: none
  Strides q, k, v, o;
};

__device__ __forceinline__ bool kept(const Problem& p, int qpos, int kpos) {
  if (kpos >= p.S) return false;
  if (p.causal && kpos > qpos) return false;
  if (p.window > 0 && kpos <= qpos - p.window) return false;
  return true;
}

// Key tiles [lo, hi) a query tile starting at q0 can see, lo tile-aligned.
__device__ __forceinline__ void key_range(const Problem& p, int q0, int rows,
                                          int tile, int& lo, int& hi) {
  int first = 0;
  if (p.window > 0) first = max(0, q0 - p.window + 1);
  lo = (first / tile) * tile;
  hi = p.causal ? min(p.S, q0 + rows) : p.S;
}

// -------------------------------------------------------------------------
// bf16: TMA, mbarriers, wgmma, warp specialisation
// -------------------------------------------------------------------------

template <int HD> struct Bf16Tile {
  static constexpr int ROWS = 128;            // query rows per block
  static constexpr int BK = 128;              // keys per tile
  static constexpr int STAGES = HD == 64 ? 4 : 3;
  static constexpr int BOXES = HD / 64;       // 128-byte boxes per row
  static constexpr int Q_BYTES = ROWS * HD * 2;
  static constexpr int TILE_BYTES = BK * HD * 2;        // one K or V tile
  static constexpr int BAR_OFFSET = Q_BYTES + 2 * STAGES * TILE_BYTES;
  // + 1 KB to align the base by hand, + the barriers
  static constexpr int SMEM = 1024 + BAR_OFFSET + 8 * (2 * STAGES + 2);
};
constexpr int CONSUMERS = 2;                  // warpgroups of 64 query rows
constexpr int THREADS_BF16 = 128 * (1 + CONSUMERS);

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

// One box of a 4-D tensor map at (c0, c1, c2, c3) into shared memory; its
// bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(&map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Until at most `pending` of this warpgroup's committed groups are running.
template <int pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(pending)
               : "memory");
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers (the layout of
// an m64nNk16 accumulator's two 8-column tiles), B MN-major (transposed) in
// shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// Keeps the compiler from moving reads or writes of r across a wgmma.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared
// memory; D is overwritten when !accumulate.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers (the layout of
// an m64nNk16 accumulator's two 8-column tiles), B MN-major (transposed) in
// shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the SFU, results below 2^-126 flushed to 0 (exp2f would add three
// instructions to keep them subnormal; P is rounded to bf16 anyway).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One block's unit of work: a 128-row query tile of one (head, batch).
struct Work {
  int q0, h, b, lo, ntiles;
};

// Work item idx of the longest-first order: the last query tiles (most keys
// under a causal mask) of every (head, batch) first.
__device__ __forceinline__ Work work_item(const Problem& p, int B, int idx) {
  constexpr int ROWS = Bf16Tile<64>::ROWS, BK = Bf16Tile<64>::BK;
  const int nq = (p.S + ROWS - 1) / ROWS;
  const int hb = p.H * B;
  Work w;
  w.q0 = (nq - 1 - idx / hb) * ROWS;
  w.h = (idx % hb) % p.H;
  w.b = (idx % hb) / p.H;
  int hi;
  key_range(p, w.q0, ROWS, BK, w.lo, hi);
  w.ntiles = (hi - w.lo + BK - 1) / BK;
  return w;
}

// The work item of a persistent block's round r: rounds of gridDim.x items
// in the longest-first order, dealt forwards in even rounds and backwards
// in odd ones, so every block's total is close to the mean.
__device__ __forceinline__ int item_of_round(int r) {
  const int g = gridDim.x;
  return r * g + ((r & 1) ? g - 1 - blockIdx.x : blockIdx.x);
}

// The two consumers take turns issuing their products (named barriers 1
// and 2, both consumers' 256 threads): consumer c waits at 1 + c until the
// other has issued, and passes at 2 - c once it has issued its own.  One
// consumer's softmax then runs while the other's products hold the tensor
// cores.
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + c) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - c) : "memory");
}

// A persistent block walks its work items (item_of_round); its producer
// runs ahead through the K/V ring across items, and loads the next item's Q
// as soon as both consumers have issued their last Q K^T.
template <int HD>
__global__ void __launch_bounds__(THREADS_BF16, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv,
               __nv_bfloat16* __restrict__ o, int B, int items, Problem p) {
  using T = Bf16Tile<HD>;
  constexpr int BK = T::BK, STAGES = T::STAGES, BOXES = T::BOXES;
  constexpr int QBOX = 64 * 128;          // one 64-row box of Q, bytes
  constexpr int KBOX = BK * 128;          // one BK-row box of K or V, bytes
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = smem;                                 // [consumer][box]
  uint8_t* sK = smem + T::Q_BYTES;                    // [stage][box]
  uint8_t* sV = sK + STAGES * T::TILE_BYTES;          // [stage][box]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFFSET);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;
  uint64_t* qempty = qfull + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * CONSUMERS);
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, 128 * CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    int n = 0;                                  // K/V tiles loaded so far
    for (int local = 0;; ++local) {             // local: work items so far
      const int idx = item_of_round(local);
      if (idx >= items) break;
      const Work w = work_item(p, B, idx);
      const int kvh = w.h / (p.H / p.KV);
      for (int it = 0; it < w.ntiles; ++it, ++n) {
        const int s = n % STAGES;
        mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * T::TILE_BYTES);
        const int k0 = w.lo + it * BK;
        for (int x = 0; x < BOXES; ++x) {
          tma_load(sK + s * T::TILE_BYTES + x * KBOX, mk, &full[s], 64 * x,
                   kvh, k0, w.b);
          tma_load(sV + s * T::TILE_BYTES + x * KBOX, mv, &full[s], 64 * x,
                   kvh, k0, w.b);
        }
        if (it == 0) {                          // Q once the last is used
          mbar_wait(qempty, (local & 1) ^ 1);
          mbar_expect_tx(qfull, T::Q_BYTES);
          for (int c = 0; c < CONSUMERS; ++c)
            for (int x = 0; x < BOXES; ++x)
              tma_load(sQ + (c * BOXES + x) * QBOX, mq, qfull, 64 * x, w.h,
                       w.q0 + 64 * c, w.b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;                       // this consumer's 64 rows
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32, lane = tw % 32;
    const int g = lane / 4, t = lane % 4;       // fragment row / column
    const float qk_scale = p.scale * LOG2E;     // scores in log2 units
    const uint32_t q_addr = smem_addr(sQ + c * BOXES * QBOX);
    float s[64];                                // S tile: 64 x 128
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.0f;

    int n = 0;                                  // K/V tiles used so far
    if (c == 1) turn_pass(c);                   // consumer 0 goes first
    for (int local = 0;; ++local) {
      const int idx = item_of_round(local);
      if (idx >= items) break;
      const Work w = work_item(p, B, idx);
      const int qc0 = w.q0 + 64 * c;
      const int r0 = qc0 + 16 * warp + g, r1 = r0 + 8;
      float acc[HD / 2] = {};                   // O: 64 x hd
      float m[2] = {-INFINITY, -INFINITY};     // running max (log2 units)
      float l[2] = {0.0f, 0.0f};               // this thread's share of sum
      uint32_t pa[BK / 16][4];                  // P in bf16, A fragments

      // S = Q K^T of the stage at k_addr: k-step kk reads dims 16kk..16kk+15
      // (box kk / 4, 32 bytes a step inside the 128-byte row).
      auto issue_qk = [&](uint32_t k_addr) {
  #pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss_n128(s,
                        sw128_desc(q_addr + (kk / 4) * QBOX + off, 16, 1024),
                        sw128_desc(k_addr + (kk / 4) * KBOX + off, 16, 1024),
                        kk > 0);
        }
        wgmma_commit();
      };
      // O += P V of the stage at v_addr: k-step kk (keys 16kk..16kk+15) takes
      // the A fragment pa[kk]; V's rows of those keys are 2 KB apart, and at
      // hd 128 its dims 64.. are the next box, KBOX on (the leading offset).
      auto issue_pv = [&](uint32_t v_addr) {
  #pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t dv = sw128_desc(v_addr + kk * 16 * 128, KBOX, 1024);
          if constexpr (HD == 64) wgmma_rs_n64(acc, pa[kk], dv);
          else wgmma_rs_n128(acc, pa[kk], dv);
        }
        wgmma_commit();
      };
      // Scores of the tile at key k0 -> P in s (log2 units, exp2), the
      // running max and sum, and corr, by which O must be rescaled.  Only a
      // tile on the diagonal, the window's edge or the ragged end evaluates
      // the mask.  s[4j + e] is row (e < 2 ? r0 : r1), key k0 + 8j + 2t +
      // (e & 1).
      auto softmax = [&](int k0, float (&corr)[2]) {
        const bool inside = k0 + BK <= p.S &&
                            (!p.causal || k0 + BK - 1 <= qc0) &&
                            (p.window <= 0 || k0 > qc0 + 63 - p.window);
        if (!inside) {
  #pragma unroll
          for (int j = 0; j < BK / 8; ++j)
  #pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!kept(p, e < 2 ? r0 : r1, k0 + 8 * j + 2 * t + (e & 1)))
                s[4 * j + e] = -INFINITY;
        }
        // row r's max and sum in 4 independent chains (i >> 1 & 3 = r + 2 *
        // the column tile's parity), so their latencies overlap
        float part[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  #pragma unroll
        for (int i = 0; i < 64; ++i)
          part[(i >> 1) & 3] = fmaxf(part[(i >> 1) & 3], s[i]);
        float tmax[2] = {fmaxf(part[0], part[2]), fmaxf(part[1], part[3])};
        float neg[2];                             // -(the max used)
  #pragma unroll
        for (int r = 0; r < 2; ++r) {
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
          const float mnew = fmaxf(m[r], tmax[r] * qk_scale);
          const float mexp = mnew == -INFINITY ? 0.0f : mnew;
          corr[r] = ex2(m[r] - mexp);
          neg[r] = -mexp;
          m[r] = mnew;
          l[r] *= corr[r];
        }
  #pragma unroll
        for (int i = 0; i < 4; ++i) part[i] = 0.0f;
  #pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float pe = ex2(fmaf(s[i], qk_scale, neg[(i >> 1) & 1]));
          s[i] = pe;
          part[(i >> 1) & 3] += pe;
        }
        l[0] += part[0] + part[2];
        l[1] += part[1] + part[3];
      };
      // P rounded to bf16: S's column tiles 2kk, 2kk + 1 are k-step kk's A.
      auto pack_p = [&]() {
  #pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
      };
      auto stage_addr = [&](uint8_t* base, int st) {
        return smem_addr(base + st * T::TILE_BYTES);
      };

      // Tile it's Q K^T runs beside tile it - 1's P V; its softmax runs
      // while that P V finishes, then O is rescaled and P packed.  The two
      // consumers take turns issuing their products.
      mbar_wait(qfull, local & 1);
      int prev = n % STAGES;
      mbar_wait(&full[prev], (n / STAGES) & 1);
      ++n;
      pin(s);
      turn_wait(c);
      wgmma_fence();
      issue_qk(stage_addr(sK, prev));
      turn_pass(c);
      wgmma_wait<0>();
      pin(s);
      if (w.ntiles == 1) mbar_arrive(qempty);   // Q may be reloaded
      float corr[2];
      softmax(w.lo, corr);
      pack_p();
      for (int it = 1; it < w.ntiles; ++it, ++n) {
        const int st = n % STAGES;
        mbar_wait(&full[st], (n / STAGES) & 1);
        pin(s);
        pin(acc);
        turn_wait(c);
        wgmma_fence();
        issue_qk(stage_addr(sK, st));
        issue_pv(stage_addr(sV, prev));
        turn_pass(c);
        wgmma_wait<1>();                        // S of tile it is in
        pin(s);
        if (it == w.ntiles - 1) mbar_arrive(qempty);
        softmax(w.lo + it * BK, corr);
        wgmma_wait<0>();                        // P V of tile it - 1 too
        pin(acc);
        mbar_arrive(&empty[prev]);              // its stage may be refilled
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
        pack_p();
        prev = st;
      }
      pin(acc);
      turn_wait(c);
      wgmma_fence();
      issue_pv(stage_addr(sV, prev));
      turn_pass(c);
      wgmma_wait<0>();
      pin(acc);
      mbar_arrive(&empty[prev]);

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
      }
      __nv_bfloat16* ob = o + w.b * p.o.b + w.h * p.o.h;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (r0 < p.S)
          *reinterpret_cast<uint32_t*>(ob + r0 * p.o.s + col) = pack_bf16(
              acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
        if (r1 < p.S)
          *reinterpret_cast<uint32_t*>(ob + r1 * p.o.s + col) = pack_bf16(
              acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
      }
    }
    if (c == 0) turn_wait(c);   // take consumer 1's last pass
  }
}

// -------------------------------------------------------------------------
// fp32: SIMT fp32 FMAs
// -------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(256)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Problem p) {
  constexpr int TPR = 4;              // threads per query row
  constexpr int CH = HD / 16;         // float4 chunks per thread
  __shared__ __align__(16) float sK[BK32][HD];
  __shared__ __align__(16) float sV[BK32][HD];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int part = threadIdx.x % TPR;
  const int qpos = q0 + threadIdx.x / TPR;
  const bool live = qpos < p.S;

  const float* kb = k + b * p.k.b + kvh * p.k.h;
  const float* vb = v + b * p.v.b + kvh * p.v.h;

  // this thread's dims: chunk c covers 16c + 4*part + [0, 4)
  float4 qr[CH], acc[CH];
  const float* qrow = q + b * p.q.b + h * p.q.h + qpos * p.q.s;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    qr[c] = live ? *reinterpret_cast<const float4*>(qrow + 16 * c + 4 * part)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY, l = 0.0f;

  int lo, hi;
  key_range(p, q0, BQ, BK32, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += BK32) {
    __syncthreads();
    for (int i = threadIdx.x; i < BK32 * HD / 4; i += blockDim.x) {
      const int row = i / (HD / 4), col = (i % (HD / 4)) * 4;
      const int kpos = k0 + row;
      float4 kr = make_float4(0.f, 0.f, 0.f, 0.f), vr = kr;
      if (kpos < p.S) {
        kr = *reinterpret_cast<const float4*>(kb + kpos * p.k.s + col);
        vr = *reinterpret_cast<const float4*>(vb + kpos * p.v.s + col);
      }
      *reinterpret_cast<float4*>(&sK[row][col]) = kr;
      *reinterpret_cast<float4*>(&sV[row][col]) = vr;
    }
    __syncthreads();

    float s[BK32];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK32; ++j) {
      float d = 0.0f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(
            &sK[j][16 * c + 4 * part]);
        d = fmaf(qr[c].x, kv.x, d);
        d = fmaf(qr[c].y, kv.y, d);
        d = fmaf(qr[c].z, kv.z, d);
        d = fmaf(qr[c].w, kv.w, d);
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      s[j] = kept(p, qpos, k0 + j) ? d * p.scale : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    const float mnew = fmaxf(m, tmax);
    const float mexp = mnew == -INFINITY ? 0.0f : mnew;
    const float corr = expf(m - mexp);
    m = mnew;
    l *= corr;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      acc[c].x *= corr;
      acc[c].y *= corr;
      acc[c].z *= corr;
      acc[c].w *= corr;
    }
#pragma unroll
    for (int j = 0; j < BK32; ++j) {
      const float pj = expf(s[j] - mexp);
      l += pj;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(
            &sV[j][16 * c + 4 * part]);
        acc[c].x = fmaf(pj, vv.x, acc[c].x);
        acc[c].y = fmaf(pj, vv.y, acc[c].y);
        acc[c].z = fmaf(pj, vv.z, acc[c].z);
        acc[c].w = fmaf(pj, vv.w, acc[c].w);
      }
    }
  }

  if (live) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    float* orow = o + b * p.o.b + h * p.o.h + qpos * p.o.s;
#pragma unroll
    for (int c = 0; c < CH; ++c)
      *reinterpret_cast<float4*>(orow + 16 * c + 4 * part) =
          make_float4(acc[c].x * inv, acc[c].y * inv, acc[c].z * inv,
                      acc[c].w * inv);
  }
}


// cuTensorMapEncodeTiled, from the driver through the runtime, so the
// library links no -lcuda.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 [B, S, heads, hd] tensor as dims (hd, heads, S, B), 128-byte
// swizzled boxes of 64 columns x 1 head x `rows` rows x 1 batch; reads past
// S come back as zeros.
bool encode_map(CUtensorMap* map, const void* base, int B, int S, int heads,
                int hd, const Strides& st, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, const Problem& p, cudaStream_t stream) {
  using T = Bf16Tile<HD>;
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, q, B, p.S, p.H, HD, p.q, 64) ||
      !encode_map(&mk, k, B, p.S, p.KV, HD, p.k, T::BK) ||
      !encode_map(&mv, v, B, p.S, p.KV, HD, p.v, T::BK))
    return cudaErrorInvalidValue;
  const long long items =
      static_cast<long long>((p.S + T::ROWS - 1) / T::ROWS) * p.H * B;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_bf16<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::SMEM);
  if (err != cudaSuccess) return err;
  const int blocks = static_cast<int>(items < sms ? items : sms);
  flash_fwd_bf16<HD><<<blocks, THREADS_BF16, T::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), B,
      static_cast<int>(items), p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, const Problem& p, int dtype, cudaStream_t stream) {
  if (dtype == 1) return launch_bf16<HD>(q, k, v, o, B, p, stream);
  const dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  flash_fwd_f32<HD><<<grid, 256, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// strides: 12 element strides, (batch, seq, head) of q, k, v, o in turn.
// window <= 0 means no window.  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for arguments the kernel does not take (a bf16
// tensor map that cannot be encoded among them).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int KV, int hd,
                                      const long long* strides, int causal,
                                      int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Problem p;
  p.S = S;
  p.H = H;
  p.KV = KV;
  p.scale = 1.0f / sqrtf(static_cast<float>(hd));
  p.causal = causal;
  p.window = window;
  Strides* all[4] = {&p.q, &p.k, &p.v, &p.o};
  for (int i = 0; i < 4; ++i) {
    all[i]->b = strides[3 * i];
    all[i]->s = strides[3 * i + 1];
    all[i]->h = strides[3 * i + 2];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64) return static_cast<int>(launch<64>(q, k, v, o, B, p, dtype, s));
  if (hd == 128)
    return static_cast<int>(launch<128>(q, k, v, o, B, p, dtype, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

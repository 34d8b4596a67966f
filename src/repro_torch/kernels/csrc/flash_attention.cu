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
// 12.5 us at 3.35 TB/s.
//
// Design (simple and right first; wgmma, TMA and warp specialisation are
// later work):
//  * bf16: one block of 4 warps per (64-row query tile, head, batch).  Each
//    warp owns 16 query rows, holds them as mma.sync.m16n8k16 A fragments
//    in registers for the whole loop, and keeps its 16 x hd fp32 output
//    accumulator in registers.  K and V tiles (64 keys at hd 64, 32 at hd
//    128) are copied into two shared-memory buffers with cp.async, the
//    next tile in flight while the current one is computed, rows padded by
//    8 elements so ldmatrix reads are conflict-free; ldmatrix gives the B
//    fragments of K, and its transposing form those of V.  S = Q K^T and
//    O += P V both run on the tensor cores with fp32 accumulators, P
//    rounded to bf16 for the second product.  Scores are kept in log2
//    units (scale * log2 e folded in) so the softmax uses exp2f.  Row max
//    and sum reduce over the 4 threads of a fragment row with two
//    shuffles; only tiles on the diagonal, the window's edge or the
//    ragged end evaluate the mask.
//  * fp32: plain fp32 FMAs (no TF32, so the result stays within 2e-5 of
//    the plain version).  256 threads per 64-row tile, 4 threads a row, each
//    owning hd / 4 dims of q and of the accumulator; a score is the sum of
//    the 4 partial dot products (two shuffles).  K and V tiles of 32 keys
//    in shared memory, read as float4 broadcasts.
//  * hd is a template parameter: 64 or 128.  Keys past S are zero-filled in
//    shared memory (0 * garbage could be NaN) and masked; query rows past S
//    are computed and not stored.
//
// Traps:
//  * A row can see no key of a tile (window) or of any tile so far: its
//    running max is then -inf, and exp(-inf - -inf) would be NaN.  The
//    max used for the exponent is 0 in that case, so p = 0 and corr = 0.
//  * Build without --use_fast_math: exp and division stay IEEE-accurate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK32 = 32;      // keys per tile, fp32 path
constexpr int PAD = 8;        // bf16 elements of padding per smem row

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
// bf16: mma.sync.m16n8k16, fp32 accumulators
// -------------------------------------------------------------------------

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and receives row l / 4, columns 2(l % 4) and
// 2(l % 4) + 1 of each (with .trans: those of the transposed matrix).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Keys per tile: two buffers of K and V tiles stay under 48 KB.
template <int HD> struct Tile { static constexpr int BK = HD == 64 ? 64 : 32; };

template <int HD>
__global__ void __launch_bounds__(128)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, Problem p) {
  constexpr int BK = Tile<HD>::BK;
  constexpr int KSTEPS = HD / 16;     // k-steps of Q K^T
  constexpr int NT = BK / 8;          // 8-key column tiles of S
  constexpr int DT = HD / 8;          // 8-dim column tiles of O
  constexpr int VEC = 8;              // bf16 per 16-byte copy
  constexpr float LOG2E = 1.4426950408889634f;
  __shared__ __align__(16) __nv_bfloat16 sK[2][BK][HD + PAD];
  __shared__ __align__(16) __nv_bfloat16 sV[2][BK][HD + PAD];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;          // fragment row / column
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8; // this thread's two rows
  const float qk_scale = p.scale * LOG2E;         // scores in log2 units

  const __nv_bfloat16* qb = q + b * p.q.b + h * p.q.h;
  const __nv_bfloat16* kb = k + b * p.k.b + kvh * p.k.h;
  const __nv_bfloat16* vb = v + b * p.v.b + kvh * p.v.h;

  // K and V tile at key k0 into buffer buf; rows past S are zero-filled
  // (0 * garbage could be NaN in P V).
  auto load_tile = [&](int buf, int k0) {
    for (int i = threadIdx.x; i < BK * HD / VEC; i += blockDim.x) {
      const int row = i / (HD / VEC), col = (i % (HD / VEC)) * VEC;
      const int kpos = k0 + row;
      const bool valid = kpos < p.S;
      const long long kr = valid ? kpos : 0;
      cp_async16(&sK[buf][row][col], kb + kr * p.k.s + col, valid);
      cp_async16(&sV[buf][row][col], vb + kr * p.v.s + col, valid);
    }
  };

  // Q as A fragments: reg 0/1 rows r0/r1, cols 16kk + 2t; reg 2/3 the same
  // rows, cols 16kk + 8 + 2t.
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = 16 * kk + 2 * t;
    qa[kk][0] = r0 < p.S ? load_pair(qb + r0 * p.q.s + c) : 0u;
    qa[kk][1] = r1 < p.S ? load_pair(qb + r1 * p.q.s + c) : 0u;
    qa[kk][2] = r0 < p.S ? load_pair(qb + r0 * p.q.s + c + 8) : 0u;
    qa[kk][3] = r1 < p.S ? load_pair(qb + r1 * p.q.s + c + 8) : 0u;
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};   // running max (log2 units)
  float l[2] = {0.0f, 0.0f};             // this thread's share of the sum

  int lo, hi;
  key_range(p, q0, BQ, BK, lo, hi);
  const int ntiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;
  if (ntiles > 0) load_tile(0, lo);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = lo + it * BK, buf = it & 1;
    if (it + 1 < ntiles) load_tile(buf ^ 1, k0 + BK);   // next tile, in flight
    cp_async_commit();
    cp_async_wait_one();                                 // this tile landed
    __syncthreads();

    // S = Q K^T.  B[kdim][key] = K[key][kdim]: one ldmatrix gives the B
    // registers of k-steps kk and kk + 1 of key tile n.
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; kk += 2) {
        uint32_t kf[4];
        ldsm_x4(kf, &sK[buf][8 * n + (lane & 7)][16 * kk + 8 * (lane >> 3)]);
        mma16816(s[n], qa[kk], kf[0], kf[1]);
        mma16816(s[n], qa[kk + 1], kf[2], kf[3]);
      }
    }

    // scale, mask (only a tile on the diagonal, the window's edge or the
    // ragged end needs it), running max over the row's 4 threads
    const bool inside = k0 + BK <= p.S && (!p.causal || k0 + BK - 1 <= q0) &&
                        (p.window <= 0 || k0 > q0 + BQ - 1 - p.window);
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = e < 2 ? r0 : r1;
        const int kpos = k0 + 8 * n + 2 * t + (e & 1);
        const float x = inside || kept(p, qpos, kpos) ? s[n][e] * qk_scale
                                                      : -INFINITY;
        s[n][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float mexp[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float mnew = fmaxf(m[r], tmax[r]);
      mexp[r] = mnew == -INFINITY ? 0.0f : mnew;
      corr[r] = exp2f(m[r] - mexp[r]);
      m[r] = mnew;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[n][e] - mexp[e >> 1]);
        s[n][e] = pe;
        l[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P V: the S accumulators of column tiles 2kk, 2kk+1 are exactly
    // the A fragment of k-step kk; B[key][dim] = V[key][dim], read with a
    // transposing ldmatrix that gives dim tiles j and j + 1 at once.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, &sV[buf][16 * kk + 8 * ((lane >> 3) & 1) +
                                   (lane & 7)][8 * (j + (lane >> 4))]);
        mma16816(acc[j], pa, vf[0], vf[1]);
        mma16816(acc[j + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();   // buffer buf is refilled two tiles from now
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* ob = o + b * p.o.b + h * p.o.h;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = 8 * j + 2 * t;
    if (r0 < p.S)
      *reinterpret_cast<uint32_t*>(ob + r0 * p.o.s + c) =
          pack_bf16(acc[j][0] * inv[0], acc[j][1] * inv[0]);
    if (r1 < p.S)
      *reinterpret_cast<uint32_t*>(ob + r1 * p.o.s + c) =
          pack_bf16(acc[j][2] * inv[1], acc[j][3] * inv[1]);
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

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, const Problem& p, int dtype, cudaStream_t stream) {
  const dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  if (dtype == 0) {
    flash_fwd_f32<HD><<<grid, 256, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), p);
  } else {
    flash_fwd_bf16<HD><<<grid, 128, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), p);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// strides: 12 element strides, (batch, seq, head) of q, k, v, o in turn.
// window <= 0 means no window.  Returns cudaGetLastError() after the launch.
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

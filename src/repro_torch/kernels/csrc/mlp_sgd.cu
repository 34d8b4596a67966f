// Local SGD of many one-hidden-layer ReLU MLP client rows, for Hopper
// (sm_90a).
//
// For each client row r of rows_in [R, W] (float32, fl/state.py's
// ParamLayout in JAX's sorted-key order: b1 [H] at 0, w1 [D, H] at H,
// b2 [C] at H + D*H, w2 [H, C] right after b2, padding up to W), L steps
// of plain SGD on the batches x [R, L, B, D] (float32), y [R, L, B]
// (int32):
//
//   z = x.W1 + b1,  h = relu(z),  logits = h.W2 + b2,
//   loss = mean over the batch of the softmax cross-entropy,
//   theta <- theta + (-lr) * dloss/dtheta      (every leaf, every step)
//
// written to rows_out [R, W]; the padding floats are copied from rows_in.
// Every gradient of a step is taken at the step's parameters (dh from the
// pre-update W2), as autograd takes them, and each update is rounded as
// autograd's `-lr * g` then `theta + upd`.  An out-of-range label gives no
// one-hot term (PyTorch would raise); the caller's labels are in [0, C).
//
// Replaces no Pallas kernel: the JAX package leaves local SGD, vmap(grad)
// of the loss over the client axis, to XLA (src/repro/fl/engine.py,
// make_local_train).  On the card that was PyTorch autograd over the flat
// [R, W] rows: ~9 elementwise passes over the rows a step (autograd's
// zero-filled slice_backward buffer for each of the four leaves and their
// sum, -lr*g, theta + upd) and ~10x the rows in memory.
//
// What bounds it, at the dense main path (R 10,000 rows, L 5, B 10,
// 784-200-10, W 159,012):
//  * bytes: each row read once and written once, 12.7 GB, and the batches
//    read once, 1.57 GB: 14.3 GB, 4.3 ms at 3.35 TB/s;
//  * arithmetic: ~3.2 M fp32 FMAs a client a step (layer 1's forward,
//    10x784x200, and its weight gradient, 784x200x10; layer 2 ~1 % of it):
//    3.2e11 FLOP over 50,000 client-steps, 4.8 ms at 67 TFLOP/s.
// So ~5 ms a round.  Fp32 FMA on the CUDA cores throughout (the
// configuration says tf32 false): no TF32, bf16 or 3xTF32.
//
// Every sum is taken in the order autograd's kernels take it on an H100
// with PyTorch 2.11 and CUDA 12.8 at 784-200-10 (measured bit-equal at
// B 10 and R 1,000 to 10,000; cuBLAS picks other kernels at R 64, where
// the rows agree to rounding only): each product's
// output an FMA chain over its inner dimension in order, the logits' as
// two such chains over the halves of the hidden units, added (cuBLAS's
// split at K 200); a bias gradient in four accumulators, row b into
// b % 4, added in order (torch.sum over the batch); the softmax and its
// gradient as PyTorch's warp softmax, fused multiply-add included.  So the
// rows come out bit-equal to autograd's and to the benchmark's plain
// reference.  That is what keeps a z within rounding of 0 on autograd's
// side of relu: summed in another order, a few of the millions of
// pre-activations a round land on the other side, and that unit's W1
// column moves by ~1e-3 of its change.
//
// Design: the row stays in shared memory for all L steps, so it is read
// once and written once.
//  * One thread-block cluster of CL CTAs a row (the fewest that fit; 4 at
//    B <= 10 for 784-200-10).  CTA c holds W1's columns of its share of
//    the hidden units (4-column tiles split evenly, 52 or 48 columns at
//    CL 4), all D rows (163 KB), and b1, b2, W2 and the step's batch (x
//    transposed to [D][BP]).  A persistent grid of clusters walks the rows.
//  * Forward, with no communication: a thread a tile of 2 batch rows x 4
//    hidden units, each an FMA chain over the D inputs in order.
//  * Layer 2: every CTA gathers all of h through distributed shared
//    memory (h is double buffered by step parity, so one cluster barrier
//    a step suffices) and computes the logits, dlogits and W2's and b2's
//    updates alike; then dh and b1 for its own hidden units.
//  * W1's update: a thread keeps dh[:, 4 columns] in registers and walks
//    its share of the rows, W1[i, j] += (-lr) * sum_b x[b, i] dh[b, j].
//  * Loads by cp.async: the row (b1, the tail b2/W2/padding, the CTA's W1
//    columns) and each step's batch, the next batch prefetched into L2
//    during the step; stores straight from shared memory.
//  * The batch is padded to BP (a template parameter) with zero rows that
//    add exact zeros: x, h, dlogits and dh are 0 there.
//
// Deterministic: every sum has one fixed order and nothing depends on
// which cluster takes a row, so two launches give the same bits, and a
// row's result does not depend on R or on the other rows.
//
// Traps:
//  * Build without --use_fast_math (NaN propagation, expf).
//  * relu keeps NaN (torch.relu does), and its gradient passes where
//    !(h <= 0), as threshold_backward does, NaN included.
//  * A CTA must not leave while another reads its partials: a last
//    cluster barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// The kernel's limits; mlp_sgd_plan and the launch check every plan
// against them.
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_CLASSES = 12;
constexpr int MAX_SMEM = 232448;                   // 227 KB, sm_90's opt-in

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// Shared memory, in floats from the base; every region starts on 16 bytes.
// JC = ceil(H / 4 / CL) is the most 4-column tiles a CTA holds; a W1, h or
// dh row is 4 JC floats, a dlogits row round4(C).
struct Regions {
  int b1, tail, w1, xs, h, hall, dl, lab, total;
};

__host__ __device__ inline Regions regions(int D, int H, int C, int T,
                                           int bp, int cl) {
  const int hs = 4 * ((H / 4 + cl - 1) / cl);
  Regions r;
  r.b1 = 0;                            // b1 [H]
  r.tail = r.b1 + round4(H);           // b2 [C], w2 [H, C], padding
  r.w1 = r.tail + round4(T);           // the CTA's W1 columns [D][hs]
  r.xs = r.w1 + D * hs;                // the step's batch [D][BP]
  r.h = r.xs + round4(D * bp);         // h of the CTA's units [2][BP][hs]
                                       // (by step parity; dh in the other)
  r.hall = r.h + 2 * bp * hs;          // h of every unit [BP][H]
  r.dl = r.hall + bp * H;              // logits, dlogits [BP][round4(C)]
  r.lab = r.dl + bp * round4(C);       // labels [BP] (int)
  r.total = r.lab + round4(bp);
  return r;
}

struct Args {
  const float* rows_in;
  float* rows_out;
  const float* x;
  const int* y;
  long long R;
  int L, B, D, H, C, W;
  float nlr;    // -lr, float32
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// This thread's copies in flight, landed; a barrier then makes them all
// visible.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float relu(float v) {
  return v <= 0.0f ? 0.0f : v;         // NaN stays NaN, as torch.relu
}

// TB consecutive floats (8-byte aligned when TB is 2).
template <int TB>
__device__ __forceinline__ void load_pair(const float* p, float (&v)[TB]) {
  if constexpr (TB == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x;
    v[1] = u.y;
  } else {
    v[0] = p[0];
  }
}

// theta + (-lr) * g, rounded as autograd's two elementwise passes.
__device__ __forceinline__ float sgd(float theta, float nlr, float g) {
  return __fadd_rn(theta, __fmul_rn(nlr, g));
}

template <int BP>
__global__ void __launch_bounds__(THREADS, 1) mlp_sgd_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  constexpr int TB = BP > 1 ? 2 : 1;      // batch rows of a forward tile
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long first = blockIdx.x / CL;
  const long long clusters = gridDim.x / CL;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int L = a.L, B = a.B, D = a.D, H = a.H, C = a.C, W = a.W;
  const int T = W - H - D * H;            // b2, w2, padding
  const int JT = H / 4, HS = 4 * ((JT + CL - 1) / CL);
  const int t0 = rank * JT / CL, nt = (rank + 1) * JT / CL - t0;
  const int c0 = 4 * t0, hc = 4 * nt;     // this CTA's hidden units
  const int CP = round4(C);
  const Regions o = regions(D, H, C, T, BP, CL);
  float* b1 = sm + o.b1;
  float* tail = sm + o.tail;
  float* b2 = tail;
  float* w2 = tail + C;
  float* w1 = sm + o.w1;                  // w1[i * HS + (j - c0)]
  float* xs = sm + o.xs;                  // xs[i * BP + b]
  float* hbuf = sm + o.h;                 // h[b * HS + (j - c0)], 2 steps
  float* hall = sm + o.hall;              // hall[b * H + j]
  float* dl = sm + o.dl;                  // dl[b * CP + c]
  int* lab = reinterpret_cast<int*>(sm + o.lab);
  const float inv_b = 1.0f / static_cast<float>(B);

  for (int k = tid; k < D * BP; k += THREADS) xs[k] = 0.0f;   // pad rows
  __syncthreads();

  // x[r, s] (transposed) and y[r, s], by cp.async
  auto load_x = [&](long long r, int s) {
    const long long step = r * L + s;
    const float* src = a.x + step * B * static_cast<long long>(D);
    for (int b = 0; b < B; ++b)
      for (int i = tid; i < D; i += THREADS)
        cp_async4(xs + i * BP + b, src + static_cast<long long>(b) * D + i);
    for (int b = tid; b < B; b += THREADS)
      cp_async4(lab + b, a.y + step * B + b);
  };
  // the batch of step s of row r, into L2 ahead of its load
  auto prefetch_x = [&](long long r, int s) {
    const char* p = reinterpret_cast<const char*>(
        a.x + (r * L + s) * B * static_cast<long long>(D));
    const long long bytes = 4LL * B * D;
    for (long long off = 128LL * tid; off < bytes; off += 128LL * THREADS)
      asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p + off));
  };

  int gs = 0;                             // steps run, over all rows
  for (long long r = first; r < a.R; r += clusters) {
    // ---- the row in, with step 0's batch
    const float* row = a.rows_in + r * W;
    for (int e = tid; e < H / 4; e += THREADS)
      cp_async16(b1 + 4 * e, row + 4 * e);
    for (int e = tid; e < T / 4; e += THREADS)
      cp_async16(tail + 4 * e, row + H + D * H + 4 * e);
    for (int e = tid; e < D * nt; e += THREADS) {
      const int i = e / nt, q = e - i * nt;
      cp_async16(w1 + i * HS + 4 * q,
                 row + H + static_cast<long long>(i) * H + c0 + 4 * q);
    }
    if (L > 0) load_x(r, 0);
    cp_async_wait_all();
    __syncthreads();

    for (int s = 0; s < L; ++s, ++gs) {
      {                                   // the next batch, into L2
        long long rn = r;
        int sn = s + 1;
        if (sn == L) { rn = r + clusters; sn = 0; }
        if (rn < a.R) prefetch_x(rn, sn);
      }

      float* h = hbuf + (gs & 1) * BP * HS;   // read by the cluster
      float* dh = hbuf + (~gs & 1) * BP * HS; // read by no other CTA

      // ---- forward: a thread a tile of TB batch rows x 4 hidden units,
      // each z an FMA chain over the inputs in order, then + b1.  A CTA
      // has few tiles, so each runs its chain alone: unrolled deep, so that
      // loads run ahead of the sums.  The batch groups of a tile lie in
      // neighbouring lanes: a quarter warp reads one or two W1 chunks (no
      // bank conflict), a half warp one run of x.
      for (int t = tid; t < (BP / TB) * nt; t += THREADS) {
        const int bg = t % (BP / TB), jt = t / (BP / TB);
        float acc[TB][4] = {};
        const float* wp = w1 + 4 * jt;
        const float* xp = xs + TB * bg;
#pragma unroll 16
        for (int i = 0; i < D; ++i) {
          const float4 w = *reinterpret_cast<const float4*>(wp + i * HS);
          float xv[TB];
          load_pair<TB>(xp + i * BP, xv);
#pragma unroll
          for (int tb = 0; tb < TB; ++tb) {
            acc[tb][0] = fmaf(xv[tb], w.x, acc[tb][0]);
            acc[tb][1] = fmaf(xv[tb], w.y, acc[tb][1]);
            acc[tb][2] = fmaf(xv[tb], w.z, acc[tb][2]);
            acc[tb][3] = fmaf(xv[tb], w.w, acc[tb][3]);
          }
        }
        const int jl = 4 * jt;
#pragma unroll
        for (int tb = 0; tb < TB; ++tb) {
          const int b = TB * bg + tb;
          float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (b < B)
            v = make_float4(relu(acc[tb][0] + b1[c0 + jl]),
                            relu(acc[tb][1] + b1[c0 + jl + 1]),
                            relu(acc[tb][2] + b1[c0 + jl + 2]),
                            relu(acc[tb][3] + b1[c0 + jl + 3]));
          *reinterpret_cast<float4*>(h + b * HS + jl) = v;
        }
      }
      cluster.sync();                     // every CTA's h is in

      // ---- every unit's h, from the CTAs that hold it (tile t of rank q)
      for (int e = tid; e < BP * JT; e += THREADS) {
        const int b = e / JT, t = e - b * JT;
        int q = 0;
        while (q + 1 < CL && (q + 1) * JT / CL <= t) ++q;
        const float* src = cluster.map_shared_rank(h, q) + b * HS +
                           4 * (t - q * JT / CL);
        *reinterpret_cast<float4*>(hall + b * H + 4 * t) =
            *reinterpret_cast<const float4*>(src);
      }
      __syncthreads();

      // ---- logits = h.W2 + b2, as cuBLAS's batched GEMM sums h.W2 at
      // K 200 (two FMA chains over the halves of the hidden units, added)
      for (int e = tid; e < BP * C; e += THREADS) {
        const int b = e / C, c = e - b * C;
        float v = 0.0f;                   // the padding rows hold zeros
        if (b < B) {
          const float* hb = hall + b * H;
          float v0 = 0.0f, v1 = 0.0f;
          for (int j = 0; j < H / 2; ++j) {
            v0 = fmaf(hb[j], w2[j * C + c], v0);
            v1 = fmaf(hb[H / 2 + j], w2[(H / 2 + j) * C + c], v1);
          }
          v = (v0 + v1) + b2[c];
        }
        dl[b * CP + c] = v;
      }
      __syncthreads();

      // ---- dlogits = (softmax - onehot) / B, as log_softmax's backward:
      // half a warp a batch row, a lane a class
      for (int b0 = 0; b0 < B; b0 += 2 * WARPS) {
        const int b = b0 + 2 * warp + lane / 16, c = lane % 16;
        const bool on = b < B && c < C;
        const float v = on ? dl[b * CP + c] : -INFINITY;
        float m = v;
#pragma unroll
        for (int k = 8; k > 0; k >>= 1) {
          const float u = __shfl_xor_sync(0xffffffffu, m, k, 16);
          m = (u > m || u != u) ? u : m;            // NaN propagates
        }
        m = __shfl_sync(0xffffffffu, m, 0, 16);
        float se = on ? expf(v - m) : 0.0f;
#pragma unroll
        for (int k = 8; k > 0; k >>= 1)
          se += __shfl_xor_sync(0xffffffffu, se, k, 16);
        const float lse = logf(__shfl_sync(0xffffffffu, se, 0, 16));
        if (on) {
          const float p = expf((v - m) - lse);
          dl[b * CP + c] = fmaf(p, inv_b, c == lab[b] ? -inv_b : 0.0f);
        }
      }
      __syncthreads();

      // ---- a thread a hidden unit j: W2[j] moves in every CTA alike (all
      // of W2 feeds the next logits); for this CTA's units also dh[:, j] =
      // dlogits.W2[j]^T where !(h <= 0), from the step's W2, and b1[j]
      // (and every CTA's b2, alike).  One pass over the batch: a dlogits
      // row, as float4s, feeds dh[b, j] and W2[j]'s gradient; the padding
      // rows add exact zeros and their dh is 0.  The products sum as
      // cuBLAS's (FMA chains in order), the bias gradients as torch.sum
      // over the batch (four accumulators, row b into b % 4, added in
      // order).
      for (int j = tid; j < H; j += THREADS) {
        const int jl = j - c0;
        const bool own = jl >= 0 && jl < hc;
        float w[MAX_CLASSES], g2[MAX_CLASSES];
#pragma unroll
        for (int c = 0; c < MAX_CLASSES; ++c) {
          w[c] = c < C ? w2[j * C + c] : 0.0f;
          g2[c] = 0.0f;
        }
        float g1[4] = {};
#pragma unroll
        for (int b = 0; b < BP; ++b) {
          const float hb = hall[b * H + j];
          float d[MAX_CLASSES];
#pragma unroll
          for (int q = 0; q < MAX_CLASSES / 4; ++q)
            if (4 * q < C) {
              const float4 u =
                  *reinterpret_cast<const float4*>(dl + b * CP + 4 * q);
              d[4 * q] = u.x; d[4 * q + 1] = u.y;
              d[4 * q + 2] = u.z; d[4 * q + 3] = u.w;
            }
#pragma unroll
          for (int c = 0; c < MAX_CLASSES; ++c)
            if (c < C) g2[c] = fmaf(hb, d[c], g2[c]);
          if (own) {
            float v = 0.0f;
#pragma unroll
            for (int c = 0; c < MAX_CLASSES; ++c)
              if (c < C) v = fmaf(d[c], w[c], v);
            if (b >= B || hb <= 0.0f) v = 0.0f;
            dh[b * HS + jl] = v;
            if (b < B) g1[b % 4] += v;
          }
        }
#pragma unroll
        for (int c = 0; c < MAX_CLASSES; ++c)
          if (c < C) w2[j * C + c] = sgd(w[c], a.nlr, g2[c]);
        if (own)
          b1[j] = sgd(b1[j], a.nlr, ((g1[0] + g1[1]) + g1[2]) + g1[3]);
      }
      for (int c = tid; c < C; c += THREADS) {
        float g[4] = {};
        for (int b = 0; b < B; ++b) g[b % 4] += dl[b * CP + c];
        b2[c] = sgd(b2[c], a.nlr, ((g[0] + g[1]) + g[2]) + g[3]);
      }
      __syncthreads();

      // ---- this CTA's W1 columns: dh's 4 columns held in registers, the
      // rows split over the threads
      const int k2 = THREADS / nt;
      if (tid < nt * k2) {
        const int jt = tid % nt, ks = tid / nt;
        float d[BP][4];
#pragma unroll
        for (int b = 0; b < BP; ++b) {
          const float4 v = *reinterpret_cast<const float4*>(dh + b * HS +
                                                            4 * jt);
          d[b][0] = v.x; d[b][1] = v.y; d[b][2] = v.z; d[b][3] = v.w;
        }
        for (int i = ks; i < D; i += k2) {
          const float* xi = xs + i * BP;
          float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, g3 = 0.0f;
#pragma unroll
          for (int b = 0; b < BP; ++b) {
            const float xv = xi[b];
            g0 = fmaf(xv, d[b][0], g0);
            g1 = fmaf(xv, d[b][1], g1);
            g2 = fmaf(xv, d[b][2], g2);
            g3 = fmaf(xv, d[b][3], g3);
          }
          float4* p = reinterpret_cast<float4*>(w1 + i * HS + 4 * jt);
          const float4 w = *p;
          *p = make_float4(sgd(w.x, a.nlr, g0), sgd(w.y, a.nlr, g1),
                           sgd(w.z, a.nlr, g2), sgd(w.w, a.nlr, g3));
        }
      }
      __syncthreads();

      if (s + 1 < L) {                    // the next step's batch
        load_x(r, s + 1);
        cp_async_wait_all();
        __syncthreads();
      }
    }

    // ---- the row out: this CTA's b1 and W1 columns; CTA 0 the tail (b2,
    // W2 and the padding, alike in every CTA)
    float* out = a.rows_out + r * W;
    for (int e = tid; e < D * nt; e += THREADS) {
      const int i = e / nt, q = e - i * nt;
      *reinterpret_cast<float4*>(out + H + static_cast<long long>(i) * H +
                                 c0 + 4 * q) =
          *reinterpret_cast<const float4*>(w1 + i * HS + 4 * q);
    }
    for (int e = tid; e < hc; e += THREADS) out[c0 + e] = b1[c0 + e];
    if (rank == 0)
      for (int e = tid; e < T; e += THREADS) out[H + D * H + e] = tail[e];
    __syncthreads();                      // before the next row lands
  }
  cluster.sync();                         // no CTA leaves while read
}

// The batch tile a batch of B rows runs in; 0 above the largest.  The
// tiles are the batches the port runs (1; the paper's 10; 32, the largest
// that fits), each a template instance: a batch between them is padded.
inline int batch_tile(int B) {
  const int tiles[] = {1, 10, 32};
  for (int t : tiles)
    if (B <= t) return t;
  return 0;
}

// Shared memory in bytes of the plan, or a negative value for shapes or a
// cluster the kernel does not take.
inline int plan_smem(int B, int D, int H, int C, int W, int cl) {
  const int bp = batch_tile(B);
  if (bp == 0 || B < 1 || D < 1 || H < 4 || H % 4 != 0 ||
      C < 1 || C > MAX_CLASSES || W % 4 != 0 ||
      (cl != 1 && cl != 2 && cl != 4 && cl != 8) || cl > H / 4 ||
      (H / 4 + cl - 1) / cl > THREADS)
    return -1;
  const long long T = static_cast<long long>(W) - H -
                      static_cast<long long>(D) * H;
  if (T < C + static_cast<long long>(H) * C || T % 4 != 0) return -1;
  const long long bytes =
      4LL * regions(D, H, C, static_cast<int>(T), bp, cl).total;
  return bytes > MAX_SMEM ? -1 : static_cast<int>(bytes);
}

template <int BP>
cudaError_t run(const Args& a, int cl, int clusters, int smem,
                cudaStream_t stream, int* occupancy) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_sgd_kernel<BP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * cl));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cl);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (occupancy != nullptr)
    return cudaOccupancyMaxActiveClusters(occupancy, mlp_sgd_kernel<BP>,
                                          &cfg);
  err = cudaLaunchKernelEx(&cfg, mlp_sgd_kernel<BP>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t dispatch(const Args& a, int cl, int clusters, int smem,
                     cudaStream_t stream, int* occupancy) {
  switch (batch_tile(a.B)) {
    case 1: return run<1>(a, cl, clusters, smem, stream, occupancy);
    case 10: return run<10>(a, cl, clusters, smem, stream, occupancy);
    case 32: return run<32>(a, cl, clusters, smem, stream, occupancy);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes.  cl: the CTAs of a cluster
// (mlp_sgd_plan's); clusters: how many clusters the persistent grid holds
// (at most mlp_sgd_max_clusters').  Each returns a CUDA error code (0 on
// success; cudaErrorInvalidValue for arguments or a plan the kernel does
// not take); the launch returns cudaGetLastError() after it.

// The plan for batches of B rows of a D-H-C MLP in rows of W floats: the
// fewest CTAs a cluster (*cl) whose shared memory (*smem bytes a CTA)
// holds a CTA's W1 columns with the step's batch.
extern "C" int mlp_sgd_plan(int B, int D, int H, int C, int W, int* cl,
                            int* smem) {
  for (int c = 1; c <= MAX_CLUSTER; c *= 2) {
    const int bytes = plan_smem(B, D, H, C, W, c);
    if (bytes >= 0) {
      *cl = c;
      *smem = bytes;
      return 0;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int mlp_sgd_launch(const void* rows_in, void* rows_out,
                              const void* x, const void* y, long long R,
                              int L, int B, int D, int H, int C, int W,
                              int cl, int clusters, float nlr, void* stream) {
  const int smem = plan_smem(B, D, H, C, W, cl);
  if (smem < 0 || R < 0 || L < 0 || clusters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  Args a{static_cast<const float*>(rows_in), static_cast<float*>(rows_out),
         static_cast<const float*>(x), static_cast<const int*>(y), R, L, B,
         D, H, C, W, nlr};
  return static_cast<int>(dispatch(a, cl, clusters, smem,
                                   static_cast<cudaStream_t>(stream),
                                   nullptr));
}

// How many clusters of the plan the current card runs at once, in *out.
extern "C" int mlp_sgd_max_clusters(int B, int D, int H, int C, int W,
                                    int cl, int* out) {
  const int smem = plan_smem(B, D, H, C, W, cl);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.B = B;
  return static_cast<int>(dispatch(a, cl, 1, smem, nullptr, out));
}

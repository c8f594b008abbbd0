// LSTM recurrence, forward and backward.  Time-major: xs [T, B, 4H] f32
// (pre-projected gate inputs, bias folded in; gates i | f | g | o), w
// [H, 4H] f32 or bf16, h0/c0 [B, H] f32, mask [T, B] f32 (1 live, 0
// padding: a padded step carries h and c through).
//   gates = xs[t] + mm(h_prev) . w             (f32 accumulation)
//   c = f * c_prev + i * g,  h = o * tanh(c),  masked against h/c_prev
// where mm() rounds the operand to bf16 when w is bf16 (program.amp), as
// the Pallas kernels' dots take `.astype(w.dtype)` operands.  The backward
// recomputes the gates from the saved h_prev/c_prev sequences (built by
// the wrapper: [h0, hs[:-1]]), walks t from T - 1 down to 0 and returns
// dxs (= dgates), dw (f32, summed over T), dh0 and dc0.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py _lstm_fwd_kernel
// (_lstm_pallas_fwd) and _lstm_bwd_kernel (_lstm_pallas_bwd).
//
// Bound on the H100: neither bytes nor operations.  At the main path's
// T80 B32 H512 the function moves ~35 MB (~10 us at 3.35 TB/s) and does
// 5.4 GFLOP forward (~80 us at the f32 rate, ~5 us on bf16 tensor cores),
// but step t needs every unit of step t - 1: the time is T times the
// latency of one step (a [B, H] x [H, 4H] product split over the card, the
// gate math, and a grid-wide barrier).
//
// Forward.  On the TPU the grid over T runs in order on one core with w
// in VMEM.  Here one cooperative launch is persistent over T: block k
// owns HB hidden units (HB = 4 at H = 512: 128 blocks on 132 SMs) and
// keeps the 4 * HB columns of w that feed them in shared memory ([4HB][H]
// f32, 32 KB), so its gate math stays local.  Per step each warp takes R
// batch rows, reads h_prev from L2 and accumulates R x 4HB dot products
// over H (lanes stride over H, then a warp reduction); the cell math runs
// per (row, unit); `grid.sync()` ends the step.
//
// Backward.  Only dh and dc carry from step to step: the gates'
// pre-activations depend on the saved h_prev alone, and dw on h_prev and
// the dgates of every step.  So one C call enqueues three kernels:
//   1. the gates for all T at once, [T*B, H] x [H, 4H] + xs, into dxs;
//   2. the recurrence, one cooperative launch persistent over T (block k
//      owns HB units as in the forward, keeping only the rows of w of its
//      units, [HB][4H]): per step the cell's gradients of its units
//      (dgates written over their gates in dxs, and as a bf16 copy for a
//      bf16 w: the operand's precision, half the bytes every block reads
//      back), one grid-wide barrier, then dh_prev of its units from every
//      unit's dgates, through L2 -- on the tensor cores (mma.sync
//      m16n8k16) for a bf16 w, on the CUDA cores for f32;
//   3. dw = mm(h_prev)^T . mm(dgates), [H, T*B] x [T*B, 4H].
// 1 and 3 are tiled products: bf16 mma.sync on the tensor cores for a bf16
// w, the CUDA cores for f32.  Every sum is taken in a fixed order, the
// tensor cores' 16-deep products each added to an f32 sum with FADD, and
// nothing is summed with atomics: runs repeat bit for bit.
#include "flash_mma.cuh"
#include "recurrent.cuh"

namespace {

using namespace ptt::rnn;

template <typename W, int HB>
__global__ void __launch_bounds__(kThreads)
    lstm_fwd_kernel(const float* __restrict__ xs, const W* __restrict__ w,
                    const float* __restrict__ h0,
                    const float* __restrict__ c0,
                    const float* __restrict__ mask, float* hs, float* cs,
                    int T, int B, int H) {
  constexpr int G = 4 * HB;
  constexpr int R = rows_per_warp(G);
  extern __shared__ float smem[];
  float* w_s = smem;            // [G][H] the units' columns of w
  float* g_s = w_s + G * H;     // [B][G] gate pre-activations of a step
  const int j0 = blockIdx.x * HB, nu = min(HB, H - j0);
  const int warp = threadIdx.x >> 5;
  const int64_t H4 = 4LL * H, BH = static_cast<int64_t>(B) * H;
  load_columns<W, HB>(w, H, 4, j0, nu, w_s);
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < T; ++t) {
    const float* hp = t ? hs + (t - 1) * BH : h0;
    const float* cp = t ? cs + (t - 1) * BH : c0;
    const float* xt = xs + t * B * H4;
    for (int b0 = warp * R; b0 < B; b0 += kWarps * R) {
      float acc[R][G];
      warp_rows_dot<W, R, G, true>(hp, H, b0, B, H, w_s, acc);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int n = 0; n < G; ++n) {
          const int b = b0 + r, q = n / HB, u = n % HB;
          if (lane_owns(r, n, G) && b < B && u < nu)
            g_s[b * G + n] = xt[b * H4 + q * H + j0 + u] + acc[r][n];
        }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
      const int b = idx / nu, u = idx - b * nu;
      const int64_t at = static_cast<int64_t>(b) * H + j0 + u;
      const float* g = g_s + b * G;
      const float i = sigmoid(g[u]), f = sigmoid(g[HB + u]);
      const float gg = tanhf(g[2 * HB + u]), o = sigmoid(g[3 * HB + u]);
      const float h_prev = __ldcg(hp + at), c_prev = __ldcg(cp + at);
      const float c_new = f * c_prev + i * gg;
      const float h_new = o * tanhf(c_new);
      const float m = mask[t * B + b];
      hs[t * BH + at] = m * h_new + (1.f - m) * h_prev;
      cs[t * BH + at] = m * c_new + (1.f - m) * c_prev;
    }
    grid.sync();
  }
}

// --- backward: the products before and after the recurrence ------------
//
// out[M][N] = (cin ? cin[M][N] : 0) + sum over k < K of mm(A[m][k]) . B[k][n]
// with A f32 at a[m * lda + k] (kAT: at a[k * lda + m], A stored
// transposed) and B of w's type at b[k * ldb + n]; out and cin have row
// stride N.  A block computes a 64 x 64 tile of out, 32 (bf16) or 16
// (f32) k at a time through shared memory; with gridDim.z = S > 1 block
// z takes the z-th of S runs of k-tiles and writes its partial tile to
// out + z * M * N, which `lstm_bwd_sum_splits_kernel` adds in order of z
// (a product with few output tiles and a long k, as dw, fills the card
// that way).
//  - bf16 w: mma.sync m16n8k16 on the tensor cores, A rounded to bf16 as
//    it is staged (mm()); 4 warps, 16 rows each.  The next k-tile is
//    loaded into registers (16-byte loads where the strides and pointers
//    allow) while the current one is multiplied.  Each 16-deep product
//    is summed from zero and added to the f32 accumulator with FADD
//    (the tensor cores do not round their sums to nearest, PERF.md).
//  - f32 w: the CUDA cores, 256 threads with 4 x 4 outputs each, every
//    sum an FMA chain over k in order.
// The gates' pre-activations are this with cin = xs, A = h_prev [T*B, H]
// and B = w; dw is it with A^T = h_prev (kAT) and B = dgates [T*B, 4H].
constexpr int kBM = 64, kBN = 64;

template <typename W>
__host__ __device__ constexpr int gemm_threads() {
  return sizeof(W) == 2 ? 128 : 256;
}

template <typename W>
__host__ __device__ constexpr int gemm_bk() {
  return sizeof(W) == 2 ? 32 : 16;
}

__device__ __forceinline__ uint2 pack4_bf16(float4 v) {
  return make_uint2(ptt::fa::pack_bf16(v.x, v.y), ptt::fa::pack_bf16(v.z, v.w));
}

template <typename W, bool kAT>
__global__ void __launch_bounds__(gemm_threads<W>())
    lstm_bwd_gemm_kernel(const float* __restrict__ a, int64_t lda,
                         const W* __restrict__ b, int64_t ldb,
                         const float* __restrict__ cin,
                         float* __restrict__ out, int M, int N, int K,
                         int kps) {
  constexpr int NT = gemm_threads<W>(), kBK = gemm_bk<W>();
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * kps, kt1 = min(nk, kt0 + kps);
  if (gridDim.z > 1) out += static_cast<int64_t>(blockIdx.z) * M * N;
  auto a_at = [&](int m, int k) -> float {
    if (m >= M || k >= K) return 0.f;
    return kAT ? a[static_cast<int64_t>(k) * lda + m]
               : a[static_cast<int64_t>(m) * lda + k];
  };
  if constexpr (sizeof(W) == 2) {
    using Tc = ptt::fa::Tc<__nv_bfloat16>;
    constexpr int LA = kAT ? kBM + 8 : kBK + 8, LB = kBN + 8;
    __shared__ __align__(16) __nv_bfloat16 As[kAT ? kBK * LA : kBM * LA];
    __shared__ __align__(16) __nv_bfloat16 Bs[kBK * LB];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const bool avec = lda % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
    const bool bvec = ldb % 8 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
    const unsigned short* bu = reinterpret_cast<const unsigned short*>(b);
    // a thread stages 4 x 4 values of A and 2 x 8 of B a k-tile: A as
    // (row, 4 k) runs, or (k, 4 rows) for kAT; B as (k, 8 n) runs
    float4 ar[4];
    uint4 br[2];
    auto load = [&](int kt) {
      const int k0 = kt * kBK;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = threadIdx.x + j * NT;
        const int r = kAT ? idx / 16 : idx / 8, c = kAT ? idx % 16 : idx % 8;
        const int m = kAT ? m0 + 4 * c : m0 + r, k = kAT ? k0 + r : k0 + 4 * c;
        const bool full = kAT ? k < K && m + 4 <= M : m < M && k + 4 <= K;
        if (avec && full) {
          ar[j] = __ldg(reinterpret_cast<const float4*>(
              kAT ? a + static_cast<int64_t>(k) * lda + m
                  : a + static_cast<int64_t>(m) * lda + k));
        } else if (kAT) {
          ar[j] = make_float4(a_at(m, k), a_at(m + 1, k), a_at(m + 2, k),
                              a_at(m + 3, k));
        } else {
          ar[j] = make_float4(a_at(m, k), a_at(m, k + 1), a_at(m, k + 2),
                              a_at(m, k + 3));
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int idx = threadIdx.x + j * NT;
        const int k = k0 + idx / 8, n = n0 + 8 * (idx % 8);
        if (bvec && k < K && n + 8 <= N) {
          br[j] = __ldg(reinterpret_cast<const uint4*>(
              b + static_cast<int64_t>(k) * ldb + n));
        } else {
          unsigned h[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            h[e] = k < K && n + e < N
                ? bu[static_cast<int64_t>(k) * ldb + n + e] : 0u;
          br[j] = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                             h[4] | h[5] << 16, h[6] | h[7] << 16);
        }
      }
    };
    auto store = [&]() {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = threadIdx.x + j * NT;
        const int r = kAT ? idx / 16 : idx / 8, c = kAT ? idx % 16 : idx % 8;
        *reinterpret_cast<uint2*>(As + r * LA + 4 * c) = pack4_bf16(ar[j]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int idx = threadIdx.x + j * NT;
        *reinterpret_cast<uint4*>(Bs + (idx / 8) * LB + 8 * (idx % 8)) =
            br[j];
      }
    };
    float acc[kBN / 8][4] = {};
    if (kt0 < kt1) {
      load(kt0);
      store();
    }
    __syncthreads();
    for (int kt = kt0; kt < kt1; ++kt) {
      if (kt + 1 < kt1) load(kt + 1);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        Tc::A af;
        if constexpr (kAT) {
          const int i = lane >> 3, r = lane & 7;
          ptt::fa::ldsm_x4_t(af.x, As + (kk + (i >> 1) * 8 + r) * LA
                                       + 16 * warp + (i & 1) * 8);
        } else {
          af = Tc::load_a(As + 16 * warp * LA, LA, kk);
        }
#pragma unroll
        for (int nb = 0; nb < kBN; nb += 16) {
          Tc::B b0, b1;
          Tc::load_bt(b0, b1, Bs, LB, kk, nb);
          float d0[4] = {}, d1[4] = {};
          ptt::fa::mma_bf16(d0, af.x, b0.x[0], b0.x[1]);
          ptt::fa::mma_bf16(d1, af.x, b1.x[0], b1.x[1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[nb / 8][e] += d0[e];
            acc[nb / 8 + 1][e] += d1[e];
          }
        }
      }
      __syncthreads();
      if (kt + 1 < kt1) {
        store();
        __syncthreads();
      }
    }
    // accumulator (row g / g + 8, columns 2t, 2t + 1) of each n-block
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nb = 0; nb < kBN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 16 * warp + g + (e >> 1) * 8;
        const int n = n0 + nb * 8 + 2 * t + (e & 1);
        if (m < M && n < N) {
          const int64_t at = static_cast<int64_t>(m) * N + n;
          out[at] = (cin ? cin[at] : 0.f) + acc[nb][e];
        }
      }
  } else {
    __shared__ __align__(16) float As[kBK][kBM];
    __shared__ __align__(16) float Bs[kBK][kBN];
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
    float acc[4][4] = {};
    for (int kt = kt0; kt < kt1; ++kt) {
      const int k0 = kt * kBK;
      for (int i = threadIdx.x; i < kBM * kBK; i += NT) {
        if constexpr (kAT) {
          const int kr = i / kBM, mc = i % kBM;
          As[kr][mc] = a_at(m0 + mc, k0 + kr);
        } else {
          const int mr = i / kBK, kc = i % kBK;
          As[kc][mr] = a_at(m0 + mr, k0 + kc);
        }
        const int kr = i / kBN, nc = i % kBN;
        Bs[kr][nc] = (k0 + kr < K && n0 + nc < N)
                         ? ptt::to_f32(b[static_cast<int64_t>(k0 + kr) * ldb
                                         + n0 + nc])
                         : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(&As[k][4 * tr]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][4 * tc]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + 4 * tr + i, n = n0 + 4 * tc + j;
        if (m < M && n < N) {
          const int64_t at = static_cast<int64_t>(m) * N + n;
          out[at] = (cin ? cin[at] : 0.f) + acc[i][j];
        }
      }
  }
}

// out[i] = sum over z < S of part[z][i], in order of z (float4 at a time;
// n is a multiple of 4).
__global__ void lstm_bwd_sum_splits_kernel(const float4* __restrict__ part,
                                           float4* __restrict__ out,
                                           int64_t n4, int S) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x)
                   + threadIdx.x;
       i < n4; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float4 s = part[i];
    for (int z = 1; z < S; ++z) {
      const float4 v = part[z * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[i] = s;
  }
}

// out = cin + A . B (S == 1, part unused), or, for S > 1, the S partial
// products into part [S][M][N] and their sum into out.
template <typename W, bool kAT>
void launch_gemm(const float* a, int64_t lda, const W* b, int64_t ldb,
                 const float* cin, float* out, float* part, int S, int M,
                 int N, int K, cudaStream_t st) {
  const int nk = (K + gemm_bk<W>() - 1) / gemm_bk<W>();
  const int kps = (nk + S - 1) / S;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, S);
  lstm_bwd_gemm_kernel<W, kAT><<<grid, gemm_threads<W>(), 0, st>>>(
      a, lda, b, ldb, S > 1 ? nullptr : cin, S > 1 ? part : out, M, N, K,
      kps);
  if (S > 1) {
    const int64_t n4 = static_cast<int64_t>(M) * N / 4;
    lstm_bwd_sum_splits_kernel<<<264, 256, 0, st>>>(
        reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(out),
        n4, S);
  }
}

// --- backward: the recurrence ----------------------------------------
//
// dh_prev[b][j] = sum over n < 4H of mm(dgates[b][n]) . w[j][n] needs
// every unit's dgates.  Rather than have every block read all of them
// (an all-gather of B x 4H values a block a step, PERF.md), each block
// multiplies its own 4HB dgates columns by the matching columns of w for
// every j, a [B, 4HB] x [4HB, H] product, and writes the partial sums
// (f32) to an exchange buffer P; after the step's barrier block k adds
// the partials of its units over all blocks, in order of the block that
// wrote them.  Every block reads B x HB values of every block: its own
// lines, which no other block reads.  P is [2][blocks (reader)][blocks
// (writer)][seg] f32, seg = B * HB rounded up to 4, one half a step in
// turn: a block writes one half only after every block has passed the
// barrier that follows its reading of that half.

// Row stride of the bf16 dgates copy (the dw product's operand): 4H in
// whole 16-byte chunks.
__host__ __device__ inline int dg_ld(int H) { return (4 * H + 7) / 8 * 8; }

// Depth of the per-step partial product: the 4HB own columns, padded to
// whole m16n8k16 steps for a bf16 w.
template <typename W, int HB>
__host__ __device__ constexpr int own_k() {
  return sizeof(W) == 2 ? (4 * HB + 15) / 16 * 16 : 4 * HB;
}

// Row stride (elements) of the two operands of the per-step product in
// shared memory: bf16 rows with 16 bytes of padding (ldmatrix rows in
// distinct banks), f32 rows with one word of padding.
template <typename W, int HB>
__host__ __device__ constexpr int own_ld() {
  return sizeof(W) == 2 ? own_k<W, HB>() + 8 : own_k<W, HB>() + 1;
}

__host__ __device__ inline int exchange_seg(int B, int HB) {
  return (B * HB + 3) / 4 * 4;
}

// Shared memory of the recurrence: the block's columns of w for every j
// ([roundup(H, 16)][own_ld] of w's type, row j holding w[j][q*H + j0 + u]
// at q*HB + u), its dgates as the product's operand ([roundup(B, 16)]
// [own_ld], same type), the partial sums of the exchange read
// (max(1024, seg) f32), and dh, dc carried to step t - 1 ([B][HB] each).
template <typename W, int HB>
size_t bwd_smem(int B, int H) {
  const size_t ld = own_ld<W, HB>();
  const size_t rows = (H + 15) / 16 * 16 + (B + 15) / 16 * 16;
  const int seg = exchange_seg(B, HB);
  const size_t red = seg > 1024 ? seg : 1024;
  return (rows * ld * sizeof(W) + 15) / 16 * 16
         + sizeof(float) * (red + 2 * static_cast<size_t>(B) * HB);
}

// The block's partial products: p[dst][src][b * HB + u] = sum over its
// own columns n of mm(dg[b][n]) . w[dst * HB + u][n], for every j = dst *
// HB + u < H, src = this block.
//  - bf16 w: m16n8k16 on the tensor cores, M = the batch rows, N = j (two
//    n-blocks of 8 a load_b, the pairs split over the warps), K = the own
//    columns (16 or 32); each 16-deep product is summed from zero and
//    added with FADD.
//  - f32 w: the CUDA cores, a thread a j (its own-column weights in
//    registers), an FMA chain over the own columns for each b.
template <typename W, int HB>
__device__ __forceinline__ void partial_dh(const W* dg_s, const W* wc_s,
                                           float* p, int src, int blocks,
                                           int B, int H) {
  constexpr int KO = own_k<W, HB>(), LD = own_ld<W, HB>();
  const int seg = exchange_seg(B, HB);
  const int64_t row_ld = static_cast<int64_t>(blocks) * seg;
  if constexpr (sizeof(W) == 2) {
    using Tc = ptt::fa::Tc<__nv_bfloat16>;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    for (int m0 = 0; m0 < B; m0 += 16) {
      Tc::A af[KO / 16];
#pragma unroll
      for (int kk = 0; kk < KO / 16; ++kk)
        af[kk] = Tc::load_a(dg_s + m0 * LD, LD, 16 * kk);
      for (int n0 = 16 * warp; n0 < H; n0 += 16 * kWarps) {
        float c[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < KO / 16; ++kk) {
          Tc::B b0, b1;
          Tc::load_b(b0, b1, wc_s, LD, n0, 16 * kk);
          float d0[4] = {}, d1[4] = {};
          ptt::fa::mma_bf16(d0, af[kk].x, b0.x[0], b0.x[1]);
          ptt::fa::mma_bf16(d1, af[kk].x, b1.x[0], b1.x[1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            c[0][e] += d0[e];
            c[1][e] += d1[e];
          }
        }
        // (row g / g + 8, columns 2t, 2t + 1) of the two n-blocks
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int b = m0 + g + 8 * r, j = n0 + 8 * h + 2 * t;
            if (b >= B || j >= H) continue;
            const float x = c[h][2 * r], y = c[h][2 * r + 1];
            float* q = p + (j / HB) * row_ld
                       + static_cast<int64_t>(src) * seg + b * HB + j % HB;
            if constexpr (HB >= 2) {
              if (j + 1 < H) {
                *reinterpret_cast<float2*>(q) = make_float2(x, y);
                continue;
              }
            } else if (j + 1 < H) {
              p[(j + 1) * row_ld + static_cast<int64_t>(src) * seg + b] = y;
            }
            *q = x;
          }
      }
    }
  } else {
    for (int j = threadIdx.x; j < H; j += kThreads) {
      float wv[KO];
#pragma unroll
      for (int n = 0; n < KO; ++n) wv[n] = wc_s[j * LD + n];
      float* q = p + (j / HB) * row_ld + static_cast<int64_t>(src) * seg
                 + j % HB;
      for (int b = 0; b < B; ++b) {
        float s = 0.f;
#pragma unroll
        for (int n = 0; n < KO; ++n) s = fmaf(dg_s[b * LD + n], wv[n], s);
        q[b * HB] = s;
      }
    }
  }
}

// dh_s[b][u] += sum over src < blocks of p[k][src][b * HB + u], k = this
// block, in order of src: threads take 4 values (one float4) of a slice of
// the writers each, the slices' sums meet in red and are added in order.
template <int HB>
__device__ __forceinline__ void gather_dh(const float* p, float* red,
                                          float* dh_s, int blocks, int B,
                                          int nu) {
  const int seg = exchange_seg(B, HB), Q = seg / 4;
  const int slices = max(1, kThreads / Q);
  const int per = (blocks + slices - 1) / slices;
  const float4* pk = reinterpret_cast<const float4*>(
      p + static_cast<int64_t>(blockIdx.x) * blocks * seg);
  for (int i = threadIdx.x; i < Q * slices; i += kThreads) {
    const int s = i / Q, q = i - s * Q;
    const int src1 = min(blocks, (s + 1) * per);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int src0 = s * per; src0 < src1; src0 += 16) {
      float4 v[16];
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (src0 + e < src1) v[e] = __ldcg(pk + (src0 + e) * Q + q);
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (src0 + e < src1) {
          acc.x += v[e].x;
          acc.y += v[e].y;
          acc.z += v[e].z;
          acc.w += v[e].w;
        }
    }
    reinterpret_cast<float4*>(red)[s * Q + q] = acc;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
    const int b = idx / nu, u = idx - b * nu;
    float sum = 0.f;
    for (int s = 0; s < slices; ++s) sum += red[s * seg + b * HB + u];
    dh_s[b * HB + u] += sum;
  }
}

// One cooperative launch for all T steps, block k owning units
// [k * HB, k * HB + HB).  dxs holds the gates' pre-activations on entry
// (the product before the launch) and dgates on exit.  Per step: the
// cell's gradients of the block's units (dgates written over their gates,
// as a bf16 copy for a bf16 w, and into shared memory as the operand of
// the partial product), the partial product into the exchange, one
// grid-wide barrier, then the exchange read for dh_prev of its units.
template <typename W, int HB>
__global__ void __launch_bounds__(kThreads)
    lstm_bwd_kernel(const W* __restrict__ w, const float* __restrict__ cprev,
                    const float* __restrict__ mask,
                    const float* __restrict__ dhs,
                    const float* __restrict__ dcs, float* dxs,
                    __nv_bfloat16* dg16, float* exch, float* dh0,
                    float* dc0, int T, int B, int H) {
  constexpr bool kBf16 = sizeof(W) == 2;
  constexpr int LD = own_ld<W, HB>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int j0 = blockIdx.x * HB, nu = min(HB, H - j0);
  const int blocks = gridDim.x, H4 = 4 * H, ldd = dg_ld(H);
  const int64_t BH = static_cast<int64_t>(B) * H;
  const int64_t half = static_cast<int64_t>(blocks) * blocks
                       * exchange_seg(B, HB);
  const int hp = (H + 15) / 16 * 16, bp = (B + 15) / 16 * 16;
  W* wc_s = reinterpret_cast<W*>(smem_raw);
  W* dg_s = wc_s + hp * LD;
  float* red = reinterpret_cast<float*>(
      smem_raw + ((hp + bp) * LD * sizeof(W) + 15) / 16 * 16);
  float* dh_s = red + max(1024, exchange_seg(B, HB));
  float* dc_s = dh_s + B * HB;
  // the block's columns of w, for every j (0 past H, past its units and
  // past 4HB), and a zeroed operand (its padding stays 0)
  for (int idx = threadIdx.x; idx < hp * LD; idx += kThreads) {
    const int j = idx / LD, n = idx - j * LD, q = n / HB, u = n - q * HB;
    wc_s[idx] = j < H && n < 4 * HB && u < nu
        ? w[static_cast<int64_t>(j) * H4 + q * H + j0 + u]
        : static_cast<W>(0.f);
  }
  for (int idx = threadIdx.x; idx < bp * LD; idx += kThreads)
    dg_s[idx] = static_cast<W>(0.f);
  for (int idx = threadIdx.x; idx < B * HB; idx += kThreads)
    dh_s[idx] = dc_s[idx] = 0.f;
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  for (int t = T - 1; t >= 0; --t) {
    const float* cp = cprev + t * BH;
    float* dxt = dxs + t * B * static_cast<int64_t>(H4);
    float* p = exch + (t & 1) * half;
    // the cell's gradients
    for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
      const int b = idx / nu, u = idx - b * nu, j = j0 + u;
      const int64_t at = static_cast<int64_t>(b) * H + j;
      float* gx = dxt + static_cast<int64_t>(b) * H4 + j;
      const float i = sigmoid(gx[0]), f = sigmoid(gx[H]);
      const float gg = tanhf(gx[2 * H]), o = sigmoid(gx[3 * H]);
      const float c_prev = cp[at];
      const float tc = tanhf(f * c_prev + i * gg);
      const float m = mask[t * B + b];
      const float dh = dhs[t * BH + at] + dh_s[b * HB + u];
      const float dc_out = dcs[t * BH + at] + dc_s[b * HB + u];
      const float dh_new = m * dh;
      const float dc_new = m * dc_out + dh_new * o * (1.f - tc * tc);
      const float d[4] = {dc_new * gg * i * (1.f - i),
                          dc_new * c_prev * f * (1.f - f),
                          dc_new * i * (1.f - gg * gg),
                          dh_new * tc * o * (1.f - o)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        gx[q * H] = d[q];
        dg_s[b * LD + q * HB + u] = static_cast<W>(d[q]);
        if constexpr (kBf16)
          dg16[(t * B + static_cast<int64_t>(b)) * ldd + q * H + j] =
              __float2bfloat16(d[q]);
      }
      dc_s[b * HB + u] = f * dc_new + (1.f - m) * dc_out;
      dh_s[b * HB + u] = (1.f - m) * dh;
    }
    __syncthreads();
    // this block's share of every unit's dh_prev
    partial_dh<W, HB>(dg_s, wc_s, p, blockIdx.x, blocks, B, H);
    grid.sync();  // step barrier
    // dh_prev of the units += the shares of every block
    gather_dh<HB>(p, red, dh_s, blocks, B, nu);
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
    const int b = idx / nu, u = idx - b * nu;
    dh0[b * H + j0 + u] = dh_s[b * HB + u];
    dc0[b * H + j0 + u] = dc_s[b * HB + u];
  }
}

// The backward: check that the recurrence can be placed, then enqueue the
// gates' product (into dxs), the recurrence, and dw's product (in S runs
// of k, summed through part, when S > 1).
template <typename W, int HB>
int launch_bwd(const float* xs, const W* w, const float* hprev,
               const float* cprev, const float* mask, const float* dhs,
               const float* dcs, float* dxs, __nv_bfloat16* dg16,
               float* exch, float* dw, float* part, int S, float* dh0,
               float* dc0, int T, int B, int H, cudaStream_t st) {
  auto kern = lstm_bwd_kernel<W, HB>;
  const int blocks = (H + HB - 1) / HB;
  const size_t smem = bwd_smem<W, HB>(B, H);
  cudaError_t e = place(kern, blocks, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int TB = T * B, H4 = 4 * H;
  launch_gemm<W, false>(hprev, H, w, H4, xs, dxs, nullptr, 1, TB, H4, H, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&w, &cprev, &mask, &dhs, &dcs, &dxs, &dg16, &exch, &dh0,
                  &dc0, &T, &B, &H};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                  blocks, kThreads, args, smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  // dgates as the product's operand: the bf16 copy, or dxs itself
  const bool bf = sizeof(W) == 2;
  const W* dg = bf ? reinterpret_cast<const W*>(dg16)
                   : reinterpret_cast<const W*>(dxs);
  launch_gemm<W, true>(hprev, H, dg, bf ? dg_ld(H) : H4, nullptr, dw, part,
                       S, H, H4, TB, st);
  return static_cast<int>(cudaGetLastError());
}

template <typename W, int HB>
int launch_fwd(const float* xs, const W* w, const float* h0, const float* c0,
               const float* mask, float* hs, float* cs, int T, int B, int H,
               cudaStream_t st) {
  auto kern = lstm_fwd_kernel<W, HB>;
  const int blocks = (H + HB - 1) / HB;
  const size_t smem = sizeof(float) * (4 * HB * static_cast<size_t>(H)
                                       + static_cast<size_t>(B) * 4 * HB);
  cudaError_t e = place(kern, blocks, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&xs, &w, &h0, &c0, &mask, &hs, &cs, &T, &B, &H};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kern), blocks, kThreads, args, smem, st));
}

template <typename W>
int fwd(const void* xs, const void* w, const void* h0, const void* c0,
        const void* mask, void* hs, void* cs, int T, int B, int H,
        cudaStream_t st) {
  const float* x = static_cast<const float*>(xs);
  const W* wt = static_cast<const W*>(w);
  const float* h = static_cast<const float*>(h0);
  const float* c = static_cast<const float*>(c0);
  const float* m = static_cast<const float*>(mask);
  float* ho = static_cast<float*>(hs);
  float* co = static_cast<float*>(cs);
  switch (units_per_block(H)) {
    case 1: return launch_fwd<W, 1>(x, wt, h, c, m, ho, co, T, B, H, st);
    case 2: return launch_fwd<W, 2>(x, wt, h, c, m, ho, co, T, B, H, st);
    case 4: return launch_fwd<W, 4>(x, wt, h, c, m, ho, co, T, B, H, st);
    default: return launch_fwd<W, 8>(x, wt, h, c, m, ho, co, T, B, H, st);
  }
}

template <typename W>
int bwd(const void* xs, const void* w, const void* hprev, const void* cprev,
        const void* mask, const void* dhs, const void* dcs, void* dxs,
        void* dg16, void* exch, void* dw, void* part, int S, void* dh0,
        void* dc0, int T, int B, int H, cudaStream_t st) {
  const float* x = static_cast<const float*>(xs);
  const W* wt = static_cast<const W*>(w);
  const float* hp = static_cast<const float*>(hprev);
  const float* cp = static_cast<const float*>(cprev);
  const float* m = static_cast<const float*>(mask);
  const float* gh = static_cast<const float*>(dhs);
  const float* gc = static_cast<const float*>(dcs);
  float* dx = static_cast<float*>(dxs);
  __nv_bfloat16* dg = static_cast<__nv_bfloat16*>(dg16);
  float* ex = static_cast<float*>(exch);
  float* dwo = static_cast<float*>(dw);
  float* pt = static_cast<float*>(part);
  float* dh = static_cast<float*>(dh0);
  float* dc = static_cast<float*>(dc0);
  switch (units_per_block(H)) {
    case 1: return launch_bwd<W, 1>(x, wt, hp, cp, m, gh, gc, dx, dg, ex, dwo,
                                    pt, S, dh, dc, T, B, H, st);
    case 2: return launch_bwd<W, 2>(x, wt, hp, cp, m, gh, gc, dx, dg, ex, dwo,
                                    pt, S, dh, dc, T, B, H, st);
    case 4: return launch_bwd<W, 4>(x, wt, hp, cp, m, gh, gc, dx, dg, ex, dwo,
                                    pt, S, dh, dc, T, B, H, st);
    default: return launch_bwd<W, 8>(x, wt, hp, cp, m, gh, gc, dx, dg, ex, dwo,
                                     pt, S, dh, dc, T, B, H, st);
  }
}

}  // namespace

// hs, cs [T, B, H] f32 are written for every t.  T, B, H >= 1.
extern "C" int ptt_lstm_fwd(const void* xs, const void* w, const void* h0,
                            const void* c0, const void* mask, void* hs,
                            void* cs, int T, int B, int H, int w_bf16,
                            void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w_bf16 ? fwd<__nv_bfloat16>(xs, w, h0, c0, mask, hs, cs, T, B, H, st)
                : fwd<float>(xs, w, h0, c0, mask, hs, cs, T, B, H, st);
}

// hprev/cprev [T, B, H]: the state each step starts from ([h0, hs[:-1]]).
// dxs [T, B, 4H], dw [H, 4H], dh0/dc0 [B, H], all f32, fully written.
// Scratch: dg16 [T, B, dg_ld(H)] bf16 for a bf16 w (unused for f32);
// exch, the exchange of dh_prev's partial sums, 2 * blocks^2 * seg f32
// (blocks = ceil(H / units a block), seg = B * units rounded up to 4);
// for dw_splits S > 1 part [S, H, 4H] f32.  Three kernels, one call
// (four with S > 1): gates' product, recurrence, dw's product (and the
// sum of its S runs).
extern "C" int ptt_lstm_bwd(const void* xs, const void* w, const void* hprev,
                            const void* cprev, const void* mask,
                            const void* dhs, const void* dcs, void* dxs,
                            void* dg16, void* exch, void* dw, void* part,
                            void* dh0, void* dc0, int T, int B, int H,
                            int dw_splits, int w_bf16, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || dw_splits <= 0)
    return cudaErrorInvalidValue;
  if ((w_bf16 && dg16 == nullptr) || exch == nullptr
      || (dw_splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  for (const void* p : {exch, dw, part})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w_bf16 ? bwd<__nv_bfloat16>(xs, w, hprev, cprev, mask, dhs, dcs,
                                     dxs, dg16, exch, dw, part, dw_splits,
                                     dh0, dc0, T, B, H, st)
                : bwd<float>(xs, w, hprev, cprev, mask, dhs, dcs, dxs, dg16,
                             exch, dw, part, dw_splits, dh0, dc0, T, B, H,
                             st);
}

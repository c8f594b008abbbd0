// Shared pieces of the recurrent kernels (lstm.cu, gru.cu).
//
// The persistent path: each kernel is ONE cooperative launch for all T
// steps.  Block k owns the hidden units [k*HB, k*HB + HB): it keeps the
// columns of w that feed those units (every gate of them) in shared
// memory for the whole launch, computes their gates for the whole batch,
// and writes their states; a grid-wide barrier separates the steps,
// because step t + 1 reads every unit of step t.  The barrier deadlocks
// unless every block is resident, so `place` checks the occupancy and the
// launch is cooperative (the runtime refuses a grid that does not fit,
// rather than hanging).
//
// The stepwise path, for the shapes whose persistent grid the card cannot
// hold (`persistent_fits`: one block an SM, its columns of w in shared
// memory; at H 2048 an f32 w alone is 64 MB, the card's shared memory
// about 30 MB): one launch a step (the GRU two), the kernel boundary in
// place of grid.sync().  Block k still owns units [k*HB, k*HB + HB) and
// runs the same step product and cell arithmetic, but w's columns come
// from global memory (the L2) every step instead of staying in shared
// memory: the forward's warps stream their k-ranges of w and of the
// operand through double-buffered chunks (`streamed_product`), the
// backward's exchange shares stream w's rows in chunks of kStepJ
// (`streamed_share`), and what the persistent kernels keep in shared
// memory from step to step (h, c, the carried dh and dc) goes through
// global memory.  The k-steps, their order and every FADD are the
// persistent kernels', and so are the exchanges and their order of
// summation, so the two paths give the same bits.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "flash_mma.cuh"

namespace ptt {
namespace rnn {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// --- the forward kernels' staged step product (lstm.cu, gru.cu) --------
//
// Each step every block multiplies a [B, H] operand that every block wrote
// (h_prev) by its own columns of w.  The operand is staged into shared
// memory in w's type (16-byte cp.async copies, all in flight at once) and
// the product's depth is split over the 8 warps on the tensor cores.
// Geometry (host and device agree on it): KP = H rounded up to 16 (the
// depth, zero-padded), LDK = KP + 16 bytes, the row stride of the staged
// operand and of the w columns (a warp's ldmatrix rows, or its f32
// fragment reads, in distinct banks).
template <typename W>
struct StepGeom {
  __host__ __device__ static int kp(int H) { return (H + 15) / 16 * 16; }
  __host__ __device__ static int ldk(int H) {
    return kp(H) + 16 / static_cast<int>(sizeof(W));
  }
};

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// The k-range [k0, k1) of this warp in a step product of depth kp (a
// multiple of 16): the warps split it into runs of whole 16-deep steps,
// in order.
__device__ __forceinline__ void warp_k_range(int kp, int& k0, int& k1) {
  const int warp = threadIdx.x >> 5;
  const int steps = kp / 16, per = (steps + kWarps - 1) / kWarps;
  k0 = 16 * min(steps, warp * per);
  k1 = 16 * min(steps, warp * per + per);
}

// Stage columns [k0, k1) (a multiple of 8 wide, k0 a multiple of 8) of
// rows b0 .. b0 + MC - 1 of a [B, H] operand (h_prev, or the GRU's
// r * h_prev) into dst [MC][ld], column k at dst column k - k0 (0 past B,
// past H and at or past kend), by the calling warp: from h16 (bf16, row
// stride kp) with 16-byte cp.async copies; for an f32 w from hf (f32, row
// stride H) the same way when H is a multiple of 4; otherwise (the first
// step of a bf16 w, which rounds h0 here, or an f32 H not a multiple of
// 4) element by element through L2.  The caller commits, waits and syncs
// the warp.
template <typename W>
__device__ __forceinline__ void stage_cols(W* dst, int ld, const float* hf,
                                           const __nv_bfloat16* h16, int b0,
                                           int MC, int B, int H, int kp,
                                           int k0, int k1, int kend) {
  using ptt::fa::cp_async16;
  const int lane = threadIdx.x & 31;
  if constexpr (sizeof(W) == 2) {
    if (h16 != nullptr) {
      const int chunks = (k1 - k0) / 8;
      for (int i = lane; i < MC * chunks; i += 32) {
        const int r = i / chunks, c = (i - r * chunks) * 8;
        const bool in = b0 + r < B && k0 + c < kend;
        cp_async16(dst + r * ld + c,
                   h16 + (in ? static_cast<int64_t>(b0 + r) * kp + k0 + c
                             : 0),
                   in ? 16 : 0);
      }
      return;
    }
  } else {
    if (H % 4 == 0 && reinterpret_cast<uintptr_t>(hf) % 16 == 0) {
      const int chunks = (k1 - k0) / 4;
      for (int i = lane; i < MC * chunks; i += 32) {
        const int r = i / chunks, c = (i - r * chunks) * 4;
        const bool in = b0 + r < B && k0 + c < H && k0 + c < kend;
        cp_async16(dst + r * ld + c,
                   hf + (in ? static_cast<int64_t>(b0 + r) * H + k0 + c : 0),
                   in ? 16 : 0);
      }
      return;
    }
  }
  const int cols = k1 - k0;
  for (int i = lane; i < MC * cols; i += 32) {
    const int r = i / cols, c = i - r * cols, k = k0 + c;
    dst[r * ld + c] =
        b0 + r < B && k < H && k < kend
            ? static_cast<W>(__ldcg(hf + static_cast<int64_t>(b0 + r) * H + k))
            : static_cast<W>(0.f);
  }
}

// Stage rows b0 .. b0 + MC - 1 of the operand into h_s [MC][ldk], each
// warp the columns of its own k-range (`warp_k_range`), so that a warp's
// product waits only for its own copies (`stage_cols`).
template <typename W>
__device__ __forceinline__ void stage_h(W* h_s, int ldk, const float* hf,
                                        const __nv_bfloat16* h16, int b0,
                                        int MC, int B, int H, int kp) {
  int k0, k1;
  warp_k_range(kp, k0, k1);
  stage_cols<W>(h_s + k0, ldk, hf, h16, b0, MC, B, H, kp, k0, k1, k1);
}

// The step product's partial tiles: red[warp][r][n] = sum over the warp's
// k-range (`warp_k_range`) of mm(h_s[r][k]) . w_s[n][k], for r < MC (a
// multiple of 16), n < NP (a multiple of 16), in rows of NP + 4 floats.
// On the tensor cores, each k-step's product summed from zero and added
// to the tile with FADD:
//  - bf16 w: m16n8k16;
//  - f32 w: 3xTF32 m16n8k8 (flash_mma.cuh: lo.hi + hi.lo + hi.hi).
template <typename W, int NP>
__device__ __forceinline__ void step_product(const W* h_s, const W* w_s,
                                             int ldk, float* red, int MC,
                                             int kp) {
  static_assert(NP % 16 == 0, "whole pairs of 8-column n-blocks");
  constexpr int NR = NP + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int k0, k1;
  warp_k_range(kp, k0, k1);
  float* out = red + warp * MC * NR;
  const int g = lane >> 2, t = lane & 3;
  for (int m0 = 0; m0 < MC; m0 += 16) {
    float acc[NP / 8][4] = {};
    if constexpr (sizeof(W) == 2) {
      using Tc = ptt::fa::Tc<__nv_bfloat16>;
      for (int k = k0; k < k1; k += 16) {
        const Tc::A af = Tc::load_a(h_s + m0 * ldk, ldk, k);
#pragma unroll
        for (int n0 = 0; n0 < NP; n0 += 16) {
          Tc::B b0, b1;
          Tc::load_b(b0, b1, w_s, ldk, n0, k);
          float d0[4] = {}, d1[4] = {};
          ptt::fa::mma_bf16(d0, af.x, b0.x[0], b0.x[1]);
          ptt::fa::mma_bf16(d1, af.x, b1.x[0], b1.x[1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[n0 / 8][e] += d0[e];
            acc[n0 / 8 + 1][e] += d1[e];
          }
        }
      }
    } else {
      // m16n8k8 fragments read element by element: A (row g / g + 8,
      // k t / t + 4) of h_s, B (k t / t + 4, column g) of w_s
      for (int k = k0; k < k1; k += 8) {
        const float* ap = h_s + (m0 + g) * ldk + k + t;
        uint32_t ahi[4], alo[4];
        ptt::fa::split_tf32(ap[0], ahi[0], alo[0]);
        ptt::fa::split_tf32(ap[8 * ldk], ahi[1], alo[1]);
        ptt::fa::split_tf32(ap[4], ahi[2], alo[2]);
        ptt::fa::split_tf32(ap[8 * ldk + 4], ahi[3], alo[3]);
#pragma unroll
        for (int nb = 0; nb < NP / 8; ++nb) {
          const float* bp = w_s + (nb * 8 + g) * ldk + k + t;
          uint32_t bhi[2], blo[2];
          ptt::fa::split_tf32(bp[0], bhi[0], blo[0]);
          ptt::fa::split_tf32(bp[4], bhi[1], blo[1]);
          float d[4];
          ptt::fa::mma_tf32_zero(d, alo, bhi);
          ptt::fa::mma_tf32(d, ahi, blo);
          ptt::fa::mma_tf32(d, ahi, bhi);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nb][e] += d[e];
        }
      }
    }
    // (row g / g + 8, columns 2t, 2t + 1) of each n-block
#pragma unroll
    for (int nb = 0; nb < NP / 8; ++nb)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(out + (m0 + g + 8 * r) * NR + nb * 8
                                   + 2 * t) =
            make_float2(acc[nb][2 * r], acc[nb][2 * r + 1]);
  }
}

// --- the stepwise forward's streamed step product -----------------------
//
// A block of a stepwise forward launch takes kStepRows rows of the batch
// (gridDim.y covers B) and the NP gate columns of its units.  Each warp
// multiplies its k-range (`warp_k_range`, as `step_product`) in chunks of
// KC rows of k: the chunk's [KC][NP] block of w (its units' columns,
// straight from w's [H, G*H] rows, so rows of k: the product reads B with
// ldmatrix.trans for bf16) and the operand's [kStepRows][KC] columns, both
// cp.async'd into the warp's own two buffers, chunk c + 1 in flight while
// chunk c is multiplied.  Each k-step is summed from zero and added to the
// accumulator with FADD in the order `step_product` adds them, and the
// fragments hold the same values, so a warp's partial tile is bit for bit
// the persistent product's.

constexpr int kStepRows = 32;  // batch rows of a stepwise forward block
constexpr int kStepJ = 256;    // rows of w a stepwise exchange share stages

template <typename W, int NP>
struct Streamed {
  static constexpr int KC = sizeof(W) == 2 ? 32 : 16;  // k rows a chunk
  static constexpr int LDN = NP + 8;  // w chunk [KC][LDN]: rows of 16 B
  // (bf16) or 32 B (f32) of padding, fragment reads in distinct banks
  static constexpr int LDH = KC + 16 / static_cast<int>(sizeof(W));
  static constexpr int kBuf = KC * LDN + kStepRows * LDH;  // one buffer
  // the warps' buffers, which the partial tiles [kWarps][kStepRows][NP + 4]
  // f32 reuse after the product
  __host__ __device__ static constexpr size_t bytes() {
    const size_t stage = static_cast<size_t>(kWarps) * 2 * kBuf * sizeof(W);
    const size_t red = sizeof(float) * kWarps * kStepRows * (NP + 4);
    return align16(stage > red ? stage : red);
  }
};

// Whether a stepwise kernel may copy w's block columns in 16-byte chunks:
// HB units of each gate are whole chunks, and every gate's first column
// (base + q * H + j0) and w itself are 16-byte aligned.
template <typename W>
__host__ inline int w_vec(const void* w, int HB, int H, int base) {
  constexpr int vec = 16 / static_cast<int>(sizeof(W));
  return HB % vec == 0 && H % vec == 0 && base % vec == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

// Stage rows [kc, kc + KC) of k of the block's gate columns of w into
// wc [KC][LDN] (column q * HB + u, q < Q, u < nu, holds
// w[k][base + q * H + j0 + u]; 0 elsewhere and past kend), by the calling
// warp: 16-byte cp.async copies where `vec`, else element by element.
template <typename W, int HB, int NP>
__device__ __forceinline__ void stage_w_cols(W* wc, const W* w, int64_t ldw,
                                             int base, int Q, int H, int j0,
                                             int nu, int kc, int kend,
                                             int vec) {
  using S = Streamed<W, NP>;
  const int lane = threadIdx.x & 31;
  constexpr int kVec = 16 / static_cast<int>(sizeof(W));
  if (vec) {
    constexpr int chunks = NP / kVec;
    for (int i = lane; i < S::KC * chunks; i += 32) {
      const int r = i / chunks, n = (i - r * chunks) * kVec;
      const int q = n / HB, u = n - q * HB;
      const bool in = q < Q && u < nu && kc + r < kend;
      ptt::fa::cp_async16(
          wc + r * S::LDN + n,
          w + (in ? (kc + r) * ldw + base + q * H + j0 + u : 0), in ? 16 : 0);
    }
    return;
  }
  for (int i = lane; i < S::KC * NP; i += 32) {
    const int r = i / NP, n = i - r * NP, q = n / HB, u = n - q * HB;
    wc[r * S::LDN + n] = q < Q && u < nu && kc + r < kend
                             ? w[(kc + r) * ldw + base + q * H + j0 + u]
                             : static_cast<W>(0.f);
  }
}

// The calling warp's share of a stepwise step product: acc[m][n] (rows
// mt * 16 + m of the block's kStepRows, NP columns) = the sum over the
// warp's k-range of mm(operand[b0 + row][k]) . w[k][column], as
// `step_product` sums it (the operand from hf / h16 as `stage_cols`, w's
// columns as `stage_w_cols`).  `stage` is the block's buffers; the caller
// has committed its other copies, and waits for all of them after.
template <typename W, int HB, int NP>
__device__ __forceinline__ void streamed_product(
    float (&acc)[2][NP / 8][4], W* stage, const W* w, int64_t ldw, int base,
    int Q, int j0, int nu, int vec, const float* hf,
    const __nv_bfloat16* h16, int b0, int B, int H, int kp) {
  using S = Streamed<W, NP>;
  constexpr int KC = S::KC, LDN = S::LDN, LDH = S::LDH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int k0, k1;
  warp_k_range(kp, k0, k1);
  W* buf = stage + warp * 2 * S::kBuf;
  const int n = (k1 - k0 + KC - 1) / KC;
  auto load = [&](int c) {
    W* wc = buf + (c & 1) * S::kBuf;
    const int kc = k0 + c * KC;
    stage_w_cols<W, HB, NP>(wc, w, ldw, base, Q, H, j0, nu, kc, min(k1, H),
                            vec);
    stage_cols<W>(wc + KC * LDN, LDH, hf, h16, b0, kStepRows, B, H, kp, kc,
                  kc + KC, k1);
    ptt::fa::cp_async_commit();
  };
  if (n > 0) load(0);
  for (int c = 0; c < n; ++c) {
    if (c + 1 < n) {
      load(c + 1);
      ptt::fa::cp_async_wait<1>();
    } else {
      ptt::fa::cp_async_wait<0>();
    }
    __syncwarp();  // the chunk is staged for every lane
    const W* wc = buf + (c & 1) * S::kBuf;
    const W* hc = wc + KC * LDN;
    const int kn = min(KC, k1 - (k0 + c * KC));
    if constexpr (sizeof(W) == 2) {
      using Tc = ptt::fa::Tc<__nv_bfloat16>;
      for (int k = 0; k < kn; k += 16) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const Tc::A af = Tc::load_a(hc + mt * 16 * LDH, LDH, k);
#pragma unroll
          for (int n0 = 0; n0 < NP; n0 += 16) {
            Tc::B b0, b1;
            Tc::load_bt(b0, b1, wc, LDN, k, n0);
            float d0[4] = {}, d1[4] = {};
            ptt::fa::mma_bf16(d0, af.x, b0.x[0], b0.x[1]);
            ptt::fa::mma_bf16(d1, af.x, b1.x[0], b1.x[1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[mt][n0 / 8][e] += d0[e];
              acc[mt][n0 / 8 + 1][e] += d1[e];
            }
          }
        }
      }
    } else {
      for (int k = 0; k < kn; k += 8) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* ap = hc + (mt * 16 + g) * LDH + k + t;
          uint32_t ahi[4], alo[4];
          ptt::fa::split_tf32(ap[0], ahi[0], alo[0]);
          ptt::fa::split_tf32(ap[8 * LDH], ahi[1], alo[1]);
          ptt::fa::split_tf32(ap[4], ahi[2], alo[2]);
          ptt::fa::split_tf32(ap[8 * LDH + 4], ahi[3], alo[3]);
#pragma unroll
          for (int nb = 0; nb < NP / 8; ++nb) {
            const float* bp = wc + (k + t) * LDN + nb * 8 + g;
            uint32_t bhi[2], blo[2];
            ptt::fa::split_tf32(bp[0], bhi[0], blo[0]);
            ptt::fa::split_tf32(bp[4 * LDN], bhi[1], blo[1]);
            float d[4];
            ptt::fa::mma_tf32_zero(d, alo, bhi);
            ptt::fa::mma_tf32(d, ahi, blo);
            ptt::fa::mma_tf32(d, ahi, bhi);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nb][e] += d[e];
          }
        }
      }
    }
    __syncwarp();  // every lane is done with the buffer before its refill
  }
}

// The warp's partial tile of a stepwise product into red[warp][row][n]
// (rows of NP + 4 floats, kStepRows of them), as `step_product` writes
// its own.
template <int NP>
__device__ __forceinline__ void store_partials(
    const float (&acc)[2][NP / 8][4], float* red) {
  constexpr int NR = NP + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* out = red + warp * kStepRows * NR;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nb = 0; nb < NP / 8; ++nb)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(out + (mt * 16 + g + 8 * r) * NR + nb * 8
                                   + 2 * t) =
            make_float2(acc[mt][nb][2 * r], acc[mt][nb][2 * r + 1]);
}

// --- the exchange of partial sums (the backward kernels) ---------------
//
// A product over the hidden units, out[b][j] = sum over n < G*H of
// mm(d[b][n]) . w[j][n] (dh_prev from the dgates), needs every unit's d.
// Rather than have every block read all of them (an all-gather of B x GH
// values a block a step, PERF.md), each block multiplies its own columns
// of d by the matching columns of w for every j and writes the partial
// sums (f32) to an exchange buffer P; after a grid-wide barrier block k
// adds the partials of its units over all blocks, in order of the block
// that wrote them.  Every block reads B x HB values of every block: its
// own lines, which no other block reads.  P is [blocks (reader)][blocks
// (writer)][seg] f32, seg = B * HB rounded up to 4.

__host__ __device__ inline int exchange_seg(int B, int HB) {
  return (B * HB + 3) / 4 * 4;
}

// The block's share: p[dst][src][b * HB + u] = sum over n < KO of
// mm(a_s[b][n]) . w_s[j][n] for every j = dst * HB + u in [jb, je) (all
// j < H by `exchange_share`; a stepwise kernel's chunks of rows of w by
// `streamed_share`), src = this block.  a_s ([roundup(B, 16)] rows of
// stride lda) and w_s (rows jb .. of stride ldw, to a whole 16 past je)
// are in shared memory, in w's type, their padding 0; jb is a multiple of
// 16 and of HB.
//  - bf16 w: m16n8k16 on the tensor cores, M = the batch rows, N = j (two
//    n-blocks of 8 a load_b, the pairs split over the warps), K = the own
//    columns (KO, a multiple of 16); each 16-deep product is summed from
//    zero and added with FADD.
//  - f32 w: the CUDA cores, a warp a destination block (its HB rows of
//    w_s read as broadcasts), a lane a batch row: the lane's HB sums, each
//    an FMA chain over the own columns, are contiguous in the segment, so
//    the warp's stores fill whole sectors.
template <typename W, int HB, int KO>
__device__ __forceinline__ void exchange_share_rows(const W* a_s, int lda,
                                                    const W* w_s, int ldw,
                                                    float* p, int src,
                                                    int blocks, int B, int H,
                                                    int jb, int je) {
  const int seg = exchange_seg(B, HB);
  const int64_t row_ld = static_cast<int64_t>(blocks) * seg;
  if constexpr (sizeof(W) == 2) {
    static_assert(KO % 16 == 0, "bf16 shares run whole m16n8k16 steps");
    using Tc = ptt::fa::Tc<__nv_bfloat16>;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    for (int m0 = 0; m0 < B; m0 += 16) {
      Tc::A af[KO / 16];
#pragma unroll
      for (int kk = 0; kk < KO / 16; ++kk)
        af[kk] = Tc::load_a(a_s + m0 * lda, lda, 16 * kk);
      for (int n0 = jb + 16 * warp; n0 < je; n0 += 16 * kWarps) {
        float c[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < KO / 16; ++kk) {
          Tc::B b0, b1;
          Tc::load_b(b0, b1, w_s, ldw, n0 - jb, 16 * kk);
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
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int dst = jb / HB + warp; dst * HB < je; dst += kWarps) {
      const W* wr = w_s + (dst * HB - jb) * ldw;
      float* q = p + dst * row_ld + static_cast<int64_t>(src) * seg;
      for (int b = lane; b < B; b += 32) {
        float av[KO];
#pragma unroll
        for (int n = 0; n < KO; ++n) av[n] = a_s[b * lda + n];
        float sv[HB];
#pragma unroll
        for (int u = 0; u < HB; ++u) {
          float s = 0.f;
#pragma unroll
          for (int n = 0; n < KO; ++n) s = fmaf(av[n], wr[u * ldw + n], s);
          sv[u] = s;
        }
        float* qb = q + b * HB;
        if constexpr (HB % 4 == 0) {
#pragma unroll
          for (int u = 0; u < HB; u += 4)
            *reinterpret_cast<float4*>(qb + u) =
                make_float4(sv[u], sv[u + 1], sv[u + 2], sv[u + 3]);
        } else if constexpr (HB == 2) {
          *reinterpret_cast<float2*>(qb) = make_float2(sv[0], sv[1]);
        } else {
          qb[0] = sv[0];
        }
      }
    }
  }
}

template <typename W, int HB, int KO>
__device__ __forceinline__ void exchange_share(const W* a_s, int lda,
                                               const W* w_s, int ldw,
                                               float* p, int src, int blocks,
                                               int B, int H) {
  exchange_share_rows<W, HB, KO>(a_s, lda, w_s, ldw, p, src, blocks, B, H, 0,
                                 H);
}

// Stage rows [jr, jr + kStepJ) of the block's columns of w into ws
// [kStepJ][ld], columns [off, off + ko): column off + q * HB + u (q < Q,
// u < nu) holds w[j][base + q * H + j0 + u], the rest of the range 0, and
// so does a row past H (the layout of the persistent backward's w_s).
// 16-byte cp.async copies for a bf16 w of 8 units where `vec`; 4-byte
// ones for an f32 w; else plain loads and stores.  The caller commits.
template <typename W, int HB>
__device__ __forceinline__ void stage_w_rows(W* ws, int ld, int off, int ko,
                                             const W* w, int64_t ldw,
                                             int base, int Q, int H, int j0,
                                             int nu, int jr, int vec) {
  if constexpr (sizeof(W) == 2 && HB == 8) {
    if (vec) {
      const int chunks = ko / 8;
      for (int i = threadIdx.x; i < kStepJ * chunks; i += kThreads) {
        const int r = i / chunks, q = i - r * chunks;
        const bool in = jr + r < H && q < Q;
        ptt::fa::cp_async16(
            ws + r * ld + off + 8 * q,
            w + (in ? (jr + r) * ldw + base + q * H + j0 : 0), in ? 16 : 0);
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < kStepJ * ko; i += kThreads) {
    const int r = i / ko, n = i - r * ko, q = n / HB, u = n - q * HB;
    const bool in = jr + r < H && q < Q && u < nu;
    const int64_t at = in ? (jr + r) * ldw + base + q * H + j0 + u : 0;
    if constexpr (sizeof(W) == 4) {
      ptt::fa::cp_async4(ws + r * ld + off + n, w + at, in ? 4 : 0);
    } else {
      ws[r * ld + off + n] = in ? w[at] : static_cast<W>(0.f);
    }
  }
}

// A stepwise backward's exchange share: `exchange_share_rows` over all
// j < H, with w's rows streamed through wbuf (two buffers of kStepJ rows
// of ld, filled as `stage_w_rows` does at columns [off, off + KO)), the
// next chunk in flight while one is multiplied.  No copy of the caller's
// may be in flight.
template <typename W, int HB, int KO>
__device__ __forceinline__ void streamed_share(
    const W* a_s, int lda, W* wbuf, int ld, int off, const W* w, int64_t ldw,
    int base, int Q, int j0, int nu, int vec, float* p, int src, int blocks,
    int B, int H) {
  const int n = (H + kStepJ - 1) / kStepJ;
  stage_w_rows<W, HB>(wbuf, ld, off, KO, w, ldw, base, Q, H, j0, nu, 0, vec);
  ptt::fa::cp_async_commit();
  for (int c = 0; c < n; ++c) {
    if (c + 1 < n) {
      stage_w_rows<W, HB>(wbuf + ((c + 1) & 1) * kStepJ * ld, ld, off, KO, w,
                          ldw, base, Q, H, j0, nu, (c + 1) * kStepJ, vec);
      ptt::fa::cp_async_commit();
      ptt::fa::cp_async_wait<1>();
    } else {
      ptt::fa::cp_async_wait<0>();
    }
    __syncthreads();  // chunk c landed for every thread
    exchange_share_rows<W, HB, KO>(
        a_s, lda, wbuf + (c & 1) * kStepJ * ld + off, ld, p, src, blocks, B,
        H, c * kStepJ, min(H, (c + 1) * kStepJ));
    __syncthreads();  // every thread is done with its buffer
  }
}

// dst[b][u] (+)= sum over src < blocks of p[k][src][b * HB + u], k = this
// block, in order of src (kAdd: added to dst, else written over it):
// threads take 4 values (one float4) of a slice of the writers each, the
// slices' sums meet in red (max(1024, seg) f32) and are added in order.
template <int HB, bool kAdd>
__device__ __forceinline__ void exchange_gather(const float* p, float* red,
                                                float* dst, int blocks,
                                                int B, int nu) {
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
    if constexpr (kAdd) {
      dst[b * HB + u] += sum;
    } else {
      dst[b * HB + u] = sum;
    }
  }
}

// Set the dynamic shared memory a kernel needs and check that `blocks` of
// it fit on the card at once.
template <typename Kern>
cudaError_t place(Kern kern, int blocks, size_t smem) {
  int dev = 0, sms = 0, optin = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop || smem > static_cast<size_t>(optin))
    return cudaErrorCooperativeLaunchTooLarge;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, smem);
  if (e != cudaSuccess) return e;
  return per_sm * sms >= blocks ? cudaSuccess
                                : cudaErrorCooperativeLaunchTooLarge;
}

// Whether a persistent grid of `blocks` blocks of `smem` bytes takes the
// persistent path: no more blocks than the card has SMs (one block an SM),
// its shared memory within what a block may ask for, and the occupancy
// query agreeing that one block fits an SM.  Otherwise the shape runs
// stepwise.  kernels.recurrent_path is the same rule in Python (without
// the occupancy query, which a block of 256 threads under 227 KB always
// passes).
template <typename Kern>
bool persistent_fits(Kern kern, int blocks, size_t smem) {
  int dev = 0, sms = 0, optin = 0, coop = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&optin,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) !=
          cudaSuccess)
    return false;
  if (!coop || blocks > sms || smem > static_cast<size_t>(optin))
    return false;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    smem) != cudaSuccess)
    return false;
  return per_sm >= 1;
}

// The most dynamic shared memory a block of this card may ask for.
inline int smem_optin() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return optin;
}

// Opt a stepwise kernel in to `smem` bytes of dynamic shared memory.
template <typename Kern>
cudaError_t allow_step_smem(Kern kern, size_t smem) {
  if (smem > static_cast<size_t>(smem_optin())) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Rows of the batch a forward kernel stages at once, given its shared
// memory at MC rows (smem(MC)): the whole batch when it fits, else the
// most rows (a multiple of 16) that fit.
template <typename Smem>
int staged_rows(int B, Smem smem) {
  const size_t optin = static_cast<size_t>(smem_optin());
  int MC = (B + 15) / 16 * 16;
  while (MC > 16 && smem(MC) > optin) MC -= 16;
  return MC;
}

// Units per block: the fewest (1, 2, 4 or 8) that need no more blocks
// than the card has SMs (one block each), else 8.
inline int units_per_block(int H) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int hb = 1;
  while (hb < 8 && (H + hb - 1) / hb > sms) hb *= 2;
  return hb;
}

// f32 elements of a backward kernel's exchange buffer at H, B on this
// card: two [blocks (reader)][blocks (writer)][seg] buffers (the LSTM's
// two halves taken in turn, the GRU's exchanges 1 and 2).
inline int64_t exchange_floats(int H, int B) {
  const int hb = units_per_block(H);
  const int64_t blocks = (H + hb - 1) / hb;
  return 2 * blocks * blocks * exchange_seg(B, hb);
}

}  // namespace rnn
}  // namespace ptt

// *floats: the size of the exchange buffer that ptt_lstm_bwd or
// ptt_gru_bwd takes at H, B on this card.  Each library that includes this
// header (lstm.cu, gru.cu) exports it, so a wrapper asks its own kernel's.
extern "C" int ptt_rnn_exchange_floats(int H, int B, long long* floats) {
  if (H <= 0 || B <= 0 || floats == nullptr) return cudaErrorInvalidValue;
  *floats = ptt::rnn::exchange_floats(H, B);
  return cudaSuccess;
}

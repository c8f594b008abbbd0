// Shared pieces of the persistent recurrent kernels (lstm.cu, gru.cu).
//
// Each kernel is ONE cooperative launch for all T steps.  Block k owns the
// hidden units [k*HB, k*HB + HB): it keeps the columns of w that feed
// those units (every gate of them) in shared memory for the whole
// launch, computes their gates for the whole batch, and writes their
// states; a grid-wide barrier separates the steps, because step t + 1
// reads every unit of step t.  The barrier deadlocks unless every block
// is resident, so `place` checks the occupancy and the launch is
// cooperative (the runtime refuses a grid that does not fit, rather than
// hanging).
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

// An operand of a product with w: rounded to bf16 when w is bf16 (the
// Pallas kernels' `.astype(w.dtype)` before a dot that accumulates in f32).
template <typename W>
__device__ __forceinline__ float mm(float x);
template <>
__device__ __forceinline__ float mm<float>(float x) { return x; }
template <>
__device__ __forceinline__ float mm<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Rows a warp takes at once in `warp_rows_dot`: R x N accumulators, about
// 64 registers, so a column of w read from shared memory serves R rows.
__host__ __device__ constexpr int rows_per_warp(int n) {
  return n >= 64 ? 1 : (64 / n > 8 ? 8 : 64 / n);
}

// acc[r][n] = sum over k < K of mm(src[(b0 + r) * ld + k]) * w_s[n * K + k]
// for the rows b0 .. b0 + R - 1 that are below B (others give 0).  The
// lanes stride over k, and every lane ends with the full sums.  src lies
// in device memory; kL2 reads it through L2 only (`__ldcg`), for data that
// another block wrote during this launch (L1 is not coherent across SMs).
// w_s is an [N][K] slice in shared memory: neighbouring lanes read
// neighbouring words.
template <typename W, int R, int N, bool kL2>
__device__ __forceinline__ void warp_rows_dot(const float* src, int64_t ld,
                                              int b0, int B, int K,
                                              const float* w_s,
                                              float (&acc)[R][N]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int n = 0; n < N; ++n) acc[r][n] = 0.f;
  for (int k = lane; k < K; k += 32) {
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float x = 0.f;
      if (b0 + r < B) {
        const float* p = src + (b0 + r) * ld + k;
        x = kL2 ? __ldcg(p) : *p;
      }
      v[r] = mm<W>(x);
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float wv = w_s[n * K + k];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r][n] = fmaf(v[r], wv, acc[r][n]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int n = 0; n < N; ++n) acc[r][n] = warp_sum(acc[r][n]);
}

// Whether this lane stores accumulator (r, n) of `warp_rows_dot`: the
// stores spread over the lanes, one lane per value.
__device__ __forceinline__ bool lane_owns(int r, int n, int N) {
  return ((r * N + n) & 31) == (threadIdx.x & 31);
}

// Load the columns of w [H, gates * H] that feed units j0 .. j0 + HB - 1
// into w_s [gates * HB][H] as f32: row q * HB + u of w_s is column
// q * H + j0 + u of w (0 for a unit past H).
template <typename W, int HB>
__device__ void load_columns(const W* w, int H, int gates, int j0, int nu,
                             float* w_s) {
  const int64_t ld = static_cast<int64_t>(gates) * H;
  for (int idx = threadIdx.x; idx < gates * HB * H; idx += kThreads) {
    const int n = idx / H, k = idx - n * H, q = n / HB, u = n - q * HB;
    w_s[idx] = u < nu ? to_f32(w[k * ld + q * H + j0 + u]) : 0.f;
  }
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
// mm(a_s[b][n]) . w_s[j][n] for every j = dst * HB + u < H, src = this
// block.  a_s ([roundup(B, 16)] rows of stride lda) and w_s
// ([roundup(H, 16)] rows of stride ldw) are in shared memory, in w's type,
// their padding 0.
//  - bf16 w: m16n8k16 on the tensor cores, M = the batch rows, N = j (two
//    n-blocks of 8 a load_b, the pairs split over the warps), K = the own
//    columns (KO, a multiple of 16); each 16-deep product is summed from
//    zero and added with FADD.
//  - f32 w: the CUDA cores, a warp a destination block (its HB rows of
//    w_s read as broadcasts), a lane a batch row: the lane's HB sums, each
//    an FMA chain over the own columns, are contiguous in the segment, so
//    the warp's stores fill whole sectors.
template <typename W, int HB, int KO>
__device__ __forceinline__ void exchange_share(const W* a_s, int lda,
                                               const W* w_s, int ldw,
                                               float* p, int src, int blocks,
                                               int B, int H) {
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
      for (int n0 = 16 * warp; n0 < H; n0 += 16 * kWarps) {
        float c[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < KO / 16; ++kk) {
          Tc::B b0, b1;
          Tc::load_b(b0, b1, w_s, ldw, n0, 16 * kk);
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
    for (int dst = warp; dst * HB < H; dst += kWarps) {
      const W* wr = w_s + dst * HB * ldw;
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

// The most dynamic shared memory a block of this card may ask for.
inline int smem_optin() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return optin;
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

// The tiled products that the recurrent backward kernels (lstm.cu, gru.cu)
// run before and after their serial recurrence: the gates'
// pre-activations from the saved h_prev, and dw from h_prev and the
// dgates of every step.
//
// out[m][n] (row stride ldo) = (cin ? cin[m][n] : 0)
//                              + sum over k < K of mm(A[m][k]) . B[k][n]
// with A f32 at a[m * lda + k] (kAT: at a[k * lda + m], A stored
// transposed), B of w's type at b[k * ldb + n], and cin with out's row
// stride (so a product can read and write a band of gate columns of a
// wider [T*B, G*H] array).  A block computes a 64 x 64 tile of out, 32
// (bf16) or 16 (f32) k at a time through shared memory; with gridDim.z =
// S > 1 block z takes the z-th of S runs of k-tiles and writes its
// partial tile to out + z * M * ldo, which `rnn_sum_splits_kernel` adds in
// order of z (a product with few output tiles and a long k, as dw, fills
// the card that way).
//  - bf16 w: mma.sync m16n8k16 on the tensor cores, A rounded to bf16 as
//    it is staged (mm()); 4 warps, 16 rows each.  The next k-tile is
//    loaded into registers (16-byte loads where the strides and pointers
//    allow) while the current one is multiplied.  Each 16-deep product
//    is summed from zero and added to the f32 accumulator with FADD
//    (the tensor cores do not round their sums to nearest, PERF.md).
//  - f32 w: the tensor cores in 3xTF32 (flash_mma.cuh: every operand split
//    into a tf32 high part and the rest, three m16n8k8 products), about
//    f32's accuracy; each 8-deep step's three products are summed from
//    zero and added to the f32 accumulator with FADD.
#pragma once

#include "flash_mma.cuh"
#include "recurrent.cuh"

namespace ptt {
namespace rnn {

constexpr int kBM = 64, kBN = 64;

// 4 warps, 16 rows of the 64-row tile each
constexpr int kGemmThreads = 128;

template <typename W>
__host__ __device__ constexpr int gemm_bk() {
  return sizeof(W) == 2 ? 32 : 16;
}

__device__ __forceinline__ uint2 pack4_bf16(float4 v) {
  return make_uint2(ptt::fa::pack_bf16(v.x, v.y),
                    ptt::fa::pack_bf16(v.z, v.w));
}

template <typename W, bool kAT>
__global__ void __launch_bounds__(kGemmThreads)
    rnn_gemm_kernel(const float* __restrict__ a, int64_t lda,
                    const W* __restrict__ b, int64_t ldb,
                    const float* __restrict__ cin, float* __restrict__ out,
                    int64_t ldo, int M, int N, int K, int kps) {
  constexpr int NT = kGemmThreads, kBK = gemm_bk<W>();
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * kps, kt1 = min(nk, kt0 + kps);
  if (gridDim.z > 1) out += static_cast<int64_t>(blockIdx.z) * M * ldo;
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
          const int64_t at = static_cast<int64_t>(m) * ldo + n;
          out[at] = (cin ? cin[at] : 0.f) + acc[nb][e];
        }
      }
  } else {
    // 3xTF32: each operand split into a tf32 high part and the rest
    // (flash_mma.cuh), three m16n8k8 products a k-step summed from zero
    // and added to the accumulator with FADD.  As is [m][k], Bs [k][n];
    // the fragments are read element by element (rows of As and Bs padded
    // so that a warp's reads fall in distinct banks).
    constexpr int LA = kBK + 4, LB = kBN + 8;
    __shared__ __align__(16) float As[kBM * LA];
    __shared__ __align__(16) float Bs[kBK * LB];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const bool avec = lda % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
    const bool bvec = ldb % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
    // a thread stages 2 x 4 values of A and 2 x 4 of B a k-tile: A as
    // (row, 4 k) runs, or (k, 4 rows) for kAT; B as (k, 4 n) runs
    float4 ar[2], br[2];
    auto load = [&](int kt) {
      const int k0 = kt * kBK;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int idx = threadIdx.x + j * NT;
        const int r = kAT ? idx / 16 : idx / 4, c = kAT ? idx % 16 : idx % 4;
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
        const int k = k0 + idx / 16, n = n0 + 4 * (idx % 16);
        if (bvec && k < K && n + 4 <= N) {
          br[j] = __ldg(reinterpret_cast<const float4*>(
              b + static_cast<int64_t>(k) * ldb + n));
        } else {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = k < K && n + e < N
                ? ptt::to_f32(b[static_cast<int64_t>(k) * ldb + n + e]) : 0.f;
          br[j] = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    };
    auto store = [&]() {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int idx = threadIdx.x + j * NT;
        if constexpr (kAT) {
          const int r = idx / 16, c = idx % 16;
          As[(4 * c) * LA + r] = ar[j].x;
          As[(4 * c + 1) * LA + r] = ar[j].y;
          As[(4 * c + 2) * LA + r] = ar[j].z;
          As[(4 * c + 3) * LA + r] = ar[j].w;
        } else {
          *reinterpret_cast<float4*>(As + (idx / 4) * LA + 4 * (idx % 4)) =
              ar[j];
        }
        *reinterpret_cast<float4*>(Bs + (idx / 16) * LB + 4 * (idx % 16)) =
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
      for (int kk = 0; kk < kBK; kk += 8) {
        const float* ap = As + 16 * warp * LA + kk;
        uint32_t ahi[4], alo[4];
        ptt::fa::split_tf32(ap[g * LA + t], ahi[0], alo[0]);
        ptt::fa::split_tf32(ap[(g + 8) * LA + t], ahi[1], alo[1]);
        ptt::fa::split_tf32(ap[g * LA + t + 4], ahi[2], alo[2]);
        ptt::fa::split_tf32(ap[(g + 8) * LA + t + 4], ahi[3], alo[3]);
#pragma unroll
        for (int nb = 0; nb < kBN / 8; ++nb) {
          const float* bp = Bs + kk * LB + nb * 8 + g;
          uint32_t bhi[2], blo[2];
          ptt::fa::split_tf32(bp[t * LB], bhi[0], blo[0]);
          ptt::fa::split_tf32(bp[(t + 4) * LB], bhi[1], blo[1]);
          float d[4];
          ptt::fa::mma_tf32_zero(d, alo, bhi);
          ptt::fa::mma_tf32(d, ahi, blo);
          ptt::fa::mma_tf32(d, ahi, bhi);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nb][e] += d[e];
        }
      }
      __syncthreads();
      if (kt + 1 < kt1) {
        store();
        __syncthreads();
      }
    }
#pragma unroll
    for (int nb = 0; nb < kBN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 16 * warp + g + (e >> 1) * 8;
        const int n = n0 + nb * 8 + 2 * t + (e & 1);
        if (m < M && n < N) {
          const int64_t at = static_cast<int64_t>(m) * ldo + n;
          out[at] = (cin ? cin[at] : 0.f) + acc[nb][e];
        }
      }
  }
}

// out[i] = sum over z < S of part[z * n + i], in order of z, for i < n
// (float4 at a time when n is a multiple of 4, else one at a time).
__global__ void rnn_sum_splits_kernel(const float* __restrict__ part,
                                      float* __restrict__ out, int64_t n,
                                      int S) {
  const int64_t n4 = n % 4 == 0 ? n / 4 : 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const float4* p4 = reinterpret_cast<const float4*>(part);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x)
                   + threadIdx.x;
       i < n4; i += stride) {
    float4 s = p4[i];
    for (int z = 1; z < S; ++z) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(part + z * n)
                             + i);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    reinterpret_cast<float4*>(out)[i] = s;
  }
  for (int64_t i = 4 * n4 + blockIdx.x * static_cast<int64_t>(blockDim.x)
                   + threadIdx.x;
       i < n; i += stride) {
    float s = part[i];
    for (int z = 1; z < S; ++z) s += part[z * n + i];
    out[i] = s;
  }
}

// out = cin + A . B; for S > 1, the S partial products of k-runs into
// out + z * M * ldo instead (cin unused), which `launch_sum_splits` adds.
template <typename W, bool kAT>
void launch_gemm(const float* a, int64_t lda, const W* b, int64_t ldb,
                 const float* cin, float* out, int64_t ldo, int S, int M,
                 int N, int K, cudaStream_t st) {
  const int nk = (K + gemm_bk<W>() - 1) / gemm_bk<W>();
  const int kps = (nk + S - 1) / S;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, S);
  rnn_gemm_kernel<W, kAT><<<grid, kGemmThreads, 0, st>>>(
      a, lda, b, ldb, S > 1 ? nullptr : cin, out, ldo, M, N, K, kps);
}

// out[i] = sum over z < S of part[z][i], i < n (part and out 16-byte
// aligned).
inline void launch_sum_splits(const float* part, float* out, int64_t n,
                              int S, cudaStream_t st) {
  rnn_sum_splits_kernel<<<264, 256, 0, st>>>(part, out, n, S);
}

}  // namespace rnn
}  // namespace ptt

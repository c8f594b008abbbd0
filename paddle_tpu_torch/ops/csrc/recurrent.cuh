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

// Load rows j0 .. j0 + HB - 1 of w, columns [c0, c0 + len), into
// w_s [HB][len] as f32 (0 for a unit past H).
template <typename W, int HB>
__device__ void load_rows(const W* w, int64_t ld, int c0, int len, int j0,
                          int nu, float* w_s) {
  for (int idx = threadIdx.x; idx < HB * len; idx += kThreads) {
    const int u = idx / len, c = idx - u * len;
    w_s[idx] = u < nu ? to_f32(w[(j0 + u) * ld + c0 + c]) : 0.f;
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

}  // namespace rnn
}  // namespace ptt

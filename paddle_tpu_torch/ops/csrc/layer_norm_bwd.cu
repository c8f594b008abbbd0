// Row LayerNorm backward over x [R, F] and dy [R, F] (x's dtype), with
// the forward's f32 mean and inv = rsqrt(var + eps) per row and the f32
// scale [F] -> dx [R, F] (x's dtype), dscale and dbias [F] (f32, summed
// over all rows).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py _ln_bwd_kernel (reached
// through _ln_pallas_bwd / fused_layer_norm's VJP).
//
// Bound on the H100: bytes.  The kernel must read x and dy once and write
// dx once (plus the per-row statistics and 3 x F f32 of scale, dscale and
// dbias); it does ~12 flops per element, far below the card's ~20 flops
// per byte.
//
// Design.  dx takes the closed form
//   dx = inv * (dxn - mean(dxn) - xn * mean(dxn * xn)),  dxn = dy * scale,
// one block per run of rows, each row in two passes that re-read it from
// L1/L2 (a row is a few KB).  dscale and dbias are sums over ALL rows: the
// TPU kernel carried them in scratch across its sequential row grid, but
// Hopper blocks run in no order.  So each block sums its own rows into a
// [2, F] f32 accumulator in shared memory (each thread owns fixed
// columns: no races), writes it as one row of a [2, n_blocks, F] partial
// buffer, and a second kernel sums the partials over blocks in a fixed
// order.  No atomics: the result is the same from run to run.  Any F up
// to what the accumulator's shared memory allows works; the ragged edge
// is just the loop bound.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kReduceCols = 32;   // columns per block of the reduce kernel
constexpr int kReduceWarps = 8;   // warps splitting the blocks to sum

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_rows_kernel(const T* __restrict__ x,
                       const float* __restrict__ scale,
                       const float* __restrict__ mean,
                       const float* __restrict__ inv,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ part, int R, int F,
                       int rows_per_block) {
  extern __shared__ float acc[];  // [2][F]: this block's dscale, dbias
  __shared__ float scratch[32];
  float* dsc = acc;
  float* dbi = acc + F;
  const int tid = threadIdx.x;
  for (int i = tid; i < F; i += kThreads) {
    dsc[i] = 0.f;
    dbi[i] = 0.f;
  }
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  const float inv_f = 1.f / F;
  for (int r = r0; r < r1; ++r) {
    const int64_t base = static_cast<int64_t>(r) * F;
    const float mu = mean[r], iv = inv[r];
    float c1 = 0.f, c2 = 0.f;
    for (int i = tid; i < F; i += kThreads) {
      const float xn = (ptt::to_f32(x[base + i]) - mu) * iv;
      const float g = ptt::to_f32(dy[base + i]);
      dsc[i] += g * xn;
      dbi[i] += g;
      const float dxn = g * scale[i];
      c1 += dxn * xn;
      c2 += dxn;
    }
    c1 = ptt::block_sum(c1, scratch) * inv_f;
    c2 = ptt::block_sum(c2, scratch) * inv_f;
    for (int i = tid; i < F; i += kThreads) {
      const float xn = (ptt::to_f32(x[base + i]) - mu) * iv;
      const float dxn = ptt::to_f32(dy[base + i]) * scale[i];
      dx[base + i] = ptt::from_f32<T>(iv * (dxn - c2 - xn * c1));
    }
  }
  const int64_t nb = gridDim.x;
  for (int i = tid; i < F; i += kThreads) {
    part[static_cast<int64_t>(blockIdx.x) * F + i] = dsc[i];
    part[(nb + blockIdx.x) * F + i] = dbi[i];
  }
}

// dscale[i] = sum over blocks b of part[0][b][i], dbias likewise from
// part[1]; warp w sums blocks w, w + 8, ... for 32 columns, then the
// eight warp sums are added in order.
__global__ void __launch_bounds__(32 * kReduceWarps)
    ln_bwd_reduce_kernel(const float* __restrict__ part,
                         float* __restrict__ dscale,
                         float* __restrict__ dbias, int nb, int F) {
  __shared__ float sums[2][kReduceWarps][kReduceCols];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * kReduceCols + lane;
  float a = 0.f, b = 0.f;
  if (i < F) {
    for (int blk = w; blk < nb; blk += kReduceWarps) {
      a += part[static_cast<int64_t>(blk) * F + i];
      b += part[static_cast<int64_t>(nb + blk) * F + i];
    }
  }
  sums[0][w][lane] = a;
  sums[1][w][lane] = b;
  __syncthreads();
  if (w == 0 && i < F) {
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < kReduceWarps; ++j) {
      sa += sums[0][j][lane];
      sb += sums[1][j][lane];
    }
    dscale[i] = sa;
    dbias[i] = sb;
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* mean,
           const void* inv, const void* dy, void* dx, void* part,
           void* dscale, void* dbias, int rows, int features,
           int rows_per_block, cudaStream_t st) {
  const int nb = (rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = 2 * static_cast<size_t>(features) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ln_bwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ln_bwd_rows_kernel<T><<<nb, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(mean), static_cast<const float*>(inv),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(part), rows, features, rows_per_block);
  ln_bwd_reduce_kernel<<<(features + kReduceCols - 1) / kReduceCols,
                         32 * kReduceWarps, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dscale),
      static_cast<float*>(dbias), nb, features);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part is f32 scratch of 2 x ceil(rows / rows_per_block) x features
// values, allocated by the caller.
extern "C" int ptt_layer_norm_bwd(const void* x, const void* scale,
                                  const void* mean, const void* inv,
                                  const void* dy, void* dx, void* part,
                                  void* dscale, void* dbias, int rows,
                                  int features, int rows_per_block,
                                  int is_bf16, void* stream) {
  if (rows <= 0 || features <= 0 || rows_per_block <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, scale, mean, inv, dy, dx, part, dscale,
                                 dbias, rows, features, rows_per_block, st);
  return launch<float>(x, scale, mean, inv, dy, dx, part, dscale, dbias,
                       rows, features, rows_per_block, st);
}

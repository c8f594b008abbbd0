// Row LayerNorm forward over x [R, F] -> y [R, F] (x's dtype), mean and
// var [R] (f32).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py _ln_fwd_kernel (reached
// through _ln_pallas_fwd / fused_layer_norm).
//
// Bound on the H100: bytes.  The kernel must read x once and write y
// once (plus 2 x F f32 of scale/bias and 8 bytes of stats per row); it
// does ~8 flops per element, far below the card's ~20 flops per byte.
// At the serving shape (16 rows of 768) the bound is tens of
// nanoseconds, so there the launch and the wrapper's host cost are the
// time.
//
// Design: statistics are two-pass in f32 (mean, then the mean of squared
// deviations), exact where the TPU kernel needed Welford's chunk merge
// to bound its VMEM temporaries, and every element is rounded in the
// plain version's order (square_dev, normalize).  Two paths, picked by
// the wrapper
// (kernels.layer_norm_geometry):
// - ln_fwd_warp_kernel, for rows of at most 1024 features in whole
//   16-byte chunks (F768: three chunks a lane in bf16, six in f32): one
//   warp owns a row and holds it in registers, so x is read from memory
//   exactly once with 16-byte loads, both statistics are warp shuffles
//   over the registers, and there is no __syncthreads.  A block holds
//   kRowWarps rows.
// - ln_fwd_block_kernel, for any other F: one block a row.  The first
//   pass copies the row into shared memory (when it fits in 48 KB) and
//   the other two read it from there, so x is read from memory once; a
//   longer row is re-read through L2.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kRowWarps = 4;       // rows of a warp-per-row block
constexpr int kWarpRowMax = 1024;  // longest row (features) of that path

// The plain version's roundings, kept apart (no contraction into fma):
// (x - mean)^2 rounded before it is summed, and
// y = ((x - mean) * inv) * scale + bias with inv = 1 / sqrt(var + eps),
// so a row whose mean and var round as the plain version's gives the
// same y bit for bit.
__device__ __forceinline__ float square_dev(float x, float mean) {
  const float d = __fsub_rn(x, mean);
  return __fmul_rn(d, d);
}

__device__ __forceinline__ float normalize(float x, float mean, float inv,
                                           float scale, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), inv), scale),
                   bias);
}

// pairwise sum of n (a power of two) values
template <int n>
__device__ __forceinline__ float pair_sum(const float* v) {
  if constexpr (n == 1) {
    return v[0];
  } else {
    return pair_sum<n / 2>(v) + pair_sum<n / 2>(v + n / 2);
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
    ln_fwd_warp_kernel(const T* __restrict__ x,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ y,
                       float* __restrict__ mean_out,
                       float* __restrict__ var_out, int R, int F,
                       float eps) {
  constexpr int vec = ptt::Chunk<T>::n;
  constexpr int kMax = kWarpRowMax / vec / 32;  // chunks a lane holds
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowWarps +
                      (threadIdx.x >> 5);
  if (row >= R) return;  // the whole warp
  const int n_chunks = F / vec;
  const T* xr = x + row * F;

  float v[kMax][vec];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMax; ++i) {
    const int c = lane + 32 * i;
    if (c < n_chunks) {
      ptt::Chunk<T>::unpack(ptt::Chunk<T>::raw(xr + c * vec), v[i]);
      s += pair_sum<vec>(v[i]);
    }
  }
  const float mean = ptt::warp_sum(s) / F;
  float s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kMax; ++i) {
    if (lane + 32 * i < n_chunks) {
      float sq[vec];
#pragma unroll
      for (int e = 0; e < vec; ++e) sq[e] = square_dev(v[i][e], mean);
      s2 += pair_sum<vec>(sq);
    }
  }
  const float var = ptt::warp_sum(s2) / F;
  const float inv = 1.f / sqrtf(var + eps);

  T* yr = y + row * F;
#pragma unroll
  for (int i = 0; i < kMax; ++i) {
    const int c = lane + 32 * i;
    if (c < n_chunks) {
      float sc[vec], bi[vec], out[vec];
#pragma unroll
      for (int k = 0; k < vec; k += 4) {
        ptt::Chunk<float>::unpack(ptt::Chunk<float>::raw(scale + c * vec + k),
                                  sc + k);
        ptt::Chunk<float>::unpack(ptt::Chunk<float>::raw(bias + c * vec + k),
                                  bi + k);
      }
#pragma unroll
      for (int e = 0; e < vec; ++e)
        out[e] = normalize(v[i][e], mean, inv, sc[e], bi[e]);
      *reinterpret_cast<uint4*>(yr + c * vec) = ptt::Chunk<T>::pack(out);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    var_out[row] = var;
  }
}

template <typename T>
__global__ void ln_fwd_block_kernel(const T* __restrict__ x,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ bias,
                                    T* __restrict__ y,
                                    float* __restrict__ mean_out,
                                    float* __restrict__ var_out, int F,
                                    float eps, int cache_row) {
  extern __shared__ unsigned char row_cache[];
  __shared__ float scratch[32];
  T* cached = reinterpret_cast<T*>(row_cache);
  const int64_t row = blockIdx.x;
  const T* xr = x + row * F;
  T* yr = y + row * F;

  float s = 0.f;
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    const T xi = xr[i];
    if (cache_row) cached[i] = xi;
    s += ptt::to_f32(xi);
  }
  // block_sum's barriers also publish the cached row
  const float mean = ptt::block_sum(s, scratch) / F;
  const T* src = cache_row ? cached : xr;

  float s2 = 0.f;
  for (int i = threadIdx.x; i < F; i += blockDim.x)
    s2 += square_dev(ptt::to_f32(src[i]), mean);
  const float var = ptt::block_sum(s2, scratch) / F;
  const float inv = 1.f / sqrtf(var + eps);

  for (int i = threadIdx.x; i < F; i += blockDim.x)
    yr[i] = ptt::from_f32<T>(
        normalize(ptt::to_f32(src[i]), mean, inv, scale[i], bias[i]));
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    var_out[row] = var;
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* y,
           void* mean_out, void* var_out, int R, int F, float eps,
           int block_threads, int cache_bytes, cudaStream_t st) {
  const T* xx = static_cast<const T*>(x);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  T* yy = static_cast<T*>(y);
  float* mean = static_cast<float*>(mean_out);
  float* var = static_cast<float*>(var_out);
  if (block_threads == 0) {  // warp per row
    if (F % ptt::Chunk<T>::n != 0 || F > kWarpRowMax)
      return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (R + kRowWarps - 1) / kRowWarps;
    ln_fwd_warp_kernel<T><<<blocks, kRowWarps * 32, 0, st>>>(
        xx, sc, bi, yy, mean, var, R, F, eps);
  } else {
    ln_fwd_block_kernel<T><<<R, block_threads, cache_bytes, st>>>(
        xx, sc, bi, yy, mean, var, F, eps, cache_bytes > 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// block_threads 0 takes the warp-per-row kernel, otherwise the
// block-per-row kernel with that many threads and cache_bytes of shared
// memory for the row (0: no cache).
extern "C" int ptt_layer_norm_fwd(const void* x, const void* scale,
                                  const void* bias, void* y, void* mean,
                                  void* var, int rows, int features,
                                  float eps, int block_threads,
                                  int cache_bytes, int is_bf16,
                                  void* stream) {
  if (rows <= 0 || features <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, scale, bias, y, mean, var, rows,
                                 features, eps, block_threads, cache_bytes,
                                 st);
  return launch<float>(x, scale, bias, y, mean, var, rows, features, eps,
                       block_threads, cache_bytes, st);
}

// Row LayerNorm forward over x [R, F] -> y [R, F] (x's dtype), mean and
// var [R] (f32).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py _ln_fwd_kernel (reached
// through _ln_pallas_fwd / fused_layer_norm).
//
// Bound on the H100: bytes.  The kernel must read x once and write y
// once (plus 2 x F f32 of scale/bias and 8 bytes of stats per row); it
// does ~8 flops per element, far below the card's ~20 flops per byte.
//
// Design: one block per row.  Statistics are two-pass in f32 (mean, then
// the mean of squared deviations), which is exact where the TPU kernel
// needed Welford's chunk merge to bound its VMEM temporaries.  The three
// passes re-read the row through the read-only cache: a row is a few KB,
// so after the first pass it is served from L1/L2 and device memory sees
// one read of x.  Any F works; the ragged edge is just the loop bound.
#include <cstdint>

#include "common.cuh"

namespace {

template <typename T>
__global__ void ln_fwd_kernel(const T* __restrict__ x,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias,
                              T* __restrict__ y, float* __restrict__ mean_out,
                              float* __restrict__ var_out, int F, float eps) {
  __shared__ float scratch[32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * F;
  T* yr = y + row * F;

  float s = 0.f;
  for (int i = threadIdx.x; i < F; i += blockDim.x) s += ptt::to_f32(xr[i]);
  const float mean = ptt::block_sum(s, scratch) / F;

  float s2 = 0.f;
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    const float d = ptt::to_f32(xr[i]) - mean;
    s2 += d * d;
  }
  const float var = ptt::block_sum(s2, scratch) / F;
  const float inv = rsqrtf(var + eps);

  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    const float xn = (ptt::to_f32(xr[i]) - mean) * inv;
    yr[i] = ptt::from_f32<T>(xn * scale[i] + bias[i]);
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    var_out[row] = var;
  }
}

}  // namespace

extern "C" int ptt_layer_norm_fwd(const void* x, const void* scale,
                                  const void* bias, void* y, void* mean,
                                  void* var, int rows, int features,
                                  float eps, int is_bf16, void* stream) {
  if (rows <= 0 || features <= 0) return cudaSuccess;
  const int threads = features >= 1024 ? 256 : 128;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    ln_fwd_kernel<__nv_bfloat16><<<rows, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(y), static_cast<float*>(mean),
        static_cast<float*>(var), features, eps);
  } else {
    ln_fwd_kernel<float><<<rows, threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<float*>(y),
        static_cast<float*>(mean), static_cast<float*>(var), features, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

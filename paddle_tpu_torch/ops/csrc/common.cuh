// Shared helpers for the port's kernels: element and 16-byte loads and
// stores in f32 or bf16, warp- and block-wide reductions.  Every kernel
// accumulates in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace ptt {

// The compiled head-dim code of the attention kernels that serves head
// dim d: the least of 16, 32, 64 and 128 at or above d, for d a multiple
// of 8 from 8 to 128 (the kernels zero-fill the columns past d); 0 for
// any other d (kernels.head_dim_code is the same map).
__host__ __device__ inline int head_dim_code(int d) {
  if (d < 8 || d > 128 || d % 8 != 0) return 0;
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T (4 f32 or 8 bf16) as one vector load or store: `raw`
// reads them (through the read-only path), `unpack` widens them to f32,
// `pack` rounds n f32 back to T.  Pointers must be 16-byte aligned.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ uint4 raw(const float* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ uint4 raw(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  // a 32-bit word holds elements 2i (low half) and 2i+1 (high half); a
  // bf16 is the high half of the f32 with the same bits
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum/max; `scratch` holds 32 floats in shared memory.  Every
// thread of the block must call it; every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = (lane < n_warps) ? scratch[lane] : 0.f;
  return warp_sum(v);
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = (lane < n_warps) ? scratch[lane] : -CUDART_INF_F;
  return warp_max(v);
}

}  // namespace ptt

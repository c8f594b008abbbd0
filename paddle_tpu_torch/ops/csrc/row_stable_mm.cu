// Row-stable f32 product with bias: out [M, N] = x [M, K] . w [K, N]
// (+ bias [N]), every output element summed in one fixed order, so that a
// row's bits depend on that row of x alone and never on M or on the
// row's place in the batch.
//
// Replaces: no Pallas kernel.  It carries the JAX package's
// numerics="exact" contract (paddle_tpu/serving/decode_engine.py:54-70,
// _GenPredictor: XLA CPU's op-at-a-time dot is row- and batch-stable) to
// the card, where a library GEMM picks its kernel by shape (split-K at
// small M among them) and so does not promise the same bits for a row of
// a [S, d] decode step and the same row of a [B*T, d] recompute.  It
// serves the exact decode path's products: the QKV projection, the two
// FFN products and the LM head.
//
// The order: out[i, j] = (...((0 + x[i,0] w[0,j]) + x[i,1] w[1,j]) + ...
// + x[i,K-1] w[K-1,j]) + bias[j], each product and each sum rounded to
// f32 on its own (__fmul_rn / __fadd_rn, which the compiler never fuses
// into an FFMA).  That is the plain version's arithmetic
// (kernels.row_stable_mm_plain: one elementwise multiply and add per k),
// so kernel and plain version agree bit for bit, on the card and on the
// CPU.  No split-K, no atomics, one tile code at every M.
//
// Bound on the H100: operations for the recompute's shapes (2 M N K
// flops against 4 (M K + K N + M N) bytes; M = 8192, K = 768, N = 3072:
// 39 GFLOP against 0.13 GB), at the CUDA cores' 67 TFLOP/s; without the
// FFMA each multiply-add issues two instructions, so this kernel cannot
// pass half of that.  At decode's M = 4 it is bytes (w read once).
//
// Design: the classic register-tiled SGEMM.  A block of 256 threads owns
// a 128 x 128 output tile and walks K in steps of 8: the next step's x
// and w tiles are read into registers (16-byte loads) while the current
// one, in shared memory (x transposed), feeds the products; two shared
// buffers, one barrier a step.  Each thread keeps an 8 x 8 accumulator
// tile: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns tx*4 + {0..3}
// and 64 + tx*4 + {0..3}, so a warp's shared-memory reads are whole
// conflict-free 16-byte runs.  K and N are multiples of 4 and the
// pointers 16-byte aligned (the wrapper checks); rows past M and columns
// past N are masked, and K's tail is padded with zeros, which add +0 to a
// sum that is never -0.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 8, kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    row_stable_mm_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ bias,
                         float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float As[2][kBK][kBM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int n0 = blockIdx.x * kBN;
  // each thread copies one float4 of the x tile and one of the w tile
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const int b_k = tid >> 5, b_n = (tid & 31) * 4;
  const bool a_ok = m0 + a_row < M;
  const bool b_ok = n0 + b_n < N;
  const float* a_src = x + (m0 + a_row) * K + a_k;
  const float* b_src = w + static_cast<int64_t>(b_k) * N + n0 + b_n;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 a_reg, b_reg;
  auto load = [&](int k0) {
    a_reg = a_ok && k0 + a_k < K
                ? *reinterpret_cast<const float4*>(a_src + k0)
                : zero;
    b_reg = b_ok && k0 + b_k < K
                ? *reinterpret_cast<const float4*>(
                      b_src + static_cast<int64_t>(k0) * N)
                : zero;
  };
  auto store = [&](int buf) {
    As[buf][a_k + 0][a_row] = a_reg.x;
    As[buf][a_k + 1][a_row] = a_reg.y;
    As[buf][a_k + 2][a_row] = a_reg.z;
    As[buf][a_k + 3][a_row] = a_reg.w;
    *reinterpret_cast<float4*>(&Bs[buf][b_k][b_n]) = b_reg;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_steps = (K + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < n_steps) load((step + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i], b[j]));
    }
    // the other buffer was last read in the previous step, which every
    // thread finished before the barrier that ended it
    if (step + 1 < n_steps) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = n0 + half * 64 + tx * 4;
      if (col >= N) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][half * 4 + j];
        if (bias != nullptr) v[j] = __fadd_rn(v[j], bias[col + j]);
      }
      *reinterpret_cast<float4*>(out + row * N + col) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

}  // namespace

extern "C" int ptt_row_stable_mm(const void* x, const void* w,
                                 const void* bias, void* out, int m, int n,
                                 int k, void* stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  row_stable_mm_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

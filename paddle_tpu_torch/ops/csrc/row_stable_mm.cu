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
// CPU.  No split-K, no atomics.  There are two tile codes, one for small
// M and one for the rest (below); they differ only in which thread sums
// which element and when its operands arrive, never in an element's
// arithmetic, which is the same chain of FMUL and FADD over k in order in
// both.  So a row gives the same bits whichever code runs it, and the
// wrapper may choose the code by M.
//
// Bound on the H100.  At the recompute's shapes it is operations (2 M N
// K flops against 4 (M K + K N + M N) bytes; M = 8192, K = 768, N =
// 3072: 39 GFLOP against 0.13 GB) at the CUDA cores' 67 TFLOP/s; without
// the FFMA each multiply-add issues two instructions, so this kernel
// cannot pass half of that.  At decode's M = 4 it is bytes (w read once:
// 98 MB for the head, 0.0295 ms), except where K is long: one element's
// chain of K dependent FADDs takes about 4 cycles a step, 1.75 us at K
// 768 and 7 us at K 3072, and no order-preserving design beats that
// (for FFN2 at M 4 it is above the 2.8 us bytes bound).
//
// Large M: the classic register-tiled SGEMM.  A block of 256 threads
// owns a 128 x 128 output tile and walks K in steps of 8: the next
// step's x and w tiles are read into registers (16-byte loads) while the
// current one, in shared memory (x transposed), feeds the products; two
// shared buffers, one barrier a step.  Each thread keeps an 8 x 8
// accumulator tile: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns
// tx*4 + {0..3} and 64 + tx*4 + {0..3}, so a warp's shared-memory reads
// are whole conflict-free 16-byte runs.
//
// Small M (M <= kSmallMaxRows; the wrapper picks the code): a 128-row
// tile would compute padding rows, and a grid of ceil(N / 128) blocks
// leaves most SMs idle (6 blocks for N 768).  Here parallelism comes
// from N alone: a block owns all of its rows (M padded to MB, a power of
// two from 4 to 64) and a strip of BN columns (8, 16 or 32, the
// wrapper's choice by N), so N 768 gives 96 blocks of 8 and N 32000 1000
// blocks of 32.  At M 4 each thread owns one element (row tid / BN,
// column tid % BN), at larger M a few of one column (kSums), each its
// own FADD chain: per 4 k a thread issues one 16-byte shared read of x a
// row, four reads of w, four FMUL and four FADD a row, 13 instructions
// against one chain's 16 cycles, so one warp on a scheduler runs at the
// chain's pace.  x and w stream through a ring of kStages stages of
// kSmallBK k-rows in shared memory, filled with 16-byte cp.async copies.
// What limits it is how fast one SM streams w (measured with
// row_stable_builds.py): about 20 GB/s when a row of w is read in
// 128-byte runs (32 columns), a third of that in 32-byte runs, whatever
// the ring's depth; so the strip is as wide as the SMs allow, and a long
// K over a narrow N (FFN2: K 3072, N 768) stays at about 5 times its
// chain floor.  Bulk copies through the TMA unit, one a row segment,
// were 3-4 times slower.
//
// Both codes: K and N are multiples of 4 and the pointers 16-byte
// aligned (the wrapper checks); rows past M and columns past N are
// masked, and K's tail is padded with zeros, which add +0 to a sum that
// is never -0.
#include <cstdint>

#include <cuda_runtime.h>

#include "flash_mma.cuh"  // ptt::fa::cp_async16 and its commit and wait

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


// the small-M code: k-rows a stage, stages in the ring, the largest M it
// takes, the most threads a block, and the padded row stride of a
// stage's x tile (its 16 extra bytes put the rows of a warp's 16-byte
// reads in distinct banks)
constexpr int kSmallBK = 64, kStages = 8, kSmallMaxRows = 64;
constexpr int kSmallMaxThreads = 256;
constexpr int kXLd = kSmallBK + 4;

// threads of a block of MB rows and BN columns, each thread summing
// MB * BN / threads elements of one column
template <int MB, int BN>
__host__ __device__ constexpr int small_threads() {
  return MB * BN < kSmallMaxThreads ? MB * BN : kSmallMaxThreads;
}

template <int MB, int BN>
constexpr int small_smem_bytes() {
  return kStages * (MB * kXLd + kSmallBK * BN) *
         static_cast<int>(sizeof(float));
}

template <int MB, int BN>
__global__ void __launch_bounds__(small_threads<MB, BN>())
    row_stable_mm_small_kernel(const float* __restrict__ x,
                               const float* __restrict__ w,
                               const float* __restrict__ bias,
                               float* __restrict__ out, int M, int N, int K) {
  constexpr int kT = small_threads<MB, BN>();
  constexpr int kRowStep = kT / BN;         // rows between a thread's sums
  constexpr int kSums = MB / kRowStep;      // elements a thread sums
  constexpr int kWChunks = BN / 4;          // 16-byte chunks a w row
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                         // [kStages][MB][kXLd]
  float* ws = smem + kStages * MB * kXLd;   // [kStages][kSmallBK][BN]
  const int tid = threadIdx.x;
  const int c = tid % BN, i0 = tid / BN;
  const int n0 = blockIdx.x * BN;
  const int n_steps = (K + kSmallBK - 1) / kSmallBK;

  // one stage: kSmallBK rows of the strip's BN columns and MB rows of
  // kSmallBK values of x; what lies past K, M or N is filled with zeros
  auto load = [&](int step) {
    const int stage = step % kStages, k0 = step * kSmallBK;
    for (int q = tid; q < kSmallBK * kWChunks; q += kT) {
      const int kr = q / kWChunks, cq = (q % kWChunks) * 4, k = k0 + kr;
      const bool in = k < K && n0 + cq < N;
      ptt::fa::cp_async16(ws + (stage * kSmallBK + kr) * BN + cq,
                          in ? w + static_cast<int64_t>(k) * N + n0 + cq : w,
                          in ? 16 : 0);
    }
    for (int q = tid; q < MB * (kSmallBK / 4); q += kT) {
      const int r = q / (kSmallBK / 4), kq = (q % (kSmallBK / 4)) * 4;
      const bool in = r < M && k0 + kq < K;
      ptt::fa::cp_async16(
          xs + (stage * MB + r) * kXLd + kq,
          in ? x + static_cast<int64_t>(r) * K + k0 + kq : x, in ? 16 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load(s);
    ptt::fa::cp_async_commit();
  }
  float acc[kSums];
#pragma unroll
  for (int j = 0; j < kSums; ++j) acc[j] = 0.f;
  for (int step = 0; step < n_steps; ++step) {
    // stage `step` has landed for this thread's copies; the barrier makes
    // every thread's visible and ends every read of the stage refilled
    // next (read in the previous step)
    ptt::fa::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (step + kStages - 1 < n_steps) load(step + kStages - 1);
    ptt::fa::cp_async_commit();
    const int stage = step % kStages;
    const float* xr = xs + (stage * MB + i0) * kXLd;
    const float* wr = ws + stage * kSmallBK * BN + c;
#pragma unroll
    for (int kk = 0; kk < kSmallBK; kk += 4) {
      float4 a[kSums];
#pragma unroll
      for (int j = 0; j < kSums; ++j)
        a[j] = *reinterpret_cast<const float4*>(xr + j * kRowStep * kXLd +
                                                kk);
      const float w0 = wr[(kk + 0) * BN], w1 = wr[(kk + 1) * BN];
      const float w2 = wr[(kk + 2) * BN], w3 = wr[(kk + 3) * BN];
#pragma unroll
      for (int j = 0; j < kSums; ++j) {
        acc[j] = __fadd_rn(acc[j], __fmul_rn(a[j].x, w0));
        acc[j] = __fadd_rn(acc[j], __fmul_rn(a[j].y, w1));
        acc[j] = __fadd_rn(acc[j], __fmul_rn(a[j].z, w2));
        acc[j] = __fadd_rn(acc[j], __fmul_rn(a[j].w, w3));
      }
    }
  }
  ptt::fa::cp_async_wait<0>();  // only empty groups remain; none outlives
  const int col = n0 + c;
  if (col >= N) return;
  const float bv = bias != nullptr ? bias[col] : 0.f;
#pragma unroll
  for (int j = 0; j < kSums; ++j) {
    const int row = i0 + j * kRowStep;
    if (row < M)
      out[static_cast<int64_t>(row) * N + col] =
          bias != nullptr ? __fadd_rn(acc[j], bv) : acc[j];
  }
}

template <int MB, int BN>
cudaError_t launch_small(const float* x, const float* w, const float* bias,
                         float* out, int m, int n, int k, cudaStream_t st) {
  constexpr int smem = small_smem_bytes<MB, BN>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        row_stable_mm_small_kernel<MB, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  row_stable_mm_small_kernel<MB, BN>
      <<<(n + BN - 1) / BN, small_threads<MB, BN>(), smem, st>>>(
          x, w, bias, out, m, n, k);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_small_rows(const float* x, const float* w,
                              const float* bias, float* out, int m, int n,
                              int k, cudaStream_t st) {
  if (m <= 4) return launch_small<4, BN>(x, w, bias, out, m, n, k, st);
  if (m <= 8) return launch_small<8, BN>(x, w, bias, out, m, n, k, st);
  if (m <= 16) return launch_small<16, BN>(x, w, bias, out, m, n, k, st);
  if (m <= 32) return launch_small<32, BN>(x, w, bias, out, m, n, k, st);
  if (m <= kSmallMaxRows)
    return launch_small<kSmallMaxRows, BN>(x, w, bias, out, m, n, k, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// `strip` > 0 (the wrapper's choice by M and N) takes the small-M code
// with strips of that many columns (8, 16 or 32), which refuses M above
// kSmallMaxRows; 0 takes the 128 x 128 code.
extern "C" int ptt_row_stable_mm(const void* x, const void* w,
                                 const void* bias, void* out, int m, int n,
                                 int k, int strip, void* stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (strip) {
    case 0: {
      const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
      row_stable_mm_kernel<<<grid, kThreads, 0, st>>>(xf, wf, bf, of, m, n,
                                                      k);
      return static_cast<int>(cudaGetLastError());
    }
    case 8:
      return launch_small_rows<8>(xf, wf, bf, of, m, n, k, st);
    case 16:
      return launch_small_rows<16>(xf, wf, bf, of, m, n, k, st);
    case 32:
      return launch_small_rows<32>(xf, wf, bf, of, m, n, k, st);
    default:
      return cudaErrorInvalidValue;
  }
}

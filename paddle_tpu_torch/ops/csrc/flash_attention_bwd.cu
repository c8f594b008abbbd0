// FlashAttention-2 backward: from q [BH, Tq, D], k/v [BH, Tk, D], the
// forward's out [BH, Tq, D] and lse [BH, Tq] (f32), and dO [BH, Tq, D] ->
// dq [BH, Tq, D], dk/dv [BH, Tk, D], each in the input dtype.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py _flash_backward, i.e. the
// pair _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel.
//
// Bound on the H100: operations.  The backward recomputes the scores and
// does 2.5x the forward's products (s = q.k, dp = dO.v, dq += ds k,
// dk += ds q, dv += p dO: 10 x Tq x Tk x D flops per head, halved when
// causal) against 4 x (Tq + Tk) x D elements moved.  Like the forward,
// this first version computes on the CUDA cores in f32, far below the
// tensor-core bound: a wgmma version is later work.
//
// Design.  The TPU kernels carry their sums in VMEM scratch across a
// sequential grid axis; Hopper blocks run in no order, so each sum is a
// loop inside one block instead, and nothing is summed across blocks (no
// atomics, so results are the same from run to run):
//   1. delta = rowsum(dO * O) in f32, one warp per row;
//   2. dq: one block per (64-row q tile, batch*head), one thread per
//      query row holding its q, dO and dq rows in registers; 32-row K/V
//      tiles are staged in shared memory and read by every thread at the
//      same address (broadcast);
//   3. dk/dv: one block per (64-row k tile, batch*head), one thread per
//      key row; its own k and v rows sit transposed in shared memory
//      (conflict-free column reads), its dk and dv rows in registers, and
//      16-row Q/dO tiles are staged and broadcast.
// Both recompute p = exp(s - lse) in f32 from the saved lse.  Causal
// masking is bottom-right aligned (key j visible to query i when
// j <= i + Tk - Tq), tiles wholly outside the mask are skipped, ragged
// Tq/Tk are masked inside the kernel, and a fully masked row (lse = -inf)
// contributes p = 0, as the TPU kernels do.  head_dim is a template
// parameter: 32 and 64 are built, as in the forward.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kRows = 64;    // rows a block owns: one per thread
constexpr int kTileK = 32;   // K/V rows staged per step of the dq loop
constexpr int kTileQ = 16;   // Q/dO rows staged per step of the dk/dv loop

template <typename T>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ out,
                                       const T* __restrict__ dout,
                                       float* __restrict__ delta,
                                       int64_t rows, int D) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int d = lane; d < D; d += 32)
    s += ptt::to_f32(out[row * D + d]) * ptt::to_f32(dout[row * D + d]);
  s = ptt::warp_sum(s);
  if (lane == 0) delta[row] = s;
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Tq, int Tk, int causal, float scale) {
  __shared__ __align__(16) float Ks[kTileK][D];
  __shared__ __align__(16) float Vs[kTileK][D];

  const int64_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int row = q0 + tid;
  const int offset = Tk - Tq;
  const int64_t r = bh * Tq + min(row, Tq - 1);

  float qr[D], dor[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = ptt::to_f32(q[r * D + d]);
    dor[d] = ptt::to_f32(dout[r * D + d]);
    acc[d] = 0.f;
  }
  const float L = lse[r];
  const float dl = delta[r];
  // last key this row sees; none for rows past Tq and fully masked rows
  const bool live = row < Tq && L > -CUDART_INF_F;
  const int lim = !live ? -1
                        : (causal ? min(row + offset, Tk - 1) : Tk - 1);
  const int block_last_row = min(q0 + kRows, Tq) - 1;
  const int kv_end = causal ? min(Tk, block_last_row + offset + 1) : Tk;

  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;
  for (int k0 = 0; k0 < kv_end; k0 += kTileK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kTileK * D; i += kRows) {
      const int rr = i / D, c = i % D, kr = k0 + rr;
      const bool in = kr < Tk;
      Ks[rr][c] = in ? ptt::to_f32(kb[static_cast<int64_t>(kr) * D + c]) : 0.f;
      Vs[rr][c] = in ? ptt::to_f32(vb[static_cast<int64_t>(kr) * D + c]) : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kTileK && k0 + j <= lim; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s += qr[d] * Ks[j][d];
        dp += dor[d] * Vs[j][d];
      }
      const float p = expf(s * scale - L);
      const float ds = p * (dp - dl) * scale;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += ds * Ks[j][d];
    }
  }
  if (row < Tq) {
    T* op = dq + (bh * Tq + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = ptt::from_f32<T>(acc[d]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int Tq,
                          int Tk, int causal, float scale) {
  // own rows, transposed and padded: thread t reads column t of row d
  __shared__ float Kt[D][kRows + 1];
  __shared__ float Vt[D][kRows + 1];
  __shared__ __align__(16) float Qs[kTileQ][D];
  __shared__ __align__(16) float Gs[kTileQ][D];  // dO tile
  __shared__ float Ls[kTileQ];
  __shared__ float Dl[kTileQ];

  const int64_t bh = blockIdx.y;
  const int k0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int col = k0 + tid;  // this thread's key
  const int offset = Tk - Tq;

  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;
  for (int i = tid; i < kRows * D; i += kRows) {
    const int rr = i / D, c = i % D, kr = k0 + rr;
    const bool in = kr < Tk;
    Kt[c][rr] = in ? ptt::to_f32(kb[static_cast<int64_t>(kr) * D + c]) : 0.f;
    Vt[c][rr] = in ? ptt::to_f32(vb[static_cast<int64_t>(kr) * D + c]) : 0.f;
  }
  float dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dka[d] = 0.f;
    dva[d] = 0.f;
  }
  // queries that see key j: i >= j - offset (causal), all otherwise
  const int first_q = col >= Tk ? Tq : (causal ? max(0, col - offset) : 0);
  const int q_start = causal ? max(0, k0 - offset) : 0;

  const T* qb = q + bh * Tq * D;
  const T* gb = dout + bh * Tq * D;
  for (int i0 = q_start; i0 < Tq; i0 += kTileQ) {
    __syncthreads();  // the previous tile is no longer read (and Kt/Vt
                      // are written before the first)
    for (int i = tid; i < kTileQ * D; i += kRows) {
      const int rr = i / D, c = i % D, qr = i0 + rr;
      const bool in = qr < Tq;
      Qs[rr][c] = in ? ptt::to_f32(qb[static_cast<int64_t>(qr) * D + c]) : 0.f;
      Gs[rr][c] = in ? ptt::to_f32(gb[static_cast<int64_t>(qr) * D + c]) : 0.f;
    }
    if (tid < kTileQ) {
      const int qr = i0 + tid;
      Ls[tid] = qr < Tq ? lse[bh * Tq + qr] : -CUDART_INF_F;
      Dl[tid] = qr < Tq ? delta[bh * Tq + qr] : 0.f;
    }
    __syncthreads();
    for (int ii = 0; ii < kTileQ; ++ii) {
      const int i = i0 + ii;
      const float L = Ls[ii];
      if (i < first_q || !(L > -CUDART_INF_F)) continue;  // masked or past Tq
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s += Kt[d][tid] * Qs[ii][d];
        dp += Vt[d][tid] * Gs[ii][d];
      }
      const float p = expf(s * scale - L);
      const float ds = p * (dp - Dl[ii]) * scale;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dva[d] += p * Gs[ii][d];
        dka[d] += ds * Qs[ii][d];
      }
    }
  }
  if (col < Tk) {
    T* kp = dk + (bh * Tk + col) * D;
    T* vp = dv + (bh * Tk + col) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kp[d] = ptt::from_f32<T>(dka[d]);
      vp[d] = ptt::from_f32<T>(dva[d]);
    }
  }
}

template <typename T, int D>
void launch_d(const T* q, const T* k, const T* v, const T* dout,
              const float* lse, const float* delta, T* dq, T* dk, T* dv,
              int BH, int Tq, int Tk, int causal, float scale,
              cudaStream_t st) {
  const dim3 grid_q((Tq + kRows - 1) / kRows, BH);
  flash_bwd_dq_kernel<T, D><<<grid_q, kRows, 0, st>>>(
      q, k, v, dout, lse, delta, dq, Tq, Tk, causal, scale);
  const dim3 grid_k((Tk + kRows - 1) / kRows, BH);
  flash_bwd_dkdv_kernel<T, D><<<grid_k, kRows, 0, st>>>(
      q, k, v, dout, lse, delta, dk, dv, Tq, Tk, causal, scale);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int BH, int Tq, int Tk, int D, int causal, float scale,
           cudaStream_t st) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* gg = static_cast<const T*>(dout);
  const float* ll = static_cast<const float*>(lse);
  float* dd = static_cast<float*>(delta);
  const int64_t rows = static_cast<int64_t>(BH) * Tq;
  constexpr int kWarps = 8;
  flash_bwd_delta_kernel<T><<<(rows + kWarps - 1) / kWarps, 32 * kWarps, 0,
                              st>>>(static_cast<const T*>(out), gg, dd, rows,
                                    D);
  switch (D) {
    case 32:
      launch_d<T, 32>(qq, kk, vv, gg, ll, dd, static_cast<T*>(dq),
                      static_cast<T*>(dk), static_cast<T*>(dv), BH, Tq, Tk,
                      causal, scale, st);
      break;
    case 64:
      launch_d<T, 64>(qq, kk, vv, gg, ll, dd, static_cast<T*>(dq),
                      static_cast<T*>(dk), static_cast<T*>(dv), BH, Tq, Tk,
                      causal, scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// delta is f32 scratch of BH x Tq values, allocated by the caller.
extern "C" int ptt_flash_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* out,
                                       const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk,
                                       void* dv, int bh, int tq, int tk,
                                       int head_dim, int causal, float scale,
                                       int is_bf16, void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                 bh, tq, tk, head_dim, causal, scale, st);
  return launch<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh, tq,
                       tk, head_dim, causal, scale, st);
}

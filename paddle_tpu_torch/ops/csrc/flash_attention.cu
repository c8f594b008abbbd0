// FlashAttention-2 forward: q [BH, Tq, D], k/v [BH, Tk, D] ->
// out [BH, Tq, D] (q's dtype) and lse [BH, Tq] (f32).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py _flash_kernel (reached
// through _flash_forward; on the TPU the library kernel _lib_flash also
// served this call).
//
// Bound on the H100: operations at long T (4 x Tq x Tk x D flops per head,
// halved when causal, against 2 x (Tq + 2 Tk) x D elements moved); bytes
// at short T.  This first version computes on the CUDA cores in f32, so
// it is far from the tensor-core bound (989 TFLOP/s bf16): a wgmma
// version is later work.
//
// Design: one block per (64-row q tile, batch*head), one thread per query
// row.  The thread keeps its scaled query row and output accumulator in
// registers; K/V tiles of 32 rows are staged in shared memory (as f32)
// and read by every thread of the block at the same address (broadcast,
// no bank conflicts).  The online softmax (running max m and sum l) is
// f32.  Causal masking is bottom-right aligned (key j is visible to
// query i when j <= i + Tk - Tq), K/V tiles wholly in the masked future
// of the block's last row are never loaded, and ragged Tq/Tk are masked
// inside the kernel, so any length works (prefill goes down to 1 token).
// A fully masked row gives out 0 and lse -inf, as the TPU kernel does.
// The query row and accumulator live in registers, so head_dim is a
// template parameter: 32 and 64 are built (the served model has 64).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int Tq, int Tk, int causal,
                     float scale) {
  __shared__ __align__(16) float Ks[kBlockK][D];
  __shared__ __align__(16) float Vs[kBlockK][D];

  const int64_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int row = q0 + tid;
  const int offset = Tk - Tq;

  float qr[D], acc[D];
  const T* qp = q + (bh * Tq + min(row, Tq - 1)) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = ptt::to_f32(qp[d]) * scale;
    acc[d] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;
  // last key this row sees (rows past Tq see nothing)
  const int lim = row >= Tq ? -1 : (causal ? min(row + offset, Tk - 1)
                                           : Tk - 1);
  // keys any row of this block sees
  const int block_last_row = min(q0 + kBlockQ, Tq) - 1;
  const int kv_end = causal ? min(Tk, block_last_row + offset + 1) : Tk;

  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kBlockK * D; i += kBlockQ) {
      const int r = i / D, c = i % D, kr = k0 + r;
      const bool in = kr < Tk;
      Ks[r][c] = in ? ptt::to_f32(kb[static_cast<int64_t>(kr) * D + c]) : 0.f;
      Vs[r][c] = in ? ptt::to_f32(vb[static_cast<int64_t>(kr) * D + c]) : 0.f;
    }
    __syncthreads();
    if (k0 > lim) continue;  // every key of the tile is masked for this row

    float sc[kBlockK];
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += qr[d] * Ks[j][d];
      sc[j] = (k0 + j <= lim) ? dot : -CUDART_INF_F;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    const float m_new = fmaxf(m, tile_max);  // finite: key k0 <= lim
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(sc[j] - m_new);  // 0 for a masked key
      psum += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += p * Vs[j][d];
    }
    l = l * alpha + psum;
    m = m_new;
  }
  if (row < Tq) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* op = out + (bh * Tq + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = ptt::from_f32<T>(acc[d] * inv);
    lse[bh * Tq + row] = l > 0.f ? m + logf(l) : -CUDART_INF_F;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int BH, int Tq, int Tk, int D, int causal, float scale,
           cudaStream_t st) {
  const dim3 grid((Tq + kBlockQ - 1) / kBlockQ, BH);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  float* ll = static_cast<float*>(lse);
  switch (D) {
    case 32:
      flash_fwd_kernel<T, 32><<<grid, kBlockQ, 0, st>>>(qq, kk, vv, oo, ll,
                                                        Tq, Tk, causal, scale);
      break;
    case 64:
      flash_fwd_kernel<T, 64><<<grid, kBlockQ, 0, st>>>(qq, kk, vv, oo, ll,
                                                        Tq, Tk, causal, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int bh, int tq, int tk, int head_dim,
                                       int causal, float scale, int is_bf16,
                                       void* stream) {
  if (bh <= 0 || tq <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, lse, bh, tq, tk, head_dim,
                                 causal, scale, st);
  return launch<float>(q, k, v, out, lse, bh, tq, tk, head_dim, causal,
                       scale, st);
}

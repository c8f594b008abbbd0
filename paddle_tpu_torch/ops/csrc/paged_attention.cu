// Paged decode attention: one query token per slot over its paged KV
// prefix.  q [S, H, 1, D], pools [N, L, H, D], table [S, P] int32,
// index [S] int32 -> out [S, H, 1, D] (q's dtype).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py _paged_attn_kernel (reached
// through paged_attention_pallas).
//
// Bound on the H100: bytes.  Slot s must read (Index[s]+1) x H x D x 2
// pool elements (its K and V rows); the work is ~4 flops per element
// read, far below the card's ~20 flops per byte.
//
// Design: one block per (slot, head), 128 threads.  The block walks its
// slot's positions 0..Index[s] in chunks of 128: each thread scores one
// position against the query (the query row sits in shared memory), the
// chunk folds into an f32 online softmax (running max and sum), and the
// probability-weighted V rows are summed with D threads per group, so
// neighbouring threads read neighbouring V elements.  The page table is
// walked inside the kernel, so no gathered [S, H, P*L, D] prefix is ever
// written.  Unlike the TPU kernel, pages wholly past Index[s] are never
// loaded.  Sentinel page ids (num_blocks, an idle slot's row) clamp to
// N-1 exactly as the TPU kernel's index map does, so idle slots give the
// same finite rows.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, int D>
__device__ __forceinline__ float dot_row(const float* qs, const T* row) {
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < D; ++e) acc += qs[e] * ptt::to_f32(row[e]);
  return acc;
}

__device__ __forceinline__ int page_of(const int* table_row, int pos, int L,
                                       int N) {
  const int page = table_row[pos / L];
  return min(max(page, 0), N - 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                      const T* __restrict__ pool_v,
                      const int* __restrict__ table,
                      const int* __restrict__ index, T* __restrict__ out,
                      int N, int L, int H, int P, float scale) {
  constexpr int G = kThreads / D;  // position groups in the V pass
  __shared__ float qs[D];
  __shared__ float ps[kThreads];
  __shared__ float scratch[32];
  __shared__ float accs[G][D];

  const int s = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int64_t q_off = (static_cast<int64_t>(s) * H + h) * D;
  if (tid < D) qs[tid] = ptt::to_f32(q[q_off + tid]) * scale;
  __syncthreads();

  const int* table_row = table + static_cast<int64_t>(s) * P;
  const int last = min(index[s], P * L - 1);  // last position attended
  const int d = tid % D, g = tid / D;
  float m = -CUDART_INF_F, l = 0.f, acc = 0.f;

  for (int c0 = 0; c0 <= last; c0 += kThreads) {
    const int t = c0 + tid;
    float sc = -CUDART_INF_F;
    if (t <= last) {
      const int page = page_of(table_row, t, L, N);
      const T* kr =
          pool_k + ((static_cast<int64_t>(page) * L + t % L) * H + h) * D;
      sc = dot_row<T, D>(qs, kr);
    }
    // position c0 <= last is always live, so the chunk max is finite
    const float m_new = fmaxf(m, ptt::block_max(sc, scratch));
    const float alpha = expf(m - m_new);  // 0 on the first chunk
    const float p = (t <= last) ? expf(sc - m_new) : 0.f;
    ps[tid] = p;  // visible after block_sum's barriers
    l = l * alpha + ptt::block_sum(p, scratch);
    acc *= alpha;
    const int n_here = min(kThreads, last - c0 + 1);
    for (int j = g; j < n_here; j += G) {
      const int tt = c0 + j;
      const int page = page_of(table_row, tt, L, N);
      const T* vr =
          pool_v + ((static_cast<int64_t>(page) * L + tt % L) * H + h) * D;
      acc += ps[j] * ptt::to_f32(vr[d]);
    }
    m = m_new;
    __syncthreads();  // ps is rewritten by the next chunk
  }
  accs[g][d] = acc;
  __syncthreads();
  if (tid < D) {
    float o = 0.f;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) o += accs[gg][tid];
    out[q_off + tid] = ptt::from_f32<T>(l > 0.f ? o / l : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* pk, const void* pv, const void* table,
           const void* index, void* out, int S, int H, int D, int N, int L,
           int P, float scale, cudaStream_t st) {
  const dim3 grid(S, H);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(pk);
  const T* vv = static_cast<const T*>(pv);
  const int* tb = static_cast<const int*>(table);
  const int* ix = static_cast<const int*>(index);
  T* oo = static_cast<T*>(out);
  switch (D) {
    case 16:
      paged_attn_kernel<T, 16><<<grid, kThreads, 0, st>>>(
          qq, kk, vv, tb, ix, oo, N, L, H, P, scale);
      break;
    case 32:
      paged_attn_kernel<T, 32><<<grid, kThreads, 0, st>>>(
          qq, kk, vv, tb, ix, oo, N, L, H, P, scale);
      break;
    case 64:
      paged_attn_kernel<T, 64><<<grid, kThreads, 0, st>>>(
          qq, kk, vv, tb, ix, oo, N, L, H, P, scale);
      break;
    case 128:
      paged_attn_kernel<T, 128><<<grid, kThreads, 0, st>>>(
          qq, kk, vv, tb, ix, oo, N, L, H, P, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptt_paged_attention(const void* q, const void* pool_k,
                                   const void* pool_v, const void* table,
                                   const void* index, void* out, int slots,
                                   int heads, int head_dim, int num_blocks,
                                   int block_len, int pages, float scale,
                                   int is_bf16, void* stream) {
  if (slots <= 0 || heads <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, pool_k, pool_v, table, index, out, slots,
                                 heads, head_dim, num_blocks, block_len,
                                 pages, scale, st);
  return launch<float>(q, pool_k, pool_v, table, index, out, slots, heads,
                       head_dim, num_blocks, block_len, pages, scale, st);
}

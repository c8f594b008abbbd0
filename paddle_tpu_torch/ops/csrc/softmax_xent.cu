// Hard-label softmax cross-entropy over logits x [R, V] (f32 or bf16) and
// int32 labels [R]:
//   forward:  loss [R] = lse - x[label] and lse [R] = logsumexp(x), f32;
//   backward: dx [R, V] = (exp(x - lse) - onehot(label)) * dloss, in x's
//             dtype, from the saved lse and dloss [R] (f32).
// A label outside [0, V) picks no logit (gold 0) and no one-hot lane, as
// the TPU kernels do.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py _sm_xent_fwd_kernel and
// _sm_xent_bwd_kernel (reached through _sm_xent_pallas_fwd/_bwd and
// fused_softmax_xent).
//
// Bound on the H100: bytes.  The forward must read the logits once (8
// bytes of output per row); the backward must read them once and write
// dx once.  Both do a few flops and one exp per element.
//
// Forward design.  One block of 256 threads a row.  What limits a
// streaming pass is the bytes in flight, so each thread reads its share
// of the row as 16-byte vectors (8 bf16 or 4 f32), kLoads of them issued
// together before the first is used: 32 values a chunk, vectors
// t + 256 u (u < kLoads) of the chunk's 256 kLoads vectors, so a warp's
// loads are whole 512-byte runs.  Each thread keeps an online softmax
// (m2, s) in base 2: m2 = max x * log2(e), rounded once, s = sum of
// 2^(x log2(e) - m2), each term one FFMA and one MUFU.EX2; a chunk takes
// one max and at most one rescale of s, not one per element, and no
// branch per element, so the next chunk's loads do not wait on it.  The
// block combines the threads' pairs (a warp butterfly, then the 8 warps'
// pairs in warp 0), and lse = (m2 + log2 s) ln 2: m2's rounding cancels
// in m2 + log2 s.  The gold logit is read once, by thread 0, at
// x[row, label] for a label in [0, V), so there is no compare per element
// and one block reduction instead of three.  A row whose start is not
// 16-byte aligned (V not a multiple of 8 in bf16 or 4 in f32) reads its
// first elements up to the boundary and its last ones past the final
// whole vector one at a time (fewer than one vector each, folded into
// the threads' pairs as one more chunk) and the rest as vectors, in the
// same kernel.  A row of -inf has no term: lse = -inf.  The [R, V]
// probability tensor exists in neither direction.
//
// Backward: one elementwise pass, one block per row.
#include <cstdint>

#include "common.cuh"
#include "flash_mma.cuh"  // ptt::fa::exp2_approx (ex2.approx.ftz)

namespace {

constexpr int kThreads = 256;
constexpr int kChunkValues = 32;  // values a thread folds in at once
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// Fold n values into a thread's (m2, s).  Values of -inf (and masked
// slots, which hold -inf) add 0.
template <int n>
__device__ __forceinline__ void fold(const float (&v)[n], float& m2,
                                     float& s) {
  float cm = -CUDART_INF_F;
#pragma unroll
  for (int e = 0; e < n; ++e) cm = fmaxf(cm, v[e]);
  if (!(cm > -CUDART_INF_F)) return;
  const float cm2 = cm * kLog2e;
  if (cm2 > m2) {  // 2^(-inf) = 0 while m2 is still -inf
    s *= ptt::fa::exp2_approx(m2 - cm2);
    m2 = cm2;
  }
#pragma unroll
  for (int e = 0; e < n; ++e)
    s += ptt::fa::exp2_approx(fmaf(v[e], kLog2e, -m2));
}

// (m2, s) <- the pair of both sets of terms
__device__ __forceinline__ void combine(float& m2, float& s, float om2,
                                        float os) {
  const float mx = fmaxf(m2, om2);
  if (!(mx > -CUDART_INF_F)) return;
  s = s * ptt::fa::exp2_approx(m2 - mx) + os * ptt::fa::exp2_approx(om2 - mx);
  m2 = mx;
}

__device__ __forceinline__ void warp_combine(float& m2, float& s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    combine(m2, s, __shfl_xor_sync(0xffffffffu, m2, o),
            __shfl_xor_sync(0xffffffffu, s, o));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sm_xent_fwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                       float* __restrict__ loss, float* __restrict__ lse,
                       int V) {
  using C = ptt::Chunk<T>;
  constexpr int kLoads = kChunkValues / C::n;  // 4 bf16 or 8 f32 vectors
  __shared__ float pair_m2[kThreads / 32], pair_s[kThreads / 32];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * V;
  const int lab = tid == 0 ? labels[row] : 0;
  // elements before the first 16-byte boundary, whole vectors, the rest
  const int head = min(
      V, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(xr) & 15)) &
                          15) / static_cast<int>(sizeof(T)));
  const int nvec = (V - head) / C::n;
  const int tail0 = head + nvec * C::n;
  float m2 = -CUDART_INF_F, s = 0.f;
  {
    const float edge[2] = {
        tid < head ? ptt::to_f32(xr[tid]) : -CUDART_INF_F,
        tail0 + tid < V ? ptt::to_f32(xr[tail0 + tid]) : -CUDART_INF_F};
    fold(edge, m2, s);
  }
  const T* body = xr + head;
  for (int base = 0; base < nvec; base += kThreads * kLoads) {
    uint4 raw[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = base + u * kThreads + tid;
      if (j < nvec) raw[u] = C::raw(body + static_cast<int64_t>(j) * C::n);
    }
    float v[kChunkValues];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (base + u * kThreads + tid < nvec) {
        C::unpack(raw[u], v + u * C::n);
      } else {
#pragma unroll
        for (int e = 0; e < C::n; ++e) v[u * C::n + e] = -CUDART_INF_F;
      }
    }
    fold(v, m2, s);
  }
  const float gold =
      tid == 0 && lab >= 0 && lab < V ? ptt::to_f32(xr[lab]) : 0.f;
  warp_combine(m2, s);
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    pair_m2[warp] = m2;
    pair_s[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m2 = lane < kThreads / 32 ? pair_m2[lane] : -CUDART_INF_F;
    s = lane < kThreads / 32 ? pair_s[lane] : 0.f;
    warp_combine(m2, s);
    if (lane == 0) {
      const float l =
          m2 > -CUDART_INF_F ? (m2 + log2f(s)) * kLn2 : -CUDART_INF_F;
      lse[row] = l;
      loss[row] = l - gold;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sm_xent_bwd_kernel(const T* __restrict__ x,
                       const int* __restrict__ labels,
                       const float* __restrict__ lse,
                       const float* __restrict__ dloss, T* __restrict__ dx,
                       int V) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * V;
  T* dr = dx + row * V;
  const int lab = labels[row];
  const float l = lse[row], g = dloss[row];
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const float p = expf(ptt::to_f32(xr[i]) - l);
    dr[i] = ptt::from_f32<T>((p - (i == lab ? 1.f : 0.f)) * g);
  }
}

}  // namespace

extern "C" int ptt_softmax_xent_fwd(const void* x, const void* labels,
                                    void* loss, void* lse, int rows,
                                    int vocab, int is_bf16, void* stream) {
  if (rows <= 0 || vocab <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  if (is_bf16)
    sm_xent_fwd_kernel<__nv_bfloat16><<<rows, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), lab, static_cast<float*>(loss),
        static_cast<float*>(lse), vocab);
  else
    sm_xent_fwd_kernel<float><<<rows, kThreads, 0, st>>>(
        static_cast<const float*>(x), lab, static_cast<float*>(loss),
        static_cast<float*>(lse), vocab);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptt_softmax_xent_bwd(const void* x, const void* labels,
                                    const void* lse, const void* dloss,
                                    void* dx, int rows, int vocab,
                                    int is_bf16, void* stream) {
  if (rows <= 0 || vocab <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* l = static_cast<const float*>(lse);
  const float* g = static_cast<const float*>(dloss);
  if (is_bf16)
    sm_xent_bwd_kernel<__nv_bfloat16><<<rows, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), lab, l, g,
        static_cast<__nv_bfloat16*>(dx), vocab);
  else
    sm_xent_bwd_kernel<float><<<rows, kThreads, 0, st>>>(
        static_cast<const float*>(x), lab, l, g, static_cast<float*>(dx),
        vocab);
  return static_cast<int>(cudaGetLastError());
}

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
// Design.  Forward: one block per row; each thread streams its strided
// share of the row with its own running max and rescaled sum (online
// softmax, f32), picks the gold logit if the label falls in its share,
// and the block combines the (max, sum) pairs: max first, then each sum
// rescaled to it.  The [R, V] probability tensor exists in neither
// direction.  Backward: one elementwise pass, one block per row.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sm_xent_fwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                       float* __restrict__ loss, float* __restrict__ lse,
                       int V) {
  __shared__ float scratch[32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * V;
  const int lab = labels[row];
  float m = -CUDART_INF_F, s = 0.f, gold = 0.f;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const float xi = ptt::to_f32(xr[i]);
    if (i == lab) gold = xi;
    if (!(xi > -CUDART_INF_F)) continue;  // exp(-inf) adds nothing
    if (xi > m) {
      s *= expf(m - xi);  // 0 while m is still -inf
      m = xi;
    }
    s += expf(xi - m);
  }
  const float mx = ptt::block_max(m, scratch);
  const float st = m > -CUDART_INF_F ? s * expf(m - mx) : 0.f;
  const float sum = ptt::block_sum(st, scratch);
  const float g = ptt::block_sum(gold, scratch);
  if (threadIdx.x == 0) {
    const float l = mx > -CUDART_INF_F ? mx + logf(sum) : mx;
    lse[row] = l;
    loss[row] = l - g;
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

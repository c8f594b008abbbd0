// FlashAttention-2 backward on the tensor cores: from q [BH, Tq, D], k/v
// [BH, Tk, D], the forward's out [BH, Tq, D] and lse [BH, Tq] (f32), and
// dO [BH, Tq, D] -> dq [BH, Tq, D], dk/dv [BH, Tk, D], each in the input
// dtype.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py _flash_backward, i.e. the
// pair _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel.
//
// Bound on the H100: operations.  The backward recomputes the scores and
// does 2.5x the forward's products (s = q.k, dp = dO.v, dq += ds k,
// dk += ds q, dv += p dO: 10 x Tq x Tk x D flops per head, halved when
// causal) against 4 x (Tq + Tk) x D elements moved.  bf16 runs at the
// 989 TFLOP/s of the bf16 tensor cores, f32 at a third of the 495 TFLOP/s
// TF32 rate (3xTF32, flash_mma.cuh).
//
// Design.  The TPU kernels carry their sums in VMEM scratch across a
// sequential grid axis; Hopper blocks run in no order, so each sum is a
// loop inside one block instead, and nothing is summed across blocks (no
// atomics, so results are the same bit for bit from run to run).  The
// price: dq's block and dk/dv's block each recompute s = q.k and
// dp = dO.v, so the two kernels do 14 products of Tq x Tk x D pairs
// where one kernel with atomic dq sums would do 10.
//   1. delta = rowsum(dO * O) in f32, one warp per row;
//   2. dq: one block of 4 warps per (64-row q tile, batch*head), issued
//      heaviest first; each warp owns 16 query rows.  Q and dO tiles come
//      in once by cp.async; K/V tiles of 64 keys are double buffered
//      (tile j + 1 in flight while tile j is computed).  Per 32 keys:
//      S = Q.K^T and dP = dO.V^T on the tensor cores, p = exp(s - lse)
//      (0 on a fully masked row), ds = p (dp - delta) / sqrt(D), and
//      dQ += dS.K with dS taken from the accumulator registers as the A
//      operand and K through ldmatrix.trans;
//   3. dk/dv: one block of 4 warps per (64-key tile, batch*head), the
//      first keys (which see the most queries under a causal mask) first;
//      each warp owns 16 keys, its K/V rows loaded once, and Q/dO tiles
//      of 64 queries (with their lse and delta) are double buffered.  Per
//      32 queries it computes the transposes S^T = K.Q^T and
//      dP^T = V.dO^T directly, so P^T and dS^T come out in the
//      accumulator layout that is the A operand of dV += P^T.dO and
//      dK += dS^T.Q.
// Products run in bf16 mma.sync (p and ds rounded to bf16 only as
// product operands, as in the forward) or in 3xTF32 for f32, and each
// step's dq, dk or dv product is summed apart and added with an FADD
// (`add_pn`).  Causal
// masking is bottom-right aligned (key j visible to query i when
// j <= i + Tk - Tq), tiles wholly outside the mask are skipped, the mask
// and the ragged edges are applied only on the tiles that cross them
// (rows past the end read as zeros), and a fully masked row (lse = -inf)
// contributes p = 0, as the TPU kernels do.  head_dim is a template
// parameter: 32 and 64 are built, as in the forward.  mma.sync rather
// than wgmma/TMA for the reason the forward gives (flash_attention.cu).
#include <cstdint>

#include "flash_mma.cuh"

namespace {

using ptt::fa::kRows;
using ptt::fa::kThreads;

constexpr int kSub = 32;  // keys (dq) or queries (dk/dv) per inner step

// acc += the warp's [16 x D] product P.B of one inner step, summed apart
// first: the tensor cores add into their accumulator without rounding to
// nearest, so a running sum over a thousand keys fed straight by mma
// drifts toward zero by most of F32_TOL; each step's sum is added with an
// FADD.
template <typename T, int N, int D>
__device__ __forceinline__ void add_pn(float (&acc)[D / 8][4],
                                       const float (&p)[N / 8][4], const T* b,
                                       int ld) {
  float part[D / 8][4] = {};
  ptt::fa::gemm_pn<T, N, D>(part, p, b, ld);
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] += part[nd][e];
}

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

// Shared memory of either kernel: two single tiles and two double-
// buffered ones, plus (dk/dv) lse and delta of two query tiles.
template <typename T, int D>
constexpr int smem_bytes() {
  return 6 * kRows * ptt::fa::ld<T, D>() * static_cast<int>(sizeof(T)) +
         4 * kRows * static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Tq, int Tk, int causal, float scale) {
  constexpr int LD = ptt::fa::ld<T, D>();
  constexpr int kTile = kRows * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Gs = Qs + kTile;      // dO
  T* Ks = Gs + kTile;      // two buffers
  T* Vs = Ks + 2 * kTile;  // two buffers

  const int64_t bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = q0 + warp * 16;
  const int offset = Tk - Tq;
  const int last_row = min(q0 + kRows, Tq) - 1;
  const int kv_end = causal ? min(Tk, last_row + offset + 1) : Tk;
  const int n_kv = kv_end > 0 ? (kv_end + kRows - 1) / kRows : 0;

  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;
  ptt::fa::load_tile<T, D>(Qs, q + bh * Tq * D, q0, Tq);
  ptt::fa::load_tile<T, D>(Gs, dout + bh * Tq * D, q0, Tq);
  if (n_kv > 0) {
    ptt::fa::load_tile<T, D>(Ks, kb, 0, Tk);
    ptt::fa::load_tile<T, D>(Vs, vb, 0, Tk);
  }
  ptt::fa::cp_async_commit();

  // per row (g, g + 8): lse and delta; dead rows get p = 0
  float Lr[2], dl[2];
  bool live[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = w0 + g + 8 * rr;
    const float L = row < Tq ? lse[bh * Tq + row] : -CUDART_INF_F;
    live[rr] = L > -CUDART_INF_F;
    Lr[rr] = live[rr] ? L : 0.f;
    dl[rr] = row < Tq ? delta[bh * Tq + row] : 0.f;
  }
  float acc[D / 8][4] = {};

  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kv) {
      ptt::fa::load_tile<T, D>(Ks + (buf ^ 1) * kTile, kb, (j + 1) * kRows,
                               Tk);
      ptt::fa::load_tile<T, D>(Vs + (buf ^ 1) * kTile, vb, (j + 1) * kRows,
                               Tk);
      ptt::fa::cp_async_commit();
      ptt::fa::cp_async_wait<1>();
    } else {
      ptt::fa::cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + buf * kTile;
    const T* Vt = Vs + buf * kTile;
#pragma unroll
    for (int sub = 0; sub < kRows; sub += kSub) {
      const int c0 = j * kRows + sub;  // first key of the step
      if (causal && c0 > w0 + 15 + offset) break;  // the rest is masked
      float s[kSub / 8][4] = {}, ds[kSub / 8][4] = {};
      ptt::fa::gemm_nt<T, kSub, D>(s, Qs + warp * 16 * LD, Kt + sub * LD,
                                   LD);
      ptt::fa::gemm_nt<T, kSub, D>(ds, Gs + warp * 16 * LD, Vt + sub * LD,
                                   LD);
      const bool edge =
          c0 + kSub > Tk || (causal && c0 + kSub - 1 > w0 + offset);
#pragma unroll
      for (int nb = 0; nb < kSub / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = e >> 1;
          const int col = c0 + nb * 8 + 2 * t + (e & 1);
          const int row = w0 + g + 8 * rr;
          // exp(s / sqrt(D) - lse), rounded in natural units first so the
          // error scales with the exponent, not with lse
          float p = live[rr]
                        ? ptt::fa::exp2_approx(fmaf(s[nb][e], scale, -Lr[rr]) *
                                               ptt::fa::kLog2e)
                        : 0.f;
          if (edge && (col >= Tk || (causal && col > row + offset))) p = 0.f;
          ds[nb][e] = p * (ds[nb][e] - dl[rr]) * scale;
        }
      add_pn<T, kSub, D>(acc, ds, Kt + sub * LD, LD);
    }
    __syncthreads();
  }
  if (n_kv == 0) ptt::fa::cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  ptt::fa::store_rows<T, D>(dq + bh * Tq * D, acc, one, w0, Tq);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int Tq,
                          int Tk, int causal, float scale) {
  constexpr int LD = ptt::fa::ld<T, D>();
  constexpr int kTile = kRows * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kTile;
  T* Qs = Vs + kTile;      // two buffers
  T* Gs = Qs + 2 * kTile;  // dO, two buffers
  float* Ls = reinterpret_cast<float*>(Gs + 2 * kTile);  // [2][kRows]
  float* Dl = Ls + 2 * kRows;                            // [2][kRows]

  const int64_t bh = blockIdx.y;
  const int k0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = k0 + warp * 16;  // the warp's first key
  const int offset = Tk - Tq;
  // queries that see any key of the block: i >= j - offset (causal)
  const int q_start = causal ? max(0, k0 - offset) : 0;
  const int n_q = q_start < Tq ? (Tq - q_start + kRows - 1) / kRows : 0;

  const T* qb = q + bh * Tq * D;
  const T* gb = dout + bh * Tq * D;
  const float* lb = lse + bh * Tq;
  const float* db = delta + bh * Tq;
  // Q, dO, lse and delta of the query tile at i0 into buffer `buf`
  auto load_q = [&](int i0, int buf) {
    ptt::fa::load_tile<T, D>(Qs + buf * kTile, qb, i0, Tq);
    ptt::fa::load_tile<T, D>(Gs + buf * kTile, gb, i0, Tq);
    const int r = threadIdx.x & (kRows - 1), i = i0 + r;
    const bool in = i < Tq;
    if (threadIdx.x < kRows)
      ptt::fa::cp_async4(Ls + buf * kRows + r, lb + (in ? i : 0), in ? 4 : 0);
    else
      ptt::fa::cp_async4(Dl + buf * kRows + r, db + (in ? i : 0), in ? 4 : 0);
  };
  ptt::fa::load_tile<T, D>(Ks, k + bh * Tk * D, k0, Tk);
  ptt::fa::load_tile<T, D>(Vs, v + bh * Tk * D, k0, Tk);
  if (n_q > 0) load_q(q_start, 0);
  ptt::fa::cp_async_commit();

  float dka[D / 8][4] = {}, dva[D / 8][4] = {};

  for (int j = 0; j < n_q; ++j) {
    const int buf = j & 1;
    const int i0 = q_start + j * kRows;
    if (j + 1 < n_q) {
      load_q(i0 + kRows, buf ^ 1);
      ptt::fa::cp_async_commit();
      ptt::fa::cp_async_wait<1>();
    } else {
      ptt::fa::cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qt = Qs + buf * kTile;
    const T* Gt = Gs + buf * kTile;
    const float* Lt = Ls + buf * kRows;
    const float* Dt = Dl + buf * kRows;
#pragma unroll
    for (int sub = 0; sub < kRows; sub += kSub) {
      const int c0 = i0 + sub;  // first query of the step
      if (c0 >= Tq) break;
      // every key of the warp in the masked future of every query
      if (causal && w0 > c0 + kSub - 1 + offset) continue;
      float p[kSub / 8][4] = {};
      ptt::fa::gemm_nt<T, kSub, D>(p, Ks + warp * 16 * LD, Qt + sub * LD,
                                   LD);
      const bool edge =
          c0 + kSub > Tq || (causal && w0 + 15 > c0 + offset);
#pragma unroll
      for (int nb = 0; nb < kSub / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = sub + nb * 8 + 2 * t + (e & 1);  // query in tile
          const int i = i0 + c;
          const int key = w0 + g + 8 * (e >> 1);
          const float L = Lt[c];
          float x = L > -CUDART_INF_F
                        ? ptt::fa::exp2_approx(fmaf(p[nb][e], scale, -L) *
                                               ptt::fa::kLog2e)
                        : 0.f;
          if (edge && (i >= Tq || (causal && key > i + offset))) x = 0.f;
          p[nb][e] = x;
        }
      add_pn<T, kSub, D>(dva, p, Gt + sub * LD, LD);
      float ds[kSub / 8][4] = {};
      ptt::fa::gemm_nt<T, kSub, D>(ds, Vs + warp * 16 * LD, Gt + sub * LD,
                                   LD);
#pragma unroll
      for (int nb = 0; nb < kSub / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = sub + nb * 8 + 2 * t + (e & 1);
          ds[nb][e] = p[nb][e] * (ds[nb][e] - Dt[c]) * scale;
        }
      add_pn<T, kSub, D>(dka, ds, Qt + sub * LD, LD);
    }
    __syncthreads();
  }
  if (n_q == 0) ptt::fa::cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  ptt::fa::store_rows<T, D>(dk + bh * Tk * D, dka, one, w0, Tk);
  ptt::fa::store_rows<T, D>(dv + bh * Tk * D, dva, one, w0, Tk);
}

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, const T* dout,
             const float* lse, const float* delta, T* dq, T* dk, T* dv,
             int BH, int Tq, int Tk, int causal, float scale,
             cudaStream_t st) {
  constexpr int kSmem = smem_bytes<T, D>();
  auto dq_kernel = flash_bwd_dq_kernel<T, D>;
  auto dkdv_kernel = flash_bwd_dkdv_kernel<T, D>;
  if (int rc = ptt::fa::allow_smem(dq_kernel, kSmem)) return rc;
  if (int rc = ptt::fa::allow_smem(dkdv_kernel, kSmem)) return rc;
  const dim3 grid_q((Tq + kRows - 1) / kRows, BH);
  dq_kernel<<<grid_q, kThreads, kSmem, st>>>(q, k, v, dout, lse, delta, dq,
                                             Tq, Tk, causal, scale);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  const dim3 grid_k((Tk + kRows - 1) / kRows, BH);
  dkdv_kernel<<<grid_k, kThreads, kSmem, st>>>(q, k, v, dout, lse, delta, dk,
                                               dv, Tq, Tk, causal, scale);
  return static_cast<int>(cudaGetLastError());
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
  if (D != 32 && D != 64) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = static_cast<int64_t>(BH) * Tq;
  constexpr int kWarps = 8;
  flash_bwd_delta_kernel<T><<<(rows + kWarps - 1) / kWarps, 32 * kWarps, 0,
                              st>>>(static_cast<const T*>(out), gg, dd, rows,
                                    D);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (D == 32)
    return launch_d<T, 32>(qq, kk, vv, gg, ll, dd, static_cast<T*>(dq),
                           static_cast<T*>(dk), static_cast<T*>(dv), BH, Tq,
                           Tk, causal, scale, st);
  return launch_d<T, 64>(qq, kk, vv, gg, ll, dd, static_cast<T*>(dq),
                         static_cast<T*>(dk), static_cast<T*>(dv), BH, Tq, Tk,
                         causal, scale, st);
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
  if (int rc = ptt::fa::check_aligned({q, k, v, dout})) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                 bh, tq, tk, head_dim, causal, scale, st);
  return launch<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh, tq,
                       tk, head_dim, causal, scale, st);
}

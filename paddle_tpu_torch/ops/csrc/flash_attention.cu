// FlashAttention-2 forward on the tensor cores: q [BH, Tq, D], k/v
// [BH, Tk, D] -> out [BH, Tq, D] (q's dtype) and lse [BH, Tq] (f32).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py _flash_kernel (reached
// through _flash_forward; on the TPU the library kernel _lib_flash also
// served this call).
//
// Bound on the H100: operations at long T (4 x Tq x Tk x D flops per head,
// halved when causal, against 2 x (Tq + 2 Tk) x D elements moved), bytes
// at short T.  bf16 runs at the 989 TFLOP/s of the bf16 tensor cores.
// f32 runs at a third of the 495 TFLOP/s TF32 rate, since each product
// is three tf32 mmas (3xTF32, flash_mma.cuh): 165 TFLOP/s.
//
// Design (FlashAttention-2): one block of 4 warps per (64-row q tile,
// batch*head); each warp owns 16 query rows.  The grid is issued
// heaviest first: blockIdx.x 0 takes the last q tile, which under a
// causal mask sees the most keys.  Q's tile comes in by cp.async and its
// mma fragments stay in registers for the whole loop (bf16 as loaded; f32
// split once into tf32 hi and lo).  K/V tiles of 64 keys are double
// buffered: tile j + 1 is copied by cp.async while tile j is computed.
// Per tile and warp: S = Q.K^T on the tensor cores (K's fragments through
// ldmatrix); the causal mask and the ragged edge only on tiles that cross
// them; the online softmax on the accumulator fragments, each row's max
// reduced over the 4 lanes of a quad with shuffles, p = exp(s - m) left
// unnormalised (divided by the row sum once, at the end); then O += P.V
// with P taken from the accumulator registers as the A operand (rounded
// to bf16 there for bf16 inputs, split to tf32 hi/lo for f32) and V
// through ldmatrix.trans.  The row sum adds the f32 p.  For f32 each
// k-step's three tf32 products are summed apart and added to S and O with
// FADD (flash_mma.cuh): the forward's rounding reaches the model's
// activations, and with S and O summed straight by the tensor cores one
// FFN weight's gradient in chip_smoke.py's phase 6 (one step on the card
// against the CPU) moved past its limit.  At head_dim 64 the f32 kernel is
// capped at 168 registers, three blocks an SM, and spills about 180 bytes
// there (Q's tf32 hi and lo fragments take 64 registers, the S and O
// accumulators 32 each): ptxas's own choice, 180 registers without a
// spill, runs slower (flash_builds.py times both).
//
// Causal masking is bottom-right aligned (key j is visible to query i when
// j <= i + Tk - Tq); K/V tiles wholly in the masked future of the block
// are never loaded and a warp skips the tiles wholly in its own masked
// future; ragged Tq/Tk are masked in the kernel (rows past the end read as
// zeros), so any length works (prefill goes down to 1 token).  A fully
// masked row gives out 0 and lse -inf, as the TPU kernel does.
//
// Head dims.  The code's width D is a template parameter: 16, 32, 64 and
// 128 are built, and head dim d (a multiple of 8 up to 128) runs the
// least code D >= d (common.cuh head_dim_code): the tile loads zero-fill
// the columns past d in shared memory (cp.async with a zero source size,
// nothing padded on the host), those columns add 0 to every score, and
// only the first d columns of out are stored (`kPad`: a code at its own
// width keeps d a compile-time constant, a narrower d runs an
// instantiation of its own).  The scale is the caller's (1/sqrt(d)).
// f32 at D 128 cannot keep Q's fragments in registers (128 for Q's tf32
// hi and lo beside O's 64 accumulators): that code keeps Q's tile in
// shared memory beside the K/V buffers (five tiles, 165 KB, one block an
// SM) and reads its fragments again for each key tile
// (`q_in_registers`).
// A grid has at most 65535 batch-heads in y; more run in chunks of 65535
// with offset pointers.
//
// Why mma.sync and not wgmma/TMA: one warp-level MMA path serves bf16 and
// 3xTF32 alike (a wgmma tf32 path would need its own operand splitting in
// shared memory), at a fraction of a warp-specialised design's code.  A
// warp-specialised wgmma + TMA pipeline is the next step for the shapes
// that stay above half of their bound (PERF.md section 6).
#include <cstdint>

#include "flash_mma.cuh"

namespace {

using ptt::fa::kRows;
using ptt::fa::kThreads;
using ptt::fa::Tc;

// Whether a code keeps Q's mma fragments in registers for the whole loop:
// all but f32 at D 128, which reads them from Q's tile in shared memory.
template <typename T, int D>
__host__ __device__ constexpr bool q_in_registers() {
  return !(sizeof(T) == 4 && D == 128);
}

// Double-buffered K and V tiles; Q's tile is read once, into registers,
// from K's second buffer before that buffer is first filled (or, without
// `q_in_registers`, kept in a fifth tile of its own).
template <typename T, int D>
constexpr int smem_bytes() {
  return (q_in_registers<T, D>() ? 4 : 5) * kRows * ptt::fa::ld<T, D>() *
         static_cast<int>(sizeof(T));
}

template <typename T, int D, bool kPad>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 && D == 64 ? 3 : 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int Tq, int Tk, int d_in,
                     int causal, float scale) {
  using M = Tc<T>;
  const int d = kPad ? d_in : D;  // the true head dim
  constexpr bool kQReg = q_in_registers<T, D>();
  constexpr int LD = ptt::fa::ld<T, D>();
  constexpr int kTile = kRows * LD;
  constexpr int NB = kRows / 8;  // 8-key accumulator blocks of a tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);  // two buffers
  T* Vs = Ks + 2 * kTile;               // two buffers

  const int64_t bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = q0 + warp * 16;  // the warp's first row
  const int offset = Tk - Tq;
  // keys any row of the block sees
  const int last_row = min(q0 + kRows, Tq) - 1;
  const int kv_end = causal ? min(Tk, last_row + offset + 1) : Tk;
  const int n_kv = kv_end > 0 ? (kv_end + kRows - 1) / kRows : 0;

  const T* kb = k + bh * Tk * d;
  const T* vb = v + bh * Tk * d;
  // tile j goes to buffer j & 1, one commit group per tile (empty past
  // the last): at step j only tile j's group is still in flight
  auto load_kv = [&](int j) {
    if (j < n_kv) {
      ptt::fa::load_tile<T, D>(Ks + (j & 1) * kTile, kb, j * kRows, Tk, d);
      ptt::fa::load_tile<T, D>(Vs + (j & 1) * kTile, vb, j * kRows, Tk, d);
    }
    ptt::fa::cp_async_commit();
  };
  // K's second buffer, free until tile 1 is loaded; or a tile of its own
  T* Qs = kQReg ? Ks + kTile : Vs + 2 * kTile;
  ptt::fa::load_tile<T, D>(Qs, q + bh * Tq * d, q0, Tq, d);
  ptt::fa::cp_async_commit();
  load_kv(0);
  // Q's fragments go to registers once, before the loop, while tile 0 is
  // still in flight
  ptt::fa::cp_async_wait<1>();
  __syncthreads();
  typename M::A qf[kQReg ? D / M::kK : 1];
  if constexpr (kQReg) {
#pragma unroll
    for (int kk = 0; kk < D / M::kK; ++kk)
      qf[kk] = M::load_a(Qs + warp * 16 * LD, LD, kk * M::kK);
    __syncthreads();  // Q's slot may now take tile 1
  }

  const float sl2 = scale * ptt::fa::kLog2e;
  float o[D / 8][4] = {};
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max of raw q.k
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums

  for (int j = 0; j < n_kv; ++j) {
    ptt::fa::cp_async_wait<0>();
    __syncthreads();  // tile j landed for every thread, and every thread
                      // is done with tile j - 1, whose buffer is refilled
    load_kv(j + 1);
    const int k0 = j * kRows;
    const T* Kt = Ks + (j & 1) * kTile;
    const T* Vt = Vs + (j & 1) * kTile;
    // a warp skips a tile wholly in the masked future of its rows
    if (!causal || k0 <= w0 + 15 + offset) {
      float s[NB][4] = {};
      if constexpr (kQReg) {
        ptt::fa::gemm_nt_reg<T, kRows, D, true>(s, qf, Kt, LD);
      } else {
        ptt::fa::gemm_nt<T, kRows, D, true>(s, Qs + warp * 16 * LD, Kt, LD);
      }
      if (k0 + kRows > Tk || (causal && k0 + kRows - 1 > w0 + offset)) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + nb * 8 + 2 * t + (e & 1);
            const int row = w0 + g + 8 * (e >> 1);
            if (col >= Tk || (causal && col > row + offset))
              s[nb][e] = -CUDART_INF_F;
          }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          mx = fmaxf(mx, fmaxf(s[nb][2 * rr], s[nb][2 * rr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[rr], mx);
        // a row that has seen no key yet keeps p = 0 and alpha = 0
        const float base = m_new == -CUDART_INF_F ? 0.f : m_new * sl2;
        const float alpha = ptt::fa::exp2_approx(m[rr] * sl2 - base);
        m[rr] = m_new;
        l[rr] *= alpha;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          o[nd][2 * rr] *= alpha;
          o[nd][2 * rr + 1] *= alpha;
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
            s[nb][e] = ptt::fa::exp2_approx(fmaf(s[nb][e], sl2, -base));
            l[rr] += s[nb][e];
          }
      }
      ptt::fa::gemm_pn<T, kRows, D, true>(o, s, Vt, LD);
    }
  }
  ptt::fa::cp_async_wait<0>();  // no copy outlives the block
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    inv[rr] = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
    const int row = w0 + g + 8 * rr;
    if (t == 0 && row < Tq)
      lse[bh * Tq + row] =
          l[rr] > 0.f ? m[rr] * scale + logf(l[rr]) : -CUDART_INF_F;
  }
  ptt::fa::store_rows<T, D>(out + bh * Tq * d, o, inv, w0, Tq, d);
}

// The most batch-heads one grid takes (gridDim.y).
constexpr int kMaxGridY = 65535;

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, T* out, float* lse, int BH,
             int Tq, int Tk, int d, int causal, float scale,
             cudaStream_t st) {
  constexpr int kSmem = smem_bytes<T, D>();
  auto kernel = d == D ? flash_fwd_kernel<T, D, false>
                       : flash_fwd_kernel<T, D, true>;
  if (int rc = ptt::fa::allow_smem(kernel, kSmem)) return rc;
  for (int b0 = 0; b0 < BH; b0 += kMaxGridY) {
    const int64_t qo = static_cast<int64_t>(b0) * Tq;
    const int64_t ko = static_cast<int64_t>(b0) * Tk * d;
    const dim3 grid((Tq + kRows - 1) / kRows, min(kMaxGridY, BH - b0));
    kernel<<<grid, kThreads, kSmem, st>>>(q + qo * d, k + ko, v + ko,
                                          out + qo * d, lse + qo, Tq, Tk, d,
                                          causal, scale);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  return 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int BH, int Tq, int Tk, int d, int causal, float scale,
           cudaStream_t st) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  float* ll = static_cast<float*>(lse);
  switch (ptt::head_dim_code(d)) {
    case 16:
      return launch_d<T, 16>(qq, kk, vv, oo, ll, BH, Tq, Tk, d, causal,
                             scale, st);
    case 32:
      return launch_d<T, 32>(qq, kk, vv, oo, ll, BH, Tq, Tk, d, causal,
                             scale, st);
    case 64:
      return launch_d<T, 64>(qq, kk, vv, oo, ll, BH, Tq, Tk, d, causal,
                             scale, st);
    case 128:
      return launch_d<T, 128>(qq, kk, vv, oo, ll, BH, Tq, Tk, d, causal,
                              scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int ptt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int bh, int tq, int tk, int head_dim,
                                       int causal, float scale, int is_bf16,
                                       void* stream) {
  if (bh <= 0 || tq <= 0) return cudaSuccess;
  if (int rc = ptt::fa::check_aligned({q, k, v})) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, lse, bh, tq, tk, head_dim,
                                 causal, scale, st);
  return launch<float>(q, k, v, out, lse, bh, tq, tk, head_dim, causal,
                       scale, st);
}

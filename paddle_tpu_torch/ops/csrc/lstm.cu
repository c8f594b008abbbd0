// LSTM recurrence, forward and backward.  Time-major: xs [T, B, 4H] f32
// (pre-projected gate inputs, bias folded in; gates i | f | g | o), w
// [H, 4H] f32 or bf16, h0/c0 [B, H] f32, mask [T, B] f32 (1 live, 0
// padding: a padded step carries h and c through).
//   gates = xs[t] + mm(h_prev) . w             (f32 accumulation)
//   c = f * c_prev + i * g,  h = o * tanh(c),  masked against h/c_prev
// where mm() rounds the operand to bf16 when w is bf16 (program.amp), as
// the Pallas kernels' dots take `.astype(w.dtype)` operands.  The backward
// recomputes the gates from the saved h_prev/c_prev sequences (built by
// the wrapper: [h0, hs[:-1]]), walks t from T - 1 down to 0 and returns
// dxs (= dgates), dw (f32, summed over T), dh0 and dc0.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py _lstm_fwd_kernel
// (_lstm_pallas_fwd) and _lstm_bwd_kernel (_lstm_pallas_bwd).
//
// Bound on the H100: neither bytes nor operations.  At the main path's
// T80 B32 H512 the function moves ~35 MB (~10 us at 3.35 TB/s) and does
// 5.4 GFLOP forward (~80 us at the f32 rate, ~5 us on bf16 tensor cores),
// but step t needs every unit of step t - 1: the time is T times the
// latency of one step (a [B, H] x [H, 4H] product split over the card, the
// gate math, and a grid-wide barrier).
//
// Forward.  On the TPU the grid over T runs in order on one core with w
// in VMEM.  Here one cooperative launch is persistent over T: block k
// owns HB hidden units (HB = 4 at H = 512: 128 blocks on 132 SMs) and
// keeps the 4 * HB columns of w that feed them in shared memory, in w's
// own type, so its gate math stays local.  Per step every block needs all
// of h_prev (the gates are 4H wide and h is H wide, so an exchange of
// partial gates would move 4x the bytes of h: the all-gather stays, made
// cheap):
//   - h is published in the product's precision: for a bf16 w each block
//     also writes its units' h rounded to bf16 (exactly the operand the
//     plain version multiplies) into a two-slot buffer h16 (slot t & 1 is
//     written at step t and read at t + 1: a slot is rewritten only after
//     the barrier that follows every read of it), so every block reads
//     back half the bytes; an f32 w reads the f32 hs of step t - 1;
//   - h_prev is staged into shared memory with 16-byte cp.async copies,
//     each warp the k-range it multiplies, every copy of the step in
//     flight at once and one wait (with the step's x and mask), instead
//     of 4-byte loads whose FMAs wait on them;
//   - the step product [B, H] x [H, 4HB] splits K over the 8 warps, on
//     the tensor cores: mma.sync m16n8k16 for a bf16 w, 3xTF32 m16n8k8 for
//     f32 (about f32's accuracy), each k-step's product summed from zero
//     and added with FADD; the warps' partial tiles go to shared memory
//     and are added in order of warp by the cell math, which needs no
//     shuffle reduction;
//   - a block keeps its own units' h and c in shared memory (no read of
//     c_prev), and `grid.sync()` ends the step.
// The staging and the product are recurrent.cuh's (shared with gru.cu).
// The batch is staged MC rows at a time (MC a multiple of 16, the whole
// batch when the shared memory allows, fewer otherwise).
//
// Backward.  Only dh and dc carry from step to step: the gates'
// pre-activations depend on the saved h_prev alone, and dw on h_prev and
// the dgates of every step.  So one C call enqueues three kernels:
//   1. the gates for all T at once, [T*B, H] x [H, 4H] + xs, into dxs;
//   2. the recurrence, one cooperative launch persistent over T (block k
//      owns HB units as in the forward, keeping the columns of w of its
//      units for every j, [H][4HB]): per step the cell's gradients of its
//      units (dgates written over their gates in dxs, and as a bf16 copy
//      for a bf16 w, dw's operand), the block's share of every unit's
//      dh_prev into an exchange (recurrent.cuh; on the tensor cores,
//      mma.sync m16n8k16, for a bf16 w, on the CUDA cores for f32), one
//      grid-wide barrier, then the shares of its units added in order;
//   3. dw = mm(h_prev)^T . mm(dgates), [H, T*B] x [T*B, 4H].
// 1 and 3 are tiled products on the tensor cores: bf16 mma.sync for a
// bf16 w, 3xTF32 for f32.  Every sum is taken in a fixed order, the
// tensor cores' 16-deep products each added to an f32 sum with FADD, and
// nothing is summed with atomics: runs repeat bit for bit.
//
// Stepwise.  A shape whose persistent grid the card cannot hold (one
// block an SM with its columns of w in shared memory, `persistent_fits`:
// H above 8 x the SMs, e.g. H 2048 on 132 SMs) runs stepwise
// (recurrent.cuh): the forward one launch a step (lstm_fwd_step_kernel:
// grid = the unit blocks x the batch in 32-row blocks, w's columns and
// h_prev streamed per warp), the backward's recurrence one launch a step
// (lstm_bwd_step_kernel: the exchange of step t + 1 gathered, the cell's
// gradients, the share of step t streamed over w's rows; dh and dc
// carried through a [2, B, H] f32 scratch) and a last launch that gathers
// step 0's exchange into dh0.  The gates' and dw's products are the same
// kernels on both paths.  At T80 B32 H2048 a step's product reads w once
// (64 MB in f32, 19 us at 3.35 TB/s; 32 MB in bf16, which the 50 MB L2
// may keep) for 1.07 GFLOP of products.
#include "recurrent_gemm.cuh"

namespace {

using namespace ptt::rnn;

// --- forward -------------------------------------------------------------
//
// Geometry of the step product (host and device agree on it): KP and LDK
// as recurrent.cuh's StepGeom, NP = 4HB rounded up to 16 (the gate
// columns, zero-padded), NR = NP + 4 the row stride of a warp's partial
// tile.
template <typename W, int HB>
struct FwdGeom : StepGeom<W> {
  static constexpr int NP = (4 * HB + 15) / 16 * 16;
  static constexpr int NR = NP + 4;
};

// Shared memory of the forward at MC staged rows: w_s [NP][LDK] and h_s
// [MC][LDK] of w's type, the warps' partial tiles [kWarps][MC][NR], the
// step's x [MC][4HB] and mask [MC], and the units' c and h [B][HB] (f32).
template <typename W, int HB>
size_t fwd_smem(int B, int H, int MC) {
  using G = FwdGeom<W, HB>;
  const size_t ldk = G::ldk(H);
  return align16(G::NP * ldk * sizeof(W)) + align16(MC * ldk * sizeof(W))
         + sizeof(float) * (static_cast<size_t>(kWarps) * MC * G::NR
                            + MC * 4 * HB + MC
                            + 2 * static_cast<size_t>(B) * HB);
}

// One (row, unit) of the forward cell: its gates' pre-activations,
// h_prev, c_prev and the step's mask -> (h, c); both paths' arithmetic.
__device__ __forceinline__ void lstm_cell(const float (&gate)[4],
                                          float h_prev, float c_prev,
                                          float m, float& h, float& c) {
  const float ig = sigmoid(gate[0]), f = sigmoid(gate[1]);
  const float gg = tanhf(gate[2]), o = sigmoid(gate[3]);
  const float c_new = f * c_prev + ig * gg;
  const float h_new = o * tanhf(c_new);
  h = m * h_new + (1.f - m) * h_prev;
  c = m * c_new + (1.f - m) * c_prev;
}

template <typename W, int HB>
__global__ void __launch_bounds__(kThreads)
    lstm_fwd_kernel(const float* __restrict__ xs, const W* __restrict__ w,
                    const float* __restrict__ h0,
                    const float* __restrict__ c0,
                    const float* __restrict__ mask, float* hs, float* cs,
                    __nv_bfloat16* h16, int T, int B, int H, int MC) {
  using Geo = FwdGeom<W, HB>;
  constexpr bool kBf16 = sizeof(W) == 2;
  constexpr int G = 4 * HB, NP = Geo::NP, NR = Geo::NR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kp = Geo::kp(H), ldk = Geo::ldk(H);
  W* w_s = reinterpret_cast<W*>(smem_raw);  // [NP][ldk] the units' columns
  W* h_s = reinterpret_cast<W*>(smem_raw + align16(NP * ldk * sizeof(W)));
  float* red = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(h_s) + align16(MC * ldk * sizeof(W)));
  float* x_s = red + kWarps * MC * NR;  // [MC][G] the step's x
  float* m_s = x_s + MC * G;            // [MC] the step's mask
  float* c_s = m_s + MC;                // [B][HB] the units' c
  float* ho_s = c_s + B * HB;           // [B][HB] the units' h
  const int j0 = blockIdx.x * HB, nu = min(HB, H - j0);
  const int64_t H4 = 4LL * H, BH = static_cast<int64_t>(B) * H;
  // w_s[q * HB + u][k] = w[k][q * H + j0 + u]; 0 past the units and past H
  for (int idx = threadIdx.x; idx < NP * ldk; idx += kThreads) {
    const int n = idx / ldk, k = idx - n * ldk, q = n / HB, u = n - q * HB;
    w_s[idx] = n < G && u < nu && k < H ? w[k * H4 + q * H + j0 + u]
                                        : static_cast<W>(0.f);
  }
  for (int idx = threadIdx.x; idx < B * HB; idx += kThreads) {
    const int b = idx / HB, u = idx - b * HB;
    c_s[idx] = u < nu ? c0[b * H + j0 + u] : 0.f;
    ho_s[idx] = u < nu ? h0[b * H + j0 + u] : 0.f;
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < T; ++t) {
    const float* xt = xs + t * B * H4;
    const float* hf = t ? hs + (t - 1) * BH : h0;
    const __nv_bfloat16* hb =
        kBf16 && t ? h16 + ((t - 1) & 1) * static_cast<int64_t>(B) * kp
                   : nullptr;
    for (int b0 = 0; b0 < B; b0 += MC) {
      const int rows = min(MC, B - b0);
      // the step's x and mask of the rows (4-byte copies), then h_prev
      for (int i = threadIdx.x; i < rows * G; i += kThreads) {
        const int r = i / G, n = i - r * G, q = n / HB, u = n - q * HB;
        if (u < nu)
          ptt::fa::cp_async4(x_s + i, xt + (b0 + r) * H4 + q * H + j0 + u,
                             4);
      }
      for (int r = threadIdx.x; r < rows; r += kThreads)
        ptt::fa::cp_async4(m_s + r, mask + t * B + b0 + r, 4);
      stage_h<W>(h_s, ldk, hf, hb, b0, MC, B, H, kp);
      ptt::fa::cp_async_commit();
      ptt::fa::cp_async_wait<0>();
      __syncwarp();  // the warp's own k-range is staged
      step_product<W, NP>(h_s, w_s, ldk, red, MC, kp);
      __syncthreads();
      // the gates (x + the warps' partial products, added in order of
      // warp) and the cell of each (row, unit)
      for (int i = threadIdx.x; i < rows * nu; i += kThreads) {
        const int r = i / nu, u = i - r * nu, b = b0 + r;
        float gate[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = q * HB + u;
          float s = red[r * NR + n];
#pragma unroll
          for (int wp = 1; wp < kWarps; ++wp) s += red[(wp * MC + r) * NR + n];
          gate[q] = x_s[r * G + n] + s;
        }
        float h, c;
        lstm_cell(gate, ho_s[b * HB + u], c_s[b * HB + u], m_s[r], h, c);
        const int64_t at = static_cast<int64_t>(b) * H + j0 + u;
        hs[t * BH + at] = h;
        cs[t * BH + at] = c;
        ho_s[b * HB + u] = h;
        c_s[b * HB + u] = c;
        if constexpr (kBf16)
          h16[((t & 1) * static_cast<int64_t>(B) + b) * kp + j0 + u] =
              __float2bfloat16(h);
      }
      __syncthreads();
    }
    grid.sync();  // forward step barrier
  }
}

// One launch of the stepwise forward: step t for the block's units and
// its kStepRows rows of the batch (recurrent.cuh `streamed_product`), the
// step's h and c read back from hs and cs (or h0, c0) instead of shared
// memory.  h16 as in lstm_fwd_kernel.
template <typename W, int HB>
__global__ void __launch_bounds__(kThreads)
    lstm_fwd_step_kernel(const float* __restrict__ xs,
                         const W* __restrict__ w,
                         const float* __restrict__ h0,
                         const float* __restrict__ c0,
                         const float* __restrict__ mask, float* hs,
                         float* cs, __nv_bfloat16* h16, int t, int B, int H,
                         int vec) {
  using Geo = FwdGeom<W, HB>;
  using S = Streamed<W, Geo::NP>;
  constexpr bool kBf16 = sizeof(W) == 2;
  constexpr int G = 4 * HB, NP = Geo::NP, NR = Geo::NR, MC = kStepRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* stage = reinterpret_cast<W*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw);  // after the product
  float* x_s = reinterpret_cast<float*>(smem_raw + S::bytes());  // [MC][G]
  float* m_s = x_s + MC * G;                                      // [MC]
  const int kp = Geo::kp(H);
  const int j0 = blockIdx.x * HB, nu = min(HB, H - j0);
  const int b0 = blockIdx.y * MC, rows = min(MC, B - b0);
  const int64_t H4 = 4LL * H, BH = static_cast<int64_t>(B) * H;
  const float* xt = xs + t * B * H4;
  for (int i = threadIdx.x; i < rows * G; i += kThreads) {
    const int r = i / G, n = i - r * G, q = n / HB, u = n - q * HB;
    if (u < nu)
      ptt::fa::cp_async4(x_s + i, xt + (b0 + r) * H4 + q * H + j0 + u, 4);
  }
  for (int r = threadIdx.x; r < rows; r += kThreads)
    ptt::fa::cp_async4(m_s + r, mask + t * B + b0 + r, 4);
  ptt::fa::cp_async_commit();
  const float* hf = t ? hs + (t - 1) * BH : h0;
  const __nv_bfloat16* hb =
      kBf16 && t ? h16 + ((t - 1) & 1) * static_cast<int64_t>(B) * kp
                 : nullptr;
  float acc[2][NP / 8][4] = {};
  streamed_product<W, HB, NP>(acc, stage, w, H4, 0, 4, j0, nu, vec, hf, hb,
                              b0, B, H, kp);
  ptt::fa::cp_async_wait<0>();
  __syncthreads();  // every warp is done with its buffers; x has landed
  store_partials<NP>(acc, red);
  __syncthreads();
  for (int i = threadIdx.x; i < rows * nu; i += kThreads) {
    const int r = i / nu, u = i - r * nu, b = b0 + r;
    float gate[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = q * HB + u;
      float s = red[r * NR + n];
#pragma unroll
      for (int wp = 1; wp < kWarps; ++wp) s += red[(wp * MC + r) * NR + n];
      gate[q] = x_s[r * G + n] + s;
    }
    const int64_t at = static_cast<int64_t>(b) * H + j0 + u;
    float h, c;
    lstm_cell(gate, t ? hs[(t - 1) * BH + at] : h0[at],
              t ? cs[(t - 1) * BH + at] : c0[at], m_s[r], h, c);
    hs[t * BH + at] = h;
    cs[t * BH + at] = c;
    if constexpr (kBf16)
      h16[((t & 1) * static_cast<int64_t>(B) + b) * kp + j0 + u] =
          __float2bfloat16(h);
  }
}

template <typename W, int HB>
size_t fwd_step_smem() {
  return Streamed<W, FwdGeom<W, HB>::NP>::bytes()
         + sizeof(float) * (kStepRows * 4 * HB + kStepRows);
}

// --- backward ------------------------------------------------------------
//
// The products before and after the recurrence are recurrent_gemm.cuh's:
// the gates' pre-activations with cin = xs, A = h_prev [T*B, H] and B = w;
// dw with A^T = h_prev (kAT) and B = dgates [T*B, 4H], split over k and
// summed in order.  In the recurrence, dh_prev[b][j] = sum over n < 4H of
// mm(dgates[b][n]) . w[j][n] goes through recurrent.cuh's exchange: each
// block's share is its own 4HB dgates columns times the matching columns
// of w, a [B, 4HB] x [4HB, H] product.  The exchange buffer has two
// halves, one a step in turn: a block writes one half only after every
// block has passed the barrier that follows its reading of that half.

// Row stride of the bf16 dgates copy (the dw product's operand): 4H in
// whole 16-byte chunks.
__host__ __device__ inline int dg_ld(int H) { return (4 * H + 7) / 8 * 8; }

// Depth of the per-step partial product: the 4HB own columns, padded to
// whole m16n8k16 steps for a bf16 w.
template <typename W, int HB>
__host__ __device__ constexpr int own_k() {
  return sizeof(W) == 2 ? (4 * HB + 15) / 16 * 16 : 4 * HB;
}

// Row stride (elements) of the two operands of the per-step product in
// shared memory: bf16 rows with 16 bytes of padding (ldmatrix rows in
// distinct banks), f32 rows with one word of padding.
template <typename W, int HB>
__host__ __device__ constexpr int own_ld() {
  return sizeof(W) == 2 ? own_k<W, HB>() + 8 : own_k<W, HB>() + 1;
}

// Shared memory of the recurrence: the block's columns of w for every j
// ([roundup(H, 16)][own_ld] of w's type, row j holding w[j][q*H + j0 + u]
// at q*HB + u), its dgates as the product's operand ([roundup(B, 16)]
// [own_ld], same type), the partial sums of the exchange read
// (max(1024, seg) f32), and dh, dc carried to step t - 1 ([B][HB] each).
template <typename W, int HB>
size_t bwd_smem(int B, int H) {
  const size_t ld = own_ld<W, HB>();
  const size_t rows = (H + 15) / 16 * 16 + (B + 15) / 16 * 16;
  const int seg = exchange_seg(B, HB);
  const size_t red = seg > 1024 ? seg : 1024;
  return (rows * ld * sizeof(W) + 15) / 16 * 16
         + sizeof(float) * (red + 2 * static_cast<size_t>(B) * HB);
}

// The cell's gradients of (row b, unit u = j - j0) at step t, both paths:
// from the gates' pre-activations in dxt's row (dgates written over
// them, into the operand dg_s in w's type and, for a bf16 w, into dg16)
// and the carried dh_s, dc_s ([B][HB]), which become (1 - m) dh and the
// dc carried to step t - 1.
template <typename W, int HB>
__device__ __forceinline__ void lstm_cell_grad(
    int b, int u, int j, int t, int B, int H, const float* cp,
    const float* mask, const float* dhs, const float* dcs, float* dxt,
    W* dg_s, __nv_bfloat16* dg16, float* dh_s, float* dc_s) {
  constexpr int LD = own_ld<W, HB>();
  const int64_t BH = static_cast<int64_t>(B) * H, H4 = 4LL * H;
  const int64_t at = static_cast<int64_t>(b) * H + j;
  float* gx = dxt + b * H4 + j;
  const float i = sigmoid(gx[0]), f = sigmoid(gx[H]);
  const float gg = tanhf(gx[2 * H]), o = sigmoid(gx[3 * H]);
  const float c_prev = cp[at];
  const float tc = tanhf(f * c_prev + i * gg);
  const float m = mask[t * B + b];
  const float dh = dhs[t * BH + at] + dh_s[b * HB + u];
  const float dc_out = dcs[t * BH + at] + dc_s[b * HB + u];
  const float dh_new = m * dh;
  const float dc_new = m * dc_out + dh_new * o * (1.f - tc * tc);
  const float d[4] = {dc_new * gg * i * (1.f - i),
                      dc_new * c_prev * f * (1.f - f),
                      dc_new * i * (1.f - gg * gg),
                      dh_new * tc * o * (1.f - o)};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    gx[q * H] = d[q];
    dg_s[b * LD + q * HB + u] = static_cast<W>(d[q]);
    if constexpr (sizeof(W) == 2)
      dg16[(t * B + static_cast<int64_t>(b)) * dg_ld(H) + q * H + j] =
          __float2bfloat16(d[q]);
  }
  dc_s[b * HB + u] = f * dc_new + (1.f - m) * dc_out;
  dh_s[b * HB + u] = (1.f - m) * dh;
}

// One cooperative launch for all T steps, block k owning units
// [k * HB, k * HB + HB).  dxs holds the gates' pre-activations on entry
// (the product before the launch) and dgates on exit.  Per step: the
// cell's gradients of the block's units (dgates written over their gates,
// as a bf16 copy for a bf16 w, and into shared memory as the operand of
// the partial product), the partial product into the exchange, one
// grid-wide barrier, then the exchange read for dh_prev of its units.
template <typename W, int HB>
__global__ void __launch_bounds__(kThreads)
    lstm_bwd_kernel(const W* __restrict__ w, const float* __restrict__ cprev,
                    const float* __restrict__ mask,
                    const float* __restrict__ dhs,
                    const float* __restrict__ dcs, float* dxs,
                    __nv_bfloat16* dg16, float* exch, float* dh0,
                    float* dc0, int T, int B, int H) {
  constexpr int KO = own_k<W, HB>(), LD = own_ld<W, HB>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int j0 = blockIdx.x * HB, nu = min(HB, H - j0);
  const int blocks = gridDim.x, H4 = 4 * H;
  const int64_t BH = static_cast<int64_t>(B) * H;
  const int64_t half = static_cast<int64_t>(blocks) * blocks
                       * exchange_seg(B, HB);
  const int hp = (H + 15) / 16 * 16, bp = (B + 15) / 16 * 16;
  W* wc_s = reinterpret_cast<W*>(smem_raw);
  W* dg_s = wc_s + hp * LD;
  float* red = reinterpret_cast<float*>(
      smem_raw + ((hp + bp) * LD * sizeof(W) + 15) / 16 * 16);
  float* dh_s = red + max(1024, exchange_seg(B, HB));
  float* dc_s = dh_s + B * HB;
  // the block's columns of w, for every j (0 past H, past its units and
  // past 4HB), and a zeroed operand (its padding stays 0)
  for (int idx = threadIdx.x; idx < hp * LD; idx += kThreads) {
    const int j = idx / LD, n = idx - j * LD, q = n / HB, u = n - q * HB;
    wc_s[idx] = j < H && n < 4 * HB && u < nu
        ? w[static_cast<int64_t>(j) * H4 + q * H + j0 + u]
        : static_cast<W>(0.f);
  }
  for (int idx = threadIdx.x; idx < bp * LD; idx += kThreads)
    dg_s[idx] = static_cast<W>(0.f);
  for (int idx = threadIdx.x; idx < B * HB; idx += kThreads)
    dh_s[idx] = dc_s[idx] = 0.f;
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  for (int t = T - 1; t >= 0; --t) {
    const float* cp = cprev + t * BH;
    float* dxt = dxs + t * B * static_cast<int64_t>(H4);
    float* p = exch + (t & 1) * half;
    // the cell's gradients
    for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
      const int b = idx / nu, u = idx - b * nu;
      lstm_cell_grad<W, HB>(b, u, j0 + u, t, B, H, cp, mask, dhs, dcs, dxt,
                            dg_s, dg16, dh_s, dc_s);
    }
    __syncthreads();
    // this block's share of every unit's dh_prev
    exchange_share<W, HB, KO>(dg_s, LD, wc_s, LD, p, blockIdx.x, blocks, B,
                              H);
    grid.sync();  // step barrier
    // dh_prev of the units += the shares of every block
    exchange_gather<HB, true>(p, red, dh_s, blocks, B, nu);
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
    const int b = idx / nu, u = idx - b * nu;
    dh0[b * H + j0 + u] = dh_s[b * HB + u];
    dc0[b * H + j0 + u] = dc_s[b * HB + u];
  }
}

// One launch of the stepwise backward's recurrence, block k owning units
// [k * HB, k * HB + HB) as in lstm_bwd_kernel: the carried dh and dc of
// its units from `carry` ([2][B][H] f32; 0 at t = T - 1), the shares of
// step t + 1's exchange added to dh in order of writer, then (t >= 0) the
// cell's gradients of step t and the block's share of its exchange, with
// w's rows streamed (`streamed_share`), and the carry written back; the
// launch at t = -1 writes dh0 and dc0 instead.
template <typename W, int HB>
__global__ void __launch_bounds__(kThreads)
    lstm_bwd_step_kernel(const W* __restrict__ w,
                         const float* __restrict__ cprev,
                         const float* __restrict__ mask,
                         const float* __restrict__ dhs,
                         const float* __restrict__ dcs, float* dxs,
                         __nv_bfloat16* dg16, float* exch, float* carry,
                         float* dh0, float* dc0, int t, int T, int B, int H,
                         int vec) {
  constexpr int KO = own_k<W, HB>(), LD = own_ld<W, HB>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int j0 = blockIdx.x * HB, nu = min(HB, H - j0);
  const int blocks = gridDim.x;
  const int64_t BH = static_cast<int64_t>(B) * H;
  const int64_t half = static_cast<int64_t>(blocks) * blocks
                       * exchange_seg(B, HB);
  const int bp = (B + 15) / 16 * 16;
  W* dg_s = reinterpret_cast<W*>(smem_raw);
  W* wr_s = dg_s + bp * LD;  // two buffers of kStepJ rows
  float* red = reinterpret_cast<float*>(
      smem_raw + align16((bp + 2 * kStepJ) * LD * sizeof(W)));
  float* dh_s = red + max(1024, exchange_seg(B, HB));
  float* dc_s = dh_s + B * HB;
  for (int idx = threadIdx.x; idx < bp * LD; idx += kThreads)
    dg_s[idx] = static_cast<W>(0.f);
  for (int idx = threadIdx.x; idx < B * HB; idx += kThreads) {
    const int b = idx / HB, u = idx - b * HB;
    const bool in = u < nu && t < T - 1;
    dh_s[idx] = in ? carry[b * H + j0 + u] : 0.f;
    dc_s[idx] = in ? carry[BH + b * H + j0 + u] : 0.f;
  }
  __syncthreads();
  if (t < T - 1) {
    exchange_gather<HB, true>(exch + ((t + 1) & 1) * half, red, dh_s, blocks,
                              B, nu);
    __syncthreads();
  }
  if (t < 0) {
    for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
      const int b = idx / nu, u = idx - b * nu;
      dh0[b * H + j0 + u] = dh_s[b * HB + u];
      dc0[b * H + j0 + u] = dc_s[b * HB + u];
    }
    return;
  }
  float* dxt = dxs + t * B * 4LL * H;
  for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
    const int b = idx / nu, u = idx - b * nu;
    lstm_cell_grad<W, HB>(b, u, j0 + u, t, B, H, cprev + t * BH, mask, dhs,
                          dcs, dxt, dg_s, dg16, dh_s, dc_s);
  }
  __syncthreads();
  streamed_share<W, HB, KO>(dg_s, LD, wr_s, LD, 0, w, 4LL * H, 0, 4, j0, nu,
                            vec, exch + (t & 1) * half, blockIdx.x, blocks,
                            B, H);
  for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
    const int b = idx / nu, u = idx - b * nu;
    carry[b * H + j0 + u] = dh_s[b * HB + u];
    carry[BH + b * H + j0 + u] = dc_s[b * HB + u];
  }
}

template <typename W, int HB>
size_t bwd_step_smem(int B) {
  const int bp = (B + 15) / 16 * 16, seg = exchange_seg(B, HB);
  return align16((bp + 2 * kStepJ) * own_ld<W, HB>() * sizeof(W))
         + sizeof(float) * ((seg > 1024 ? seg : 1024)
                            + 2 * static_cast<size_t>(B) * HB);
}

// Whether the backward's recurrence at B, H takes the persistent path
// (recurrent.cuh persistent_fits).
template <typename W, int HB>
bool bwd_persistent(int B, int H) {
  return persistent_fits(lstm_bwd_kernel<W, HB>, (H + HB - 1) / HB,
                         bwd_smem<W, HB>(B, H));
}

// The backward: enqueue the gates' product (into dxs), the recurrence
// (persistent: check that it can be placed, then one cooperative launch;
// stepwise: T + 1 launches), and dw's product (in S runs of k, summed
// through part, when S > 1).
template <typename W, int HB>
int launch_bwd(const float* xs, const W* w, const float* hprev,
               const float* cprev, const float* mask, const float* dhs,
               const float* dcs, float* dxs, __nv_bfloat16* dg16,
               float* exch, float* dw, float* part, int S, float* dh0,
               float* dc0, float* carry, int stepwise, int T, int B, int H,
               cudaStream_t st) {
  auto kern = lstm_bwd_kernel<W, HB>;
  auto step = lstm_bwd_step_kernel<W, HB>;
  const int blocks = (H + HB - 1) / HB;
  const size_t smem =
      stepwise ? bwd_step_smem<W, HB>(B) : bwd_smem<W, HB>(B, H);
  cudaError_t e = stepwise ? allow_step_smem(step, smem)
                           : place(kern, blocks, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int TB = T * B, H4 = 4 * H;
  launch_gemm<W, false>(hprev, H, w, H4, xs, dxs, H4, 1, TB, H4, H, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (stepwise) {
    const int vec = w_vec<W>(w, HB, H, 0);
    for (int t = T - 1; t >= -1; --t) {
      step<<<blocks, kThreads, smem, st>>>(w, cprev, mask, dhs, dcs, dxs,
                                           dg16, exch, carry, dh0, dc0, t, T,
                                           B, H, vec);
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  } else {
    void* args[] = {&w, &cprev, &mask, &dhs, &dcs, &dxs, &dg16, &exch, &dh0,
                    &dc0, &T, &B, &H};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                    blocks, kThreads, args, smem, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // dgates as the product's operand: the bf16 copy, or dxs itself
  const bool bf = sizeof(W) == 2;
  const W* dg = bf ? reinterpret_cast<const W*>(dg16)
                   : reinterpret_cast<const W*>(dxs);
  launch_gemm<W, true>(hprev, H, dg, bf ? dg_ld(H) : H4, nullptr,
                       S > 1 ? part : dw, H4, S, H, H4, TB, st);
  if (S > 1) launch_sum_splits(part, dw, static_cast<int64_t>(H) * H4, S, st);
  return static_cast<int>(cudaGetLastError());
}

// Rows of the batch the forward stages at once (recurrent.cuh).
template <typename W, int HB>
int fwd_rows(int B, int H) {
  return staged_rows(B, [&](int MC) { return fwd_smem<W, HB>(B, H, MC); });
}

template <typename W>
int fwd_rows(int B, int H) {
  switch (units_per_block(H)) {
    case 1: return fwd_rows<W, 1>(B, H);
    case 2: return fwd_rows<W, 2>(B, H);
    case 4: return fwd_rows<W, 4>(B, H);
    default: return fwd_rows<W, 8>(B, H);
  }
}

// Whether the forward at B, H takes the persistent path.
template <typename W, int HB>
bool fwd_persistent(int B, int H) {
  return persistent_fits(lstm_fwd_kernel<W, HB>, (H + HB - 1) / HB,
                         fwd_smem<W, HB>(B, H, fwd_rows<W, HB>(B, H)));
}

template <typename W, int HB>
int launch_fwd(const float* xs, const W* w, const float* h0, const float* c0,
               const float* mask, float* hs, float* cs, __nv_bfloat16* h16,
               int stepwise, int T, int B, int H, cudaStream_t st) {
  const int blocks = (H + HB - 1) / HB;
  if (stepwise) {
    auto step = lstm_fwd_step_kernel<W, HB>;
    const size_t smem = fwd_step_smem<W, HB>();
    cudaError_t e = allow_step_smem(step, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int vec = w_vec<W>(w, HB, H, 0);
    const dim3 grid(blocks, (B + kStepRows - 1) / kStepRows);
    for (int t = 0; t < T; ++t) {
      step<<<grid, kThreads, smem, st>>>(xs, w, h0, c0, mask, hs, cs, h16, t,
                                         B, H, vec);
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    return 0;
  }
  auto kern = lstm_fwd_kernel<W, HB>;
  int MC = fwd_rows<W, HB>(B, H);
  const size_t smem = fwd_smem<W, HB>(B, H, MC);
  cudaError_t e = place(kern, blocks, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&xs, &w, &h0, &c0, &mask, &hs, &cs, &h16, &T, &B, &H,
                  &MC};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kern), blocks, kThreads, args, smem, st));
}

template <typename W>
int fwd(const void* xs, const void* w, const void* h0, const void* c0,
        const void* mask, void* hs, void* cs, void* h16, int stepwise, int T,
        int B, int H, cudaStream_t st) {
  const float* x = static_cast<const float*>(xs);
  const W* wt = static_cast<const W*>(w);
  const float* h = static_cast<const float*>(h0);
  const float* c = static_cast<const float*>(c0);
  const float* m = static_cast<const float*>(mask);
  float* ho = static_cast<float*>(hs);
  float* co = static_cast<float*>(cs);
  __nv_bfloat16* hb = static_cast<__nv_bfloat16*>(h16);
  switch (units_per_block(H)) {
    case 1: return launch_fwd<W, 1>(x, wt, h, c, m, ho, co, hb, stepwise, T,
                                    B, H, st);
    case 2: return launch_fwd<W, 2>(x, wt, h, c, m, ho, co, hb, stepwise, T,
                                    B, H, st);
    case 4: return launch_fwd<W, 4>(x, wt, h, c, m, ho, co, hb, stepwise, T,
                                    B, H, st);
    default: return launch_fwd<W, 8>(x, wt, h, c, m, ho, co, hb, stepwise,
                                     T, B, H, st);
  }
}

template <typename W>
int bwd(const void* xs, const void* w, const void* hprev, const void* cprev,
        const void* mask, const void* dhs, const void* dcs, void* dxs,
        void* dg16, void* exch, void* dw, void* part, int S, void* dh0,
        void* dc0, void* carry, int stepwise, int T, int B, int H,
        cudaStream_t st) {
  const float* x = static_cast<const float*>(xs);
  const W* wt = static_cast<const W*>(w);
  const float* hp = static_cast<const float*>(hprev);
  const float* cp = static_cast<const float*>(cprev);
  const float* m = static_cast<const float*>(mask);
  const float* gh = static_cast<const float*>(dhs);
  const float* gc = static_cast<const float*>(dcs);
  float* dx = static_cast<float*>(dxs);
  __nv_bfloat16* dg = static_cast<__nv_bfloat16*>(dg16);
  float* ex = static_cast<float*>(exch);
  float* dwo = static_cast<float*>(dw);
  float* pt = static_cast<float*>(part);
  float* dh = static_cast<float*>(dh0);
  float* dc = static_cast<float*>(dc0);
  float* cy = static_cast<float*>(carry);
  switch (units_per_block(H)) {
    case 1: return launch_bwd<W, 1>(x, wt, hp, cp, m, gh, gc, dx, dg, ex, dwo,
                                    pt, S, dh, dc, cy, stepwise, T, B, H, st);
    case 2: return launch_bwd<W, 2>(x, wt, hp, cp, m, gh, gc, dx, dg, ex, dwo,
                                    pt, S, dh, dc, cy, stepwise, T, B, H, st);
    case 4: return launch_bwd<W, 4>(x, wt, hp, cp, m, gh, gc, dx, dg, ex, dwo,
                                    pt, S, dh, dc, cy, stepwise, T, B, H, st);
    default: return launch_bwd<W, 8>(x, wt, hp, cp, m, gh, gc, dx, dg, ex, dwo,
                                     pt, S, dh, dc, cy, stepwise, T, B, H,
                                     st);
  }
}

template <typename W>
void paths(int B, int H, int* fwd_p, int* bwd_p) {
  switch (units_per_block(H)) {
    case 1:
      *fwd_p = fwd_persistent<W, 1>(B, H), *bwd_p = bwd_persistent<W, 1>(B, H);
      break;
    case 2:
      *fwd_p = fwd_persistent<W, 2>(B, H), *bwd_p = bwd_persistent<W, 2>(B, H);
      break;
    case 4:
      *fwd_p = fwd_persistent<W, 4>(B, H), *bwd_p = bwd_persistent<W, 4>(B, H);
      break;
    default:
      *fwd_p = fwd_persistent<W, 8>(B, H), *bwd_p = bwd_persistent<W, 8>(B, H);
  }
}

}  // namespace

// hs, cs [T, B, H] f32 are written for every t.  T, B, H >= 1.  h16, for
// a bf16 w only (null for f32), is [2, B, roundup(H, 16)] bf16 scratch
// whose padding columns are 0: the step's h as the next step's operand.
// stepwise 0: one cooperative launch (refused with
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be placed);
// 1: one launch a step.
extern "C" int ptt_lstm_fwd(const void* xs, const void* w, const void* h0,
                            const void* c0, const void* mask, void* hs,
                            void* cs, void* h16, int T, int B, int H,
                            int w_bf16, int stepwise, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  if (w_bf16 && (h16 == nullptr || reinterpret_cast<uintptr_t>(h16) % 16))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w_bf16 ? fwd<__nv_bfloat16>(xs, w, h0, c0, mask, hs, cs, h16,
                                     stepwise, T, B, H, st)
                : fwd<float>(xs, w, h0, c0, mask, hs, cs, h16, stepwise, T,
                             B, H, st);
}

// *rows: the rows of the batch the forward stages at once at B, H on this
// card (B when the shared memory allows, else fewer, in chunks).
extern "C" int ptt_lstm_fwd_rows(int B, int H, int w_bf16, int* rows) {
  if (B <= 0 || H <= 0 || rows == nullptr) return cudaErrorInvalidValue;
  const int mc =
      w_bf16 ? fwd_rows<__nv_bfloat16>(B, H) : fwd_rows<float>(B, H);
  *rows = mc < B ? mc : B;
  return cudaSuccess;
}

// *fwd, *bwd: 1 where the forward, the backward's recurrence, takes the
// persistent path at B, H on this card, 0 where it runs stepwise
// (recurrent.cuh persistent_fits; the wrappers choose by it).
extern "C" int ptt_lstm_paths(int B, int H, int w_bf16, int* fwd_p,
                              int* bwd_p) {
  if (B <= 0 || H <= 0 || fwd_p == nullptr || bwd_p == nullptr)
    return cudaErrorInvalidValue;
  if (w_bf16)
    paths<__nv_bfloat16>(B, H, fwd_p, bwd_p);
  else
    paths<float>(B, H, fwd_p, bwd_p);
  cudaGetLastError();  // a query refused above only answers "stepwise"
  return cudaSuccess;
}

// hprev/cprev [T, B, H]: the state each step starts from ([h0, hs[:-1]]).
// dxs [T, B, 4H], dw [H, 4H], dh0/dc0 [B, H], all f32, fully written.
// Scratch: dg16 [T, B, dg_ld(H)] bf16 for a bf16 w (unused for f32);
// exch, the exchange of dh_prev's partial sums, of the f32 elements that
// ptt_rnn_exchange_floats gives (recurrent.cuh);
// for dw_splits S > 1 part [S, H, 4H] f32; for stepwise carry [2, B, H]
// f32 (dh and dc between launches).  Three kernels, one call (four with
// S > 1): gates' product, recurrence (one cooperative launch, or T + 1
// launches stepwise), dw's product (and the sum of its S runs).
extern "C" int ptt_lstm_bwd(const void* xs, const void* w, const void* hprev,
                            const void* cprev, const void* mask,
                            const void* dhs, const void* dcs, void* dxs,
                            void* dg16, void* exch, void* dw, void* part,
                            void* dh0, void* dc0, void* carry, int T, int B,
                            int H, int dw_splits, int w_bf16, int stepwise,
                            void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || dw_splits <= 0)
    return cudaErrorInvalidValue;
  if ((w_bf16 && dg16 == nullptr) || exch == nullptr
      || (dw_splits > 1 && part == nullptr)
      || (stepwise && carry == nullptr))
    return cudaErrorInvalidValue;
  for (const void* p : {exch, dw, part})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w_bf16 ? bwd<__nv_bfloat16>(xs, w, hprev, cprev, mask, dhs, dcs,
                                     dxs, dg16, exch, dw, part, dw_splits,
                                     dh0, dc0, carry, stepwise, T, B, H, st)
                : bwd<float>(xs, w, hprev, cprev, mask, dhs, dcs, dxs, dg16,
                             exch, dw, part, dw_splits, dh0, dc0, carry,
                             stepwise, T, B, H, st);
}

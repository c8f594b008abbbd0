// GRU recurrence, forward and backward, each ONE launch for all T steps.
// Time-major: xs [T, B, 3H] f32 (pre-projected inputs, bias folded in;
// gate columns r | z | c, the JAX package's layout), w [H, 3H] f32 or
// bf16, h0 [B, H] f32, mask [T, B] f32 (1 live, 0 padding: a padded step
// carries h through).
//   r, z = sigmoid(xs[t][r|z] + mm(h_prev) . w[:, r|z])
//   c    = tanh(xs[t][c] + mm(r * h_prev) . w[:, c])
//   h    = (1 - z) * h_prev + z * c,  masked against h_prev
// where mm() rounds the operand to bf16 when w is bf16, as the Pallas
// kernels' dots take `.astype(w.dtype)` operands (the op rule applies no
// amp cast to the GRU, so the main path runs f32).  The backward
// recomputes the gates from the saved h_prev sequence (built by the
// wrapper: [h0, hs[:-1]]), walks t from T - 1 down to 0 and returns dxs,
// dw (f32, summed over T) and dh0.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py _gru_fwd_kernel
// (_gru_pallas_fwd) and _gru_bwd_kernel (_gru_pallas_bwd).
//
// Bound on the H100: neither bytes nor operations.  At the main path's
// T80 B32 H512 the function moves ~27 MB and does 4 GFLOP forward
// (~8 us and ~60 us at the f32 rate), but each step waits on the one
// before: the time is T times the latency of a step, and a GRU step has
// two dependent products, since (r * h_prev) . w_c needs r of every unit.
//
// Forward: as lstm.cu, one cooperative launch persistent over T; block k
// owns HB = 8 hidden units (64 blocks at H = 512; `kFwdUnits`) and keeps
// the 3 * HB columns of w that feed them in shared memory, in w's own
// type.  A step has two products over the whole hidden state, each
// followed by a grid-wide barrier: r and z of the block's units from
// h_prev, then c from r * h_prev, which needs r of every unit.  Both are
// recurrent.cuh's staged step product:
//   - the operand is published in the product's precision: for a bf16 w
//     h and r * h_prev are written rounded to bf16 (exactly the operands
//     the plain version multiplies, at half the bytes), for an f32 w in
//     f32 (hs itself, and an [B, H] f32 scratch for r * h_prev);
//   - each product splits K over the 8 warps; each warp stages its own
//     k-range of the operand into shared memory with 16-byte cp.async
//     copies, all in flight at once with the step's x (and mask), waits
//     once and multiplies on the tensor cores: mma.sync m16n8k16 for a
//     bf16 w, 3xTF32 m16n8k8 for an f32 w, each k-step's product summed
//     from zero and added with FADD; the gate math adds the warps'
//     partial tiles in order of warp;
//   - a block keeps its own units' h (the f32 carry) and z in shared
//     memory, so nothing of its own is re-read from device memory.
// Per step: (a) the r|z product, r and z, r * h_prev of the units
// published; barrier 1; (b) the c product, c and h of the units
// published; barrier 2.  The batch is staged MC rows at a time (MC a
// multiple of 16, the whole batch when the shared memory allows, fewer
// otherwise: `ptt_gru_fwd_rows`).
//
// Backward.  Only dh carries from step to step: r, z and c depend on the
// saved h_prev alone, and dw on h_prev and the dgates of every step.  So
// one C call enqueues three stages (counted as one launch):
//   1. before the recurrence, as tiled products over all T
//      (recurrent_gemm.cuh): the r|z pre-activations xs[.., :2H] +
//      mm(h_prev) . w[:, :2H], [T*B, H] x [H, 2H], into dxs; r and z
//      (activated, over them) and rh = r * h_prev into a [T, B, H]
//      scratch; then c's pre-activation xs[.., 2H:] + mm(rh) . w[:, 2H:],
//      [T*B, H] x [H, H], into dxs;
//   2. the recurrence, one cooperative launch persistent over T.  Block k
//      keeps, for every j, the 3 * HB columns of w of its units, in w's
//      type ([H][3HB] with padding).  Per step, two exchanges of partial
//      sums (recurrent.cuh) and two grid barriers:
//        (a) for its units dh = dhs + the carried dh, dc_in and dz_in into
//            dxs, then its share of drh for every j, sum over its units of
//            mm(dc_in) . w_c[j, unit], into exchange 1;  barrier 1;
//        (b) drh of its units gathered in order of writer, dr_in into dxs,
//            the carry (1 - m) dh + dh_new (1 - z) + drh r, then its share
//            of the reference's drz_in . w_rz^T into exchange 2;  barrier 2;
//        (c) exchange 2 of its units gathered into the carry.
//      No block reads another block's dgates.  Each exchange needs one
//      buffer, not two halves: exchange 1 is written in (a) and read in (b)
//      of a step, and the next write, in (a) of step t - 1, comes after
//      barrier 2, which every block passes only after its reading in (b);
//      exchange 2 is written in (b) and read in (c), and its next write
//      comes after barrier 1 of step t - 1, which every block passes only
//      after its (c).  The step's inputs of the block's units (dhs, h_prev,
//      r, z, c) are prefetched one step ahead with cp.async;
//   3. after the recurrence, dw as tiled products: dw[:, :2H] =
//      mm(h_prev)^T . mm(drz_in) and dw[:, 2H:] = mm(rh)^T . mm(dc_in),
//      [H, T*B] x [T*B, .], split over k and summed in order of split.
// The tiled products run on the tensor cores, bf16 mma.sync for a bf16 w
// and 3xTF32 for f32 (each 16- or 8-deep product summed from zero and
// added with FADD); the exchanges' shares run bf16 mma.sync for a bf16 w
// and the CUDA cores for f32.  Every sum is taken in a fixed order and
// nothing is summed with atomics: runs repeat bit for bit.  Shared memory
// is about H * 3HB of w's type plus operands (120 KB at H1024 B32 for an
// f32 w), so H1024 places (HB 8, 128 blocks); H2048 needs 256 blocks, one
// an SM, and runs stepwise.
//
// Stepwise (recurrent.cuh), for the shapes whose persistent grid does not
// fit (`persistent_fits`): the forward two launches a step, the kernel
// boundary in place of each barrier (gru_fwd_rz_kernel: the r|z product,
// r * h_prev published and z kept in a [B, H] f32 scratch;
// gru_fwd_c_kernel: c's product and h), w's columns and the operand
// streamed per warp; the backward's recurrence two launches a step
// (gru_bwd_a_kernel: exchange 2 of step t + 1 gathered into the carry,
// (a) and its share of drh streamed over w's rows; gru_bwd_b_kernel:
// exchange 1 gathered, (b) and its share of drz_in . w_rz^T) and a last
// launch that gathers step 0's exchange 2 into dh0; the carry and the
// part of dh_prev known before the exchanges go through a [2, B, H] f32
// scratch, the step's inputs are read from device memory.
#include "recurrent_gemm.cuh"

namespace {

using namespace ptt::rnn;

// --- forward -------------------------------------------------------------
//
// Geometry of the two step products: NPR = 2HB rounded up to 16 (the r|z
// columns of the block's units, zero-padded), NPC = HB rounded up to 16
// (c's); w_s holds [NPR + NPC] rows of LDK (recurrent.cuh's StepGeom).  A
// warp's partial tile of a product over NP columns has rows of NP + 4
// floats (step_product); NPR >= NPC, so the r|z tile is the larger.
template <typename W, int HB>
struct FwdGeom : StepGeom<W> {
  static constexpr int NPR = (2 * HB + 15) / 16 * 16;
  static constexpr int NPC = (HB + 15) / 16 * 16;
};

// Units a block of the forward owns, at any H: both tiles are 16 columns
// wide for 1 to 8 units, so 8 units cost a block no more product work
// than 4 and halve the blocks that stage all of h twice a step (on an
// H100 at T80 B32 H512, f32 w: 0.99 ms at 8 units, 1.08 at 4, 1.14 at 16).
constexpr int kFwdUnits = 8;

// Shared memory of the forward at MC staged rows: w_s [NPR + NPC][LDK] and
// the staged operand [MC][LDK] of w's type, the warps' partial tiles
// [kWarps][MC][NPR + 4], the step's x of the phase's gates [MC][2HB] and
// mask [MC], and the units' z and h [B][HB] (f32).
template <typename W, int HB>
size_t fwd_smem(int B, int H, int MC) {
  using G = FwdGeom<W, HB>;
  const size_t ldk = G::ldk(H);
  return align16((G::NPR + G::NPC) * ldk * sizeof(W))
         + align16(MC * ldk * sizeof(W))
         + sizeof(float) * (static_cast<size_t>(kWarps) * MC * (G::NPR + 4)
                            + MC * 2 * HB + MC
                            + 2 * static_cast<size_t>(B) * HB);
}

// The sum of the warps' partial tiles at (row r, column n), in order of
// warp; tiles of MC rows of NR floats.
__device__ __forceinline__ float warp_tiles_sum(const float* red, int MC,
                                                int NR, int r, int n) {
  float s = red[r * NR + n];
#pragma unroll
  for (int wp = 1; wp < kWarps; ++wp) s += red[(wp * MC + r) * NR + n];
  return s;
}

// h of one (row, unit) from z, h_prev, c and the step's mask, both paths.
__device__ __forceinline__ float gru_h(float z, float h_prev, float c,
                                       float m) {
  return m * ((1.f - z) * h_prev + z * c) + (1.f - m) * h_prev;
}

// One cooperative launch for all T steps, block k owning units [k * HB,
// k * HB + HB) and the 3HB columns of w that feed them (w_s).  Per step,
// for each run of MC batch rows:
//   (a) h_prev staged (hf: f32 [B, H]; or for a bf16 w h16, [B, kp] bf16),
//       with the step's x of r and z; the r|z product; r and z of the
//       units; r * h_prev (h_prev of the units from ho_s, the f32 carry)
//       published into the scratch in the operand's precision (rhf f32
//       [B, H], or rh16 [B, kp] bf16);
// then forward barrier 1; then for each run of rows:
//   (b) the whole r * h_prev staged, with x of c and the mask; c's
//       product; c and h of the units, written to hs[t] (and h16);
// then forward barrier 2.  One buffer each for r * h_prev and h16 is
// enough: every read of r * h_prev falls between barriers 1 and 2 of a
// step and its writes before barrier 1, and every read of h16 before
// barrier 1 and its writes after it, so no block writes a buffer that
// another block may still be reading.
template <typename W, int HB>
__global__ void __launch_bounds__(kThreads)
    gru_fwd_kernel(const float* __restrict__ xs, const W* __restrict__ w,
                   const float* __restrict__ h0,
                   const float* __restrict__ mask, float* hs, float* rhf,
                   __nv_bfloat16* rh16, __nv_bfloat16* h16, int T, int B,
                   int H, int MC) {
  using Geo = FwdGeom<W, HB>;
  constexpr bool kBf16 = sizeof(W) == 2;
  constexpr int NPR = Geo::NPR, NPC = Geo::NPC;
  constexpr int NRR = NPR + 4, NRC = NPC + 4, G2 = 2 * HB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kp = Geo::kp(H), ldk = Geo::ldk(H);
  W* w_s = reinterpret_cast<W*>(smem_raw);  // [NPR + NPC][ldk]
  W* h_s = reinterpret_cast<W*>(
      smem_raw + align16((NPR + NPC) * ldk * sizeof(W)));  // [MC][ldk]
  float* red = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(h_s) + align16(MC * ldk * sizeof(W)));
  float* x_s = red + kWarps * MC * NRR;  // [MC][2HB] the phase's x
  float* m_s = x_s + MC * G2;            // [MC] the step's mask
  float* z_s = m_s + MC;                 // [B][HB] the units' z
  float* ho_s = z_s + B * HB;            // [B][HB] the units' h
  const int j0 = blockIdx.x * HB, nu = min(HB, H - j0);
  const int64_t H3 = 3LL * H, BH = static_cast<int64_t>(B) * H;
  // w_s[q * HB + u][k] = w[k][q * H + j0 + u] for r, z (q = 0, 1), and
  // w_s[NPR + u][k] = w[k][2H + j0 + u] for c; 0 past the units and past H
  for (int idx = threadIdx.x; idx < (NPR + NPC) * ldk; idx += kThreads) {
    const int n = idx / ldk, k = idx - n * ldk;
    const int q = n < NPR ? n / HB : 2, u = n < NPR ? n % HB : n - NPR;
    const bool in = (n < NPR ? n < G2 : u < HB) && u < nu && k < H;
    w_s[idx] = in ? w[k * H3 + q * H + j0 + u] : static_cast<W>(0.f);
  }
  for (int idx = threadIdx.x; idx < B * HB; idx += kThreads) {
    const int b = idx / HB, u = idx - b * HB;
    ho_s[idx] = u < nu ? h0[b * H + j0 + u] : 0.f;
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < T; ++t) {
    const float* xt = xs + t * B * H3;
    const float* hf = t ? hs + (t - 1) * BH : h0;
    const __nv_bfloat16* hb = kBf16 && t ? h16 : nullptr;
    for (int b0 = 0; b0 < B; b0 += MC) {
      const int rows = min(MC, B - b0);
      // (a) x of r and z (4-byte copies), then h_prev
      for (int i = threadIdx.x; i < rows * G2; i += kThreads) {
        const int r = i / G2, n = i - r * G2, q = n / HB, u = n - q * HB;
        if (u < nu)
          ptt::fa::cp_async4(x_s + i, xt + (b0 + r) * H3 + q * H + j0 + u,
                             4);
      }
      stage_h<W>(h_s, ldk, hf, hb, b0, MC, B, H, kp);
      ptt::fa::cp_async_commit();
      ptt::fa::cp_async_wait<0>();
      __syncwarp();  // the warp's own k-range is staged
      step_product<W, NPR>(h_s, w_s, ldk, red, MC, kp);
      __syncthreads();
      for (int i = threadIdx.x; i < rows * nu; i += kThreads) {
        const int r = i / nu, u = i - r * nu, b = b0 + r;
        const float rg = sigmoid(x_s[r * G2 + u]
                                 + warp_tiles_sum(red, MC, NRR, r, u));
        const float zg = sigmoid(x_s[r * G2 + HB + u]
                                 + warp_tiles_sum(red, MC, NRR, r, HB + u));
        z_s[b * HB + u] = zg;
        const float rh = rg * ho_s[b * HB + u];
        if constexpr (kBf16) {
          rh16[static_cast<int64_t>(b) * kp + j0 + u] = __float2bfloat16(rh);
        } else {
          rhf[static_cast<int64_t>(b) * H + j0 + u] = rh;
        }
      }
      __syncthreads();
    }
    grid.sync();  // forward barrier 1: every unit's r * h_prev is published
    for (int b0 = 0; b0 < B; b0 += MC) {
      const int rows = min(MC, B - b0);
      // (b) x of c and the mask (4-byte copies), then r * h_prev
      for (int i = threadIdx.x; i < rows * HB; i += kThreads) {
        const int r = i / HB, u = i - r * HB;
        if (u < nu)
          ptt::fa::cp_async4(x_s + i, xt + (b0 + r) * H3 + 2 * H + j0 + u,
                             4);
      }
      for (int r = threadIdx.x; r < rows; r += kThreads)
        ptt::fa::cp_async4(m_s + r, mask + t * B + b0 + r, 4);
      stage_h<W>(h_s, ldk, rhf, rh16, b0, MC, B, H, kp);
      ptt::fa::cp_async_commit();
      ptt::fa::cp_async_wait<0>();
      __syncwarp();  // the warp's own k-range is staged
      step_product<W, NPC>(h_s, w_s + NPR * ldk, ldk, red, MC, kp);
      __syncthreads();
      for (int i = threadIdx.x; i < rows * nu; i += kThreads) {
        const int r = i / nu, u = i - r * nu, b = b0 + r;
        const float c =
            tanhf(x_s[r * HB + u] + warp_tiles_sum(red, MC, NRC, r, u));
        const float h = gru_h(z_s[b * HB + u], ho_s[b * HB + u], c, m_s[r]);
        hs[t * BH + static_cast<int64_t>(b) * H + j0 + u] = h;
        ho_s[b * HB + u] = h;
        if constexpr (kBf16)
          h16[static_cast<int64_t>(b) * kp + j0 + u] = __float2bfloat16(h);
      }
      __syncthreads();
    }
    grid.sync();  // forward barrier 2: every unit's h is published
  }
}

// The stepwise forward's two launches of step t, each for the block's
// units and its kStepRows rows of the batch (recurrent.cuh
// `streamed_product`), as (a) and (b) of gru_fwd_kernel: the r|z launch
// publishes r * h_prev (rhf or rh16) and keeps z in zs [B, H] f32; the c
// launch reads them and writes h (hs[t], and h16 for a bf16 w).  h_prev
// is read from hs[t - 1] (or h0).
template <typename W, int HB>
__global__ void __launch_bounds__(kThreads)
    gru_fwd_rz_kernel(const float* __restrict__ xs, const W* __restrict__ w,
                      const float* __restrict__ h0, const float* hs,
                      float* rhf, __nv_bfloat16* rh16,
                      const __nv_bfloat16* h16, float* zs, int t, int B,
                      int H, int vec) {
  using Geo = FwdGeom<W, HB>;
  constexpr int NP = Geo::NPR, NR = NP + 4, G2 = 2 * HB, MC = kStepRows;
  using S = Streamed<W, NP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* stage = reinterpret_cast<W*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw);
  float* x_s = reinterpret_cast<float*>(smem_raw + S::bytes());  // [MC][2HB]
  const int kp = Geo::kp(H);
  const int j0 = blockIdx.x * HB, nu = min(HB, H - j0);
  const int b0 = blockIdx.y * MC, rows = min(MC, B - b0);
  const int64_t H3 = 3LL * H, BH = static_cast<int64_t>(B) * H;
  const float* xt = xs + t * B * H3;
  for (int i = threadIdx.x; i < rows * G2; i += kThreads) {
    const int r = i / G2, n = i - r * G2, q = n / HB, u = n - q * HB;
    if (u < nu)
      ptt::fa::cp_async4(x_s + i, xt + (b0 + r) * H3 + q * H + j0 + u, 4);
  }
  ptt::fa::cp_async_commit();
  const float* hf = t ? hs + (t - 1) * BH : h0;
  float acc[2][NP / 8][4] = {};
  streamed_product<W, HB, NP>(acc, stage, w, H3, 0, 2, j0, nu, vec, hf,
                              sizeof(W) == 2 && t ? h16 : nullptr, b0, B, H,
                              kp);
  ptt::fa::cp_async_wait<0>();
  __syncthreads();
  store_partials<NP>(acc, red);
  __syncthreads();
  for (int i = threadIdx.x; i < rows * nu; i += kThreads) {
    const int r = i / nu, u = i - r * nu, b = b0 + r;
    const int64_t at = static_cast<int64_t>(b) * H + j0 + u;
    const float rg = sigmoid(x_s[r * G2 + u]
                             + warp_tiles_sum(red, MC, NR, r, u));
    const float zg = sigmoid(x_s[r * G2 + HB + u]
                             + warp_tiles_sum(red, MC, NR, r, HB + u));
    zs[at] = zg;
    const float rh = rg * hf[at];
    if constexpr (sizeof(W) == 2) {
      rh16[static_cast<int64_t>(b) * kp + j0 + u] = __float2bfloat16(rh);
    } else {
      rhf[at] = rh;
    }
  }
}

template <typename W, int HB>
__global__ void __launch_bounds__(kThreads)
    gru_fwd_c_kernel(const float* __restrict__ xs, const W* __restrict__ w,
                     const float* __restrict__ h0,
                     const float* __restrict__ mask, float* hs,
                     const float* rhf, const __nv_bfloat16* rh16,
                     __nv_bfloat16* h16, const float* zs, int t, int B, int H,
                     int vec) {
  using Geo = FwdGeom<W, HB>;
  constexpr int NP = Geo::NPC, NR = NP + 4, MC = kStepRows;
  using S = Streamed<W, NP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* stage = reinterpret_cast<W*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw);
  float* x_s = reinterpret_cast<float*>(smem_raw + S::bytes());  // [MC][HB]
  float* m_s = x_s + MC * HB;                                     // [MC]
  const int kp = Geo::kp(H);
  const int j0 = blockIdx.x * HB, nu = min(HB, H - j0);
  const int b0 = blockIdx.y * MC, rows = min(MC, B - b0);
  const int64_t H3 = 3LL * H, BH = static_cast<int64_t>(B) * H;
  const float* xt = xs + t * B * H3;
  for (int i = threadIdx.x; i < rows * HB; i += kThreads) {
    const int r = i / HB, u = i - r * HB;
    if (u < nu)
      ptt::fa::cp_async4(x_s + i, xt + (b0 + r) * H3 + 2 * H + j0 + u, 4);
  }
  for (int r = threadIdx.x; r < rows; r += kThreads)
    ptt::fa::cp_async4(m_s + r, mask + t * B + b0 + r, 4);
  ptt::fa::cp_async_commit();
  float acc[2][NP / 8][4] = {};
  streamed_product<W, HB, NP>(acc, stage, w, H3, 2 * H, 1, j0, nu, vec, rhf,
                              rh16, b0, B, H, kp);
  ptt::fa::cp_async_wait<0>();
  __syncthreads();
  store_partials<NP>(acc, red);
  __syncthreads();
  const float* hf = t ? hs + (t - 1) * BH : h0;
  for (int i = threadIdx.x; i < rows * nu; i += kThreads) {
    const int r = i / nu, u = i - r * nu, b = b0 + r;
    const int64_t at = static_cast<int64_t>(b) * H + j0 + u;
    const float c =
        tanhf(x_s[r * HB + u] + warp_tiles_sum(red, MC, NR, r, u));
    const float h = gru_h(zs[at], hf[at], c, m_s[r]);
    hs[t * BH + at] = h;
    if constexpr (sizeof(W) == 2)
      h16[static_cast<int64_t>(b) * kp + j0 + u] = __float2bfloat16(h);
  }
}

template <typename W, int HB>
size_t fwd_step_smem() {
  using Geo = FwdGeom<W, HB>;
  const size_t rz = Streamed<W, Geo::NPR>::bytes()
                    + sizeof(float) * kStepRows * 2 * HB;
  const size_t c = Streamed<W, Geo::NPC>::bytes()
                   + sizeof(float) * (kStepRows * HB + kStepRows);
  return rz > c ? rz : c;
}

// --- backward ------------------------------------------------------------
//
// Shared memory of the recurrence.  Row j of w_s holds the block's
// columns of w for unit row j: w[j][q*H + j0 + u] at q*HB + u for the r|z
// gates (q = 0, 1, padded to KR columns), then w[j][2H + j0 + u] at KR + u
// for c (padded to KC); a_s holds the batch rows of the block's dgates in
// the same columns (dr_in, dz_in; dc_in), the operands of its two shares.
// bf16: KR and KC are whole m16n8k16 depths and rows carry 16 bytes of
// padding (ldmatrix rows in distinct banks); f32: no padding but one word.
template <typename W, int HB>
struct BwdGeom {
  static constexpr bool kBf16 = sizeof(W) == 2;
  static constexpr int KR = kBf16 ? (2 * HB + 15) / 16 * 16 : 2 * HB;
  static constexpr int KC = kBf16 ? (HB + 15) / 16 * 16 : HB;
  static constexpr int LD = KR + KC + (kBf16 ? 8 : 1);
};

// Row stride of the bf16 dgates copy (the dw products' operand): 3H in
// whole 16-byte chunks.
__host__ __device__ inline int dg_ld(int H) { return (3 * H + 7) / 8 * 8; }

// w_s [roundup(H, 16)][LD] and a_s [roundup(B, 16)][LD] of w's type; the
// exchange read's sums (max(1024, seg) f32); per (row, unit) the carried
// dh, its part known before the exchanges, and drh ([B][HB] f32 each);
// the prefetched inputs of two steps ([2][5][B][HB] f32: dhs, h_prev, r,
// z, c's pre-activation) and their masks ([2][B]).
template <typename W, int HB>
size_t bwd_smem(int B, int H) {
  using G = BwdGeom<W, HB>;
  const size_t rows = (H + 15) / 16 * 16 + (B + 15) / 16 * 16;
  const int seg = exchange_seg(B, HB);
  const size_t red = seg > 1024 ? seg : 1024;
  return (rows * G::LD * sizeof(W) + 15) / 16 * 16
         + sizeof(float) * (red + 13 * static_cast<size_t>(B) * HB + 2 * B);
}

// Prefetch step t's inputs of the block's (row, unit) pairs into in_s
// [5][B][HB] and m_s [B] with 4-byte cp.async copies (committed by the
// caller): dhs[t], h_prev[t] and, from dxs, r, z and c's pre-activation.
__device__ __forceinline__ void prefetch_step(float* in_s, float* m_s,
                                              const float* dhs,
                                              const float* hprev,
                                              const float* dxs,
                                              const float* mask, int t,
                                              int B, int H, int HB, int j0,
                                              int nu) {
  using ptt::fa::cp_async4;
  const int64_t BH = static_cast<int64_t>(B) * H, H3 = 3LL * H;
  for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
    const int b = idx / nu, u = idx - b * nu, j = j0 + u, at = b * HB + u;
    const int64_t hb = t * BH + static_cast<int64_t>(b) * H + j;
    const float* gx = dxs + (static_cast<int64_t>(t) * B + b) * H3 + j;
    cp_async4(in_s + at, dhs + hb, 4);
    cp_async4(in_s + B * HB + at, hprev + hb, 4);
    cp_async4(in_s + 2 * B * HB + at, gx, 4);
    cp_async4(in_s + 3 * B * HB + at, gx + H, 4);
    cp_async4(in_s + 4 * B * HB + at, gx + 2 * H, 4);
  }
  for (int b = threadIdx.x; b < B; b += kThreads)
    cp_async4(m_s + b, mask + t * B + b, 4);
}

// (a) of one (row, unit), both paths: from dhs, the carried dh, h_prev,
// z, c's pre-activation and the mask -> the part of dh_prev known before
// the exchanges, dz_in and dc_in.
__device__ __forceinline__ void gru_grad_a(float dhs_v, float carry,
                                           float h_prev, float z,
                                           float c_pre, float m, float& part,
                                           float& dz_in, float& dc_in) {
  const float c = tanhf(c_pre);
  const float dh = dhs_v + carry;
  const float dh_new = m * dh;
  part = (1.f - m) * dh + dh_new * (1.f - z);
  const float dz = dh_new * (c - h_prev);
  dc_in = dh_new * z * (1.f - c * c);
  dz_in = dz * z * (1.f - z);
}

// (b) of one (row, unit), both paths: dr_in and the carry to step t - 1
// (before exchange 2's shares) from drh, h_prev, r and (a)'s part.
__device__ __forceinline__ void gru_grad_b(float drh, float h_prev, float r,
                                           float part, float& dr_in,
                                           float& carry) {
  dr_in = drh * h_prev * r * (1.f - r);
  carry = part + drh * r;
}

// One cooperative launch for all T steps, block k owning units [k * HB,
// k * HB + HB).  On entry dxs holds r and z (activated) and c's
// pre-activation (the products before the launch); on exit the dgates
// dr_in, dz_in, dc_in.  Per step (a: the units' dc_in, dz_in and the share
// of drh; barrier 1; b: drh gathered, dr_in, the carry's middle terms and
// the share of drz_in . w_rz^T; barrier 2; c: that share gathered into
// the carry).  ex1 and ex2 are [blocks][blocks][seg] f32 each.
template <typename W, int HB>
__global__ void __launch_bounds__(kThreads)
    gru_bwd_kernel(const W* __restrict__ w, const float* __restrict__ hprev,
                   const float* __restrict__ mask,
                   const float* __restrict__ dhs, float* dxs,
                   __nv_bfloat16* dg16, float* ex1, float* ex2, float* dh0,
                   int T, int B, int H) {
  using G = BwdGeom<W, HB>;
  constexpr bool kBf16 = G::kBf16;
  constexpr int KR = G::KR, KC = G::KC, LD = G::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int j0 = blockIdx.x * HB, nu = min(HB, H - j0);
  const int blocks = gridDim.x, ldd = dg_ld(H);
  const int64_t H3 = 3LL * H;
  const int hp = (H + 15) / 16 * 16, bp = (B + 15) / 16 * 16;
  const int BU = B * HB;
  W* w_s = reinterpret_cast<W*>(smem_raw);
  W* a_s = w_s + hp * LD;
  float* red = reinterpret_cast<float*>(
      smem_raw + ((hp + bp) * LD * sizeof(W) + 15) / 16 * 16);
  float* carry_s = red + max(1024, exchange_seg(B, HB));  // dh to step t-1
  float* part_s = carry_s + BU;  // (1 - m) dh + dh_new (1 - z)
  float* drh_s = part_s + BU;
  float* in_s = drh_s + BU;      // [2][5][B][HB]
  float* m_s = in_s + 10 * BU;   // [2][B]
  for (int idx = threadIdx.x; idx < hp * LD; idx += kThreads) {
    const int j = idx / LD, n = idx - j * LD;
    const int q = n < KR ? n / HB : 2, u = n < KR ? n % HB : n - KR;
    const bool in = j < H && u < nu && (n < KR ? n < 2 * HB : u < HB);
    w_s[idx] = in ? w[static_cast<int64_t>(j) * H3 + q * H + j0 + u]
                  : static_cast<W>(0.f);
  }
  for (int idx = threadIdx.x; idx < bp * LD; idx += kThreads)
    a_s[idx] = static_cast<W>(0.f);
  for (int idx = threadIdx.x; idx < BU; idx += kThreads) carry_s[idx] = 0.f;
  prefetch_step(in_s + ((T - 1) & 1) * 5 * BU, m_s + ((T - 1) & 1) * B, dhs,
                hprev, dxs, mask, T - 1, B, H, HB, j0, nu);
  ptt::fa::cp_async_commit();
  cg::grid_group grid = cg::this_grid();
  for (int t = T - 1; t >= 0; --t) {
    float* dxt = dxs + static_cast<int64_t>(t) * B * H3;
    const float* in = in_s + (t & 1) * 5 * BU;
    const float* mt = m_s + (t & 1) * B;
    ptt::fa::cp_async_wait<0>();
    __syncthreads();
    // (a) dc_in and dz_in of the units, then the share of drh
    for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
      const int b = idx / nu, u = idx - b * nu, j = j0 + u, at = b * HB + u;
      float dz_in, dc_in;
      gru_grad_a(in[at], carry_s[at], in[BU + at], in[3 * BU + at],
                 in[4 * BU + at], mt[b], part_s[at], dz_in, dc_in);
      dxt[b * H3 + H + j] = dz_in;
      dxt[b * H3 + 2 * H + j] = dc_in;
      a_s[b * LD + HB + u] = static_cast<W>(dz_in);
      a_s[b * LD + KR + u] = static_cast<W>(dc_in);
      if constexpr (kBf16) {
        __nv_bfloat16* d = dg16 + (static_cast<int64_t>(t) * B + b) * ldd + j;
        d[H] = __float2bfloat16(dz_in);
        d[2 * H] = __float2bfloat16(dc_in);
      }
    }
    __syncthreads();
    exchange_share<W, HB, KC>(a_s + KR, LD, w_s + KR, LD, ex1, blockIdx.x,
                              blocks, B, H);
    grid.sync();  // barrier 1
    // (b) drh of the units, dr_in, and the share of drz_in . w_rz^T
    exchange_gather<HB, false>(ex1, red, drh_s, blocks, B, nu);
    __syncthreads();
    for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
      const int b = idx / nu, u = idx - b * nu, j = j0 + u, at = b * HB + u;
      float dr_in;
      gru_grad_b(drh_s[at], in[BU + at], in[2 * BU + at], part_s[at], dr_in,
                 carry_s[at]);
      dxt[b * H3 + j] = dr_in;
      a_s[b * LD + u] = static_cast<W>(dr_in);
      if constexpr (kBf16)
        dg16[(static_cast<int64_t>(t) * B + b) * ldd + j] =
            __float2bfloat16(dr_in);
    }
    if (t > 0) {
      prefetch_step(in_s + ((t - 1) & 1) * 5 * BU, m_s + ((t - 1) & 1) * B,
                    dhs, hprev, dxs, mask, t - 1, B, H, HB, j0, nu);
      ptt::fa::cp_async_commit();
    }
    __syncthreads();
    exchange_share<W, HB, KR>(a_s, LD, w_s, LD, ex2, blockIdx.x, blocks, B,
                              H);
    grid.sync();  // barrier 2
    // (c) the carry += the shares of every block
    exchange_gather<HB, true>(ex2, red, carry_s, blocks, B, nu);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
    const int b = idx / nu, u = idx - b * nu;
    dh0[b * H + j0 + u] = carry_s[b * HB + u];
  }
}

// The stepwise backward's two launches of step t, block k owning units
// [k * HB, k * HB + HB) as in gru_bwd_kernel; carry is [2][B][H] f32: the
// carried dh, then (a)'s part of dh_prev.  The step's inputs (dhs,
// h_prev, and r, z, c's pre-activation from dxs) are read from device
// memory.  A: the carry of the units with exchange 2 of step t + 1 added
// in order of writer (0 at t = T - 1), then (a) and the share of drh
// into exchange 1, w's c rows streamed; at t = -1 dh0 instead.  B:
// exchange 1 gathered into drh, (b), the carry written, and the share of
// drz_in . w_rz^T into exchange 2, w's r|z rows streamed.
template <typename W, int HB>
__global__ void __launch_bounds__(kThreads)
    gru_bwd_a_kernel(const W* __restrict__ w,
                     const float* __restrict__ hprev,
                     const float* __restrict__ mask,
                     const float* __restrict__ dhs, float* dxs,
                     __nv_bfloat16* dg16, float* ex1, const float* ex2,
                     float* carry, float* dh0, int t, int T, int B, int H,
                     int vec) {
  using G = BwdGeom<W, HB>;
  constexpr int KR = G::KR, KC = G::KC, LD = G::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int j0 = blockIdx.x * HB, nu = min(HB, H - j0);
  const int blocks = gridDim.x, bp = (B + 15) / 16 * 16;
  const int64_t H3 = 3LL * H, BH = static_cast<int64_t>(B) * H;
  W* a_s = reinterpret_cast<W*>(smem_raw);
  W* wr_s = a_s + bp * LD;  // two buffers of kStepJ rows
  float* red = reinterpret_cast<float*>(
      smem_raw + align16((bp + 2 * kStepJ) * LD * sizeof(W)));
  float* carry_s = red + max(1024, exchange_seg(B, HB));  // [B][HB]
  for (int idx = threadIdx.x; idx < bp * LD; idx += kThreads)
    a_s[idx] = static_cast<W>(0.f);
  for (int idx = threadIdx.x; idx < B * HB; idx += kThreads) {
    const int b = idx / HB, u = idx - b * HB;
    carry_s[idx] = u < nu && t < T - 1 ? carry[b * H + j0 + u] : 0.f;
  }
  __syncthreads();
  if (t < T - 1) {
    exchange_gather<HB, true>(ex2, red, carry_s, blocks, B, nu);
    __syncthreads();
  }
  if (t < 0) {
    for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
      const int b = idx / nu, u = idx - b * nu;
      dh0[b * H + j0 + u] = carry_s[b * HB + u];
    }
    return;
  }
  float* dxt = dxs + t * B * H3;
  for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
    const int b = idx / nu, u = idx - b * nu, j = j0 + u;
    const int64_t hb = t * BH + static_cast<int64_t>(b) * H + j;
    float* gx = dxt + b * H3 + j;
    float part, dz_in, dc_in;
    gru_grad_a(dhs[hb], carry_s[b * HB + u], hprev[hb], gx[H], gx[2 * H],
               mask[t * B + b], part, dz_in, dc_in);
    carry[BH + b * H + j] = part;
    gx[H] = dz_in;
    gx[2 * H] = dc_in;
    a_s[b * LD + KR + u] = static_cast<W>(dc_in);
    if constexpr (sizeof(W) == 2) {
      __nv_bfloat16* d = dg16 + (static_cast<int64_t>(t) * B + b) * dg_ld(H)
                         + j;
      d[H] = __float2bfloat16(dz_in);
      d[2 * H] = __float2bfloat16(dc_in);
    }
  }
  __syncthreads();
  streamed_share<W, HB, KC>(a_s + KR, LD, wr_s, LD, KR, w, H3, 2 * H, 1, j0,
                            nu, vec, ex1, blockIdx.x, blocks, B, H);
}

template <typename W, int HB>
__global__ void __launch_bounds__(kThreads)
    gru_bwd_b_kernel(const W* __restrict__ w,
                     const float* __restrict__ hprev, float* dxs,
                     __nv_bfloat16* dg16, const float* ex1, float* ex2,
                     float* carry, int t, int B, int H, int vec) {
  using G = BwdGeom<W, HB>;
  constexpr int KR = G::KR, LD = G::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int j0 = blockIdx.x * HB, nu = min(HB, H - j0);
  const int blocks = gridDim.x, bp = (B + 15) / 16 * 16;
  const int64_t H3 = 3LL * H, BH = static_cast<int64_t>(B) * H;
  W* a_s = reinterpret_cast<W*>(smem_raw);
  W* wr_s = a_s + bp * LD;
  float* red = reinterpret_cast<float*>(
      smem_raw + align16((bp + 2 * kStepJ) * LD * sizeof(W)));
  float* drh_s = red + max(1024, exchange_seg(B, HB));  // [B][HB]
  for (int idx = threadIdx.x; idx < bp * LD; idx += kThreads)
    a_s[idx] = static_cast<W>(0.f);
  exchange_gather<HB, false>(ex1, red, drh_s, blocks, B, nu);
  __syncthreads();
  float* dxt = dxs + t * B * H3;
  for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
    const int b = idx / nu, u = idx - b * nu, j = j0 + u;
    const int64_t at = static_cast<int64_t>(b) * H + j;
    float* gx = dxt + b * H3 + j;
    float dr_in, cy;
    gru_grad_b(drh_s[b * HB + u], hprev[t * BH + at], gx[0], carry[BH + at],
               dr_in, cy);
    carry[at] = cy;
    gx[0] = dr_in;
    a_s[b * LD + u] = static_cast<W>(dr_in);
    a_s[b * LD + HB + u] = static_cast<W>(gx[H]);  // dz_in, from (a)
    if constexpr (sizeof(W) == 2)
      dg16[(static_cast<int64_t>(t) * B + b) * dg_ld(H) + j] =
          __float2bfloat16(dr_in);
  }
  __syncthreads();
  streamed_share<W, HB, KR>(a_s, LD, wr_s, LD, 0, w, H3, 0, 2, j0, nu, vec,
                            ex2, blockIdx.x, blocks, B, H);
}

// Shared memory of either stepwise backward launch.
template <typename W, int HB>
size_t bwd_step_smem(int B) {
  const int bp = (B + 15) / 16 * 16, seg = exchange_seg(B, HB);
  return align16((bp + 2 * kStepJ) * BwdGeom<W, HB>::LD * sizeof(W))
         + sizeof(float) * ((seg > 1024 ? seg : 1024)
                            + static_cast<size_t>(B) * HB);
}

// r = sigmoid(dxs[.., :H]) and z = sigmoid(dxs[.., H:2H]) written over
// their pre-activations, and rh = r * h_prev, for all T * B rows.
__global__ void gru_gates_kernel(float* __restrict__ dxs,
                                 const float* __restrict__ hprev,
                                 float* __restrict__ rh, int64_t rows,
                                 int H) {
  const int64_t n = rows * H, H3 = 3LL * H;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x)
                   + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = i / H, j = i - row * H;
    float* g = dxs + row * H3 + j;
    const float r = sigmoid(g[0]), z = sigmoid(g[H]);
    g[0] = r;
    g[H] = z;
    rh[i] = r * hprev[i];
  }
}

// The backward: enqueue the gates (r|z product, r and z with rh, c's
// product, all into dxs), the recurrence (persistent: check that it can
// be placed, then one cooperative launch; stepwise: 2T + 1 launches), and
// dw's two products (in S runs of k through part, summed after, when
// S > 1).
template <typename W, int HB>
int launch_bwd(const float* xs, const W* w, const float* hprev,
               const float* mask, const float* dhs, float* dxs,
               __nv_bfloat16* dg16, float* exch, float* dw, float* part,
               int S, float* dh0, float* rh, float* carry, int stepwise,
               int T, int B, int H, cudaStream_t st) {
  auto kern = gru_bwd_kernel<W, HB>;
  auto step_a = gru_bwd_a_kernel<W, HB>;
  auto step_b = gru_bwd_b_kernel<W, HB>;
  const int blocks = (H + HB - 1) / HB;
  const size_t smem =
      stepwise ? bwd_step_smem<W, HB>(B) : bwd_smem<W, HB>(B, H);
  cudaError_t e = cudaSuccess;
  if (stepwise) {
    e = allow_step_smem(step_a, smem);
    if (e == cudaSuccess) e = allow_step_smem(step_b, smem);
  } else {
    e = place(kern, blocks, smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int TB = T * B, H2 = 2 * H, H3 = 3 * H;
  launch_gemm<W, false>(hprev, H, w, H3, xs, dxs, H3, 1, TB, H2, H, st);
  gru_gates_kernel<<<264, 256, 0, st>>>(dxs, hprev, rh, TB, H);
  launch_gemm<W, false>(rh, H, w + H2, H3, xs + H2, dxs + H2, H3, 1, TB, H,
                        H, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  float* ex1 = exch;
  float* ex2 = exch + static_cast<int64_t>(blocks) * blocks
                          * exchange_seg(B, HB);
  if (stepwise) {
    // w's rows are copied 16 bytes at a time for a bf16 w of 8 units
    const int vec = w_vec<W>(w, HB, H, 0) && HB == 8;
    for (int t = T - 1; t >= 0; --t) {
      step_a<<<blocks, kThreads, smem, st>>>(w, hprev, mask, dhs, dxs, dg16,
                                             ex1, ex2, carry, dh0, t, T, B,
                                             H, vec);
      step_b<<<blocks, kThreads, smem, st>>>(w, hprev, dxs, dg16, ex1, ex2,
                                             carry, t, B, H, vec);
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    step_a<<<blocks, kThreads, smem, st>>>(w, hprev, mask, dhs, dxs, dg16,
                                           ex1, ex2, carry, dh0, -1, T, B, H,
                                           vec);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    void* args[] = {&w, &hprev, &mask, &dhs, &dxs, &dg16, &ex1, &ex2, &dh0,
                    &T, &B, &H};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                    blocks, kThreads, args, smem, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // the dgates as the products' operand: the bf16 copy, or dxs itself
  const bool bf = sizeof(W) == 2;
  const W* dg = bf ? reinterpret_cast<const W*>(dg16)
                   : reinterpret_cast<const W*>(dxs);
  const int ldg = bf ? dg_ld(H) : H3;
  float* out = S > 1 ? part : dw;
  launch_gemm<W, true>(hprev, H, dg, ldg, nullptr, out, H3, S, H, H2, TB,
                       st);
  launch_gemm<W, true>(rh, H, dg + H2, ldg, nullptr, out + H2, H3, S, H, H,
                       TB, st);
  if (S > 1) launch_sum_splits(part, dw, static_cast<int64_t>(H) * H3, S, st);
  return static_cast<int>(cudaGetLastError());
}

// Rows of the batch the forward stages at once (recurrent.cuh).
template <typename W, int HB>
int fwd_rows(int B, int H) {
  return staged_rows(B, [&](int MC) { return fwd_smem<W, HB>(B, H, MC); });
}

template <typename W, int HB>
int launch_fwd(const float* xs, const W* w, const float* h0,
               const float* mask, float* hs, float* rhf, __nv_bfloat16* rh16,
               __nv_bfloat16* h16, float* zs, int stepwise, int T, int B,
               int H, cudaStream_t st) {
  const int blocks = (H + HB - 1) / HB;
  if (stepwise) {
    auto rz = gru_fwd_rz_kernel<W, HB>;
    auto c = gru_fwd_c_kernel<W, HB>;
    const size_t smem = fwd_step_smem<W, HB>();
    cudaError_t e = allow_step_smem(rz, smem);
    if (e == cudaSuccess) e = allow_step_smem(c, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int vec_rz = w_vec<W>(w, HB, H, 0);
    const int vec_c = w_vec<W>(w, HB, H, 2 * H);
    const dim3 grid(blocks, (B + kStepRows - 1) / kStepRows);
    for (int t = 0; t < T; ++t) {
      rz<<<grid, kThreads, smem, st>>>(xs, w, h0, hs, rhf, rh16, h16, zs, t,
                                       B, H, vec_rz);
      c<<<grid, kThreads, smem, st>>>(xs, w, h0, mask, hs, rhf, rh16, h16,
                                      zs, t, B, H, vec_c);
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    return 0;
  }
  auto kern = gru_fwd_kernel<W, HB>;
  int MC = fwd_rows<W, HB>(B, H);
  const size_t smem = fwd_smem<W, HB>(B, H, MC);
  cudaError_t e = place(kern, blocks, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&xs, &w, &h0, &mask, &hs, &rhf, &rh16, &h16, &T, &B, &H,
                  &MC};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kern), blocks, kThreads, args, smem, st));
}

// rh is r * h_prev's scratch: f32 for an f32 w, bf16 for a bf16 w.
template <typename W>
int fwd(const void* xs, const void* w, const void* h0, const void* mask,
        void* hs, void* rh, void* h16, void* zs, int stepwise, int T, int B,
        int H, cudaStream_t st) {
  constexpr bool kBf16 = sizeof(W) == 2;
  return launch_fwd<W, kFwdUnits>(
      static_cast<const float*>(xs), static_cast<const W*>(w),
      static_cast<const float*>(h0), static_cast<const float*>(mask),
      static_cast<float*>(hs), kBf16 ? nullptr : static_cast<float*>(rh),
      kBf16 ? static_cast<__nv_bfloat16*>(rh) : nullptr,
      static_cast<__nv_bfloat16*>(h16), static_cast<float*>(zs), stepwise, T,
      B, H, st);
}

template <typename W>
int bwd(const void* xs, const void* w, const void* hprev, const void* mask,
        const void* dhs, void* dxs, void* dg16, void* exch, void* dw,
        void* part, int S, void* dh0, void* rh, void* carry, int stepwise,
        int T, int B, int H, cudaStream_t st) {
  const float* x = static_cast<const float*>(xs);
  const W* wt = static_cast<const W*>(w);
  const float* hp = static_cast<const float*>(hprev);
  const float* m = static_cast<const float*>(mask);
  const float* gh = static_cast<const float*>(dhs);
  float* dx = static_cast<float*>(dxs);
  __nv_bfloat16* dg = static_cast<__nv_bfloat16*>(dg16);
  float* ex = static_cast<float*>(exch);
  float* dwo = static_cast<float*>(dw);
  float* pt = static_cast<float*>(part);
  float* dh = static_cast<float*>(dh0);
  float* s = static_cast<float*>(rh);
  float* cy = static_cast<float*>(carry);
  switch (units_per_block(H)) {
    case 1: return launch_bwd<W, 1>(x, wt, hp, m, gh, dx, dg, ex, dwo, pt, S,
                                    dh, s, cy, stepwise, T, B, H, st);
    case 2: return launch_bwd<W, 2>(x, wt, hp, m, gh, dx, dg, ex, dwo, pt, S,
                                    dh, s, cy, stepwise, T, B, H, st);
    case 4: return launch_bwd<W, 4>(x, wt, hp, m, gh, dx, dg, ex, dwo, pt, S,
                                    dh, s, cy, stepwise, T, B, H, st);
    default: return launch_bwd<W, 8>(x, wt, hp, m, gh, dx, dg, ex, dwo, pt,
                                     S, dh, s, cy, stepwise, T, B, H, st);
  }
}

// Whether the backward's recurrence at B, H takes the persistent path.
template <typename W, int HB>
bool bwd_persistent(int B, int H) {
  return persistent_fits(gru_bwd_kernel<W, HB>, (H + HB - 1) / HB,
                         bwd_smem<W, HB>(B, H));
}

template <typename W>
void paths(int B, int H, int* fwd_p, int* bwd_p) {
  *fwd_p = persistent_fits(
      gru_fwd_kernel<W, kFwdUnits>, (H + kFwdUnits - 1) / kFwdUnits,
      fwd_smem<W, kFwdUnits>(B, H, fwd_rows<W, kFwdUnits>(B, H)));
  switch (units_per_block(H)) {
    case 1: *bwd_p = bwd_persistent<W, 1>(B, H); break;
    case 2: *bwd_p = bwd_persistent<W, 2>(B, H); break;
    case 4: *bwd_p = bwd_persistent<W, 4>(B, H); break;
    default: *bwd_p = bwd_persistent<W, 8>(B, H);
  }
}

}  // namespace

// hs [T, B, H] f32 is written for every t.  T, B, H >= 1.  Scratch, the
// step's operands published for every block: rh, r * h_prev, is [B, H]
// f32 for an f32 w, [B, roundup(H, 16)] bf16 for a bf16 w; h16, for a
// bf16 w only (null for f32), is [B, roundup(H, 16)] bf16 (h as the next
// step's operand).  The padding columns of both bf16 buffers are 0 and
// stay 0.  stepwise 0: one cooperative launch (refused with
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be placed); 1:
// two launches a step, with zs [B, H] f32 scratch (z between them).
extern "C" int ptt_gru_fwd(const void* xs, const void* w, const void* h0,
                           const void* mask, void* hs, void* rh, void* h16,
                           void* zs, int T, int B, int H, int w_bf16,
                           int stepwise, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || rh == nullptr
      || (stepwise && zs == nullptr))
    return cudaErrorInvalidValue;
  if (w_bf16 && (h16 == nullptr || reinterpret_cast<uintptr_t>(h16) % 16
                 || reinterpret_cast<uintptr_t>(rh) % 16))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w_bf16 ? fwd<__nv_bfloat16>(xs, w, h0, mask, hs, rh, h16, zs,
                                     stepwise, T, B, H, st)
                : fwd<float>(xs, w, h0, mask, hs, rh, h16, zs, stepwise, T,
                             B, H, st);
}

// *rows: the rows of the batch the forward stages at once at B, H on this
// card (B when the shared memory allows, else fewer, in chunks).
extern "C" int ptt_gru_fwd_rows(int B, int H, int w_bf16, int* rows) {
  if (B <= 0 || H <= 0 || rows == nullptr) return cudaErrorInvalidValue;
  const int mc = w_bf16 ? fwd_rows<__nv_bfloat16, kFwdUnits>(B, H)
                        : fwd_rows<float, kFwdUnits>(B, H);
  *rows = mc < B ? mc : B;
  return cudaSuccess;
}

// *fwd, *bwd: 1 where the forward, the backward's recurrence, takes the
// persistent path at B, H on this card, 0 where it runs stepwise
// (recurrent.cuh persistent_fits; the wrappers choose by it).
extern "C" int ptt_gru_paths(int B, int H, int w_bf16, int* fwd_p,
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

// hprev [T, B, H]: the state each step starts from ([h0, hs[:-1]]).
// dxs [T, B, 3H], dw [H, 3H], dh0 [B, H], all f32, fully written.
// Scratch: rh [T, B, H] f32 (r * h_prev, the c product's and dw's operand);
// dg16 [T, B, dg_ld(H)] bf16 for a bf16 w (unused for f32); exch, the two
// exchanges, of the f32 elements that ptt_rnn_exchange_floats gives
// (recurrent.cuh); for dw_splits S > 1 part [S, H, 3H] f32; for stepwise
// carry [2, B, H] f32.  Seven kernels, one call (six with S == 1): r|z
// product, r, z and rh, c product, recurrence (one cooperative launch, or
// 2T + 1 launches stepwise), dw's two products (and the sum of their S
// runs).
extern "C" int ptt_gru_bwd(const void* xs, const void* w, const void* hprev,
                           const void* mask, const void* dhs, void* dxs,
                           void* dg16, void* exch, void* dw, void* part,
                           void* dh0, void* rh, void* carry, int T, int B,
                           int H, int dw_splits, int w_bf16, int stepwise,
                           void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || dw_splits <= 0)
    return cudaErrorInvalidValue;
  if ((w_bf16 && dg16 == nullptr) || exch == nullptr || rh == nullptr
      || (dw_splits > 1 && part == nullptr)
      || (stepwise && carry == nullptr))
    return cudaErrorInvalidValue;
  for (const void* p : {exch, dw, part})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w_bf16 ? bwd<__nv_bfloat16>(xs, w, hprev, mask, dhs, dxs, dg16,
                                     exch, dw, part, dw_splits, dh0, rh,
                                     carry, stepwise, T, B, H, st)
                : bwd<float>(xs, w, hprev, mask, dhs, dxs, dg16, exch, dw,
                             part, dw_splits, dh0, rh, carry, stepwise, T, B,
                             H, st);
}

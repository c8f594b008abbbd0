// LSTM recurrence, forward and backward, each ONE launch for all T steps.
// Time-major: xs [T, B, 4H] f32 (pre-projected gate inputs, bias folded
// in; gates i | f | g | o), w [H, 4H] f32 or bf16, h0/c0 [B, H] f32, mask
// [T, B] f32 (1 live, 0 padding: a padded step carries h and c through).
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
// Design.  On the TPU the grid over T runs in order on one core with w in
// VMEM.  Here one cooperative launch is persistent over T: block k owns
// HB hidden units (HB = 4 at H = 512: 128 blocks on 132 SMs) and keeps
// the 4 * HB columns of w that feed them in shared memory ([4HB][H] f32,
// 32 KB), so its gate math stays local.  Per step each warp takes R batch
// rows, reads h_prev from L2 and accumulates R x 4HB dot products over
// H (lanes stride over H, then a warp reduction); the cell math runs per
// (row, unit); `grid.sync()` ends the step.  The backward keeps, besides
// those columns, the rows of w of its units ([HB][4H], for
// dh_prev = dgates . w^T) and its dw columns ([4HB][H] f32, summed over T
// in shared memory and written once: no atomics, runs repeat bit for
// bit).  Per step: recompute the gates, the cell's gradients for its
// units (written to dxs[t], and kept rounded for dw), dw += h_prev^T .
// dgates for its columns, then one barrier, after which dh_prev of its
// units reads every unit's dgates from L2.  Tensor cores, TMA and
// clusters are later work.
#include "recurrent.cuh"

namespace {

using namespace ptt::rnn;

template <typename W, int HB>
__global__ void __launch_bounds__(kThreads)
    lstm_fwd_kernel(const float* __restrict__ xs, const W* __restrict__ w,
                    const float* __restrict__ h0,
                    const float* __restrict__ c0,
                    const float* __restrict__ mask, float* hs, float* cs,
                    int T, int B, int H) {
  constexpr int G = 4 * HB;
  constexpr int R = rows_per_warp(G);
  extern __shared__ float smem[];
  float* w_s = smem;            // [G][H] the units' columns of w
  float* g_s = w_s + G * H;     // [B][G] gate pre-activations of a step
  const int j0 = blockIdx.x * HB, nu = min(HB, H - j0);
  const int warp = threadIdx.x >> 5;
  const int64_t H4 = 4LL * H, BH = static_cast<int64_t>(B) * H;
  load_columns<W, HB>(w, H, 4, j0, nu, w_s);
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < T; ++t) {
    const float* hp = t ? hs + (t - 1) * BH : h0;
    const float* cp = t ? cs + (t - 1) * BH : c0;
    const float* xt = xs + t * B * H4;
    for (int b0 = warp * R; b0 < B; b0 += kWarps * R) {
      float acc[R][G];
      warp_rows_dot<W, R, G, true>(hp, H, b0, B, H, w_s, acc);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int n = 0; n < G; ++n) {
          const int b = b0 + r, q = n / HB, u = n % HB;
          if (lane_owns(r, n, G) && b < B && u < nu)
            g_s[b * G + n] = xt[b * H4 + q * H + j0 + u] + acc[r][n];
        }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
      const int b = idx / nu, u = idx - b * nu;
      const int64_t at = static_cast<int64_t>(b) * H + j0 + u;
      const float* g = g_s + b * G;
      const float i = sigmoid(g[u]), f = sigmoid(g[HB + u]);
      const float gg = tanhf(g[2 * HB + u]), o = sigmoid(g[3 * HB + u]);
      const float h_prev = __ldcg(hp + at), c_prev = __ldcg(cp + at);
      const float c_new = f * c_prev + i * gg;
      const float h_new = o * tanhf(c_new);
      const float m = mask[t * B + b];
      hs[t * BH + at] = m * h_new + (1.f - m) * h_prev;
      cs[t * BH + at] = m * c_new + (1.f - m) * c_prev;
    }
    grid.sync();
  }
}

template <typename W, int HB>
__global__ void __launch_bounds__(kThreads)
    lstm_bwd_kernel(const float* __restrict__ xs, const W* __restrict__ w,
                    const float* __restrict__ hprev,
                    const float* __restrict__ cprev,
                    const float* __restrict__ mask,
                    const float* __restrict__ dhs,
                    const float* __restrict__ dcs, float* dxs, float* dw,
                    float* dh0, float* dc0, int T, int B, int H) {
  constexpr int G = 4 * HB;
  constexpr int R = rows_per_warp(G);
  constexpr int RD = rows_per_warp(HB);
  extern __shared__ float smem[];
  float* wc_s = smem;            // [G][H]  the units' columns of w
  float* wr_s = wc_s + G * H;    // [HB][4H] the units' rows of w
  float* dw_s = wr_s + G * H;    // [G][H]  dw of the units' columns
  float* g_s = dw_s + G * H;     // [B][G]  gate pre-activations
  float* dg_s = g_s + B * G;     // [B][G]  dgates as dw's operand
  float* dh_s = dg_s + B * G;    // [B][HB] dh carried to step t - 1
  float* dc_s = dh_s + B * HB;   // [B][HB] dc carried to step t - 1
  const int j0 = blockIdx.x * HB, nu = min(HB, H - j0);
  const int warp = threadIdx.x >> 5;
  const int64_t H4 = 4LL * H, BH = static_cast<int64_t>(B) * H;
  load_columns<W, HB>(w, H, 4, j0, nu, wc_s);
  load_rows<W, HB>(w, H4, 0, 4 * H, j0, nu, wr_s);
  for (int idx = threadIdx.x; idx < G * H; idx += kThreads) dw_s[idx] = 0.f;
  for (int idx = threadIdx.x; idx < B * HB; idx += kThreads)
    dh_s[idx] = dc_s[idx] = 0.f;
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  for (int t = T - 1; t >= 0; --t) {
    const float* hp = hprev + t * BH;
    const float* cp = cprev + t * BH;
    const float* xt = xs + t * B * H4;
    float* dxt = dxs + t * B * H4;
    // 1. recompute the gates of the units
    for (int b0 = warp * R; b0 < B; b0 += kWarps * R) {
      float acc[R][G];
      warp_rows_dot<W, R, G, false>(hp, H, b0, B, H, wc_s, acc);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int n = 0; n < G; ++n) {
          const int b = b0 + r, q = n / HB, u = n % HB;
          if (lane_owns(r, n, G) && b < B && u < nu)
            g_s[b * G + n] = xt[b * H4 + q * H + j0 + u] + acc[r][n];
        }
    }
    __syncthreads();
    // 2. the cell's gradients
    for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
      const int b = idx / nu, u = idx - b * nu, j = j0 + u;
      const int64_t at = static_cast<int64_t>(b) * H + j;
      const float* g = g_s + b * G;
      const float i = sigmoid(g[u]), f = sigmoid(g[HB + u]);
      const float gg = tanhf(g[2 * HB + u]), o = sigmoid(g[3 * HB + u]);
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
        dxt[b * H4 + q * H + j] = d[q];
        dg_s[b * G + q * HB + u] = mm<W>(d[q]);
      }
      dc_s[b * HB + u] = f * dc_new + (1.f - m) * dc_out;
      dh_s[b * HB + u] = (1.f - m) * dh;
    }
    __syncthreads();
    // 3. dw of the units' columns += mm(h_prev)^T . dgates
    for (int k = threadIdx.x; k < H; k += kThreads) {
      float a[G];
#pragma unroll
      for (int n = 0; n < G; ++n) a[n] = 0.f;
      for (int b = 0; b < B; ++b) {
        const float hv = mm<W>(hp[b * H + k]);
#pragma unroll
        for (int n = 0; n < G; ++n) a[n] = fmaf(hv, dg_s[b * G + n], a[n]);
      }
#pragma unroll
      for (int n = 0; n < G; ++n) dw_s[n * H + k] += a[n];
    }
    // every block's dgates of step t are in dxs
    grid.sync();
    // 4. dh_prev of the units += mm(dgates) . w[units, :]^T
    for (int b0 = warp * RD; b0 < B; b0 += kWarps * RD) {
      float acc[RD][HB];
      warp_rows_dot<W, RD, HB, true>(dxt, H4, b0, B, 4 * H, wr_s, acc);
#pragma unroll
      for (int r = 0; r < RD; ++r)
#pragma unroll
        for (int u = 0; u < HB; ++u)
          if (lane_owns(r, u, HB) && b0 + r < B && u < nu)
            dh_s[(b0 + r) * HB + u] += acc[r][u];
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < G * H; idx += kThreads) {
    const int n = idx / H, k = idx - n * H, q = n / HB, u = n % HB;
    if (u < nu) dw[k * H4 + q * H + j0 + u] = dw_s[idx];
  }
  for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
    const int b = idx / nu, u = idx - b * nu;
    dh0[b * H + j0 + u] = dh_s[b * HB + u];
    dc0[b * H + j0 + u] = dc_s[b * HB + u];
  }
}

template <typename W, int HB>
int launch_fwd(const float* xs, const W* w, const float* h0, const float* c0,
               const float* mask, float* hs, float* cs, int T, int B, int H,
               cudaStream_t st) {
  auto kern = lstm_fwd_kernel<W, HB>;
  const int blocks = (H + HB - 1) / HB;
  const size_t smem = sizeof(float) * (4 * HB * static_cast<size_t>(H)
                                       + static_cast<size_t>(B) * 4 * HB);
  cudaError_t e = place(kern, blocks, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&xs, &w, &h0, &c0, &mask, &hs, &cs, &T, &B, &H};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kern), blocks, kThreads, args, smem, st));
}

template <typename W, int HB>
int launch_bwd(const float* xs, const W* w, const float* hprev,
               const float* cprev, const float* mask, const float* dhs,
               const float* dcs, float* dxs, float* dw, float* dh0,
               float* dc0, int T, int B, int H, cudaStream_t st) {
  auto kern = lstm_bwd_kernel<W, HB>;
  const int blocks = (H + HB - 1) / HB;
  const size_t smem = sizeof(float) * (12 * HB * static_cast<size_t>(H)
                                       + static_cast<size_t>(B) * 10 * HB);
  cudaError_t e = place(kern, blocks, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&xs, &w, &hprev, &cprev, &mask, &dhs, &dcs,
                  &dxs, &dw, &dh0, &dc0, &T, &B, &H};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kern), blocks, kThreads, args, smem, st));
}

template <typename W>
int fwd(const void* xs, const void* w, const void* h0, const void* c0,
        const void* mask, void* hs, void* cs, int T, int B, int H,
        cudaStream_t st) {
  const float* x = static_cast<const float*>(xs);
  const W* wt = static_cast<const W*>(w);
  const float* h = static_cast<const float*>(h0);
  const float* c = static_cast<const float*>(c0);
  const float* m = static_cast<const float*>(mask);
  float* ho = static_cast<float*>(hs);
  float* co = static_cast<float*>(cs);
  switch (units_per_block(H)) {
    case 1: return launch_fwd<W, 1>(x, wt, h, c, m, ho, co, T, B, H, st);
    case 2: return launch_fwd<W, 2>(x, wt, h, c, m, ho, co, T, B, H, st);
    case 4: return launch_fwd<W, 4>(x, wt, h, c, m, ho, co, T, B, H, st);
    default: return launch_fwd<W, 8>(x, wt, h, c, m, ho, co, T, B, H, st);
  }
}

template <typename W>
int bwd(const void* xs, const void* w, const void* hprev, const void* cprev,
        const void* mask, const void* dhs, const void* dcs, void* dxs,
        void* dw, void* dh0, void* dc0, int T, int B, int H,
        cudaStream_t st) {
  const float* x = static_cast<const float*>(xs);
  const W* wt = static_cast<const W*>(w);
  const float* hp = static_cast<const float*>(hprev);
  const float* cp = static_cast<const float*>(cprev);
  const float* m = static_cast<const float*>(mask);
  const float* gh = static_cast<const float*>(dhs);
  const float* gc = static_cast<const float*>(dcs);
  float* dx = static_cast<float*>(dxs);
  float* dwo = static_cast<float*>(dw);
  float* dh = static_cast<float*>(dh0);
  float* dc = static_cast<float*>(dc0);
  switch (units_per_block(H)) {
    case 1: return launch_bwd<W, 1>(x, wt, hp, cp, m, gh, gc, dx, dwo, dh,
                                    dc, T, B, H, st);
    case 2: return launch_bwd<W, 2>(x, wt, hp, cp, m, gh, gc, dx, dwo, dh,
                                    dc, T, B, H, st);
    case 4: return launch_bwd<W, 4>(x, wt, hp, cp, m, gh, gc, dx, dwo, dh,
                                    dc, T, B, H, st);
    default: return launch_bwd<W, 8>(x, wt, hp, cp, m, gh, gc, dx, dwo, dh,
                                     dc, T, B, H, st);
  }
}

}  // namespace

// hs, cs [T, B, H] f32 are written for every t.  T, B, H >= 1.
extern "C" int ptt_lstm_fwd(const void* xs, const void* w, const void* h0,
                            const void* c0, const void* mask, void* hs,
                            void* cs, int T, int B, int H, int w_bf16,
                            void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w_bf16 ? fwd<__nv_bfloat16>(xs, w, h0, c0, mask, hs, cs, T, B, H, st)
                : fwd<float>(xs, w, h0, c0, mask, hs, cs, T, B, H, st);
}

// hprev/cprev [T, B, H]: the state each step starts from ([h0, hs[:-1]]).
// dxs [T, B, 4H], dw [H, 4H], dh0/dc0 [B, H], all f32, fully written.
extern "C" int ptt_lstm_bwd(const void* xs, const void* w, const void* hprev,
                            const void* cprev, const void* mask,
                            const void* dhs, const void* dcs, void* dxs,
                            void* dw, void* dh0, void* dc0, int T, int B,
                            int H, int w_bf16, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w_bf16 ? bwd<__nv_bfloat16>(xs, w, hprev, cprev, mask, dhs, dcs, dxs,
                                     dw, dh0, dc0, T, B, H, st)
                : bwd<float>(xs, w, hprev, cprev, mask, dhs, dcs, dxs, dw,
                             dh0, dc0, T, B, H, st);
}

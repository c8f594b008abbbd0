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
// Design: as lstm.cu, one cooperative launch persistent over T; block k
// owns HB hidden units and keeps the 3 * HB columns of w that feed them in
// shared memory.  Forward, per step: r and z of its units from h_prev
// (L2), r * h_prev of its units into a [B, H] scratch, a grid barrier,
// then c of its units from the whole scratch, h, and a second barrier.
// The backward also keeps the rows of w of its units ([HB][3H], for the
// products with w^T) and its dw columns ([3HB][H] f32, summed over T in
// shared memory and written once: no atomics).  Per step it needs three
// barriers: after r * h_prev (the recomputed c needs every unit), after
// dc_in (drh = dc_in . w_c^T needs every unit) and after dr_in/dz_in (the
// last term of dh_prev, drz_in . w_rz^T).  dw's candidate columns read
// the scratch before the third barrier, after which another block may
// overwrite it for step t - 1.
#include "recurrent.cuh"

namespace {

using namespace ptt::rnn;

template <typename W, int HB>
__global__ void __launch_bounds__(kThreads)
    gru_fwd_kernel(const float* __restrict__ xs, const W* __restrict__ w,
                   const float* __restrict__ h0,
                   const float* __restrict__ mask, float* hs, float* rh,
                   int T, int B, int H) {
  constexpr int G = 3 * HB;
  constexpr int RZ = 2 * HB;
  constexpr int R2 = rows_per_warp(RZ);
  constexpr int R1 = rows_per_warp(HB);
  extern __shared__ float smem[];
  float* w_s = smem;             // [G][H]  the units' columns: r, z, c
  float* rz_s = w_s + G * H;     // [B][2HB] r and z of the units
  float* c_s = rz_s + B * RZ;    // [B][HB]  c of the units
  const int j0 = blockIdx.x * HB, nu = min(HB, H - j0);
  const int warp = threadIdx.x >> 5;
  const int64_t H3 = 3LL * H, BH = static_cast<int64_t>(B) * H;
  load_columns<W, HB>(w, H, 3, j0, nu, w_s);
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < T; ++t) {
    const float* hp = t ? hs + (t - 1) * BH : h0;
    const float* xt = xs + t * B * H3;
    for (int b0 = warp * R2; b0 < B; b0 += kWarps * R2) {
      float acc[R2][RZ];
      warp_rows_dot<W, R2, RZ, true>(hp, H, b0, B, H, w_s, acc);
#pragma unroll
      for (int r = 0; r < R2; ++r)
#pragma unroll
        for (int n = 0; n < RZ; ++n) {
          const int b = b0 + r, q = n / HB, u = n % HB;
          if (lane_owns(r, n, RZ) && b < B && u < nu)
            rz_s[b * RZ + n] =
                sigmoid(xt[b * H3 + q * H + j0 + u] + acc[r][n]);
        }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
      const int b = idx / nu, u = idx - b * nu;
      const int64_t at = static_cast<int64_t>(b) * H + j0 + u;
      rh[at] = rz_s[b * RZ + u] * __ldcg(hp + at);
    }
    // every unit's r * h_prev is in the scratch
    grid.sync();
    for (int b0 = warp * R1; b0 < B; b0 += kWarps * R1) {
      float acc[R1][HB];
      warp_rows_dot<W, R1, HB, true>(rh, H, b0, B, H, w_s + RZ * H, acc);
#pragma unroll
      for (int r = 0; r < R1; ++r)
#pragma unroll
        for (int u = 0; u < HB; ++u) {
          const int b = b0 + r;
          if (lane_owns(r, u, HB) && b < B && u < nu)
            c_s[b * HB + u] =
                tanhf(xt[b * H3 + 2 * H + j0 + u] + acc[r][u]);
        }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
      const int b = idx / nu, u = idx - b * nu;
      const int64_t at = static_cast<int64_t>(b) * H + j0 + u;
      const float z = rz_s[b * RZ + HB + u], c = c_s[b * HB + u];
      const float h_prev = __ldcg(hp + at);
      const float m = mask[t * B + b];
      hs[t * BH + at] = m * ((1.f - z) * h_prev + z * c) + (1.f - m) * h_prev;
    }
    grid.sync();
  }
}

template <typename W, int HB>
__global__ void __launch_bounds__(kThreads)
    gru_bwd_kernel(const float* __restrict__ xs, const W* __restrict__ w,
                   const float* __restrict__ hprev,
                   const float* __restrict__ mask,
                   const float* __restrict__ dhs, float* dxs, float* dw,
                   float* dh0, float* rh, int T, int B, int H) {
  constexpr int G = 3 * HB;
  constexpr int RZ = 2 * HB;
  constexpr int R2 = rows_per_warp(RZ);
  constexpr int R1 = rows_per_warp(HB);
  extern __shared__ float smem[];
  float* wc_s = smem;             // [G][H]   the units' columns: r, z, c
  float* wrc_s = wc_s + G * H;    // [HB][H]  w[units, c columns]
  float* wrz_s = wrc_s + HB * H;  // [HB][2H] w[units, r|z columns]
  float* dw_s = wrz_s + RZ * H;   // [G][H]   dw of the units' columns
  float* rz_s = dw_s + G * H;     // [B][2HB] r and z
  float* c_s = rz_s + B * RZ;     // [B][HB]  c
  float* dg_s = c_s + B * HB;     // [B][G]   dr_in, dz_in, dc_in for dw
  float* dz_s = dg_s + B * G;     // [B][HB]  dz
  float* dh_s = dz_s + B * HB;    // [B][HB]  dh carried to step t - 1
  const int j0 = blockIdx.x * HB, nu = min(HB, H - j0);
  const int warp = threadIdx.x >> 5;
  const int64_t H3 = 3LL * H, BH = static_cast<int64_t>(B) * H;
  load_columns<W, HB>(w, H, 3, j0, nu, wc_s);
  load_rows<W, HB>(w, H3, 2 * H, H, j0, nu, wrc_s);
  load_rows<W, HB>(w, H3, 0, 2 * H, j0, nu, wrz_s);
  for (int idx = threadIdx.x; idx < G * H; idx += kThreads) dw_s[idx] = 0.f;
  for (int idx = threadIdx.x; idx < B * HB; idx += kThreads) dh_s[idx] = 0.f;
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  for (int t = T - 1; t >= 0; --t) {
    const float* hp = hprev + t * BH;
    const float* xt = xs + t * B * H3;
    float* dxt = dxs + t * B * H3;
    // 1. r and z of the units, then their r * h_prev into the scratch
    for (int b0 = warp * R2; b0 < B; b0 += kWarps * R2) {
      float acc[R2][RZ];
      warp_rows_dot<W, R2, RZ, false>(hp, H, b0, B, H, wc_s, acc);
#pragma unroll
      for (int r = 0; r < R2; ++r)
#pragma unroll
        for (int n = 0; n < RZ; ++n) {
          const int b = b0 + r, q = n / HB, u = n % HB;
          if (lane_owns(r, n, RZ) && b < B && u < nu)
            rz_s[b * RZ + n] =
                sigmoid(xt[b * H3 + q * H + j0 + u] + acc[r][n]);
        }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
      const int b = idx / nu, u = idx - b * nu;
      const int64_t at = static_cast<int64_t>(b) * H + j0 + u;
      rh[at] = rz_s[b * RZ + u] * hp[at];
    }
    grid.sync();
    // 2. c of the units from every unit's r * h_prev
    for (int b0 = warp * R1; b0 < B; b0 += kWarps * R1) {
      float acc[R1][HB];
      warp_rows_dot<W, R1, HB, true>(rh, H, b0, B, H, wc_s + RZ * H, acc);
#pragma unroll
      for (int r = 0; r < R1; ++r)
#pragma unroll
        for (int u = 0; u < HB; ++u) {
          const int b = b0 + r;
          if (lane_owns(r, u, HB) && b < B && u < nu)
            c_s[b * HB + u] =
                tanhf(xt[b * H3 + 2 * H + j0 + u] + acc[r][u]);
        }
    }
    __syncthreads();
    // 3. dc_in of the units (into dxs), dz, and dh_prev's first terms
    for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
      const int b = idx / nu, u = idx - b * nu, j = j0 + u;
      const int64_t at = static_cast<int64_t>(b) * H + j;
      const float z = rz_s[b * RZ + HB + u], c = c_s[b * HB + u];
      const float h_prev = hp[at];
      const float m = mask[t * B + b];
      const float dh = dhs[t * BH + at] + dh_s[b * HB + u];
      const float dh_new = m * dh;
      const float dc_in = dh_new * z * (1.f - c * c);
      dxt[b * H3 + 2 * H + j] = dc_in;
      dg_s[b * G + RZ + u] = mm<W>(dc_in);
      dz_s[b * HB + u] = dh_new * (c - h_prev);
      dh_s[b * HB + u] = (1.f - m) * dh + dh_new * (1.f - z);
    }
    __syncthreads();
    // 4. dw of the units' c columns += mm(r * h_prev)^T . dc_in, while the
    //    scratch still holds step t
    for (int k = threadIdx.x; k < H; k += kThreads) {
      float a[HB];
#pragma unroll
      for (int u = 0; u < HB; ++u) a[u] = 0.f;
      for (int b = 0; b < B; ++b) {
        const float v = mm<W>(__ldcg(rh + b * H + k));
#pragma unroll
        for (int u = 0; u < HB; ++u)
          a[u] = fmaf(v, dg_s[b * G + RZ + u], a[u]);
      }
#pragma unroll
      for (int u = 0; u < HB; ++u) dw_s[(RZ + u) * H + k] += a[u];
    }
    // every block's dc_in of step t is in dxs
    grid.sync();
    // 5. drh = mm(dc_in) . w[units, c]^T, then dr_in and dz_in (into dxs)
    for (int b0 = warp * R1; b0 < B; b0 += kWarps * R1) {
      float acc[R1][HB];
      warp_rows_dot<W, R1, HB, true>(dxt + 2 * H, H3, b0, B, H, wrc_s, acc);
#pragma unroll
      for (int r = 0; r < R1; ++r)
#pragma unroll
        for (int u = 0; u < HB; ++u) {
          const int b = b0 + r, j = j0 + u;
          if (!(lane_owns(r, u, HB) && b < B && u < nu)) continue;
          const float rr = rz_s[b * RZ + u], z = rz_s[b * RZ + HB + u];
          const float drh = acc[r][u];
          const float h_prev = hp[static_cast<int64_t>(b) * H + j];
          dh_s[b * HB + u] += drh * rr;
          const float dr_in = drh * h_prev * rr * (1.f - rr);
          const float dz_in = dz_s[b * HB + u] * z * (1.f - z);
          dxt[b * H3 + j] = dr_in;
          dxt[b * H3 + H + j] = dz_in;
          dg_s[b * G + u] = mm<W>(dr_in);
          dg_s[b * G + HB + u] = mm<W>(dz_in);
        }
    }
    __syncthreads();
    // 6. dw of the units' r and z columns += mm(h_prev)^T . drz_in
    for (int k = threadIdx.x; k < H; k += kThreads) {
      float a[RZ];
#pragma unroll
      for (int n = 0; n < RZ; ++n) a[n] = 0.f;
      for (int b = 0; b < B; ++b) {
        const float v = mm<W>(hp[b * H + k]);
#pragma unroll
        for (int n = 0; n < RZ; ++n) a[n] = fmaf(v, dg_s[b * G + n], a[n]);
      }
#pragma unroll
      for (int n = 0; n < RZ; ++n) dw_s[n * H + k] += a[n];
    }
    // every block's dr_in and dz_in of step t are in dxs
    grid.sync();
    // 7. dh_prev += mm(drz_in) . w[units, r|z]^T
    for (int b0 = warp * R1; b0 < B; b0 += kWarps * R1) {
      float acc[R1][HB];
      warp_rows_dot<W, R1, HB, true>(dxt, H3, b0, B, 2 * H, wrz_s, acc);
#pragma unroll
      for (int r = 0; r < R1; ++r)
#pragma unroll
        for (int u = 0; u < HB; ++u)
          if (lane_owns(r, u, HB) && b0 + r < B && u < nu)
            dh_s[(b0 + r) * HB + u] += acc[r][u];
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < G * H; idx += kThreads) {
    const int n = idx / H, k = idx - n * H, q = n / HB, u = n % HB;
    if (u < nu) dw[k * H3 + q * H + j0 + u] = dw_s[idx];
  }
  for (int idx = threadIdx.x; idx < B * nu; idx += kThreads) {
    const int b = idx / nu, u = idx - b * nu;
    dh0[b * H + j0 + u] = dh_s[b * HB + u];
  }
}

template <typename W, int HB>
int launch_fwd(const float* xs, const W* w, const float* h0,
               const float* mask, float* hs, float* rh, int T, int B, int H,
               cudaStream_t st) {
  auto kern = gru_fwd_kernel<W, HB>;
  const int blocks = (H + HB - 1) / HB;
  const size_t smem = sizeof(float) * (3 * HB * static_cast<size_t>(H)
                                       + static_cast<size_t>(B) * 3 * HB);
  cudaError_t e = place(kern, blocks, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&xs, &w, &h0, &mask, &hs, &rh, &T, &B, &H};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kern), blocks, kThreads, args, smem, st));
}

template <typename W, int HB>
int launch_bwd(const float* xs, const W* w, const float* hprev,
               const float* mask, const float* dhs, float* dxs, float* dw,
               float* dh0, float* rh, int T, int B, int H, cudaStream_t st) {
  auto kern = gru_bwd_kernel<W, HB>;
  const int blocks = (H + HB - 1) / HB;
  const size_t smem = sizeof(float) * (9 * HB * static_cast<size_t>(H)
                                       + static_cast<size_t>(B) * 8 * HB);
  cudaError_t e = place(kern, blocks, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&xs, &w, &hprev, &mask, &dhs, &dxs, &dw, &dh0, &rh,
                  &T, &B, &H};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kern), blocks, kThreads, args, smem, st));
}

template <typename W>
int fwd(const void* xs, const void* w, const void* h0, const void* mask,
        void* hs, void* rh, int T, int B, int H, cudaStream_t st) {
  const float* x = static_cast<const float*>(xs);
  const W* wt = static_cast<const W*>(w);
  const float* h = static_cast<const float*>(h0);
  const float* m = static_cast<const float*>(mask);
  float* ho = static_cast<float*>(hs);
  float* s = static_cast<float*>(rh);
  switch (units_per_block(H)) {
    case 1: return launch_fwd<W, 1>(x, wt, h, m, ho, s, T, B, H, st);
    case 2: return launch_fwd<W, 2>(x, wt, h, m, ho, s, T, B, H, st);
    case 4: return launch_fwd<W, 4>(x, wt, h, m, ho, s, T, B, H, st);
    default: return launch_fwd<W, 8>(x, wt, h, m, ho, s, T, B, H, st);
  }
}

template <typename W>
int bwd(const void* xs, const void* w, const void* hprev, const void* mask,
        const void* dhs, void* dxs, void* dw, void* dh0, void* rh, int T,
        int B, int H, cudaStream_t st) {
  const float* x = static_cast<const float*>(xs);
  const W* wt = static_cast<const W*>(w);
  const float* hp = static_cast<const float*>(hprev);
  const float* m = static_cast<const float*>(mask);
  const float* gh = static_cast<const float*>(dhs);
  float* dx = static_cast<float*>(dxs);
  float* dwo = static_cast<float*>(dw);
  float* dh = static_cast<float*>(dh0);
  float* s = static_cast<float*>(rh);
  switch (units_per_block(H)) {
    case 1: return launch_bwd<W, 1>(x, wt, hp, m, gh, dx, dwo, dh, s, T, B,
                                    H, st);
    case 2: return launch_bwd<W, 2>(x, wt, hp, m, gh, dx, dwo, dh, s, T, B,
                                    H, st);
    case 4: return launch_bwd<W, 4>(x, wt, hp, m, gh, dx, dwo, dh, s, T, B,
                                    H, st);
    default: return launch_bwd<W, 8>(x, wt, hp, m, gh, dx, dwo, dh, s, T, B,
                                     H, st);
  }
}

}  // namespace

// hs [T, B, H] f32 is written for every t; rh is [B, H] f32 scratch.
extern "C" int ptt_gru_fwd(const void* xs, const void* w, const void* h0,
                           const void* mask, void* hs, void* rh, int T,
                           int B, int H, int w_bf16, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w_bf16 ? fwd<__nv_bfloat16>(xs, w, h0, mask, hs, rh, T, B, H, st)
                : fwd<float>(xs, w, h0, mask, hs, rh, T, B, H, st);
}

// hprev [T, B, H]: the state each step starts from ([h0, hs[:-1]]).
// dxs [T, B, 3H], dw [H, 3H], dh0 [B, H], all f32, fully written; rh is
// [B, H] f32 scratch.
extern "C" int ptt_gru_bwd(const void* xs, const void* w, const void* hprev,
                           const void* mask, const void* dhs, void* dxs,
                           void* dw, void* dh0, void* rh, int T, int B,
                           int H, int w_bf16, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w_bf16 ? bwd<__nv_bfloat16>(xs, w, hprev, mask, dhs, dxs, dw, dh0,
                                     rh, T, B, H, st)
                : bwd<float>(xs, w, hprev, mask, dhs, dxs, dw, dh0, rh, T, B,
                             H, st);
}

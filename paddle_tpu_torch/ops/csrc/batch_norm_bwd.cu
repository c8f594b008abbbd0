// BatchNorm training backward over a [N', C, S] view of x and dy (x's
// dtype): element (n, c, s) at n*C*S + c*S + s, so NHWC activations are
// (N*H*W, C, 1) and NCHW ones (N, C, H*W).  With the forward's per-channel
// f32 mean and inv = rsqrt(var + eps), and the f32 scale and bias [C]:
//   xn  = (x - mean) * inv
//   dy' = dy, masked by xn * scale + bias > 0 under the fused relu
//   dbias = sum dy',  dscale = sum dy' * xn          (over n and s, f32)
//   dx  = (dy' - dbias / R - xn * dscale / R) * scale * inv,  R = N' * S
//
// Replaces: paddle_tpu/ops/pallas_kernels.py _bn_bwd_kernel (reached
// through bn_bwd_onepass / _bn_train_core's VJP).
//
// Bound on the H100: bytes.  The function must read x and dy once and
// write dx once; it does ~15 flops per element, far below the card's
// ~20 flops per byte.
//
// Design.  The TPU kernel keeps a 128-channel column of ALL rows in VMEM
// and reads x and dy once.  At ResNet-50 bs128 a column is up to 1.6 M
// rows, which no shared memory holds, so this kernel takes three passes:
//   1. partial sums.  A block owns a tile of nb rows x cb channels x sb
//      spatial positions (at most 1024 elements; for a fixed n the tile's
//      elements are cb runs of sb, contiguous when sb == S) and a run of
//      n.  Each thread owns up to 4 fixed tile positions, so its channel
//      and per-channel constants stay in registers while it walks the
//      rows: neighbouring threads read neighbouring addresses in both
//      layouts.  At the end the block folds its per-position sums into
//      one row of a [P, 2, C] f32 partial buffer (per channel, a warp
//      sums the tile positions in a fixed order);
//   2. a fixed-order reduce of the partials into dscale and dbias;
//   3. an elementwise dx pass over the same tiles.
// No atomics: the result is the same from run to run.  x and dy are read
// twice (5 units of traffic against the 3 of the bound); keeping them in
// L2 or shared memory between the passes is later work.  The relu mask
// rounds xn * scale and + bias separately, as the forward computes them.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                   // tile positions per thread
constexpr int kTile = kThreads * kPer;    // elements of a block's tile
constexpr int kReduceCols = 32;           // channels per reduce block
constexpr int kReduceWarps = 8;           // warps splitting the partials

struct Geom {
  int64_t rows;                   // N'
  int C, S;
  int nb, cb, sb;                 // the tile
  int64_t rows_per_chunk;         // rows of n each block walks
};

// The fixed tile positions of this thread: offsets from the tile's row,
// the row within the tile, the channel, and whether the position lies
// inside the tensor.
struct Slots {
  int64_t off[kPer];
  int nl[kPer];
  int c[kPer];
  bool ok[kPer];
};

__device__ __forceinline__ void tile_slots(const Geom& g, int c0, int s0,
                                           Slots& t) {
  const int per_row = g.cb * g.sb;
  const int tile = g.nb * per_row;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = threadIdx.x + k * kThreads;
    const int nl = j / per_row, rem = j - nl * per_row;
    const int cl = rem / g.sb, sl = rem - cl * g.sb;
    const int c = c0 + cl, s = s0 + sl;
    t.ok[k] = j < tile && c < g.C && s < g.S;
    t.nl[k] = nl;
    t.c[k] = t.ok[k] ? c : 0;
    t.off[k] = static_cast<int64_t>(nl) * g.C * g.S
               + static_cast<int64_t>(c) * g.S + s;
  }
}

template <bool kRelu>
__device__ __forceinline__ float masked(float g, float xn, float sc,
                                        float bi) {
  if (kRelu && !(__fadd_rn(__fmul_rn(xn, sc), bi) > 0.f)) return 0.f;
  return g;
}

template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const float* __restrict__ mean,
                       const float* __restrict__ inv,
                       float* __restrict__ part, Geom g) {
  __shared__ float red[2][kTile];
  const int c0 = blockIdx.y * g.cb, s0 = blockIdx.z * g.sb;
  Slots t;
  tile_slots(g, c0, s0, t);
  float mu[kPer], iv[kPer], sc[kPer], bi[kPer], ds[kPer], db[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    mu[k] = mean[t.c[k]];
    iv[k] = inv[t.c[k]];
    sc[k] = scale[t.c[k]];
    bi[k] = bias[t.c[k]];
    ds[k] = 0.f;
    db[k] = 0.f;
  }
  const int64_t cs = static_cast<int64_t>(g.C) * g.S;
  const int64_t n0 = blockIdx.x * g.rows_per_chunk;
  const int64_t n1 = min(g.rows, n0 + g.rows_per_chunk);
  for (int64_t n = n0; n < n1; n += g.nb) {
    const int64_t base = n * cs;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (t.ok[k] && n + t.nl[k] < n1) {
        const float xn = (ptt::to_f32(x[base + t.off[k]]) - mu[k]) * iv[k];
        const float gk = masked<kRelu>(ptt::to_f32(dy[base + t.off[k]]), xn,
                                       sc[k], bi[k]);
        db[k] += gk;
        ds[k] += gk * xn;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    red[0][threadIdx.x + k * kThreads] = ds[k];
    red[1][threadIdx.x + k * kThreads] = db[k];
  }
  __syncthreads();
  // per channel of the tile: its nb * sb positions, lanes strided, then a
  // warp tree -- a fixed order
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int per_c = g.nb * g.sb;
  const int64_t p = static_cast<int64_t>(blockIdx.z) * gridDim.x
                    + blockIdx.x;
  for (int cl = w; cl < g.cb; cl += kThreads / 32) {
    float a = 0.f, b = 0.f;
    for (int q = lane; q < per_c; q += 32) {
      const int nl = q / g.sb, sl = q - nl * g.sb;
      const int j = (nl * g.cb + cl) * g.sb + sl;
      a += red[0][j];
      b += red[1][j];
    }
    a = ptt::warp_sum(a);
    b = ptt::warp_sum(b);
    if (lane == 0 && c0 + cl < g.C) {
      part[(2 * p) * g.C + c0 + cl] = a;
      part[(2 * p + 1) * g.C + c0 + cl] = b;
    }
  }
}

// dscale[c] = sum over p of part[p][0][c], dbias likewise from part[p][1];
// warp w sums p = w, w + 8, ... for 32 channels, then the eight warp sums
// are added in order.
__global__ void __launch_bounds__(32 * kReduceWarps)
    bn_bwd_reduce_kernel(const float* __restrict__ part,
                         float* __restrict__ dscale,
                         float* __restrict__ dbias, int64_t np, int C) {
  __shared__ float sums[2][kReduceWarps][kReduceCols];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.x * kReduceCols + lane;
  float a = 0.f, b = 0.f;
  if (c < C) {
    for (int64_t p = w; p < np; p += kReduceWarps) {
      a += part[(2 * p) * C + c];
      b += part[(2 * p + 1) * C + c];
    }
  }
  sums[0][w][lane] = a;
  sums[1][w][lane] = b;
  __syncthreads();
  if (w == 0 && c < C) {
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < kReduceWarps; ++j) {
      sa += sums[0][j][lane];
      sb += sums[1][j][lane];
    }
    dscale[c] = sa;
    dbias[c] = sb;
  }
}

template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     const float* __restrict__ mean,
                     const float* __restrict__ inv,
                     const float* __restrict__ dscale,
                     const float* __restrict__ dbias, T* __restrict__ dx,
                     Geom g, float count) {
  const int c0 = blockIdx.y * g.cb, s0 = blockIdx.z * g.sb;
  Slots t;
  tile_slots(g, c0, s0, t);
  float mu[kPer], iv[kPer], sc[kPer], bi[kPer], mb[kPer], ms[kPer],
      a[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = t.c[k];
    mu[k] = mean[c];
    iv[k] = inv[c];
    sc[k] = scale[c];
    bi[k] = bias[c];
    mb[k] = dbias[c] / count;
    ms[k] = dscale[c] / count;
    a[k] = sc[k] * iv[k];
  }
  const int64_t cs = static_cast<int64_t>(g.C) * g.S;
  const int64_t n0 = blockIdx.x * g.rows_per_chunk;
  const int64_t n1 = min(g.rows, n0 + g.rows_per_chunk);
  for (int64_t n = n0; n < n1; n += g.nb) {
    const int64_t base = n * cs;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (t.ok[k] && n + t.nl[k] < n1) {
        const int64_t e = base + t.off[k];
        const float xn = (ptt::to_f32(x[e]) - mu[k]) * iv[k];
        const float gk = masked<kRelu>(ptt::to_f32(dy[e]), xn, sc[k],
                                       bi[k]);
        dx[e] = ptt::from_f32<T>((gk - mb[k] - xn * ms[k]) * a[k]);
      }
    }
  }
}

template <typename T, bool kRelu>
int launch(const void* x, const void* dy, const void* scale,
           const void* bias, const void* mean, const void* inv, void* dx,
           void* part, void* dscale, void* dbias, const Geom& g,
           int64_t n_chunks, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(n_chunks),
                  static_cast<unsigned>((g.C + g.cb - 1) / g.cb),
                  static_cast<unsigned>((g.S + g.sb - 1) / g.sb));
  const int64_t np = n_chunks * grid.z;
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* mu = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv);
  float* ds = static_cast<float*>(dscale);
  float* db = static_cast<float*>(dbias);
  bn_bwd_sums_kernel<T, kRelu><<<grid, kThreads, 0, st>>>(
      xt, dyt, sc, bi, mu, iv, static_cast<float*>(part), g);
  bn_bwd_reduce_kernel<<<(g.C + kReduceCols - 1) / kReduceCols,
                         32 * kReduceWarps, 0, st>>>(
      static_cast<const float*>(part), ds, db, np, g.C);
  bn_bwd_dx_kernel<T, kRelu><<<grid, kThreads, 0, st>>>(
      xt, dyt, sc, bi, mu, iv, ds, db, static_cast<T*>(dx), g,
      static_cast<float>(g.rows * g.S));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tile (nb, cb, sb) and rows_per_chunk come from the wrapper, which
// also allocates part: f32 scratch of n_chunks * ceil(S / sb) * 2 * C
// values.  Grid: n_chunks x ceil(C / cb) x ceil(S / sb) blocks.
extern "C" int ptt_batch_norm_bwd(const void* x, const void* dy,
                                  const void* scale, const void* bias,
                                  const void* mean, const void* inv,
                                  void* dx, void* part, void* dscale,
                                  void* dbias, int64_t rows, int channels,
                                  int spatial, int nb, int cb, int sb,
                                  int64_t rows_per_chunk, int64_t n_chunks,
                                  int relu, int is_bf16, void* stream) {
  if (rows <= 0 || channels <= 0 || spatial <= 0) return cudaSuccess;
  if (nb <= 0 || cb <= 0 || sb <= 0 || nb * cb * sb > kTile
      || rows_per_chunk <= 0 || n_chunks <= 0
      || (n_chunks - 1) * rows_per_chunk >= rows
      || n_chunks * rows_per_chunk < rows || n_chunks > 0x7fffffff
      || (channels + cb - 1) / cb > 65535 || (spatial + sb - 1) / sb > 65535)
    return cudaErrorInvalidValue;
  const Geom g{rows, channels, spatial, nb, cb, sb, rows_per_chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return relu ? launch<__nv_bfloat16, true>(x, dy, scale, bias, mean, inv,
                                              dx, part, dscale, dbias, g,
                                              n_chunks, st)
                : launch<__nv_bfloat16, false>(x, dy, scale, bias, mean, inv,
                                               dx, part, dscale, dbias, g,
                                               n_chunks, st);
  return relu ? launch<float, true>(x, dy, scale, bias, mean, inv, dx, part,
                                    dscale, dbias, g, n_chunks, st)
              : launch<float, false>(x, dy, scale, bias, mean, inv, dx, part,
                                     dscale, dbias, g, n_chunks, st);
}

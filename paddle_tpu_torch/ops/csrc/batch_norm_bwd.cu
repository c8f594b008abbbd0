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
// and reads x and dy once.  At ResNet-50 bs128 one launch's x and dy are
// up to 411 MB, far beyond the 50 MB of L2 and any on-chip memory, and dx
// needs the finished sums, so this kernel streams twice (5 units of
// traffic against the 3 of the bound):
//   1. partial sums, one row of a [P, 2, C] f32 buffer per block;
//   2. a fixed-order reduce of the partials into dscale and dbias;
//   3. dx, walking the rows in the reverse order of pass 1, so the lines
//      pass 1 read last are still in L2 (all of them for a launch whose
//      x and dy fit there, as ResNet-50's stage-3 and stage-4 ones do).
// Every load and store is 16 bytes a thread (8 bf16 or 4 f32) where the
// contiguous dimension and the pointers allow, else one element:
//  - channels-last (S == 1, the main path): a thread owns V consecutive
//    channels, keeps their constants and partial sums in registers and
//    walks rows; a block covers up to 256 vectors of a row and, for
//    narrow C, several rows at once (rpp rows per pass);
//  - channel-major (S > 1, NCHW): a block owns one channel and walks its
//    N runs of S elements, V at a time.
// Each thread keeps kUnroll rows of loads in flight.  The grid is one
// wave of the blocks the card holds at once (the wrapper asks
// `ptt_batch_norm_bwd_residency`, i.e. cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor, times the SMs), and each block walks its rows
// grid-stride.  No atomics: every sum is taken in a fixed order, so
// runs repeat bit for bit.  The relu mask rounds xn * scale and + bias
// separately, as the forward computes them.
#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;               // rows of loads in flight a thread
constexpr int kReduceWarps = 32;         // warps splitting the partials

struct Geom {
  int64_t rows;   // N'
  int C, S;
  int bcols;      // channels-last: vectors of a row one block covers
  int rpp;        // channels-last: rows a block takes per pass
};

// V elements of T at once: one 16-byte vector (kVec) or one element.
template <typename T, bool kVec>
struct Pack {
  static constexpr int V = kVec ? ptt::Chunk<T>::n : 1;
  uint4 u;
  T e;
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kVec) u = ptt::Chunk<T>::raw(p);
    else e = *p;
  }
  __device__ __forceinline__ void unpack(float* f) const {
    if constexpr (kVec) ptt::Chunk<T>::unpack(u, f);
    else f[0] = ptt::to_f32(e);
  }
  static __device__ __forceinline__ void store(T* p, const float* f) {
    if constexpr (kVec) *reinterpret_cast<uint4*>(p) = ptt::Chunk<T>::pack(f);
    else *p = ptt::from_f32<T>(f[0]);
  }
};

template <bool kRelu>
__device__ __forceinline__ float masked(float g, float xn, float sc,
                                        float bi) {
  if (kRelu && !(__fadd_rn(__fmul_rn(xn, sc), bi) > 0.f)) return 0.f;
  return g;
}

// --- channels-last (S == 1): element (n, c) at n*C + c ---------------
//
// Block (bx, by) covers vector columns [by * bcols, by * bcols + bcols);
// thread t owns column t % bcols and row lane t / bcols (< rpp).  Its rows
// are base + k * stride, base = bx * rpp + lane, stride = gridDim.x * rpp:
// in step k the grid reads one band of stride consecutive rows.

template <typename T, bool kVec, bool kRelu>
__global__ void __launch_bounds__(kThreads, 2)
    bn_sums_last_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        const float* __restrict__ mean,
                        const float* __restrict__ inv,
                        float* __restrict__ part, Geom g) {
  using P = Pack<T, kVec>;
  constexpr int V = P::V;
  __shared__ float red[2][kThreads * V];
  const int col = threadIdx.x % g.bcols, lane = threadIdx.x / g.bcols;
  const int c0 = (blockIdx.y * g.bcols + col) * V;
  const bool on = lane < g.rpp && c0 < g.C;
  float mu[V], iv[V], sc[V], bi[V], ds[V], db[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = on ? c0 + j : 0;
    mu[j] = mean[c];
    iv[j] = inv[c];
    sc[j] = kRelu ? scale[c] : 0.f;
    bi[j] = kRelu ? bias[c] : 0.f;
    ds[j] = db[j] = 0.f;
  }
  if (on) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * g.rpp;
    for (int64_t r0 = static_cast<int64_t>(blockIdx.x) * g.rpp + lane;
         r0 < g.rows; r0 += kUnroll * stride) {
      P xv[kUnroll], gv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t r = r0 + u * stride;
        if (r < g.rows) {
          xv[u].load(x + r * g.C + c0);
          gv[u].load(dy + r * g.C + c0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + u * stride >= g.rows) break;
        float xf[V], gf[V];
        xv[u].unpack(xf);
        gv[u].unpack(gf);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xn = (xf[j] - mu[j]) * iv[j];
          const float gk = masked<kRelu>(gf[j], xn, sc[j], bi[j]);
          db[j] += gk;
          ds[j] += gk * xn;
        }
      }
    }
  }
  // per channel of the block: its rpp row lanes in order
  const int nch = g.bcols * V;
  if (lane < g.rpp) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red[0][lane * nch + col * V + j] = ds[j];
      red[1][lane * nch + col * V + j] = db[j];
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nch; k += kThreads) {
    const int c = blockIdx.y * nch + k;
    if (c >= g.C) break;
    float a = 0.f, b = 0.f;
    for (int q = 0; q < g.rpp; ++q) {
      a += red[0][q * nch + k];
      b += red[1][q * nch + k];
    }
    part[(2 * static_cast<int64_t>(blockIdx.x)) * g.C + c] = a;
    part[(2 * static_cast<int64_t>(blockIdx.x) + 1) * g.C + c] = b;
  }
}

template <typename T, bool kVec, bool kRelu>
__global__ void __launch_bounds__(kThreads, 2)
    bn_dx_last_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      const float* __restrict__ mean,
                      const float* __restrict__ inv,
                      const float* __restrict__ dscale,
                      const float* __restrict__ dbias, T* __restrict__ dx,
                      Geom g, float count) {
  using P = Pack<T, kVec>;
  constexpr int V = P::V;
  const int col = threadIdx.x % g.bcols, lane = threadIdx.x / g.bcols;
  const int c0 = (blockIdx.y * g.bcols + col) * V;
  if (lane >= g.rpp || c0 >= g.C) return;
  float mu[V], iv[V], sc[V], bi[V], mb[V], ms[V], a[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = c0 + j;
    mu[j] = mean[c];
    iv[j] = inv[c];
    sc[j] = scale[c];
    bi[j] = bias[c];
    mb[j] = dbias[c] / count;
    ms[j] = dscale[c] / count;
    a[j] = sc[j] * iv[j];
  }
  // the rows of pass 1, last first
  const int64_t stride = static_cast<int64_t>(gridDim.x) * g.rpp;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * g.rpp + lane;
  if (base >= g.rows) return;
  for (int64_t r0 = base + (g.rows - 1 - base) / stride * stride; r0 >= 0;
       r0 -= kUnroll * stride) {
    P xv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = r0 - u * stride;
      if (r >= 0) {
        xv[u].load(x + r * g.C + c0);
        gv[u].load(dy + r * g.C + c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t r = r0 - u * stride;
      if (r < 0) break;
      float xf[V], gf[V], o[V];
      xv[u].unpack(xf);
      gv[u].unpack(gf);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xn = (xf[j] - mu[j]) * iv[j];
        const float gk = masked<kRelu>(gf[j], xn, sc[j], bi[j]);
        o[j] = (gk - mb[j] - xn * ms[j]) * a[j];
      }
      P::store(dx + r * g.C + c0, o);
    }
  }
}

// --- channel-major (S > 1): element (n, c, s) at n*C*S + c*S + s -------
//
// Block (bx, c) walks channel c's N * S / V vectors e = n * (S / V) + s / V:
// e = (k * gridDim.x + bx) * kThreads + t.

template <typename T, bool kVec, bool kRelu>
__global__ void __launch_bounds__(kThreads, 2)
    bn_sums_major_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias,
                         const float* __restrict__ mean,
                         const float* __restrict__ inv,
                         float* __restrict__ part, Geom g) {
  using P = Pack<T, kVec>;
  constexpr int V = P::V;
  __shared__ float scratch[32];
  const int c = blockIdx.y;
  const float mu = mean[c], iv = inv[c];
  const float sc = kRelu ? scale[c] : 0.f, bi = kRelu ? bias[c] : 0.f;
  const int sv = g.S / V;
  const int64_t nv = g.rows * sv;
  const int64_t cs = static_cast<int64_t>(g.C) * g.S;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  float ds = 0.f, db = 0.f;
  for (int64_t e0 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e0 < nv; e0 += kUnroll * stride) {
    P xv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t e = e0 + u * stride;
      if (e < nv) {
        const int64_t n = e / sv;
        const int64_t off = n * cs + static_cast<int64_t>(c) * g.S
                            + (e - n * sv) * V;
        xv[u].load(x + off);
        gv[u].load(dy + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (e0 + u * stride >= nv) break;
      float xf[V], gf[V];
      xv[u].unpack(xf);
      gv[u].unpack(gf);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xn = (xf[j] - mu) * iv;
        const float gk = masked<kRelu>(gf[j], xn, sc, bi);
        db += gk;
        ds += gk * xn;
      }
    }
  }
  ds = ptt::block_sum(ds, scratch);
  db = ptt::block_sum(db, scratch);
  if (threadIdx.x == 0) {
    part[(2 * static_cast<int64_t>(blockIdx.x)) * g.C + c] = ds;
    part[(2 * static_cast<int64_t>(blockIdx.x) + 1) * g.C + c] = db;
  }
}

template <typename T, bool kVec, bool kRelu>
__global__ void __launch_bounds__(kThreads, 2)
    bn_dx_major_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const float* __restrict__ mean,
                       const float* __restrict__ inv,
                       const float* __restrict__ dscale,
                       const float* __restrict__ dbias, T* __restrict__ dx,
                       Geom g, float count) {
  using P = Pack<T, kVec>;
  constexpr int V = P::V;
  const int c = blockIdx.y;
  const float mu = mean[c], iv = inv[c], sc = scale[c], bi = bias[c];
  const float mb = dbias[c] / count, ms = dscale[c] / count, a = sc * iv;
  const int sv = g.S / V;
  const int64_t nv = g.rows * sv;
  const int64_t cs = static_cast<int64_t>(g.C) * g.S;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads
                       + threadIdx.x;
  if (base >= nv) return;
  for (int64_t e0 = base + (nv - 1 - base) / stride * stride; e0 >= 0;
       e0 -= kUnroll * stride) {
    P xv[kUnroll], gv[kUnroll];
    int64_t off[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t e = e0 - u * stride;
      if (e >= 0) {
        const int64_t n = e / sv;
        off[u] = n * cs + static_cast<int64_t>(c) * g.S + (e - n * sv) * V;
        xv[u].load(x + off[u]);
        gv[u].load(dy + off[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (e0 - u * stride < 0) break;
      float xf[V], gf[V], o[V];
      xv[u].unpack(xf);
      gv[u].unpack(gf);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xn = (xf[j] - mu) * iv;
        const float gk = masked<kRelu>(gf[j], xn, sc, bi);
        o[j] = (gk - mb - xn * ms) * a;
      }
      P::store(dx + off[u], o);
    }
  }
}

// dscale[c] = sum over p of part[p][0][c], dbias likewise from part[p][1]:
// a block takes 32 channels (one a lane); warp w sums p = w + 32 i with
// four partial sums (i mod 4) so that four loads are in flight, adds them
// in order, and the 32 warp sums are added in order.
__global__ void __launch_bounds__(32 * kReduceWarps)
    bn_reduce_kernel(const float* __restrict__ part,
                     float* __restrict__ dscale, float* __restrict__ dbias,
                     int np, int C) {
  __shared__ float sums[2][kReduceWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
  if (c < C) {
    for (int p0 = w; p0 < np; p0 += 4 * kReduceWarps) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = p0 + u * kReduceWarps;
        if (p < np) {
          a[u] += part[(2 * static_cast<int64_t>(p)) * C + c];
          b[u] += part[(2 * static_cast<int64_t>(p) + 1) * C + c];
        }
      }
    }
  }
  sums[0][w][lane] = (a[0] + a[1]) + (a[2] + a[3]);
  sums[1][w][lane] = (b[0] + b[1]) + (b[2] + b[3]);
  __syncthreads();
  if (w == 0 && c < C) {
    float sa = 0.f, sb = 0.f;
    for (int j = 0; j < kReduceWarps; ++j) {
      sa += sums[0][j][lane];
      sb += sums[1][j][lane];
    }
    dscale[c] = sa;
    dbias[c] = sb;
  }
}

struct Args {
  const void *x, *dy, *scale, *bias, *mean, *inv;
  void *dx, *part, *dscale, *dbias;
  Geom g;
  int gx_sums, gx_dx, gy;
  cudaStream_t st;
};

struct Launch {
  const Args& a;
  template <typename T, bool kVec, bool kRelu>
  int run() const {
    const Geom& g = a.g;
    const T* x = static_cast<const T*>(a.x);
    const T* dy = static_cast<const T*>(a.dy);
    const float* sc = static_cast<const float*>(a.scale);
    const float* bi = static_cast<const float*>(a.bias);
    const float* mu = static_cast<const float*>(a.mean);
    const float* iv = static_cast<const float*>(a.inv);
    float* part = static_cast<float*>(a.part);
    float* ds = static_cast<float*>(a.dscale);
    float* db = static_cast<float*>(a.dbias);
    T* dx = static_cast<T*>(a.dx);
    const dim3 sums_grid(a.gx_sums, a.gy), dx_grid(a.gx_dx, a.gy);
    const float count = static_cast<float>(g.rows * g.S);
    if (g.S == 1)
      bn_sums_last_kernel<T, kVec, kRelu><<<sums_grid, kThreads, 0, a.st>>>(x, dy, sc, bi, mu, iv,
                                                     part, g);
    else
      bn_sums_major_kernel<T, kVec, kRelu><<<sums_grid, kThreads, 0, a.st>>>(x, dy, sc, bi, mu, iv,
                                                      part, g);
    bn_reduce_kernel<<<(g.C + 31) / 32, 32 * kReduceWarps, 0, a.st>>>(
        part, ds, db, a.gx_sums, g.C);
    if (g.S == 1)
      bn_dx_last_kernel<T, kVec, kRelu><<<dx_grid, kThreads, 0, a.st>>>(x, dy, sc, bi, mu, iv, ds,
                                                 db, dx, g, count);
    else
      bn_dx_major_kernel<T, kVec, kRelu><<<dx_grid, kThreads, 0, a.st>>>(x, dy, sc, bi, mu, iv, ds,
                                                  db, dx, g, count);
    return static_cast<int>(cudaGetLastError());
  }
};

struct Residency {
  bool major;
  int* sums;
  int* dx;
  template <typename T, bool kVec, bool kRelu>
  int run() const {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        sums, major ? bn_sums_major_kernel<T, kVec, kRelu>
                    : bn_sums_last_kernel<T, kVec, kRelu>, kThreads, 0);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          dx, major ? bn_dx_major_kernel<T, kVec, kRelu>
                    : bn_dx_last_kernel<T, kVec, kRelu>, kThreads, 0);
    return static_cast<int>(e);
  }
};

template <typename Op>
int dispatch(int is_bf16, int vec, int relu, const Op& op) {
  using B = __nv_bfloat16;
  if (is_bf16) {
    if (vec)
      return relu ? op.template run<B, true, true>()
                  : op.template run<B, true, false>();
    return relu ? op.template run<B, false, true>()
                : op.template run<B, false, false>();
  }
  if (vec)
    return relu ? op.template run<float, true, true>()
                : op.template run<float, true, false>();
  return relu ? op.template run<float, false, true>()
              : op.template run<float, false, false>();
}

}  // namespace

// Blocks of the sums and dx kernels one SM holds at once, for a dtype, a
// relu, a layout (channel_major: S > 1) and a load width (vec: 16 bytes).
extern "C" int ptt_batch_norm_bwd_residency(int is_bf16, int relu,
                                            int channel_major, int vec,
                                            int* sums_blocks,
                                            int* dx_blocks) {
  return dispatch(is_bf16, vec, relu,
                  Residency{channel_major != 0, sums_blocks, dx_blocks});
}

// The geometry comes from the wrapper (kernels.bn_bwd_geometry): vec 1
// for 16-byte loads (the contiguous dimension -- C when S == 1, else S --
// a multiple of 16 bytes' elements, and x, dy, dx 16-byte aligned), else
// 0; channels-last (S == 1): bcols vectors a block, rpp rows a pass, gy =
// ceil(C / V / bcols) column groups; channel-major: gy = C.  part is f32
// scratch of gx_sums * 2 * C values.
extern "C" int ptt_batch_norm_bwd(const void* x, const void* dy,
                                  const void* scale, const void* bias,
                                  const void* mean, const void* inv,
                                  void* dx, void* part, void* dscale,
                                  void* dbias, int64_t rows, int channels,
                                  int spatial, int vec, int bcols, int rpp,
                                  int gx_sums, int gx_dx, int gy, int relu,
                                  int is_bf16, void* stream) {
  if (rows <= 0 || channels <= 0 || spatial <= 0) return cudaSuccess;
  const int v = vec ? 16 / (is_bf16 ? 2 : 4) : 1;
  const int along = spatial == 1 ? channels : spatial;
  if (along % v != 0 || gx_sums <= 0 || gx_dx <= 0 || gy <= 0
      || gy > 65535)
    return cudaErrorInvalidValue;
  if (vec)
    for (const void* p : {x, dy, static_cast<const void*>(dx)})
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
        return cudaErrorMisalignedAddress;
  if (spatial == 1) {
    if (bcols <= 0 || bcols > kThreads || rpp <= 0 || rpp * bcols > kThreads
        || static_cast<int64_t>(gy) * bcols * v < channels)
      return cudaErrorInvalidValue;
  } else if (gy != channels) {
    return cudaErrorInvalidValue;
  }
  const Args a{x, dy, scale, bias, mean, inv, dx, part, dscale, dbias,
               Geom{rows, channels, spatial, bcols, rpp},
               gx_sums, gx_dx, gy, static_cast<cudaStream_t>(stream)};
  return dispatch(is_bf16, vec, relu, Launch{a});
}

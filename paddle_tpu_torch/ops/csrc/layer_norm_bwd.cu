// Row LayerNorm backward over x [R, F] and dy [R, F] (x's dtype), with
// the forward's f32 mean and inv = rsqrt(var + eps) per row and the f32
// scale [F] -> dx [R, F] (x's dtype), dscale and dbias [F] (f32, summed
// over all rows).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py _ln_bwd_kernel (reached
// through _ln_pallas_bwd / fused_layer_norm's VJP).
//
// Bound on the H100: bytes.  The kernel must read x and dy once and write
// dx once (plus the per-row statistics and 3 x F f32 of scale, dscale and
// dbias); it does ~12 flops per element, far below the card's ~20 flops
// per byte.
//
// Design.  dx takes the closed form
//   dx = inv * (dxn - mean(dxn) - xn * mean(dxn * xn)),  dxn = dy * scale.
// dscale and dbias are sums over ALL rows: the TPU kernel carried them in
// scratch across its sequential row grid, but Hopper blocks run in no
// order.  So each block sums its own rows into one row of a [2, blocks,
// F] f32 partial buffer, and a second kernel sums the partials over the
// blocks in a fixed order.  No atomics: the result repeats bit for bit.
// The grid is one wave of resident blocks (the library's occupancy query,
// `ptt_layer_norm_bwd_residency`); each walker (a warp, or a block) takes
// a run of consecutive rows.
// Two paths, picked by the wrapper (kernels.layer_norm_bwd_geometry):
// - ln_bwd_warp_kernel, for rows of at most 1024 features in whole
//   16-byte chunks with 16-byte aligned pointers (F768: six chunks a lane
//   in f32, three in bf16): one warp owns a row and holds its x and dy in
//   registers, read once with 16-byte cp.async copies into a staging area
//   of shared memory (the next row's copies are issued as soon as the
//   current row is in registers, so they run under its sums and stores);
//   both row sums are warp shuffles, dx is written from registers with
//   16-byte stores, and no barrier is taken per row.  Each lane adds
//   dscale and dbias of its own columns in registers over every row its
//   warp walks; at the end the block (8 warps) adds its warps' sums in
//   order through shared memory.
// - ln_bwd_block_kernel, for any other F: a block takes one row at a
//   time, each thread owning fixed columns of a [2, F] accumulator in
//   shared memory, with 16-byte loads when F is in whole chunks and the
//   pointers aligned; the second pass re-reads the row from L1/L2.
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int kThreads = 256;      // a block-path block
constexpr int kRowWarps = 8;       // warps (rows in flight) of a warp-path block
constexpr int kWarpRowMax = 1024;  // longest row (features) of the warp path
constexpr int kReduceCols = 32;    // columns of a reduce block (its lanes)
constexpr int kReduceWarps = 32;   // warps splitting the blocks to sum
constexpr int kReduceBatch = 16;   // partials a warp loads before adding

// V elements of a row as f32: one 16-byte chunk (V == Chunk<T>::n) or one
// element (V == 1).
template <typename T, int V>
__device__ __forceinline__ void load_v(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = ptt::to_f32(*p);
  } else {
    ptt::Chunk<T>::unpack(ptt::Chunk<T>::raw(p), v);
  }
}

template <int V>
__device__ __forceinline__ void load_scale(const float* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = *p;
  } else {
#pragma unroll
    for (int k = 0; k < V; k += 4)
      ptt::Chunk<float>::unpack(ptt::Chunk<float>::raw(p + k), v + k);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = ptt::from_f32<T>(v[0]);
  } else {
    *reinterpret_cast<uint4*>(p) = ptt::Chunk<T>::pack(v);
  }
}

// The rows [first, last) of walker w of `walkers` over R rows: runs of
// ceil(R / walkers) consecutive rows (neighbouring rows of one walker are
// neighbours in memory).
__device__ __forceinline__ void walk(int64_t w, int64_t walkers, int R,
                                     int64_t& first, int64_t& last) {
  const int64_t per = (R + walkers - 1) / walkers;
  first = w * per;
  last = first + per < R ? first + per : R;
}

// NCH: 16-byte chunks a lane holds, ceil(F / vec / 32).  Each warp owns
// 2F floats of shared memory: first the staging area of its next row (x
// then dy, in T), then, after its last row, its dscale and dbias sums.
template <typename T, int NCH>
__global__ void __launch_bounds__(kRowWarps * 32)
    ln_bwd_warp_kernel(const T* __restrict__ x,
                       const float* __restrict__ scale,
                       const float* __restrict__ mean,
                       const float* __restrict__ inv,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ part, int R, int F) {
  constexpr int vec = ptt::Chunk<T>::n;
  extern __shared__ __align__(16) float smem[];  // [kRowWarps][2][F]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_chunks = F / vec;
  const float inv_f = 1.f / F;
  float* own = smem + 2 * warp * F;
  T* x_s = reinterpret_cast<T*>(own);
  T* g_s = x_s + F;
  // a row's x and dy into the staging area: each lane copies the chunks
  // it will read, so its own wait orders the copies before its reads
  auto stage = [&](int64_t row) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = lane + 32 * i;
      if (c < n_chunks) {
        ptt::fa::cp_async16(x_s + c * vec, x + row * F + c * vec, 16);
        ptt::fa::cp_async16(g_s + c * vec, dy + row * F + c * vec, 16);
      }
    }
    ptt::fa::cp_async_commit();
  };
  float dsc[NCH][vec], dbi[NCH][vec];
#pragma unroll
  for (int i = 0; i < NCH; ++i)
#pragma unroll
    for (int e = 0; e < vec; ++e) dsc[i][e] = dbi[i][e] = 0.f;
  int64_t first, last;
  walk(static_cast<int64_t>(blockIdx.x) * kRowWarps + warp,
       static_cast<int64_t>(gridDim.x) * kRowWarps, R, first, last);
  if (first < last) stage(first);
  for (int64_t row = first; row < last; ++row) {
    const float mu = mean[row], iv = inv[row];
    ptt::fa::cp_async_wait<0>();
    float xv[NCH][vec], gv[NCH][vec];
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = lane + 32 * i;
      if (c < n_chunks) {
        ptt::Chunk<T>::unpack(*reinterpret_cast<const uint4*>(x_s + c * vec),
                              xv[i]);
        ptt::Chunk<T>::unpack(*reinterpret_cast<const uint4*>(g_s + c * vec),
                              gv[i]);
      }
    }
    float c1 = 0.f, c2 = 0.f;
    // xv becomes xn and gv dxn, in place
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = lane + 32 * i;
      if (c < n_chunks) {
        float sc[vec];
        load_scale<vec>(scale + c * vec, sc);
#pragma unroll
        for (int e = 0; e < vec; ++e) {
          const float xn = (xv[i][e] - mu) * iv, g = gv[i][e];
          dsc[i][e] += g * xn;
          dbi[i][e] += g;
          const float dxn = g * sc[e];
          c1 += dxn * xn;
          c2 += dxn;
          xv[i][e] = xn;
          gv[i][e] = dxn;
        }
      }
    }
    // the staged chunks are in registers and used: the next row's copies
    // run under this row's sums and stores
    if (row + 1 < last) stage(row + 1);
    c1 = ptt::warp_sum(c1) * inv_f;
    c2 = ptt::warp_sum(c2) * inv_f;
    T* dr = dx + row * F;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = lane + 32 * i;
      if (c < n_chunks) {
        float out[vec];
#pragma unroll
        for (int e = 0; e < vec; ++e)
          out[e] = iv * (gv[i][e] - c2 - xv[i][e] * c1);
        store_v<T, vec>(dr + c * vec, out);
      }
    }
  }
  // the block's column sums: its warps' in order of warp, each warp's in
  // its own area (every lane's staged reads are done)
  __syncwarp();
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = lane + 32 * i;
    if (c < n_chunks)
#pragma unroll
      for (int e = 0; e < vec; ++e) {
        own[c * vec + e] = dsc[i][e];
        own[F + c * vec + e] = dbi[i][e];
      }
  }
  __syncthreads();
  const int64_t nb = gridDim.x;
  for (int i = threadIdx.x; i < F; i += kRowWarps * 32) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) {
      a += smem[2 * w * F + i];
      b += smem[(2 * w + 1) * F + i];
    }
    part[static_cast<int64_t>(blockIdx.x) * F + i] = a;
    part[(nb + blockIdx.x) * F + i] = b;
  }
}

// V: elements a thread loads at once (16 bytes' worth, or 1).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_block_kernel(const T* __restrict__ x,
                        const float* __restrict__ scale,
                        const float* __restrict__ mean,
                        const float* __restrict__ inv,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ part, int R, int F) {
  extern __shared__ float acc[];  // [2][F]: this block's dscale, dbias
  __shared__ float scratch[32];
  float* dsc = acc;
  float* dbi = acc + F;
  const int nv = F / V;
  // each thread owns the columns of its vectors: no races
  for (int v = threadIdx.x; v < nv; v += kThreads)
#pragma unroll
    for (int e = 0; e < V; ++e) dsc[v * V + e] = dbi[v * V + e] = 0.f;
  const float inv_f = 1.f / F;
  int64_t first, last;
  walk(blockIdx.x, gridDim.x, R, first, last);
  for (int64_t r = first; r < last; ++r) {
    const int64_t base = r * F;
    const float mu = mean[r], iv = inv[r];
    float c1 = 0.f, c2 = 0.f;
    for (int v = threadIdx.x; v < nv; v += kThreads) {
      float xv[V], gv[V], sc[V];
      load_v<T, V>(x + base + v * V, xv);
      load_v<T, V>(dy + base + v * V, gv);
      load_scale<V>(scale + v * V, sc);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xn = (xv[e] - mu) * iv, g = gv[e];
        dsc[v * V + e] += g * xn;
        dbi[v * V + e] += g;
        const float dxn = g * sc[e];
        c1 += dxn * xn;
        c2 += dxn;
      }
    }
    c1 = ptt::block_sum(c1, scratch) * inv_f;
    c2 = ptt::block_sum(c2, scratch) * inv_f;
    for (int v = threadIdx.x; v < nv; v += kThreads) {
      float xv[V], gv[V], sc[V], out[V];
      load_v<T, V>(x + base + v * V, xv);
      load_v<T, V>(dy + base + v * V, gv);
      load_scale<V>(scale + v * V, sc);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xn = (xv[e] - mu) * iv, dxn = gv[e] * sc[e];
        out[e] = iv * (dxn - c2 - xn * c1);
      }
      store_v<T, V>(dx + base + v * V, out);
    }
  }
  __syncthreads();
  const int64_t nb = gridDim.x;
  for (int i = threadIdx.x; i < F; i += kThreads) {
    part[static_cast<int64_t>(blockIdx.x) * F + i] = dsc[i];
    part[(nb + blockIdx.x) * F + i] = dbi[i];
  }
}

// dscale[i] = sum over blocks b of part[0][b][i], dbias likewise from
// part[1]: warp w adds blocks w, w + 32, ... in order (loading
// kReduceBatch of them before adding: one round trip to memory for up to
// 512 blocks), then the 32 warp sums are added in order of warp.
__global__ void __launch_bounds__(32 * kReduceWarps)
    ln_bwd_reduce_kernel(const float* __restrict__ part,
                         float* __restrict__ dscale,
                         float* __restrict__ dbias, int nb, int F) {
  __shared__ float sums[2][kReduceWarps][kReduceCols];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * kReduceCols + lane;
  float a = 0.f, b = 0.f;
  if (i < F) {
    for (int blk0 = w; blk0 < nb; blk0 += kReduceWarps * kReduceBatch) {
      // every load issued before the first add (past nb: a valid row,
      // not added)
      float va[kReduceBatch], vb[kReduceBatch];
#pragma unroll
      for (int k = 0; k < kReduceBatch; ++k) {
        const int64_t blk = min(blk0 + k * kReduceWarps, nb - 1);
        va[k] = part[blk * F + i];
        vb[k] = part[(nb + blk) * F + i];
      }
#pragma unroll
      for (int k = 0; k < kReduceBatch; ++k)
        if (blk0 + k * kReduceWarps < nb) {
          a += va[k];
          b += vb[k];
        }
    }
  }
  sums[0][w][lane] = a;
  sums[1][w][lane] = b;
  __syncthreads();
  if (w == 0 && i < F) {
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < kReduceWarps; ++j) {
      sa += sums[0][j][lane];
      sb += sums[1][j][lane];
    }
    dscale[i] = sa;
    dbias[i] = sb;
  }
}

// Call fn(std::integral_constant<int, NCH>) for the warp path's chunks a
// lane, nch in 1 .. kWarpRowMax / vec / 32.
template <typename T, typename Fn>
int by_chunks(int nch, Fn fn) {
  using std::integral_constant;
  switch (nch) {
    case 1: return fn(integral_constant<int, 1>{});
    case 2: return fn(integral_constant<int, 2>{});
    case 3: return fn(integral_constant<int, 3>{});
    case 4: return fn(integral_constant<int, 4>{});
    default: break;
  }
  if constexpr (sizeof(T) == 4) {
    switch (nch) {
      case 5: return fn(integral_constant<int, 5>{});
      case 6: return fn(integral_constant<int, 6>{});
      case 7: return fn(integral_constant<int, 7>{});
      case 8: return fn(integral_constant<int, 8>{});
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The path's kernel with its block size and dynamic shared memory, handed
// to fn(kernel, threads, smem); cudaErrorInvalidValue for a geometry the
// kernels do not take.
template <typename T, typename Fn>
int with_kernel(int features, int warp, int vec, Fn fn) {
  constexpr int kVec = ptt::Chunk<T>::n;
  if (warp) {
    if (vec != kVec || features % kVec != 0 || features > kWarpRowMax)
      return static_cast<int>(cudaErrorInvalidValue);
    const int nch = (features / kVec + 31) / 32;
    const size_t smem = 2 * kRowWarps * static_cast<size_t>(features) * 4;
    return by_chunks<T>(nch, [&](auto c) {
      return fn(ln_bwd_warp_kernel<T, decltype(c)::value>, kRowWarps * 32,
                smem);
    });
  }
  const size_t smem = 2 * static_cast<size_t>(features) * sizeof(float);
  if (vec == kVec && features % kVec == 0)
    return fn(ln_bwd_block_kernel<T, kVec>, kThreads, smem);
  if (vec == 1) return fn(ln_bwd_block_kernel<T, 1>, kThreads, smem);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int launch(const void* x, const void* scale, const void* mean,
           const void* inv, const void* dy, void* dx, void* part,
           void* dscale, void* dbias, int rows, int features, int warp,
           int vec, int blocks, cudaStream_t st) {
  const int rc = with_kernel<T>(features, warp, vec, [&](auto kern,
                                                        int threads,
                                                        size_t smem) {
    const cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<blocks, threads, smem, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(mean), static_cast<const float*>(inv),
        static_cast<const T*>(dy), static_cast<T*>(dx),
        static_cast<float*>(part), rows, features);
    return static_cast<int>(cudaGetLastError());
  });
  if (rc != 0) return rc;
  ln_bwd_reduce_kernel<<<(features + kReduceCols - 1) / kReduceCols,
                         32 * kReduceWarps, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dscale),
      static_cast<float*>(dbias), blocks, features);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int residency(int features, int warp, int vec, int* blocks) {
  return with_kernel<T>(features, warp, vec, [&](auto kern, int threads,
                                                 size_t smem) {
    cudaError_t e = allow_smem(kern, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                        threads, smem);
    return static_cast<int>(e);
  });
}

}  // namespace

// *blocks: the blocks of the path's kernel (warp 1: warp per row, else
// block per row; vec: elements a thread loads at once) one SM holds at
// once, for the wrapper's one-wave grid.
extern "C" int ptt_layer_norm_bwd_residency(int features, int warp, int vec,
                                            int is_bf16, int* blocks) {
  if (features <= 0 || blocks == nullptr) return cudaErrorInvalidValue;
  return is_bf16 ? residency<__nv_bfloat16>(features, warp, vec, blocks)
                 : residency<float>(features, warp, vec, blocks);
}

// The geometry comes from the wrapper (kernels.layer_norm_bwd_geometry):
// warp 1 for the warp-per-row kernel (F <= 1024 in whole 16-byte chunks,
// vec = 16 bytes' elements, x, dy and dx 16-byte aligned), else the
// block-per-row kernel with vec 16 bytes' elements or 1; ``blocks`` is
// the grid.  part is f32 scratch of 2 x blocks x features values.
extern "C" int ptt_layer_norm_bwd(const void* x, const void* scale,
                                  const void* mean, const void* inv,
                                  const void* dy, void* dx, void* part,
                                  void* dscale, void* dbias, int rows,
                                  int features, int warp, int vec,
                                  int blocks, int is_bf16, void* stream) {
  if (rows <= 0 || features <= 0) return cudaSuccess;
  if (blocks <= 0) return cudaErrorInvalidValue;
  if (vec > 1)
    for (const void* p : {x, scale, dy, static_cast<const void*>(dx)})
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
        return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, scale, mean, inv, dy, dx, part, dscale,
                                 dbias, rows, features, warp, vec, blocks,
                                 st);
  return launch<float>(x, scale, mean, inv, dy, dx, part, dscale, dbias,
                       rows, features, warp, vec, blocks, st);
}

// Paged decode attention: one query token per slot over its paged KV
// prefix.  q [S, H, 1, D], pools [N, L, H, D], table [S, P] int32,
// index [S] int32 -> out [S, H, 1, D] (q's dtype).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py _paged_attn_kernel (reached
// through paged_attention_pallas).
//
// Bound on the H100: bytes.  Slot s must read (Index[s]+1) x H x D pool
// elements of K and as many of V; the work is ~4 flops per element read,
// far below the card's ~20 flops per byte, and with one query row per
// head each head's product is a GEMV, so tensor cores do not help.
//
// Design: split-K over each slot's positions (flash-decoding), in two
// kernels that one entry point enqueues.
// - paged_split_kernel: block (j, s, g) owns slot s, positions
//   [j*split, (j+1)*split) and head group g (all H heads when a lane's
//   share of one position's row fits kChunks 16-byte chunks).  Blocks
//   whose first position lies past Index[s] exit at once, so the grid
//   covers the table's capacity without the host reading `index`.  One
//   position's K (and V) row of the head group is contiguous (H*D
//   elements: 1536 B in bf16 at H12 D64), so a warp reads it with one
//   16-byte load per lane and chunk, lanes on neighbouring addresses;
//   the lanes that hold one head (D*sizeof(T)/16 of them) reduce its dot
//   product with xor shuffles.  Each warp walks positions warp,
//   warp+4, ... two at a time, keeping its own running max, sum and f32
//   accumulator per head in registers: no barrier inside the loop.  The
//   four warps merge once at the end through shared memory, and the
//   block writes its (m, l, acc) per head to f32 scratch.
// - paged_combine_kernel: one block per (slot, head, 16 elements of D)
//   merges the live splits of its slot (m in log2 units, rescaled to
//   their max): 16 groups of threads take every 16th split, then meet
//   in shared memory in a fixed order.  No atomics, so a launch repeats
//   bit for bit.
// The split length is picked by the wrapper (kernels.paged_geometry):
// 64 positions, halved down to 16 while the grid holds fewer than two
// blocks per SM.  Sentinel page ids (num_blocks, an idle slot's row)
// clamp to N-1 as the TPU kernel's index map does, so an idle slot
// (index 0) gives that block's first V row; a slot with Index < 0 has
// no live split and gives 0.
//
// Head dims: codes D = 16, 32, 64 and 128 are built; head dim d (a
// multiple of 8 up to 128) runs the least code D >= d (common.cuh
// head_dim_code).  The pools and q keep their true d, heads packed at a
// stride of d: a lane's chunk c of the head group is head c / (D / vec),
// chunk c % (D / vec) of it, and reads zero past d, so the padded lanes
// add 0 to every dot product (a code at its own width keeps d a
// compile-time constant: `kPad`).  The scratch is laid out in the code's
// D; the combine kernel stores only the first d elements of each head.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;           // warps of a split block
constexpr int kThreads = kWarps * 32;
constexpr int kChunks = 4;          // most 16-byte chunks a lane holds
constexpr int kCombineD = 16;       // elements of D a combine block owns
constexpr int kCombineGroups = 16;  // its threads' groups of splits
constexpr int kCombineThreads = kCombineD * kCombineGroups;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Geometry {
  static constexpr int vec = ptt::Chunk<T>::n;     // elements a chunk
  static constexpr int lanes_per_head = D / vec;
  static constexpr int max_heads = kChunks * 32 / lanes_per_head;
};

// The element offset, in a head group's row of heads at a stride of d,
// of the lane chunk c of a code of lanes_per_head chunks a head; -1 past
// the head's d columns.
template <typename T>
__device__ __forceinline__ int chunk_offset(int c, int lanes_per_head,
                                            int d) {
  constexpr int vec = ptt::Chunk<T>::n;
  const int hh = c / lanes_per_head, cc = c - hh * lanes_per_head;
  return cc * vec < d ? hh * d + cc * vec : -1;
}

// one position's K and V chunks of this lane (chunk lane + 32 i of the
// head group's row), zero where the lane holds no chunk
template <typename T>
__device__ __forceinline__ void load_position(
    const T* __restrict__ pool_k, const T* __restrict__ pool_v,
    int64_t base, int lane, int n_chunks, int lanes_per_head, int d,
    uint4 (&k)[kChunks], uint4 (&v)[kChunks]) {
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + 32 * i;
    const int at =
        c < n_chunks ? chunk_offset<T>(c, lanes_per_head, d) : -1;
    if (at >= 0) {
      k[i] = ptt::Chunk<T>::raw(pool_k + base + at);
      v[i] = ptt::Chunk<T>::raw(pool_v + base + at);
    } else {
      k[i] = v[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// fold one position into the lane's running (m, l, acc) of each of its
// heads; scores are in log2 units (q carries scale * log2 e)
template <typename T, int D>
__device__ __forceinline__ void fold_position(
    const float (&qf)[kChunks][ptt::Chunk<T>::n], const uint4 (&k)[kChunks],
    const uint4 (&v)[kChunks], int n_chunks, float (&m)[kChunks],
    float (&l)[kChunks], float (&acc)[kChunks][ptt::Chunk<T>::n]) {
  using G = Geometry<T, D>;
  constexpr int vec = G::vec;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if (32 * i >= n_chunks) break;  // warp-uniform
    float kf[vec], vf[vec];
    ptt::Chunk<T>::unpack(k[i], kf);
    ptt::Chunk<T>::unpack(v[i], vf);
    float sc = 0.f;
#pragma unroll
    for (int e = 0; e < vec; ++e) sc = fmaf(qf[i][e], kf[e], sc);
#pragma unroll
    for (int o = G::lanes_per_head / 2; o > 0; o >>= 1)
      sc += __shfl_xor_sync(0xffffffffu, sc, o);
    const float m_new = fmaxf(m[i], sc);
    const float alpha = exp2f(m[i] - m_new);  // 0 on the first position
    const float p = exp2f(sc - m_new);
    l[i] = fmaf(l[i], alpha, p);
#pragma unroll
    for (int e = 0; e < vec; ++e)
      acc[i][e] = fmaf(acc[i][e], alpha, p * vf[e]);
    m[i] = m_new;
  }
}

template <typename T, int D, bool kPad>
__global__ void __launch_bounds__(kThreads)
    paged_split_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                       const T* __restrict__ pool_v,
                       const int* __restrict__ table,
                       const int* __restrict__ index,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int N, int L, int H,
                       int d_in, int P, int split, int n_splits,
                       int heads_per_block, float scale_log2) {
  using G = Geometry<T, D>;
  const int d = kPad ? d_in : D;  // the true head dim
  constexpr int vec = G::vec;
  __shared__ float sm_acc[kWarps][kChunks * 32 * vec];
  __shared__ float sm_m[kWarps][G::max_heads];
  __shared__ float sm_l[kWarps][G::max_heads];

  const int j = blockIdx.x, s = blockIdx.y;
  const int last = min(index[s], P * L - 1);  // last position attended
  const int t0 = j * split;
  if (t0 > last) return;  // the whole split lies past the query
  const int t1 = min(t0 + split, last + 1);
  const int h0 = blockIdx.z * heads_per_block;
  const int nh = min(heads_per_block, H - h0);
  const int n_chunks = nh * G::lanes_per_head;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float qf[kChunks][vec];
  const T* qrow = q + (static_cast<int64_t>(s) * H + h0) * d;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + 32 * i;
    const int at =
        c < n_chunks ? chunk_offset<T>(c, G::lanes_per_head, d) : -1;
    if (at >= 0) {
      ptt::Chunk<T>::unpack(ptt::Chunk<T>::raw(qrow + at), qf[i]);
#pragma unroll
      for (int e = 0; e < vec; ++e) qf[i][e] *= scale_log2;
    } else {
#pragma unroll
      for (int e = 0; e < vec; ++e) qf[i][e] = 0.f;
    }
  }
  float m[kChunks], l[kChunks], acc[kChunks][vec];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < vec; ++e) acc[i][e] = 0.f;
  }

  const int* trow = table + static_cast<int64_t>(s) * P;
  const int64_t row_elems = static_cast<int64_t>(H) * d;
  for (int t = t0 + warp; t < t1; t += 2 * kWarps) {
    const int u = t + kWarps;
    const bool two = u < t1;  // warp-uniform
    uint4 k0[kChunks], v0[kChunks], k1[kChunks], v1[kChunks];
    const int p0 = min(max(trow[t / L], 0), N - 1);
    load_position<T>(pool_k, pool_v,
                     (static_cast<int64_t>(p0) * L + t % L) * row_elems +
                         static_cast<int64_t>(h0) * d,
                     lane, n_chunks, G::lanes_per_head, d, k0, v0);
    if (two) {
      const int p1 = min(max(trow[u / L], 0), N - 1);
      load_position<T>(pool_k, pool_v,
                       (static_cast<int64_t>(p1) * L + u % L) * row_elems +
                           static_cast<int64_t>(h0) * d,
                       lane, n_chunks, G::lanes_per_head, d, k1, v1);
    }
    fold_position<T, D>(qf, k0, v0, n_chunks, m, l, acc);
    if (two) fold_position<T, D>(qf, k1, v1, n_chunks, m, l, acc);
  }

  // merge the four warps: a warp that saw no position has m = -inf and
  // weight 0; warp 0 saw t0, so the block's max is finite
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + 32 * i;
    if (c < n_chunks) {
#pragma unroll
      for (int e = 0; e < vec; ++e) sm_acc[warp][c * vec + e] = acc[i][e];
      if (c % G::lanes_per_head == 0) {
        sm_m[warp][c / G::lanes_per_head] = m[i];
        sm_l[warp][c / G::lanes_per_head] = l[i];
      }
    }
  }
  __syncthreads();
  const int64_t part = (static_cast<int64_t>(s) * n_splits + j) * H + h0;
  for (int e = threadIdx.x; e < nh * D; e += kThreads) {
    const int hh = e / D;
    float mx = sm_m[0][hh];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][hh]);
    float a = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(sm_m[w][hh] - mx);
      a = fmaf(sm_acc[w][e], wt, a);
      sum = fmaf(sm_l[w][hh], wt, sum);
    }
    part_acc[part * D + e] = a;
    if (e % D == 0) {
      part_ml[(part + hh) * 2] = mx;
      part_ml[(part + hh) * 2 + 1] = sum;
    }
  }
}

// one block per (slot, head, kCombineD elements of D): thread (g, dd)
// sums the splits j = g, g + kCombineGroups, ... of element dd, the
// groups meet in shared memory in a fixed order; the scratch is laid out
// in the code's D, out in the true head dim d (elements past d are not
// stored)
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    paged_combine_kernel(const float* __restrict__ part_acc,
                         const float* __restrict__ part_ml,
                         const int* __restrict__ index, T* __restrict__ out,
                         int H, int D, int d, int capacity, int split,
                         int n_splits) {
  __shared__ float scratch[32];
  __shared__ float sm_a[kCombineGroups][kCombineD];
  __shared__ float sm_l[kCombineGroups];
  const int s = blockIdx.x, h = blockIdx.y;
  const int d0 = blockIdx.z * kCombineD;
  const int g = threadIdx.x / kCombineD, dd = threadIdx.x % kCombineD;
  const int last = min(index[s], capacity - 1);
  const int live = last < 0 ? 0 : last / split + 1;
  const int64_t hd = static_cast<int64_t>(H) * D;
  const float* ml =
      part_ml + (static_cast<int64_t>(s) * n_splits * H + h) * 2;
  const float* pa =
      part_acc + static_cast<int64_t>(s) * n_splits * hd + h * D + d0 + dd;

  float mx = -CUDART_INF_F;
  for (int j = threadIdx.x; j < live; j += kCombineThreads)
    mx = fmaxf(mx, ml[j * 2 * H]);
  mx = ptt::block_max(mx, scratch);  // -inf when no split is live
  float a = 0.f, sum = 0.f;
#pragma unroll 4
  for (int j = g; j < live; j += kCombineGroups) {
    const float wt = exp2f(ml[j * 2 * H] - mx);
    sum = fmaf(ml[j * 2 * H + 1], wt, sum);
    a = fmaf(pa[j * hd], wt, a);
  }
  sm_a[g][dd] = a;
  if (dd == 0) sm_l[g] = sum;
  __syncthreads();
  if (g == 0 && d0 + dd < d) {
    float o = 0.f, l = 0.f;
#pragma unroll
    for (int k = 0; k < kCombineGroups; ++k) {
      o += sm_a[k][dd];
      l += sm_l[k];
    }
    out[(static_cast<int64_t>(s) * H + h) * d + d0 + dd] =
        ptt::from_f32<T>(live > 0 ? o / l : 0.f);
  }
}

template <typename T, int D>
int launch_d(const T* q, const T* pk, const T* pv, const int* table,
             const int* index, T* out, float* scratch, int S, int H, int d,
             int N, int L, int P, int split, int n_splits,
             int heads_per_block, float scale, cudaStream_t st) {
  using G = Geometry<T, D>;
  if (heads_per_block <= 0 || heads_per_block > G::max_heads ||
      split <= 0 || static_cast<int64_t>(split) * n_splits < P * L)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (H + heads_per_block - 1) / heads_per_block;
  float* part_acc = scratch;
  float* part_ml = scratch + static_cast<int64_t>(S) * n_splits * H * D;
  auto split_kernel = d == D ? paged_split_kernel<T, D, false>
                             : paged_split_kernel<T, D, true>;
  split_kernel<<<dim3(n_splits, S, groups), kThreads, 0, st>>>(
      q, pk, pv, table, index, part_acc, part_ml, N, L, H, d, P, split,
      n_splits, heads_per_block, scale * kLog2e);
  const dim3 cgrid(S, H, D / kCombineD);
  paged_combine_kernel<T><<<cgrid, kCombineThreads, 0, st>>>(
      part_acc, part_ml, index, out, H, D, d, P * L, split, n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* pk, const void* pv, const void* table,
           const void* index, void* out, void* scratch, int S, int H, int D,
           int N, int L, int P, int split, int n_splits,
           int heads_per_block, float scale, cudaStream_t st) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(pk);
  const T* vv = static_cast<const T*>(pv);
  const int* tb = static_cast<const int*>(table);
  const int* ix = static_cast<const int*>(index);
  T* oo = static_cast<T*>(out);
  float* sc = static_cast<float*>(scratch);
  switch (ptt::head_dim_code(D)) {
    case 16:
      return launch_d<T, 16>(qq, kk, vv, tb, ix, oo, sc, S, H, D, N, L, P,
                             split, n_splits, heads_per_block, scale, st);
    case 32:
      return launch_d<T, 32>(qq, kk, vv, tb, ix, oo, sc, S, H, D, N, L, P,
                             split, n_splits, heads_per_block, scale, st);
    case 64:
      return launch_d<T, 64>(qq, kk, vv, tb, ix, oo, sc, S, H, D, N, L, P,
                             split, n_splits, heads_per_block, scale, st);
    case 128:
      return launch_d<T, 128>(qq, kk, vv, tb, ix, oo, sc, S, H, D, N, L, P,
                              split, n_splits, heads_per_block, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Enqueues the split kernel and the combine kernel on `stream`.
// `scratch` holds slots * n_splits * heads * (code + 2) f32, code the
// head dim's compiled code (head_dim_code): each split's accumulator
// rows, then its (m, l) pairs.
extern "C" int ptt_paged_attention(const void* q, const void* pool_k,
                                   const void* pool_v, const void* table,
                                   const void* index, void* out,
                                   void* scratch, int slots, int heads,
                                   int head_dim, int num_blocks,
                                   int block_len, int pages, int split,
                                   int n_splits, int heads_per_block,
                                   float scale, int is_bf16, void* stream) {
  if (slots <= 0 || heads <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, pool_k, pool_v, table, index, out,
                                 scratch, slots, heads, head_dim, num_blocks,
                                 block_len, pages, split, n_splits,
                                 heads_per_block, scale, st);
  return launch<float>(q, pool_k, pool_v, table, index, out, scratch, slots,
                       heads, head_dim, num_blocks, block_len, pages, split,
                       n_splits, heads_per_block, scale, st);
}

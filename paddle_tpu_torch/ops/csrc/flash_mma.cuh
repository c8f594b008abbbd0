// Warp-level tensor-core building blocks of the flash attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): cp.async tile loads,
// ldmatrix, and mma.sync products in bf16 or in 3xTF32 for f32.
//
// A block is 4 warps (128 threads) and a tile is 64 rows: each warp owns
// 16 of them, the M of one m16n8 mma.  Tiles sit in shared memory
// row-major with 16 bytes of padding per row, so the 8 row addresses of
// an ldmatrix and the 32 scalar reads of a transposed tf32 fragment fall
// in distinct banks.
//
// bf16: mma.sync.m16n8k16 with f32 accumulators.  A fragments come from
// ldmatrix, B fragments from ldmatrix (a tile whose rows are the n index:
// K in Q.K^T) or ldmatrix.trans (rows are the k index: V in P.V).  The
// C layout of two neighbouring m16n8 accumulators is the A layout of one
// m16n8k16, so P (and dS) become A operands in registers, rounded to
// bf16 there and nowhere else.
//
// f32: mma.sync.m16n8k8 in tf32, three times per product ("3xTF32",
// CUTLASS's OpMultiplyAddFastF32): every operand x is split into
// hi = x rounded to tf32 to nearest, ties away (cvt.rna's rounding), and
// lo = x - hi, exact in f32; the accumulator takes lo.hi + hi.lo + hi.hi,
// about f32's accuracy at the tensor cores' rate.  hi is rounded with two
// integer operations, (bits + 0x1000) & ~0x1fff, the same value cvt.rna
// gives for finite x (the PTX cvt lowers to a longer sequence with
// NaN/Inf handling on sm_90a, which flash_builds.py times); lo enters the
// mma as it is and the tensor core reads its tf32 bits by truncation, as
// CUTLASS's converter for the small part does.  A single tf32 pass keeps
// 11 bits and is never used.  The C layout of an m16n8
// accumulator holds columns (2t, 2t+1) where the m16n8k8 A operand wants
// (t, t+4); the k index of a sum may be permuted, so `from_acc` takes the
// accumulator as it is and `load_bt` reads the B rows in the same
// permuted order (k 2t and 2t+1).  A and non-transposed B fragments come
// through ldmatrix too: an 8 x 8 b16 matrix is 8 rows of 4 f32, and lane
// 4g + t receives row g, word t, the tf32 fragment layout.
//
// The tensor cores add into their accumulator without rounding to
// nearest, so a long sum fed straight by mma drifts; `mma<true>` sums
// each k-step's three products from zero and adds them to the running
// sum with FADD (the forward's products, whose rounding reaches the
// model's activations), and the backward adds each 32-row step's
// partial product with FADD (flash_attention_bwd.cu).
#pragma once

#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace ptt {
namespace fa {

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // rows of a tile: 16 per warp
constexpr float kLog2e = 1.4426950408889634f;

// Row stride of a padded tile in elements: D + 16 bytes.
template <typename T, int D>
__host__ __device__ constexpr int ld() {
  return D + 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 fills the 16 bytes with 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async rows [row0, row0 + kRows) of a row-major [rows x D] matrix at
// src into a padded tile; rows at or past `rows` read as zeros.  Every
// thread of the block calls it; the caller commits the group.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int rows) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = D / kVec;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec, gr = row0 + r;
    const bool in = gr < rows;
    cp_async16(dst + r * ld<T, D>() + c,
               src + static_cast<int64_t>(in ? gr : 0) * D + c, in ? 16 : 0);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a . b, the accumulator starting from zero
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// 2^x to about 2 ulp (MUFU.EX2); 0 for -inf.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Fragments and one mma of each element type.  `s` points at row 0 of a
// padded tile (or of the warp's 16 rows for an A operand); lane = 4g + t.
template <typename T>
struct Tc;

template <>
struct Tc<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kK = 16;  // depth of one mma
  struct A {
    uint32_t x[4];
  };
  struct B {
    uint32_t x[2];
  };

  // A fragment of the 16 x 16 block at columns k0.. of 16 rows.
  __device__ static __forceinline__ A load_a(const T* s, int ld, int k0) {
    const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
    A a;
    ldsm_x4(a.x, s + ((i & 1) * 8 + r) * ld + k0 + (i >> 1) * 8);
    return a;
  }
  // B fragments of n-blocks n0.. and n0+8.., depth k0..k0+15, from a tile
  // whose rows are n (K in Q.K^T).
  __device__ static __forceinline__ void load_b(B& b0, B& b1, const T* s,
                                                int ld, int n0, int k0) {
    const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
    uint32_t x[4];
    ldsm_x4(x, s + (n0 + (i >> 1) * 8 + r) * ld + k0 + (i & 1) * 8);
    b0 = {{x[0], x[1]}};
    b1 = {{x[2], x[3]}};
  }
  // The same from a tile whose rows are k (V in P.V).
  __device__ static __forceinline__ void load_bt(B& b0, B& b1, const T* s,
                                                 int ld, int k0, int n0) {
    const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
    uint32_t x[4];
    ldsm_x4_t(x, s + (k0 + (i & 1) * 8 + r) * ld + n0 + (i >> 1) * 8);
    b0 = {{x[0], x[1]}};
    b1 = {{x[2], x[3]}};
  }
  // A fragment of depth block kb (columns 16kb..) of an f32 accumulator
  // [16 x 8NB], rounded to bf16.
  template <int NB>
  __device__ static __forceinline__ A from_acc(const float (&c)[NB][4],
                                               int kb) {
    const float* c0 = c[2 * kb];
    const float* c1 = c[2 * kb + 1];
    return {{pack_bf16(c0[0], c0[1]), pack_bf16(c0[2], c0[3]),
             pack_bf16(c1[0], c1[1]), pack_bf16(c1[2], c1[3])}};
  }
  // c += a . b (one mma: nothing to sum apart, whatever kExact)
  template <bool kExact>
  __device__ static __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    mma_bf16(c, a.x, b.x[0], b.x[1]);
  }
};

template <>
struct Tc<float> {
  using T = float;
  static constexpr int kK = 8;
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };

  __device__ static __forceinline__ A load_a(const T* s, int ld, int k0) {
    const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
    uint32_t x[4];
    ldsm_x4(x, s + ((i & 1) * 8 + r) * ld + k0 + (i >> 1) * 4);
    A a;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32(__uint_as_float(x[e]), a.hi[e], a.lo[e]);
    return a;
  }
  __device__ static __forceinline__ void load_b(B& b0, B& b1, const T* s,
                                                int ld, int n0, int k0) {
    const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
    uint32_t x[4];
    ldsm_x4(x, s + (n0 + (i >> 1) * 8 + r) * ld + k0 + (i & 1) * 4);
    split_tf32(__uint_as_float(x[0]), b0.hi[0], b0.lo[0]);
    split_tf32(__uint_as_float(x[1]), b0.hi[1], b0.lo[1]);
    split_tf32(__uint_as_float(x[2]), b1.hi[0], b1.lo[0]);
    split_tf32(__uint_as_float(x[3]), b1.hi[1], b1.lo[1]);
  }
  // k in the permuted order of `from_acc`: b0 holds rows k0+2t, k0+2t+1.
  __device__ static __forceinline__ void load_bt(B& b0, B& b1, const T* s,
                                                 int ld, int k0, int n0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const T* p = s + (k0 + 2 * t) * ld + n0 + g;
    split_tf32(p[0], b0.hi[0], b0.lo[0]);
    split_tf32(p[ld], b0.hi[1], b0.lo[1]);
    split_tf32(p[8], b1.hi[0], b1.lo[0]);
    split_tf32(p[ld + 8], b1.hi[1], b1.lo[1]);
  }
  // A fragment of depth block kb (columns 8kb..) of an accumulator, k
  // permuted: A column t is accumulator column 2t, column t+4 is 2t+1.
  template <int NB>
  __device__ static __forceinline__ A from_acc(const float (&c)[NB][4],
                                               int kb) {
    const float* x = c[kb];
    A a;
    split_tf32(x[0], a.hi[0], a.lo[0]);
    split_tf32(x[2], a.hi[1], a.lo[1]);
    split_tf32(x[1], a.hi[2], a.lo[2]);
    split_tf32(x[3], a.hi[3], a.lo[3]);
    return a;
  }
  // c += a . b in 3xTF32, the small terms first, then hi.hi; kExact sums
  // the three from zero and adds them with FADD.
  template <bool kExact>
  __device__ static __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    if constexpr (kExact) {
      float d[4];
      mma_tf32_zero(d, a.lo, b.hi);
      mma_tf32(d, a.hi, b.lo);
      mma_tf32(d, a.hi, b.hi);
#pragma unroll
      for (int e = 0; e < 4; ++e) c[e] += d[e];
    } else {
      mma_tf32(c, a.lo, b.hi);
      mma_tf32(c, a.hi, b.lo);
      mma_tf32(c, a.hi, b.hi);
    }
  }
};

// acc[16 x N] += A[16 x D] . B[N x D]^T: A from the warp's 16 rows at
// `a`, B from N rows at `b`, both padded tiles of stride `ld`; kExact as
// in `Tc::mma`.
template <typename T, int N, int D, bool kExact = false>
__device__ __forceinline__ void gemm_nt(float (&acc)[N / 8][4], const T* a,
                                        const T* b, int ld) {
  using M = Tc<T>;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += M::kK) {
    const typename M::A af = M::load_a(a, ld, k0);
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      typename M::B b0, b1;
      M::load_b(b0, b1, b, ld, n0, k0);
      M::template mma<kExact>(acc[n0 / 8], af, b0);
      M::template mma<kExact>(acc[n0 / 8 + 1], af, b1);
    }
  }
}

// The same with A's fragments held in registers (`af[kb]` covers columns
// kb * kK..).
template <typename T, int N, int D, bool kExact = false>
__device__ __forceinline__ void gemm_nt_reg(
    float (&acc)[N / 8][4], const typename Tc<T>::A (&af)[D / Tc<T>::kK],
    const T* b, int ld) {
  using M = Tc<T>;
#pragma unroll
  for (int kb = 0; kb < D / M::kK; ++kb) {
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      typename M::B b0, b1;
      M::load_b(b0, b1, b, ld, n0, kb * M::kK);
      M::template mma<kExact>(acc[n0 / 8], af[kb], b0);
      M::template mma<kExact>(acc[n0 / 8 + 1], af[kb], b1);
    }
  }
}

// acc[16 x D] += P[16 x N] . B[N x D]: P an f32 accumulator of the same
// warp (rounded only as this product's operand), B from N rows at `b`.
template <typename T, int N, int D, bool kExact = false>
__device__ __forceinline__ void gemm_pn(float (&acc)[D / 8][4],
                                        const float (&p)[N / 8][4],
                                        const T* b, int ld) {
  using M = Tc<T>;
#pragma unroll
  for (int kb = 0; kb < N / M::kK; ++kb) {
    const typename M::A af = M::from_acc(p, kb);
#pragma unroll
    for (int n0 = 0; n0 < D; n0 += 16) {
      typename M::B b0, b1;
      M::load_bt(b0, b1, b, ld, kb * M::kK, n0);
      M::template mma<kExact>(acc[n0 / 8], af, b0);
      M::template mma<kExact>(acc[n0 / 8 + 1], af, b1);
    }
  }
}

// Store the warp's [16 x D] accumulator, scaled per row by mul[rr] (rr 0
// for row g, 1 for row g + 8), as rows w0.. of a [rows x D] matrix.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[D / 8][4],
                                           const float (&mul)[2], int w0,
                                           int rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = w0 + g + 8 * rr;
    if (row >= rows) continue;
    T* p = dst + static_cast<int64_t>(row) * D + 2 * t;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const float x = acc[nb][2 * rr] * mul[rr];
      const float y = acc[nb][2 * rr + 1] * mul[rr];
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float2*>(p + nb * 8) = make_float2(x, y);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(p + nb * 8) =
            __floats2bfloat162_rn(x, y);
      }
    }
  }
}

// cudaErrorMisalignedAddress unless every pointer is 16-byte aligned (the
// cp.async copies need it; torch's allocations are).
__host__ inline int check_aligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  return 0;
}

// Opt a kernel in to `bytes` of dynamic shared memory (above 48 KB only
// on request).
template <typename Kernel>
__host__ inline int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace fa
}  // namespace ptt

// Tile helpers shared by the flash kernels (flash_attention.cu, dense, and
// flash_sparse.cu, block-sparse): the CUDA-core thread layout (128 threads,
// RG row groups x CG column lanes), the dropout hash, fp32 row staging, and
// the mma.sync fragment loaders and products.  Kept in one place so that the
// dense and the sparse kernels draw bit-identical dropout masks and round
// at the same points.  Include after common.cuh.

#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int RG = 16;  // row groups: thread tid owns rows i*RG + tid/CG
constexpr int CG = 8;   // column lanes: and columns j*CG + tid%CG
// x rounded to T and widened back (the casts p.astype(v.dtype) and
// ds.astype(k.dtype) before a product with fp32 accumulation)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  h *= 0x297A2D39u;
  h ^= h >> 15;
  return h;
}

// fmix32 after its first step h ^= h >> 15.  A logical right shift
// distributes over ^, so keep_scale's hash of row term x and column term y
// is fmix32_tail((x ^ x >> 15) ^ (y ^ y >> 15)): the wgmma kernels take the
// first step of each term once a row or a column, the same bits
__device__ __forceinline__ uint32_t fmix32_tail(uint32_t h) {
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  h *= 0x297A2D39u;
  h ^= h >> 15;
  return h;
}

// the {0, 1/keep} mask value of (q, k) for a row block with hash term bhm
template <typename P>
__device__ __forceinline__ float keep_scale(const P& p, uint32_t bhm, int q,
                                            int k) {
  const uint32_t h = fmix32(p.seed_h ^ bhm ^ (uint32_t(q) * 0x85EBCA6Bu) ^
                            (uint32_t(k) * 0xC2B2AE35u));
  return h < p.thr ? p.inv_keep : 0.f;
}

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < CG; o <<= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < CG; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// rows [row0, row0 + tile_rows) of a [nrows, D] matrix -> fp32 shared rows
// of stride D + 1, times mul; rows past nrows are zero-filled
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0,
                                          int nrows, int tile_rows, float mul) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < tile_rows * VPR; i += THREADS) {
    const int rr = i / VPR, cc = (i % VPR) * VEC;
    const int g = row0 + rr;
    float f[VEC];
    if (g < nrows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + size_t(g) * D + cc);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int t = 0; t < VEC; ++t) f[t] = to_f(e[t]) * mul;
    } else {
#pragma unroll
      for (int t = 0; t < VEC; ++t) f[t] = 0.f;
    }
    float* d = dst + rr * (D + 1) + cc;
#pragma unroll
    for (int t = 0; t < VEC; ++t) d[t] = f[t];
  }
}

// two consecutive elements (row, col), col even, as one 32-bit word; 0 past
// the last row
template <typename T>
__device__ __forceinline__ uint32_t ld_pair(const T* base, int row, int nrows,
                                            int ld, int col) {
  return row < nrows
             ? *reinterpret_cast<const uint32_t*>(base + size_t(row) * ld + col)
             : 0u;
}

// rows [row0, row0 + tile_rows) of a [nrows, D] matrix -> shared rows of
// stride LD elements, zero past nrows
template <typename T, int D, int LD>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int row0,
                                           int nrows, int tile_rows) {
  constexpr int VEC = 8, VPR = D / VEC;
  for (int i = threadIdx.x; i < tile_rows * VPR; i += THREADS) {
    const int rr = i / VPR, cc = (i % VPR) * VEC;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row0 + rr < nrows)
      raw = *reinterpret_cast<const uint4*>(src + size_t(row0 + rr) * D + cc);
    *reinterpret_cast<uint4*>(dst + rr * LD + cc) = raw;
  }
}

// the same rows transposed: dst[d][r] (stride LD), for the B operand of a
// product that sums over rows
template <typename T, int D, int LD>
__device__ __forceinline__ void stage_cols(T* dst, const T* src, int row0,
                                           int nrows, int tile_rows) {
  constexpr int VEC = 8;
  for (int i = threadIdx.x; i < tile_rows * (D / VEC); i += THREADS) {
    const int rr = i % tile_rows, cc = (i / tile_rows) * VEC;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row0 + rr < nrows)
      raw = *reinterpret_cast<const uint4*>(src + size_t(row0 + rr) * D + cc);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[(cc + j) * LD + rr] = e[j];
  }
}

// A fragments of a warp's 16 rows [r, r + 16) of a [nrows, D] matrix
template <typename T, int D>
__device__ __forceinline__ void load_a(uint32_t (*a)[4], const T* base,
                                       int r, int nrows, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = ld_pair(base, r + g, nrows, D, 16 * kk + 2 * t);
    a[kk][1] = ld_pair(base, r + g + 8, nrows, D, 16 * kk + 2 * t);
    a[kk][2] = ld_pair(base, r + g, nrows, D, 16 * kk + 8 + 2 * t);
    a[kk][3] = ld_pair(base, r + g + 8, nrows, D, 16 * kk + 8 + 2 * t);
  }
}

// acc[nt] (16 x 8 each) += A (16 x 16*KD, registers) . B, B[k][n] read as
// sB[(n0 + n) * LD + k]: the rows of sB are B's columns
template <typename T, int KD, int NT, int LD>
__device__ __forceinline__ void mma_tiles(float (*acc)[4], uint32_t (*a)[4],
                                          const T* sB, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const T* b = sB + (nt * 8 + g) * LD + 16 * kk + 2 * t;
      Mma<T>::run(acc[nt], a[kk], *reinterpret_cast<const uint32_t*>(b),
                  *reinterpret_cast<const uint32_t*>(b + 8));
    }
}

// C fragments of a 16 x (16*KK) matrix, rounded to T -> A fragments
template <typename T, int KK>
__device__ __forceinline__ void c_to_a(uint32_t (*a)[4], float (*c)[4]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    a[kk][0] = Mma<T>::pack(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = Mma<T>::pack(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = Mma<T>::pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = Mma<T>::pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// acc[nt] += A . B with the A fragments of 16 rows [0, 16) of sA (row
// stride LDA) read from shared memory
template <typename T, int KD, int NT, int LDA, int LDB>
__device__ __forceinline__ void mma_tiles_sa(float (*acc)[4], const T* sA,
                                             const T* sB, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const T* ar = sA + g * LDA + 16 * kk + 2 * t;
    uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(ar),
                     *reinterpret_cast<const uint32_t*>(ar + 8 * LDA),
                     *reinterpret_cast<const uint32_t*>(ar + 8),
                     *reinterpret_cast<const uint32_t*>(ar + 8 * LDA + 8)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const T* b = sB + (nt * 8 + g) * LDB + 16 * kk + 2 * t;
      Mma<T>::run(acc[nt], a, *reinterpret_cast<const uint32_t*>(b),
                  *reinterpret_cast<const uint32_t*>(b + 8));
    }
  }
}

// acc += C . B for an fp32 C (16 x 16*KK, C fragments) that the function
// keeps in fp32: C goes to the tensor cores as three bf16 terms, each the
// bf16 rounding of what the terms before it left (x - bf16(x) is exact in
// fp32), so hi + mid + lo carries C to 2^-24 relative, as fp32 does.  C is
// consumed (left holding the last residual).
template <int KK, int DN, int LDB>
__device__ __forceinline__ void mma_fp32_a(float (*acc)[4], float (*c)[4],
                                           const __nv_bfloat16* sB, int g,
                                           int t) {
#pragma unroll
  for (int level = 0; level < 3; ++level) {
    uint32_t a[KK][4];
    c_to_a<__nv_bfloat16, KK>(a, c);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&a[kk][j]);
        // a[kk][j] holds c[2kk + (j >> 1)][2 (j & 1) + {0, 1}]
        float* cc = c[2 * kk + (j >> 1)] + 2 * (j & 1);
        cc[0] -= __bfloat162float(h.x);
        cc[1] -= __bfloat162float(h.y);
      }
    mma_tiles<__nv_bfloat16, KK, DN, LDB>(acc, a, sB, g, t);
  }
}

// f(ea, eb, ec) with each flag as std::true_type or std::false_type: one
// instantiation of f's body per combination, chosen at run time (the wgmma
// kernels' elementwise passes, whose masks, bias and hash compile away
// where they are off)
template <typename F>
__device__ __forceinline__ void with_flags(bool a, bool b, bool c, F&& f) {
  auto on_c = [&](auto x, auto y) {
    if (c) f(x, y, std::true_type{}); else f(x, y, std::false_type{});
  };
  auto on_b = [&](auto x) {
    if (b) on_c(x, std::true_type{}); else on_c(x, std::false_type{});
  };
  if (a) on_b(std::true_type{}); else on_b(std::false_type{});
}

template <typename KernelT>
cudaError_t set_smem(KernelT kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

}  // namespace

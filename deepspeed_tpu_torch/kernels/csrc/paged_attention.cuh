// Paged attention over a block-table KV cache, written for Hopper (sm_90a):
// the kernels, their launchers and the C entry's checks, shared by the
// libraries of paged_attention.cu (fp32 and bf16 caches),
// paged_attention_f16.cu, paged_attention_int8.cu and
// paged_attention_int4.cu — one library per cache kind, so that the
// kernel's many instantiations compile in parallel.
//
// Replaces the TPU kernel `_paged_kernel` (deepspeed_tpu/kernels/paged.py:127,
// wrapper `paged_attention_pallas` :176), dense and int8/int4 branches.
// Computes what `paged_attention_reference` computes
// (deepspeed_tpu_torch/kernels/paged.py): for every slot b, query row t and
// head h,
//     out[b,t,h,:] = softmax_k( where(q_pos[b,t] >= k, q.K_k * Dh^-0.5, NEG_INF) ) . V
// over the slot's L cache rows: key k lives at cache row rows[b, k] (the
// rows are the walk of the slot's block table, serving/kv_cache.py
// `rows_for_tables`).  q is read where it lies (a strided view of the fused
// QKV output); rows and q_pos are the int64 tensors the serving programs
// build once per step, so a call launches one kernel and nothing else.  The
// cache is one of:
//   * dense [num_rows, H, Dh] in fp32, bf16 or fp16 (q in fp32 or the cache
//     dtype); the output is written in the cache dtype;
//   * int8: codes [num_rows, H, Dh] plus one fp16 scale per (row, head)
//     [num_rows, H] for K and for V; int4: the codes packed two a byte, low
//     nibble first, [num_rows, H, Dh / 2] (runtime/comm/quant.py
//     `quantize_rows`).  The dequant is fused into the gather: the staged
//     codes are decoded in registers (the int4 nibbles sign-extended), times
//     the row's fp16 scale in fp32 — exact, as the reference's
//     `codes * scales` is — and the marker code -qmax-1 becomes NaN
//     (paged.py:103-124).  q is fp32, bf16 or fp16; the output is fp32
//     (paged.py:211).
//
// What bounds it on this card: bytes at decode and verify (each live K/V
// row is read once and does 4 Dh FLOPs per query row: a few FLOPs per byte
// against the H100's ~295); at a prefill chunk of 128 rows the same bytes
// carry 128x the work, so there the CUDA cores' fp32 FMAs, not the bytes,
// were the limit.  A quantized cache moves fewer bytes for the same keys:
// per live key and head, K and V take 2 (Dh + 2) bytes at int8 and
// 2 (Dh / 2 + 2) at int4, against 4 Dh at bf16.  Two routes, picked on the
// host (kernels/paged.py `route`):
//
//   * split keys (every cache kind, q dtype and head_dim; decode, verify and
//     any prefill the tensor-core route does not take).  The grid is
//     (slot*head x key split, q tile, column block).  A q tile is TQ = 1 row
//     at decode (T = 1) and 8 otherwise.  The host plans the splits from the
//     batch, the head count, T and the table width L alone (paged.py
//     `split_plan`, no device value read): S ranges of `split_keys` keys (a
//     multiple of 128), so that the grid fills the 132 SMs many times over
//     at small batch, where one block per (slot, head) would walk a long
//     table alone; a decode grid whose (slot, head) blocks already cover
//     the SMs keeps one range (there the merge cost more than the split
//     saved: GPT-2 XL decode at B 8, PERF.md section 6).  A split walks its
//     keys in chunks of KC = 128: each chunk's row indices are loaded once
//     (one thread per key), clamped, turned into byte offsets and kept in
//     shared memory with the key's K and V scales when quantized; its K and
//     V rows are staged with cp.async (double-buffered when the split has
//     more than one chunk, so the next chunk's index loads and copies
//     overlap this chunk's math); rows are padded by 16 bytes so the
//     per-lane reads are bank-conflict free.  Each of the 4 warps takes 32
//     keys of a chunk for every row of the tile with its own fp32 online
//     softmax (lane j scores key j, shuffles reduce max and sum; for P.V a
//     lane owns ceil(cols/32) output columns), the warps' partials are
//     merged through shared memory in warp order, and with S > 1 each block
//     writes its (m, l, acc) to fp32 scratch.  A split that starts past its
//     tile's live length writes (m = NEG_INF, l = 0) and exits.  The last
//     block of a group, found by an atomic ticket after a __threadfence
//     (per (slot*head, tile, column block); the wrapper keeps the tickets
//     per device, zeroed once, and the merging block resets its own), merges
//     the S partials in split order — a fixed order, so the output does not
//     depend on which block finished last and is bitwise repeatable.
//   * tensor cores (T >= 16, a dense bf16/fp16 cache, q in the cache dtype,
//     Dh 64 or 128): 4 warps a block own 64 query rows, 16 a warp, with q's
//     A fragments in registers; 64-key K/V chunks are gathered with 16-byte
//     cp.async (TMA cannot gather arbitrary rows), double-buffered; S = Q.K^T
//     and O += P.V are mma.sync m16n8k16 with fp32 accumulators (V read by
//     ldmatrix.trans).  The causal select reads the absolute positions of
//     q_pos (never assumes them contiguous).  P.V takes p as two terms of
//     the cache dtype (hi + lo: two products a step) so that the products
//     carry p as fp32 would.  The same key splits and ticketed merge as
//     above.
//
// Head dims: 64 and 128 are compiled as such (16-byte staging, loops
// unrolled).  Every other head_dim runs the head_dim-generic instantiation
// of the split-keys route: a row is staged 4 bytes at a time with cp.async
// where its byte length is a multiple of 4, and otherwise in 2- or 1-byte
// pieces by plain loads (an odd Dh at bf16 or int8), into a shared-memory
// row padded with zeros to a whole 4-byte word; q's staged row is padded the
// same way, so the padding adds exactly 0 to every score and the cache
// itself is never padded.  A block accumulates at most COLS = 256 output
// columns and stages only those columns of V; a larger head_dim splits its
// columns over blocks (grid.z), each scoring the whole row.  Above
// PIECE = 1024 columns the score q.k is streamed over pieces of at most
// 1024 columns (q's piece and the keys' piece staged, the partial dot
// products added in registers), so shared memory does not grow with Dh:
// only grid.z (65535 column blocks) bounds the head_dim.  Where 32 keys a
// warp would not fit in shared memory, a warp takes 16, 8, ... .
//
// Exactness notes (the guards of the TPU kernel, kept):
//   * the causal mask is a select to NEG_INF, never an additive bias;
//   * p is zeroed where s <= NEG_INF/2: on a chunk with no live key and the
//     running max still at NEG_INF, exp(s - m) would be 1 (paged.py:158-160);
//     a warp, split or block that saw no key carries l = 0 and is weighted 0
//     (or skipped) in every merge;
//   * the final division happens only where l > 0: a row with no live key
//     is 0, as the TPU kernel leaves it (paged.py `_finish`);
//   * keys past the live length are zero-filled in shared memory and
//     masked, and a masked key contributes exactly 0 (decode passes the
//     whole table, trash block 0 included);
//   * row indices are clamped into [0, num_rows), as the TPU kernel's index
//     map clamps its table entries, so a bad entry cannot read out of bounds.
//   * the split-keys route keeps the probabilities fp32 into P.V (the
//     reference rounds them to a dense cache's dtype first), so at bf16 the
//     two differ by about one bf16 rounding of the output; the tensor-core
//     route carries each p as two terms of the cache dtype, hi + lo (see
//     `split_p`), whose sum is p to u^2, so it holds the same bound
//     (paged.py `bf16_tolerance`); rounding p once, as the reference does,
//     would not: the kernel's p (against its running max) and the
//     reference's (normalised) round apart, and on values of mixed sign
//     their errors can add up to twice the bound's term.

#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int KW = 32;                  // keys per warp per chunk: one per lane
constexpr int KC = WARPS * KW;          // keys per staged chunk (at most)
// output columns a thread block accumulates (8 a lane): a larger head_dim
// splits its columns over blocks on grid.z
constexpr int COLS = 256;
// score columns staged at once: a larger head_dim streams q.k over pieces
constexpr int PIECE = 1024;
// the key splits are whole multiples of this many keys (kernels/paged.py
// `split_plan` plans them so)
constexpr int SPLIT_UNIT = KC;

// How the cache stores a row of Dh values for one head.  N: values per
// 16-byte vector and N4 per 4-byte word; unpack / unpack4: one vector or
// word -> that many floats; get: value `col` of a staged row.  `scale` is
// the row's dequant scale (ignored when dense).
template <typename T> struct Dense {
  static constexpr bool QUANT = false;
  static constexpr int N = 16 / sizeof(T), N4 = 4 / sizeof(T);
  using Out = T;
  __host__ __device__ static constexpr int row_bytes(int dh) { return dh * int(sizeof(T)); }
  __device__ __forceinline__ static void unpack(const uint4& r, float* f, float) {
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f(e[i]);
  }
  __device__ __forceinline__ static void unpack4(uint32_t r, float* f, float) {
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < N4; ++i) f[i] = to_f(e[i]);
  }
  __device__ __forceinline__ static float get(const unsigned char* row, int col, float) {
    return to_f(reinterpret_cast<const T*>(row)[col]);
  }
};

// int8 codes; the marker -128 (-qmax-1) dequantizes to NaN
struct Int8 {
  static constexpr bool QUANT = true;
  static constexpr int N = 16, N4 = 4;
  using Out = float;
  __host__ __device__ static constexpr int row_bytes(int dh) { return dh; }
  __device__ __forceinline__ static float dq(int c, float scale) {
    return c == -128 ? __int_as_float(0x7fc00000) : float(c) * scale;
  }
  __device__ __forceinline__ static void unpack(const uint4& r, float* f, float scale) {
    const int8_t* e = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = dq(e[i], scale);
  }
  __device__ __forceinline__ static void unpack4(uint32_t r, float* f, float scale) {
    const int8_t* e = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
    for (int i = 0; i < N4; ++i) f[i] = dq(e[i], scale);
  }
  __device__ __forceinline__ static float get(const unsigned char* row, int col, float scale) {
    return dq(reinterpret_cast<const int8_t*>(row)[col], scale);
  }
};

// int4 codes, two a byte, low nibble first, two's complement; the marker
// -8 dequantizes to NaN
struct Int4 {
  static constexpr bool QUANT = true;
  static constexpr int N = 32, N4 = 8;
  using Out = float;
  __host__ __device__ static constexpr int row_bytes(int dh) { return dh / 2; }
  __device__ __forceinline__ static float dq(int nib, float scale) {
    const int c = nib > 7 ? nib - 16 : nib;
    return c == -8 ? __int_as_float(0x7fc00000) : float(c) * scale;
  }
  __device__ __forceinline__ static void unpack(const uint4& r, float* f, float scale) {
    const uint8_t* e = reinterpret_cast<const uint8_t*>(&r);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      f[2 * i] = dq(e[i] & 0x0F, scale);
      f[2 * i + 1] = dq(e[i] >> 4, scale);
    }
  }
  __device__ __forceinline__ static void unpack4(uint32_t r, float* f, float scale) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t b = (r >> (8 * i)) & 0xFF;
      f[2 * i] = dq(b & 0x0F, scale);
      f[2 * i + 1] = dq(b >> 4, scale);
    }
  }
  __device__ __forceinline__ static float get(const unsigned char* row, int col, float scale) {
    const uint8_t b = row[col >> 1];
    return dq((col & 1) ? (b >> 4) : (b & 0x0F), scale);
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ int warp_max_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

// dynamic shared memory a block may take beside the kernel's static arrays
constexpr size_t SMEM_LIMIT = 220 * 1024;

// -- the split merge -------------------------------------------------------------
//
// Scratch `part` holds every split's unnormalised accumulator, [groups]
// [n_splits][rows][cw] floats (a group is a (slot*head, q tile, column
// block)), then every split's running max m and denominator l,
// [groups][n_splits][rows][2].

// the partials of group `grp`
struct Parts {
  float* acc;  // [n_splits][rows][cw]
  float* ml;   // [n_splits][rows][2]
};
__device__ __forceinline__ Parts group_parts(float* part, int grp, int groups,
                                             int n_splits, int rows, int cw) {
  const size_t per = size_t(n_splits) * rows;
  return {part + size_t(grp) * per * cw,
          part + size_t(groups) * per * cw + size_t(grp) * per * 2};
}

// every block of a group calls this once its partial is written; true in
// the last block of the group to arrive (the one that merges)
__device__ __forceinline__ bool last_of_group(int* tickets, int grp, int n_splits,
                                              int* s_last) {
  __threadfence();  // the partial is visible before the ticket is taken
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(&tickets[grp], 1) == n_splits - 1;
    if (last) tickets[grp] = 0;  // every other block has taken its ticket
    *s_last = last;
  }
  __syncthreads();
  if (*s_last) __threadfence();
  return *s_last;
}

// what the merge keeps in shared memory: a factor per (row, split) and a
// denominator per row (kernels/paged.py `split_plan` caps the splits so
// that rows x n_splits <= MERGE_FACTORS)
constexpr int MERGE_FACTORS = 1024, MERGE_ROWS = 64;
constexpr size_t MERGE_BYTES = (MERGE_FACTORS + MERGE_ROWS) * sizeof(float);

// the last block merges the group's n splits in split order:
// out = sum_s f_s acc_s / sum_s f_s l_s, f_s = exp(m_s - max m), a split
// with l = 0 (no live key) skipped; 0 where no split saw a key.  First each
// row's factors and denominator into shared memory (`sm`, MERGE_BYTES),
// then the output elements, four columns a load where they align and two
// such groups a thread at once, so that the partials' loads overlap.
template <typename OT>
__device__ void merge_splits(Parts pa, int n, int rows, int nt, int ncols,
                             int cw, OT* out, long long row_stride, float* sm) {
  float* sF = sm;                    // [rows][n]
  float* sL = sm + MERGE_FACTORS;    // [rows]
  const size_t ms = size_t(rows) * 2;     // floats between two splits' (m, l)
  for (int r = threadIdx.x; r < nt; r += blockDim.x) {
    const float* ml = pa.ml + size_t(r) * 2;
    float m_all = NEG_INF;
    for (int s = 0; s < n; ++s) m_all = fmaxf(m_all, __ldcg(ml + s * ms));
    float l_all = 0.f;
    for (int s = 0; s < n; ++s) {
      const float l = __ldcg(ml + s * ms + 1);
      float f = -1.f;   // skipped: no key of this split is live
      if (l != 0.f) {   // NaN (a NaN marker's score) is kept, as the reference keeps it
        f = expf(__ldcg(ml + s * ms) - m_all);
        l_all = fmaf(l, f, l_all);
      }
      sF[r * n + s] = f;
    }
    sL[r] = l_all;
  }
  __syncthreads();
  const size_t ss = size_t(rows) * cw;   // floats between two splits' partials
  if (ncols % 4 == 0 && cw % 4 == 0) {
    const int q4 = ncols / 4, total = nt * q4;
    for (int i0 = threadIdx.x; i0 < total; i0 += 2 * blockDim.x) {
      const int i1 = i0 + blockDim.x;
      const bool has1 = i1 < total;
      const int r0 = i0 / q4, c0 = (i0 % q4) * 4;
      const int r1 = has1 ? i1 / q4 : r0, c1 = has1 ? (i1 % q4) * 4 : c0;
      const float* a0 = pa.acc + size_t(r0) * cw + c0;
      const float* a1 = pa.acc + size_t(r1) * cw + c1;
      float4 o0 = make_float4(0.f, 0.f, 0.f, 0.f), o1 = o0;
#pragma unroll 4
      for (int s = 0; s < n; ++s) {
        const float f0 = sF[r0 * n + s], f1 = has1 ? sF[r1 * n + s] : -1.f;
        if (f0 >= 0.f) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(a0 + s * ss));
          o0.x = fmaf(f0, v.x, o0.x);
          o0.y = fmaf(f0, v.y, o0.y);
          o0.z = fmaf(f0, v.z, o0.z);
          o0.w = fmaf(f0, v.w, o0.w);
        }
        if (f1 >= 0.f) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(a1 + s * ss));
          o1.x = fmaf(f1, v.x, o1.x);
          o1.y = fmaf(f1, v.y, o1.y);
          o1.z = fmaf(f1, v.z, o1.z);
          o1.w = fmaf(f1, v.w, o1.w);
        }
      }
      const float l0 = sL[r0];
      OT* d0 = out + r0 * row_stride + c0;
      d0[0] = from_f<OT>(l0 == 0.f ? 0.f : o0.x / l0);
      d0[1] = from_f<OT>(l0 == 0.f ? 0.f : o0.y / l0);
      d0[2] = from_f<OT>(l0 == 0.f ? 0.f : o0.z / l0);
      d0[3] = from_f<OT>(l0 == 0.f ? 0.f : o0.w / l0);
      if (has1) {
        const float l1 = sL[r1];
        OT* d1 = out + r1 * row_stride + c1;
        d1[0] = from_f<OT>(l1 == 0.f ? 0.f : o1.x / l1);
        d1[1] = from_f<OT>(l1 == 0.f ? 0.f : o1.y / l1);
        d1[2] = from_f<OT>(l1 == 0.f ? 0.f : o1.z / l1);
        d1[3] = from_f<OT>(l1 == 0.f ? 0.f : o1.w / l1);
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < nt * ncols; idx += blockDim.x) {
    const int r = idx / ncols, c = idx % ncols;
    const float* a = pa.acc + size_t(r) * cw + c;
    float o = 0.f;
#pragma unroll 4
    for (int s = 0; s < n; ++s) {
      const float f = sF[r * n + s];
      if (f >= 0.f) o = fmaf(f, __ldcg(a + s * ss), o);
    }
    const float l = sL[r];
    out[r * row_stride + c] = from_f<OT>(l == 0.f ? 0.f : o / l);
  }
}

// -- the split-keys route (CUDA cores) ---------------------------------------------

// The staging geometry of one head_dim and tile height.  A compiled head_dim
// (64, 128) copies rows 16 bytes at a time, 32 keys a warp.  Any other
// head_dim takes the head_dim-generic instantiation: q and the keys' rows
// are staged in pieces of `piece` columns (the whole row up to PIECE), V
// only in the block's `vcols` columns (at most COLS), every staged row
// rounded up to a whole 4-byte word of the cache's storage (zero pad),
// copied `vb` = 4 bytes at a time with cp.async where the cache row's own
// length is a multiple of 4 and in 2- or 1-byte pieces by plain loads
// otherwise; a warp takes the most keys of 32, 16, 8, ... whose chunk fits.
template <typename S, int TQ>
struct Geo {
  int dh, piece, n_pieces, vcols, kw, vb, k_stride, v_stride, stages;
  size_t q_bytes, k_chunk, v_chunk, smem;
  __host__ __device__ static constexpr Geo make(int dh, bool many_chunks) {
    Geo g{};
    g.dh = dh;
    const int dh_pad = (dh + S::N4 - 1) / S::N4 * S::N4;
    g.piece = dh_pad < PIECE ? dh_pad : PIECE;
    g.n_pieces = (dh_pad + PIECE - 1) / PIECE;
    const int cw = dh < COLS ? dh : COLS;
    g.vcols = (cw + S::N4 - 1) / S::N4 * S::N4;
    const int rb = S::row_bytes(dh);
    g.vb = rb % 4 == 0 ? 4 : (rb % 2 == 0 ? 2 : 1);
    // +16 B: conflict-free 16-byte reads of a compiled head_dim's rows
    g.k_stride = S::row_bytes(g.piece) + 16;
    g.v_stride = S::row_bytes(g.vcols) + 16;
    g.q_bytes = size_t(TQ) * g.piece * sizeof(float);
    g.kw = KW;
    while (g.kw > 1 && g.q_bytes + size_t(WARPS) * g.kw * (g.k_stride + g.v_stride) >
                           SMEM_LIMIT)
      g.kw /= 2;
    g.k_chunk = size_t(WARPS) * g.kw * g.k_stride;
    g.v_chunk = size_t(WARPS) * g.kw * g.v_stride;
    // double-buffer a split of several chunks where that leaves room for
    // two blocks on an SM
    g.stages = many_chunks && g.n_pieces == 1 &&
                       g.q_bytes + 2 * (g.k_chunk + g.v_chunk) <= 100 * 1024
                   ? 2 : 1;
    // the end-of-kernel merge of the warps' partial results reuses the
    // staging buffers: per warp and row, the block's columns plus (m, l)
    // (and, in the last block of a group, the split merge's factors)
    const size_t stage = size_t(g.stages) * (g.k_chunk + g.v_chunk);
    size_t merge = size_t(WARPS) * TQ * (cw + 2) * sizeof(float);
    if (merge < MERGE_BYTES) merge = MERGE_BYTES;
    g.smem = g.q_bytes + (stage > merge ? stage : merge);
    return g;
  }
};

struct QStrides {
  long long b, t, h;  // element strides of q's first three dims (Dh is 1)
};

struct Split {
  float* part;    // fp32 scratch of the partials (null when n == 1)
  int* tickets;   // one per group, zero between launches
  int n, keys;    // splits of the table width and keys a split
};

// DH > 0: that head_dim, compiled; DH = 0: the head_dim `dh` of `G`, this
// block taking output columns [COLS z, COLS z + COLS) of it (z = blockIdx.z)
template <typename S, typename QT, int DH, int TQ>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const QT* __restrict__ q, QStrides qs,
                       const unsigned char* __restrict__ ck,
                       const unsigned char* __restrict__ cv,
                       const __half* __restrict__ ks,
                       const __half* __restrict__ vs,
                       const int64_t* __restrict__ rows,
                       const int64_t* __restrict__ q_pos,
                       typename S::Out* __restrict__ out, Split sp, int T_len,
                       int H, int L, int num_rows, float scale, Geo<S, TQ> G) {
  using OT = typename S::Out;
  constexpr bool FIXED = DH > 0;
  constexpr int EPL = FIXED ? DH / 32 : COLS / 32;  // output columns per lane (bound)
  constexpr int VB = FIXED ? 16 : 4;           // bytes per staged copy
  const int dh = FIXED ? DH : G.dh, kw = FIXED ? KW : G.kw;
  const int rb = S::row_bytes(dh);             // a cache row's bytes
  // this block's output columns [c0, c0 + ncols), epl of them a lane
  const int c0 = FIXED ? 0 : blockIdx.z * COLS;
  const int ncols = FIXED ? DH : min(COLS, dh - c0);
  const int epl = FIXED ? EPL : (ncols + 31) / 32;
  const int cw = FIXED ? DH : min(dh, COLS);   // a partial's columns
  const int piece = FIXED ? DH : G.piece, n_pieces = FIXED ? 1 : G.n_pieces;
  const int kc = WARPS * kw;                   // keys per staged chunk
  const int k_stride = G.k_stride, v_stride = G.v_stride;
  const size_t stage_bytes = G.k_chunk + G.v_chunk;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_qpos[TQ];
  // per stage: byte offset of each key's row (-1 past live) and, for a
  // quantized cache, its K and V scales
  __shared__ long long s_off[2][KC];
  __shared__ float s_scale[2][2][S::QUANT ? KC : 1];
  __shared__ int s_last;
  float* sQ = reinterpret_cast<float*>(smem);  // [TQ][piece]
  unsigned char* sKV = smem + G.q_bytes;       // [stage][K chunk | V chunk]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x % sp.n, bh = blockIdx.x / sp.n;
  const int b = bh / H, h = bh % H;
  const int t0 = blockIdx.y * TQ;
  const int nt = min(TQ, T_len - t0);
  const int grp = (bh * gridDim.y + blockIdx.y) * gridDim.z + blockIdx.z;
  const int64_t* slot_rows = rows + size_t(b) * L;

  // this block's keys: its split of the table, up to the live length
  const int k_beg = split * sp.keys;
  // the first chunk's row indices, loaded beside q_pos so that the two
  // round trips to memory overlap
  const int64_t first_row = tid < kc && k_beg + tid < L ? slot_rows[k_beg + tid] : 0;
  if (tid < TQ) {
    // a position past the last key sees every key, one below 0 sees none:
    // clamping into [-1, L] keeps the mask exact and the value an int
    const int64_t p = tid < nt ? q_pos[size_t(b) * T_len + t0 + tid] : -1;
    s_qpos[tid] = int(p < -1 ? -1 : (p > L ? L : p));
  }
  __syncthreads();
  int max_qp = -1;
  for (int r = 0; r < nt; ++r) max_qp = max(max_qp, s_qpos[r]);
  const int live = min(L, max_qp + 1);          // keys any row of the tile sees
  const int k_end = min(live, k_beg + sp.keys);
  const int n_chunks = k_end > k_beg ? (k_end - k_beg + kc - 1) / kc : 0;
  OT* dst0 = out + ((size_t(b) * T_len + t0) * H + h) * dh + c0;
  const int groups = int(gridDim.x) / sp.n * gridDim.y * gridDim.z;
  const Parts pa = sp.n > 1 ? group_parts(sp.part, grp, groups, sp.n, TQ, cw)
                            : Parts{nullptr, nullptr};
  float* sMerge = reinterpret_cast<float*>(smem + G.q_bytes);

  if (n_chunks == 0 && sp.n > 1) {
    // an empty partial: no key of this split is live
    if (tid < nt) {
      float* p = pa.ml + (size_t(split) * TQ + tid) * 2;
      p[0] = NEG_INF;
      p[1] = 0.f;
    }
    if (last_of_group(sp.tickets, grp, sp.n, &s_last))
      merge_splits(pa, sp.n, TQ, nt, ncols, cw, dst0, (long long)H * dh, sMerge);
    return;
  }

  // columns [p piece, p piece + piece) of the tile's q rows, fp32, zero
  // past dh and past the tile's rows
  auto load_q = [&](int p) {
    const int d0 = p * piece;
    for (int i = tid; i < TQ * piece; i += THREADS) {
      const int r = i / piece, d = d0 + i % piece;
      sQ[i] = r < nt && d < dh
                  ? to_f(q[b * qs.b + (t0 + r) * qs.t + h * qs.h + d]) : 0.f;
    }
  };

  // bytes [b0, b0 + nb) of each staged key's row of `src` -> dst rows
  // (stride `stride`), zero past the cache row and for keys past live
  auto copy_rows = [&](unsigned char* dst, const unsigned char* src, int s,
                       int b0, int nb, int stride) {
    if constexpr (FIXED) {
      const int vecs = nb / VB;
      for (int i = tid; i < kc * vecs; i += THREADS) {
        const int row = i / vecs, at = (i % vecs) * VB;
        const long long base = s_off[s][row];
        cp_async16(dst + row * stride + at, base >= 0 ? src + base + b0 + at : src,
                   base >= 0 ? VB : 0);
      }
    } else if (G.vb == 4) {
      const int words = nb / 4;
      for (int i = tid; i < kc * words; i += THREADS) {
        const int row = i / words, at = (i % words) * 4;
        const long long base = s_off[s][row];
        const bool in = base >= 0 && b0 + at < rb;
        cp_async4(dst + row * stride + at, in ? src + base + b0 + at : src,
                  in ? 4 : 0);
      }
    } else {
      // a row whose byte length is not a multiple of 4 (an odd Dh at bf16
      // or int8): plain 2- or 1-byte loads, the padding to a whole word
      // and the rows past live written as zeros
      const int vb = G.vb, n = nb / vb;
      for (int i = tid; i < kc * n; i += THREADS) {
        const int row = i / n, at = (i % n) * vb;
        const long long base = s_off[s][row];
        const bool in = base >= 0 && b0 + at < rb;
        unsigned char* d = dst + row * stride + at;
        if (vb == 2)
          *reinterpret_cast<uint16_t*>(d) =
              in ? *reinterpret_cast<const uint16_t*>(src + base + b0 + at) : uint16_t(0);
        else
          *d = in ? src[base + b0 + at] : (unsigned char)0;
      }
    }
  };

  // chunk c of this block's keys into buffer s: at the first piece the
  // keys' row offsets (and scales), then the keys' piece p of K and, at the
  // last piece, the block's columns of V
  auto stage = [&](int c, int s, int p) {
    unsigned char* dk = sKV + size_t(s) * stage_bytes;
    if (p == 0) {
      for (int i = tid; i < kc; i += THREADS) {
        const int key = k_beg + c * kc + i;
        long long off = -1;
        if (key < k_end) {
          int64_t cache_row = c == 0 ? first_row : slot_rows[key];
          cache_row = cache_row < 0 ? 0 : (cache_row >= num_rows ? num_rows - 1 : cache_row);
          const long long rh = cache_row * H + h;
          off = rh * rb;
          if constexpr (S::QUANT) {
            s_scale[s][0][i] = __half2float(ks[rh]);
            s_scale[s][1][i] = __half2float(vs[rh]);
          }
        } else if constexpr (S::QUANT) {
          s_scale[s][0][i] = s_scale[s][1][i] = 0.f;
        }
        s_off[s][i] = off;
      }
      __syncthreads();
    }
    copy_rows(dk, ck, s, S::row_bytes(p * piece), S::row_bytes(piece), k_stride);
    if (p == n_pieces - 1)
      copy_rows(dk + G.k_chunk, cv, s, S::row_bytes(c0),
                S::row_bytes(FIXED ? DH : G.vcols), v_stride);
  };

  // this warp's partial online softmax over its kw keys of every chunk,
  // for every row of the tile
  float m[TQ], l[TQ], acc[TQ][EPL];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[i][e] = 0.f;
  }
  // lanes past kw (keys a warp, when 16) score no key; they read row 0
  const int klane = lane < kw ? lane : 0;

  // dot[i] += q row i . this lane's key, over the staged piece
  auto score = [&](float* dot, int c, int s) {
    const int first = k_beg + c * kc + warp * kw;  // this warp's first key
    const unsigned char* krow =
        sKV + size_t(s) * stage_bytes + size_t(warp * kw + klane) * k_stride;
    const float kscale = S::QUANT ? s_scale[s][0][warp * kw + klane] : 1.f;
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      // warp-uniform: a row whose position is before this warp's keys
      // sees none of them (p = 0 for all of them) — skip the work
      if (i < nt && s_qpos[i] >= first) {
        const float* qr = sQ + i * piece;
        float d = 0.f;
        if constexpr (FIXED) {
          const uint4* kv4 = reinterpret_cast<const uint4*>(krow);
#pragma unroll
          for (int v = 0; v < S::row_bytes(DH) / 16; ++v) {
            float kf[S::N];
            S::unpack(kv4[v], kf, kscale);
#pragma unroll
            for (int e = 0; e < S::N; ++e) d = fmaf(qr[v * S::N + e], kf[e], d);
          }
        } else {
          const uint32_t* kv1 = reinterpret_cast<const uint32_t*>(krow);
          const int words = S::row_bytes(piece) / 4;
          for (int v = 0; v < words; ++v) {
            float kf[S::N4];
            S::unpack4(kv1[v], kf, kscale);
#pragma unroll
            for (int e = 0; e < S::N4; ++e) d = fmaf(qr[v * S::N4 + e], kf[e], d);
          }
        }
        dot[i] += d;
      }
    }
  };

  // the online-softmax update of chunk c with the finished scores
  auto update = [&](const float* dot, int c, int s) {
    const int first = k_beg + c * kc + warp * kw;
    const unsigned char* V = sKV + size_t(s) * stage_bytes + G.k_chunk +
                             size_t(warp) * kw * v_stride;
    const int kidx = first + lane;
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      if (i < nt && s_qpos[i] >= first) {
        const bool valid = (FIXED || lane < kw) && kidx < L && s_qpos[i] >= kidx;
        const float sc = valid ? dot[i] * scale : NEG_INF;
        const float m_new = fmaxf(m[i], warp_max(sc));
        float p = expf(sc - m_new);
        if (sc <= NEG_INF * 0.5f) p = 0.f;
        const float alpha = expf(m[i] - m_new);
        l[i] = alpha * l[i] + warp_sum(p);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[i][e] *= alpha;
#pragma unroll 8
        for (int j = 0; j < kw; ++j) {
          const float pj = __shfl_sync(FULL, p, j);
          const unsigned char* vr = V + j * v_stride;
          const float vscale = S::QUANT ? s_scale[s][1][warp * kw + j] : 1.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            const int col = lane * epl + e;
            if (FIXED || (e < epl && col < ncols))
              acc[i][e] = fmaf(pj, S::get(vr, col, vscale), acc[i][e]);
          }
        }
        m[i] = m_new;
      }
    }
  };

  if (n_pieces == 1) {
    load_q(0);
    const bool two = G.stages == 2;
    if (two && n_chunks > 0) {
      stage(0, 0, 0);
      cp_async_commit();
    }
    for (int c = 0; c < n_chunks; ++c) {
      const int s = two ? (c & 1) : 0;
      if (!two) {
        stage(c, 0, 0);
        cp_async_commit();
        cp_async_wait<0>();
      } else if (c + 1 < n_chunks) {
        stage(c + 1, s ^ 1, 0);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      float dot[TQ];
#pragma unroll
      for (int i = 0; i < TQ; ++i) dot[i] = 0.f;
      score(dot, c, s);
      update(dot, c, s);
      __syncthreads();  // the next stage() overwrites this buffer
    }
  } else {
    // q.k streamed over pieces of the row: q's and the keys' piece p staged,
    // the partial dot products added in registers
    for (int c = 0; c < n_chunks; ++c) {
      float dot[TQ];
#pragma unroll
      for (int i = 0; i < TQ; ++i) dot[i] = 0.f;
      for (int p = 0; p < n_pieces; ++p) {
        load_q(p);
        stage(c, 0, p);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        score(dot, c, 0);
        if (p == n_pieces - 1) update(dot, c, 0);
        __syncthreads();  // the next piece overwrites q's and the keys' rows
      }
    }
  }

  // merge the warps' partial (m, l, acc) per row; the staging buffers are
  // free after the loop's last barrier (or were never used)
  float* sM = reinterpret_cast<float*>(smem + G.q_bytes);  // [WARPS][TQ][cw+2]
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    if (i < nt) {
      float* d = sM + (size_t(warp) * TQ + i) * (cw + 2);
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int col = lane * epl + e;
        if (FIXED || (e < epl && col < ncols)) d[col] = acc[i][e];
      }
      if (lane == 0) {
        d[cw] = m[i];
        d[cw + 1] = l[i];
      }
    }
  }
  __syncthreads();
  for (int i = warp; i < nt; i += WARPS) {
    float mw[WARPS], m_all = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      mw[w] = sM[(size_t(w) * TQ + i) * (cw + 2) + cw];
      m_all = fmaxf(m_all, mw[w]);
    }
    float l_all = 0.f, o[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* d = sM + (size_t(w) * TQ + i) * (cw + 2);
      const float f = expf(mw[w] - m_all);  // 0 for a warp that saw no key
      l_all = fmaf(d[cw + 1], f, l_all);
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int col = lane * epl + e;
        if (FIXED || (e < epl && col < ncols)) o[e] = fmaf(d[col], f, o[e]);
      }
    }
    if (sp.n == 1) {
      const float denom = l_all > 0.f ? l_all : 1.f;
      OT* dst = dst0 + size_t(i) * H * dh;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int col = lane * epl + e;
        if (FIXED || (e < epl && col < ncols)) dst[col] = from_f<OT>(o[e] / denom);
      }
    } else {
      float* p = pa.acc + (size_t(split) * TQ + i) * cw;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int col = lane * epl + e;
        if (FIXED || (e < epl && col < ncols)) p[col] = o[e];
      }
      if (lane == 0) {
        float* q2 = pa.ml + (size_t(split) * TQ + i) * 2;
        q2[0] = m_all;
        q2[1] = l_all;
      }
    }
  }
  if (sp.n > 1 && last_of_group(sp.tickets, grp, sp.n, &s_last))
    merge_splits(pa, sp.n, TQ, nt, ncols, cw, dst0, (long long)H * dh, sMerge);
}

// -- the tensor-core route (prefill, dense bf16 / fp16, Dh 64 and 128) -----------

constexpr int TC_ROWS = 64;   // query rows a block: 16 a warp
constexpr int TC_KEYS = 64;   // keys a staged chunk

// p in (0, 1] is carried into P.V as hi = T(p * P_SCALE) and lo =
// T(p * P_SCALE - hi): |hi + lo - p * P_SCALE| <= u^2 p * P_SCALE, with u the
// unit roundoff of T.  The scale 2^15 keeps lo in fp16's normal range for
// p >= 2^-18 (below it fp16's subnormal spacing leaves at most 2^-40 of p
// a key) and hi below fp16's largest value.
constexpr float P_SCALE = 32768.f;

template <typename T>
__device__ __forceinline__ void split_p(float a, float b, uint32_t& hi,
                                        uint32_t& lo) {
  a *= P_SCALE;
  b *= P_SCALE;
  hi = Mma<T>::pack(a, b);
  using T2 = typename std::conditional<std::is_same<T, __half>::value, __half2,
                                       __nv_bfloat162>::type;
  const T2 h = *reinterpret_cast<const T2*>(&hi);
  lo = Mma<T>::pack(a - __low2float(h), b - __high2float(h));
}

template <int DH> constexpr size_t tc_smem(int elem) {
  return size_t(4) * TC_KEYS * (DH + 8) * elem;  // K and V, two buffers each
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
paged_prefill_mma_kernel(const T* __restrict__ q, QStrides qs,
                         const T* __restrict__ ck, const T* __restrict__ cv,
                         const int64_t* __restrict__ rows,
                         const int64_t* __restrict__ q_pos, T* __restrict__ out,
                         Split sp, int T_len, int H, int L, int num_rows,
                         float scale) {
  constexpr int LD = DH + 8;        // padded row: conflict-free fragment reads
  constexpr int KT = DH / 16, NT = DH / 8, VPR = DH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);        // [2][TC_KEYS][LD]
  T* sV = sK + 2 * TC_KEYS * LD;             // [2][TC_KEYS][LD]
  __shared__ long long s_off[2][TC_KEYS];
  __shared__ int s_qpos[TC_ROWS];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x % sp.n, bh = blockIdx.x / sp.n;
  const int b = bh / H, h = bh % H;
  const int t0 = blockIdx.y * TC_ROWS;
  const int nt = min(TC_ROWS, T_len - t0);
  const int grp = bh * gridDim.y + blockIdx.y;
  const int groups = int(gridDim.x) / sp.n * gridDim.y;
  const int64_t* slot_rows = rows + size_t(b) * L;
  const int k_beg = split * sp.keys;
  // the first chunk's row indices, loaded beside q_pos
  const int64_t first_row = tid < TC_KEYS && k_beg + tid < L ? slot_rows[k_beg + tid] : 0;

  if (tid < TC_ROWS) {
    const int64_t p = tid < nt ? q_pos[size_t(b) * T_len + t0 + tid] : -1;
    s_qpos[tid] = int(p < -1 ? -1 : (p > L ? L : p));
  }
  __syncthreads();
  const int max_qp = warp_max_i(max(s_qpos[lane], s_qpos[lane + 32]));
  const int live = min(L, max_qp + 1);
  const int k_end = min(live, k_beg + sp.keys);
  const int n_chunks = k_end > k_beg ? (k_end - k_beg + TC_KEYS - 1) / TC_KEYS : 0;
  T* dst0 = out + ((size_t(b) * T_len + t0) * H + h) * DH;
  const Parts pa = sp.n > 1 ? group_parts(sp.part, grp, groups, sp.n, TC_ROWS, DH)
                            : Parts{nullptr, nullptr};
  float* sMerge = reinterpret_cast<float*>(smem);   // the staging buffers, once free

  if (n_chunks == 0 && sp.n > 1) {
    if (tid < nt) {
      float* p = pa.ml + (size_t(split) * TC_ROWS + tid) * 2;
      p[0] = NEG_INF;
      p[1] = 0.f;
    }
    if (last_of_group(sp.tickets, grp, sp.n, &s_last))
      merge_splits(pa, sp.n, TC_ROWS, nt, DH, DH, dst0, (long long)H * DH, sMerge);
    return;
  }

  // this thread's rows of the warp's 16 and their positions
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int qp0 = s_qpos[r0], qp1 = s_qpos[r1];
  // q's A fragments, read where q lies (rows past T are zero)
  uint32_t qa[KT][4];
  {
    const T* q0 = q + b * qs.b + (t0 + r0) * qs.t + h * qs.h + 2 * t;
    const T* q1 = q + b * qs.b + (t0 + r1) * qs.t + h * qs.h + 2 * t;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      qa[kk][0] = r0 < nt ? ld32(q0 + 16 * kk) : 0u;
      qa[kk][1] = r1 < nt ? ld32(q1 + 16 * kk) : 0u;
      qa[kk][2] = r0 < nt ? ld32(q0 + 16 * kk + 8) : 0u;
      qa[kk][3] = r1 < nt ? ld32(q1 + 16 * kk + 8) : 0u;
    }
  }

  // chunk c's row offsets (element offsets, -1 past live), then its K and V
  // rows by 16-byte cp.async into buffer s
  auto stage = [&](int c, int s) {
    if (tid < TC_KEYS) {
      const int key = k_beg + c * TC_KEYS + tid;
      long long off = -1;
      if (key < k_end) {
        int64_t cache_row = c == 0 ? first_row : slot_rows[key];
        cache_row = cache_row < 0 ? 0 : (cache_row >= num_rows ? num_rows - 1 : cache_row);
        off = (cache_row * H + h) * DH;
      }
      s_off[s][tid] = off;
    }
    __syncthreads();
    for (int i = tid; i < TC_KEYS * VPR; i += THREADS) {
      const int row = i / VPR, vec = (i % VPR) * 8;
      const long long off = s_off[s][row];
      const size_t d = (size_t(s) * TC_KEYS + row) * LD + vec;
      cp_async16(sK + d, off >= 0 ? ck + off + vec : ck, off >= 0 ? 16 : 0);
      cp_async16(sV + d, off >= 0 ? cv + off + vec : cv, off >= 0 ? 16 : 0);
    }
  };

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  if (n_chunks > 0) {
    stage(0, 0);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c & 1;
    if (c + 1 < n_chunks) {
      stage(c + 1, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* K = sK + size_t(s) * TC_KEYS * LD;
    const T* V = sV + size_t(s) * TC_KEYS * LD;
    const int key0 = k_beg + c * TC_KEYS;
    // S = Q.K^T over this chunk's 64 keys, 8 keys an n-tile
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const T* kr = K + (8 * j + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        Mma<T>::run(sc[j], qa[kk], ld32(kr + 16 * kk), ld32(kr + 16 * kk + 8));
    }
    // causal select on absolute positions, then the online softmax
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kidx = key0 + 8 * j + 2 * t + (r & 1);
        const int qp = r < 2 ? qp0 : qp1;
        sc[j][r] = kidx < k_end && qp >= kidx ? sc[j][r] * scale : NEG_INF;
        if (r < 2) mx0 = fmaxf(mx0, sc[j][r]);
        else mx1 = fmaxf(mx1, sc[j][r]);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float mn = r < 2 ? mn0 : mn1;
        const float p = sc[j][r] <= NEG_INF * 0.5f ? 0.f : expf(sc[j][r] - mn);
        sc[j][r] = p;
        if (r < 2) ps0 += p;
        else ps1 += p;
      }
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    l0 = a0 * l0 + quad_sum(ps0);
    l1 = a1 * l1 + quad_sum(ps1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
    // O += P.V with p as two terms of T (hi + lo, scaled by P_SCALE): the
    // products see p to u^2, as the split-keys route's fp32 p
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split_p<T>(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
      split_p<T>(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
      split_p<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
      split_p<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
      const T* vr = V + (16 * kk + (lane & 15)) * LD;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, vr + 8 * n);
        Mma<T>::run(o[n], ph, b0, b1);
        Mma<T>::run(o[n], pl, b0, b1);
      }
    }
    __syncthreads();  // the next stage() overwrites this buffer
  }
  // P_SCALE out again: a power of two, exact
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[n][r] *= 1.f / P_SCALE;

  if (sp.n == 1) {
    const float d0 = l0 > 0.f ? l0 : 1.f, d1 = l1 > 0.f ? l1 : 1.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * n + 2 * t;
      if (r0 < nt)
        *reinterpret_cast<uint32_t*>(dst0 + size_t(r0) * H * DH + col) =
            Mma<T>::pack(o[n][0] / d0, o[n][1] / d0);
      if (r1 < nt)
        *reinterpret_cast<uint32_t*>(dst0 + size_t(r1) * H * DH + col) =
            Mma<T>::pack(o[n][2] / d1, o[n][3] / d1);
    }
    return;
  }
  float* p0 = pa.acc + (size_t(split) * TC_ROWS + r0) * DH;
  float* p1 = pa.acc + (size_t(split) * TC_ROWS + r1) * DH;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = 8 * n + 2 * t;
    if (r0 < nt) *reinterpret_cast<float2*>(p0 + col) = make_float2(o[n][0], o[n][1]);
    if (r1 < nt) *reinterpret_cast<float2*>(p1 + col) = make_float2(o[n][2], o[n][3]);
  }
  if (t == 0) {
    if (r0 < nt)
      *reinterpret_cast<float2*>(pa.ml + (size_t(split) * TC_ROWS + r0) * 2) =
          make_float2(m0, l0);
    if (r1 < nt)
      *reinterpret_cast<float2*>(pa.ml + (size_t(split) * TC_ROWS + r1) * 2) =
          make_float2(m1, l1);
  }
  if (last_of_group(sp.tickets, grp, sp.n, &s_last))
    merge_splits(pa, sp.n, TC_ROWS, nt, DH, DH, dst0, (long long)H * DH, sMerge);
}

// -- launchers ---------------------------------------------------------------------

struct Args {
  const void *q, *ck, *cv, *ks, *vs, *rows, *q_pos;
  void* out;
  QStrides qs;
  Split sp;
  int B, T_len, H, L, num_rows;
  float scale;
  cudaStream_t stream;
};

template <typename S, typename QT, int DH, int TQ>
cudaError_t launch(const Args& a, int dh) {
  const Geo<S, TQ> geo = Geo<S, TQ>::make(DH > 0 ? DH : dh, a.sp.keys > WARPS * KW);
  if (geo.smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  auto kern = paged_attention_kernel<S, QT, DH, TQ>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(geo.smem));
  if (e != cudaSuccess) return e;
  const long long z = DH > 0 ? 1 : (dh + COLS - 1) / COLS;
  const long long tiles = (a.T_len + TQ - 1) / TQ;
  if (z > 65535 || tiles > 65535) return cudaErrorInvalidValue;
  dim3 grid(a.B * a.H * a.sp.n, unsigned(tiles), unsigned(z));
  kern<<<grid, THREADS, geo.smem, a.stream>>>(
      static_cast<const QT*>(a.q), a.qs, static_cast<const unsigned char*>(a.ck),
      static_cast<const unsigned char*>(a.cv), static_cast<const __half*>(a.ks),
      static_cast<const __half*>(a.vs), static_cast<const int64_t*>(a.rows),
      static_cast<const int64_t*>(a.q_pos),
      static_cast<typename S::Out*>(a.out), a.sp, a.T_len, a.H, a.L,
      a.num_rows, a.scale, geo);
  return cudaGetLastError();
}

template <typename S, typename QT, int DH>
cudaError_t launch_tq(const Args& a, int dh) {
  // decode (T = 1) takes a one-row tile
  return a.T_len == 1 ? launch<S, QT, DH, 1>(a, dh) : launch<S, QT, DH, 8>(a, dh);
}

template <typename S, typename QT>
cudaError_t launch_dh(int Dh, const Args& a) {
  if (Dh == 64) return launch_tq<S, QT, 64>(a, Dh);
  if (Dh == 128) return launch_tq<S, QT, 128>(a, Dh);
  // int4 packs two codes a byte: its rows need an even head_dim
  if (Dh < 1 || (S::N4 == 8 && Dh % 2)) return cudaErrorInvalidValue;
  return launch_tq<S, QT, 0>(a, Dh);
}

template <typename T, int DH>
cudaError_t launch_mma(const Args& a) {
  constexpr size_t smem = tc_smem<DH>(sizeof(T));
  auto kern = paged_prefill_mma_kernel<T, DH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const long long tiles = (a.T_len + TC_ROWS - 1) / TC_ROWS;
  if (tiles > 65535) return cudaErrorInvalidValue;
  dim3 grid(a.B * a.H * a.sp.n, unsigned(tiles));
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), a.qs, static_cast<const T*>(a.ck),
      static_cast<const T*>(a.cv), static_cast<const int64_t*>(a.rows),
      static_cast<const int64_t*>(a.q_pos), static_cast<T*>(a.out), a.sp,
      a.T_len, a.H, a.L, a.num_rows, a.scale);
  return cudaGetLastError();
}

// a dense cache takes q in fp32 or in the cache dtype T; the tensor-core
// route q in T at Dh 64 or 128
template <typename T>
cudaError_t launch_dense(int q_dtype, int Dh, int route, const Args& a) {
  if (route == 1) {
    if constexpr (std::is_same<T, float>::value) {
      return cudaErrorInvalidValue;
    } else {
      if (q_dtype == 0 || a.T_len < 16) return cudaErrorInvalidValue;
      if (Dh == 64) return launch_mma<T, 64>(a);
      if (Dh == 128) return launch_mma<T, 128>(a);
      return cudaErrorInvalidValue;
    }
  }
  if (q_dtype == 0) return launch_dh<Dense<T>, float>(Dh, a);
  return launch_dh<Dense<T>, T>(Dh, a);
}

// a quantized cache takes q in fp32, bf16 or fp16
template <typename S>
cudaError_t launch_quant(int q_dtype, int Dh, const Args& a) {
  switch (q_dtype) {
    case 0: return launch_dh<S, float>(Dh, a);
    case 1: return launch_dh<S, __nv_bfloat16>(Dh, a);
    case 2: return launch_dh<S, __half>(Dh, a);
    default: return cudaErrorInvalidValue;
  }
}

using Dispatch = cudaError_t (*)(int cache, int q_dtype, int Dh, int route,
                                 const Args& a);

// The C entry, each library's `paged_attention_fwd`, for its cache kinds.
// cache: 0 = float32, 1 = bfloat16, 2 = float16 dense caches (ck/cv
// [num_rows, H, Dh], the output dtype too); 3 = int8 (ck/cv int8
// [num_rows, H, Dh]), 4 = int4 (ck/cv uint8 [num_rows, H, Dh / 2]), each
// with ks/vs fp16 [num_rows, H] scales and an fp32 output.  q [B, T, H, Dh]
// with element strides (q_sb, q_st, q_sh) and unit stride over Dh, in
// q_dtype (0 = fp32, 1 = bf16, 2 = fp16; a dense cache takes fp32 or its
// own dtype).  Caches contiguous and 16-byte aligned; rows int64 [B, L] and
// q_pos int64 [B, T] contiguous; out [B, T, H, Dh] contiguous; scale =
// Dh**-0.5 as the caller rounds it to fp32.  route: 0 = split keys on the
// CUDA cores, 1 = tensor cores (a dense bf16/fp16 cache, q in its dtype,
// T >= 16, Dh 64 or 128; q's strides even and its storage 4-byte aligned).
// The table width is split into n_splits ranges of split_keys keys (a
// multiple of 128); with n_splits > 1, part is fp32 scratch of
// groups x n_splits x rows x (min(Dh, 256) + 2) floats (groups = B H x q
// tiles x column blocks; rows = 1 at T = 1 and 8 otherwise, 64 on the
// tensor-core route) and tickets int32 [groups], zero before the launch and
// left zero after it.  Returns the cudaError_t of the launch (0 on
// success); the caller raises on anything else.
// Returns cudaErrorInvalidValue for a cache kind another library serves.
inline int paged_entry(const void* q, long long q_sb, long long q_st,
                       long long q_sh, int q_dtype, const void* ck,
                       const void* cv, const void* ks, const void* vs,
                       const void* rows, const void* q_pos, void* out, int B,
                       int T_len, int H, int Dh, int L, int num_rows,
                       float scale, int cache, void* part, void* tickets,
                       int n_splits, int split_keys, int route, void* stream,
                       Dispatch dispatch) {
  (void)cudaGetLastError();  // report this launch's error, not an older one
  if (B <= 0 || T_len <= 0 || H <= 0 || L <= 0 || num_rows <= 0 || Dh <= 0)
    return cudaErrorInvalidValue;
  if (n_splits < 1 || split_keys < SPLIT_UNIT || split_keys % SPLIT_UNIT ||
      (long long)(n_splits - 1) * split_keys >= L ||
      (n_splits > 1 && (part == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  if ((long long)B * H * n_splits > 0x7fffffffLL) return cudaErrorInvalidValue;
  // the merge keeps a factor per (row, split) in shared memory
  const int rows_a_tile = route == 1 ? TC_ROWS : (T_len == 1 ? 1 : 8);
  if (n_splits > 1 && n_splits * rows_a_tile > MERGE_FACTORS) return cudaErrorInvalidValue;
  if (route == 1 && (cache < 1 || cache > 2 || q_dtype != cache))
    return cudaErrorInvalidValue;
  const Args a{q, ck, cv, ks, vs, rows, q_pos, out, {q_sb, q_st, q_sh},
               {static_cast<float*>(part), static_cast<int*>(tickets), n_splits,
                split_keys},
               B, T_len, H, L, num_rows, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(cache, q_dtype, Dh, route, a);
}

}  // namespace

// one library's C interface: `dispatch` serves its cache kinds
#define PAGED_ATTENTION_ENTRY(dispatch)                                          \
  extern "C" {                                                                  \
  int paged_attention_fwd(const void* q, long long q_sb, long long q_st,        \
                          long long q_sh, int q_dtype, const void* ck,          \
                          const void* cv, const void* ks, const void* vs,       \
                          const void* rows, const void* q_pos, void* out, int B,\
                          int T_len, int H, int Dh, int L, int num_rows,        \
                          float scale, int cache, void* part, void* tickets,    \
                          int n_splits, int split_keys, int route,              \
                          void* stream) {                                       \
    return paged_entry(q, q_sb, q_st, q_sh, q_dtype, ck, cv, ks, vs, rows,      \
                       q_pos, out, B, T_len, H, Dh, L, num_rows, scale, cache,  \
                       part, tickets, n_splits, split_keys, route, stream,      \
                       dispatch);                                               \
  }                                                                             \
  const char* paged_attention_error_string(int err) {                           \
    return cudaGetErrorString(static_cast<cudaError_t>(err));                   \
  }                                                                             \
  }

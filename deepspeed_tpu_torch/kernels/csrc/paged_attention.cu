// Paged attention over a block-table KV cache, written for Hopper (sm_90a).
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
// QKV output) and widened to fp32 as the reference does; rows and q_pos are
// the int64 tensors the serving programs build once per step, so a call
// launches this kernel and nothing else.  The cache is one of:
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
// What bounds it on this card: bytes.  Each live K/V row is read once per
// query tile and does 4*Dh FLOPs per query row, so at decode (T = 1) and at
// verify (T = draft_len + 1) the arithmetic intensity is a few FLOPs per
// byte against the H100's ~295 — far below the ridge.  A quantized cache
// moves fewer bytes for the same keys: per live key and head, K and V take
// 2 (Dh + 2) bytes at int8 and 2 (Dh / 2 + 2) at int4 (codes plus the fp16
// scale), against 4 Dh at bf16 — 0.52x and 0.27x at Dh = 64.  The HBM read
// is the compressed cache, which is the point of the branch.  The design
// therefore only tries to move the bytes it must, and to keep loads in
// flight:
//   * one thread block per (slot*head, tile of up to TQ = 8 query rows); the
//     block walks the slot's rows in a loop, KC = 128 keys per step;
//   * chunks past the causal horizon of the tile (first key > largest q_pos)
//     are never loaded — the loop ends there, so the cost follows the live
//     length, not the table width;
//   * each chunk's KC row indices are read once (one thread per key),
//     clamped, turned into byte offsets and kept in shared memory, with the
//     key's K and V scales when the cache is quantized, so the threads that
//     copy a key's row do not each load its index again (repeated
//     per-thread index loads in front of the copies made the staging loop
//     the slowest part at decode);
//   * each KC-row K and V chunk of the block's head is staged into shared
//     memory with 16-byte cp.async copies, compressed (double-buffered where
//     two blocks still fit on an SM, so the next chunk's loads overlap this
//     chunk's math); rows are padded by 16 bytes so the per-lane 16-byte
//     reads of the score loop are bank-conflict free;
//   * each of the 4 warps takes 32 keys of every chunk for every row of the
//     tile (at decode, T = 1, all four warps work, not one), keeping its own
//     fp32 running max, denominator and accumulator in registers (online
//     softmax): lane j scores key j, warp shuffles reduce max and sum, and
//     for P.V each lane owns ceil(Dh/32) consecutive output columns (the
//     last lanes fewer or none when Dh is not a multiple of 32).  A row
//     whose position is before a warp's keys skips them (p would be 0 for
//     all).  The four partial results of a row are merged through shared
//     memory at the end.
//   * head_dim: 64 and 128 are compiled as such (16-byte staging, the
//     loops unrolled); every other head_dim from 1 to 1024 runs the
//     head_dim-generic instantiation.  It stages a row 4 bytes at a time
//     with cp.async where its byte length is a multiple of 4, and otherwise
//     in 2- or 1-byte pieces by plain loads (an odd Dh at bf16 or int8),
//     into a shared-memory row padded with zeros to a whole 4-byte word:
//     q's staged row is padded the same way, so the padding adds exactly 0
//     to every score and the cache itself is never padded.  Where 32 keys a
//     warp would not fit in shared memory, a warp takes 16, 8, ... (fp32
//     rows above Dh 192 take 16).  A block accumulates at most COLS = 256
//     output columns (8 a lane); a larger head_dim splits its columns over
//     blocks on grid.z, each scoring the whole row.  Above Dh 1024 the
//     launch is refused: shared memory (q rows and the merge buffer in
//     fp32) sets that limit.
// Left to later work: wgmma/TMA tiles for long prefill tiles, and split-K
// over long caches so that decode at small batch fills all 132 SMs.
//
// Exactness notes (the guards of the TPU kernel, kept):
//   * the causal mask is a select to NEG_INF, never an additive bias;
//   * p is zeroed where s <= NEG_INF/2: on a chunk with no live key and the
//     running max still at NEG_INF, exp(s - m) would be 1 (paged.py:158-160);
//   * the final division happens only where l > 0 (an empty row stays 0);
//   * keys past the tile's live length are zero-filled in shared memory and
//     masked, and a masked key contributes exactly 0 (decode passes the
//     whole table, trash block 0 included);
//   * row indices are clamped into [0, num_rows), as the TPU kernel's index
//     map clamps its table entries, so a bad entry cannot read out of bounds.
//   * probabilities stay fp32 into the P.V product (the reference rounds them
//     to a dense cache's dtype first), so at bf16 the two differ by about one
//     bf16 rounding of the output; over a quantized cache both stay fp32.

#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TQ = 8;                   // query rows per thread block
constexpr int KW = 32;                  // keys per warp per chunk: one per lane
constexpr int KC = WARPS * KW;          // keys per staged chunk (at most)
// output columns a thread block accumulates (8 a lane): a larger head_dim
// splits its columns over blocks on grid.z
constexpr int COLS = 256;
// the largest head_dim: above it an fp32 tile's staged q rows and the warps'
// end-of-kernel merge buffer leave no room in the SM's shared memory (they
// would fill it at Dh 1406)
constexpr int MAX_HEAD_DIM = 1024;

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

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

// dynamic shared memory a block may take beside the kernel's static arrays
constexpr size_t SMEM_LIMIT = 220 * 1024;

// The staging geometry of one head_dim.  A compiled head_dim (64, 128) has
// it at compile time: rows copied 16 bytes at a time, 32 keys a warp per
// chunk.  Any other head_dim takes a head_dim-generic instantiation, whose
// geometry the host computes: a row is staged as `row_bytes(dh_pad)` bytes
// (dh rounded up to a whole 4-byte word of the cache's storage, the pad
// zero-filled), copied `vb` = 4 bytes at a time with cp.async where the
// cache row's own length is a multiple of 4 and in 2- or 1-byte pieces by
// plain loads otherwise; a warp takes the most keys of 32, 16, 8, ... whose
// chunk fits in shared memory (fp32 rows above Dh 192 take 16).
template <typename S>
struct Geo {
  int dh, dh_pad, kw;       // head_dim, staged columns, keys a warp
  int row_bytes, vb, row_stride, stages;
  size_t q_bytes, chunk_bytes, smem;
  __host__ __device__ static constexpr Geo make(int dh) {
    Geo g{};
    g.dh = dh;
    g.dh_pad = (dh + S::N4 - 1) / S::N4 * S::N4;
    g.row_bytes = S::row_bytes(dh);
    g.vb = g.row_bytes % 4 == 0 ? 4 : (g.row_bytes % 2 == 0 ? 2 : 1);
    // +16 B: conflict-free 16-byte reads of a compiled head_dim's rows
    g.row_stride = S::row_bytes(g.dh_pad) + 16;
    g.q_bytes = size_t(TQ) * g.dh_pad * sizeof(float);
    g.kw = KW;
    while (g.kw > 1 &&
           g.q_bytes + 2 * size_t(WARPS) * g.kw * g.row_stride > SMEM_LIMIT)
      g.kw /= 2;
    g.chunk_bytes = size_t(WARPS) * g.kw * g.row_stride;  // one K or V chunk
    // double-buffer where that leaves room for two blocks on an SM
    g.stages = g.q_bytes + 4 * g.chunk_bytes <= 100 * 1024 ? 2 : 1;
    // the end-of-kernel merge of the warps' partial results reuses the
    // staging buffers: per warp and row, dh accumulators plus (m, l)
    const size_t stage = 2 * size_t(g.stages) * g.chunk_bytes;
    const size_t merge = size_t(WARPS) * TQ * (dh + 2) * sizeof(float);
    g.smem = g.q_bytes + (stage > merge ? stage : merge);
    return g;
  }
};

struct QStrides {
  long long b, t, h;  // element strides of q's first three dims (Dh is 1)
};

// DH > 0: that head_dim, compiled; DH = 0: the head_dim `dh` of `geo`, this
// block taking output columns [COLS z, COLS z + COLS) of it (z = blockIdx.z)
template <typename S, typename QT, int DH>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const QT* __restrict__ q, QStrides qs,
                       const unsigned char* __restrict__ ck,
                       const unsigned char* __restrict__ cv,
                       const __half* __restrict__ ks,
                       const __half* __restrict__ vs,
                       const int64_t* __restrict__ rows,
                       const int64_t* __restrict__ q_pos,
                       typename S::Out* __restrict__ out, int T_len, int H,
                       int L, int num_rows, float scale, Geo<S> geo) {
  using OT = typename S::Out;
  constexpr bool FIXED = DH > 0;
  constexpr Geo<S> FG = Geo<S>::make(FIXED ? DH : 32);
  const Geo<S> G = FIXED ? FG : geo;
  constexpr int EPL = FIXED ? DH / 32 : COLS / 32;  // output columns per lane (bound)
  constexpr int VB = FIXED ? 16 : 4;           // bytes per staged copy
  const int dh = G.dh, kw = FIXED ? KW : G.kw;
  // this block's output columns [c0, c0 + ncols), epl of them a lane
  const int c0 = FIXED ? 0 : blockIdx.z * COLS;
  const int ncols = FIXED ? DH : min(COLS, dh - c0);
  const int epl = FIXED ? EPL : (ncols + 31) / 32;
  const int dh_pad = FIXED ? DH : G.dh_pad;    // staged columns (zero pad)
  const int kc = WARPS * kw;                   // keys per staged chunk
  // staged words a row (VB-byte vectors; 4-byte words when generic)
  const int row_stride = G.row_stride, vecs = S::row_bytes(dh_pad) / VB;
  // copies a row: VB-byte vectors, or the generic tail's vb-byte pieces
  const int vb = FIXED ? VB : G.vb, pieces = S::row_bytes(dh_pad) / vb;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_qpos[TQ];
  // per stage: byte offset of each key's row (-1 past live) and, for a
  // quantized cache, its K and V scales
  __shared__ long long s_off[2][KC];
  __shared__ float s_scale[2][2][S::QUANT ? KC : 1];
  float* sQ = reinterpret_cast<float*>(smem);
  unsigned char* sKV = smem + G.q_bytes;  // [stage][K|V][kc][row_stride]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int t0 = blockIdx.y * TQ;
  const int nt = min(TQ, T_len - t0);
  const int64_t* slot_rows = rows + size_t(b) * L;

  for (int i = tid; i < TQ * dh_pad; i += THREADS) {
    const int r = i / dh_pad, d = i % dh_pad;
    sQ[i] = r < nt && d < dh
                ? to_f(q[b * qs.b + (t0 + r) * qs.t + h * qs.h + d]) : 0.f;
  }
  if (tid < TQ) {
    // a position past the last key sees every key, one below 0 sees none:
    // clamping into [-1, L] keeps the mask exact and the value an int
    const int64_t p = tid < nt ? q_pos[size_t(b) * T_len + t0 + tid] : -1;
    s_qpos[tid] = int(p < -1 ? -1 : (p > L ? L : p));
  }
  __syncthreads();

  int max_qp = -1;
  for (int r = 0; r < nt; ++r) max_qp = max(max_qp, s_qpos[r]);
  const int live = min(L, max_qp + 1);            // keys any row of the tile sees
  const int n_chunks = live > 0 ? (live + kc - 1) / kc : 0;

  auto stage = [&](int c, int s) {
    unsigned char* dk = sKV + size_t(2 * s) * G.chunk_bytes;
    unsigned char* dv = dk + G.chunk_bytes;
    for (int i = tid; i < kc; i += THREADS) {
      const int key = c * kc + i;
      long long off = -1;
      if (key < live) {
        int64_t cache_row = slot_rows[key];
        cache_row = cache_row < 0 ? 0 : (cache_row >= num_rows ? num_rows - 1 : cache_row);
        const long long rh = cache_row * H + h;
        off = rh * G.row_bytes;
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
    if (!FIXED && vb < 4) {
      // a row whose byte length is not a multiple of 4 (an odd Dh at bf16
      // or int8): plain 2- or 1-byte loads, the padding to a whole word
      // and the rows past live written as zeros
      for (int i = tid; i < kc * pieces; i += THREADS) {
        const int row = i / pieces, at = (i % pieces) * vb;
        const long long base = s_off[s][row];
        const bool in = base >= 0 && at < G.row_bytes;
        unsigned char* pk = dk + row * row_stride + at;
        unsigned char* pv = dv + row * row_stride + at;
        if (vb == 2) {
          const uint16_t* gk = reinterpret_cast<const uint16_t*>(ck + (in ? base + at : 0));
          const uint16_t* gv = reinterpret_cast<const uint16_t*>(cv + (in ? base + at : 0));
          *reinterpret_cast<uint16_t*>(pk) = in ? *gk : uint16_t(0);
          *reinterpret_cast<uint16_t*>(pv) = in ? *gv : uint16_t(0);
        } else {
          *pk = in ? ck[base + at] : (unsigned char)0;
          *pv = in ? cv[base + at] : (unsigned char)0;
        }
      }
      return;
    }
    for (int i = tid; i < kc * vecs; i += THREADS) {
      const int row = i / vecs, vec = i % vecs;
      const long long base = s_off[s][row];
      const unsigned char* srck = ck;
      const unsigned char* srcv = cv;
      int bytes = 0;
      if (base >= 0) {
        const size_t off = size_t(base) + size_t(vec) * VB;
        srck = ck + off;
        srcv = cv + off;
        bytes = VB;
      }
      if constexpr (VB == 16) {
        cp_async16(dk + row * row_stride + vec * VB, srck, bytes);
        cp_async16(dv + row * row_stride + vec * VB, srcv, bytes);
      } else {
        cp_async4(dk + row * row_stride + vec * VB, srck, bytes);
        cp_async4(dv + row * row_stride + vec * VB, srcv, bytes);
      }
    }
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

  const bool two = G.stages == 2;
  if (two && n_chunks > 0) {
    stage(0, 0);
    cp_async_commit();
  }
  // lanes past kw (keys a warp, when 16) score no key; they read row 0
  const int klane = lane < kw ? lane : 0;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = two ? (c & 1) : 0;
    if (!two) {
      stage(c, 0);
      cp_async_commit();
      cp_async_wait<0>();
    } else if (c + 1 < n_chunks) {
      stage(c + 1, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int first = c * kc + warp * kw;          // this warp's first key
    const unsigned char* K = sKV + size_t(2 * s) * G.chunk_bytes +
                             size_t(warp) * kw * row_stride;
    const unsigned char* V = K + G.chunk_bytes;
    const int kidx = first + lane;
    const unsigned char* krow = K + klane * row_stride;
    const float kscale = S::QUANT ? s_scale[s][0][warp * kw + klane] : 1.f;
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      // warp-uniform: a row whose position is before this warp's keys
      // sees none of them (p = 0 for all of them), which leaves m, l and
      // acc exactly as they are — skip the work
      if (i < nt && s_qpos[i] >= first) {
        const float* qr = sQ + i * dh_pad;
        float dot = 0.f;
        if constexpr (FIXED) {
          const uint4* kv4 = reinterpret_cast<const uint4*>(krow);
#pragma unroll
          for (int v = 0; v < G.row_bytes / 16; ++v) {
            float kf[S::N];
            S::unpack(kv4[v], kf, kscale);
#pragma unroll
            for (int e = 0; e < S::N; ++e) dot = fmaf(qr[v * S::N + e], kf[e], dot);
          }
        } else {
          const uint32_t* kv1 = reinterpret_cast<const uint32_t*>(krow);
          for (int v = 0; v < vecs; ++v) {
            float kf[S::N4];
            S::unpack4(kv1[v], kf, kscale);
#pragma unroll
            for (int e = 0; e < S::N4; ++e) dot = fmaf(qr[v * S::N4 + e], kf[e], dot);
          }
        }
        const bool valid = (FIXED || lane < kw) && kidx < L && s_qpos[i] >= kidx;
        const float sc = valid ? dot * scale : NEG_INF;
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
          const unsigned char* vr = V + j * row_stride;
          const float vscale = S::QUANT ? s_scale[s][1][warp * kw + j] : 1.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            const int col = lane * epl + e;
            if (FIXED || (e < epl && col < ncols))
              acc[i][e] = fmaf(pj, S::get(vr, c0 + col, vscale), acc[i][e]);
          }
        }
        m[i] = m_new;
      }
    }
    __syncthreads();  // the next stage() overwrites this buffer
  }

  // merge the warps' partial (m, l, acc) per row; the staging buffers are
  // free after the loop's last barrier (or were never used)
  float* sM = reinterpret_cast<float*>(smem + G.q_bytes);  // [WARPS][TQ][dh+2]
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    if (i < nt) {
      float* d = sM + (size_t(warp) * TQ + i) * (dh + 2);
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int col = lane * epl + e;
        if (FIXED || (e < epl && col < ncols)) d[c0 + col] = acc[i][e];
      }
      if (lane == 0) {
        d[dh] = m[i];
        d[dh + 1] = l[i];
      }
    }
  }
  __syncthreads();
  for (int i = warp; i < nt; i += WARPS) {
    float mw[WARPS], m_all = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      mw[w] = sM[(size_t(w) * TQ + i) * (dh + 2) + dh];
      m_all = fmaxf(m_all, mw[w]);
    }
    float l_all = 0.f, o[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* d = sM + (size_t(w) * TQ + i) * (dh + 2);
      const float f = expf(mw[w] - m_all);  // 0 for a warp that saw no key
      l_all = fmaf(d[dh + 1], f, l_all);
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int col = lane * epl + e;
        if (FIXED || (e < epl && col < ncols)) o[e] = fmaf(d[c0 + col], f, o[e]);
      }
    }
    const float denom = l_all > 0.f ? l_all : 1.f;
    OT* dst = out + ((size_t(b) * T_len + t0 + i) * H + h) * dh;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int col = lane * epl + e;
      if (FIXED || (e < epl && col < ncols)) dst[c0 + col] = from_f<OT>(o[e] / denom);
    }
  }
}

struct Args {
  const void *q, *ck, *cv, *ks, *vs, *rows, *q_pos;
  void* out;
  QStrides qs;
  int B, T_len, H, L, num_rows;
  float scale;
  cudaStream_t stream;
};

template <typename S, typename QT, int DH>
cudaError_t launch(const Args& a, int dh) {
  const Geo<S> geo = Geo<S>::make(DH > 0 ? DH : dh);
  if (geo.smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  auto kern = paged_attention_kernel<S, QT, DH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(geo.smem));
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.H, (a.T_len + TQ - 1) / TQ, DH > 0 ? 1 : (dh + COLS - 1) / COLS);
  kern<<<grid, THREADS, geo.smem, a.stream>>>(
      static_cast<const QT*>(a.q), a.qs, static_cast<const unsigned char*>(a.ck),
      static_cast<const unsigned char*>(a.cv), static_cast<const __half*>(a.ks),
      static_cast<const __half*>(a.vs), static_cast<const int64_t*>(a.rows),
      static_cast<const int64_t*>(a.q_pos),
      static_cast<typename S::Out*>(a.out), a.T_len, a.H, a.L, a.num_rows,
      a.scale, geo);
  return cudaGetLastError();
}

template <typename S, typename QT>
cudaError_t launch_dh(int Dh, const Args& a) {
  if (Dh == 64) return launch<S, QT, 64>(a, Dh);
  if (Dh == 128) return launch<S, QT, 128>(a, Dh);
  // int4 packs two codes a byte: its rows need an even head_dim
  if (Dh < 1 || Dh > MAX_HEAD_DIM || (S::N4 == 8 && Dh % 2)) return cudaErrorInvalidValue;
  return launch<S, QT, 0>(a, Dh);
}

// a dense cache takes q in fp32 or in the cache dtype T
template <typename T>
cudaError_t launch_dense(int q_dtype, int Dh, const Args& a) {
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

}  // namespace

extern "C" {

// cache: 0 = float32, 1 = bfloat16, 2 = float16 dense caches (ck/cv
// [num_rows, H, Dh], the output dtype too); 3 = int8 (ck/cv int8
// [num_rows, H, Dh]), 4 = int4 (ck/cv uint8 [num_rows, H, Dh / 2]), each
// with ks/vs fp16 [num_rows, H] scales and an fp32 output.  q [B, T, H, Dh]
// with element strides (q_sb, q_st, q_sh) and unit stride over Dh, in
// q_dtype (0 = fp32, 1 = bf16, 2 = fp16; a dense cache takes fp32 or its
// own dtype).  Caches contiguous and 16-byte aligned; rows int64 [B, L] and
// q_pos int64 [B, T] contiguous; out [B, T, H, Dh] contiguous; scale =
// Dh**-0.5 as the caller rounds it to fp32.  Returns the cudaError_t of the
// launch (0 on success); the caller raises on anything else.
int paged_attention_fwd(const void* q, long long q_sb, long long q_st,
                        long long q_sh, int q_dtype, const void* ck,
                        const void* cv, const void* ks, const void* vs,
                        const void* rows, const void* q_pos, void* out, int B,
                        int T_len, int H, int Dh, int L, int num_rows,
                        float scale, int cache, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not an older one
  if (B <= 0 || T_len <= 0 || H <= 0 || L <= 0 || num_rows <= 0)
    return cudaErrorInvalidValue;
  if ((T_len + TQ - 1) / TQ > 65535) return cudaErrorInvalidValue;
  const Args a{q, ck, cv, ks, vs, rows, q_pos, out, {q_sb, q_st, q_sh}, B,
               T_len, H, L, num_rows, scale, static_cast<cudaStream_t>(stream)};
  switch (cache) {
    case 0: return launch_dense<float>(q_dtype, Dh, a);
    case 1: return launch_dense<__nv_bfloat16>(q_dtype, Dh, a);
    case 2: return launch_dense<__half>(q_dtype, Dh, a);
    case 3: return launch_quant<Int8>(q_dtype, Dh, a);
    case 4: return launch_quant<Int4>(q_dtype, Dh, a);
    default: return cudaErrorInvalidValue;
  }
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Paged attention over a block-table KV cache, written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_kernel` (deepspeed_tpu/kernels/paged.py:127,
// wrapper `paged_attention_pallas` :176), dense branch.  Computes what
// `paged_attention_reference` computes (deepspeed_tpu_torch/kernels/paged.py):
// for every slot b, query row t and head h,
//     out[b,t,h,:] = softmax_k( where(q_pos[b,t] >= k, q.K_k * Dh^-0.5, NEG_INF) ) . V
// over the slot's L cache rows: key k lives at cache row rows[b, k] (the
// rows are the walk of the slot's block table, serving/kv_cache.py
// `rows_for_tables`).  The cache is [num_rows, H, Dh] in fp32, bf16 or fp16;
// q is read where it lies (a strided view of the fused QKV output), in fp32
// or in the cache dtype, and widened to fp32 as the reference does; rows and
// q_pos are the int64 tensors the serving programs build once per step, so
// a call launches this kernel and nothing else.  The output is written in
// the cache dtype.
//
// What bounds it on this card: bytes.  Each live K/V row is read once per
// query tile and does 4*Dh FLOPs per query row, so at decode (T = 1) the
// arithmetic intensity is about 1 FLOP/byte against the H100's ~295 — far
// below the ridge.  The design therefore only tries to move the bytes it
// must, and to keep loads in flight:
//   * one thread block per (slot*head, tile of up to TQ = 8 query rows); the
//     block walks the slot's rows in a loop, KC = 128 keys per step;
//   * chunks past the causal horizon of the tile (first key > largest q_pos)
//     are never loaded — the loop ends there, so the cost follows the live
//     length, not the table width;
//   * each chunk's KC row indices are read once (one thread per key),
//     clamped, turned into element offsets and kept in shared memory, so the
//     Dh*sizeof(T)/16 threads that copy a key's row do not each load its
//     index again (repeated per-thread index loads in front of the copies
//     made the staging loop the slowest part at decode);
//   * each KC-row K and V chunk of the block's head is staged into shared
//     memory with 16-byte cp.async copies (double-buffered where two blocks
//     still fit on an SM, so the next chunk's loads overlap this chunk's
//     math); rows are padded by 16 bytes so the per-lane 16-byte reads of
//     the score loop are bank-conflict free;
//   * each of the 4 warps takes 32 keys of every chunk for every row of the
//     tile (at decode, T = 1, all four warps work, not one), keeping its own
//     fp32 running max, denominator and accumulator in registers (online
//     softmax): lane j scores key j, warp shuffles reduce max and sum, and
//     for P.V each lane owns Dh/32 output columns.  A row whose position is
//     before a warp's 32 keys skips them (p would be 0 for all).  The four
//     partial results of a row are merged through shared memory at the end.
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
//     to the cache dtype first), so at bf16 the two differ by about one bf16
//     rounding of the output.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TQ = 8;                   // query rows per thread block
constexpr int KW = 32;                  // keys per warp per chunk: one per lane
constexpr int KC = WARPS * KW;          // keys per staged chunk
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// 16 bytes of cache elements -> floats
template <typename T> struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f(e[i]);
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  // src_bytes = 0 zero-fills the 16 destination bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

template <typename T, int DH>
struct Layout {
  static constexpr int ROW_ELEMS = DH + 16 / sizeof(T);  // +16 B padding
  static constexpr int VECS = DH * sizeof(T) / 16;       // 16-B vectors per row
  static constexpr size_t Q_BYTES = size_t(TQ) * DH * sizeof(float);
  // one K (or V) chunk of KC rows for one pipeline stage
  static constexpr size_t CHUNK_BYTES = size_t(KC) * ROW_ELEMS * sizeof(T);
  // double-buffer where that leaves room for two blocks on an SM
  static constexpr int STAGES = Q_BYTES + 4 * CHUNK_BYTES <= 100 * 1024 ? 2 : 1;
  static constexpr size_t SMEM = Q_BYTES + 2 * STAGES * CHUNK_BYTES;
  // the end-of-kernel merge of the warps' partial results reuses the
  // staging buffers: per warp and row, DH accumulators plus (m, l)
  static constexpr size_t MERGE_BYTES = size_t(WARPS) * TQ * (DH + 2) * sizeof(float);
  static_assert(MERGE_BYTES <= 2 * STAGES * CHUNK_BYTES, "merge space");
};

struct QStrides {
  long long b, t, h;  // element strides of q's first three dims (Dh is 1)
};

template <typename T, typename QT, int DH>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const QT* __restrict__ q, QStrides qs,
                       const T* __restrict__ ck, const T* __restrict__ cv,
                       const int64_t* __restrict__ rows,
                       const int64_t* __restrict__ q_pos, T* __restrict__ out,
                       int T_len, int H, int L, int num_rows, float scale) {
  using LY = Layout<T, DH>;
  constexpr int EPL = DH / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_qpos[TQ];
  float* sQ = reinterpret_cast<float*>(smem);
  T* sKV = reinterpret_cast<T*>(smem + LY::Q_BYTES);  // [stage][K|V][KC][ROW]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int t0 = blockIdx.y * TQ;
  const int nt = min(TQ, T_len - t0);
  const int64_t* slot_rows = rows + size_t(b) * L;

  for (int i = tid; i < TQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    sQ[i] = r < nt ? to_f(q[b * qs.b + (t0 + r) * qs.t + h * qs.h + d]) : 0.f;
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
  const int n_chunks = live > 0 ? (live + KC - 1) / KC : 0;

  __shared__ long long s_off[2][KC];  // per stage: element offset of each key's row, -1 past live
  auto stage = [&](int c, int s) {
    T* dk = sKV + size_t(2 * s) * KC * LY::ROW_ELEMS;
    T* dv = dk + size_t(KC) * LY::ROW_ELEMS;
    for (int i = tid; i < KC; i += THREADS) {
      const int key = c * KC + i;
      long long off = -1;
      if (key < live) {
        int64_t cache_row = slot_rows[key];
        cache_row = cache_row < 0 ? 0 : (cache_row >= num_rows ? num_rows - 1 : cache_row);
        off = (cache_row * H + h) * DH;
      }
      s_off[s][i] = off;
    }
    __syncthreads();
    for (int i = tid; i < KC * LY::VECS; i += THREADS) {
      const int row = i / LY::VECS, vec = i % LY::VECS;
      const long long base = s_off[s][row];
      const T* srck = ck;
      const T* srcv = cv;
      int bytes = 0;
      if (base >= 0) {
        const size_t off = size_t(base) + size_t(vec) * Vec16<T>::N;
        srck = ck + off;
        srcv = cv + off;
        bytes = 16;
      }
      cp_async16(dk + row * LY::ROW_ELEMS + vec * Vec16<T>::N, srck, bytes);
      cp_async16(dv + row * LY::ROW_ELEMS + vec * Vec16<T>::N, srcv, bytes);
    }
  };

  // this warp's partial online softmax over its KW keys of every chunk,
  // for every row of the tile
  float m[TQ], l[TQ], acc[TQ][EPL];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[i][e] = 0.f;
  }

  if (LY::STAGES == 2 && n_chunks > 0) {
    stage(0, 0);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int s = LY::STAGES == 2 ? (c & 1) : 0;
    if (LY::STAGES == 1) {
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
    const int first = c * KC + warp * KW;          // this warp's first key
    const T* K = sKV + size_t(2 * s) * KC * LY::ROW_ELEMS + warp * KW * LY::ROW_ELEMS;
    const T* V = K + size_t(KC) * LY::ROW_ELEMS;
    const int kidx = first + lane;
    const uint4* krow = reinterpret_cast<const uint4*>(K + lane * LY::ROW_ELEMS);
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      // warp-uniform: a row whose position is before this warp's keys
      // sees none of them (p = 0 for all 32), which leaves m, l and acc
      // exactly as they are — skip the work
      if (i < nt && s_qpos[i] >= first) {
        const float* qr = sQ + i * DH;
        float dot = 0.f;
#pragma unroll
        for (int v = 0; v < LY::VECS; ++v) {
          float kf[Vec16<T>::N];
          Vec16<T>::unpack(krow[v], kf);
#pragma unroll
          for (int e = 0; e < Vec16<T>::N; ++e)
            dot = fmaf(qr[v * Vec16<T>::N + e], kf[e], dot);
        }
        const float sc = (kidx < L && s_qpos[i] >= kidx) ? dot * scale : NEG_INF;
        const float m_new = fmaxf(m[i], warp_max(sc));
        float p = expf(sc - m_new);
        if (sc <= NEG_INF * 0.5f) p = 0.f;
        const float alpha = expf(m[i] - m_new);
        l[i] = alpha * l[i] + warp_sum(p);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[i][e] *= alpha;
#pragma unroll 8
        for (int j = 0; j < KW; ++j) {
          const float pj = __shfl_sync(FULL, p, j);
          const T* vr = V + j * LY::ROW_ELEMS + lane * EPL;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[i][e] = fmaf(pj, to_f(vr[e]), acc[i][e]);
        }
        m[i] = m_new;
      }
    }
    __syncthreads();  // the next stage() overwrites this buffer
  }

  // merge the warps' partial (m, l, acc) per row; the staging buffers are
  // free after the loop's last barrier (or were never used)
  float* sM = reinterpret_cast<float*>(smem + LY::Q_BYTES);  // [WARPS][TQ][DH+2]
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    if (i < nt) {
      float* d = sM + (size_t(warp) * TQ + i) * (DH + 2);
#pragma unroll
      for (int e = 0; e < EPL; ++e) d[lane * EPL + e] = acc[i][e];
      if (lane == 0) {
        d[DH] = m[i];
        d[DH + 1] = l[i];
      }
    }
  }
  __syncthreads();
  for (int i = warp; i < nt; i += WARPS) {
    float mw[WARPS], m_all = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      mw[w] = sM[(size_t(w) * TQ + i) * (DH + 2) + DH];
      m_all = fmaxf(m_all, mw[w]);
    }
    float l_all = 0.f, o[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* d = sM + (size_t(w) * TQ + i) * (DH + 2);
      const float f = expf(mw[w] - m_all);  // 0 for a warp that saw no key
      l_all = fmaf(d[DH + 1], f, l_all);
#pragma unroll
      for (int e = 0; e < EPL; ++e) o[e] = fmaf(d[lane * EPL + e], f, o[e]);
    }
    const float denom = l_all > 0.f ? l_all : 1.f;
    T* dst = out + ((size_t(b) * T_len + t0 + i) * H + h) * DH + lane * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) dst[e] = from_f<T>(o[e] / denom);
  }
}

struct Args {
  const void *q, *ck, *cv, *rows, *q_pos;
  void* out;
  QStrides qs;
  int B, T_len, H, L, num_rows;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename QT, int DH>
cudaError_t launch(const Args& a) {
  using LY = Layout<T, DH>;
  auto kern = paged_attention_kernel<T, QT, DH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(LY::SMEM));
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.H, (a.T_len + TQ - 1) / TQ);
  kern<<<grid, THREADS, LY::SMEM, a.stream>>>(
      static_cast<const QT*>(a.q), a.qs, static_cast<const T*>(a.ck),
      static_cast<const T*>(a.cv), static_cast<const int64_t*>(a.rows),
      static_cast<const int64_t*>(a.q_pos), static_cast<T*>(a.out), a.T_len,
      a.H, a.L, a.num_rows, a.scale);
  return cudaGetLastError();
}

template <typename T, typename QT>
cudaError_t launch_dh(int Dh, const Args& a) {
  if (Dh == 64) return launch<T, QT, 64>(a);
  if (Dh == 128) return launch<T, QT, 128>(a);
  return cudaErrorInvalidValue;
}

// q in fp32 or in the cache dtype T
template <typename T>
cudaError_t launch_q(int q_f32, int Dh, const Args& a) {
  return q_f32 ? launch_dh<T, float>(Dh, a) : launch_dh<T, T>(Dh, a);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (the cache and output dtype).
// q [B, T, H, Dh] with element strides (q_sb, q_st, q_sh) and unit stride
// over Dh, in fp32 (q_f32 = 1) or in the cache dtype (q_f32 = 0);
// ck/cv [num_rows, H, Dh] contiguous; rows int64 [B, L] and q_pos int64
// [B, T] contiguous; out [B, T, H, Dh] contiguous; scale = Dh**-0.5 as the
// caller rounds it to fp32.  Returns the cudaError_t of the launch (0 on
// success); the caller raises on anything else.
int paged_attention_fwd(const void* q, long long q_sb, long long q_st,
                        long long q_sh, int q_f32, const void* ck,
                        const void* cv, const void* rows, const void* q_pos,
                        void* out, int B, int T_len, int H, int Dh, int L,
                        int num_rows, float scale, int dtype, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not an older one
  if (B <= 0 || T_len <= 0 || H <= 0 || L <= 0 || num_rows <= 0)
    return cudaErrorInvalidValue;
  if ((T_len + TQ - 1) / TQ > 65535) return cudaErrorInvalidValue;
  const Args a{q, ck, cv, rows, q_pos, out, {q_sb, q_st, q_sh}, B, T_len, H,
               L, num_rows, scale, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch_q<float>(q_f32, Dh, a);
    case 1: return launch_q<__nv_bfloat16>(q_f32, Dh, a);
    case 2: return launch_q<__half>(q_f32, Dh, a);
    default: return cudaErrorInvalidValue;
  }
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Flash attention forward, dQ and dK/dV, written for Hopper (sm_90a).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/transformer/flash_attention.py:
//   flash_attention_fwd  <- `_fwd_kernel` (:113, pallas_call :200)
//   flash_attention_dq   <- `_dq_kernel`  (:227, pallas_call :368)
//   flash_attention_dkv  <- `_dkv_kernel` (:280, pallas_call :395)
// and computes what their plain PyTorch versions compute
// (deepspeed_tpu_torch/ops/transformer/flash_attention.py `_fwd_plain`,
// `_dq_plain`, `_dkv_plain`), on [BH, S, D] tensors in fp32, bf16 or fp16,
// D = 64 or 128:
//   fwd:  s = (q*scale).k, causal select to NEG_INF, + per-key bias; online
//         softmax; the denominator sums the undropped p, the value sum takes
//         p * keep_mask rounded to V's dtype; out = acc / l (l == 0 -> 1),
//         lse = m + log(l);
//   dq:   p = exp(s - lse); dp = dO.V^T (* keep_mask); ds = p (dp - delta);
//         dq = scale * sum(round_K(ds) . K);
//   dkv:  the same p, pd = p * keep_mask, ds as in dq, all kept in fp32;
//         dv = sum(pd^T . dO), dk = scale * sum(ds^T . q).
// delta = rowsum(dO * O) is a plain op of the caller, as in JAX.
//
// Dropout: the keep mask of element (bh, q, k) is the counter hash of the
// JAX kernels (`_keep_mask`, :70), recomputed bit for bit in all three
// kernels from (seed, bh + bh_offset, global q, global k), so the three
// agree with one another and with JAX for a given seed, whatever the tiling.
//
// What bounds it on this card: at the training shape (S = 1024, D = 64,
// causal) attention does ~2·S·D FLOPs per byte it must move, far above the
// H100's ~295 FLOP/byte ridge: the bound is operations, the bf16 tensor
// cores' 989 TFLOP/s.  Two paths:
//   * bf16 / fp16 (the training dtypes): warp-level tensor-core tiles,
//     mma.sync m16n8k16 with fp32 accumulators (flash_*_mma_kernel below).
//     A block of 4 warps owns a (bh, 64-row q tile) for the forward and dQ
//     and a (bh, 64-key tile) for dK/dV, each warp 16 of those rows, and
//     loops over the other axis, skipping the tiles above the causal
//     diagonal; causal q tiles are scheduled heaviest first.  The second
//     product of each kernel takes its A operand (p, ds, pd^T, ds^T) from
//     the first product's accumulators in registers.  dK/dV keeps pd and ds
//     in fp32, as the function does, by feeding each to the tensor cores as
//     three bf16 terms (hi + mid + lo carries fp32's 24 bits); that path is
//     bf16 at D = 64, the training shape; fp16 and D = 128 take the CUDA-core
//     dK/dV.
//   * fp32, and the dK/dV cases above: fp32 FMAs on the CUDA cores (67
//     TFLOP/s peak).  Tiles are staged in shared memory as fp32 rows padded
//     by one word; a thread owns RM rows (strided by 16) and every 8th
//     column, so the 8 lanes that share rows reduce max and sum with three
//     shuffles and the shared-memory reads are conflict free.
// Both keep scores, probabilities and accumulators in fp32 and make only
// the roundings that define the function (p to V's dtype before P.V, ds to
// K's dtype before dS.K).  Staging is plain 16-byte loads; cp.async or TMA
// pipelining and wgmma are later work.
//
// Exactness notes (the TPU kernels' guards, kept): masks are selects to the
// finite NEG_INF = -1e30 (the bias is clamped to >= NEG_INF by the caller);
// with a bias, p is zeroed where s <= NEG_INF/2 (a fully masked row keeps
// m at ~NEG_INF, where exp(s - m) would be 1); a fully masked row gives a
// zero output; keys or rows past the sequence end contribute exactly 0.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int RG = 16;  // row groups: thread tid owns rows i*RG + tid/CG
constexpr int CG = 8;   // column lanes: and columns j*CG + tid%CG
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
// x rounded to T and widened back (the casts p.astype(v.dtype) and
// ds.astype(k.dtype) before a product with fp32 accumulation)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

struct Params {
  int BH, H, S, Sk;
  float scale;
  int causal;
  const float* kb;    // [BH / H, Sk] per-key bias (clamped) or null
  uint32_t seed_h;    // uint32(seed) * 0x9E3779B1
  int bh_offset;
  uint32_t thr;       // keep iff hash < thr
  float inv_keep;     // fp32(1 / (1 - rate))
  int dropout;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  h *= 0x297A2D39u;
  h ^= h >> 15;
  return h;
}

// the {0, 1/keep} mask value of (q, k) for a row block with hash term bhm
__device__ __forceinline__ float keep_scale(const Params& p, uint32_t bhm,
                                            int q, int k) {
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

// masked, biased score of (row qg, key kg); -inf for a key past the end
__device__ __forceinline__ float masked_score(const Params& p, float s,
                                              int qg, int kg) {
  if (kg >= p.Sk) return -INFINITY;
  if (p.causal && qg < kg) s = NEG_INF;
  if (p.kb) s += p.kb[kg];
  return s;
}

// ---------------------------------------------------------------------------
// forward: one block per (q tile, bh)
// ---------------------------------------------------------------------------

template <typename T, int D, int BQ, int BK>
struct FwdLayout {
  static constexpr int LD = D + 1, LP = BK + 1;
  static constexpr size_t FLOATS = size_t(BQ) * LD + 2 * size_t(BK) * LD + size_t(BQ) * LP;
  static constexpr size_t SMEM = FLOATS * sizeof(float);
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Params p) {
  using LY = FwdLayout<T, D, BQ, BK>;
  constexpr int RM = BQ / RG, CN = BK / CG, DN = D / CG;
  constexpr int LD = LY::LD, LP = LY::LP;
  extern __shared__ __align__(16) float sm[];
  float* sQ = sm;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int r = threadIdx.x / CG, c = threadIdx.x % CG;
  const int nq = (p.S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - int(blockIdx.x)) * BQ;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const T* kh = k + size_t(bh) * p.Sk * D;
  const T* vh = v + size_t(bh) * p.Sk * D;
  if (p.kb) p.kb += size_t(bh / p.H) * p.Sk;
  const uint32_t bhm = uint32_t(bh + p.bh_offset) * 0x7FEB352Du;

  load_rows<T, D>(sQ, q + size_t(bh) * p.S * D, q0, p.S, BQ, p.scale);

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DN; ++e) acc[i][e] = 0.f;
  }

  // causal: keys past the tile's last row are masked for every row of it
  const int k_end = p.causal ? min(p.Sk, q0 + BQ) : p.Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's reads of sK, sV, sP are done
    load_rows<T, D>(sK, kh, k0, p.Sk, BK, 1.f);
    load_rows<T, D>(sV, vh, k0, p.Sk, BK, 1.f);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RM], b[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = sQ[(i * RG + r) * LD + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) b[j] = sK[(j * CG + c) * LD + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = i * RG + r, qg = q0 + row;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = masked_score(p, s[i][j], qg, k0 + j * CG + c);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kg = k0 + j * CG + c;
        float pv = kg < p.Sk ? expf(s[i][j] - m_new) : 0.f;
        if (p.kb && s[i][j] <= NEG_INF * 0.5f) pv = 0.f;
        psum += pv;
        if (p.dropout) pv *= keep_scale(p, bhm, qg, kg);
        sP[row * LP + j * CG + c] = round_to<T>(pv);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(psum);
#pragma unroll
      for (int e = 0; e < DN; ++e) acc[i][e] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

    const int nk = min(BK, p.Sk - k0);
    for (int kk = 0; kk < nk; ++kk) {
      float a[RM], b[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = sP[(i * RG + r) * LP + kk];
#pragma unroll
      for (int e = 0; e < DN; ++e) b[e] = sV[kk * LD + e * CG + c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int e = 0; e < DN; ++e) acc[i][e] = fmaf(a[i], b[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qg = q0 + i * RG + r;
    if (qg >= p.S) continue;
    const float safe = l[i] == 0.f ? 1.f : l[i];
    T* dst = o + (size_t(bh) * p.S + qg) * D;
#pragma unroll
    for (int e = 0; e < DN; ++e) dst[e * CG + c] = from_f<T>(acc[i][e] / safe);
    if (c == 0) lse[size_t(bh) * p.S + qg] = m[i] + logf(safe);
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (q tile, bh)
// ---------------------------------------------------------------------------

template <typename T, int D, int BQ, int BK>
struct DqLayout {
  static constexpr int LD = D + 1, LP = BK + 1;
  static constexpr size_t FLOATS = 2 * size_t(BQ) * LD + 2 * size_t(BK) * LD + size_t(BQ) * LP;
  static constexpr size_t SMEM = FLOATS * sizeof(float);
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, Params p) {
  using LY = DqLayout<T, D, BQ, BK>;
  constexpr int RM = BQ / RG, CN = BK / CG, DN = D / CG;
  constexpr int LD = LY::LD, LP = LY::LP;
  extern __shared__ __align__(16) float sm[];
  float* sQ = sm;
  float* sO = sQ + BQ * LD;   // dO
  float* sK = sO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;   // ds rounded to K's dtype

  const int r = threadIdx.x / CG, c = threadIdx.x % CG;
  const int nq = (p.S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - int(blockIdx.x)) * BQ;
  const int bh = blockIdx.y;
  const T* kh = k + size_t(bh) * p.Sk * D;
  const T* vh = v + size_t(bh) * p.Sk * D;
  if (p.kb) p.kb += size_t(bh / p.H) * p.Sk;
  const uint32_t bhm = uint32_t(bh + p.bh_offset) * 0x7FEB352Du;

  load_rows<T, D>(sQ, q + size_t(bh) * p.S * D, q0, p.S, BQ, p.scale);
  load_rows<T, D>(sO, dout + size_t(bh) * p.S * D, q0, p.S, BQ, 1.f);
  float lse_r[RM], delta_r[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qg = q0 + i * RG + r;
    lse_r[i] = qg < p.S ? lse[size_t(bh) * p.S + qg] : 0.f;
    delta_r[i] = qg < p.S ? delta[size_t(bh) * p.S + qg] : 0.f;
#pragma unroll
    for (int e = 0; e < DN; ++e) acc[i][e] = 0.f;
  }

  const int k_end = p.causal ? min(p.Sk, q0 + BQ) : p.Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_rows<T, D>(sK, kh, k0, p.Sk, BK, 1.f);
    load_rows<T, D>(sV, vh, k0, p.Sk, BK, 1.f);
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RM], ao[RM], b[CN], bv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        a[i] = sQ[(i * RG + r) * LD + d];
        ao[i] = sO[(i * RG + r) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        b[j] = sK[(j * CG + c) * LD + d];
        bv[j] = sV[(j * CG + c) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(ao[i], bv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = i * RG + r, qg = q0 + row;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kg = k0 + j * CG + c;
        const float x = masked_score(p, s[i][j], qg, kg);
        float pv = kg < p.Sk ? expf(x - lse_r[i]) : 0.f;
        if (p.kb && x <= NEG_INF * 0.5f) pv = 0.f;
        float dpv = dp[i][j];
        if (p.dropout) dpv *= keep_scale(p, bhm, qg, kg);
        sS[row * LP + j * CG + c] = round_to<T>(pv * (dpv - delta_r[i]));
      }
    }
    __syncthreads();

    const int nk = min(BK, p.Sk - k0);
    for (int kk = 0; kk < nk; ++kk) {
      float a[RM], b[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = sS[(i * RG + r) * LP + kk];
#pragma unroll
      for (int e = 0; e < DN; ++e) b[e] = sK[kk * LD + e * CG + c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int e = 0; e < DN; ++e) acc[i][e] = fmaf(a[i], b[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qg = q0 + i * RG + r;
    if (qg >= p.S) continue;
    T* dst = dq + (size_t(bh) * p.S + qg) * D;
#pragma unroll
    for (int e = 0; e < DN; ++e) dst[e * CG + c] = from_f<T>(p.scale * acc[i][e]);
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (k tile, bh), sweeping the q tiles
// ---------------------------------------------------------------------------

template <typename T, int D, int BKV, int BQ>
struct DkvLayout {
  static constexpr int LD = D + 1, LP = BQ + 1;
  static constexpr size_t FLOATS = 2 * size_t(BKV) * LD + 2 * size_t(BQ) * LD +
                                   2 * size_t(BKV) * LP + 2 * size_t(BQ);
  static constexpr size_t SMEM = FLOATS * sizeof(float);
};

template <typename T, int D, int BKV, int BQ>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, Params p) {
  using LY = DkvLayout<T, D, BKV, BQ>;
  constexpr int RM = BKV / RG, CN = BQ / CG, DN = D / CG;
  constexpr int LD = LY::LD, LP = LY::LP;
  extern __shared__ __align__(16) float sm[];
  float* sK = sm;
  float* sV = sK + BKV * LD;
  float* sQ = sV + BKV * LD;   // q, unscaled
  float* sO = sQ + BQ * LD;    // dO
  float* sPd = sO + BQ * LD;   // pd^T [key][q], fp32
  float* sDs = sPd + BKV * LP; // ds^T [key][q], fp32
  float* sL = sDs + BKV * LP;  // lse of the q tile
  float* sD = sL + BQ;         // delta of the q tile

  const int r = threadIdx.x / CG, c = threadIdx.x % CG;
  const int k0 = blockIdx.x * BKV;  // causal: the first k tiles see the most q tiles
  const int bh = blockIdx.y;
  const T* qh = q + size_t(bh) * p.S * D;
  const T* oh = dout + size_t(bh) * p.S * D;
  const float* lh = lse + size_t(bh) * p.S;
  const float* dh = delta + size_t(bh) * p.S;
  if (p.kb) p.kb += size_t(bh / p.H) * p.Sk;
  const uint32_t bhm = uint32_t(bh + p.bh_offset) * 0x7FEB352Du;

  load_rows<T, D>(sK, k + size_t(bh) * p.Sk * D, k0, p.Sk, BKV, 1.f);
  load_rows<T, D>(sV, v + size_t(bh) * p.Sk * D, k0, p.Sk, BKV, 1.f);
  float dka[RM][DN], dva[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int e = 0; e < DN; ++e) dka[i][e] = dva[i][e] = 0.f;

  // causal: q tiles whose rows all precede this k tile see none of it
  const int q_begin = p.causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < p.S; q0 += BQ) {
    __syncthreads();
    load_rows<T, D>(sQ, qh, q0, p.S, BQ, 1.f);
    load_rows<T, D>(sO, oh, q0, p.S, BQ, 1.f);
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const bool in = q0 + i < p.S;
      sL[i] = in ? lh[q0 + i] : 0.f;
      sD[i] = in ? dh[q0 + i] : 0.f;
    }
    __syncthreads();

    // transposed tiles: rows are keys, columns are q rows
    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RM], av[RM], b[CN], bo[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        a[i] = sK[(i * RG + r) * LD + d];
        av[i] = sV[(i * RG + r) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        b[j] = sQ[(j * CG + c) * LD + d];
        bo[j] = sO[(j * CG + c) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(av[i], bo[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = i * RG + r, kg = k0 + row;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int col = j * CG + c, qg = q0 + col;
        // s = (q*scale).k: scale * (q.k) is the same number when scale is a
        // power of two (D = 64) and within one rounding otherwise
        const float x = masked_score(p, p.scale * s[i][j], qg, kg);
        float pv = (kg < p.Sk && qg < p.S) ? expf(x - sL[col]) : 0.f;
        if (p.kb && x <= NEG_INF * 0.5f) pv = 0.f;
        float pd = pv, dpv = dp[i][j];
        if (p.dropout) {
          const float ks = keep_scale(p, bhm, qg, kg);
          pd *= ks;
          dpv *= ks;
        }
        sPd[row * LP + col] = pd;
        sDs[row * LP + col] = pv * (dpv - sD[col]);
      }
    }
    __syncthreads();

    const int nqr = min(BQ, p.S - q0);
    for (int qq = 0; qq < nqr; ++qq) {
      float apd[RM], ads[RM], bo[DN], bq[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        apd[i] = sPd[(i * RG + r) * LP + qq];
        ads[i] = sDs[(i * RG + r) * LP + qq];
      }
#pragma unroll
      for (int e = 0; e < DN; ++e) {
        bo[e] = sO[qq * LD + e * CG + c];
        bq[e] = sQ[qq * LD + e * CG + c];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int e = 0; e < DN; ++e) {
          dva[i][e] = fmaf(apd[i], bo[e], dva[i][e]);
          dka[i][e] = fmaf(ads[i], bq[e], dka[i][e]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int kg = k0 + i * RG + r;
    if (kg >= p.Sk) continue;
    T* dstk = dk + (size_t(bh) * p.Sk + kg) * D;
    T* dstv = dv + (size_t(bh) * p.Sk + kg) * D;
#pragma unroll
    for (int e = 0; e < DN; ++e) {
      dstk[e * CG + c] = from_f<T>(p.scale * dka[i][e]);
      dstv[e * CG + c] = from_f<T>(dva[i][e]);
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core forward and dQ for bf16 / fp16: mma.sync m16n8k16
// ---------------------------------------------------------------------------
//
// One block of 4 warps per (64-row q tile, bh); each warp owns 16 q rows and
// keeps its Q (and dO) operand fragments in registers for the whole k loop.
// A k tile of BK keys is staged in shared memory as rows padded by 8
// elements (conflict-free 32-bit fragment reads), K row-major for S = Q.K^T
// and V (or K, for dQ) transposed for the second product.  Scores and
// accumulators are fp32 in the mma accumulators; the probabilities (or ds)
// are rounded to T once, as the function does, and fed back as the A
// operand of the second product straight from registers.  Fragment
// layouts (PTX ISA, mma.m16n8k16): lane = 4g + t; A regs {row g | g+8} x
// {cols 2t, 2t+1 | +8}; B regs {k 2t, 2t+1 | +8} x {col g}; C {row g | g+8}
// x {cols 2t, 2t+1}.

template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
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

template <typename T, int D, int BK>
struct MmaLayout {
  static constexpr int BQ = 64, LDK = D + 8, LDT = BK + 8;
  static constexpr size_t FWD_SMEM = (size_t(BK) * LDK + size_t(D) * LDT) * sizeof(T);
  static constexpr size_t DQ_SMEM = (2 * size_t(BK) * LDK + size_t(D) * LDT) * sizeof(T);
};

template <typename T, int D, int BK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, Params p) {
  using LY = MmaLayout<T, D, BK>;
  constexpr int BQ = LY::BQ, LDK = LY::LDK, LDT = LY::LDT;
  constexpr int KD = D / 16, NT = BK / 8, KK = BK / 16, DN = D / 8;
  extern __shared__ __align__(16) unsigned char smraw[];
  T* sK = reinterpret_cast<T*>(smraw);   // [BK][LDK]
  T* sVt = sK + BK * LDK;                // [D][LDT]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (p.S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - int(blockIdx.x)) * BQ;
  const int bh = blockIdx.y;
  const T* kh = k + size_t(bh) * p.Sk * D;
  const T* vh = v + size_t(bh) * p.Sk * D;
  if (p.kb) p.kb += size_t(bh / p.H) * p.Sk;
  const uint32_t bhm = uint32_t(bh + p.bh_offset) * 0x7FEB352Du;
  const int r0 = q0 + warp * 16, ra = r0 + g, rb = ra + 8;

  uint32_t qa[KD][4];
  load_a<T, D>(qa, q + size_t(bh) * p.S * D, r0, p.S, g, t);
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

  const int k_end = p.causal ? min(p.Sk, q0 + BQ) : p.Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    stage_rows<T, D, LDK>(sK, kh, k0, p.Sk, BK);
    stage_cols<T, D, LDT>(sVt, vh, k0, p.Sk, BK);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    mma_tiles<T, KD, NT, LDK>(s, qa, sK, g, t);

    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kg = k0 + nt * 8 + 2 * t + i;
        s[nt][i] = masked_score(p, p.scale * s[nt][i], ra, kg);
        s[nt][2 + i] = masked_score(p, p.scale * s[nt][2 + i], rb, kg);
        mx_a = fmaxf(mx_a, s[nt][i]);
        mx_b = fmaxf(mx_b, s[nt][2 + i]);
      }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kg = k0 + nt * 8 + 2 * t + (i & 1);
        const int row = i < 2 ? ra : rb;
        const float mn = i < 2 ? mn_a : mn_b;
        float pv = kg < p.Sk ? expf(s[nt][i] - mn) : 0.f;
        if (p.kb && s[nt][i] <= NEG_INF * 0.5f) pv = 0.f;
        if (i < 2) ps_a += pv; else ps_b += pv;
        if (p.dropout) pv *= keep_scale(p, bhm, row, kg);
        s[nt][i] = pv;
      }
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    l_a = al_a * l_a + quad_sum(ps_a);
    l_b = al_b * l_b + quad_sum(ps_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      acc[dn][0] *= al_a;
      acc[dn][1] *= al_a;
      acc[dn][2] *= al_b;
      acc[dn][3] *= al_b;
    }
    uint32_t pa[KK][4];
    c_to_a<T, KK>(pa, s);  // p rounded to V's dtype
    mma_tiles<T, KK, DN, LDT>(acc, pa, sVt, g, t);
  }

  const float sa = l_a == 0.f ? 1.f : l_a, sb = l_b == 0.f ? 1.f : l_b;
  T* oh = o + size_t(bh) * p.S * D;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (ra < p.S)
      *reinterpret_cast<uint32_t*>(oh + size_t(ra) * D + col) =
          Mma<T>::pack(acc[dn][0] / sa, acc[dn][1] / sa);
    if (rb < p.S)
      *reinterpret_cast<uint32_t*>(oh + size_t(rb) * D + col) =
          Mma<T>::pack(acc[dn][2] / sb, acc[dn][3] / sb);
  }
  if (t == 0) {
    if (ra < p.S) lse[size_t(bh) * p.S + ra] = m_a + logf(sa);
    if (rb < p.S) lse[size_t(bh) * p.S + rb] = m_b + logf(sb);
  }
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(THREADS)
flash_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Params p) {
  using LY = MmaLayout<T, D, BK>;
  constexpr int BQ = LY::BQ, LDK = LY::LDK, LDT = LY::LDT;
  constexpr int KD = D / 16, NT = BK / 8, KK = BK / 16, DN = D / 8;
  extern __shared__ __align__(16) unsigned char smraw[];
  T* sK = reinterpret_cast<T*>(smraw);   // [BK][LDK]
  T* sV = sK + BK * LDK;                 // [BK][LDK]
  T* sKt = sV + BK * LDK;                // [D][LDT]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (p.S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - int(blockIdx.x)) * BQ;
  const int bh = blockIdx.y;
  const T* kh = k + size_t(bh) * p.Sk * D;
  const T* vh = v + size_t(bh) * p.Sk * D;
  if (p.kb) p.kb += size_t(bh / p.H) * p.Sk;
  const uint32_t bhm = uint32_t(bh + p.bh_offset) * 0x7FEB352Du;
  const int r0 = q0 + warp * 16, ra = r0 + g, rb = ra + 8;

  uint32_t qa[KD][4], da[KD][4];
  load_a<T, D>(qa, q + size_t(bh) * p.S * D, r0, p.S, g, t);
  load_a<T, D>(da, dout + size_t(bh) * p.S * D, r0, p.S, g, t);
  const float lse_a = ra < p.S ? lse[size_t(bh) * p.S + ra] : 0.f;
  const float lse_b = rb < p.S ? lse[size_t(bh) * p.S + rb] : 0.f;
  const float dl_a = ra < p.S ? delta[size_t(bh) * p.S + ra] : 0.f;
  const float dl_b = rb < p.S ? delta[size_t(bh) * p.S + rb] : 0.f;
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  const int k_end = p.causal ? min(p.Sk, q0 + BQ) : p.Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    stage_rows<T, D, LDK>(sK, kh, k0, p.Sk, BK);
    stage_rows<T, D, LDK>(sV, vh, k0, p.Sk, BK);
    stage_cols<T, D, LDT>(sKt, kh, k0, p.Sk, BK);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
    mma_tiles<T, KD, NT, LDK>(s, qa, sK, g, t);
    mma_tiles<T, KD, NT, LDK>(dp, da, sV, g, t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kg = k0 + nt * 8 + 2 * t + (i & 1);
        const int row = i < 2 ? ra : rb;
        const float x = masked_score(p, p.scale * s[nt][i], row, kg);
        float pv = kg < p.Sk ? expf(x - (i < 2 ? lse_a : lse_b)) : 0.f;
        if (p.kb && x <= NEG_INF * 0.5f) pv = 0.f;
        float dpv = dp[nt][i];
        if (p.dropout) dpv *= keep_scale(p, bhm, row, kg);
        s[nt][i] = pv * (dpv - (i < 2 ? dl_a : dl_b));
      }
    uint32_t dsa[KK][4];
    c_to_a<T, KK>(dsa, s);  // ds rounded to K's dtype
    mma_tiles<T, KK, DN, LDT>(acc, dsa, sKt, g, t);
  }

  T* dqh = dq + size_t(bh) * p.S * D;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (ra < p.S)
      *reinterpret_cast<uint32_t*>(dqh + size_t(ra) * D + col) =
          Mma<T>::pack(p.scale * acc[dn][0], p.scale * acc[dn][1]);
    if (rb < p.S)
      *reinterpret_cast<uint32_t*>(dqh + size_t(rb) * D + col) =
          Mma<T>::pack(p.scale * acc[dn][2], p.scale * acc[dn][3]);
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

template <int D, int BKV, int BQ>
struct DkvMmaLayout {
  static constexpr int LDR = D + 8, LDT = BQ + 8;
  static constexpr size_t BYTES =
      (2 * size_t(BKV) * LDR + 2 * size_t(BQ) * LDR + 2 * size_t(D) * LDT) *
          sizeof(__nv_bfloat16) + 2 * size_t(BQ) * sizeof(float);
};

// dK, dV in bf16 on the tensor cores: one block of 4 warps per (64-key tile,
// bh), each warp 16 keys, sweeping the q tiles.  The transposed tiles
// S^T = K.Q^T and dP^T = V.dO^T come out of the mma with keys as rows, so
// pd^T and ds^T are C fragments and feed dV += pd^T.dO and dK += ds^T.Q as
// A operands from registers, in three bf16 terms each (mma_fp32_a).
template <int D, int BKV, int BQ>
__global__ void __launch_bounds__(THREADS)
flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, Params p) {
  using T = __nv_bfloat16;
  using LY = DkvMmaLayout<D, BKV, BQ>;
  constexpr int LDR = LY::LDR, LDT = LY::LDT;
  constexpr int KD = D / 16, NT = BQ / 8, KK = BQ / 16, DN = D / 8;
  extern __shared__ __align__(16) unsigned char smraw[];
  T* sK = reinterpret_cast<T*>(smraw);  // [BKV][LDR]
  T* sV = sK + BKV * LDR;               // [BKV][LDR]
  T* sQ = sV + BKV * LDR;               // [BQ][LDR]
  T* sO = sQ + BQ * LDR;                // dO [BQ][LDR]
  T* sQt = sO + BQ * LDR;               // [D][LDT]
  T* sOt = sQt + D * LDT;               // [D][LDT]
  float* sL = reinterpret_cast<float*>(sOt + D * LDT);
  float* sDl = sL + BQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BKV;
  const int bh = blockIdx.y;
  const T* qh = q + size_t(bh) * p.S * D;
  const T* oh = dout + size_t(bh) * p.S * D;
  const float* lh = lse + size_t(bh) * p.S;
  const float* dh = delta + size_t(bh) * p.S;
  if (p.kb) p.kb += size_t(bh / p.H) * p.Sk;
  const uint32_t bhm = uint32_t(bh + p.bh_offset) * 0x7FEB352Du;
  const int ka = k0 + warp * 16 + g, kb_ = ka + 8;

  stage_rows<T, D, LDR>(sK, k + size_t(bh) * p.Sk * D, k0, p.Sk, BKV);
  stage_rows<T, D, LDR>(sV, v + size_t(bh) * p.Sk * D, k0, p.Sk, BKV);
  float dka[DN][4], dva[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[dn][i] = dva[dn][i] = 0.f;

  const int q_begin = p.causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < p.S; q0 += BQ) {
    __syncthreads();
    stage_rows<T, D, LDR>(sQ, qh, q0, p.S, BQ);
    stage_rows<T, D, LDR>(sO, oh, q0, p.S, BQ);
    stage_cols<T, D, LDT>(sQt, qh, q0, p.S, BQ);
    stage_cols<T, D, LDT>(sOt, oh, q0, p.S, BQ);
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const bool in = q0 + i < p.S;
      sL[i] = in ? lh[q0 + i] : 0.f;
      sDl[i] = in ? dh[q0 + i] : 0.f;
    }
    __syncthreads();

    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[nt][i] = dpt[nt][i] = 0.f;
    mma_tiles_sa<T, KD, NT, LDR, LDR>(st, sK + warp * 16 * LDR, sQ, g, t);
    mma_tiles_sa<T, KD, NT, LDR, LDR>(dpt, sV + warp * 16 * LDR, sO, g, t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 8 + 2 * t + (i & 1), qg = q0 + col;
        const int kg = i < 2 ? ka : kb_;
        // s = (q*scale).k: scale * (q.k) is the same number when scale is
        // a power of two (D = 64)
        const float x = masked_score(p, p.scale * st[nt][i], qg, kg);
        float pv = (kg < p.Sk && qg < p.S) ? expf(x - sL[col]) : 0.f;
        if (p.kb && x <= NEG_INF * 0.5f) pv = 0.f;
        float pd = pv, dpv = dpt[nt][i];
        if (p.dropout) {
          const float ks = keep_scale(p, bhm, qg, kg);
          pd *= ks;
          dpv *= ks;
        }
        st[nt][i] = pd;                          // pd^T, fp32
        dpt[nt][i] = pv * (dpv - sDl[col]);      // ds^T, fp32
      }
    mma_fp32_a<KK, DN, LDT>(dva, st, sOt, g, t);
    mma_fp32_a<KK, DN, LDT>(dka, dpt, sQt, g, t);
  }

#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (ka < p.Sk) {
      const size_t o = (size_t(bh) * p.Sk + ka) * D + col;
      *reinterpret_cast<uint32_t*>(dk + o) =
          Mma<T>::pack(p.scale * dka[dn][0], p.scale * dka[dn][1]);
      *reinterpret_cast<uint32_t*>(dv + o) = Mma<T>::pack(dva[dn][0], dva[dn][1]);
    }
    if (kb_ < p.Sk) {
      const size_t o = (size_t(bh) * p.Sk + kb_) * D + col;
      *reinterpret_cast<uint32_t*>(dk + o) =
          Mma<T>::pack(p.scale * dka[dn][2], p.scale * dka[dn][3]);
      *reinterpret_cast<uint32_t*>(dv + o) = Mma<T>::pack(dva[dn][2], dva[dn][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Ptrs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o, *lse_out, *dq, *dk, *dv;
};

// tile sizes: (q rows, k rows) for fwd/dq, (k rows, q rows) for dkv; the
// D = 128 tiles are halved where registers or shared memory would not fit
template <int D> struct Tiles;
template <> struct Tiles<64> { static constexpr int BQ = 64, BK = 64, BKV = 64, BQ2 = 64; };
template <> struct Tiles<128> { static constexpr int BQ = 64, BK = 32, BKV = 32, BQ2 = 64; };

template <typename KernelT>
cudaError_t set_smem(KernelT kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

// the mma tile depth over keys: D = 128 halves it for dQ's registers
template <int D> struct MmaTiles;
template <> struct MmaTiles<64> { static constexpr int FWD_BK = 64, DQ_BK = 64; };
template <> struct MmaTiles<128> { static constexpr int FWD_BK = 64, DQ_BK = 32; };

// Which kernel runs, chosen at compile time so that each is instantiated
// only for the dtypes that reach it: the tensor-core forward and dQ for
// bf16 / fp16, the tensor-core dK/dV for bf16 at D = 64 (at D = 128 its
// accumulators would not fit in registers), the CUDA-core kernels for the
// rest.
template <typename T, int D>
cudaError_t launch(int which, const Ptrs& a, const Params& p, cudaStream_t st) {
  using TL = Tiles<D>;
  using MT = MmaTiles<D>;
  constexpr bool mma = !std::is_same<T, float>::value;
  constexpr bool mma_dkv = std::is_same<T, __nv_bfloat16>::value && D == 64;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  cudaError_t e;
  if (which == 0) {
    if constexpr (mma) {
      using LY = MmaLayout<T, D, MT::FWD_BK>;
      auto kern = flash_fwd_mma_kernel<T, D, MT::FWD_BK>;
      if ((e = set_smem(kern, LY::FWD_SMEM)) != cudaSuccess) return e;
      dim3 grid((p.S + LY::BQ - 1) / LY::BQ, p.BH);
      kern<<<grid, THREADS, LY::FWD_SMEM, st>>>(
          q, k, v, static_cast<T*>(a.o), static_cast<float*>(a.lse_out), p);
    } else {
      using LY = FwdLayout<T, D, TL::BQ, TL::BK>;
      auto kern = flash_fwd_kernel<T, D, TL::BQ, TL::BK>;
      if ((e = set_smem(kern, LY::SMEM)) != cudaSuccess) return e;
      dim3 grid((p.S + TL::BQ - 1) / TL::BQ, p.BH);
      kern<<<grid, THREADS, LY::SMEM, st>>>(
          q, k, v, static_cast<T*>(a.o), static_cast<float*>(a.lse_out), p);
    }
  } else if (which == 1) {
    if constexpr (mma) {
      using LY = MmaLayout<T, D, MT::DQ_BK>;
      auto kern = flash_dq_mma_kernel<T, D, MT::DQ_BK>;
      if ((e = set_smem(kern, LY::DQ_SMEM)) != cudaSuccess) return e;
      dim3 grid((p.S + LY::BQ - 1) / LY::BQ, p.BH);
      kern<<<grid, THREADS, LY::DQ_SMEM, st>>>(
          q, k, v, dout, lse, delta, static_cast<T*>(a.dq), p);
    } else {
      using LY = DqLayout<T, D, TL::BQ, TL::BK>;
      auto kern = flash_dq_kernel<T, D, TL::BQ, TL::BK>;
      if ((e = set_smem(kern, LY::SMEM)) != cudaSuccess) return e;
      dim3 grid((p.S + TL::BQ - 1) / TL::BQ, p.BH);
      kern<<<grid, THREADS, LY::SMEM, st>>>(
          q, k, v, dout, lse, delta, static_cast<T*>(a.dq), p);
    }
  } else {
    if constexpr (mma_dkv) {
      using LY = DkvMmaLayout<D, 64, 64>;
      auto kern = flash_dkv_mma_kernel<D, 64, 64>;
      if ((e = set_smem(kern, LY::BYTES)) != cudaSuccess) return e;
      dim3 grid((p.Sk + 63) / 64, p.BH);
      kern<<<grid, THREADS, LY::BYTES, st>>>(
          q, k, v, dout, lse, delta, static_cast<T*>(a.dk),
          static_cast<T*>(a.dv), p);
    } else {
      using LY = DkvLayout<T, D, TL::BKV, TL::BQ2>;
      auto kern = flash_dkv_kernel<T, D, TL::BKV, TL::BQ2>;
      if ((e = set_smem(kern, LY::SMEM)) != cudaSuccess) return e;
      dim3 grid((p.Sk + TL::BKV - 1) / TL::BKV, p.BH);
      kern<<<grid, THREADS, LY::SMEM, st>>>(
          q, k, v, dout, lse, delta, static_cast<T*>(a.dk),
          static_cast<T*>(a.dv), p);
    }
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int which, int D, const Ptrs& a, const Params& p,
                     cudaStream_t st) {
  if (D == 64) return launch<T, 64>(which, a, p, st);
  if (D == 128) return launch<T, 128>(which, a, p, st);
  return cudaErrorInvalidValue;
}

int run(int which, const Ptrs& a, int BH, int H, int S, int Sk, int D,
        float scale, int causal, const void* kb, int seed, int bh_offset,
        unsigned thr, float inv_keep, int dropout, int dtype, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not an older one
  if (BH <= 0 || H <= 0 || BH % H || S <= 0 || Sk <= 0 || BH > 65535)
    return cudaErrorInvalidValue;
  const Params p{BH, H, S, Sk, scale, causal, static_cast<const float*>(kb),
                 uint32_t(seed) * 0x9E3779B1u, bh_offset, thr, inv_keep,
                 dropout};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_d<float>(which, D, a, p, st);
    case 1: return launch_d<__nv_bfloat16>(which, D, a, p, st);
    case 2: return launch_d<__half>(which, D, a, p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// All tensors contiguous, on one device, 16-byte aligned: q [BH, S, D],
// k/v [BH, Sk, D], one dtype (0 = float32, 1 = bfloat16, 2 = float16);
// lse, delta [BH, S] fp32; kb null or [BH / H, Sk] fp32 (clamped to
// >= -1e30).  seed, bh_offset: the dropout hash's int32 seed and batch-head
// offset; thr and inv_keep: keep_threshold(rate) and fp32(1 / (1 - rate));
// dropout = 0 turns the mask off.  Each returns the cudaError_t of the
// launch (0 on success); the caller raises on anything else.

int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* kb, void* o, void* lse, int BH, int H,
                        int S, int Sk, int D, float scale, int causal, int seed,
                        int bh_offset, unsigned thr, float inv_keep, int dropout,
                        int dtype, void* stream) {
  Ptrs a{q, k, v, nullptr, nullptr, nullptr, o, lse, nullptr, nullptr, nullptr};
  return run(0, a, BH, H, S, Sk, D, scale, causal, kb, seed, bh_offset, thr,
             inv_keep, dropout, dtype, stream);
}

int flash_attention_dq(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* kb, void* dq, int BH, int H, int S, int Sk,
                       int D, float scale, int causal, int seed, int bh_offset,
                       unsigned thr, float inv_keep, int dropout, int dtype,
                       void* stream) {
  Ptrs a{q, k, v, dout, lse, delta, nullptr, nullptr, dq, nullptr, nullptr};
  return run(1, a, BH, H, S, Sk, D, scale, causal, kb, seed, bh_offset, thr,
             inv_keep, dropout, dtype, stream);
}

int flash_attention_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        const void* kb, void* dk, void* dv, int BH, int H,
                        int S, int Sk, int D, float scale, int causal, int seed,
                        int bh_offset, unsigned thr, float inv_keep, int dropout,
                        int dtype, void* stream) {
  Ptrs a{q, k, v, dout, lse, delta, nullptr, nullptr, nullptr, dk, dv};
  return run(2, a, BH, H, S, Sk, D, scale, causal, kb, seed, bh_offset, thr,
             inv_keep, dropout, dtype, stream);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

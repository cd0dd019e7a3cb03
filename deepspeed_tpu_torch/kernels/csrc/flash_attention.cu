// Flash attention forward, dQ and dK/dV, written for Hopper (sm_90a).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/transformer/flash_attention.py:
//   flash_attention_fwd  <- `_fwd_kernel` (:113, pallas_call :200)
//   flash_attention_dq   <- `_dq_kernel`  (:227, pallas_call :368)
//   flash_attention_dkv  <- `_dkv_kernel` (:280, pallas_call :395)
// and computes what their plain PyTorch versions compute
// (deepspeed_tpu_torch/ops/transformer/flash_attention.py `_fwd_plain`,
// `_dq_plain`, `_dkv_plain`), on [BH, S, D] tensors in fp32, bf16 or fp16,
// D = 64, 128 or 256:
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
// cores' 989 TFLOP/s.  At D = 64 the softmax's exponentials are as many
// MUFU.EX2 cycles as the tile's products take on the tensor cores, so each
// kernel has to overlap the two and keep the loads out of the way.  The
// routes, chosen from the dtype and D alone (`dq_route_of`, `dkv_route_of`;
// exported as flash_attention_dq_route / _dkv_route):
//   * forward, bf16 / fp16: the wgmma kernel (flash_fwd_wgmma_kernel) —
//     TMA loads into a ring of swizzled shared-memory stages by a producer
//     warpgroup, S = Q.K^T and O += P.V by wgmma.mma_async with P fed from
//     registers and V read in place (MN-major), the online softmax in
//     registers with the masks only on the tiles that need them, a
//     persistent grid of several CTAs an SM (their products and softmaxes
//     interleave).  What holds it back (PERF.md): a consumer still waits
//     for each product before the softmax that reads it.
//   * dQ, bf16 / fp16 at D 64 and 128: flash_dq_wgmma_kernel, the same
//     producer / consumer shape over (q tile, bh) items, largest q0 first;
//     S and dP by wgmma, ds rounded to K's dtype into A fragments, dQ +=
//     ds.K with K read MN-major from the same stage.  At D 256:
//     flash_dq_mma_kernel, mma.sync m16n8k16 tiles staged by plain loads.
//   * dK/dV, bf16 at D 64 and 128: flash_dkv_wgmma_kernel over (key tile,
//     bh) items, key tile 0 of every bh first (the longest causal walk);
//     S^T and dP^T by wgmma with keys as rows, pd and ds kept in fp32 and
//     fed to dV += pd^T.dO and dK += ds^T.Q as three bf16 terms each, dO
//     and Q read MN-major from the stage.  fp16 (whose residual terms would
//     fall into subnormals) and D 256 take the CUDA-core dK/dV.
//   * fp32, and the dK/dV cases above: fp32 FMAs on the CUDA cores (67
//     TFLOP/s peak).  Tiles are staged in shared memory as fp32 rows padded
//     by one word; a thread owns RM rows (strided by 16) and every 8th
//     column, so the 8 lanes that share rows reduce max and sum with three
//     shuffles and the shared-memory reads are conflict free.
// All keep scores, probabilities and accumulators in fp32 and make only the
// roundings that define the function (p to V's dtype before P.V, ds to K's
// dtype before dS.K).  The wgmma kernels are persistent and sum every
// output element in one warp in a fixed order: no atomics, bitwise
// repeatable.
//
// Exactness notes (the TPU kernels' guards, kept): masks are selects to the
// finite NEG_INF = -1e30 (the bias is clamped to >= NEG_INF by the caller);
// with a bias, p is zeroed where s <= NEG_INF/2 (a fully masked row keeps
// m at ~NEG_INF, where exp(s - m) would be 1); a fully masked row gives a
// zero output; keys or rows past the sequence end contribute exactly 0.

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

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
// forward for bf16 / fp16: TMA ring, warp-specialised, wgmma
// ---------------------------------------------------------------------------
//
// A persistent grid of CTAs (as many as fit: MB an SM) walks the work items
// (64-row q tile, bh), heaviest causal tiles first, CTA c taking items c,
// c + gridDim.x, ...  A CTA is two warpgroups.  Warpgroup 1 is the
// producer: it gives up its registers (setmaxnreg.dec), and one thread
// loads each item's Q tile into one of two buffers and every K and V tile
// of its key range by TMA (128-byte swizzled) into a ring of STAGES
// stages, each arrival reported to a `full` mbarrier, each release awaited
// on an `empty` one; the ring runs on across items, so the next item's Q
// and first tiles load while this one finishes.  Warpgroup 0 is the
// consumer, with the producer's registers (setmaxnreg.inc).  Per key tile
// of BK keys it computes S = Q.K^T by wgmma with both operands in shared
// memory (fp32 accumulators in registers), runs the online softmax on them
// in registers, rounds p * keep to V's dtype into wgmma A fragments and
// adds P.V by wgmma reading V in place as an MN-major operand (no
// transposed copy); then it hands the stage back.  An SM's tensor cores are
// kept busy by its MB CTAs, whose products and softmaxes interleave.  The
// causal select and the end-of-keys mask run only on tiles that cross the
// diagonal or Sk; keys past Sk come in as TMA's zero fill and get p = 0
// exactly.  Rows past S load as zeros and are not stored.  Each of the
// function's steps is the CUDA-core kernel's (above): s = scale * (q.k)
// (= (q*scale).k at the power-of-two scales of D 64 and 256, within one
// rounding at D 128), exp(s - m) as 2^((s - m) log2 e) (without a bias,
// the scale folded into one FMA: 2^(q.k scale log2 e - m scale log2 e)),
// the same masks, guards, roundings and hash.

template <typename T, int D, int BK, int STAGES, int MB>
struct WgFwd {
  static constexpr int THREADS = 256;               // consumer + producer
  static constexpr int BQ = 64, NDC = D / 64;       // 64-column chunks
  static constexpr int Q_CHUNK = BQ * 128;          // bytes of one chunk
  static constexpr int KV_CHUNK = BK * 128;
  static constexpr int Q_BYTES = NDC * Q_CHUNK;
  static constexpr int KV_BYTES = NDC * KV_CHUNK;   // one K (or V) tile
  // two Q buffers (the next item's loads while this one runs), the K/V
  // ring, the barriers
  static constexpr size_t SMEM =
      1024 + 2 * Q_BYTES + 2 * size_t(STAGES) * KV_BYTES + 8 * (2 * STAGES + 4);
  // with MB > 1 CTAs an SM the producer hands its registers to the
  // consumer (setmaxnreg): 24 left, the consumer twice the launch count
  // less 24; with one CTA (D = 256, whose m64n256 accumulators need more
  // registers at launch than two CTAs leave) every thread keeps 255
  static constexpr bool REBALANCE = MB > 1;
  static constexpr int LAUNCH_REGS = (65536 / (THREADS * MB)) & ~7;
  static constexpr int CONSUMER_REGS = 2 * LAUNCH_REGS - 24;
};

template <typename T, int D, int BK, int STAGES, int MB>
__global__ void __launch_bounds__(256, MB)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       T* __restrict__ o, float* __restrict__ lse, Params p) {
  using LY = WgFwd<T, D, BK, STAGES, MB>;
  constexpr int NT = BK / 8, DN = D / 8;
  extern __shared__ unsigned char smraw[];
  // 1024-byte alignment for the swizzle atoms
  unsigned char* sQ = smraw + ((1024 - (smem_u32(smraw) & 1023)) & 1023);
  unsigned char* sK = sQ + 2 * LY::Q_BYTES;          // [STAGES][NDC][BK][128 B]
  unsigned char* sV = sK + STAGES * LY::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + STAGES * LY::KV_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;                   // [2]: Q buffer loaded
  uint64_t* qempty = qbar + 2;                       // [2]: Q buffer free

  // work items (q tile, bh), heaviest causal q tiles first; CTA c takes
  // items c, c + gridDim.x, ...
  const int nq = (p.S + LY::BQ - 1) / LY::BQ;
  const int n_items = nq * p.BH;
  auto item = [&](int w, int& q0, int& bh) {
    q0 = (nq - 1 - w / p.BH) * LY::BQ;
    bh = w % p.BH;
    const int k_end = p.causal ? min(p.Sk, q0 + LY::BQ) : p.Sk;
    return (k_end + BK - 1) / BK;                  // its key tiles
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);   // one arrival per consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&qbar[b], 1);
      mbar_init(&qempty[b], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: the ring's tile count runs on across items, so the next
    // item's Q and first K/V tiles load while this one finishes
    if constexpr (LY::REBALANCE) setmaxnreg_dec<24>();
    if (threadIdx.x == 128) {
      int it = 0;
      for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
        int q0, bh;
        const int n_tiles = item(w, q0, bh);
        const int b = n & 1;
        mbar_wait(&qempty[b], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&qbar[b], LY::Q_BYTES);
        for (int c = 0; c < LY::NDC; ++c)
          tma_load_3d(sQ + b * LY::Q_BYTES + c * LY::Q_CHUNK, &tq, &qbar[b],
                      64 * c, q0, bh);
        for (int i = 0; i < n_tiles; ++i, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * LY::KV_BYTES);
          unsigned char* dk = sK + s * LY::KV_BYTES;
          unsigned char* dv = sV + s * LY::KV_BYTES;
          for (int c = 0; c < LY::NDC; ++c) {
            tma_load_3d(dk + c * LY::KV_CHUNK, &tk, &full[s], 64 * c, i * BK, bh);
            tma_load_3d(dv + c * LY::KV_CHUNK, &tv, &full[s], 64 * c, i * BK, bh);
          }
        }
      }
    }
    return;
  }

  // consumer
  if constexpr (LY::REBALANCE) setmaxnreg_inc<LY::CONSUMER_REGS>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int q0, bh, ra, rb;
  const float* kb;
  uint32_t bhm;
  float acc[D / 2];
  float m_a, m_b, l_a, l_b;
  // without a bias the scores stay unscaled: the max is taken over q.k
  // (scale > 0, so it commutes with the scaling) and kept unscaled, and
  // p = 2^(q.k scale log2e - m scale log2e) is one FMA and one EX2
  const float sl2 = p.kb ? LOG2E : p.scale * LOG2E;

  // the online softmax of one tile, its scores `sc` in place -> p * keep;
  // EDGE: the tile crosses the causal diagonal or Sk; BIAS: a key bias
  auto softmax = [&](float* sc, int k0, auto edge_c, auto bias_c) {
    constexpr bool EDGE = decltype(edge_c)::value;
    constexpr bool BIAS = decltype(bias_c)::value;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kg = k0 + 8 * j + 2 * t + (r & 1);
        float x = sc[4 * j + r];
        if constexpr (BIAS) {
          // s = (q.k) scale, the causal select, + bias: the function's own
          // order; a key past Sk is -inf (p = 0)
          x *= p.scale;
          if (EDGE && kg >= p.Sk) {
            x = -INFINITY;
          } else {
            if (EDGE && p.causal && (r < 2 ? ra : rb) < kg) x = NEG_INF;
            x += kb[kg];
          }
        } else if constexpr (EDGE) {
          // a masked key has p = 0 exactly; without a bias no row has all
          // its keys masked (key 0 is in the first tile)
          if (kg >= p.Sk || (p.causal && (r < 2 ? ra : rb) < kg)) x = -INFINITY;
        }
        sc[4 * j + r] = x;
        if (r < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
      }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float ma2 = mn_a * sl2, mb2 = mn_b * sl2;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kg = k0 + 8 * j + 2 * t + (r & 1);
        const float x = sc[4 * j + r];
        float pv;
        if constexpr (BIAS) {
          // exp(s - m), with p = 0 where s <= NEG_INF / 2
          pv = ex2((x - (r < 2 ? mn_a : mn_b)) * LOG2E);
          if (x <= NEG_INF * 0.5f) pv = 0.f;
        } else {
          pv = ex2(fmaf(x, sl2, -(r < 2 ? ma2 : mb2)));
        }
        if (r < 2) ps_a += pv; else ps_b += pv;
        if (p.dropout) pv *= keep_scale(p, bhm, r < 2 ? ra : rb, kg);
        sc[4 * j + r] = pv;
      }
    const float al_a = ex2((m_a - mn_a) * sl2);
    const float al_b = ex2((m_b - mn_b) * sl2);
    l_a = al_a * l_a + quad_sum(ps_a);
    l_b = al_b * l_b + quad_sum(ps_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      acc[4 * j] *= al_a;
      acc[4 * j + 1] *= al_a;
      acc[4 * j + 2] *= al_b;
      acc[4 * j + 3] *= al_b;
    }
  };

  int it = 0;
  for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
    const int n_tiles = item(w, q0, bh);
    ra = q0 + warp * 16 + g;
    rb = ra + 8;
    kb = p.kb ? p.kb + size_t(bh / p.H) * p.Sk : nullptr;
    bhm = uint32_t(bh + p.bh_offset) * 0x7FEB352Du;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    m_a = m_b = NEG_INF;
    l_a = l_b = 0.f;

    const int b = n & 1;
    const unsigned char* qt = sQ + b * LY::Q_BYTES;
    mbar_wait(&qbar[b], (n >> 1) & 1);
    for (int i = 0; i < n_tiles; ++i, ++it) {
      const int s = it % STAGES, k0 = i * BK;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* kt = sK + s * LY::KV_BYTES;
      const unsigned char* vt = sV + s * LY::KV_BYTES;
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk & 3) * 32;
        Wgmma<T, BK>::ss(
            sc, sw128_desc(qt + (kk >> 2) * LY::Q_CHUNK + off, 16, 1024),
            sw128_desc(kt + (kk >> 2) * LY::KV_CHUNK + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BK / 2>(sc);

      const bool edge = (p.causal && k0 + BK - 1 > q0) || k0 + BK > p.Sk;
      if (kb) {
        if (edge) softmax(sc, k0, std::true_type{}, std::true_type{});
        else softmax(sc, k0, std::false_type{}, std::true_type{});
      } else {
        if (edge) softmax(sc, k0, std::true_type{}, std::false_type{});
        else softmax(sc, k0, std::false_type{}, std::false_type{});
      }
      // p * keep rounded to V's dtype, as wgmma A fragments (16 keys each)
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = Mma<T>::pack(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = Mma<T>::pack(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = Mma<T>::pack(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = Mma<T>::pack(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      fence_regs<D / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<T, D>::rs(acc, pa[kk],
                        sw128_desc(vt + kk * 16 * 128, LY::KV_CHUNK, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(acc);
      // the stage's K and V have been read: hand it back to the producer
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&empty[s]);
        // and its Q buffer after the item's last tile
        if (i + 1 == n_tiles) mbar_arrive(&qempty[b]);
      }
    }

    // the row max in the scores' own units (unscaled without a bias)
    const float mscale = kb ? 1.f : p.scale;
    const float sa = l_a == 0.f ? 1.f : l_a, sb = l_b == 0.f ? 1.f : l_b;
    T* oh = o + size_t(bh) * p.S * D;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int col = 8 * j + 2 * t;
      if (ra < p.S)
        *reinterpret_cast<uint32_t*>(oh + size_t(ra) * D + col) =
            Mma<T>::pack(acc[4 * j] / sa, acc[4 * j + 1] / sa);
      if (rb < p.S)
        *reinterpret_cast<uint32_t*>(oh + size_t(rb) * D + col) =
            Mma<T>::pack(acc[4 * j + 2] / sb, acc[4 * j + 3] / sb);
    }
    if (t == 0) {
      if (ra < p.S) lse[size_t(bh) * p.S + ra] = m_a * mscale + logf(sa);
      if (rb < p.S) lse[size_t(bh) * p.S + rb] = m_b * mscale + logf(sb);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ for bf16 / fp16 at D = 256: mma.sync m16n8k16
// ---------------------------------------------------------------------------
//
// One block of 4 warps per (64-row q tile, bh); each warp owns 16 q rows.
// Its Q and dO operand fragments would take 128 registers at D 256, so the
// two 64-row tiles are staged in shared memory once and each product reads
// its A fragments there.  A k tile of BK keys is staged in shared
// memory as rows padded by 8 elements (conflict-free 32-bit fragment
// reads), K and V row-major for S = Q.K^T and dP = dO.V^T and K transposed
// for dQ += dS.K.  ds is rounded to K's dtype once, as the function does,
// and fed back as the A operand of the second product straight from
// registers.  Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4g + t; A
// regs {row g | g+8} x {cols 2t, 2t+1 | +8}; B regs {k 2t, 2t+1 | +8} x
// {col g}; C {row g | g+8} x {cols 2t, 2t+1}.

template <typename T, int D, int BK>
struct MmaLayout {
  static constexpr int BQ = 64, LDK = D + 8, LDT = BK + 8;
  static constexpr size_t DQ_SMEM =
      (2 * size_t(BK) * LDK + size_t(D) * LDT + 2 * size_t(BQ) * LDK) * sizeof(T);
};

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
  T* sQ = sKt + D * LDT;                 // [BQ][LDK]
  T* sO = sQ + BQ * LDK;                 // dO [BQ][LDK]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (p.S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - int(blockIdx.x)) * BQ;
  const int bh = blockIdx.y;
  const T* kh = k + size_t(bh) * p.Sk * D;
  const T* vh = v + size_t(bh) * p.Sk * D;
  if (p.kb) p.kb += size_t(bh / p.H) * p.Sk;
  const uint32_t bhm = uint32_t(bh + p.bh_offset) * 0x7FEB352Du;
  const int ra = q0 + warp * 16 + g, rb = ra + 8;

  // read after the loop's first barrier
  stage_rows<T, D, LDK>(sQ, q + size_t(bh) * p.S * D, q0, p.S, BQ);
  stage_rows<T, D, LDK>(sO, dout + size_t(bh) * p.S * D, q0, p.S, BQ);
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
    mma_tiles_sa<T, KD, NT, LDK, LDK>(s, sQ + warp * 16 * LDK, sK, g, t);
    mma_tiles_sa<T, KD, NT, LDK, LDK>(dp, sO + warp * 16 * LDK, sV, g, t);
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

// ---------------------------------------------------------------------------
// dQ for bf16 / fp16 at D = 64 or 128: TMA, wgmma, warp-specialised
// ---------------------------------------------------------------------------
//
// The block-sparse dQ's shape (flash_sparse.cu `sparse_dq_wgmma_kernel`) on
// the dense causal walk.  The work items are (64-row q tile, bh), the
// largest q0 first under causal masking (its walk is the longest), taken by
// a persistent grid of CTAs (two an SM) as c, c + gridDim.x, ...  A CTA is
// two warpgroups.  Warpgroup 1 is the producer (24 registers after
// setmaxnreg.dec): one thread TMA-loads each item's Q and dO tiles (64 x D,
// 128-byte swizzled, in 64-column chunks) and its rows' lse and delta (64
// floats each, through 1-d maps over the flat [BH S] buffers: any S and q0,
// no alignment asked of bh S + q0) into one of QB buffers, then a ring of
// STAGES (K, V) stages over the key tiles 0 ... min(Sk, q0 + 64) (all of
// Sk without the causal mask); the ring runs on across items.  Warpgroup 0
// is the consumer (setmaxnreg.inc); warp w owns q rows [16 w, 16 w + 16) of
// the item.  Per key tile it computes S = Q.K^T and dP = dO.V^T by wgmma
// m64n64k16 with both operands in shared memory, then in fp32 registers
// the function's
//   x = scale (q.k), the causal select to NEG_INF, + the key bias;
//   p = exp(x - lse) as one EX2 of (x - lse) log2 e, the difference first
//       (zeroed where x <= NEG_INF / 2 under a bias);
//   ds = p (dp keep - delta)
// (the causal select and the end-of-keys mask only on the tiles that cross
// the diagonal or Sk; the hash of `keep_scale` at the global (q, k) with
// bh + bh_offset, its row terms' first step taken once an item and its
// column terms' once a tile), rounds ds once to K's dtype straight into
// wgmma A fragments (the function's ds.astype(k.dtype)), and adds
// dQ += ds.K by wgmma m64nDk16 with B the SAME swizzled K tile read MN-major:
// no transposed copy.  TMA zero-fills rows past S and keys past Sk; a key
// past Sk gets p = 0 (x = -inf), a row past S is computed on zeros and not
// stored.  Every output element is summed by one warp in key order: no
// atomics, bitwise repeatable.  Shared memory: D 64 two Q buffers and three
// (K, V) stages, 83 KB; D 128 one Q buffer and two stages, 98 KB.

template <int D>
struct WgDq {
  static constexpr int THREADS = 256, MB = 2;
  static constexpr int NDC = D / 64;                // 64-column chunks
  static constexpr int CHUNK = 64 * 128;            // 64 rows of one chunk
  static constexpr int TILE = NDC * CHUNK;          // 64 rows of all D
  static constexpr int QB = D == 64 ? 2 : 1;        // Q / dO buffers
  static constexpr int STAGES = D == 64 ? 3 : 2;    // (K, V) stages
  // a Q buffer: Q, dO, then lse[64] and delta[64] (padded so that buffers
  // stay 1024-aligned)
  static constexpr int QBUF = 2 * TILE + 1024;
  static constexpr int STAGE = 2 * TILE;
  static constexpr size_t SMEM = 1024 + QB * size_t(QBUF) +
                                 STAGES * size_t(STAGE) +
                                 8 * (2 * STAGES + 2 * QB);
  static constexpr int LAUNCH_REGS = (65536 / (THREADS * MB)) & ~7;
  static constexpr int CONSUMER_REGS = 2 * LAUNCH_REGS - 24;
};

template <typename T, int D>
__global__ void __launch_bounds__(256, WgDq<D>::MB)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tl,
                      const __grid_constant__ CUtensorMap td,
                      T* __restrict__ dq, Params p) {
  using LY = WgDq<D>;
  constexpr int TILE = LY::TILE, CHUNK = LY::CHUNK, NDC = LY::NDC;
  constexpr int QB = LY::QB, STAGES = LY::STAGES;
  extern __shared__ unsigned char smraw[];
  // 1024-byte alignment for the swizzle atoms
  unsigned char* sQ = smraw + ((1024 - (smem_u32(smraw) & 1023)) & 1023);
  unsigned char* sKV = sQ + QB * LY::QBUF;          // [STAGES][STAGE]: K, V
  uint64_t* full = reinterpret_cast<uint64_t*>(sKV + STAGES * LY::STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;                 // [QB]: Q buffer loaded
  uint64_t* qempty = qfull + QB;                    // [QB]: Q buffer free

  const int nq = (p.S + 63) / 64;
  const int n_items = nq * p.BH;
  // item w -> (q0, bh), the largest q0 first; returns its key tiles
  auto item = [&](int w, int& q0, int& bh) {
    q0 = (nq - 1 - w / p.BH) * 64;
    bh = w % p.BH;
    const int k_end = p.causal ? min(p.Sk, q0 + 64) : p.Sk;
    return (k_end + 63) / 64;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);   // one arrival per consumer warp
    }
    for (int b = 0; b < QB; ++b) {
      mbar_init(&qfull[b], 1);
      mbar_init(&qempty[b], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 128) {
      int it = 0;
      for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
        int q0, bh;
        const int n_tiles = item(w, q0, bh);
        const int b = n % QB;
        mbar_wait(&qempty[b], ((n / QB) & 1) ^ 1);
        mbar_expect_tx(&qfull[b], 2 * TILE + 512);
        unsigned char* qb = sQ + b * LY::QBUF;
        for (int c = 0; c < NDC; ++c) {
          tma_load_3d(qb + c * CHUNK, &tq, &qfull[b], 64 * c, q0, bh);
          tma_load_3d(qb + TILE + c * CHUNK, &tdo, &qfull[b], 64 * c, q0, bh);
        }
        tma_load_1d(qb + 2 * TILE, &tl, &qfull[b], bh * p.S + q0);
        tma_load_1d(qb + 2 * TILE + 256, &td, &qfull[b], bh * p.S + q0);
        for (int i = 0; i < n_tiles; ++i, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * TILE);
          unsigned char* st = sKV + s * LY::STAGE;
          for (int c = 0; c < NDC; ++c) {
            tma_load_3d(st + c * CHUNK, &tk, &full[s], 64 * c, 64 * i, bh);
            tma_load_3d(st + TILE + c * CHUNK, &tv, &full[s], 64 * c, 64 * i, bh);
          }
        }
      }
    }
    return;
  }

  // consumer
  setmaxnreg_inc<LY::CONSUMER_REGS>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int ra, rb;
  uint32_t ha, hb;
  float lse_a, lse_b, dl_a, dl_b;
  const float* kb;
  float acc[D / 2];

  // ds of one tile in place of its scores (register 4j + r: q row
  // r < 2 ? ra : rb, key k0 + 8j + 2t + (r & 1)); EDGE: the tile crosses
  // the causal diagonal or Sk; BIAS: a key bias; DROP: dropout
  auto ds_tile = [&](float* sc, const float* dp, int k0, auto edge_c,
                     auto bias_c, auto drop_c) {
    constexpr bool EDGE = decltype(edge_c)::value;
    constexpr bool BIAS = decltype(bias_c)::value;
    constexpr bool DROP = decltype(drop_c)::value;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kg = k0 + 8 * j + 2 * t + e;
        const bool live = !EDGE || kg < p.Sk;
        float bias = 0.f;
        if constexpr (BIAS) bias = live ? kb[kg] : 0.f;
        uint32_t hc = 0;
        if constexpr (DROP) {
          hc = uint32_t(kg) * 0xC2B2AE35u;
          hc ^= hc >> 15;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          // s = (q*scale).k: scale * (q.k) is the same number at the
          // power-of-two scale of D 64, within one rounding at D 128
          float x = p.scale * sc[i];
          if constexpr (EDGE) {
            if (p.causal && (h ? rb : ra) < kg) x = NEG_INF;
            if (!live) x = -INFINITY;
          }
          if constexpr (BIAS) x += bias;
          float pv = ex2((x - (h ? lse_b : lse_a)) * LOG2E);
          if constexpr (BIAS) {
            if (x <= NEG_INF * 0.5f) pv = 0.f;
          }
          float dpv = dp[i];
          if constexpr (DROP)
            dpv *= fmix32_tail((h ? hb : ha) ^ hc) < p.thr ? p.inv_keep : 0.f;
          sc[i] = pv * (dpv - (h ? dl_b : dl_a));
        }
      }
  };

  int it = 0;
  for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
    int q0, bh;
    const int n_tiles = item(w, q0, bh);
    const int b = n % QB;
    ra = q0 + warp * 16 + g;
    rb = ra + 8;
    kb = p.kb ? p.kb + size_t(bh / p.H) * p.Sk : nullptr;
    // keep_scale's row terms (flash_tiles.cuh), after fmix32's first step
    const uint32_t sb = p.seed_h ^ (uint32_t(bh + p.bh_offset) * 0x7FEB352Du);
    ha = sb ^ (uint32_t(ra) * 0x85EBCA6Bu);
    hb = sb ^ (uint32_t(rb) * 0x85EBCA6Bu);
    ha ^= ha >> 15;
    hb ^= hb >> 15;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const unsigned char* qt = sQ + b * LY::QBUF;
    const unsigned char* ot = qt + TILE;
    mbar_wait(&qfull[b], (n / QB) & 1);
    const float* sL = reinterpret_cast<const float*>(qt + 2 * TILE);
    lse_a = sL[warp * 16 + g];
    lse_b = sL[warp * 16 + g + 8];
    dl_a = sL[64 + warp * 16 + g];
    dl_b = sL[64 + warp * 16 + g + 8];

    for (int i = 0; i < n_tiles; ++i, ++it) {
      const int s = it % STAGES, k0 = 64 * i;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* kt = sKV + s * LY::STAGE;
      const unsigned char* vt = kt + TILE;

      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk >> 2) * CHUNK + (kk & 3) * 32;
        Wgmma<T, 64>::ss(sc, sw128_desc(qt + off, 16, 1024),
                         sw128_desc(kt + off, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk >> 2) * CHUNK + (kk & 3) * 32;
        Wgmma<T, 64>::ss(dp, sw128_desc(ot + off, 16, 1024),
                         sw128_desc(vt + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(sc);
      fence_regs<32>(dp);

      const bool edge = (p.causal && k0 + 63 > q0) || k0 + 64 > p.Sk;
      with_flags(edge, kb != nullptr, p.dropout != 0,
                 [&](auto e, auto b, auto d) { ds_tile(sc, dp, k0, e, b, d); });
      // ds rounded to K's dtype, as wgmma A fragments (16 keys each)
      uint32_t da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        da[kk][0] = Mma<T>::pack(sc[8 * kk], sc[8 * kk + 1]);
        da[kk][1] = Mma<T>::pack(sc[8 * kk + 2], sc[8 * kk + 3]);
        da[kk][2] = Mma<T>::pack(sc[8 * kk + 4], sc[8 * kk + 5]);
        da[kk][3] = Mma<T>::pack(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      // dQ += ds.K, B the stage's K tile read MN-major (16 keys a slice)
      fence_regs<D / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<T, D>::rs(acc, da[kk], sw128_desc(kt + kk * 16 * 128, CHUNK, 1024),
                        1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(acc);
      // the stage's K and V have been read: hand it back
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // the item's Q, dO, lse and delta have been read
    __syncwarp();
    if (lane == 0) mbar_arrive(&qempty[b]);

    T* dqh = dq + size_t(bh) * p.S * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int cc = 8 * j + 2 * t;
      if (ra < p.S)
        *reinterpret_cast<uint32_t*>(dqh + size_t(ra) * D + cc) =
            Mma<T>::pack(p.scale * acc[4 * j], p.scale * acc[4 * j + 1]);
      if (rb < p.S)
        *reinterpret_cast<uint32_t*>(dqh + size_t(rb) * D + cc) =
            Mma<T>::pack(p.scale * acc[4 * j + 2], p.scale * acc[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// dK, dV for bf16 at D = 64 or 128: TMA, wgmma, warp-specialised
// ---------------------------------------------------------------------------
//
// The block-sparse dK/dV's shape (flash_sparse.cu `sparse_dkv_wgmma_kernel`)
// on the dense causal walk.  The work items are (BKV = 64 NC keys, bh),
// heaviest causal walk first: item w takes key tile w / BH of bh w % BH, so
// key tile 0 of every bh (which every q tile sees) comes before key tile 1,
// and so on; a persistent grid of CTAs takes items c, c + gridDim.x, ...  A
// CTA is NC consumer warpgroups and one producer warpgroup.  The producer
// (24 registers after setmaxnreg.dec) has one thread TMA-load each item's K
// and V tiles (BKV x D, 128-byte swizzled, 64-column chunks) into one of two
// buffers, then a ring of STAGES stages over the q tiles from the one that
// holds the item's first key (the diagonal tile) to the end of S, or over
// all of S without the causal mask: Q and dO by TMA and that tile's lse and
// delta (64 floats each through 1-d maps over the flat [BH S] buffers, so
// any S and q0 work).  The ring runs on across items.  Consumer warpgroup c
// owns keys [64 c, 64 c + 64) of the item, its warp w the 16 keys from
// 64 c + 16 w; all NC consumers read every stage.  Per q tile it computes
// S^T = K.Q^T and dP^T = V.dO^T by wgmma m64n64k16 with both operands in
// shared memory (keys as rows, so p's and ds's transposes come out as
// accumulators with no shuffle), then in fp32 registers the function's
//   x = scale (q.k), the causal select to NEG_INF, + the key bias;
//   p = exp(x - lse) as one EX2 of (x - lse) log2 e (zeroed where
//       x <= NEG_INF / 2 under a bias);
//   pd = p keep, ds = p (dp keep - delta)
// (the causal select and the mask of rows past S only on the tiles that
// cross the diagonal or S; the hash at the global (q, k) with bh +
// bh_offset, the key terms' first step taken once an item and the q terms'
// once a tile), and then dV += pd^T.dO and dK += ds^T.Q by wgmma with A
// from registers and B the SAME swizzled dO and Q tiles read MN-major: no
// transposed copy.  pd and ds stay fp32, as the function keeps them: each
// goes to the tensor cores as three bf16 terms (`bf16_term`, hopper.cuh),
// so a q tile issues 2 + 2 x 3 products where a plain bf16 backward issues
// 4.  At D 64 the terms are issued as each is packed (two A buffers, the
// third term reusing the first's once its products retire); at D 128 the
// dK and dV accumulators take 128 registers, so one A buffer serves the
// three terms in turn.  TMA zero-fills keys past Sk (their rows are not
// stored) and rows past S (masked to p = 0).  Every output element is summed
// by one warp in q order: no atomics, bitwise repeatable.  A key that no
// row sees (causal, a key tile at or past S) writes zeros.  NC = 1 runs two
// CTAs an SM; NC = 2 one CTA of two consumers sharing each (Q, dO) stage
// (`MmaTiles`).

template <int D, int NC>
struct WgDkv {
  static constexpr int THREADS = 128 * (NC + 1), MB = NC == 1 ? 2 : 1;
  static constexpr int BKV = 64 * NC;               // keys an item
  static constexpr int NDC = D / 64;                // 64-column chunks
  static constexpr int QCHUNK = 64 * 128;           // 64 q rows of one chunk
  static constexpr int QTILE = NDC * QCHUNK;
  static constexpr int KCHUNK = BKV * 128;          // BKV keys of one chunk
  static constexpr int KTILE = NDC * KCHUNK;
  static constexpr int STAGES = D == 128 ? 2 : NC == 1 ? 3 : 4;
  // a stage: Q, dO, then lse[64] and delta[64] (padded so that stages stay
  // 1024-aligned)
  static constexpr int STAGE = 2 * QTILE + 1024;
  // two K and two V buffers (the next item's loads while this one runs),
  // the ring, the barriers
  static constexpr size_t SMEM = 1024 + 4 * size_t(KTILE) +
                                 STAGES * size_t(STAGE) + 8 * (2 * STAGES + 4);
  static constexpr int LAUNCH_REGS = (65536 / (THREADS * MB)) & ~7;
  static constexpr int CONSUMER_REGS =
      (((NC + 1) * LAUNCH_REGS - 24) / NC) & ~7;
};

template <int D, int NC>
__global__ void __launch_bounds__(WgDkv<D, NC>::THREADS, WgDkv<D, NC>::MB)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tl,
                       const __grid_constant__ CUtensorMap td,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, Params p) {
  using LY = WgDkv<D, NC>;
  using T = __nv_bfloat16;
  constexpr int QTILE = LY::QTILE, QCHUNK = LY::QCHUNK, NDC = LY::NDC;
  constexpr int KTILE = LY::KTILE, KCHUNK = LY::KCHUNK, STAGES = LY::STAGES;
  extern __shared__ unsigned char smraw[];
  // 1024-byte alignment for the swizzle atoms
  unsigned char* sK = smraw + ((1024 - (smem_u32(smraw) & 1023)) & 1023);
  unsigned char* sV = sK + 2 * KTILE;               // [2][KTILE] each
  unsigned char* sR = sV + 2 * KTILE;               // [STAGES][STAGE]
  uint64_t* full = reinterpret_cast<uint64_t*>(sR + STAGES * LY::STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* kvfull = empty + STAGES;                // [2]: K, V loaded
  uint64_t* kvempty = kvfull + 2;                   // [2]: K, V free

  const int nq = (p.S + 63) / 64;
  const int n_items = (p.Sk + LY::BKV - 1) / LY::BKV * p.BH;
  // item w -> (k0, bh), key tile 0 of every bh first; returns its first q
  // tile (causal: the one that holds key k0; rows before it see none)
  auto item = [&](int w, int& k0, int& bh) {
    k0 = w / p.BH * LY::BKV;
    bh = w % p.BH;
    return p.causal ? k0 / 64 : 0;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);   // one arrival per consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&kvfull[b], 1);
      mbar_init(&kvempty[b], 4 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NC) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * NC) {
      int it = 0;
      for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
        int k0, bh;
        const int q_first = item(w, k0, bh);
        const int b = n & 1;
        mbar_wait(&kvempty[b], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&kvfull[b], 2 * KTILE);
        for (int c = 0; c < NDC; ++c) {
          tma_load_3d(sK + b * KTILE + c * KCHUNK, &tk, &kvfull[b], 64 * c, k0, bh);
          tma_load_3d(sV + b * KTILE + c * KCHUNK, &tv, &kvfull[b], 64 * c, k0, bh);
        }
        for (int qi = q_first; qi < nq; ++qi, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * QTILE + 512);
          unsigned char* st = sR + s * LY::STAGE;
          for (int c = 0; c < NDC; ++c) {
            tma_load_3d(st + c * QCHUNK, &tq, &full[s], 64 * c, 64 * qi, bh);
            tma_load_3d(st + QTILE + c * QCHUNK, &tdo, &full[s], 64 * c, 64 * qi,
                        bh);
          }
          tma_load_1d(st + 2 * QTILE, &tl, &full[s], bh * p.S + 64 * qi);
          tma_load_1d(st + 2 * QTILE + 256, &td, &full[s], bh * p.S + 64 * qi);
        }
      }
    }
    return;
  }

  // consumers
  setmaxnreg_inc<LY::CONSUMER_REGS>();
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int kc, ka, kb_;
  uint32_t sb, ya, yb;
  float bias_a, bias_b;
  float dka[D / 2], dva[D / 2];

  // pd^T in place of the scores and ds^T in place of dp^T (register
  // 4j + r: key r < 2 ? ka : kb_, q row q0 + 8j + 2t + (r & 1)); EDGE: the
  // tile crosses the causal diagonal or S; BIAS: a key bias; DROP: dropout
  auto pd_ds_tile = [&](float* sc, float* dp, const float* sL, int q0,
                        auto edge_c, auto bias_c, auto drop_c) {
    constexpr bool EDGE = decltype(edge_c)::value;
    constexpr bool BIAS = decltype(bias_c)::value;
    constexpr bool DROP = decltype(drop_c)::value;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(sL + col);
      const float2 d2 = *reinterpret_cast<const float2*>(sL + 64 + col);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qg = q0 + col + e;
        uint32_t hq = 0;
        if constexpr (DROP) {
          hq = sb ^ (uint32_t(qg) * 0x85EBCA6Bu);
          hq ^= hq >> 15;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          // s = (q*scale).k: scale * (q.k) is the same number at the
          // power-of-two scale of D 64, within one rounding at D 128
          float x = p.scale * sc[i];
          if constexpr (EDGE) {
            if (p.causal && qg < (h ? kb_ : ka)) x = NEG_INF;
          }
          if constexpr (BIAS) x += h ? bias_b : bias_a;
          float pv = ex2((x - (e ? l2.y : l2.x)) * LOG2E);
          if constexpr (BIAS) {
            if (x <= NEG_INF * 0.5f) pv = 0.f;
          }
          if constexpr (EDGE) {
            if (qg >= p.S) pv = 0.f;   // a row past S (TMA's zeros)
          }
          float pd = pv, dpv = dp[i];
          if constexpr (DROP) {
            const float ks =
                fmix32_tail(hq ^ (h ? yb : ya)) < p.thr ? p.inv_keep : 0.f;
            pd *= ks;
            dpv *= ks;
          }
          sc[i] = pd;                                 // pd^T, fp32
          dp[i] = pv * (dpv - (e ? d2.y : d2.x));     // ds^T, fp32
        }
      }
    }
  };

  int it = 0;
  for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
    int k0, bh;
    const int q_first = item(w, k0, bh);
    const int b = n & 1;
    kc = k0 + 64 * wg;                              // this warpgroup's keys
    ka = kc + warp * 16 + g;
    kb_ = ka + 8;
    bias_a = bias_b = 0.f;
    if (p.kb) {
      const float* kbr = p.kb + size_t(bh / p.H) * p.Sk;
      bias_a = ka < p.Sk ? kbr[ka] : 0.f;           // keys past Sk: unstored
      bias_b = kb_ < p.Sk ? kbr[kb_] : 0.f;
    }
    // keep_scale's terms (flash_tiles.cuh): the key terms after fmix32's
    // first step, and the q terms' shared part
    sb = p.seed_h ^ (uint32_t(bh + p.bh_offset) * 0x7FEB352Du);
    ya = uint32_t(ka) * 0xC2B2AE35u;
    yb = uint32_t(kb_) * 0xC2B2AE35u;
    ya ^= ya >> 15;
    yb ^= yb >> 15;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    // this warpgroup's 64 rows of each 64-column chunk of K and V
    const unsigned char* kt = sK + b * KTILE + wg * 64 * 128;
    const unsigned char* vt = sV + b * KTILE + wg * 64 * 128;
    mbar_wait(&kvfull[b], (n >> 1) & 1);

    for (int qi = q_first; qi < nq; ++qi, ++it) {
      const int s = it % STAGES, q0 = 64 * qi;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* qt = sR + s * LY::STAGE;
      const unsigned char* ot = qt + QTILE;
      const float* sL = reinterpret_cast<const float*>(qt + 2 * QTILE);

      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, 64>::ss(sc,
                         sw128_desc(kt + (kk >> 2) * KCHUNK + (kk & 3) * 32, 16, 1024),
                         sw128_desc(qt + (kk >> 2) * QCHUNK + (kk & 3) * 32, 16, 1024),
                         kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, 64>::ss(dp,
                         sw128_desc(vt + (kk >> 2) * KCHUNK + (kk & 3) * 32, 16, 1024),
                         sw128_desc(ot + (kk >> 2) * QCHUNK + (kk & 3) * 32, 16, 1024),
                         kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(sc);
      fence_regs<32>(dp);

      const bool edge = (p.causal && q0 < kc + 64) || q0 + 64 > p.S;
      with_flags(edge, p.kb != nullptr, p.dropout != 0, [&](auto e, auto b, auto d) {
        pd_ds_tile(sc, dp, sL, q0, e, b, d);
      });

      // dV += pd^T.dO and dK += ds^T.Q, three bf16 terms each; B is the
      // stage's dO / Q tile read MN-major (16 q rows a slice)
      auto issue = [&](uint32_t (&pa)[4][4], uint32_t (&da)[4][4]) {
        fence_regs<D / 2>(dva);
        fence_regs<D / 2>(dka);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          Wgmma<T, D>::rs(dva, pa[kk],
                          sw128_desc(ot + kk * 16 * 128, QCHUNK, 1024), 1);
          Wgmma<T, D>::rs(dka, da[kk],
                          sw128_desc(qt + kk * 16 * 128, QCHUNK, 1024), 1);
        }
        wgmma_commit();
      };
      if constexpr (D == 64) {
        uint32_t pa0[4][4], da0[4][4], pa1[4][4], da1[4][4];
        bf16_term(pa0, sc);
        bf16_term(da0, dp);
        issue(pa0, da0);
        bf16_term(pa1, sc);
        bf16_term(da1, dp);
        issue(pa1, da1);
        wgmma_wait<1>();        // the first term's products have read pa0
        bf16_term(pa0, sc);
        bf16_term(da0, dp);
        issue(pa0, da0);
        wgmma_wait<0>();
      } else {
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          bf16_term(pa, sc);
          bf16_term(da, dp);
          issue(pa, da);
          wgmma_wait<0>();
        }
      }
      fence_regs<D / 2>(dva);
      fence_regs<D / 2>(dka);
      // the stage's Q, dO, lse and delta have been read: hand it back
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // the item's K and V have been read
    __syncwarp();
    if (lane == 0) mbar_arrive(&kvempty[b]);

#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int cc = 8 * j + 2 * t;
      if (ka < p.Sk) {
        const size_t o = (size_t(bh) * p.Sk + ka) * D + cc;
        *reinterpret_cast<uint32_t*>(dk + o) =
            Mma<T>::pack(p.scale * dka[4 * j], p.scale * dka[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(dv + o) = Mma<T>::pack(dva[4 * j], dva[4 * j + 1]);
      }
      if (kb_ < p.Sk) {
        const size_t o = (size_t(bh) * p.Sk + kb_) * D + cc;
        *reinterpret_cast<uint32_t*>(dk + o) =
            Mma<T>::pack(p.scale * dka[4 * j + 2], p.scale * dka[4 * j + 3]);
        *reinterpret_cast<uint32_t*>(dv + o) =
            Mma<T>::pack(dva[4 * j + 2], dva[4 * j + 3]);
      }
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

// tile sizes of the CUDA-core kernels: (q rows, k rows) for fwd/dq, (k rows,
// q rows) for dkv; halved at D = 128 and again at 256 where registers or
// shared memory would not fit
template <int D> struct Tiles;
template <> struct Tiles<64> { static constexpr int BQ = 64, BK = 64, BKV = 64, BQ2 = 64; };
template <> struct Tiles<128> { static constexpr int BQ = 64, BK = 32, BKV = 32, BQ2 = 64; };
template <> struct Tiles<256> { static constexpr int BQ = 32, BK = 32, BKV = 16, BQ2 = 32; };

// the tensor-core tiles: the wgmma forward's key tile, ring depth and CTAs
// an SM (MB: 4 at D 64, where a consumer needs 104 registers — S takes
// BK / 2 of them and O D / 2 — and 4 x 49 KB of shared memory fit; 2 at
// D 128; 1 at D 256, whose 128 O registers need all of a thread's), and
// the wgmma dK/dV's consumer warpgroups a CTA (DKV_NC; at D 128 two
// consumers of one CTA share each (Q, dO) stage)
template <int D> struct MmaTiles;
template <> struct MmaTiles<64> {
  static constexpr int FWD_BK = 64, STAGES = 2, MB = 4, DKV_NC = 1;
};
template <> struct MmaTiles<128> {
  static constexpr int FWD_BK = 64, STAGES = 2, MB = 2, DKV_NC = 2;
};
template <> struct MmaTiles<256> {
  static constexpr int FWD_BK = 64, STAGES = 2, MB = 1;
};
// the mma.sync dQ's key tile (D 256)
constexpr int DQ_MMA_BK = 32;

// The kernel each entry point launches for these operands, from the dtype
// code (0 fp32, 1 bf16, 2 fp16) and D alone: 1 = a wgmma kernel, 0 = the
// mma.sync dQ (D 256), 2 = a CUDA-core kernel.  The forward takes wgmma for
// bf16 / fp16; dQ for bf16 / fp16 at D 64 and 128; dK/dV for bf16 at D 64
// and 128 (its pd and ds go to the tensor cores as three bf16 terms; in
// fp16 the residual terms of a small p or ds fall into subnormals, and at
// D 256 the accumulators would not fit in registers).
constexpr int dq_route_of(int dtype, int D) {
  return dtype == 0 ? 2 : (D == 64 || D == 128) ? 1 : 0;
}
constexpr int dkv_route_of(int dtype, int D) {
  return dtype == 1 && (D == 64 || D == 128) ? 1 : 2;
}
template <typename T>
constexpr int dtype_code =
    std::is_same<T, float>::value ? 0
    : std::is_same<T, __nv_bfloat16>::value ? 1 : 2;

// a persistent grid: as many CTAs as fit on the card at once (per_sm an
// SM), at most one an item; each walks its share of the items
cudaError_t persistent_grid(int items, int per_sm, int& grid) {
  int dev, sms;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return e;
  grid = min(items, sms * per_sm);
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_fwd_wgmma(const Ptrs& a, const Params& p, cudaStream_t st) {
  using MT = MmaTiles<D>;
  using LY = WgFwd<T, D, MT::FWD_BK, MT::STAGES, MT::MB>;
  CUtensorMap tq, tk, tv;
  cudaError_t e;
  if ((e = tensor_map<T>(&tq, a.q, p.BH, p.S, D, LY::BQ)) != cudaSuccess ||
      (e = tensor_map<T>(&tk, a.k, p.BH, p.Sk, D, MT::FWD_BK)) != cudaSuccess ||
      (e = tensor_map<T>(&tv, a.v, p.BH, p.Sk, D, MT::FWD_BK)) != cudaSuccess)
    return e;
  auto kern = flash_fwd_wgmma_kernel<T, D, MT::FWD_BK, MT::STAGES, MT::MB>;
  int grid;
  if ((e = set_smem(kern, LY::SMEM)) != cudaSuccess ||
      (e = persistent_grid((p.S + LY::BQ - 1) / LY::BQ * p.BH, MT::MB, grid)) !=
          cudaSuccess)
    return e;
  kern<<<grid, LY::THREADS, LY::SMEM, st>>>(
      tq, tk, tv, static_cast<T*>(a.o), static_cast<float*>(a.lse_out), p);
  return cudaGetLastError();
}

// the maps of lse and delta: 1-d over the flat [BH S] fp32 buffers, boxes
// of 64 rows from any element (zeros past BH S)
cudaError_t row_maps(CUtensorMap* tl, CUtensorMap* td, const Ptrs& a,
                     const Params& p) {
  const long long n = (long long)p.BH * p.S;
  cudaError_t e = tensor_map_1d(tl, a.lse, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, n, 64);
  if (e != cudaSuccess) return e;
  return tensor_map_1d(td, a.delta, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, n, 64);
}

template <typename T, int D>
cudaError_t launch_dq_wgmma(const Ptrs& a, const Params& p, cudaStream_t st) {
  using LY = WgDq<D>;
  CUtensorMap tq, tk, tv, tdo, tl, td;
  cudaError_t e;
  if ((e = tensor_map<T>(&tq, a.q, p.BH, p.S, D, 64)) != cudaSuccess ||
      (e = tensor_map<T>(&tk, a.k, p.BH, p.Sk, D, 64)) != cudaSuccess ||
      (e = tensor_map<T>(&tv, a.v, p.BH, p.Sk, D, 64)) != cudaSuccess ||
      (e = tensor_map<T>(&tdo, a.dout, p.BH, p.S, D, 64)) != cudaSuccess ||
      (e = row_maps(&tl, &td, a, p)) != cudaSuccess)
    return e;
  auto kern = flash_dq_wgmma_kernel<T, D>;
  int grid;
  if ((e = set_smem(kern, LY::SMEM)) != cudaSuccess ||
      (e = persistent_grid((p.S + 63) / 64 * p.BH, LY::MB, grid)) != cudaSuccess)
    return e;
  kern<<<grid, LY::THREADS, LY::SMEM, st>>>(tq, tk, tv, tdo, tl, td,
                                           static_cast<T*>(a.dq), p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const Ptrs& a, const Params& p, cudaStream_t st) {
  using T = __nv_bfloat16;
  constexpr int NC = MmaTiles<D>::DKV_NC;
  using LY = WgDkv<D, NC>;
  CUtensorMap tq, tk, tv, tdo, tl, td;
  cudaError_t e;
  if ((e = tensor_map<T>(&tq, a.q, p.BH, p.S, D, 64)) != cudaSuccess ||
      (e = tensor_map<T>(&tk, a.k, p.BH, p.Sk, D, LY::BKV)) != cudaSuccess ||
      (e = tensor_map<T>(&tv, a.v, p.BH, p.Sk, D, LY::BKV)) != cudaSuccess ||
      (e = tensor_map<T>(&tdo, a.dout, p.BH, p.S, D, 64)) != cudaSuccess ||
      (e = row_maps(&tl, &td, a, p)) != cudaSuccess)
    return e;
  auto kern = flash_dkv_wgmma_kernel<D, NC>;
  int grid;
  if ((e = set_smem(kern, LY::SMEM)) != cudaSuccess ||
      (e = persistent_grid((p.Sk + LY::BKV - 1) / LY::BKV * p.BH, LY::MB,
                           grid)) != cudaSuccess)
    return e;
  kern<<<grid, LY::THREADS, LY::SMEM, st>>>(tq, tk, tv, tdo, tl, td,
                                           static_cast<T*>(a.dk),
                                           static_cast<T*>(a.dv), p);
  return cudaGetLastError();
}

// Which kernel runs (`dq_route_of`, `dkv_route_of`), chosen at compile time
// so that each is instantiated only for the dtypes and head dims that
// reach it.
template <typename T, int D>
cudaError_t launch(int which, const Ptrs& a, const Params& p, cudaStream_t st) {
  using TL = Tiles<D>;
  constexpr bool mma = !std::is_same<T, float>::value;
  constexpr int dq_route = dq_route_of(dtype_code<T>, D);
  constexpr int dkv_route = dkv_route_of(dtype_code<T>, D);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  cudaError_t e;
  if (which == 0) {
    if constexpr (mma) {
      return launch_fwd_wgmma<T, D>(a, p, st);
    } else {
      using LY = FwdLayout<T, D, TL::BQ, TL::BK>;
      auto kern = flash_fwd_kernel<T, D, TL::BQ, TL::BK>;
      if ((e = set_smem(kern, LY::SMEM)) != cudaSuccess) return e;
      dim3 grid((p.S + TL::BQ - 1) / TL::BQ, p.BH);
      kern<<<grid, THREADS, LY::SMEM, st>>>(
          q, k, v, static_cast<T*>(a.o), static_cast<float*>(a.lse_out), p);
    }
  } else if (which == 1) {
    if constexpr (dq_route == 1) {
      return launch_dq_wgmma<T, D>(a, p, st);
    } else if constexpr (dq_route == 0) {
      using LY = MmaLayout<T, D, DQ_MMA_BK>;
      auto kern = flash_dq_mma_kernel<T, D, DQ_MMA_BK>;
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
    if constexpr (dkv_route == 1) {
      return launch_dkv_wgmma<D>(a, p, st);
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
  if (D == 256) return launch<T, 256>(which, a, p, st);
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

// the kernel flash_attention_dq / flash_attention_dkv launches for these
// operands (dtype as above, D 64 / 128 / 256): 1 = the wgmma kernel
// (flash_dq_wgmma_kernel, flash_dkv_wgmma_kernel), 0 = the mma.sync dQ
// (flash_dq_mma_kernel), 2 = the CUDA-core kernel; -1 for operands no
// kernel takes
int flash_attention_dq_route(int dtype, int D) {
  if (dtype < 0 || dtype > 2 || (D != 64 && D != 128 && D != 256)) return -1;
  return dq_route_of(dtype, D);
}

int flash_attention_dkv_route(int dtype, int D) {
  if (dtype < 0 || dtype > 2 || (D != 64 && D != 128 && D != 256)) return -1;
  return dkv_route_of(dtype, D);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

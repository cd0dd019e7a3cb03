// Block-sparse flash attention forward, dQ and dK/dV, written for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of
// deepspeed_tpu/ops/sparse_attention/flash_sparse.py:
//   flash_sparse_fwd  <- `_fwd_kernel` (:73, pallas_call :154)
//   flash_sparse_dq   <- `_dq_kernel`  (:171, pallas_call :290)
//   flash_sparse_dkv  <- `_dkv_kernel` (:208, pallas_call :327)
// and computes what their plain PyTorch versions compute
// (deepspeed_tpu_torch/ops/sparse_attention/flash_sparse.py `_fwd_plain`,
// `_dq_plain`, `_dkv_plain`) on [BH, S, D] tensors in fp32, bf16 or fp16,
// D = 64, 128 or 256, under a block layout of `blk` x `blk` tiles (blk any
// multiple of 16 that divides S, as JAX's kernel takes any block dividing S):
//   fwd:  for each active k-block of the row's forward table, in table
//         order: s = (q*scale).k, causal select to NEG_INF; online softmax;
//         the denominator sums the undropped p, the value sum takes
//         p * keep_mask rounded to V's dtype; out = acc / l (l == 0 -> 1),
//         lse = m + log(l), or NEG_INF for a row with no active block;
//   dq:   the same walk; p = exp(s - lse); dp = dO.V^T (* keep_mask);
//         ds = p (dp - delta); dq = scale * sum(round_K(ds) . K);
//   dkv:  for each q-block of the k-block's reverse table: the same p,
//         pd = p * keep_mask, ds as in dq, kept in fp32;
//         dv = sum(pd^T . dO), dk = scale * sum(ds^T . q).
// delta = rowsum(dO * O) is a plain op of the caller, as in JAX.
//
// Tables: fwd [H, nb, W] holds each q-block's active k-blocks and rev
// [H, nb, Wq] each k-block's q-blocks, ascending and -1 padded at the end
// (`layout_tables`).  A block walks its own row up to the first -1, so it
// runs exactly the row's active tiles: no padded slot is visited, where the
// Pallas grid steps through all W (Wq) slots and masks the empty ones.
// dQ walks the forward table and dK/dV the reverse one, as in JAX, so every
// output element is summed by one block in a fixed order: no atomics, and
// the results are bitwise repeatable.
//
// Dropout: the keep mask of element (bh, q, k) is the counter hash of the
// dense flash kernels (flash_tiles.cuh `keep_scale`, JAX `_keep_mask`) over
// the GLOBAL token coordinates q = qi*blk + r, k = kj*blk + c, with
// bh = b*H + h, so the three kernels regenerate the same mask and it equals
// JAX's and the plain versions' for a given seed.
//
// What bounds it on this card: at the training shape (BERT-large, S = 4096,
// D = 64, block 128, Fixed layout, 11 active blocks a row) the kernels do
// ~2 blk D FLOPs per byte of Q/K/V/O they must move, above the H100's ~295
// FLOP/byte ridge: the bound is operations, the bf16 tensor cores' 989
// TFLOP/s (the forward about 0.05 ms).  The design is the dense kernels'
// (flash_attention.cu) with the key loop replaced by the table walk:
//   * bf16 / fp16, where no wgmma kernel below takes the operands (D 256,
//     blocks that are not a multiple of 64, fp16 dK/dV): mma.sync m16n8k16
//     tiles with fp32 accumulators, staged by plain 16-byte loads.  A block
//     of 4 warps owns C rows of one layout row (C = 64 when blk % 64 == 0:
//     blk / 64 tiles walking the same table row, two at 128, four at 256;
//     else C = 16 with one warp computing); each active k-block is staged C
//     keys at a time (32 at D = 256).  At D = 256 the row tile's Q (and dO)
//     is staged in shared memory, its fragments read there per product:
//     in registers it would take 64 of them per operand.  dK/dV on the
//     tensor cores is bf16 at D = 64 (pd and ds fed as three bf16 terms,
//     fp32 exact); fp16 and D >= 128 take the CUDA-core dK/dV.
//   * bf16 dK/dV at D = 64 with a layout block that is a multiple of 64
//     (train-bert-sparse's): a wgmma kernel fed by TMA on a persistent grid
//     whose items run heaviest reverse-table walk first (the global
//     columns' long walks no longer finish last; below).
//   * bf16 / fp16 dQ and forward at D = 64 or 128 with a layout block that
//     is a multiple of 64 (`wgmma_route_of`): warp-specialised wgmma
//     kernels fed by TMA on a persistent grid, the flash forward's shape
//     with the table walk (below); the forward's two 64-row tiles of a
//     block-128 row share each (K, V) stage.
//   * fp32: fp32 FMAs on the CUDA cores, the dense kernels' thread layout,
//     staged by plain loads.

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

struct SParams {
  int BH, H, S, nb, blk, W;  // W: the table's width (W or Wq)
  float scale;
  int causal;
  const int* tbl;            // [H, nb, W] forward or reverse table
  uint32_t seed_h;           // uint32(seed) * 0x9E3779B1
  uint32_t thr;              // keep iff hash < thr
  float inv_keep;            // fp32(1 / (1 - rate))
  int dropout;
};

__device__ __forceinline__ float causal_score(const SParams& p, float s,
                                              int qg, int kg) {
  return (p.causal && qg < kg) ? NEG_INF : s;
}

// the table row of layout block `i` (a q-block for fwd / dq, a k-block for
// dkv) of batch-head bh
__device__ __forceinline__ const int* table_row(const SParams& p, int bh,
                                                int i) {
  return p.tbl + (size_t(bh % p.H) * p.nb + i) * p.W;
}

// ---------------------------------------------------------------------------
// CUDA-core forward (fp32): one block per (BQ rows of a layout row, bh)
// ---------------------------------------------------------------------------

template <int D, int BQ, int BK>
struct FwdLayout {
  static constexpr int LD = D + 1, LP = BK + 1;
  static constexpr size_t SMEM =
      (size_t(BQ) * LD + 2 * size_t(BK) * LD + size_t(BQ) * LP) * sizeof(float);
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ lse, SParams p) {
  constexpr int RM = BQ / RG, CN = BK / CG, DN = D / CG;
  constexpr int LD = D + 1, LP = BK + 1;
  extern __shared__ __align__(16) float sm[];
  float* sQ = sm;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int r = threadIdx.x / CG, c = threadIdx.x % CG;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int* row = table_row(p, bh, q0 / p.blk);
  const T* kh = k + size_t(bh) * p.S * D;
  const T* vh = v + size_t(bh) * p.S * D;
  const uint32_t bhm = uint32_t(bh) * 0x7FEB352Du;

  load_rows<T, D>(sQ, q + size_t(bh) * p.S * D, q0, p.S, BQ, p.scale);

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DN; ++e) acc[i][e] = 0.f;
  }

  for (int a = 0; a < p.W; ++a) {
    const int kj = row[a];
    if (kj < 0) break;
    for (int k0 = kj * p.blk; k0 < (kj + 1) * p.blk; k0 += BK) {
      __syncthreads();  // the previous tile's reads of sK, sV, sP are done
      load_rows<T, D>(sK, kh, k0, p.S, BK, 1.f);
      load_rows<T, D>(sV, vh, k0, p.S, BK, 1.f);
      __syncthreads();

      float s[RM][CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float x[RM], y[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) x[i] = sQ[(i * RG + r) * LD + d];
#pragma unroll
        for (int j = 0; j < CN; ++j) y[j] = sK[(j * CG + c) * LD + d];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
      }

#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int rr = i * RG + r, qg = q0 + rr;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = causal_score(p, s[i][j], qg, k0 + j * CG + c);
          mx = fmaxf(mx, s[i][j]);
        }
        const float m_new = fmaxf(m[i], row_max(mx));
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          float pv = expf(s[i][j] - m_new);
          psum += pv;
          if (p.dropout) pv *= keep_scale(p, bhm, qg, k0 + j * CG + c);
          sP[rr * LP + j * CG + c] = round_to<T>(pv);
        }
        const float alpha = expf(m[i] - m_new);
        l[i] = alpha * l[i] + row_sum(psum);
#pragma unroll
        for (int e = 0; e < DN; ++e) acc[i][e] *= alpha;
        m[i] = m_new;
      }
      __syncthreads();

      for (int kk = 0; kk < BK; ++kk) {
        float x[RM], y[DN];
#pragma unroll
        for (int i = 0; i < RM; ++i) x[i] = sP[(i * RG + r) * LP + kk];
#pragma unroll
        for (int e = 0; e < DN; ++e) y[e] = sV[kk * LD + e * CG + c];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int e = 0; e < DN; ++e) acc[i][e] = fmaf(x[i], y[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qg = q0 + i * RG + r;
    const float safe = l[i] == 0.f ? 1.f : l[i];
    T* dst = o + (size_t(bh) * p.S + qg) * D;
#pragma unroll
    for (int e = 0; e < DN; ++e) dst[e * CG + c] = from_f<T>(acc[i][e] / safe);
    if (c == 0)
      lse[size_t(bh) * p.S + qg] = l[i] == 0.f ? NEG_INF : m[i] + logf(safe);
  }
}

// ---------------------------------------------------------------------------
// CUDA-core dQ (fp32): the forward's walk
// ---------------------------------------------------------------------------

template <int D, int BQ, int BK>
struct DqLayout {
  static constexpr int LD = D + 1, LP = BK + 1;
  static constexpr size_t SMEM =
      (2 * size_t(BQ) * LD + 2 * size_t(BK) * LD + size_t(BQ) * LP) * sizeof(float);
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
sparse_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dq, SParams p) {
  constexpr int RM = BQ / RG, CN = BK / CG, DN = D / CG;
  constexpr int LD = D + 1, LP = BK + 1;
  extern __shared__ __align__(16) float sm[];
  float* sQ = sm;
  float* sO = sQ + BQ * LD;   // dO
  float* sK = sO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;   // ds rounded to K's dtype

  const int r = threadIdx.x / CG, c = threadIdx.x % CG;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int* row = table_row(p, bh, q0 / p.blk);
  const T* kh = k + size_t(bh) * p.S * D;
  const T* vh = v + size_t(bh) * p.S * D;
  const uint32_t bhm = uint32_t(bh) * 0x7FEB352Du;

  load_rows<T, D>(sQ, q + size_t(bh) * p.S * D, q0, p.S, BQ, p.scale);
  load_rows<T, D>(sO, dout + size_t(bh) * p.S * D, q0, p.S, BQ, 1.f);
  float lse_r[RM], delta_r[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qg = q0 + i * RG + r;
    lse_r[i] = lse[size_t(bh) * p.S + qg];
    delta_r[i] = delta[size_t(bh) * p.S + qg];
#pragma unroll
    for (int e = 0; e < DN; ++e) acc[i][e] = 0.f;
  }

  for (int a = 0; a < p.W; ++a) {
    const int kj = row[a];
    if (kj < 0) break;
    for (int k0 = kj * p.blk; k0 < (kj + 1) * p.blk; k0 += BK) {
      __syncthreads();
      load_rows<T, D>(sK, kh, k0, p.S, BK, 1.f);
      load_rows<T, D>(sV, vh, k0, p.S, BK, 1.f);
      __syncthreads();

      float s[RM][CN], dp[RM][CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float x[RM], xo[RM], y[CN], yv[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          x[i] = sQ[(i * RG + r) * LD + d];
          xo[i] = sO[(i * RG + r) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          y[j] = sK[(j * CG + c) * LD + d];
          yv[j] = sV[(j * CG + c) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) {
            s[i][j] = fmaf(x[i], y[j], s[i][j]);
            dp[i][j] = fmaf(xo[i], yv[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int rr = i * RG + r, qg = q0 + rr;
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const int kg = k0 + j * CG + c;
          const float pv = expf(causal_score(p, s[i][j], qg, kg) - lse_r[i]);
          float dpv = dp[i][j];
          if (p.dropout) dpv *= keep_scale(p, bhm, qg, kg);
          sS[rr * LP + j * CG + c] = round_to<T>(pv * (dpv - delta_r[i]));
        }
      }
      __syncthreads();

      for (int kk = 0; kk < BK; ++kk) {
        float x[RM], y[DN];
#pragma unroll
        for (int i = 0; i < RM; ++i) x[i] = sS[(i * RG + r) * LP + kk];
#pragma unroll
        for (int e = 0; e < DN; ++e) y[e] = sK[kk * LD + e * CG + c];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int e = 0; e < DN; ++e) acc[i][e] = fmaf(x[i], y[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qg = q0 + i * RG + r;
    T* dst = dq + (size_t(bh) * p.S + qg) * D;
#pragma unroll
    for (int e = 0; e < DN; ++e) dst[e * CG + c] = from_f<T>(p.scale * acc[i][e]);
  }
}

// ---------------------------------------------------------------------------
// CUDA-core dK, dV: one block per (BKV keys of a layout column, bh), walking
// the reverse table's q-blocks BQ rows at a time
// ---------------------------------------------------------------------------

template <int D, int BKV, int BQ>
struct DkvLayout {
  static constexpr int LD = D + 1, LP = BQ + 1;
  static constexpr size_t SMEM =
      (2 * size_t(BKV) * LD + 2 * size_t(BQ) * LD + 2 * size_t(BKV) * LP +
       2 * size_t(BQ)) * sizeof(float);
};

template <typename T, int D, int BKV, int BQ>
__global__ void __launch_bounds__(THREADS)
sparse_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  T* __restrict__ dk, T* __restrict__ dv, SParams p) {
  constexpr int RM = BKV / RG, CN = BQ / CG, DN = D / CG;
  constexpr int LD = D + 1, LP = BQ + 1;
  extern __shared__ __align__(16) float sm[];
  float* sK = sm;
  float* sV = sK + BKV * LD;
  float* sQ = sV + BKV * LD;   // q, unscaled
  float* sO = sQ + BQ * LD;    // dO
  float* sPd = sO + BQ * LD;   // pd^T [key][q], fp32
  float* sDs = sPd + BKV * LP; // ds^T [key][q], fp32
  float* sL = sDs + BKV * LP;  // lse of the q rows
  float* sD = sL + BQ;         // delta of the q rows

  const int r = threadIdx.x / CG, c = threadIdx.x % CG;
  const int k0 = blockIdx.x * BKV;
  const int bh = blockIdx.y;
  const int* col = table_row(p, bh, k0 / p.blk);
  const T* qh = q + size_t(bh) * p.S * D;
  const T* oh = dout + size_t(bh) * p.S * D;
  const float* lh = lse + size_t(bh) * p.S;
  const float* dh = delta + size_t(bh) * p.S;
  const uint32_t bhm = uint32_t(bh) * 0x7FEB352Du;

  load_rows<T, D>(sK, k + size_t(bh) * p.S * D, k0, p.S, BKV, 1.f);
  load_rows<T, D>(sV, v + size_t(bh) * p.S * D, k0, p.S, BKV, 1.f);
  float dka[RM][DN], dva[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int e = 0; e < DN; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int a = 0; a < p.W; ++a) {
    const int qi = col[a];
    if (qi < 0) break;
    for (int q0 = qi * p.blk; q0 < (qi + 1) * p.blk; q0 += BQ) {
      __syncthreads();
      load_rows<T, D>(sQ, qh, q0, p.S, BQ, 1.f);
      load_rows<T, D>(sO, oh, q0, p.S, BQ, 1.f);
      for (int i = threadIdx.x; i < BQ; i += THREADS) {
        sL[i] = lh[q0 + i];
        sD[i] = dh[q0 + i];
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
        float x[RM], xv[RM], y[CN], yo[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          x[i] = sK[(i * RG + r) * LD + d];
          xv[i] = sV[(i * RG + r) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          y[j] = sQ[(j * CG + c) * LD + d];
          yo[j] = sO[(j * CG + c) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) {
            s[i][j] = fmaf(x[i], y[j], s[i][j]);
            dp[i][j] = fmaf(xv[i], yo[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int rr = i * RG + r, kg = k0 + rr;
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const int cc = j * CG + c, qg = q0 + cc;
          // s = (q*scale).k: scale * (q.k) is the same number when scale is
          // a power of two (D = 64) and within one rounding otherwise
          const float pv =
              expf(causal_score(p, p.scale * s[i][j], qg, kg) - sL[cc]);
          float pd = pv, dpv = dp[i][j];
          if (p.dropout) {
            const float ks = keep_scale(p, bhm, qg, kg);
            pd *= ks;
            dpv *= ks;
          }
          sPd[rr * LP + cc] = pd;
          sDs[rr * LP + cc] = pv * (dpv - sD[cc]);
        }
      }
      __syncthreads();

      for (int qq = 0; qq < BQ; ++qq) {
        float xpd[RM], xds[RM], yo[DN], yq[DN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          xpd[i] = sPd[(i * RG + r) * LP + qq];
          xds[i] = sDs[(i * RG + r) * LP + qq];
        }
#pragma unroll
        for (int e = 0; e < DN; ++e) {
          yo[e] = sO[qq * LD + e * CG + c];
          yq[e] = sQ[qq * LD + e * CG + c];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int e = 0; e < DN; ++e) {
            dva[i][e] = fmaf(xpd[i], yo[e], dva[i][e]);
            dka[i][e] = fmaf(xds[i], yq[e], dka[i][e]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int kg = k0 + i * RG + r;
    T* dstk = dk + (size_t(bh) * p.S + kg) * D;
    T* dstv = dv + (size_t(bh) * p.S + kg) * D;
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
// One block of 4 warps per (C rows of a layout row, bh); warp w owns rows
// [16w, 16w + 16) when 16w < C (C = 16: warp 0 computes, the others only
// stage) and keeps its Q (and dO) fragments in registers for the whole walk.
// Each active k-block is staged CK keys at a time as in flash_attention.cu:
// K row-major for S = Q.K^T, V (or K, for dQ) transposed for the second
// product, whose A operand (p or ds, rounded to T) comes from registers.

template <typename T, int D, int CK>
struct MmaLayout {
  // at D = 256 the 16 rows' Q (and dO) fragments would take 64 registers
  // each: the row tile is staged in shared memory once and each product
  // reads its A fragments there
  static constexpr bool QS = D == 256;
  static constexpr int LDK = D + 8, LDT = CK + 8;
  static constexpr size_t Q_SMEM = QS ? 64 * size_t(LDK) * sizeof(T) : 0;
  static constexpr size_t FWD_SMEM =
      (size_t(CK) * LDK + size_t(D) * LDT) * sizeof(T) + Q_SMEM;
  static constexpr size_t DQ_SMEM =
      (2 * size_t(CK) * LDK + size_t(D) * LDT) * sizeof(T) + 2 * Q_SMEM;
};

template <typename T, int D, int C, int CK>
__global__ void __launch_bounds__(THREADS)
sparse_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, SParams p) {
  using LY = MmaLayout<T, D, CK>;
  constexpr bool QS = LY::QS;
  constexpr int LDK = LY::LDK, LDT = LY::LDT;
  constexpr int KD = D / 16, NT = CK / 8, KK = CK / 16, DN = D / 8;
  extern __shared__ __align__(16) unsigned char smraw[];
  T* sK = reinterpret_cast<T*>(smraw);   // [CK][LDK]
  T* sVt = sK + CK * LDK;                // [D][LDT]
  T* sQ = sVt + D * LDT;                 // QS: [C][LDK]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool active = warp * 16 < C;
  const int q0 = blockIdx.x * C;
  const int bh = blockIdx.y;
  const int* row = table_row(p, bh, q0 / p.blk);
  const T* kh = k + size_t(bh) * p.S * D;
  const T* vh = v + size_t(bh) * p.S * D;
  const uint32_t bhm = uint32_t(bh) * 0x7FEB352Du;
  const int r0 = q0 + warp * 16, ra = r0 + g, rb = ra + 8;

  uint32_t qa[QS ? 1 : KD][4];
  if constexpr (QS)  // read after the walk's first barrier
    stage_rows<T, D, LDK>(sQ, q + size_t(bh) * p.S * D, q0, p.S, C);
  else if (active)
    load_a<T, D>(qa, q + size_t(bh) * p.S * D, r0, p.S, g, t);
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

  for (int a = 0; a < p.W; ++a) {
    const int kj = row[a];
    if (kj < 0) break;
    for (int k0 = kj * p.blk; k0 < (kj + 1) * p.blk; k0 += CK) {
      __syncthreads();
      stage_rows<T, D, LDK>(sK, kh, k0, p.S, CK);
      stage_cols<T, D, LDT>(sVt, vh, k0, p.S, CK);
      __syncthreads();
      if (!active) continue;

      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      if constexpr (QS)
        mma_tiles_sa<T, KD, NT, LDK, LDK>(s, sQ + warp * 16 * LDK, sK, g, t);
      else
        mma_tiles<T, KD, NT, LDK>(s, qa, sK, g, t);

      float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int kg = k0 + nt * 8 + 2 * t + i;
          s[nt][i] = causal_score(p, p.scale * s[nt][i], ra, kg);
          s[nt][2 + i] = causal_score(p, p.scale * s[nt][2 + i], rb, kg);
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
          float pv = expf(s[nt][i] - (i < 2 ? mn_a : mn_b));
          if (i < 2) ps_a += pv; else ps_b += pv;
          if (p.dropout) pv *= keep_scale(p, bhm, i < 2 ? ra : rb, kg);
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
  }
  if (!active) return;

  const float sa = l_a == 0.f ? 1.f : l_a, sb = l_b == 0.f ? 1.f : l_b;
  T* oh = o + size_t(bh) * p.S * D;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int cc = dn * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(oh + size_t(ra) * D + cc) =
        Mma<T>::pack(acc[dn][0] / sa, acc[dn][1] / sa);
    *reinterpret_cast<uint32_t*>(oh + size_t(rb) * D + cc) =
        Mma<T>::pack(acc[dn][2] / sb, acc[dn][3] / sb);
  }
  if (t == 0) {
    lse[size_t(bh) * p.S + ra] = l_a == 0.f ? NEG_INF : m_a + logf(sa);
    lse[size_t(bh) * p.S + rb] = l_b == 0.f ? NEG_INF : m_b + logf(sb);
  }
}

template <typename T, int D, int C, int CK>
__global__ void __launch_bounds__(THREADS)
sparse_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     SParams p) {
  using LY = MmaLayout<T, D, CK>;
  constexpr bool QS = LY::QS;
  constexpr int LDK = LY::LDK, LDT = LY::LDT;
  constexpr int KD = D / 16, NT = CK / 8, KK = CK / 16, DN = D / 8;
  extern __shared__ __align__(16) unsigned char smraw[];
  T* sK = reinterpret_cast<T*>(smraw);   // [CK][LDK]
  T* sV = sK + CK * LDK;                 // [CK][LDK]
  T* sKt = sV + CK * LDK;                // [D][LDT]
  T* sQ = sKt + D * LDT;                 // QS: [C][LDK]
  T* sO = sQ + 64 * LDK;                 // QS: dO [C][LDK]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool active = warp * 16 < C;
  const int q0 = blockIdx.x * C;
  const int bh = blockIdx.y;
  const int* row = table_row(p, bh, q0 / p.blk);
  const T* kh = k + size_t(bh) * p.S * D;
  const T* vh = v + size_t(bh) * p.S * D;
  const uint32_t bhm = uint32_t(bh) * 0x7FEB352Du;
  const int r0 = q0 + warp * 16, ra = r0 + g, rb = ra + 8;

  uint32_t qa[QS ? 1 : KD][4], da[QS ? 1 : KD][4];
  float lse_a = 0.f, lse_b = 0.f, dl_a = 0.f, dl_b = 0.f;
  if constexpr (QS) {  // read after the walk's first barrier
    stage_rows<T, D, LDK>(sQ, q + size_t(bh) * p.S * D, q0, p.S, C);
    stage_rows<T, D, LDK>(sO, dout + size_t(bh) * p.S * D, q0, p.S, C);
  }
  if (active) {
    if constexpr (!QS) {
      load_a<T, D>(qa, q + size_t(bh) * p.S * D, r0, p.S, g, t);
      load_a<T, D>(da, dout + size_t(bh) * p.S * D, r0, p.S, g, t);
    }
    lse_a = lse[size_t(bh) * p.S + ra];
    lse_b = lse[size_t(bh) * p.S + rb];
    dl_a = delta[size_t(bh) * p.S + ra];
    dl_b = delta[size_t(bh) * p.S + rb];
  }
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int a = 0; a < p.W; ++a) {
    const int kj = row[a];
    if (kj < 0) break;
    for (int k0 = kj * p.blk; k0 < (kj + 1) * p.blk; k0 += CK) {
      __syncthreads();
      stage_rows<T, D, LDK>(sK, kh, k0, p.S, CK);
      stage_rows<T, D, LDK>(sV, vh, k0, p.S, CK);
      stage_cols<T, D, LDT>(sKt, kh, k0, p.S, CK);
      __syncthreads();
      if (!active) continue;

      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
      if constexpr (QS) {
        mma_tiles_sa<T, KD, NT, LDK, LDK>(s, sQ + warp * 16 * LDK, sK, g, t);
        mma_tiles_sa<T, KD, NT, LDK, LDK>(dp, sO + warp * 16 * LDK, sV, g, t);
      } else {
        mma_tiles<T, KD, NT, LDK>(s, qa, sK, g, t);
        mma_tiles<T, KD, NT, LDK>(dp, da, sV, g, t);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kg = k0 + nt * 8 + 2 * t + (i & 1);
          const int rr = i < 2 ? ra : rb;
          const float x = causal_score(p, p.scale * s[nt][i], rr, kg);
          const float pv = expf(x - (i < 2 ? lse_a : lse_b));
          float dpv = dp[nt][i];
          if (p.dropout) dpv *= keep_scale(p, bhm, rr, kg);
          s[nt][i] = pv * (dpv - (i < 2 ? dl_a : dl_b));
        }
      uint32_t dsa[KK][4];
      c_to_a<T, KK>(dsa, s);  // ds rounded to K's dtype
      mma_tiles<T, KK, DN, LDT>(acc, dsa, sKt, g, t);
    }
  }
  if (!active) return;

  T* dqh = dq + size_t(bh) * p.S * D;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int cc = dn * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dqh + size_t(ra) * D + cc) =
        Mma<T>::pack(p.scale * acc[dn][0], p.scale * acc[dn][1]);
    *reinterpret_cast<uint32_t*>(dqh + size_t(rb) * D + cc) =
        Mma<T>::pack(p.scale * acc[dn][2], p.scale * acc[dn][3]);
  }
}

template <int D, int C>
struct DkvMmaLayout {
  static constexpr int LDR = D + 8, LDT = C + 8;
  static constexpr size_t BYTES =
      (4 * size_t(C) * LDR + 2 * size_t(D) * LDT) * sizeof(__nv_bfloat16) +
      2 * size_t(C) * sizeof(float);
};

// dK, dV in bf16 on the tensor cores: one block of 4 warps per (C keys of a
// layout column, bh), warp w the keys [16w, 16w + 16) when 16w < C, walking
// the reverse table's q-blocks C rows at a time.  S^T = K.Q^T and
// dP^T = V.dO^T come out with keys as rows, so pd^T and ds^T feed
// dV += pd^T.dO and dK += ds^T.Q as A operands from registers, in three bf16
// terms each (mma_fp32_a).
template <int D, int C>
__global__ void __launch_bounds__(THREADS)
sparse_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, SParams p) {
  using T = __nv_bfloat16;
  using LY = DkvMmaLayout<D, C>;
  constexpr int LDR = LY::LDR, LDT = LY::LDT;
  constexpr int KD = D / 16, NT = C / 8, KK = C / 16, DN = D / 8;
  extern __shared__ __align__(16) unsigned char smraw[];
  T* sK = reinterpret_cast<T*>(smraw);  // [C][LDR]
  T* sV = sK + C * LDR;                 // [C][LDR]
  T* sQ = sV + C * LDR;                 // [C][LDR]
  T* sO = sQ + C * LDR;                 // dO [C][LDR]
  T* sQt = sO + C * LDR;                // [D][LDT]
  T* sOt = sQt + D * LDT;               // [D][LDT]
  float* sL = reinterpret_cast<float*>(sOt + D * LDT);
  float* sDl = sL + C;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool active = warp * 16 < C;
  const int k0 = blockIdx.x * C;
  const int bh = blockIdx.y;
  const int* col = table_row(p, bh, k0 / p.blk);
  const T* qh = q + size_t(bh) * p.S * D;
  const T* oh = dout + size_t(bh) * p.S * D;
  const float* lh = lse + size_t(bh) * p.S;
  const float* dh = delta + size_t(bh) * p.S;
  const uint32_t bhm = uint32_t(bh) * 0x7FEB352Du;
  const int ka = k0 + warp * 16 + g, kb_ = ka + 8;

  stage_rows<T, D, LDR>(sK, k + size_t(bh) * p.S * D, k0, p.S, C);
  stage_rows<T, D, LDR>(sV, v + size_t(bh) * p.S * D, k0, p.S, C);
  float dka[DN][4], dva[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[dn][i] = dva[dn][i] = 0.f;

  for (int a = 0; a < p.W; ++a) {
    const int qi = col[a];
    if (qi < 0) break;
    for (int q0 = qi * p.blk; q0 < (qi + 1) * p.blk; q0 += C) {
      __syncthreads();
      stage_rows<T, D, LDR>(sQ, qh, q0, p.S, C);
      stage_rows<T, D, LDR>(sO, oh, q0, p.S, C);
      stage_cols<T, D, LDT>(sQt, qh, q0, p.S, C);
      stage_cols<T, D, LDT>(sOt, oh, q0, p.S, C);
      for (int i = threadIdx.x; i < C; i += THREADS) {
        sL[i] = lh[q0 + i];
        sDl[i] = dh[q0 + i];
      }
      __syncthreads();
      if (!active) continue;

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
          const int cc = nt * 8 + 2 * t + (i & 1), qg = q0 + cc;
          const int kg = i < 2 ? ka : kb_;
          // s = (q*scale).k: scale * (q.k) is the same number when scale is
          // a power of two (D = 64)
          const float x = causal_score(p, p.scale * st[nt][i], qg, kg);
          const float pv = expf(x - sL[cc]);
          float pd = pv, dpv = dpt[nt][i];
          if (p.dropout) {
            const float ks = keep_scale(p, bhm, qg, kg);
            pd *= ks;
            dpv *= ks;
          }
          st[nt][i] = pd;                          // pd^T, fp32
          dpt[nt][i] = pv * (dpv - sDl[cc]);       // ds^T, fp32
        }
      mma_fp32_a<KK, DN, LDT>(dva, st, sOt, g, t);
      mma_fp32_a<KK, DN, LDT>(dka, dpt, sQt, g, t);
    }
  }
  if (!active) return;

#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int cc = dn * 8 + 2 * t;
    size_t off = (size_t(bh) * p.S + ka) * D + cc;
    *reinterpret_cast<uint32_t*>(dk + off) =
        Mma<T>::pack(p.scale * dka[dn][0], p.scale * dka[dn][1]);
    *reinterpret_cast<uint32_t*>(dv + off) = Mma<T>::pack(dva[dn][0], dva[dn][1]);
    off = (size_t(bh) * p.S + kb_) * D + cc;
    *reinterpret_cast<uint32_t*>(dk + off) =
        Mma<T>::pack(p.scale * dka[dn][2], p.scale * dka[dn][3]);
    *reinterpret_cast<uint32_t*>(dv + off) = Mma<T>::pack(dva[dn][2], dva[dn][3]);
  }
}

// ---------------------------------------------------------------------------
// dK, dV in bf16 at D = 64, layout blocks a multiple of 64: TMA, wgmma
// ---------------------------------------------------------------------------
//
// The work items are (bh, 64-key tile).  The host orders the layout's
// (head, k-block) pairs by the length of their reverse-table walk, heaviest
// first (`dkv_work_order`, kept beside the layout's tables); item w is the
// pair order[w / (B tpb)], batch (w % (B tpb)) / tpb and key tile
// w % tpb of that k-block (tpb = blk / 64), so every batch row of a heavy
// column comes before any lighter column.  A persistent grid of CTAs (two
// an SM) takes items c, c + gridDim.x, ...: the global columns' 8x longer
// walks start first and the short ones fill in behind them.
//
// A CTA is two warpgroups.  Warpgroup 1 is the producer (24 registers
// after setmaxnreg.dec): one thread TMA-loads each item's K and V tiles
// (64 x 64, 128-byte swizzled) into one of two buffers, then runs a ring of
// STAGES stages along the item's reverse-table row, one stage per 64-row q
// tile: Q and dO by TMA, and that tile's lse and delta rows (256 bytes
// each) by bulk copy, all reported to the stage's `full` mbarrier.  The ring
// runs on across items.  Warpgroup 0 is the consumer (setmaxnreg.inc); warp
// w owns keys [16 w, 16 w + 16) of the item.  Per q tile it computes
// S^T = K.Q^T and dP^T = V.dO^T by wgmma with both operands in shared
// memory (keys as rows, so p's and ds's transposes come out as accumulators
// with no shuffle), then in fp32 registers the function's
//   p = exp(scale s - lse), pd = p keep, ds = p (dp keep - delta)
// (the causal select and the hash at the global (q, k) coordinates, read
// transposed: rows are keys, columns queries), and then dV += pd^T.dO and
// dK += ds^T.Q by wgmma with A from registers and B the SAME swizzled Q and
// dO tiles read as MN-major operands, as the flash forward reads V: no
// transposed copy is staged.  pd and ds stay fp32, as the function keeps
// them: each goes to the tensor cores as three bf16 terms (hi + mid + lo,
// each the bf16 rounding of what the terms before it left; x - bf16(x) is
// exact in fp32, so the three carry fp32's 24 bits), so a step issues
// 4 + 4 products for S^T and dP^T and 3 x (4 + 4) for dV and dK: twice the
// two products a plain bf16 backward would make there.  Terms are issued
// as each is packed (two A buffers, the third term reusing the first's once
// its products retire).  Every output element is summed by one warp in the
// reverse table's order: no atomics, bitwise repeatable.  A column whose
// reverse row is empty (-1 first) writes zeros.

struct WgDkv {
  static constexpr int THREADS = 256, STAGES = 3, MB = 2;
  static constexpr int TILE = 64 * 128;          // 64 rows of 64 bf16
  // Q, dO, then lse[64] and delta[64] (padded so stages stay 1024-aligned)
  static constexpr int STAGE = 2 * TILE + 1024;
  static constexpr size_t SMEM =
      1024 + 4 * size_t(TILE) + STAGES * size_t(STAGE) + 8 * (2 * STAGES + 4);
  static constexpr int LAUNCH_REGS = (65536 / (THREADS * MB)) & ~7;
  static constexpr int CONSUMER_REGS = 2 * LAUNCH_REGS - 24;
};

__global__ void __launch_bounds__(256, WgDkv::MB)
sparse_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ order, int n_batch,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, SParams p) {
  using LY = WgDkv;
  using T = __nv_bfloat16;
  constexpr int TILE = LY::TILE, STAGES = LY::STAGES, STAGE = LY::STAGE;
  extern __shared__ unsigned char smraw[];
  // 1024-byte alignment for the swizzle atoms
  unsigned char* sK = smraw + ((1024 - (smem_u32(smraw) & 1023)) & 1023);
  unsigned char* sV = sK + 2 * TILE;               // [2][TILE] each
  unsigned char* sR = sV + 2 * TILE;               // [STAGES][STAGE]
  uint64_t* full = reinterpret_cast<uint64_t*>(sR + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* kvfull = empty + STAGES;               // [2]: K, V loaded
  uint64_t* kvempty = kvfull + 2;                  // [2]: K, V free

  const int tpb = p.blk / 64;
  const int per = n_batch * tpb;                   // items a (head, k-block)
  const int n_items = p.BH * p.nb * tpb;
  // item w -> (bh, first key); returns the k-block's reverse-table row
  auto item = [&](int w, int& bh, int& k0) {
    const int hk = order[w / per], r = w % per;
    const int h = hk / p.nb, kj = hk % p.nb;
    bh = (r / tpb) * p.H + h;
    k0 = kj * p.blk + (r % tpb) * 64;
    return p.tbl + size_t(hk) * p.W;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);   // one arrival per consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&kvfull[b], 1);
      mbar_init(&kvempty[b], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 128) {
      int it = 0;
      for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
        int bh, k0;
        const int* col = item(w, bh, k0);
        const int b = n & 1;
        mbar_wait(&kvempty[b], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&kvfull[b], 2 * TILE);
        tma_load_3d(sK + b * TILE, &tk, &kvfull[b], 0, k0, bh);
        tma_load_3d(sV + b * TILE, &tv, &kvfull[b], 0, k0, bh);
        for (int a = 0; a < p.W; ++a) {
          const int qi = col[a];
          if (qi < 0) break;
          for (int q0 = qi * p.blk; q0 < (qi + 1) * p.blk; q0 += 64, ++it) {
            const int s = it % STAGES;
            mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
            mbar_expect_tx(&full[s], 2 * TILE + 512);
            unsigned char* st = sR + s * STAGE;
            tma_load_3d(st, &tq, &full[s], 0, q0, bh);
            tma_load_3d(st + TILE, &tdo, &full[s], 0, q0, bh);
            const size_t row = size_t(bh) * p.S + q0;
            bulk_load(st + 2 * TILE, lse + row, 256, &full[s]);
            bulk_load(st + 2 * TILE + 256, delta + row, 256, &full[s]);
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
  float dka[32], dva[32];
  int it = 0;
  for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
    int bh, k0;
    const int* col = item(w, bh, k0);
    const int b = n & 1;
    const int ka = k0 + warp * 16 + g, kb_ = ka + 8;
    const uint32_t bhm = uint32_t(bh) * 0x7FEB352Du;
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
    const unsigned char* kt = sK + b * TILE;
    const unsigned char* vt = sV + b * TILE;
    mbar_wait(&kvfull[b], (n >> 1) & 1);

    for (int a = 0; a < p.W; ++a) {
      const int qi = col[a];
      if (qi < 0) break;
      for (int q0 = qi * p.blk; q0 < (qi + 1) * p.blk; q0 += 64, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const unsigned char* qt = sR + s * STAGE;
        const unsigned char* ot = qt + TILE;
        const float* sL = reinterpret_cast<const float*>(qt + 2 * TILE);
        const float* sDl = sL + 64;

        float sc[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<T, 64>::ss(sc, sw128_desc(kt + 32 * kk, 16, 1024),
                           sw128_desc(qt + 32 * kk, 16, 1024), kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<T, 64>::ss(dp, sw128_desc(vt + 32 * kk, 16, 1024),
                           sw128_desc(ot + 32 * kk, 16, 1024), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(sc);
        fence_regs<32>(dp);

        // register 4j + r: key row (r < 2 ? ka : kb_), query column
        // q0 + 8j + 2t + (r & 1)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 4 * j + r, cc = 8 * j + 2 * t + (r & 1);
            const int qg = q0 + cc, kg = r < 2 ? ka : kb_;
            // s = (q*scale).k: scale * (q.k) is the same number at D = 64,
            // whose scale is a power of two
            const float x = causal_score(p, p.scale * sc[i], qg, kg);
            const float pv = expf(x - sL[cc]);
            float pd = pv, dpv = dp[i];
            if (p.dropout) {
              const float ks = keep_scale(p, bhm, qg, kg);
              pd *= ks;
              dpv *= ks;
            }
            sc[i] = pd;                       // pd^T, fp32
            dp[i] = pv * (dpv - sDl[cc]);     // ds^T, fp32
          }

        // dV += pd^T.dO and dK += ds^T.Q, three bf16 terms each; B is the
        // stage's dO / Q tile read MN-major (16 q rows a slice)
        uint32_t pa0[4][4], da0[4][4], pa1[4][4], da1[4][4];
        auto issue = [&](uint32_t (&pa)[4][4], uint32_t (&da)[4][4]) {
          fence_regs<32>(dva);
          fence_regs<32>(dka);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            Wgmma<T, 64>::rs(dva, pa[kk],
                             sw128_desc(ot + kk * 16 * 128, TILE, 1024), 1);
            Wgmma<T, 64>::rs(dka, da[kk],
                             sw128_desc(qt + kk * 16 * 128, TILE, 1024), 1);
          }
          wgmma_commit();
        };
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
        fence_regs<32>(dva);
        fence_regs<32>(dka);
        // the stage's Q, dO, lse and delta have been read: hand it back
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }
    // the item's K and V have been read
    __syncwarp();
    if (lane == 0) mbar_arrive(&kvempty[b]);

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cc = 8 * j + 2 * t;
      size_t off = (size_t(bh) * p.S + ka) * 64 + cc;
      *reinterpret_cast<uint32_t*>(dk + off) =
          Mma<T>::pack(p.scale * dka[4 * j], p.scale * dka[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(dv + off) = Mma<T>::pack(dva[4 * j], dva[4 * j + 1]);
      off = (size_t(bh) * p.S + kb_) * 64 + cc;
      *reinterpret_cast<uint32_t*>(dk + off) =
          Mma<T>::pack(p.scale * dka[4 * j + 2], p.scale * dka[4 * j + 3]);
      *reinterpret_cast<uint32_t*>(dv + off) = Mma<T>::pack(dva[4 * j + 2], dva[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ for bf16 / fp16 at D = 64 or 128, layout blocks a multiple of 64: TMA,
// wgmma, warp-specialised
// ---------------------------------------------------------------------------
//
// The flash forward's wgmma shape (flash_attention.cu
// `flash_fwd_wgmma_kernel`) with the table walk of the dK/dV kernel above.
// The work items are (bh, 64-row q tile), taken by a persistent grid of
// CTAs (MB an SM) as c, c + gridDim.x, ...  (every row of the training
// layout has the same walk length, so no order is needed).  A CTA is two
// warpgroups.  Warpgroup 1 is the producer (24 registers after
// setmaxnreg.dec): one thread TMA-loads each item's Q and dO tiles (64 x D,
// 128-byte swizzled, in 64-column chunks) and its rows' lse and delta
// (256 bytes each, by bulk copy) into one of QB buffers, then runs a ring of
// STAGES (K, V) stages along the item's forward-table row, one stage per
// 64-key tile, up to the first -1; the ring runs on across items.
// Warpgroup 0 is the consumer (setmaxnreg.inc); warp w owns q rows
// [16 w, 16 w + 16) of the item.  Per key tile it computes S = Q.K^T and
// dP = dO.V^T by wgmma m64n64k16 with both operands in shared memory, then
// in fp32 registers the function's
//   p = exp(scale s - lse) (the causal select first; the exp as one EX2),
//   ds = p (dp keep - delta)
// (the hash at the global (q, k) coordinates, `keep_scale`), rounds ds once
// to the input dtype straight into wgmma A fragments (the function's
// ds.astype(k.dtype), so the last product needs no split of ds), and adds
// dQ += ds.K by wgmma m64nDk16 with B the SAME swizzled K tile read MN-major
// (the transpose bit set): no transposed copy is staged.  The dQ
// accumulator is 64 x D fp32 in registers (D / 2 a thread); every element
// is summed by one warp in table order, 64 keys at a time: no atomics,
// bitwise repeatable.  A q tile whose table row is empty writes zeros.
// Shared memory: D 64 two Q buffers (the next item's Q and dO load while
// this one finishes) and three stages, 85 KB; D 128 one Q buffer and two
// stages, 100 KB; two CTAs an SM either way, so one CTA's tensor-core work
// overlaps the other's elementwise pass.

// exp(x - lse) is ex2((x - lse) log2 e) (hopper.cuh), the difference
// taken first as the function takes it: a row whose live keys are all
// causally masked keeps p = 1.

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
sparse_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       SParams p) {
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

  const int nq = p.S / 64;
  const int n_items = p.BH * nq;
  // item w -> (bh, first q row); returns the q-block's forward-table row
  auto item = [&](int w, int& bh, int& q0) {
    bh = w / nq;
    q0 = (w % nq) * 64;
    return table_row(p, bh, q0 / p.blk);
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
        int bh, q0;
        const int* row = item(w, bh, q0);
        const int b = n % QB;
        mbar_wait(&qempty[b], ((n / QB) & 1) ^ 1);
        mbar_expect_tx(&qfull[b], 2 * TILE + 512);
        unsigned char* qb = sQ + b * LY::QBUF;
        for (int c = 0; c < NDC; ++c) {
          tma_load_3d(qb + c * CHUNK, &tq, &qfull[b], 64 * c, q0, bh);
          tma_load_3d(qb + TILE + c * CHUNK, &tdo, &qfull[b], 64 * c, q0, bh);
        }
        const size_t r = size_t(bh) * p.S + q0;
        bulk_load(qb + 2 * TILE, lse + r, 256, &qfull[b]);
        bulk_load(qb + 2 * TILE + 256, delta + r, 256, &qfull[b]);
        for (int a = 0; a < p.W; ++a) {
          const int kj = row[a];
          if (kj < 0) break;
          for (int k0 = kj * p.blk; k0 < (kj + 1) * p.blk; k0 += 64, ++it) {
            const int s = it % STAGES;
            mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
            mbar_expect_tx(&full[s], 2 * TILE);
            unsigned char* st = sKV + s * LY::STAGE;
            for (int c = 0; c < NDC; ++c) {
              tma_load_3d(st + c * CHUNK, &tk, &full[s], 64 * c, k0, bh);
              tma_load_3d(st + TILE + c * CHUNK, &tv, &full[s], 64 * c, k0, bh);
            }
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
  float acc[D / 2];
  int it = 0;
  for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
    int bh, q0;
    const int* row = item(w, bh, q0);
    const int b = n % QB;
    const int ra = q0 + warp * 16 + g, rb = ra + 8;
    const uint32_t bhm = uint32_t(bh) * 0x7FEB352Du;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const unsigned char* qt = sQ + b * LY::QBUF;
    const unsigned char* ot = qt + TILE;
    mbar_wait(&qfull[b], (n / QB) & 1);
    const float* sL = reinterpret_cast<const float*>(qt + 2 * TILE);
    const float lse_a = sL[warp * 16 + g], lse_b = sL[warp * 16 + g + 8];
    const float dl_a = sL[64 + warp * 16 + g], dl_b = sL[64 + warp * 16 + g + 8];

    for (int a = 0; a < p.W; ++a) {
      const int kj = row[a];
      if (kj < 0) break;
      for (int k0 = kj * p.blk; k0 < (kj + 1) * p.blk; k0 += 64, ++it) {
        const int s = it % STAGES;
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

        // register 4j + r: q row (r < 2 ? ra : rb), key k0 + 8j + 2t + (r & 1)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 4 * j + r, kg = k0 + 8 * j + 2 * t + (r & 1);
            const int rr = r < 2 ? ra : rb;
            const float x = causal_score(p, p.scale * sc[i], rr, kg);
            const float pv = ex2((x - (r < 2 ? lse_a : lse_b)) * LOG2E);
            float dpv = dp[i];
            if (p.dropout) dpv *= keep_scale(p, bhm, rr, kg);
            sc[i] = pv * (dpv - (r < 2 ? dl_a : dl_b));
          }
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
    }
    // the item's Q, dO, lse and delta have been read
    __syncwarp();
    if (lane == 0) mbar_arrive(&qempty[b]);

    T* dqh = dq + size_t(bh) * p.S * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int cc = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(dqh + size_t(ra) * D + cc) =
          Mma<T>::pack(p.scale * acc[4 * j], p.scale * acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(dqh + size_t(rb) * D + cc) =
          Mma<T>::pack(p.scale * acc[4 * j + 2], p.scale * acc[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// forward for bf16 / fp16 at D = 64 or 128, layout blocks a multiple of 64:
// TMA, wgmma, warp-specialised, on the dQ kernel's walk
// ---------------------------------------------------------------------------
//
// The dense flash forward's body (flash_attention.cu
// `flash_fwd_wgmma_kernel`: S = Q.K^T by wgmma with both operands in shared
// memory, the online softmax in registers, P rounded to V's dtype straight
// into wgmma A fragments, O += P.V with B the SAME swizzled V tile read
// MN-major) on the dQ kernel's table walk above.  The work items are (bh,
// ROWS q rows of one layout row), taken by a persistent grid as c,
// c + gridDim.x, ...; ROWS = 64 NC, and a ring stage holds BK = 64 NC keys.
// A CTA is NC consumer warpgroups and one producer warpgroup:
//   * NC = 2 where the layout block is a multiple of 128 (train-bert-sparse's
//     128): the item is 128 rows, the two 64-row tiles that walk the SAME
//     table row, and the two consumers (64 rows each) read every (K, V)
//     stage of 128 keys the producer loads, so each key tile is loaded once
//     per layout row (the L2 -> shared-memory traffic of 64-row items
//     halves); one CTA an SM, 384 threads.
//   * NC = 1 for the other multiples of 64 (64, 192, ...): 64-row items and
//     64-key stages, two CTAs an SM, as the dQ kernel.
// The producer (24 registers after setmaxnreg.dec) has one thread TMA-load
// each item's Q tile (ROWS x D, 128-byte swizzled, 64-column chunks) into
// one of two buffers, then a ring of STAGES (K, V) stages along the item's
// forward-table row, up to the first -1; the ring runs on across items.
// Consumer warp w of warpgroup c owns q rows [64 c + 16 w, 64 c + 16 w + 16)
// of the item; per key tile it computes q.k by wgmma m64nBKk16, the causal
// select to NEG_INF (only on tiles that cross its rows' diagonal), the
// online softmax with the exp as one EX2 of q.k scale log2 e - m scale
// log2 e (on a tile that crosses the diagonal, of (x - m) scale log2 e,
// the difference first: a row whose live keys are all causally masked
// keeps p = 1, as the function does), the denominator over the undropped
// p, then p times the keep mask (`keep_scale`'s hash at the global (q, k),
// its row term and the hash's first step on it hoisted out of the key
// loop, its column term's out of the row loop, the same bits) rounded
// once to V's dtype, and O += P.V by
// wgmma m64nDk16.  Every output element is summed by one warp in table
// order: no atomics, bitwise repeatable.  An empty table row writes zeros
// and lse NEG_INF.  (Two schedules measured slower at train-bert-sparse's
// shape and were not kept, PERF.md §6: a software-pipelined loop, tile
// i + 1's S issued before tile i's P.V and its softmax run beside P_i.V_i;
// and that loop with the two consumers taking turns to issue, by named
// barriers.)
// The budgets (train-bert-sparse: B 2, H 16, S 4096, D 64, block 128, 11
// active blocks a row; NC = 2):
//   * registers: a consumer holds O (D / 2 fp32), a tile's scores (BK / 2)
//     and its P fragments (BK / 8): 240 after
//     setmaxnreg.inc beside the producer's 24 (NC = 1: 232, as the dQ
//     kernel).
//   * shared memory: two Q buffers (16 KB each at D 64, 32 at D 128) and
//     four (K, V) stages of 32 KB at D 64, two of 64 KB at D 128: 161 KB,
//     193 KB (NC = 1: 81 KB at D 64, 97 KB at D 128).
//   * issued FLOPs: every key of every active block, causal or not: 4 D a
//     (row, key) pair, the bound's count (which takes the causal half of a
//     diagonal block).
//   * what holds it: per 64 x 64 tile the two products are 256 tensor-core
//     cycles an SM at D 64 and its 4,096 EX2 256 MUFU cycles, but the
//     elementwise pass (about 5 instructions an element: max, FFMA, EX2,
//     sum, a share of the packing and the rescale; with dropout the hash
//     about 10 more) runs on two consumer warps a scheduler, whose
//     dependent chains it does not hide: each instruction an element
//     removed saved about three times its issue-slot share (PERF.md
//     §6).  One warpgroup's pass runs beside the other warpgroup's
//     products.

template <int D, int NC>
struct WgFwdS {
  static constexpr int THREADS = 128 * (NC + 1), MB = NC == 2 ? 1 : 2;
  static constexpr int ROWS = 64 * NC;               // q rows an item
  static constexpr int BK = 64 * NC;                 // keys a stage
  static constexpr int NDC = D / 64;                 // 64-column chunks
  static constexpr int KCHUNK = BK * 128;            // BK keys of one chunk
  static constexpr int KTILE = NDC * KCHUNK;         // BK keys of all D
  static constexpr int QCHUNK = ROWS * 128;
  static constexpr int QTILE = NDC * QCHUNK;
  static constexpr int QB = 2;                       // Q buffers
  static constexpr int STAGES = D == 128 ? 2 : 4;    // (K, V) stages
  static constexpr int STAGE = 2 * KTILE;
  static constexpr size_t SMEM = 1024 + QB * size_t(QTILE) +
                                 STAGES * size_t(STAGE) +
                                 8 * (2 * STAGES + 2 * QB);
  static constexpr int LAUNCH_REGS = (65536 / (THREADS * MB)) & ~7;
  static constexpr int CONSUMER_REGS =
      (((NC + 1) * LAUNCH_REGS - 24) / NC) & ~7;
};

template <typename T, int D, int NC>
__global__ void __launch_bounds__(WgFwdS<D, NC>::THREADS, WgFwdS<D, NC>::MB)
sparse_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        T* __restrict__ o, float* __restrict__ lse,
                        SParams p) {
  using LY = WgFwdS<D, NC>;
  constexpr int BK = LY::BK, NT = BK / 8;
  constexpr int KTILE = LY::KTILE, KCHUNK = LY::KCHUNK, NDC = LY::NDC;
  constexpr int QTILE = LY::QTILE, QCHUNK = LY::QCHUNK;
  constexpr int QB = LY::QB, STAGES = LY::STAGES;
  extern __shared__ unsigned char smraw[];
  // 1024-byte alignment for the swizzle atoms
  unsigned char* sQ = smraw + ((1024 - (smem_u32(smraw) & 1023)) & 1023);
  unsigned char* sKV = sQ + QB * QTILE;             // [STAGES][STAGE]: K, V
  uint64_t* full = reinterpret_cast<uint64_t*>(sKV + STAGES * LY::STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;                 // [QB]: Q buffer loaded
  uint64_t* qempty = qfull + QB;                    // [QB]: Q buffer free

  const int nq = p.S / LY::ROWS;
  const int n_items = p.BH * nq;
  // item w -> (bh, first q row); returns the q-block's forward-table row
  auto item = [&](int w, int& bh, int& q0) {
    bh = w / nq;
    q0 = (w % nq) * LY::ROWS;
    return table_row(p, bh, q0 / p.blk);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);   // one arrival per consumer warp
    }
    for (int b = 0; b < QB; ++b) {
      mbar_init(&qfull[b], 1);
      mbar_init(&qempty[b], 4 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NC) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * NC) {
      int it = 0;
      for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
        int bh, q0;
        const int* row = item(w, bh, q0);
        const int b = n % QB;
        mbar_wait(&qempty[b], ((n / QB) & 1) ^ 1);
        mbar_expect_tx(&qfull[b], QTILE);
        unsigned char* qb = sQ + b * QTILE;
        for (int c = 0; c < NDC; ++c)
          tma_load_3d(qb + c * QCHUNK, &tq, &qfull[b], 64 * c, q0, bh);
        for (int a = 0; a < p.W; ++a) {
          const int kj = row[a];
          if (kj < 0) break;
          for (int k0 = kj * p.blk; k0 < (kj + 1) * p.blk; k0 += BK, ++it) {
            const int s = it % STAGES;
            mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
            mbar_expect_tx(&full[s], 2 * KTILE);
            unsigned char* st = sKV + s * LY::STAGE;
            for (int c = 0; c < NDC; ++c) {
              tma_load_3d(st + c * KCHUNK, &tk, &full[s], 64 * c, k0, bh);
              tma_load_3d(st + KTILE + c * KCHUNK, &tv, &full[s], 64 * c, k0, bh);
            }
          }
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
  int ra, rb;
  uint32_t ha, hb;
  float acc[D / 2];
  float m_a, m_b, l_a, l_b;

  // The scores stay unscaled: scale > 0 commutes with the max (and with
  // its rounding), so s = scale (q.k) enters only through sl2 = scale
  // log2 e, p = 2^(q.k sl2 - m sl2), one FFMA and one EX2.  A tile that
  // crosses the diagonal takes the difference first, 2^((x - m) sl2) with
  // x = NEG_INF where masked: a row whose live keys are all masked so far
  // keeps p = 1 there, as the function does.
  const float sl2 = p.scale * LOG2E;
  // the online softmax of one BK-key tile, its scores `sc` in place ->
  // p * keep; EDGE: the tile crosses this warpgroup's causal diagonal;
  // DROP: dropout on
  auto softmax = [&](float* sc, int k0, auto edge_c, auto drop_c) {
    constexpr bool EDGE = decltype(edge_c)::value;
    constexpr bool DROP = decltype(drop_c)::value;
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = sc[4 * j + r];
        if constexpr (EDGE) {
          if ((r < 2 ? ra : rb) < k0 + 8 * j + 2 * t + (r & 1)) x = NEG_INF;
          sc[4 * j + r] = x;
        }
        if (r < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
      }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float ma2 = mn_a * sl2, mb2 = mn_b * sl2;
    // keep_scale's column term of key k0 + 2t; key k0 + 2t + 8j + e adds
    // (8j + e) times the multiplier (mod 2^32)
    const uint32_t hc = uint32_t(k0 + 2 * t) * 0xC2B2AE35u;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float pv;
        if constexpr (EDGE)
          pv = ex2((sc[4 * j + r] - (r < 2 ? mn_a : mn_b)) * sl2);
        else
          pv = ex2(fmaf(sc[4 * j + r], sl2, -(r < 2 ? ma2 : mb2)));
        if (r < 2) ps_a += pv; else ps_b += pv;
        if constexpr (DROP) {
          const uint32_t c = hc + uint32_t(8 * j + (r & 1)) * 0xC2B2AE35u;
          const uint32_t h = fmix32_tail((r < 2 ? ha : hb) ^ c ^ (c >> 15));
          pv *= h < p.thr ? p.inv_keep : 0.f;
        }
        sc[4 * j + r] = pv;
      }
    const float al_a = ex2((m_a - mn_a) * sl2);
    const float al_b = ex2((m_b - mn_b) * sl2);
    l_a = al_a * l_a + quad_sum(ps_a);
    l_b = al_b * l_b + quad_sum(ps_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= al_a;
      acc[4 * j + 1] *= al_a;
      acc[4 * j + 2] *= al_b;
      acc[4 * j + 3] *= al_b;
    }
  };

  int it = 0;
  for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
    int bh, q0;
    const int* row = item(w, bh, q0);
    const int b = n % QB;
    const int r0 = q0 + 64 * wg;                    // this warpgroup's rows
    ra = r0 + warp * 16 + g;
    rb = ra + 8;
    // keep_scale's row terms (flash_tiles.cuh), after fmix32's first step
    const uint32_t bhm = uint32_t(bh) * 0x7FEB352Du;
    ha = p.seed_h ^ bhm ^ (uint32_t(ra) * 0x85EBCA6Bu);
    hb = p.seed_h ^ bhm ^ (uint32_t(rb) * 0x85EBCA6Bu);
    ha ^= ha >> 15;
    hb ^= hb >> 15;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    m_a = m_b = NEG_INF;
    l_a = l_b = 0.f;
    const unsigned char* qt = sQ + b * QTILE + wg * 64 * 128;
    mbar_wait(&qfull[b], (n / QB) & 1);

    for (int a = 0; a < p.W; ++a) {
      const int kj = row[a];
      if (kj < 0) break;
      for (int k0 = kj * p.blk; k0 < (kj + 1) * p.blk; k0 += BK, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const unsigned char* kt = sKV + s * LY::STAGE;
        const unsigned char* vt = kt + KTILE;

        float sc[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<T, BK>::ss(
              sc, sw128_desc(qt + (kk >> 2) * QCHUNK + (kk & 3) * 32, 16, 1024),
              sw128_desc(kt + (kk >> 2) * KCHUNK + (kk & 3) * 32, 16, 1024),
              kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<BK / 2>(sc);

        const bool edge = p.causal && k0 + BK - 1 > r0;
        if (p.dropout) {
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
        // O += P.V, B the stage's V tile read MN-major (16 keys a slice)
        fence_regs<D / 2>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          Wgmma<T, D>::rs(acc, pa[kk],
                          sw128_desc(vt + kk * 16 * 128, KCHUNK, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<D / 2>(acc);
        // the stage's K and V have been read: hand it back
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }
    // the item's Q has been read
    __syncwarp();
    if (lane == 0) mbar_arrive(&qempty[b]);

    const float sa = l_a == 0.f ? 1.f : l_a, sb = l_b == 0.f ? 1.f : l_b;
    T* oh = o + size_t(bh) * p.S * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int cc = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(oh + size_t(ra) * D + cc) =
          Mma<T>::pack(acc[4 * j] / sa, acc[4 * j + 1] / sa);
      *reinterpret_cast<uint32_t*>(oh + size_t(rb) * D + cc) =
          Mma<T>::pack(acc[4 * j + 2] / sb, acc[4 * j + 3] / sb);
    }
    if (t == 0) {
      // the max in the function's units; NEG_INF (every live key masked)
      // stays NEG_INF, as the function's lse = NEG_INF + log l
      const float ms_a = m_a == NEG_INF ? NEG_INF : m_a * p.scale;
      const float ms_b = m_b == NEG_INF ? NEG_INF : m_b * p.scale;
      lse[size_t(bh) * p.S + ra] = l_a == 0.f ? NEG_INF : ms_a + logf(sa);
      lse[size_t(bh) * p.S + rb] = l_b == 0.f ? NEG_INF : ms_b + logf(sb);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Ptrs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o, *lse_out, *dq, *dk, *dv;
  const void* order;  // dK/dV's work order (null for the forward and dQ)
};

// the wgmma dK/dV (bf16, D 64, blk % 64 == 0) on a persistent grid of two
// CTAs an SM
cudaError_t launch_dkv_wgmma(const Ptrs& a, const SParams& p, cudaStream_t st) {
  using LY = WgDkv;
  using T = __nv_bfloat16;
  if (a.order == nullptr) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e;
  if ((e = tensor_map<T>(&tq, a.q, p.BH, p.S, 64, 64)) != cudaSuccess ||
      (e = tensor_map<T>(&tk, a.k, p.BH, p.S, 64, 64)) != cudaSuccess ||
      (e = tensor_map<T>(&tv, a.v, p.BH, p.S, 64, 64)) != cudaSuccess ||
      (e = tensor_map<T>(&tdo, a.dout, p.BH, p.S, 64, 64)) != cudaSuccess)
    return e;
  auto kern = sparse_dkv_wgmma_kernel;
  if ((e = set_smem(kern, LY::SMEM)) != cudaSuccess) return e;
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return e;
  const int items = p.BH * p.nb * (p.blk / 64);
  kern<<<min(items, sms * LY::MB), LY::THREADS, LY::SMEM, st>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.order),
      p.BH / p.H, static_cast<T*>(a.dk), static_cast<T*>(a.dv), p);
  return cudaGetLastError();
}

// the wgmma dQ (bf16 / fp16, D 64 / 128, blk % 64 == 0) on a persistent
// grid of MB CTAs an SM
template <typename T, int D>
cudaError_t launch_dq_wgmma(const Ptrs& a, const SParams& p, cudaStream_t st) {
  using LY = WgDq<D>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e;
  if ((e = tensor_map<T>(&tq, a.q, p.BH, p.S, D, 64)) != cudaSuccess ||
      (e = tensor_map<T>(&tk, a.k, p.BH, p.S, D, 64)) != cudaSuccess ||
      (e = tensor_map<T>(&tv, a.v, p.BH, p.S, D, 64)) != cudaSuccess ||
      (e = tensor_map<T>(&tdo, a.dout, p.BH, p.S, D, 64)) != cudaSuccess)
    return e;
  auto kern = sparse_dq_wgmma_kernel<T, D>;
  if ((e = set_smem(kern, LY::SMEM)) != cudaSuccess) return e;
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return e;
  const int items = p.BH * (p.S / 64);
  kern<<<min(items, sms * LY::MB), LY::THREADS, LY::SMEM, st>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), p);
  return cudaGetLastError();
}

// the wgmma forward (bf16 / fp16, D 64 / 128, blk % 64 == 0): NC = 2
// consumer warpgroups sharing each (K, V) stage where the block is a
// multiple of 128, one CTA an SM; else NC = 1, two CTAs an SM
template <typename T, int D, int NC>
cudaError_t launch_fwd_wgmma_nc(const Ptrs& a, const SParams& p,
                                cudaStream_t st) {
  using LY = WgFwdS<D, NC>;
  CUtensorMap tq, tk, tv;
  cudaError_t e;
  if ((e = tensor_map<T>(&tq, a.q, p.BH, p.S, D, LY::ROWS)) != cudaSuccess ||
      (e = tensor_map<T>(&tk, a.k, p.BH, p.S, D, LY::BK)) != cudaSuccess ||
      (e = tensor_map<T>(&tv, a.v, p.BH, p.S, D, LY::BK)) != cudaSuccess)
    return e;
  auto kern = sparse_fwd_wgmma_kernel<T, D, NC>;
  if ((e = set_smem(kern, LY::SMEM)) != cudaSuccess) return e;
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return e;
  const int items = p.BH * (p.S / LY::ROWS);
  kern<<<min(items, sms * LY::MB), LY::THREADS, LY::SMEM, st>>>(
      tq, tk, tv, static_cast<T*>(a.o), static_cast<float*>(a.lse_out), p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_fwd_wgmma(const Ptrs& a, const SParams& p, cudaStream_t st) {
  return p.blk % 128 == 0 ? launch_fwd_wgmma_nc<T, D, 2>(a, p, st)
                          : launch_fwd_wgmma_nc<T, D, 1>(a, p, st);
}

// 1: the wgmma forward and dQ take these operands (bf16 / fp16, D 64 or
// 128, a layout block that is a multiple of 64); 0: the mma.sync kernels
// (other bf16 / fp16), 2: the CUDA-core kernels (fp32)
int wgmma_route_of(int dtype, int D, int blk) {
  if (dtype == 0) return 2;
  return (dtype == 1 || dtype == 2) && (D == 64 || D == 128) && blk > 0 &&
                 blk % 64 == 0
             ? 1
             : 0;
}

// Which kernel runs, chosen at compile time so that each is instantiated
// only for the dtypes that reach it (as in flash_attention.cu).  C is the
// row tile (64 for a layout block that is a multiple of 64, walked as
// blk / 64 tiles of one table row, else 16); CK the key tile of dQ, of the
// fp32 forward and (at D = 256) of the mma.sync forward, halved to 32 at
// D >= 128 where registers or shared memory would not fit (the mma.sync
// forward at C = 16 stages C keys); CKV the key rows of the CUDA-core
// dK/dV, 16 at D = 256 for its shared memory.  The wgmma forward and dQ
// take bf16 / fp16 at C = 64 and D 64 / 128 (`wgmma_route_of`), the wgmma
// dK/dV bf16 at C = 64 and D 64.
template <typename T, int D, int C>
cudaError_t launch(int which, const Ptrs& a, const SParams& p, cudaStream_t st) {
  constexpr bool mma = !std::is_same<T, float>::value;
  constexpr bool mma_dkv = std::is_same<T, __nv_bfloat16>::value && D == 64;
  constexpr int CK = (D >= 128 && C > 32) ? 32 : C;
  constexpr int CKF = D == 256 ? CK : C;
  constexpr int CKV = D == 256 ? 16 : CK;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  const dim3 rows(p.S / C, p.BH);
  cudaError_t e;
  if (which == 0) {
    if constexpr (mma && C == 64 && D <= 128) {
      return launch_fwd_wgmma<T, D>(a, p, st);
    } else if constexpr (mma) {
      auto kern = sparse_fwd_mma_kernel<T, D, C, CKF>;
      const size_t smem = MmaLayout<T, D, CKF>::FWD_SMEM;
      if ((e = set_smem(kern, smem)) != cudaSuccess) return e;
      kern<<<rows, THREADS, smem, st>>>(q, k, v, static_cast<T*>(a.o),
                                        static_cast<float*>(a.lse_out), p);
    } else {
      auto kern = sparse_fwd_kernel<T, D, C, CK>;
      const size_t smem = FwdLayout<D, C, CK>::SMEM;
      if ((e = set_smem(kern, smem)) != cudaSuccess) return e;
      kern<<<rows, THREADS, smem, st>>>(q, k, v, static_cast<T*>(a.o),
                                        static_cast<float*>(a.lse_out), p);
    }
  } else if (which == 1) {
    if constexpr (mma && C == 64 && D <= 128) {
      return launch_dq_wgmma<T, D>(a, p, st);
    } else if constexpr (mma) {
      auto kern = sparse_dq_mma_kernel<T, D, C, CK>;
      const size_t smem = MmaLayout<T, D, CK>::DQ_SMEM;
      if ((e = set_smem(kern, smem)) != cudaSuccess) return e;
      kern<<<rows, THREADS, smem, st>>>(q, k, v, dout, lse, delta,
                                        static_cast<T*>(a.dq), p);
    } else {
      auto kern = sparse_dq_kernel<T, D, C, CK>;
      const size_t smem = DqLayout<D, C, CK>::SMEM;
      if ((e = set_smem(kern, smem)) != cudaSuccess) return e;
      kern<<<rows, THREADS, smem, st>>>(q, k, v, dout, lse, delta,
                                        static_cast<T*>(a.dq), p);
    }
  } else {
    if constexpr (mma_dkv && C == 64) {
      return launch_dkv_wgmma(a, p, st);
    } else if constexpr (mma_dkv) {
      auto kern = sparse_dkv_mma_kernel<D, C>;
      const size_t smem = DkvMmaLayout<D, C>::BYTES;
      if ((e = set_smem(kern, smem)) != cudaSuccess) return e;
      kern<<<rows, THREADS, smem, st>>>(q, k, v, dout, lse, delta,
                                        static_cast<T*>(a.dk),
                                        static_cast<T*>(a.dv), p);
    } else {
      auto kern = sparse_dkv_kernel<T, D, CKV, C>;
      const size_t smem = DkvLayout<D, CKV, C>::SMEM;
      if ((e = set_smem(kern, smem)) != cudaSuccess) return e;
      kern<<<dim3(p.S / CKV, p.BH), THREADS, smem, st>>>(
          q, k, v, dout, lse, delta, static_cast<T*>(a.dk),
          static_cast<T*>(a.dv), p);
    }
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(int which, int D, const Ptrs& a, const SParams& p,
                     cudaStream_t st) {
  const bool wide = p.blk % 64 == 0;
  if (D == 64)
    return wide ? launch<T, 64, 64>(which, a, p, st)
                : launch<T, 64, 16>(which, a, p, st);
  if (D == 128)
    return wide ? launch<T, 128, 64>(which, a, p, st)
                : launch<T, 128, 16>(which, a, p, st);
  if (D == 256)
    return wide ? launch<T, 256, 64>(which, a, p, st)
                : launch<T, 256, 16>(which, a, p, st);
  return cudaErrorInvalidValue;
}

int run(int which, const Ptrs& a, const void* tbl, int BH, int H, int S,
        int D, int blk, int W, float scale, int causal, int seed, unsigned thr,
        float inv_keep, int dropout, int dtype, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not an older one
  if (BH <= 0 || H <= 0 || BH % H || BH > 65535 || blk <= 0 || blk % 16 ||
      S <= 0 || S % blk || W <= 0 || tbl == nullptr)
    return cudaErrorInvalidValue;
  const SParams p{BH, H, S, S / blk, blk, W, scale, causal,
                  static_cast<const int*>(tbl), uint32_t(seed) * 0x9E3779B1u,
                  thr, inv_keep, dropout};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_t<float>(which, D, a, p, st);
    case 1: return launch_t<__nv_bfloat16>(which, D, a, p, st);
    case 2: return launch_t<__half>(which, D, a, p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// All tensors contiguous, on one device, 16-byte aligned: q, k, v, dout
// [BH, S, D] in one dtype (0 = float32, 1 = bfloat16, 2 = float16); lse,
// delta [BH, S] fp32; tbl int32 [H, S / blk, W]: the forward table for fwd
// and dq, the reverse table for dkv.  seed: the dropout hash's int32 seed;
// thr and inv_keep: keep_threshold(rate) and fp32(1 / (1 - rate)); dropout = 0
// turns the mask off.  Each returns the cudaError_t of the launch (0 on
// success); the caller raises on anything else.

int flash_sparse_fwd(const void* q, const void* k, const void* v,
                     const void* tbl, void* o, void* lse, int BH, int H, int S,
                     int D, int blk, int W, float scale, int causal, int seed,
                     unsigned thr, float inv_keep, int dropout, int dtype,
                     void* stream) {
  Ptrs a{q, k, v, nullptr, nullptr, nullptr, o, lse, nullptr, nullptr, nullptr,
         nullptr};
  return run(0, a, tbl, BH, H, S, D, blk, W, scale, causal, seed, thr,
             inv_keep, dropout, dtype, stream);
}

int flash_sparse_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    const void* tbl, void* dq, int BH, int H, int S, int D,
                    int blk, int W, float scale, int causal, int seed,
                    unsigned thr, float inv_keep, int dropout, int dtype,
                    void* stream) {
  Ptrs a{q, k, v, dout, lse, delta, nullptr, nullptr, dq, nullptr, nullptr,
         nullptr};
  return run(1, a, tbl, BH, H, S, D, blk, W, scale, causal, seed, thr,
             inv_keep, dropout, dtype, stream);
}

// the kernel flash_sparse_fwd / flash_sparse_dq launches for these
// operands: 1 = the wgmma kernel, 0 = the mma.sync kernel (sparse_fwd_mma_kernel,
// sparse_dq_mma_kernel), 2 = the CUDA-core kernel
int flash_sparse_fwd_route(int dtype, int D, int blk) {
  return wgmma_route_of(dtype, D, blk);
}

int flash_sparse_dq_route(int dtype, int D, int blk) {
  return wgmma_route_of(dtype, D, blk);
}

// order: int32 [H * S / blk], the (head, k-block) pairs heaviest walk
// first (`dkv_work_order`); every caller passes it, the bf16 D-64 kernel
// for blocks a multiple of 64 reads it and the others ignore it
int flash_sparse_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* tbl, const void* order, void* dk, void* dv,
                     int BH, int H, int S, int D, int blk, int W, float scale,
                     int causal, int seed, unsigned thr, float inv_keep,
                     int dropout, int dtype, void* stream) {
  Ptrs a{q, k, v, dout, lse, delta, nullptr, nullptr, nullptr, dk, dv, order};
  return run(2, a, tbl, BH, H, S, D, blk, W, scale, causal, seed, thr,
             inv_keep, dropout, dtype, stream);
}

const char* flash_sparse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Fused LM-head projection + softmax cross-entropy, written for Hopper (sm_90a).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/transformer/fused_xent.py:
//   fused_xent_fwd  <- `_fwd_kernel` (:52, pallas_call :86)
//   fused_xent_dx   <- `_dx_kernel`  (:127, pallas_call :172)
//   fused_xent_dw   <- `_dw_kernel`  (:145, pallas_call :189)
// and computes what their plain PyTorch versions compute
// (deepspeed_tpu_torch/ops/transformer/fused_xent.py `_fwd_plain`,
// `_dx_plain`, `_dw_plain`) for x [N, D] and the head weight W [D, V] in
// fp32, bf16 or fp16, without ever writing the [N, V] logits:
//   fwd: lse[r] = logsumexp_v (x[r].W[:, v]), ll[r] = x[r].W[:, label[r]]
//        (online max / sum over vocab tiles, started at NEG_INF and 0, the
//        label logit summed through the one-hot);
//   dx:  dx[r] = g * sum_v dl'[r, v] W[:, v]
//   dW:  dW[:, v] = g * sum_r dl'[r, v] x[r]
//   with dl' = valid[r] * (exp(x[r].W[:, v] - lse[r]) - [v == label[r]]),
//   re-formed tile by tile from the saved lse.  The function's
//   dl = (p - onehot) * coef with coef = g * valid (:169) is dl' * g; the
//   kernels multiply by the scalar g once, in fp32, at the end.
// W is read where it lies: the tied head is the transposed view of the
// [V, D] embedding (element (v, d) at v * D + d), an untied head a [D, V]
// matrix (element (v, d) at d * V + v); the caller passes the two strides.
// dW is written as dW^T, [V, D] row-major, which is the embedding's own
// layout (the caller hands autograd its transposed view).
//
// What bounds it on this card: operations.  Each product is 2 N D V FLOPs
// (633 GFLOP at the GPT-2 small training shape N = 8192, D = 768,
// V = 50304): the forward does one, dx and dW two each (the recomputed
// logits and the gradient product), 0.64 + 1.28 + 1.28 ms at the 989
// TFLOP/s bf16 peak, against ~10 MB of inputs.  The design keeps the logits
// in registers and every operand tile in shared memory, and does the
// products on the tensor cores:
//   * bf16 / fp16: mma.sync m16n8k16 with fp32 accumulators; the products of
//     two bf16 (or fp16) values are exact in fp32, as the reference's
//     preferred_element_type=float32 is.  fp32 inputs (the train-exact
//     check) take the same tiles with fp32 FMAs on the CUDA cores.
//   * fwd: a block of 4 warps owns 64 rows, each warp 16, and sweeps a
//     share of the vocab in tiles of 64 (the loop takes the place of the
//     TPU's sequential grid axis); x and W are staged in 64-wide chunks of
//     D, so any D works at the same shared-memory size.  Per row it keeps
//     (max, sum, label logit) in registers.  The vocab is split over VS
//     blocks per row block (grid.y), so that enough blocks are resident to
//     hide the staging loads: each writes its partial (max, sum, label
//     logit), and the last of the VS to finish (a ticket per row block)
//     merges them in split order — a fixed order, so the result does not
//     depend on which block finished last — and writes lse and ll.
//   * dx and dW are one kernel over two roles.  A block owns R = 16 or 32
//     resident rows (tokens for dx, vocab entries for dW) with all D
//     columns in shared memory, and streams tiles of BS = 32 rows (16 for
//     fp32, so that both tiles fit shared memory up to D = 1600) of the
//     other operand (W rows for dx, x rows for dW), also with all D columns.
//     Per tile, 8 warps form the R x BS logits (split over D in 1024 / (R BS)
//     parts where that is more than one, summed in a fixed order; each
//     warp's 16 x 8 over four independent accumulators, so its mma do not
//     wait on one another), turn them into dl' in registers and round it
//     once to the input dtype in shared memory, then accumulate
//     dl'.tile into the block's [R, D] fp32 accumulator, each warp owning
//     every 8th 8-column slice of D in registers (ldmatrix.trans reads the
//     tile's columns as the mma's B operand).  The accumulator lives in
//     registers for the whole sweep: no atomics, a fixed summation order,
//     deterministic results.  R = 32 for D <= 768 (12 slices a warp), 16 up
//     to D = 1600 (25).  Where two streamed tiles fit shared memory and
//     their rows are contiguous (bf16/fp16, the tied head's W rows or x),
//     tile i + 1 is copied in with cp.async while tile i is computed on.
//   * dl' is fp32 in the reference (:121-124).  Here it is rounded once to
//     the input dtype before the second product (relative error at most u,
//     the unit roundoff; for fp16 also an absolute 2^-25 below fp16's
//     normal range, since |dl'| <= 1): one mma instead of three for the
//     hi/mid/lo split of flash dK/dV, which would triple the second
//     product's cost.  kernels/fused_xent.py `kernel_tolerances` states the
//     resulting per-element bound.  fp32 inputs keep dl' in fp32.
// Left to later work: pipelining the forward's chunks and the fp32 path,
// wgmma, and larger resident tiles (the W and x tiles are re-read from L2
// by every block: 19.8 GB of L2 traffic per backward kernel at the GPT-2
// shape); dx at small N (1024 rows at D = 1600 make 64 blocks) leaves SMs
// idle, and a split of its vocab sweep would fill them.

#include <type_traits>

#include "common.cuh"

namespace {

// B fragments of a 16 x 8 tile whose rows (the k index) are 16 consecutive
// shared-memory rows and whose columns are 8 consecutive elements of each:
// two 8 x 8 matrices loaded transposed (lanes 0-7 address the first 8 rows,
// lanes 8-15 the next 8)
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1,
                                              const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(s));
}

// element (row, d) of an operand at src[row * s_row + d * s_col]
struct View {
  const void* p;
  long long s_row, s_col;
};

// rows [row0, row0 + count) x columns [d0, d0 + dk) of `src` -> dst (row
// stride ld elements); zero past nrows.  Contiguous rows move as 16-byte
// vectors; a transposed view (s_col != 1) element by element, neighbouring
// threads on neighbouring rows (its unit-stride axis).
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, View v, int row0,
                                      int nrows, int count, int d0, int dk) {
  const T* src = static_cast<const T*>(v.p);
  if (v.s_col == 1) {
    constexpr int VEC = 16 / sizeof(T);
    const int vpr = dk / VEC;
    for (int i = threadIdx.x; i < count * vpr; i += blockDim.x) {
      const int rr = i / vpr, cc = (i % vpr) * VEC;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (row0 + rr < nrows)
        raw = *reinterpret_cast<const uint4*>(src + (row0 + rr) * v.s_row + d0 + cc);
      T* d = dst + size_t(rr) * ld + cc;
      if constexpr (std::is_same<T, float>::value) {
        // fp32 rows are padded by one word: 4-byte stores
        const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) d[j] = e[j];
      } else {
        *reinterpret_cast<uint4*>(d) = raw;
      }
    }
  } else {
    for (int i = threadIdx.x; i < count * dk; i += blockDim.x) {
      const int rr = i % count, cc = i / count;
      dst[size_t(rr) * ld + cc] =
          row0 + rr < nrows ? src[(row0 + rr) * v.s_row + (d0 + cc) * v.s_col]
                            : from_f<T>(0.f);
    }
  }
}

// `stage` for 16-bit contiguous rows of all D columns, as 16-byte cp.async
// copies that land while the block computes (dst rows 16-byte aligned)
template <typename T>
__device__ __forceinline__ void stage_async(T* dst, int ld, View v, int row0,
                                            int nrows, int count, int D) {
  const T* src = static_cast<const T*>(v.p);
  constexpr int VEC = 16 / sizeof(T);
  const int vpr = D / VEC;
  for (int i = threadIdx.x; i < count * vpr; i += blockDim.x) {
    const int rr = i / vpr, cc = (i % vpr) * VEC;
    const bool in = row0 + rr < nrows;
    cp_async16(dst + size_t(rr) * ld + cc,
               in ? src + (row0 + rr) * v.s_row + cc : src, in ? 16 : 0);
  }
}

// c += A . B for one 16 x 8 tile over k in [kbeg, kend) (a multiple of 16),
// on the tensor cores with four independent accumulators over the k steps,
// so that consecutive mma do not wait on one another; summed in a fixed
// order at the end
template <typename T>
__device__ __forceinline__ void unit_scores(float* c, const T* sA, int lda,
                                            const T* sB, int ldb, int kbeg,
                                            int kend, int g, int t) {
  float acc[4][4] = {};
  auto step = [&](float* a_c, int k0) {
    const T* ar = sA + g * lda + k0 + 2 * t;
    const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * lda), ld32(ar + 8),
                           ld32(ar + 8 * lda + 8)};
    const T* br = sB + g * ldb + k0 + 2 * t;
    Mma<T>::run(a_c, a, ld32(br), ld32(br + 8));
  };
  int k0 = kbeg;
  for (; k0 + 64 <= kend; k0 += 64) {
    step(acc[0], k0);
    step(acc[1], k0 + 16);
    step(acc[2], k0 + 32);
    step(acc[3], k0 + 48);
  }
  for (; k0 < kend; k0 += 16) step(acc[0], k0);
#pragma unroll
  for (int j = 0; j < 4; ++j) c[j] += (acc[0][j] + acc[1][j]) + (acc[2][j] + acc[3][j]);
}

// c[nt] (16 x 8 each) += A . B over k in [kbeg, kend): A rows [0, 16) of sA
// (row stride lda), B[k][n] = sB[n * ldb + k] for n in [0, 8 NT)
template <typename T, int NT>
__device__ __forceinline__ void tile_scores(float (*c)[4], const T* sA, int lda,
                                            const T* sB, int ldb, int kbeg,
                                            int kend, int g, int t) {
  if constexpr (std::is_same<T, float>::value) {
    const float* a0 = sA + g * lda;
    const float* a1 = a0 + 8 * lda;
#pragma unroll 4
    for (int k = kbeg; k < kend; ++k) {
      const float x0 = a0[k], x1 = a1[k];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float y0 = sB[(nt * 8 + 2 * t) * ldb + k];
        const float y1 = sB[(nt * 8 + 2 * t + 1) * ldb + k];
        c[nt][0] = fmaf(x0, y0, c[nt][0]);
        c[nt][1] = fmaf(x0, y1, c[nt][1]);
        c[nt][2] = fmaf(x1, y0, c[nt][2]);
        c[nt][3] = fmaf(x1, y1, c[nt][3]);
      }
    }
  } else {
    for (int k0 = kbeg; k0 < kend; k0 += 16) {
      const T* ar = sA + g * lda + k0 + 2 * t;
      const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * lda), ld32(ar + 8),
                             ld32(ar + 8 * lda + 8)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const T* br = sB + (nt * 8 + g) * ldb + k0 + 2 * t;
        Mma<T>::run(c[nt], a, ld32(br), ld32(br + 8));
      }
    }
  }
}

template <typename T> struct Pad {
  // fp32 rows: one word (conflict-free scalar reads); 16-bit rows: 16
  // bytes (16-byte aligned rows, conflict-free fragment and ldmatrix reads)
  static constexpr int P = std::is_same<T, float>::value ? 1 : 8;
};

// ---------------------------------------------------------------------------
// forward: one block of 4 warps per 64 rows, sweeping the vocab
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(128)
fx_fwd_kernel(View x, View w, const int64_t* __restrict__ labels,
              float* __restrict__ lse, float* __restrict__ ll,
              float* __restrict__ part, int* __restrict__ tickets, int N,
              int D, int V, int VS) {
  constexpr int BR = 64, BV = 64, DK = 64, LD = DK + Pad<T>::P;
  __shared__ __align__(16) T sX[BR * LD];
  __shared__ __align__(16) T sW[BV * LD];
  __shared__ int s_last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * BR;
  // this block's share of the vocab tiles
  const int vs = blockIdx.y, n_tiles = (V + BV - 1) / BV;
  const int tile0 = int((long long)vs * n_tiles / VS);
  const int tile1 = int((long long)(vs + 1) * n_tiles / VS);
  const int ra = r0 + warp * 16 + g, rb = ra + 8;
  const long long lab_a = ra < N ? labels[ra] : -1;
  const long long lab_b = rb < N ? labels[rb] : -1;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f, ll_a = 0.f, ll_b = 0.f;

  for (int v0 = tile0 * BV; v0 < tile1 * BV; v0 += BV) {
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    for (int d0 = 0; d0 < D; d0 += DK) {
      __syncthreads();
      stage<T>(sX, LD, x, r0, N, BR, d0, DK);
      stage<T>(sW, LD, w, v0, V, BV, d0, DK);
      __syncthreads();
      tile_scores<T, 8>(s, sX + warp * 16 * LD, LD, sW, LD, 0, DK, g, t);
    }
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int v = v0 + nt * 8 + 2 * t + i;
        if (v < V) {
          mx_a = fmaxf(mx_a, s[nt][i]);
          mx_b = fmaxf(mx_b, s[nt][2 + i]);
          if (v == lab_a) ll_a += s[nt][i];
          if (v == lab_b) ll_b += s[nt][2 + i];
        }
      }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (v0 + nt * 8 + 2 * t + i < V) {
          ps_a += expf(s[nt][i] - mn_a);
          ps_b += expf(s[nt][2 + i] - mn_b);
        }
    l_a = l_a * expf(m_a - mn_a) + quad_sum(ps_a);
    l_b = l_b * expf(m_b - mn_b) + quad_sum(ps_b);
    m_a = mn_a;
    m_b = mn_b;
  }
  // the label logit sits in one lane of the quad (the others hold 0)
  ll_a = quad_sum(ll_a);
  ll_b = quad_sum(ll_b);
  // part: [3][VS][N] partial (max, sum, label logit) of each split
  float* pm = part;
  float* pl = part + size_t(VS) * N;
  float* pll = part + 2 * size_t(VS) * N;
  if (t == 0) {
    if (ra < N) {
      pm[size_t(vs) * N + ra] = m_a;
      pl[size_t(vs) * N + ra] = l_a;
      pll[size_t(vs) * N + ra] = ll_a;
    }
    if (rb < N) {
      pm[size_t(vs) * N + rb] = m_b;
      pl[size_t(vs) * N + rb] = l_b;
      pll[size_t(vs) * N + rb] = ll_b;
    }
  }
  __threadfence();  // the partials are visible before the ticket is taken
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&tickets[blockIdx.x], 1) == VS - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int r = threadIdx.x; r < BR; r += blockDim.x) {
    const int row = r0 + r;
    if (row >= N) continue;
    float m = NEG_INF, l = 0.f, lab = 0.f;
    for (int k = 0; k < VS; ++k) {
      const size_t i = size_t(k) * N + row;
      const float mk = __ldcg(pm + i), lk = __ldcg(pl + i);
      const float mn = fmaxf(m, mk);
      l = l * expf(m - mn) + lk * expf(mk - mn);
      m = mn;
      lab += __ldcg(pll + i);
    }
    lse[row] = m + logf(l);
    ll[row] = lab;
  }
}

// ---------------------------------------------------------------------------
// dx (DW = false) and dW^T (DW = true): one block of 8 warps per R resident
// rows, streaming tiles of BS rows of the other operand
// ---------------------------------------------------------------------------

constexpr int BWD_THREADS = 256;

template <typename T, int RT, bool DW, bool DB>
struct BwdLayout {
  // streamed rows per tile: 32, and 16 for fp32, whose resident and
  // streamed tiles of all D columns then fit shared memory up to D = 1600
  static constexpr int BS = std::is_same<T, float>::value ? 16 : 32;
  static constexpr int R = 16 * RT;          // resident rows
  static constexpr int UNITS = RT * BS / 8;  // 16 x 8 logits tiles per tile
  static constexpr int KS = 8 / UNITS;       // warps per logits tile (split of D)
  static constexpr int NTW = RT == 2 ? 12 : 25;  // max 8-column slices a warp
  static constexpr int LDL = BS + Pad<T>::P;
  static constexpr int SR = DW ? BS : R;     // rows whose (lse, valid, label) are staged
  static constexpr int QBUF = DB ? 2 : 1;    // streamed-tile buffers
  static size_t bytes(int D) {
    const int ld = D + Pad<T>::P;
    return (size_t(R + QBUF * BS) * ld + size_t(R) * LDL) * sizeof(T) +
           (size_t(KS - 1) * UNITS * 32 * 4 + 2 * SR) * sizeof(float) +
           SR * sizeof(int);
  }
};

template <typename T, int RT, bool DW, bool DB>
__global__ void __launch_bounds__(BWD_THREADS)
fx_bwd_kernel(View x, View w, const int64_t* __restrict__ labels,
              const float* __restrict__ lse, const uint8_t* __restrict__ valid,
              const float* __restrict__ gp, T* __restrict__ out, int N, int D,
              int V) {
  using LY = BwdLayout<T, RT, DW, DB>;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int BS = LY::BS, R = LY::R, UNITS = LY::UNITS, KS = LY::KS;
  constexpr int NTW = LY::NTW, LDL = LY::LDL, SR = LY::SR;
  const int ld = D + Pad<T>::P;
  extern __shared__ __align__(16) unsigned char smraw[];
  T* sP = reinterpret_cast<T*>(smraw);   // resident rows [R][ld]
  T* sQ0 = sP + size_t(R) * ld;          // streamed tile(s) [QBUF][BS][ld]
  T* sDL = sQ0 + size_t(LY::QBUF) * BS * ld;  // dl' [R][LDL], rows resident
  float* sRed = reinterpret_cast<float*>(sDL + R * LDL);  // [KS-1][UNITS][32][4]
  float* sLse = sRed + (KS - 1) * UNITS * 32 * 4;  // [SR]
  float* sVal = sLse + SR;               // [SR]
  int* sLab = reinterpret_cast<int*>(sVal + SR);  // [SR]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int p0 = blockIdx.x * R;
  const View P = DW ? w : x, Q = DW ? x : w;
  const int np = DW ? V : N, nq = DW ? N : V;
  const int ntw = D / 64;  // this warp's 8-column slices: warp + 8 i

  auto stage_stats = [&](int row0, int count) {
    for (int i = threadIdx.x; i < count; i += BWD_THREADS) {
      const int r = row0 + i;
      const bool in = r < N;
      sLse[i] = in ? lse[r] : 0.f;
      sVal[i] = in && valid[r] ? 1.f : 0.f;
      sLab[i] = in ? int(labels[r]) : -1;
    }
  };

  stage<T>(sP, ld, P, p0, np, R, 0, D);
  if (!DW) stage_stats(p0, R);

  float acc[RT][NTW][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int i = 0; i < NTW; ++i) acc[rt][i][0] = acc[rt][i][1] = acc[rt][i][2] = acc[rt][i][3] = 0.f;

  const int u = warp % UNITS, ks = warp / UNITS;
  const int rt1 = u / (BS / 8), nt1 = u % (BS / 8);
  const int kbeg = ks * (D / KS), kend = kbeg + D / KS;

  // DB: tile i + 1 is copied in (cp.async) while tile i is computed on
  if constexpr (DB) {
    stage_async<T>(sQ0, ld, Q, 0, nq, BS, D);
    cp_async_commit();
  }
  for (int q0 = 0, it = 0; q0 < nq; q0 += BS, ++it) {
    T* sQ = sQ0 + size_t(DB ? (it & 1) : 0) * BS * ld;
    __syncthreads();  // the previous tile's products are done with its
                      // buffer (the one refilled next) and with sDL
    if constexpr (DB) {
      if (q0 + BS < nq) {
        stage_async<T>(sQ0 + size_t((it + 1) & 1) * BS * ld, ld, Q, q0 + BS,
                       nq, BS, D);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      stage<T>(sQ, ld, Q, q0, nq, BS, 0, D);
    }
    if (DW) stage_stats(q0, BS);
    __syncthreads();

    // the logits of this warp's 16 x 8 tile, over its part of D
    float c[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    if constexpr (F32)
      tile_scores<T, 1>(c, sP + rt1 * 16 * ld, ld, sQ + nt1 * 8 * ld, ld,
                        kbeg, kend, g, t);
    else
      unit_scores<T>(c[0], sP + rt1 * 16 * ld, ld, sQ + nt1 * 8 * ld, ld,
                     kbeg, kend, g, t);
    if constexpr (KS > 1) {
      // the D parts of each logits tile, summed in part order by ks = 0
      if (ks > 0) {
        float* red = sRed + (((ks - 1) * UNITS + u) * 32 + lane) * 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) red[i] = c[0][i];
      }
      __syncthreads();
      if (ks == 0) {
#pragma unroll
        for (int k = 1; k < KS; ++k) {
          const float* red = sRed + (((k - 1) * UNITS + u) * 32 + lane) * 4;
#pragma unroll
          for (int i = 0; i < 4; ++i) c[0][i] += red[i];
        }
      }
    }
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pr = rt1 * 16 + g + (i >= 2 ? 8 : 0);  // resident row
        const int qc = nt1 * 8 + 2 * t + (i & 1);        // streamed row
        // token stats by the token's row: streamed for dW, resident for dx
        const int si = DW ? qc : pr;
        const int vocab = DW ? p0 + pr : q0 + qc;
        const bool live = DW ? q0 + qc < N : vocab < V;
        float d = 0.f;
        if (live && sVal[si] != 0.f)
          d = expf(c[0][i] - sLse[si]) - (sLab[si] == vocab ? 1.f : 0.f);
        sDL[pr * LDL + qc] = from_f<T>(d);
      }
    }
    __syncthreads();

    // acc[R, D] += dl' [R, BS] . tile [BS, D], this warp's column slices
    if constexpr (F32) {
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        if (i < ntw) {
          const int col = 8 * (warp + 8 * i) + 2 * t;
#pragma unroll 4
          for (int k = 0; k < BS; ++k) {
            const float y0 = sQ[k * ld + col], y1 = sQ[k * ld + col + 1];
#pragma unroll
            for (int rt = 0; rt < RT; ++rt) {
              const float x0 = sDL[(rt * 16 + g) * LDL + k];
              const float x1 = sDL[(rt * 16 + g + 8) * LDL + k];
              acc[rt][i][0] = fmaf(x0, y0, acc[rt][i][0]);
              acc[rt][i][1] = fmaf(x0, y1, acc[rt][i][1]);
              acc[rt][i][2] = fmaf(x1, y0, acc[rt][i][2]);
              acc[rt][i][3] = fmaf(x1, y1, acc[rt][i][3]);
            }
          }
        }
      }
    } else {
      uint32_t a[RT][BS / 16][4];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int kk = 0; kk < BS / 16; ++kk) {
          const T* ar = sDL + (rt * 16 + g) * LDL + kk * 16 + 2 * t;
          a[rt][kk][0] = ld32(ar);
          a[rt][kk][1] = ld32(ar + 8 * LDL);
          a[rt][kk][2] = ld32(ar + 8);
          a[rt][kk][3] = ld32(ar + 8 * LDL + 8);
        }
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        if (i < ntw) {
          const int col0 = 8 * (warp + 8 * i);
#pragma unroll
          for (int kk = 0; kk < BS / 16; ++kk) {
            uint32_t b0, b1;
            ldsm_x2_trans(b0, b1, sQ + (kk * 16 + (lane & 15)) * ld + col0);
#pragma unroll
            for (int rt = 0; rt < RT; ++rt) Mma<T>::run(acc[rt][i], a[rt][kk], b0, b1);
          }
        }
      }
    }
  }

  const float gs = *gp;
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      if (i < ntw) {
        const int col = 8 * (warp + 8 * i) + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = p0 + rt * 16 + g + 8 * h;
          if (row < np) {
            T* dst = out + size_t(row) * D + col;
            if constexpr (F32) {
              dst[0] = gs * acc[rt][i][2 * h];
              dst[1] = gs * acc[rt][i][2 * h + 1];
            } else {
              *reinterpret_cast<uint32_t*>(dst) =
                  Mma<T>::pack(gs * acc[rt][i][2 * h], gs * acc[rt][i][2 * h + 1]);
            }
          }
        }
      }
    }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  View x, w;
  const int64_t* labels;
  const float* lse;
  const uint8_t* valid;
  const float* g;
  void* out0;
  void* out1;
  float* part;
  int* tickets;
  int N, D, V, VS;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch_fwd(const Args& a) {
  if (a.VS < 1 || a.VS > 65535) return cudaErrorInvalidValue;
  dim3 grid((a.N + 63) / 64, a.VS);
  fx_fwd_kernel<T><<<grid, 128, 0, a.stream>>>(
      a.x, a.w, a.labels, static_cast<float*>(a.out0),
      static_cast<float*>(a.out1), a.part, a.tickets, a.N, a.D, a.V, a.VS);
  return cudaGetLastError();
}

template <typename T, int RT, bool DW, bool DB>
cudaError_t launch_bwd(const Args& a) {
  using LY = BwdLayout<T, RT, DW, DB>;
  auto kern = fx_bwd_kernel<T, RT, DW, DB>;
  const size_t smem = LY::bytes(a.D);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const int np = DW ? a.V : a.N;
  kern<<<(np + LY::R - 1) / LY::R, BWD_THREADS, smem, a.stream>>>(
      a.x, a.w, a.labels, a.lse, a.valid, a.g, static_cast<T*>(a.out0), a.N,
      a.D, a.V);
  return cudaGetLastError();
}

// D up to 1600 for every dtype: fp32 tiles (16 resident and 16 streamed
// rows) fit shared memory to 1600; 16-bit R = 32 keeps 12 slices a warp in
// registers to 768, R = 16 keeps 25 to 1600
template <typename T, bool DW>
cudaError_t launch_bwd_rt(const Args& a) {
  if (a.D > 1600) return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, float>::value) {
    return launch_bwd<T, 1, DW, false>(a);
  } else {
    // the streamed tile double-buffers where its rows are contiguous (cp.async
    // copies whole 16-byte vectors) and two tiles fit shared memory
    const View& q = DW ? a.x : a.w;
    constexpr size_t SMEM_MAX = 232448;
    if (a.D <= 768)
      return q.s_col == 1 && BwdLayout<T, 2, DW, true>::bytes(a.D) <= SMEM_MAX
                 ? launch_bwd<T, 2, DW, true>(a)
                 : launch_bwd<T, 2, DW, false>(a);
    return q.s_col == 1 && BwdLayout<T, 1, DW, true>::bytes(a.D) <= SMEM_MAX
               ? launch_bwd<T, 1, DW, true>(a)
               : launch_bwd<T, 1, DW, false>(a);
  }
}

template <typename T>
cudaError_t launch_t(int which, const Args& a) {
  if (which == 0) return launch_fwd<T>(a);
  if (which == 1) return launch_bwd_rt<T, false>(a);
  return launch_bwd_rt<T, true>(a);
}

int run(int which, const void* x, const void* w, long long w_sv,
        long long w_sd, const void* labels, const void* lse,
        const void* valid, const void* g, void* out0, void* out1,
        void* part, void* tickets, int N, int D, int V, int VS, int dtype,
        void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not an older one
  if (N <= 0 || V <= 0 || D <= 0 || D % 64) return cudaErrorInvalidValue;
  const Args a{{x, D, 1}, {w, w_sv, w_sd},
               static_cast<const int64_t*>(labels),
               static_cast<const float*>(lse),
               static_cast<const uint8_t*>(valid),
               static_cast<const float*>(g), out0, out1,
               static_cast<float*>(part), static_cast<int*>(tickets), N, D,
               V, VS, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch_t<float>(which, a);
    case 1: return launch_t<__nv_bfloat16>(which, a);
    case 2: return launch_t<__half>(which, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x [N, D] contiguous; the head weight W [D, V] with element (v, d) at
// w[v * w_sv + d * w_sd] (w_sv = D, w_sd = 1 for the transposed view of a
// [V, D] embedding; w_sv = 1, w_sd = V for a contiguous [D, V]); x and W of
// one dtype (0 = float32, 1 = bfloat16, 2 = float16), 16-byte aligned;
// D % 64 == 0.  labels int64 [N]; lse fp32 [N]; valid bool (one byte) [N];
// g one fp32 (the upstream gradient).  Each returns the cudaError_t of the
// launch (0 on success); the caller raises on anything else.

// lse, ll [N] fp32; the vocab split over VS blocks per 64 rows, with
// part fp32 [3, VS, N] scratch and tickets int32 [ceil(N / 64)], zero
// before the launch
int fused_xent_fwd(const void* x, const void* w, long long w_sv,
                   long long w_sd, const void* labels, void* lse, void* ll,
                   void* part, void* tickets, int N, int D, int V, int VS,
                   int dtype, void* stream) {
  return run(0, x, w, w_sv, w_sd, labels, nullptr, nullptr, nullptr, lse, ll,
             part, tickets, N, D, V, VS, dtype, stream);
}

// dx [N, D] in the input dtype
int fused_xent_dx(const void* x, const void* w, long long w_sv, long long w_sd,
                  const void* labels, const void* lse, const void* valid,
                  const void* g, void* dx, int N, int D, int V, int dtype,
                  void* stream) {
  return run(1, x, w, w_sv, w_sd, labels, lse, valid, g, dx, nullptr, nullptr,
             nullptr, N, D, V, 1, dtype, stream);
}

// dW^T [V, D] row-major in the input dtype
int fused_xent_dw(const void* x, const void* w, long long w_sv, long long w_sd,
                  const void* labels, const void* lse, const void* valid,
                  const void* g, void* dwt, int N, int D, int V, int dtype,
                  void* stream) {
  return run(2, x, w, w_sv, w_sd, labels, lse, valid, g, dwt, nullptr, nullptr,
             nullptr, N, D, V, 1, dtype, stream);
}

const char* fused_xent_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

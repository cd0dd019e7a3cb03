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
//   * fwd for bf16 / fp16 with the tied head and D a multiple of 8 (every
//     GPT-2 width: nano's 48, 768, XL's 1600): a persistent wgmma product
//     fed by TMA whose epilogue reduces each 128 x 256 logits tile to the
//     rows' running (max, sum, label logit) in registers
//     (fx_fwd_wgmma_kernel, below: its note states the budgets); the
//     launcher picks it (`fwd_route_of`).
//   * fwd otherwise (fp32, an untied [D, V] head, a D off the 8-element
//     stride): a block of 4 warps owns 64 rows, each warp 16, and sweeps a
//     share of the vocab in tiles of 64 (the loop takes the place of the
//     TPU's sequential grid axis); x and W are staged in 64-wide chunks of
//     D, zero past D, so any D works at the same shared-memory size.  Per row it keeps
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
//     to D = 1600 (25).  The tiles hold D rounded up to 64 columns, zero
//     past D, so any D up to 1600 takes them.  Where two streamed tiles fit
//     shared memory and their rows are contiguous (bf16/fp16, the tied
//     head's W rows or x, D a multiple of 64), tile i + 1 is copied in with
//     cp.async while tile i is computed on.
//   * dx and dW for D above 1600 (fx_bwd_stream_kernel), where a block's
//     tiles of all D columns no longer fit shared memory: the output
//     columns are split between blocks (grid.y, at most 1600 a block, kept
//     in registers as above), and every tile's logits are formed over D in
//     64-column chunks, so shared memory does not grow with D; each block
//     of a row forms the logits again, the price of the split.  The JAX
//     kernel takes any D by putting the whole row in one block; this is
//     the same domain on a card whose blocks hold 227 KB.
//   * dl' is fp32 in the reference (:121-124).  Here it is rounded once to
//     the input dtype before the second product (relative error at most u,
//     the unit roundoff; for fp16 also an absolute 2^-25 below fp16's
//     normal range, since |dl'| <= 1): one mma instead of three for the
//     hi/mid/lo split of flash dK/dV, which would triple the second
//     product's cost.  kernels/fused_xent.py `kernel_tolerances` states the
//     resulting per-element bound.  fp32 inputs keep dl' in fp32.
//   * dx and dW for bf16 / fp16 with the tied head at D = 256, 512 or 768
//     (GPT-2 small's width, train-pallas's shape) take a wgmma kernel fed
//     by TMA on a persistent grid instead, one kernel over the two roles
//     (fx_wgmma_kernel, below: its note states how it meets the register,
//     FLOP, shared-memory and L2 budgets); the launcher picks it
//     (`route_of`).
// Left to later work: pipelining fx_fwd_kernel's chunks and the fp32
// path, and larger resident tiles for the mma.sync
// kernels (their W and x tiles are re-read from L2 by every block: 19.8 GB
// of L2 traffic per backward kernel at the GPT-2 shape); dx at small N
// (1024 rows at D = 1600 make 64 blocks) leaves SMs idle, and a split of
// its vocab sweep would fill them.

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// D rounded up to the 64-column tile (the tiles' width; zero past D)
__host__ __device__ inline int round64(int d) { return (d + 63) / 64 * 64; }

// out[row, col], out[row, col + 1] of a [rows, D] output, where inside D:
// one 32-bit store of the pair for an even D, element by element otherwise
template <typename T>
__device__ __forceinline__ void store_pair(T* out, int row, int col, int D,
                                           float v0, float v1) {
  if (col >= D) return;
  T* dst = out + size_t(row) * D + col;
  if constexpr (std::is_same<T, float>::value) {
    dst[0] = v0;
    if (col + 1 < D) dst[1] = v1;
  } else if (D % 2 == 0) {
    *reinterpret_cast<uint32_t*>(dst) = Mma<T>::pack(v0, v1);
  } else {
    dst[0] = from_f<T>(v0);
    if (col + 1 < D) dst[1] = from_f<T>(v1);
  }
}

// element (row, d) of an operand at src[row * s_row + d * s_col]
struct View {
  const void* p;
  long long s_row, s_col;
};

// rows [row0, row0 + count) x columns [d0, d0 + dk) of `src` -> dst (row
// stride ld elements); zero past nrows and past column dlim (the tail of a
// D that is not a multiple of the tile).  Contiguous rows whose chunk lies
// inside D and whose starts are 16-byte aligned move as 16-byte vectors;
// other contiguous rows element by element along the row; a transposed
// view (s_col != 1) element by element, neighbouring threads on
// neighbouring rows (its unit-stride axis).
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, View v, int row0,
                                      int nrows, int count, int d0, int dk,
                                      int dlim) {
  const T* src = static_cast<const T*>(v.p);
  constexpr int VEC = 16 / sizeof(T);
  if (v.s_col == 1 && d0 + dk <= dlim && v.s_row % VEC == 0 && dk % VEC == 0) {
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
  } else if (v.s_col == 1) {
    for (int i = threadIdx.x; i < count * dk; i += blockDim.x) {
      const int rr = i / dk, cc = i % dk;
      dst[size_t(rr) * ld + cc] =
          row0 + rr < nrows && d0 + cc < dlim ? src[(row0 + rr) * v.s_row + d0 + cc]
                                              : from_f<T>(0.f);
    }
  } else {
    for (int i = threadIdx.x; i < count * dk; i += blockDim.x) {
      const int rr = i % count, cc = i / count;
      dst[size_t(rr) * ld + cc] =
          row0 + rr < nrows && d0 + cc < dlim
              ? src[(row0 + rr) * v.s_row + (d0 + cc) * v.s_col]
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
      stage<T>(sX, LD, x, r0, N, BR, d0, DK, D);
      stage<T>(sW, LD, w, v0, V, BV, d0, DK, D);
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
    const int ld = round64(D) + Pad<T>::P;
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
  // the tiles hold Dp = D rounded up to 64 columns, zero past D
  const int Dp = round64(D);
  const int ld = Dp + Pad<T>::P;
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
  const int ntw = Dp / 64;  // this warp's 8-column slices: warp + 8 i

  auto stage_stats = [&](int row0, int count) {
    for (int i = threadIdx.x; i < count; i += BWD_THREADS) {
      const int r = row0 + i;
      const bool in = r < N;
      sLse[i] = in ? lse[r] : 0.f;
      sVal[i] = in && valid[r] ? 1.f : 0.f;
      sLab[i] = in ? int(labels[r]) : -1;
    }
  };

  stage<T>(sP, ld, P, p0, np, R, 0, Dp, D);
  if (!DW) stage_stats(p0, R);

  float acc[RT][NTW][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int i = 0; i < NTW; ++i) acc[rt][i][0] = acc[rt][i][1] = acc[rt][i][2] = acc[rt][i][3] = 0.f;

  const int u = warp % UNITS, ks = warp / UNITS;
  const int rt1 = u / (BS / 8), nt1 = u % (BS / 8);
  const int kbeg = ks * (Dp / KS), kend = kbeg + Dp / KS;

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
      stage<T>(sQ, ld, Q, q0, nq, BS, 0, Dp, D);
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
          if (row < np)
            store_pair(out, row, col, D, gs * acc[rt][i][2 * h],
                       gs * acc[rt][i][2 * h + 1]);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// dx / dW^T for D above what a block's shared memory holds whole (> 1600):
// one block of 8 warps per R = 16 resident rows and a range of Dc output
// columns (grid.y splits D), the logits streamed over D in 64-column chunks
// ---------------------------------------------------------------------------

// A block owns the output rows [p0, p0 + 16) and the columns [c0, c0 + Dc)
// (Dc a multiple of 64, at most 64 STW).  Per streamed tile of BS rows it
// forms the 16 x BS logits over all of D, staging both operands 64 columns
// at a time (each warp a 16 x 8 unit over its part of every chunk, the
// parts summed in a fixed order), turns them into dl' as the kernel above
// does, then stages the tile's columns of its own range 64 at a time and
// accumulates dl'.tile into its [16, Dc] fp32 accumulator, warp w owning
// the 8 columns 64 i + 8 w of chunk i.  Every block of a row re-forms the
// logits (the work of the first product times the split), in exchange for
// shared memory that does not grow with D.
template <typename T, bool DW>
struct StreamLayout {
  static constexpr int BS = std::is_same<T, float>::value ? 16 : 32;
  static constexpr int R = 16;
  static constexpr int UNITS = BS / 8;       // 16 x 8 logits units a tile
  static constexpr int KS = 8 / UNITS;       // warps per unit (split of a chunk)
  static constexpr int STW = 25;             // max 64-column chunks of a range
  static constexpr int LDC = 64 + Pad<T>::P;
  static constexpr int LDL = BS + Pad<T>::P;
  static constexpr int SR = DW ? BS : R;
};

template <typename T, bool DW>
__global__ void __launch_bounds__(BWD_THREADS)
fx_bwd_stream_kernel(View x, View w, const int64_t* __restrict__ labels,
                     const float* __restrict__ lse,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ gp, T* __restrict__ out, int N,
                     int D, int V, int Dc) {
  using LY = StreamLayout<T, DW>;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int BS = LY::BS, R = LY::R, UNITS = LY::UNITS, KS = LY::KS;
  constexpr int STW = LY::STW, LDC = LY::LDC, LDL = LY::LDL, SR = LY::SR;
  __shared__ __align__(16) T sP[R * LDC];
  __shared__ __align__(16) T sQ[BS * LDC];
  __shared__ __align__(16) T sDL[R * LDL];
  __shared__ float sRed[(KS > 1 ? KS - 1 : 1) * UNITS * 32 * 4];
  __shared__ float sLse[SR], sVal[SR];
  __shared__ int sLab[SR];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int p0 = blockIdx.x * R;
  const int c0 = blockIdx.y * Dc;
  const int Dp = round64(D);
  const int nch = min(Dc, Dp - c0) / 64;     // this block's column chunks
  const View P = DW ? w : x, Q = DW ? x : w;
  const int np = DW ? V : N, nq = DW ? N : V;

  auto stage_stats = [&](int row0, int count) {
    for (int i = threadIdx.x; i < count; i += BWD_THREADS) {
      const int r = row0 + i;
      const bool in = r < N;
      sLse[i] = in ? lse[r] : 0.f;
      sVal[i] = in && valid[r] ? 1.f : 0.f;
      sLab[i] = in ? int(labels[r]) : -1;
    }
  };
  if (!DW) stage_stats(p0, R);

  float acc[STW][4];
#pragma unroll
  for (int i = 0; i < STW; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int u = warp % UNITS, ks = warp / UNITS;
  const int kbeg = ks * (64 / KS), kend = kbeg + 64 / KS;

  for (int q0 = 0; q0 < nq; q0 += BS) {
    // the logits of this warp's 16 x 8 unit, over its part of each chunk
    float c[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    for (int d0 = 0; d0 < Dp; d0 += 64) {
      __syncthreads();
      stage<T>(sP, LDC, P, p0, np, R, d0, 64, D);
      stage<T>(sQ, LDC, Q, q0, nq, BS, d0, 64, D);
      if (DW && d0 == 0) stage_stats(q0, BS);
      __syncthreads();
      if constexpr (F32)
        tile_scores<T, 1>(c, sP, LDC, sQ + u * 8 * LDC, LDC, kbeg, kend, g, t);
      else
        unit_scores<T>(c[0], sP, LDC, sQ + u * 8 * LDC, LDC, kbeg, kend, g, t);
    }
    if constexpr (KS > 1) {
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
        const int pr = g + (i >= 2 ? 8 : 0);     // resident row
        const int qc = u * 8 + 2 * t + (i & 1);  // streamed row
        const int si = DW ? qc : pr;
        const int vocab = DW ? p0 + pr : q0 + qc;
        const bool live = DW ? q0 + qc < N : vocab < V;
        float d = 0.f;
        if (live && sVal[si] != 0.f)
          d = expf(c[0][i] - sLse[si]) - (sLab[si] == vocab ? 1.f : 0.f);
        sDL[pr * LDL + qc] = from_f<T>(d);
      }
    }

    // acc[16, Dc] += dl' [16, BS] . tile [BS, own columns], chunk by chunk
    uint32_t a[BS / 16][4];
#pragma unroll
    for (int i = 0; i < STW; ++i) {
      if (i < nch) {
        __syncthreads();  // sDL written; the previous chunk's reads done
        stage<T>(sQ, LDC, Q, q0, nq, BS, c0 + 64 * i, 64, D);
        __syncthreads();
        if constexpr (F32) {
          const int col = 8 * warp + 2 * t;
#pragma unroll 4
          for (int k = 0; k < BS; ++k) {
            const float y0 = sQ[k * LDC + col], y1 = sQ[k * LDC + col + 1];
            const float x0 = sDL[g * LDL + k], x1 = sDL[(g + 8) * LDL + k];
            acc[i][0] = fmaf(x0, y0, acc[i][0]);
            acc[i][1] = fmaf(x0, y1, acc[i][1]);
            acc[i][2] = fmaf(x1, y0, acc[i][2]);
            acc[i][3] = fmaf(x1, y1, acc[i][3]);
          }
        } else {
          if (i == 0) {
#pragma unroll
            for (int kk = 0; kk < BS / 16; ++kk) {
              const T* ar = sDL + g * LDL + kk * 16 + 2 * t;
              a[kk][0] = ld32(ar);
              a[kk][1] = ld32(ar + 8 * LDL);
              a[kk][2] = ld32(ar + 8);
              a[kk][3] = ld32(ar + 8 * LDL + 8);
            }
          }
#pragma unroll
          for (int kk = 0; kk < BS / 16; ++kk) {
            uint32_t b0, b1;
            ldsm_x2_trans(b0, b1, sQ + (kk * 16 + (lane & 15)) * LDC + 8 * warp);
            Mma<T>::run(acc[i], a[kk], b0, b1);
          }
        }
      }
    }
  }

  const float gs = *gp;
#pragma unroll
  for (int i = 0; i < STW; ++i) {
    if (i < nch) {
      const int col = c0 + 64 * i + 8 * warp + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = p0 + g + 8 * h;
        if (row < np)
          store_pair(out, row, col, D, gs * acc[i][2 * h], gs * acc[i][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dW^T and dx for bf16 / fp16, the tied head, D = 256, 512 or 768: TMA and
// wgmma, one kernel over two roles
// ---------------------------------------------------------------------------
//
// dW^T[v, :] = g sum_n dl'[n, v] x[n, :] is flash dK's structure: the
// head's vocab rows take the place of keys, x the place of both Q and dO,
// the logits^T the place of S^T.  dx[n, :] = g sum_v dl'[n, v] W[:, v] is
// the same with the roles swapped: x's token rows resident, the tied
// embedding's vocab rows streamed.  So one kernel takes both: a resident
// tile of RT = 64 rows (vocab rows of W for dW, token rows of x for dx)
// and a stream of tiles of BN = 16 rows of the other operand.  A
// persistent grid of one CTA an SM takes resident tiles c, c + gridDim.x,
// ...: the tile's operand (64 rows, K-major, all D columns) is TMA-loaded
// once, and the other operand streams through a ring of STAGES = 4 stages
// (all D columns, 128-byte swizzled; rows past the end read as zeros).
// The per-token statistics (lse, label, valid) belong to the streamed rows
// for dW, and come with each x tile by 1-d TMA (a row past N reads valid
// 0); for dx they belong to the resident rows, and each thread reads its
// two rows' once a resident tile into registers (a row past N is invalid).
// One thread issues the loads; a stage is refilled, with the tile STAGES
// ahead, as soon as every warp's product on it has retired (an mbarrier
// counts the warps), so the loads run three tiles ahead.
// The CTA is D / 256 warpgroups; warpgroup c owns output columns
// [256c, 256c + 256) and, per streamed tile:
//   * forms its part of the logits tile (64 resident x 16 streamed rows)
//     over its own 256 columns of D by wgmma m64n16k16, both operands
//     K-major in shared memory; the partials are added through shared
//     memory in warpgroup order (the same bits in every warpgroup), so each
//     product is issued once by the CTA;
//   * turns them in registers into dl' = valid (exp(s - lse) -
//     [v == label]) — 0 for a vocab row past V (TMA's zero rows give
//     exp(0 - lse), not 0) and for a token past N; the exp is __expf, whose
//     relative error (~1e-6) sits far inside the bf16 rounding that follows
//     — rounded once to the input dtype, which is already wgmma's A
//     fragment (a logits accumulator row is an A row);
//   * accumulates out[:, 256c : 256c + 256] += dl' . tile[:, 256c : ...]
//     by wgmma m64n256k16, A from registers and B the SAME swizzled
//     streamed tile read MN-major (the transpose bit set, as the flash
//     forward reads V): no transposed copy is staged.
// The accumulator stays in registers for the whole sweep, so every output
// element is summed by one thread in streamed-row order: no atomics,
// bitwise repeatable.  g multiplies once, in fp32, in the epilogue, which
// stores resident rows < V (dW) or < N (dx).
// What holds it (dW; chip_ablate.py on an NVIDIA H100 80GB HBM3 at N 8192,
// D 768, V 50304: 6.2 ms in all): the steps run in series — with no
// products at all the kernel still takes 3.0 ms (the elementwise pass 1.6
// of it), the dW product adds 2.1 and the logits 1.1.  Issuing tile i + 1's logits before tile i's
// elementwise pass (software pipelining) needs 12 more registers, and at
// 168 ptxas then spills and serializes the products.
// The budgets (D = 768):
//   * registers: the [64, D] fp32 accumulator is 196,608 bytes, 75% of an
//     SM's register file: one CTA an SM, the accumulator split by columns
//     over three warpgroups, 128 registers a thread.  No producer
//     warpgroup: beside one (at 40 registers after setmaxnreg) the three
//     consumers could take at most 152 each, (65,536 - 128 x 40) / 384
//     rounded down to 8, and the m64n256k16 product needs 158; so 384
//     threads at up to 168 registers, which leaves 8 for the logits
//     partial and 4 for the A fragment — hence BN = 16.
//   * issued FLOPs: the logits' D-sum is split between the warpgroups, not
//     recomputed per warpgroup, so the CTA issues 2 x 2 N' D V' FLOPs (the
//     streamed rows rounded up to 16, the resident to 64): the bound's two
//     products.
//   * shared memory: the resident tile 96 KB, four streamed stages of 24 KB
//     (+ 512 bytes of stats each for dW), the partials 12 KB: 207 KB of
//     the 227 KB a block may take.
//   * L2 traffic: every CTA reads all of the streamed operand once per
//     resident tile (dW: x 786 times at V = 50304, 9.9 GB at N = 8192,
//     D = 768; dx: W 128 times, the same 9.9 GB).
// In its dx role at that shape it takes 6.1 ms where fx_bwd_kernel took
// 13.5 (chip_ab.py on an NVIDIA H100 80GB HBM3 at 700 W).  A dx that split
// D over a two-CTA cluster (two consumer warpgroups of m64n192 at 232
// registers after setmaxnreg, BN 32, the next tile's logits issued before
// this tile's elementwise pass, the logits partials exchanged by st.async)
// measured slower and was not kept: PERF.md (PR 9) has its times and why.

template <int NWG, bool DW>
struct WgBwd {
  static constexpr int THREADS = 128 * NWG;
  static constexpr int RT = 64, BN = 16, STAGES = 4;  // resident, streamed rows
  static constexpr int CH = 4 * NWG;                 // 64-column chunks of D
  static constexpr int R_CHUNK = RT * 128, S_CHUNK = BN * 128;
  static constexpr int R_BYTES = CH * R_CHUNK, S_BYTES = CH * S_CHUNK;
  // dW's stage stats: lse fp32 at 0, labels int64 at 128, valid bytes at 256
  static constexpr int STAT = DW ? 512 : 0;
  static constexpr int STAT_BYTES = DW ? BN * 4 + BN * 8 + BN : 0;
  static constexpr int PART = NWG > 1 ? NWG * 8 * 128 * 4 : 0;  // fp32 partials
  static constexpr size_t SMEM =
      1024 + R_BYTES + STAGES * size_t(S_BYTES + STAT) + PART + 128;
};

// tres: the resident operand's tensor map (W for dW, x for dx), boxes of
// 64 rows; tstr: the streamed one's, boxes of 16 rows; tlse, tlab, tval:
// dW's 1-d maps of the stats (unused for dx, which reads lse, labels and
// valid directly)
template <typename T, int NWG, bool DW>
__global__ void __launch_bounds__(128 * NWG, 1)
fx_wgmma_kernel(const __grid_constant__ CUtensorMap tres,
                const __grid_constant__ CUtensorMap tstr,
                const __grid_constant__ CUtensorMap tlse,
                const __grid_constant__ CUtensorMap tlab,
                const __grid_constant__ CUtensorMap tval,
                const float* __restrict__ lse,
                const int64_t* __restrict__ labels,
                const uint8_t* __restrict__ valid,
                const float* __restrict__ gp, T* __restrict__ out, int N,
                int V) {
  using LY = WgBwd<NWG, DW>;
  constexpr int D = 256 * NWG, STAGES = LY::STAGES;
  extern __shared__ unsigned char smraw[];
  // 1024-byte alignment for the swizzle atoms
  unsigned char* sR = smraw + ((1024 - (smem_u32(smraw) & 1023)) & 1023);
  unsigned char* sS = sR + LY::R_BYTES;                 // [STAGES][S_BYTES]
  unsigned char* sSt = sS + STAGES * LY::S_BYTES;       // [STAGES][STAT]
  float* sPart = reinterpret_cast<float*>(sSt + STAGES * LY::STAT);  // [NWG][8][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(sSt + STAGES * LY::STAT + LY::PART);
  uint64_t* empty = full + STAGES;
  uint64_t* rfull = empty + STAGES;

  const int n_res_rows = DW ? V : N, n_str_rows = DW ? N : V;
  const int n_rt = (n_res_rows + LY::RT - 1) / LY::RT;
  const int n_st = (n_str_rows + LY::BN - 1) / LY::BN;
  const int n_my = (n_rt - int(blockIdx.x) + int(gridDim.x) - 1) / int(gridDim.x);
  const int total = n_my * n_st;                    // tiles this CTA streams
  const int wg = threadIdx.x >> 7, tw_ = threadIdx.x & 127;
  const int warp = tw_ >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * NWG);   // one arrival per warp
    }
    mbar_init(rfull, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // streamed tile it of this CTA's stream (tile it % n_st) into stage
  // it % STAGES
  auto load_str = [&](int it) {
    const int s = it % STAGES, r0 = (it % n_st) * LY::BN;
    mbar_expect_tx(&full[s], LY::S_BYTES + LY::STAT_BYTES);
    unsigned char* dst = sS + s * LY::S_BYTES;
    for (int ch = 0; ch < LY::CH; ++ch)
      tma_load_3d(dst + ch * LY::S_CHUNK, &tstr, &full[s], ch * 64, r0, 0);
    if constexpr (DW) {
      unsigned char* st = sSt + s * LY::STAT;
      tma_load_1d(st, &tlse, &full[s], r0);
      tma_load_1d(st + 128, &tlab, &full[s], r0);
      tma_load_1d(st + 256, &tval, &full[s], r0);
    }
  };
  auto load_res = [&](int rt) {
    mbar_expect_tx(rfull, LY::R_BYTES);
    for (int ch = 0; ch < LY::CH; ++ch)
      tma_load_3d(sR + ch * LY::R_CHUNK, &tres, rfull, ch * 64, rt * LY::RT, 0);
  };
  if (threadIdx.x == 0 && n_my > 0) {
    load_res(blockIdx.x);
    for (int i = 0; i < STAGES && i < total; ++i) load_str(i);
  }

  const uint64_t dr0 = sw128_desc(sR + 4 * wg * LY::R_CHUNK, 16, 1024);
  float acc[128];
  int it = 0;
  for (int n = 0; n < n_my; ++n) {
    const int rt = blockIdx.x + n * gridDim.x;
    // this thread's two resident rows (register 4j + r holds row
    // 16 warp + g + 8 (r >> 1) of the tile)
    const int ra = rt * LY::RT + warp * 16 + g, rb = ra + 8;
    // dx: the two token rows' stats, once a resident tile
    bool ok_a = false, ok_b = false;
    float lse_a = 0.f, lse_b = 0.f;
    long long lab_a = -1, lab_b = -1;
    if constexpr (!DW) {
      ok_a = ra < N && valid[ra] != 0;
      ok_b = rb < N && valid[rb] != 0;
      if (ok_a) { lse_a = lse[ra]; lab_a = labels[ra]; }
      if (ok_b) { lse_b = lse[rb]; lab_b = labels[rb]; }
    }
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    mbar_wait(rfull, n & 1);
    for (int st = 0; st < n_st; ++st, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* ss = sS + s * LY::S_BYTES + 4 * wg * LY::S_CHUNK;
      const uint64_t ds0 = sw128_desc(ss, 16, 1024);
      // this warpgroup's part of the logits tile (64 resident x 16
      // streamed rows)
      float sc[8];
      wgmma_fence();
#pragma unroll
      for (int ch = 0; ch < 4; ++ch)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<T, 16>::ss(sc, dr0 + ((ch * LY::R_CHUNK + 32 * kk) >> 4),
                           ds0 + ((ch * LY::S_CHUNK + 32 * kk) >> 4), ch | kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<8>(sc);
      if constexpr (NWG > 1) {
#pragma unroll
        for (int i = 0; i < 8; ++i) sPart[(wg * 8 + i) * 128 + tw_] = sc[i];
      }
      // every warpgroup has its logits: the partials are written, and after
      // the resident tile's last streamed tile its buffer is free for the
      // next resident tile
      __syncthreads();
      if (threadIdx.x == 0 && st == n_st - 1 && n + 1 < n_my)
        load_res(rt + gridDim.x);
      if constexpr (NWG > 1) {
        // the partials in warpgroup order: the same sum in every warpgroup
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v = wg == 0 ? sc[i] : sPart[i * 128 + tw_];
#pragma unroll
          for (int w = 1; w < NWG; ++w) v += w == wg ? sc[i] : sPart[(w * 8 + i) * 128 + tw_];
          sc[i] = v;
        }
        __syncthreads();  // the partials are read: the next tile rewrites them
      }
      // dl': register 4j + r is resident row (r < 2 ? ra : rb), streamed
      // row 16 st + 8j + 2t + (r & 1)
      uint32_t a[4];
      if constexpr (DW) {
        // resident rows are vocab entries, streamed rows tokens: the
        // thread's four token columns' stats are read once
        const unsigned char* sts = sSt + s * LY::STAT;
        const float* sl = reinterpret_cast<const float*>(sts);
        const long long* slab = reinterpret_cast<const long long*>(sts + 128);
        const uint8_t* sval = sts + 256;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float d[4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * t + e;
            const float l = sl[col];
            const long long lab = slab[col];
            const bool ok = sval[col] != 0;
            d[e] = ok && ra < V ? __expf(sc[4 * j + e] - l) - (lab == ra ? 1.f : 0.f) : 0.f;
            d[2 + e] = ok && rb < V ? __expf(sc[4 * j + 2 + e] - l) - (lab == rb ? 1.f : 0.f) : 0.f;
          }
          a[2 * j] = Mma<T>::pack(d[0], d[1]);
          a[2 * j + 1] = Mma<T>::pack(d[2], d[3]);
        }
      } else {
        // resident rows are tokens (stats in registers), streamed rows
        // vocab entries
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float d[4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int v = st * LY::BN + 8 * j + 2 * t + e;
            const bool in = v < V;
            d[e] = ok_a && in ? __expf(sc[4 * j + e] - lse_a) - (lab_a == v ? 1.f : 0.f) : 0.f;
            d[2 + e] = ok_b && in ? __expf(sc[4 * j + 2 + e] - lse_b) - (lab_b == v ? 1.f : 0.f) : 0.f;
          }
          a[2 * j] = Mma<T>::pack(d[0], d[1]);
          a[2 * j + 1] = Mma<T>::pack(d[2], d[3]);
        }
      }
      // out tile += dl' . streamed tile, this warpgroup's 256 columns
      fence_regs<128>(acc);
      wgmma_fence();
      Wgmma<T, 256>::rs(acc, a, sw128_desc(ss, LY::S_CHUNK, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<128>(acc);
      // this warp is done with the stage; refill it with the tile STAGES on
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (threadIdx.x == 0 && it + STAGES < total) {
        mbar_wait(&empty[s], (it / STAGES) & 1);
        load_str(it + STAGES);
      }
      __syncwarp();
    }
    const float gs = *gp;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 256 * wg + 8 * j + 2 * t;
      if (ra < n_res_rows)
        *reinterpret_cast<uint32_t*>(out + size_t(ra) * D + col) =
            Mma<T>::pack(gs * acc[4 * j], gs * acc[4 * j + 1]);
      if (rb < n_res_rows)
        *reinterpret_cast<uint32_t*>(out + size_t(rb) * D + col) =
            Mma<T>::pack(gs * acc[4 * j + 2], gs * acc[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// forward for bf16 / fp16, the tied head, any D a multiple of 8: a
// persistent wgmma product with the logsumexp in its epilogue
// ---------------------------------------------------------------------------
//
// The forward is one product, logits = x . W^T, reduced row by row as it is
// formed: it keeps no [64, D] accumulator as dx / dW do, so the register
// file holds a whole logits tile.  A tile is BM = 128 tokens x BN = 256
// vocab rows; its logits are formed over D in 64-column chunks, each a
// stage of a STAGES = 4 ring (x's 128 rows and the tied embedding's 256
// vocab rows, both K-major, 128-byte swizzled; TMA reads the columns past
// D, and the rows past N or V, as zeros, so any D that keeps a 16-byte row
// stride takes it: nano's 48, GPT-2's 768, XL's 1600).  The CTA is three
// warpgroups: the producer (24 registers after setmaxnreg.dec), one thread
// of which keeps the ring's TMA loads in flight, and two consumers (240),
// consumer c owning the tile's token rows [64 c, 64 c + 64) as one
// m64n256k16 accumulator (128 fp32 a thread); both read every stage, so a
// W chunk is loaded once per 128 tokens.  Per chunk a consumer issues its
// four products and retires the previous chunk's (wait 1), handing that
// stage back, so one chunk's products are always in flight.  Per tile, in
// registers: vocab rows past V set to -inf (TMA's zero rows are logits 0,
// not absent), the row max over the tile (quad shuffles), the exponential
// sum against the running max (one EX2 of (s - m) log2 e, the difference
// first), the label's logit picked by the one thread whose column holds it
// (a label outside [0, V) picks none: 0), merged into each thread's running
// (m, l, ll) of its two rows.  The two consumers' epilogues run beside the
// other's products as far as the ring lets them drift apart (three chunks).
// Work units are (128-token row tile, vocab split): VS splits of the vocab
// tiles per row tile (the wrapper picks VS so the units fill the grid
// evenly), unit u = (row tile u % n_rt, split u / n_rt), taken by a
// persistent grid of one CTA an SM as c, c + gridDim.x, ...: the CTAs
// resident at one time sweep the same splits' W tiles together, so W comes
// from HBM about once and x (12.6 MB at the training shape) stays in L2.
// Each unit writes its rows' partial (max, sum, label logit); the last of
// a row tile's VS units to finish (a ticket) merges them in split order, as
// fx_fwd_kernel does: the result does not depend on the schedule, and is
// bitwise repeatable.
// The budgets (N 8192, D 768, V 50304):
//   * registers: 128 accumulators, the rows' (m, l, ll) and labels, the
//     epilogue's temporaries: within the consumers' 240.
//   * shared memory: four stages of 48 KB (x 16 KB, W 32 KB): 193 KB.
//   * issued FLOPs: 2 N' D' V' over N and V rounded up to the tile and D
//     to 64 columns: 1.003 x the bound's 632.9 GFLOP at this shape.
//   * L2 traffic: every tile reads its x (196 KB) and W (393 KB) chunks:
//     7.4 GB a call, 85 FLOP a byte.

struct WgFwd {
  static constexpr int THREADS = 384;                 // two consumers, producer
  static constexpr int BM = 128, BN = 256, STAGES = 4;
  static constexpr int X_BYTES = BM * 128, W_BYTES = BN * 128;  // a chunk
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr size_t SMEM = 1024 + STAGES * size_t(STAGE) +
                                 8 * 2 * STAGES + 16;
};

template <typename T>
__global__ void __launch_bounds__(384, 1)
fx_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tw,
                    const int64_t* __restrict__ labels,
                    float* __restrict__ lse, float* __restrict__ ll,
                    float* __restrict__ part, int* __restrict__ tickets,
                    int N, int D, int V, int VS) {
  using LY = WgFwd;
  constexpr int STAGES = LY::STAGES;
  extern __shared__ unsigned char smraw[];
  // 1024-byte alignment for the swizzle atoms
  unsigned char* sbuf = smraw + ((1024 - (smem_u32(smraw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sbuf + STAGES * LY::STAGE);
  uint64_t* empty = full + STAGES;
  int* s_last = reinterpret_cast<int*>(empty + STAGES);

  const int n_rt = (N + LY::BM - 1) / LY::BM;
  const int n_vt = (V + LY::BN - 1) / LY::BN;
  const int nk = (D + 63) / 64;
  const int n_units = n_rt * VS;
  // unit u -> (row tile, split); [t0, t1) its vocab tiles
  auto unit = [&](int u, int& rt, int& vs, int& t0, int& t1) {
    rt = u % n_rt;
    vs = u / n_rt;
    t0 = int((long long)vs * n_vt / VS);
    t1 = int((long long)(vs + 1) * n_vt / VS);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        int rt, vs, t0, t1;
        unit(u, rt, vs, t0, t1);
        for (int vt = t0; vt < t1; ++vt)
          for (int kc = 0; kc < nk; ++kc, ++it) {
            const int s = it % STAGES;
            mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
            mbar_expect_tx(&full[s], LY::STAGE);
            unsigned char* st = sbuf + s * LY::STAGE;
            tma_load_3d(st, &tx, &full[s], 64 * kc, rt * LY::BM, 0);
            tma_load_3d(st + LY::X_BYTES, &tw, &full[s], 64 * kc, vt * LY::BN,
                        0);
          }
      }
    }
    return;
  }

  // consumers
  setmaxnreg_inc<240>();
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* pm = part;
  float* pl = part + size_t(VS) * N;
  float* pll = part + 2 * size_t(VS) * N;
  float acc[128];
  int it = 0;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    int rt, vs, t0, t1;
    unit(u, rt, vs, t0, t1);
    // this thread's two token rows (register 4j + r holds row
    // 16 warp + g + 8 (r >> 1) of the consumer's 64, vocab column
    // 8j + 2t + (r & 1) of the tile) and their labels, -1 outside [0, V)
    const int ra = rt * LY::BM + 64 * wg + 16 * warp + g, rb = ra + 8;
    long long lab_a = ra < N ? labels[ra] : -1;
    long long lab_b = rb < N ? labels[rb] : -1;
    if (lab_a >= V) lab_a = -1;
    if (lab_b >= V) lab_b = -1;
    float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
    float ll_a = 0.f, ll_b = 0.f;
    for (int vt = t0; vt < t1; ++vt) {
      const int v0 = vt * LY::BN;
      for (int kc = 0; kc < nk; ++kc, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const unsigned char* st = sbuf + s * LY::STAGE;
        const uint64_t da = sw128_desc(st + wg * 64 * 128, 16, 1024);
        const uint64_t db = sw128_desc(st + LY::X_BYTES, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<T, 256>::ss(acc, da + 2 * kk, db + 2 * kk, kc | kk);
        wgmma_commit();
        // the previous chunk's products have retired: hand its stage back
        wgmma_wait<1>();
        __syncwarp();
        if (kc > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      fence_regs<128>(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

      // vocab rows past V are no logits (TMA's zero rows): -inf
      if (v0 + LY::BN > V) {
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (v0 + 8 * j + 2 * t + e >= V) acc[4 * j + e] = acc[4 * j + 2 + e] = -INFINITY;
      }
      // the label's logit, in the one thread whose column holds it
      if (lab_a >= v0 && lab_a < v0 + LY::BN) {
        const int c = int(lab_a - v0) - 2 * t;
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * j + e == c) ll_a += acc[4 * j + e];
      }
      if (lab_b >= v0 && lab_b < v0 + LY::BN) {
        const int c = int(lab_b - v0) - 2 * t;
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * j + e == c) ll_b += acc[4 * j + 2 + e];
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(acc[4 * j], acc[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(acc[4 * j + 2], acc[4 * j + 3]));
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        ps_a += ex2((acc[4 * j] - mn_a) * LOG2E);
        ps_a += ex2((acc[4 * j + 1] - mn_a) * LOG2E);
        ps_b += ex2((acc[4 * j + 2] - mn_b) * LOG2E);
        ps_b += ex2((acc[4 * j + 3] - mn_b) * LOG2E);
      }
      l_a = l_a * ex2((m_a - mn_a) * LOG2E) + quad_sum(ps_a);
      l_b = l_b * ex2((m_b - mn_b) * LOG2E) + quad_sum(ps_b);
      m_a = mn_a;
      m_b = mn_b;
    }
    // the label logit sits in one lane of the quad (the others hold 0)
    ll_a = quad_sum(ll_a);
    ll_b = quad_sum(ll_b);
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
    named_bar_sync(1, 256);
    if (threadIdx.x == 0) *s_last = atomicAdd(&tickets[rt], 1) == VS - 1;
    named_bar_sync(1, 256);
    if (*s_last) {
      // the last of the row tile's units merges the VS partials in split
      // order (fx_fwd_kernel's merge)
      __threadfence();
      const int row = rt * LY::BM + threadIdx.x;
      if (threadIdx.x < LY::BM && row < N) {
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

template <typename T, bool DW>
cudaError_t launch_bwd_stream(const Args& a) {
  using LY = StreamLayout<T, DW>;
  const int Dp = round64(a.D);
  const int splits = (Dp + 64 * LY::STW - 1) / (64 * LY::STW);
  const int Dc = round64((Dp + splits - 1) / splits);
  const int np = DW ? a.V : a.N;
  dim3 grid((np + LY::R - 1) / LY::R, (Dp + Dc - 1) / Dc);
  fx_bwd_stream_kernel<T, DW><<<grid, BWD_THREADS, 0, a.stream>>>(
      a.x, a.w, a.labels, a.lse, a.valid, a.g, static_cast<T*>(a.out0), a.N,
      a.D, a.V, Dc);
  return cudaGetLastError();
}

// D (rounded up to 64) up to 1600 for every dtype: fp32 tiles (16 resident
// and 16 streamed rows) fit shared memory to 1600; 16-bit R = 32 keeps 12
// slices a warp in registers to 768, R = 16 keeps 25 to 1600.  Wider D
// streams its columns (fx_bwd_stream_kernel).
template <typename T, bool DW>
cudaError_t launch_bwd_rt(const Args& a) {
  if (round64(a.D) > 1600) return launch_bwd_stream<T, DW>(a);
  if constexpr (std::is_same<T, float>::value) {
    return launch_bwd<T, 1, DW, false>(a);
  } else {
    // the streamed tile double-buffers where its rows are contiguous (cp.async
    // copies whole 16-byte vectors) and two tiles fit shared memory
    // (a D that is a multiple of 64 keeps every row's 16-byte vectors
    // aligned)
    const View& q = DW ? a.x : a.w;
    constexpr size_t SMEM_MAX = 232448;
    const bool db = q.s_col == 1 && a.D % 64 == 0;
    if (round64(a.D) <= 768)
      return db && BwdLayout<T, 2, DW, true>::bytes(a.D) <= SMEM_MAX
                 ? launch_bwd<T, 2, DW, true>(a)
                 : launch_bwd<T, 2, DW, false>(a);
    return db && BwdLayout<T, 1, DW, true>::bytes(a.D) <= SMEM_MAX
               ? launch_bwd<T, 1, DW, true>(a)
               : launch_bwd<T, 1, DW, false>(a);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// 1: the wgmma kernel takes these operands in either role (bf16/fp16, the
// tied head, D = 256, 512 or 768, every pointer it reads by TMA 16-byte
// aligned: x and W, and for dW lse, labels and valid); 0: fx_bwd_kernel,
// 2: fx_bwd_stream_kernel (D above 1600)
int route_of(bool dw, int dtype, int D, long long w_sv, long long w_sd,
             const void* x, const void* w, const void* labels,
             const void* lse, const void* valid) {
  if ((dtype == 1 || dtype == 2) && w_sv == D && w_sd == 1 && D % 256 == 0 &&
      D <= 768 && aligned16(x) && aligned16(w) &&
      (!dw || (aligned16(labels) && aligned16(lse) && aligned16(valid))))
    return 1;
  return round64(D) > 1600 ? 2 : 0;
}

template <typename T, int NWG, bool DW>
cudaError_t launch_wgmma_n(const Args& a) {
  using LY = WgBwd<NWG, DW>;
  CUtensorMap tx, tw, tlse{}, tlab{}, tval{};
  cudaError_t e;
  if ((e = tensor_map<T>(&tx, a.x.p, 1, a.N, a.D, DW ? LY::BN : LY::RT)) !=
          cudaSuccess ||
      (e = tensor_map<T>(&tw, a.w.p, 1, a.V, a.D, DW ? LY::RT : LY::BN)) !=
          cudaSuccess)
    return e;
  if (DW && ((e = tensor_map_1d(&tlse, a.lse, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                a.N, LY::BN)) != cudaSuccess ||
             (e = tensor_map_1d(&tlab, a.labels, CU_TENSOR_MAP_DATA_TYPE_INT64,
                                a.N, LY::BN)) != cudaSuccess ||
             (e = tensor_map_1d(&tval, a.valid, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                a.N, LY::BN)) != cudaSuccess))
    return e;
  auto kern = fx_wgmma_kernel<T, NWG, DW>;
  if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(LY::SMEM))) != cudaSuccess)
    return e;
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return e;
  const int n_rt = ((DW ? a.V : a.N) + LY::RT - 1) / LY::RT;
  kern<<<min(n_rt, sms), LY::THREADS, LY::SMEM, a.stream>>>(
      DW ? tw : tx, DW ? tx : tw, tlse, tlab, tval, a.lse, a.labels, a.valid,
      a.g, static_cast<T*>(a.out0), a.N, a.V);
  return cudaGetLastError();
}

template <typename T, bool DW>
cudaError_t launch_wgmma(const Args& a) {
  if (a.D == 256) return launch_wgmma_n<T, 1, DW>(a);
  if (a.D == 512) return launch_wgmma_n<T, 2, DW>(a);
  return launch_wgmma_n<T, 3, DW>(a);
}

// 1: the wgmma forward takes these operands (bf16/fp16, the tied head, D a
// multiple of 8 so that its rows are 16-byte strided for TMA, x and W
// 16-byte aligned); 0: fx_fwd_kernel
int fwd_route_of(int dtype, int D, long long w_sv, long long w_sd,
                 const void* x, const void* w) {
  return (dtype == 1 || dtype == 2) && w_sv == D && w_sd == 1 && D % 8 == 0 &&
                 aligned16(x) && aligned16(w)
             ? 1
             : 0;
}

// the wgmma forward on a persistent grid of one CTA an SM over the
// n_rt x VS units
template <typename T>
cudaError_t launch_fwd_wgmma(const Args& a) {
  using LY = WgFwd;
  if (a.VS < 1) return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  cudaError_t e;
  if ((e = tensor_map<T>(&tx, a.x.p, 1, a.N, a.D, LY::BM)) != cudaSuccess ||
      (e = tensor_map<T>(&tw, a.w.p, 1, a.V, a.D, LY::BN)) != cudaSuccess)
    return e;
  auto kern = fx_fwd_wgmma_kernel<T>;
  if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(LY::SMEM))) != cudaSuccess)
    return e;
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return e;
  const int units = (a.N + LY::BM - 1) / LY::BM * a.VS;
  kern<<<min(units, sms), LY::THREADS, LY::SMEM, a.stream>>>(
      tx, tw, a.labels, static_cast<float*>(a.out0),
      static_cast<float*>(a.out1), a.part, a.tickets, a.N, a.D, a.V, a.VS);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(int which, const Args& a, int dtype) {
  if (which == 0) {
    if constexpr (!std::is_same<T, float>::value) {
      if (fwd_route_of(dtype, a.D, a.w.s_row, a.w.s_col, a.x.p, a.w.p) == 1)
        return launch_fwd_wgmma<T>(a);
    }
    return launch_fwd<T>(a);
  }
  const bool dw = which == 2;
  if constexpr (!std::is_same<T, float>::value) {
    if (route_of(dw, dtype, a.D, a.w.s_row, a.w.s_col, a.x.p, a.w.p, a.labels,
                 a.lse, a.valid) == 1)
      return dw ? launch_wgmma<T, true>(a) : launch_wgmma<T, false>(a);
  }
  return dw ? launch_bwd_rt<T, true>(a) : launch_bwd_rt<T, false>(a);
}

int run(int which, const void* x, const void* w, long long w_sv,
        long long w_sd, const void* labels, const void* lse,
        const void* valid, const void* g, void* out0, void* out1,
        void* part, void* tickets, int N, int D, int V, int VS, int dtype,
        void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not an older one
  if (N <= 0 || V <= 0 || D <= 0) return cudaErrorInvalidValue;
  const Args a{{x, D, 1}, {w, w_sv, w_sd},
               static_cast<const int64_t*>(labels),
               static_cast<const float*>(lse),
               static_cast<const uint8_t*>(valid),
               static_cast<const float*>(g), out0, out1,
               static_cast<float*>(part), static_cast<int*>(tickets), N, D,
               V, VS, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch_t<float>(which, a, dtype);
    case 1: return launch_t<__nv_bfloat16>(which, a, dtype);
    case 2: return launch_t<__half>(which, a, dtype);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x [N, D] contiguous; the head weight W [D, V] with element (v, d) at
// w[v * w_sv + d * w_sd] (w_sv = D, w_sd = 1 for the transposed view of a
// [V, D] embedding; w_sv = 1, w_sd = V for a contiguous [D, V]); x and W of
// one dtype (0 = float32, 1 = bfloat16, 2 = float16), 16-byte aligned; any
// D >= 1.  labels int64 [N]; lse fp32 [N]; valid bool (one byte) [N];
// g one fp32 (the upstream gradient).  Each returns the cudaError_t of the
// launch (0 on success); the caller raises on anything else.

// lse, ll [N] fp32; the vocab split VS ways per 64 rows (fx_fwd_kernel)
// or per 128 rows (the wgmma route, `fused_xent_fwd_route`), with part
// fp32 [3, VS, N] scratch and tickets int32 [ceil(N / 64)], zero before
// the launch
int fused_xent_fwd(const void* x, const void* w, long long w_sv,
                   long long w_sd, const void* labels, void* lse, void* ll,
                   void* part, void* tickets, int N, int D, int V, int VS,
                   int dtype, void* stream) {
  return run(0, x, w, w_sv, w_sd, labels, nullptr, nullptr, nullptr, lse, ll,
             part, tickets, N, D, V, VS, dtype, stream);
}

// the kernel fused_xent_fwd launches for these operands: 1 = the wgmma
// kernel, 0 = fx_fwd_kernel
int fused_xent_fwd_route(int dtype, int D, long long w_sv, long long w_sd,
                         const void* x, const void* w) {
  return fwd_route_of(dtype, D, w_sv, w_sd, x, w);
}

// dx [N, D] in the input dtype
int fused_xent_dx(const void* x, const void* w, long long w_sv, long long w_sd,
                  const void* labels, const void* lse, const void* valid,
                  const void* g, void* dx, int N, int D, int V, int dtype,
                  void* stream) {
  return run(1, x, w, w_sv, w_sd, labels, lse, valid, g, dx, nullptr, nullptr,
             nullptr, N, D, V, 1, dtype, stream);
}

// the kernel fused_xent_dx / fused_xent_dw launches for these operands:
// 1 = the wgmma kernel, 0 = fx_bwd_kernel, 2 = fx_bwd_stream_kernel
int fused_xent_dx_route(int dtype, int D, long long w_sv, long long w_sd,
                        const void* x, const void* w, const void* labels,
                        const void* lse, const void* valid) {
  return route_of(false, dtype, D, w_sv, w_sd, x, w, labels, lse, valid);
}

int fused_xent_dw_route(int dtype, int D, long long w_sv, long long w_sd,
                        const void* x, const void* w, const void* labels,
                        const void* lse, const void* valid) {
  return route_of(true, dtype, D, w_sv, w_sd, x, w, labels, lse, valid);
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

// Sort-based MoE token movement, written for Hopper (sm_90a).
//
// Replaces the TPU kernels of deepspeed_tpu/kernels/moe_kernels.py:
//   moe_dispatch  <- `_dispatch_kernel` (:52, pallas_call :84)
//   moe_combine   <- `_combine_kernel`  (:100, pallas_call :140)
// and computes what their plain PyTorch versions compute
// (deepspeed_tpu_torch/moe/dispatch.py `sorted_dispatch_ref`,
// `sorted_combine_ref`) for B token groups at once (the JAX package vmaps
// one group at a time over the batch rows; here one launch covers all B):
//   routing, per group b: eidx, pos [k, N] int32 and keep [k, N] bool,
//     round-major (assignment a = r * N + n carries token n); a kept
//     assignment owns slot e * C + pos of the [E * C] slots, uniquely.
//     Nothing else is assumed of the kept slots: they need not fill a
//     prefix of an expert's C (a dropless overflow bucket's routing need
//     not either).
//   moe_dispatch: out[b, s] = x[b, n] where the kept assignment r * N + n
//     owns slot s, or zeros where no assignment does: a verbatim row copy,
//     so bit-exact against the plain version's add into zeros (equal
//     values; a -0.0 input row comes back -0.0 here and +0.0 from the
//     add).  With `gate` (the combine's gradient) each copied row is
//     scaled by its assignment's weight w = T(gate * keep), computed in
//     fp32 and rounded once to T, as the plain version's T multiply rounds.
//   moe_combine: y[b, n] = sum over rounds r = 0..k-1, in that order, of
//     w[r, n] * out[b, eidx[r, n] * C + pos[r, n]], with w = fp32(T(gate *
//     keep)) (the weight cast through the output dtype, moe_kernels.py
//     :131-133; without `gate` the unit weight keep, the dispatch's
//     gradient); dropped assignments add nothing.  Products and sums in
//     fp32, rounded once to T at the end; the plain version rounds each
//     product to T (for bf16 / fp16) before its sum, so the two differ by
//     at most about one ulp of the output per term: moe/dispatch.py
//     `combine_tolerance` states the bound.
//
// What bounds them on this card: bytes.  At the training shape (B 4,
// S 2048, E 64, C 32, D 768, bf16, top-1) each moves 8192 rows of 1.5 KB
// in and out, 12.6 MB each way, 7.5 us at 3.35 TB/s; the index work is
// 8192 assignments.
//
// The dispatch is one launch and nothing else: no memset, no index
// kernel.  (Its first design, which replaced the TPU kernel's scalar-
// prefetch grid over slots, was three device operations: a memset of a
// slot -> assignment table, a kernel that scattered each kept assignment
// into it, then one thread per 16 bytes of an output row, each with a
// dependent load chain table -> x and 64-bit divisions.)  Now one CTA of
// 256 threads owns R = 64 consecutive slots of one group:
//   * it builds the inverse of its slots in shared memory: every thread
//     scans its share of the group's k * N routing entries (9 bytes each,
//     L2-resident after the first CTA of the group reads them; four
//     entries a load) and writes the token (and, gated, the row's weight)
//     of each kept assignment whose slot falls in the CTA's range; a slot
//     nobody writes stays -1.  Nothing assumes that the kept positions
//     fill a prefix of an expert's slots.  Every CTA reads the group's
//     whole routing, so the scan's reads grow as k * N * E * C / R, about
//     (k * N)^2 at a fixed capacity factor, where the rows grow as k * N:
//     at k * N = 2048 they are a tenth of the row bytes (from L2), at
//     8192 over a third.  Against index_select the kernel is 1.03x at
//     k * N = 2048, 1.05-1.07x at 4096 and 1.27x at 8192, where it is
//     also 7% slower than the three-operation design (PERF.md);
//   * then each warp moves RU = 8 of the CTA's rows at once, each lane
//     VU = 3 16-byte vectors of each: 24 independent loads a thread issued
//     before the first store; an empty slot's row is written as zeros
//     without a load;
//   * index arithmetic in 32 bits (the host checks N * row vectors fits);
//     only the group's base pointers are 64-bit.
// Measured against the alternatives (PERF.md): 16-32 slots a CTA
// with 12 loads a thread, a scatter of the token rows with zero-filling
// CTAs, and a scatter whose CTAs also zero their share of the slots were
// all slower at the training shape; a scan that reads only the expert
// index (keep and pos only for the CTA's experts), 128 or 256 slots a
// CTA, and clusters of 2-8 CTAs that share the scan through distributed
// shared memory were slower at top-1 and top-2, S 2048 and 4096.  The
// out-of-range check's printf sits in a function of its own, so that it
// does not take registers from the copy.
//
// The combine is the same gather run the other way round, on the same
// stages (`read_routing`; `copy_rows`, `load_rows` / `store_rows`).  (Its
// first design ran one thread per 16-byte vector of an output row: two
// 64-bit divisions a thread, and a chain of dependent loads keep ->
// gate, eidx, pos -> the expert row -> the store that each of a row's
// threads ran again for the same routing entries.)  Now one CTA of 256
// threads owns CR consecutive tokens of one group:
//   * it stages their k x CR routing entries in shared memory once, four
//     entries a load where the rows allow: the slot row each assignment
//     reads (-1 where it was dropped; a kept one routed past the buckets
//     stops the kernel) and, gated, its weight rounded through T;
//   * at k = 1 (the training path) the sum is one product, so the rows
//     move through the dispatch's copy stage: each warp takes CR / 8
//     tokens at once, each lane VU 16-byte vectors of each, every load
//     issued before the first store, each element scaled by its weight
//     in fp32 and rounded once to T;
//   * at k > 1 each warp takes CRU tokens at once, each lane CVU vectors
//     of each, and for r = 0 .. k-1 in order issues the round's loads
//     before it adds w * row into fp32 accumulators with fmaf, then
//     rounds the sums once to T;
//   * a dropped assignment loads nothing, so a token whose every
//     assignment dropped is written as zeros without a load; index
//     arithmetic in 32 bits (the host checks E * C * row vectors fits),
//     only the group's base pointers 64-bit.

#include <cstdio>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// A kept assignment routed outside the [E, C] buckets (routing made for
// another capacity or expert count): the plain version's scatter raises
// there, so the kernel stops with a launch failure rather than write or
// read another row.
__device__ __noinline__ void slot_fault(const char* kernel, long long i,
                                        int e, int ps, int E, int C) {
  printf("%s: kept assignment %lld routes to expert %d slot %d, outside "
         "[0, %d) x [0, %d)\n", kernel, i, e, ps, E, C);
  __trap();
}
__device__ __forceinline__ void check_slot(const char* kernel, long long i,
                                           int e, int ps, int E, int C) {
  if (e < 0 || e >= E || ps < 0 || ps >= C) slot_fault(kernel, i, e, ps, E, C);
}

constexpr int DWARPS = THREADS / 32;
constexpr int R = 64;    // slots a dispatch CTA owns
constexpr int RU = 8;    // rows a warp moves at once (R / DWARPS: all of them)
constexpr int VU = 3;    // 16-byte vectors a lane moves of each
// The combine: tokens a CTA owns; at k = 1 each warp moves CR / DWARPS
// of them at once, VU vectors a lane of each (the dispatch's copy
// stage); at k > 1 it sums CRU of them at once, CVU vectors a lane of
// each (chip_ab.py's moe turns over CR 16, 32 and 64 and CRU x CVU kept
// the fastest at train-moe's shape, PERF.md)
constexpr int CR = 32;
constexpr int CRU = 2;
constexpr int CVU = 3;

// Round r's routing entries n in [n_begin, n_end), split over the CTA's
// threads: take(n, kept, e, ps) for each.  VEC4 reads four entries a
// load (n_begin and n_end multiples of 4, the rows 16-byte (eidx, pos)
// and 4-byte (keep) aligned).
template <bool VEC4, typename Take>
__device__ __forceinline__ void read_routing(const int* __restrict__ er,
                                             const int* __restrict__ pr,
                                             const uint8_t* __restrict__ kr,
                                             int n_begin, int n_end,
                                             Take take) {
  if constexpr (VEC4) {
#pragma unroll 4
    for (int qd = n_begin / 4 + int(threadIdx.x); qd < n_end / 4; qd += THREADS) {
      const uint32_t kq = reinterpret_cast<const uint32_t*>(kr)[qd];
      const int4 eq = reinterpret_cast<const int4*>(er)[qd];
      const int4 pq = reinterpret_cast<const int4*>(pr)[qd];
      take(4 * qd, kq & 0xFF, eq.x, pq.x);
      take(4 * qd + 1, (kq >> 8) & 0xFF, eq.y, pq.y);
      take(4 * qd + 2, (kq >> 16) & 0xFF, eq.z, pq.z);
      take(4 * qd + 3, kq >> 24, eq.w, pq.w);
    }
  } else {
#pragma unroll 4
    for (int n = n_begin + int(threadIdx.x); n < n_end; n += THREADS)
      take(n, kr[n] != 0, er[n], pr[n]);
  }
}

// The row copy: RU rows' vectors v0, v0 + 32, ..., v0 + 32 (NV - 1) from
// base (row src[u]), all RU x NV loads issued before any is used; a row
// whose src is negative, and a vector past vpr, is zeros without a load.
template <int RU_, int NV, typename V>
__device__ __forceinline__ void load_rows(V (&val)[RU_][NV],
                                          const V* __restrict__ base,
                                          const int (&src)[RU_], int v0,
                                          int vpr) {
#pragma unroll
  for (int u = 0; u < RU_; ++u)
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = v0 + 32 * j;
      val[u][j] = src[u] >= 0 && v < vpr ? base[src[u] * vpr + v] : V{};
    }
}

// ... and their store to rows r0 + u * DWARPS (those below nrows) of out
template <int RU_, int NV, typename V>
__device__ __forceinline__ void store_rows(V* __restrict__ out,
                                           const V (&val)[RU_][NV], int r0,
                                           int nrows, int v0, int vpr) {
#pragma unroll
  for (int u = 0; u < RU_; ++u) {
    const int row = r0 + u * DWARPS;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = v0 + 32 * j;
      if (row < nrows && v < vpr) out[row * vpr + v] = val[u][j];
    }
  }
}

// The copy stage: each warp moves RU_ of the CTA's nrows rows at once
// (rows r0 + u * DWARPS), each lane NV vectors of each: row `row` of out
// is row s_src[row] of in (zeros where it is negative, without a load),
// scaled by T(s_w[row]) where GATED, every element rounded once to T.
template <typename T, int RU_, int NV, bool GATED, typename V>
__device__ __forceinline__ void copy_rows(V* __restrict__ out,
                                          const V* __restrict__ in,
                                          const int* s_src, const float* s_w,
                                          int nrows, int vpr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r0 = warp; r0 < nrows; r0 += DWARPS * RU_) {
    int src[RU_];
    float w[RU_];
#pragma unroll
    for (int u = 0; u < RU_; ++u) {
      const int row = r0 + u * DWARPS;
      src[u] = row < nrows ? s_src[row] : -1;
      w[u] = GATED && src[u] >= 0 ? s_w[row] : 1.f;
    }
    for (int v0 = lane; v0 < vpr; v0 += 32 * NV) {
      V val[RU_][NV];
      load_rows(val, in, src, v0, vpr);
      if constexpr (GATED) {
#pragma unroll
        for (int u = 0; u < RU_; ++u)
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            T* el = reinterpret_cast<T*>(&val[u][j]);
#pragma unroll
            for (int q = 0; q < int(sizeof(V) / sizeof(T)); ++q)
              el[q] = from_f<T>(to_f(el[q]) * w[u]);
          }
      }
      store_rows(out, val, r0, nrows, v0, vpr);
    }
  }
}

// V: the vector type one lane moves; T: the element type (for weights);
// GATED: rows scaled by T(gate) (the combine's gradient; the forward's
// instantiation carries no weight code); VEC4: the routing read four
// entries a load.  One CTA: slots [R c, R c + R) of group blockIdx.y.
template <typename T, typename V, bool GATED, bool VEC4>
__global__ void __launch_bounds__(THREADS)
dispatch_kernel(const V* __restrict__ x, const int* __restrict__ eidx,
                const int* __restrict__ pos, const uint8_t* __restrict__ keep,
                const float* __restrict__ gate, int N, int k, int E, int C,
                int vpr, V* __restrict__ out) {
  __shared__ int s_tok[R];      // the token whose row fills the slot, or -1
  __shared__ float s_w[R];      // its weight T(gate), gated calls only
  const int tid = threadIdx.x;
  const int b = blockIdx.y, EC = E * C, s0 = blockIdx.x * R;
  const int nrows = min(R, EC - s0);
  for (int i = tid; i < R; i += THREADS) s_tok[i] = -1;
  __syncthreads();

  // the inverse of this CTA's slots, from the group's routing (two quads
  // a thread at the training shape)
  const size_t g0 = size_t(b) * k * N;
  for (int r = 0; r < k; ++r) {
    const size_t gr = g0 + size_t(r) * N;
    read_routing<VEC4>(eidx + gr, pos + gr, keep + gr, 0, N,
                       [&](int n, bool kept, int e, int ps) {
      if (!kept) return;
      check_slot("moe_dispatch", (long long)gr + n, e, ps, E, C);
      const int rel = e * C + ps - s0;
      if (rel >= 0 && rel < nrows) {
        s_tok[rel] = n;
        if constexpr (GATED) s_w[rel] = to_f(from_f<T>(gate[gr + n]));
      }
    });
  }
  __syncthreads();

  // an empty slot's row is zeros, without a load
  copy_rows<T, RU, VU, GATED>(out + (size_t(b) * EC + s0) * vpr,
                              x + size_t(b) * N * vpr, s_tok, s_w, nrows,
                              vpr);
}

// y[b, n] = sum over r of w[r, n] * eo[b, slot of (r, n)], in fp32, rounds
// in order.  One CTA: tokens [CR c, CR c + CR) of group blockIdx.y; its
// routing (k x CR entries) staged once in dynamic shared memory: the slot
// row each assignment reads (-1 dropped) and, GATED, its weight T(gate).
// K1 (k = 1): the sum is one product, T(w * row), so the rows move
// through the dispatch's copy stage.
template <typename T, typename V, bool GATED, bool VEC4, bool K1>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const V* __restrict__ eo, const int* __restrict__ eidx,
               const float* __restrict__ gate, const int* __restrict__ pos,
               const uint8_t* __restrict__ keep, int N, int k, int E, int C,
               int vpr, V* __restrict__ y) {
  constexpr int EPV = sizeof(V) / sizeof(T);  // elements per vector
  extern __shared__ int s_route[];
  int* s_src = s_route;                                   // [k][CR]
  float* s_w = reinterpret_cast<float*>(s_route + k * CR);  // [k][CR]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, n0 = blockIdx.x * CR;
  const int nrows = min(CR, N - n0);

  const size_t g0 = size_t(b) * k * N;
  for (int r = 0; r < k; ++r) {
    const size_t gr = g0 + size_t(r) * N;
    read_routing<VEC4>(eidx + gr, pos + gr, keep + gr, n0, n0 + nrows,
                       [&](int n, bool kept, int e, int ps) {
      if (kept) check_slot("moe_combine", (long long)gr + n, e, ps, E, C);
      s_src[r * CR + n - n0] = kept ? e * C + ps : -1;
      if constexpr (GATED)
        s_w[r * CR + n - n0] = kept ? to_f(from_f<T>(gate[gr + n])) : 0.f;
    });
  }
  __syncthreads();

  const V* eb = eo + size_t(b) * E * C * vpr;
  V* yb = y + (size_t(b) * N + n0) * vpr;
  if constexpr (K1) {
    copy_rows<T, CR / DWARPS, VU, GATED>(yb, eb, s_src, s_w, nrows, vpr);
  } else {
    for (int r0 = warp; r0 < nrows; r0 += DWARPS * CRU) {
      for (int v0 = lane; v0 < vpr; v0 += 32 * CVU) {
        float acc[CRU][CVU][EPV];
#pragma unroll
        for (int u = 0; u < CRU; ++u)
#pragma unroll
          for (int j = 0; j < CVU; ++j)
#pragma unroll
            for (int e = 0; e < EPV; ++e) acc[u][j][e] = 0.f;
        for (int r = 0; r < k; ++r) {
          int src[CRU];
          float w[CRU];
#pragma unroll
          for (int u = 0; u < CRU; ++u) {
            const int row = r0 + u * DWARPS;
            src[u] = row < nrows ? s_src[r * CR + row] : -1;
            w[u] = GATED && row < nrows ? s_w[r * CR + row] : 1.f;
          }
          // a dropped assignment adds nothing and loads nothing
          V val[CRU][CVU];
          load_rows(val, eb, src, v0, vpr);
#pragma unroll
          for (int u = 0; u < CRU; ++u)
#pragma unroll
            for (int j = 0; j < CVU; ++j) {
              const T* el = reinterpret_cast<const T*>(&val[u][j]);
#pragma unroll
              for (int e = 0; e < EPV; ++e)
                acc[u][j][e] = fmaf(to_f(el[e]), w[u], acc[u][j][e]);
            }
        }
        V out[CRU][CVU];
#pragma unroll
        for (int u = 0; u < CRU; ++u)
#pragma unroll
          for (int j = 0; j < CVU; ++j) {
            T* o = reinterpret_cast<T*>(&out[u][j]);
#pragma unroll
            for (int e = 0; e < EPV; ++e) o[e] = from_f<T>(acc[u][j][e]);
          }
        store_rows(yb, out, r0, nrows, v0, vpr);
      }
    }
  }
}

// the routing read four entries a load where its rows allow
bool routing_vec4(int N, const int* eidx, const int* pos, const uint8_t* keep) {
  return N % 4 == 0 && reinterpret_cast<uintptr_t>(eidx) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(pos) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(keep) % 4 == 0;
}

template <typename T>
cudaError_t run_dispatch(const void* x, const int* eidx, const int* pos,
                         const uint8_t* keep, const float* gate, int B, int N,
                         int k, int E, int C, int D, int vec_bytes, void* out,
                         cudaStream_t st) {
  const int vpr = D * int(sizeof(T)) / vec_bytes;
  // 32-bit offsets inside a group's token rows and a CTA's slot rows;
  // grid.y holds the groups
  if ((long long)N * vpr > 2147483647LL || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((E * C + R - 1) / R, B);
  const bool vec4 = routing_vec4(N, eidx, pos, keep);
#define LAUNCH(V, G, Q)                                                      \
  dispatch_kernel<T, V, G, Q><<<grid, THREADS, 0, st>>>(                     \
      static_cast<const V*>(x), eidx, pos, keep, gate, N, k, E, C, vpr,      \
      static_cast<V*>(out))
#define DISPATCH(V)                                                          \
  if (gate != nullptr) {                                                     \
    if (vec4) LAUNCH(V, true, true); else LAUNCH(V, true, false);            \
  } else {                                                                   \
    if (vec4) LAUNCH(V, false, true); else LAUNCH(V, false, false);          \
  }
  switch (vec_bytes) {
    case 16: DISPATCH(uint4); break;
    case 8: DISPATCH(uint2); break;
    case 4: DISPATCH(uint32_t); break;
    default:
      if (sizeof(T) != 2) return cudaErrorInvalidValue;
      DISPATCH(T);
  }
#undef DISPATCH
#undef LAUNCH
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_combine(const void* eo, const int* eidx, const float* gate,
                        const int* pos, const uint8_t* keep, int B, int N,
                        int k, int E, int C, int D, int vec_bytes, void* y,
                        cudaStream_t st) {
  const int vpr = D * int(sizeof(T)) / vec_bytes;
  // 32-bit offsets inside a group's slot rows; the CTA's routing in at
  // most 48 KB of shared memory
  const size_t smem = size_t(k) * CR * (sizeof(int) + sizeof(float));
  if ((long long)E * C * vpr > 2147483647LL || B > 65535 || smem > 48 * 1024)
    return cudaErrorInvalidValue;
  const dim3 grid((N + CR - 1) / CR, B);
  const bool vec4 = routing_vec4(N, eidx, pos, keep);
#define LAUNCH(V, G, Q, K1)                                                  \
  combine_kernel<T, V, G, Q, K1><<<grid, THREADS, smem, st>>>(               \
      static_cast<const V*>(eo), eidx, gate, pos, keep, N, k, E, C, vpr,     \
      static_cast<V*>(y))
#define ROUNDS(V, G, Q)                                                      \
  if (k == 1) LAUNCH(V, G, Q, true); else LAUNCH(V, G, Q, false);
#define COMBINE(V)                                                           \
  if (gate != nullptr) {                                                     \
    if (vec4) { ROUNDS(V, true, true) } else { ROUNDS(V, true, false) }      \
  } else {                                                                   \
    if (vec4) { ROUNDS(V, false, true) } else { ROUNDS(V, false, false) }    \
  }
  switch (vec_bytes) {
    case 16: COMBINE(uint4); break;
    case 8: COMBINE(uint2); break;
    case 4: COMBINE(uint32_t); break;
    default:
      if (sizeof(T) != 2) return cudaErrorInvalidValue;
      COMBINE(T);
  }
#undef COMBINE
#undef ROUNDS
#undef LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All tensors contiguous; eidx, pos int32 [B, k, N]; keep bool [B, k, N];
// gate fp32 [B, k, N] or null; dtype 0 = float32, 1 = bfloat16,
// 2 = float16; vec_bytes (16, 8, 4, or 2 for 16-bit types) divides the
// row's D * itemsize bytes and the alignment of the row pointers.  Each
// returns the launch's cudaError_t (0 on success).

// x [B, N, D] -> out [B, E * C, D]; gate (optional) scales each row.
// One kernel launch, and no other device operation.
int moe_dispatch(const void* x, const void* eidx, const void* pos,
                 const void* keep, const void* gate, int B, int N, int k,
                 int E, int C, int D, int vec_bytes, void* out, int dtype,
                 void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not an older one
  if (B <= 0 || N <= 0 || k <= 0 || E <= 0 || C <= 0 || D <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ei = static_cast<const int*>(eidx);
  const int* ps = static_cast<const int*>(pos);
  const float* g = static_cast<const float*>(gate);
  const uint8_t* kp = static_cast<const uint8_t*>(keep);
  switch (dtype) {
    case 0: return run_dispatch<float>(x, ei, ps, kp, g, B, N, k, E, C, D, vec_bytes, out, st);
    case 1: return run_dispatch<__nv_bfloat16>(x, ei, ps, kp, g, B, N, k, E, C, D, vec_bytes, out, st);
    case 2: return run_dispatch<__half>(x, ei, ps, kp, g, B, N, k, E, C, D, vec_bytes, out, st);
    default: return cudaErrorInvalidValue;
  }
}

// expert_out [B, E * C, D] -> y [B, N, D]; gate null = unit weights
int moe_combine(const void* eo, const void* eidx, const void* gate,
                const void* pos, const void* keep, int B, int N, int k, int E,
                int C, int D, int vec_bytes, void* y, int dtype, void* stream) {
  (void)cudaGetLastError();
  if (B <= 0 || N <= 0 || k <= 0 || E <= 0 || C <= 0 || D <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ei = static_cast<const int*>(eidx);
  const int* ps = static_cast<const int*>(pos);
  const float* g = static_cast<const float*>(gate);
  const uint8_t* kp = static_cast<const uint8_t*>(keep);
  switch (dtype) {
    case 0: return run_combine<float>(eo, ei, g, ps, kp, B, N, k, E, C, D, vec_bytes, y, st);
    case 1: return run_combine<__nv_bfloat16>(eo, ei, g, ps, kp, B, N, k, E, C, D, vec_bytes, y, st);
    case 2: return run_combine<__half>(eo, ei, g, ps, kp, B, N, k, E, C, D, vec_bytes, y, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* moe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

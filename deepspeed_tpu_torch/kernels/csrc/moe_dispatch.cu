// Sort-based MoE token movement, written for Hopper (sm_90a).
//
// Replaces the TPU kernels of deepspeed_tpu/kernels/moe_kernels.py:
//   moe_dispatch  <- `_dispatch_kernel` (:52, pallas_call :90)
//   moe_combine   <- `_combine_kernel`  (:100, pallas_call :150)
// and computes what their plain PyTorch versions compute
// (deepspeed_tpu_torch/moe/dispatch.py `sorted_dispatch_ref`,
// `sorted_combine_ref`) for B token groups at once (the JAX package vmaps
// one group at a time over the batch rows; here one launch covers all B):
//   routing, per group b: eidx, pos [k, N] int32 and keep [k, N] bool,
//     round-major (assignment a = r * N + n carries token n); a kept
//     assignment owns slot e * C + pos of the [E * C] slots, uniquely.
//   moe_slot_sources (the prologue): slot_a[b, s] = the assignment that
//     fills slot s, or -1 (the inverse permutation of moe_kernels.py:67-74).
//   moe_dispatch: out[b, s] = x[b, slot_a[b, s] % N], or zeros where
//     slot_a is -1: a verbatim row copy, so bit-exact against the plain
//     version's add into zeros (equal values; a -0.0 input row comes back
//     -0.0 here and +0.0 from the add).  With `gate` (the combine's
//     gradient) each copied row is scaled by its assignment's weight
//     w = T(gate * keep), computed in fp32 and rounded once to T, as the
//     plain version's T multiply rounds.
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
// 8192 assignments.  The design: one thread moves 16 bytes (8 bf16 or 4
// fp32 values) of one row, neighbouring threads on neighbouring bytes of
// the row, so every load and store is a coalesced 16-byte vector (where
// the row length allows; narrower vectors otherwise); the row's source
// index is read once per thread from L1.  The TPU kernel's scalar-prefetch
// grid over slots becomes a flat grid over (slot, vector); the combine's
// sequential k axis is a loop inside the thread.

#include <cstdio>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// A kept assignment routed outside the [E, C] buckets (routing made for
// another capacity or expert count): the plain version's scatter raises
// there, so the kernel stops with a launch failure rather than write or
// read another row.
__device__ __forceinline__ void check_slot(const char* kernel, long long i,
                                           int e, int ps, int E, int C) {
  if (e < 0 || e >= E || ps < 0 || ps >= C) {
    printf("%s: kept assignment %lld routes to expert %d slot %d, outside "
           "[0, %d) x [0, %d)\n", kernel, i, e, ps, E, C);
    __trap();
  }
}

// one thread per assignment: slot_a[b][e * C + pos] = a for kept ones
// (slot_a was set to -1 by the caller's memset)
__global__ void __launch_bounds__(THREADS)
slot_sources_kernel(const int* __restrict__ eidx, const int* __restrict__ pos,
                    const uint8_t* __restrict__ keep, int B, int kN, int EC,
                    int C, int* __restrict__ slot_a) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)B * kN) return;
  if (!keep[i]) return;
  const long long b = i / kN;
  const int a = int(i - b * kN);
  check_slot("moe_slot_sources", i, eidx[i], pos[i], EC / C, C);
  slot_a[b * EC + eidx[i] * C + pos[i]] = a;
}

// V: the vector type one thread moves; T: the element type (for weights)
template <typename T, typename V>
__global__ void __launch_bounds__(THREADS)
dispatch_kernel(const V* __restrict__ x, const int* __restrict__ slot_a,
                const float* __restrict__ gate, const uint8_t* __restrict__ keep,
                int B, int N, int kN, int EC, int vpr, V* __restrict__ out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)B * EC * vpr) return;
  const long long row = i / vpr;          // b * EC + s
  const int v = int(i - row * vpr);
  const long long b = row / EC;
  const int a = slot_a[row];
  V val;
  if (a < 0) {
    val = V{};  // all-zero bits: +0.0
  } else {
    val = x[(b * N + a % N) * vpr + v];
    if (gate != nullptr) {
      const long long ga = b * kN + a;
      const float w = to_f(from_f<T>(keep[ga] ? gate[ga] : 0.f));
      T* e = reinterpret_cast<T*>(&val);
#pragma unroll
      for (int j = 0; j < int(sizeof(V) / sizeof(T)); ++j)
        e[j] = from_f<T>(to_f(e[j]) * w);
    }
  }
  out[i] = val;
}

template <typename T, typename V>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const V* __restrict__ eo, const int* __restrict__ eidx,
               const float* __restrict__ gate, const int* __restrict__ pos,
               const uint8_t* __restrict__ keep, int B, int N, int k, int EC,
               int C, int vpr, V* __restrict__ y) {
  constexpr int EPV = sizeof(V) / sizeof(T);  // elements per vector
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)B * N * vpr) return;
  const long long row = i / vpr;          // b * N + n
  const int v = int(i - row * vpr);
  const long long b = row / N;
  const int n = int(row - b * N);
  float acc[EPV];
#pragma unroll
  for (int j = 0; j < EPV; ++j) acc[j] = 0.f;
  for (int r = 0; r < k; ++r) {
    const long long ga = (b * k + r) * N + n;
    if (!keep[ga]) continue;               // the plain version's zero term
    const float w = gate ? to_f(from_f<T>(gate[ga])) : 1.f;
    check_slot("moe_combine", ga, eidx[ga], pos[ga], EC / C, C);
    V val = eo[(b * EC + eidx[ga] * C + pos[ga]) * vpr + v];
    const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
    for (int j = 0; j < EPV; ++j) acc[j] = fmaf(to_f(e[j]), w, acc[j]);
  }
  V out;
  T* o = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int j = 0; j < EPV; ++j) o[j] = from_f<T>(acc[j]);
  y[i] = out;
}

template <typename T>
cudaError_t run_dispatch(const void* x, const int* slot_a, const float* gate,
                         const uint8_t* keep, int B, int N, int kN, int EC,
                         int D, int vec_bytes, void* out, cudaStream_t st) {
  const int esz = sizeof(T);
  const int vpr = D * esz / vec_bytes;
  const long long total = (long long)B * EC * vpr;
  const long long grid = (total + THREADS - 1) / THREADS;
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  switch (vec_bytes) {
    case 16:
      dispatch_kernel<T, uint4><<<unsigned(grid), THREADS, 0, st>>>(
          static_cast<const uint4*>(x), slot_a, gate, keep, B, N, kN, EC, vpr,
          static_cast<uint4*>(out));
      break;
    case 8:
      dispatch_kernel<T, uint2><<<unsigned(grid), THREADS, 0, st>>>(
          static_cast<const uint2*>(x), slot_a, gate, keep, B, N, kN, EC, vpr,
          static_cast<uint2*>(out));
      break;
    case 4:
      dispatch_kernel<T, uint32_t><<<unsigned(grid), THREADS, 0, st>>>(
          static_cast<const uint32_t*>(x), slot_a, gate, keep, B, N, kN, EC,
          vpr, static_cast<uint32_t*>(out));
      break;
    default:
      if (esz != 2) return cudaErrorInvalidValue;
      dispatch_kernel<T, T><<<unsigned(grid), THREADS, 0, st>>>(
          static_cast<const T*>(x), slot_a, gate, keep, B, N, kN, EC, vpr,
          static_cast<T*>(out));
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_combine(const void* eo, const int* eidx, const float* gate,
                        const int* pos, const uint8_t* keep, int B, int N,
                        int k, int EC, int C, int D, int vec_bytes, void* y,
                        cudaStream_t st) {
  const int vpr = D * int(sizeof(T)) / vec_bytes;
  const long long total = (long long)B * N * vpr;
  const long long grid = (total + THREADS - 1) / THREADS;
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
#define COMBINE(V)                                                          \
  combine_kernel<T, V><<<unsigned(grid), THREADS, 0, st>>>(                 \
      static_cast<const V*>(eo), eidx, gate, pos, keep, B, N, k, EC, C, vpr, \
      static_cast<V*>(y))
  switch (vec_bytes) {
    case 16: COMBINE(uint4); break;
    case 8: COMBINE(uint2); break;
    case 4: COMBINE(uint32_t); break;
    default:
      if (sizeof(T) != 2) return cudaErrorInvalidValue;
      COMBINE(T);
  }
#undef COMBINE
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All tensors contiguous; eidx, pos int32 [B, k, N]; keep bool [B, k, N];
// gate fp32 [B, k, N] or null; dtype 0 = float32, 1 = bfloat16,
// 2 = float16; vec_bytes (16, 8, 4, or 2 for 16-bit types) divides the
// row's D * itemsize bytes and the alignment of the row pointers.  Each
// returns the launch's cudaError_t (0 on success).

// slot_a int32 [B, E * C]: set to -1, then each kept assignment's index
int moe_slot_sources(const void* eidx, const void* pos, const void* keep,
                     int B, int k, int N, int E, int C, void* slot_a,
                     void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not an older one
  if (B <= 0 || k <= 0 || N <= 0 || E <= 0 || C <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(slot_a, 0xFF, size_t(B) * E * C * sizeof(int), st);
  if (e != cudaSuccess) return e;
  const long long total = (long long)B * k * N;
  slot_sources_kernel<<<unsigned((total + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      static_cast<const int*>(eidx), static_cast<const int*>(pos),
      static_cast<const uint8_t*>(keep), B, k * N, E * C, C,
      static_cast<int*>(slot_a));
  return cudaGetLastError();
}

// x [B, N, D] -> out [B, E * C, D]; gate (optional) scales each row
int moe_dispatch(const void* x, const void* slot_a, const void* gate,
                 const void* keep, int B, int N, int k, int E, int C, int D,
                 int vec_bytes, void* out, int dtype, void* stream) {
  (void)cudaGetLastError();
  if (B <= 0 || N <= 0 || k <= 0 || E <= 0 || C <= 0 || D <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sa = static_cast<const int*>(slot_a);
  const float* g = static_cast<const float*>(gate);
  const uint8_t* kp = static_cast<const uint8_t*>(keep);
  switch (dtype) {
    case 0: return run_dispatch<float>(x, sa, g, kp, B, N, k * N, E * C, D, vec_bytes, out, st);
    case 1: return run_dispatch<__nv_bfloat16>(x, sa, g, kp, B, N, k * N, E * C, D, vec_bytes, out, st);
    case 2: return run_dispatch<__half>(x, sa, g, kp, B, N, k * N, E * C, D, vec_bytes, out, st);
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
    case 0: return run_combine<float>(eo, ei, g, ps, kp, B, N, k, E * C, C, D, vec_bytes, y, st);
    case 1: return run_combine<__nv_bfloat16>(eo, ei, g, ps, kp, B, N, k, E * C, C, D, vec_bytes, y, st);
    case 2: return run_combine<__half>(eo, ei, g, ps, kp, B, N, k, E * C, C, D, vec_bytes, y, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* moe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

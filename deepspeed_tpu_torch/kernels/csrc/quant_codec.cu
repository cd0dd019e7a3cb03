// Blockwise symmetric int8/int4 quantize and dequantize, written for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of deepspeed_tpu/kernels/quant_codec.py:
//   quant_codec_quantize    <- `_quant_kernel`   (:64, pallas_call :99)
//   quant_codec_dequantize  <- `_dequant_kernel` (:128, pallas_call :163)
// and computes, bit for bit, what their plain PyTorch versions compute
// (deepspeed_tpu_torch/runtime/comm/quant.py `quantize_blockwise_ref`,
// `dequantize_blockwise_ref`):
//   quantize: the flat input (fp32, bf16 or fp16; each converts to fp32
//     exactly) in blocks of `block` elements, the last zero-padded; per
//     block: fp32 subnormals flushed to 0, amax over the finite elements,
//     scale = fp16(amax / q) (q = 127 or 7), eff = fp32(scale),
//     inv = 1 / eff, or 0 where eff is 0 or not finite, code =
//     clip(rint(v * inv), -q, q), and the marker -q - 1 where v is not
//     finite.  int8 writes the codes [nb, block]; int4 packs two codes a
//     byte, low nibble first, [nb, block / 2].
//   dequantize: value = fp32(code) * fp32(scale) (exact: at most 8 bits
//     times 11), NaN for the marker, rounded once to the output dtype
//     (__float2bfloat16_rn / __float2half_rn, as torch's `.to()` and
//     XLA's convert round); only the first n elements of each row of
//     leading batch index are written (the padding sliced off).
// Bit-exactness rests on IEEE rounding at every step: `amax / q` and
// `1.0f / eff` are IEEE divisions (the build keeps --use_fast_math and
// -ftz out of its flags, so nvcc emits div.rn and keeps subnormals), the
// product v * inv is one rounded multiply (no add for it to fuse into),
// rintf rounds half to even as jnp.round and torch.round do,
// __float2half_rn gives inf on overflow and a correctly rounded fp16
// subnormal on underflow, the finiteness test comes before the amax, and
// the marker is set after the clip.
//
// What bounds it on this card: bytes.  Quantize reads each element once
// and writes one (int8) or half a byte (int4) plus 2 bytes a block;
// dequantize reads the codes and scales and writes the output.  The
// serving path dequantizes every weight matrix of GPT-2 XL (1.557 G
// elements) once a forward: 1.56 GB read and 3.11 GB of bf16 written at
// int8, 1.4 ms at 3.35 TB/s.  The design moves each element once:
//   * quantize: one warp per block, each lane a pair of neighbouring
//     elements at a time (the pair an int4 byte packs), the amax a warp
//     shuffle reduction; the block's elements are read twice (the second
//     read hits L1/L2).  The TPU kernel's 8-row tiles and 128-lane scale
//     broadcast are its layout and have no counterpart here.
//   * dequantize: one thread per 8 consecutive elements: 8 int8 codes
//     (one 8-byte load) or 4 packed int4 bytes, one scale, one 16-byte
//     store of 8 bf16 / fp16 values (two for fp32), where the block size
//     and the row length are multiples of 8; element by element
//     otherwise (the same arithmetic).

#include "common.cuh"

namespace {

constexpr int QUANT_THREADS = 256;   // 8 warps, one block of elements each
constexpr int DEQ_THREADS = 256;

__device__ __forceinline__ float flush_subnormal(float v) {
  // |v| < FLT_MIN is false for NaN, which stays NaN
  return fabsf(v) < 1.17549435e-38f ? 0.f : v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

template <typename T>
__device__ __forceinline__ float load_elem(const T* x, long long i, long long n) {
  return i < n ? flush_subnormal(to_f(x[i])) : 0.f;
}

__device__ __forceinline__ int encode(float v, float inv, int q) {
  if (!isfinite(v)) return -q - 1;  // the marker, after the clip below
  float c = rintf(v * inv);
  c = fminf(fmaxf(c, float(-q)), float(q));
  return int(c);
}

// one warp per block of `block` elements (block even)
template <typename T>
__global__ void __launch_bounds__(QUANT_THREADS)
quantize_kernel(const T* __restrict__ x, long long n, int block, int q,
                long long nb, void* __restrict__ payload,
                __half* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * (QUANT_THREADS / 32) + (threadIdx.x >> 5);
  if (b >= nb) return;  // whole warps leave together
  const long long base = b * block;
  const int pairs = block / 2;

  float amax = 0.f;
  for (int p = lane; p < pairs; p += 32) {
    const float v0 = load_elem(x, base + 2 * p, n);
    const float v1 = load_elem(x, base + 2 * p + 1, n);
    if (isfinite(v0)) amax = fmaxf(amax, fabsf(v0));
    if (isfinite(v1)) amax = fmaxf(amax, fabsf(v1));
  }
  amax = warp_max(amax);
  const __half s = __float2half_rn(amax / float(q));
  const float eff = __half2float(s);
  const float inv = (eff > 0.f && isfinite(eff)) ? 1.0f / eff : 0.f;
  if (lane == 0) scales[b] = s;

  for (int p = lane; p < pairs; p += 32) {
    const int c0 = encode(load_elem(x, base + 2 * p, n), inv, q);
    const int c1 = encode(load_elem(x, base + 2 * p + 1, n), inv, q);
    if (q == 127) {
      char2 v;
      v.x = static_cast<signed char>(c0);
      v.y = static_cast<signed char>(c1);
      reinterpret_cast<char2*>(payload)[b * pairs + p] = v;
    } else {
      reinterpret_cast<uint8_t*>(payload)[b * pairs + p] =
          static_cast<uint8_t>((c0 & 0xF) | ((c1 & 0xF) << 4));
    }
  }
}

// 8 output elements as one 16-byte store (bf16 / fp16) or two (fp32)
template <typename T> struct Vec8 {
  static __device__ __forceinline__ void store(T* dst, const float* v) {
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = Mma<T>::pack(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(dst) = out;
  }
};
template <> struct Vec8<float> {
  static __device__ __forceinline__ void store(float* dst, const float* v) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

__device__ __forceinline__ int code_at(const void* payload, int wire_q,
                                       long long i) {
  if (wire_q == 127) return reinterpret_cast<const signed char*>(payload)[i];
  const uint8_t byte = reinterpret_cast<const uint8_t*>(payload)[i >> 1];
  const int nib = (i & 1) ? (byte >> 4) : (byte & 0xF);
  return nib > 7 ? nib - 16 : nib;
}

__device__ __forceinline__ float decode(int code, float scale, int q) {
  const float v = float(code) * scale;
  return code == -q - 1 ? __int_as_float(0x7fffffff) : v;
}

// grid (groups of 8 elements of a row, rows); payload / scales of row l at
// l * nb * block elements / l * nb scales
template <typename T, bool VEC>
__global__ void __launch_bounds__(DEQ_THREADS)
dequantize_kernel(const void* __restrict__ payload,
                  const __half* __restrict__ scales, int block, int q,
                  long long nb, long long n, T* __restrict__ out) {
  const long long grp = (long long)blockIdx.x * DEQ_THREADS + threadIdx.x;
  const long long e0 = grp * 8;
  if (e0 >= n) return;
  const long long row = blockIdx.y;
  const long long pe0 = row * nb * block;  // the row's first padded element
  const __half* srow = scales + row * nb;
  T* orow = out + row * n;
  float v[8];
  if (VEC && e0 + 8 <= n) {
    // the 8 elements share a block (block % 8 == 0)
    const float s = __half2float(srow[e0 / block]);
    int c[8];
    if (q == 127) {
      const uint2 raw = *reinterpret_cast<const uint2*>(
          reinterpret_cast<const signed char*>(payload) + pe0 + e0);
      const signed char* b = reinterpret_cast<const signed char*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) c[j] = b[j];
    } else {
      const uint32_t raw = *reinterpret_cast<const uint32_t*>(
          reinterpret_cast<const uint8_t*>(payload) + (pe0 + e0) / 2);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nib = (raw >> (4 * j)) & 0xF;
        c[j] = nib > 7 ? nib - 16 : nib;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = decode(c[j], s, q);
    Vec8<T>::store(orow + e0, v);
  } else {
    for (long long e = e0; e < e0 + 8 && e < n; ++e) {
      const float s = __half2float(srow[e / block]);
      orow[e] = from_f<T>(decode(code_at(payload, q, pe0 + e), s, q));
    }
  }
}

template <typename T>
cudaError_t launch_quantize(const void* x, long long n, int block, int q,
                            void* payload, void* scales, cudaStream_t st) {
  const long long nb = (n + block - 1) / block;
  const long long grid = (nb + QUANT_THREADS / 32 - 1) / (QUANT_THREADS / 32);
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  quantize_kernel<T><<<unsigned(grid), QUANT_THREADS, 0, st>>>(
      static_cast<const T*>(x), n, block, q, nb, payload,
      static_cast<__half*>(scales));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dequantize(const void* payload, const void* scales,
                              int block, int q, long long nb, long long n,
                              int rows, void* out, bool vec, cudaStream_t st) {
  const long long groups = (n + 7) / 8;
  const long long gx = (groups + DEQ_THREADS - 1) / DEQ_THREADS;
  if (gx > 2147483647LL || rows > 65535) return cudaErrorInvalidValue;
  dim3 grid(unsigned(gx), rows);
  const __half* s = static_cast<const __half*>(scales);
  if (vec)
    dequantize_kernel<T, true><<<grid, DEQ_THREADS, 0, st>>>(
        payload, s, block, q, nb, n, static_cast<T*>(out));
  else
    dequantize_kernel<T, false><<<grid, DEQ_THREADS, 0, st>>>(
        payload, s, block, q, nb, n, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: n contiguous elements of `dtype` (0 = float32, 1 = bfloat16,
// 2 = float16); block even; q = 127 (int8: payload int8 [nb, block]) or 7
// (int4: payload uint8 [nb, block / 2]); scales fp16 [nb], nb =
// ceil(n / block).  Returns the launch's cudaError_t (0 on success).
int quant_codec_quantize(const void* x, long long n, int block, int q,
                         void* payload, void* scales, int dtype, void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not an older one
  if (n <= 0 || block <= 0 || block % 2 || (q != 127 && q != 7))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_quantize<float>(x, n, block, q, payload, scales, st);
    case 1: return launch_quantize<__nv_bfloat16>(x, n, block, q, payload, scales, st);
    case 2: return launch_quantize<__half>(x, n, block, q, payload, scales, st);
    default: return cudaErrorInvalidValue;
  }
}

// payload [rows, nb, block | block / 2] and scales fp16 [rows, nb],
// contiguous; out [rows, n] of `dtype` (n <= nb * block).  The 16-byte
// path needs block % 8 == 0, n % 8 == 0 and 16-byte aligned payload and
// output (the wrapper decides: vec).
int quant_codec_dequantize(const void* payload, const void* scales, int block,
                           int q, long long nb, long long n, int rows,
                           void* out, int vec, int dtype, void* stream) {
  (void)cudaGetLastError();
  if (n <= 0 || nb <= 0 || rows <= 0 || block <= 0 || block % 2 ||
      n > nb * block || (q != 127 && q != 7))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dequantize<float>(payload, scales, block, q, nb, n, rows, out, vec, st);
    case 1: return launch_dequantize<__nv_bfloat16>(payload, scales, block, q, nb, n, rows, out, vec, st);
    case 2: return launch_dequantize<__half>(payload, scales, block, q, nb, n, rows, out, vec, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* quant_codec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Blockwise symmetric int8/int4 quantize and dequantize, written for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of deepspeed_tpu/kernels/quant_codec.py:
//   quant_codec_quantize    <- `_quant_kernel`   (:64, pallas_call :98)
//   quant_codec_dequantize  <- `_dequant_kernel` (:128, pallas_call :160)
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
// cvt.rni (__float2int_rn) rounds half to even as jnp.round and
// torch.round do, __float2half_rn gives inf on overflow and a correctly
// rounded fp16 subnormal on underflow, the finiteness test comes before
// the amax, and the marker is set after the clip.
//
// What bounds it on this card: bytes.  Quantize reads each element once
// and writes one (int8) or half a byte (int4) plus 2 bytes a block;
// dequantize reads the codes and scales and writes the output.  The
// serving path dequantizes every weight matrix of GPT-2 XL (1.557 G
// elements) once a forward: 1.56 GB read and 3.11 GB of bf16 written at
// int8, 1.4 ms at 3.35 TB/s.  The design moves each element once:
//   * quantize, the vector route (block % 8 == 0, L = block / 8 a power
//     of two up to 32 or a multiple of 32, x 16-byte aligned; the wrapper
//     decides, `quant_codec.route_of`): one read and one write of each
//     element.  A tile is 32 NV vectors of 8 consecutive elements; each
//     lane holds NV of them in registers (one 16-byte load each, two for
//     fp32), lane l's j-th at 32 j + l, so every load moves 512
//     contiguous bytes of a 16-bit input and all NV are issued before the
//     first reduction.  A block spans L lanes of one j (32 / L blocks a j,
//     the amax a shuffle max over the segment) where L <= 32, or m = L /
//     32 consecutive j of every lane where m is a power of two up to
//     NV_LONG (a max over those j, then over the warp).  At block 256 a
//     tile is NV = BPW blocks.  The grid is persistent (the CTAs the card
//     holds at once): each warp walks its tiles with the next one's loads
//     in flight while it encodes the current one, which took GPT-2 XL's
//     194 leaves from 2.33 to 2.10 ms against one tile a warp (PERF.md).
//     The codes are encoded from the registers and stored as one 8-byte
//     (int8) or 4-byte (int4) word a vector; one lane of each block
//     writes its scale.  Blocks of 32 m vectors with m not such a power
//     of two stream through one warp a block, reading it twice (amax,
//     then encode), still 16 bytes a load.  Index arithmetic is 32-bit
//     inside a tile, 64-bit only for its base.  The tile that reaches
//     past n (the ragged last block, or n no multiple of 8) loads element
//     by element, zeros past n.
//   * quantize, the generic route (any other even block, or x not 16-byte
//     aligned): one warp per block, each lane a pair of neighbouring
//     elements at a time (the pair an int4 byte packs), the amax a warp
//     shuffle reduction; the block's elements are read twice (the second
//     read hits L1/L2).  The TPU kernel's 8-row tiles and 128-lane scale
//     broadcast are its layout and have no counterpart here.
//   * dequantize: one thread per 8 consecutive elements: 8 int8 codes
//     (one 8-byte load) or 4 packed int4 bytes, one scale, one 16-byte
//     store of 8 bf16 / fp16 values (two for fp32), where the block size
//     and the row length are multiples of 8; element by element
//     otherwise (the same arithmetic).
// The vector route needs no subnormal flush: an fp32 subnormal changes
// neither the scale (a block whose finite amax is below FLT_MIN has
// amax / q below fp16's half-way point 2^-25 either way, so its scale is
// +0 flushed or not) nor a code (inv <= 2^24 once eff >= 2^-24, so
// |v * inv| < 2^-102 rounds to 0).

#include "common.cuh"

namespace {

constexpr int QUANT_THREADS = 256;   // 8 warps
constexpr int QUANT_WARPS = QUANT_THREADS / 32;
constexpr int DEQ_THREADS = 256;
// The vector route: NV, the vectors a lane holds, is BPW where a block
// is at most 32 BPW vectors (at block 256 a warp then takes BPW blocks;
// chip_ab.py's codec-leaves turns over BPW 1, 2 and 4 kept the fastest,
// PERF.md), and NV_LONG beyond that, for blocks up to 32 NV_LONG vectors
// (2048 elements)
constexpr int BPW = 2;
constexpr int NV_LONG = 8;

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

// |v| where v is finite, else 0 (NaN fails the comparison)
__device__ __forceinline__ float finite_abs(float v) {
  return fabsf(v) < __int_as_float(0x7f800000) ? fabsf(v) : 0.f;
}

// a block's fp16 scale and the reciprocal its codes are taken with
struct Scale {
  __half s;
  float inv;
};
__device__ __forceinline__ Scale block_scale(float amax, int q) {
  const __half s = __float2half_rn(amax / float(q));
  const float eff = __half2float(s);
  return {s, (eff > 0.f && isfinite(eff)) ? 1.0f / eff : 0.f};
}

// rint (half to even) and the conversion in one cvt.rni: v * inv is
// finite for a finite v (|v| <= amax, and inv = 0 or eff >= 2^-24 with
// amax / eff below 1.5 q), so this is rintf, the clip and int(); the
// marker after the clip
__device__ __forceinline__ int encode(float v, float inv, int q) {
  const int c = min(max(__float2int_rn(v * inv), -q), q);
  return isfinite(v) ? c : -q - 1;
}

// the generic route: one warp per block of `block` elements (block even)
template <typename T>
__global__ void __launch_bounds__(QUANT_THREADS)
quantize_kernel(const T* __restrict__ x, long long n, int block, int q,
                long long nb, void* __restrict__ payload,
                __half* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * QUANT_WARPS + (threadIdx.x >> 5);
  if (b >= nb) return;  // whole warps leave together
  const long long base = b * block;
  const int pairs = block / 2;

  float amax = 0.f;
  for (int p = lane; p < pairs; p += 32) {
    amax = fmaxf(amax, finite_abs(load_elem(x, base + 2 * p, n)));
    amax = fmaxf(amax, finite_abs(load_elem(x, base + 2 * p + 1, n)));
  }
  const Scale sc = block_scale(warp_max(amax), q);
  if (lane == 0) scales[b] = sc.s;

  for (int p = lane; p < pairs; p += 32) {
    const int c0 = encode(load_elem(x, base + 2 * p, n), sc.inv, q);
    const int c1 = encode(load_elem(x, base + 2 * p + 1, n), sc.inv, q);
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

// 8 consecutive elements of x as fp32: one 16-byte load (two for fp32)
// where all 8 lie below n (`whole`), else element by element with zeros
// past n (the zero padding of the last block)
template <typename T>
__device__ __forceinline__ void load8(const T* p, long long e0, long long n,
                                      bool whole, float* v) {
  if (whole) {
    if constexpr (sizeof(T) == 4) {
      const float4 a = reinterpret_cast<const float4*>(p)[0];
      const float4 b = reinterpret_cast<const float4*>(p)[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = to_f(e[t]);
    }
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = e0 + t < n ? to_f(p[t]) : 0.f;
  }
}

__device__ __forceinline__ float amax8(const float* v) {
  float a = finite_abs(v[0]);
#pragma unroll
  for (int t = 1; t < 8; ++t) a = fmaxf(a, finite_abs(v[t]));
  return a;
}

// the 8 codes of one vector as one word: 8 bytes (int8) or 4 (int4, the
// low nibble first in each byte)
template <int Q>
__device__ __forceinline__ void store8(void* payload, long long vi,
                                       const float* v, float inv) {
  if constexpr (Q == 127) {
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int t = 0; t < 8; ++t)
      w[t >> 2] |= uint32_t(encode(v[t], inv, Q) & 0xFF) << (8 * (t & 3));
    reinterpret_cast<uint2*>(payload)[vi] = make_uint2(w[0], w[1]);
  } else {
    uint32_t w = 0u;
#pragma unroll
    for (int t = 0; t < 8; ++t) w |= uint32_t(encode(v[t], inv, Q) & 0xF) << (4 * t);
    reinterpret_cast<uint32_t*>(payload)[vi] = w;
  }
}

// A lane's NV vectors of a whole tile as they were loaded: one uint4 a
// vector of a 16-bit input, two of fp32 (VW)
template <typename T, int NV>
struct RawTile {
  static constexpr int VW = sizeof(T) / 2;
  uint4 w[NV][VW];

  __device__ __forceinline__ void load(const T* xt, int lane) {
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int h = 0; h < VW; ++h)
        w[j][h] = reinterpret_cast<const uint4*>(xt + (32 * j + lane) * 8)[h];
  }
  __device__ __forceinline__ void to_float(float (&v)[NV][8]) const {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const T* e = reinterpret_cast<const T*>(&w[j][0]);
#pragma unroll
      for (int t = 0; t < 8; ++t) v[j][t] = to_f(e[t]);
    }
  }
};

// One tile's blocks from its lane's NV vectors in registers: the amax
// of each vector's block, the scales, the codes.  `partial`: the tile
// reaches past the padded input's nvec vectors (only the last one can).
template <int Q, int NV>
__device__ __forceinline__ void encode_tile(float (&v)[NV][8], long long v0,
                                            int lshift, long long nvec,
                                            bool partial, int lane,
                                            void* __restrict__ payload,
                                            __half* __restrict__ scales) {
  const int L = 1 << lshift;
  float amax[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) amax[j] = amax8(v[j]);
  if (L <= 32) {
    // a block is L neighbouring lanes of one j
    for (int o = 1; o < L; o <<= 1)
#pragma unroll
      for (int j = 0; j < NV; ++j)
        amax[j] = fmaxf(amax[j], __shfl_xor_sync(FULL, amax[j], o));
  } else {
    // a block is m = L / 32 consecutive j (aligned: m divides NV) of
    // every lane
    const int m = L >> 5;
#pragma unroll
    for (int s = 1; s < NV; s <<= 1) {
      if (s < m) {
        float t[NV];
#pragma unroll
        for (int j = 0; j < NV; ++j) t[j] = fmaxf(amax[j], amax[j ^ s]);
#pragma unroll
        for (int j = 0; j < NV; ++j) amax[j] = t[j];
      }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) amax[j] = warp_max(amax[j]);
  }

  const long long b0 = v0 >> lshift;  // the tile's first block
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int rel = 32 * j + lane;  // the vector's index in the tile
    if (partial && v0 + rel >= nvec) continue;
    const Scale sc = block_scale(amax[j], Q);
    if ((rel & (L - 1)) == 0) scales[b0 + (rel >> lshift)] = sc.s;
    store8<Q>(payload, v0 + rel, v[j], sc.inv);
  }
}

// The vector route where a tile of 32 NV vectors holds whole blocks of
// L = 2^lshift vectors (L <= 32, or L = 32 m with m dividing NV).  A
// persistent grid: warp w takes tiles w, w + W, w + 2 W, ... (W the
// grid's warps); the loads of its next tile are in flight while it
// encodes the current one.  The tiles that lie wholly below n
// (`nwhole`) load 16 bytes at a time; the one after them, if any, is the
// ragged end and loads element by element.
template <typename T, int Q, int NV>
__global__ void __launch_bounds__(QUANT_THREADS)
quantize_vec_kernel(const T* __restrict__ x, long long n, int lshift,
                    long long nb, void* __restrict__ payload,
                    __half* __restrict__ scales) {
  constexpr long long TILE = 32 * NV;  // vectors
  const int lane = threadIdx.x & 31;
  const long long nvec = nb << lshift;
  const long long ntiles = (nvec + TILE - 1) / TILE;
  const long long nwhole = n / (8 * TILE);
  const long long stride = (long long)gridDim.x * QUANT_WARPS;
  long long t = (long long)blockIdx.x * QUANT_WARPS + (threadIdx.x >> 5);

  RawTile<T, NV> cur;
  if (t < nwhole) cur.load(x + t * TILE * 8, lane);
  while (t < nwhole) {
    const long long next = t + stride;
    RawTile<T, NV> nxt;
    if (next < nwhole) nxt.load(x + next * TILE * 8, lane);
    float v[NV][8];
    cur.to_float(v);
    encode_tile<Q, NV>(v, t * TILE, lshift, nvec, false, lane, payload,
                       scales);
    cur = nxt;
    t = next;
  }
  if (t == nwhole && t < ntiles) {
    const long long v0 = t * TILE;
    float v[NV][8];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const long long e0 = (v0 + 32 * j + lane) * 8;
      load8(x + e0, e0, n, false, v[j]);
    }
    encode_tile<Q, NV>(v, v0, lshift, nvec, true, lane, payload, scales);
  }
}

// The vector route for the other blocks of L = 32 m vectors: one warp a
// block, each lane every 32nd vector, the block read twice (amax, then
// encode).
template <typename T, int Q>
__global__ void __launch_bounds__(QUANT_THREADS)
quantize_vec_stream_kernel(const T* __restrict__ x, long long n, int L,
                           long long nb, void* __restrict__ payload,
                           __half* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * QUANT_WARPS + (threadIdx.x >> 5);
  if (b >= nb) return;
  const long long v0 = b * L;
  const bool whole = (v0 + L) * 8 <= n;
  const T* xb = x + v0 * 8;
  float v[8];
  float amax = 0.f;
#pragma unroll 4
  for (int i = lane; i < L; i += 32) {
    load8(xb + i * 8, (v0 + i) * 8, n, whole, v);
    amax = fmaxf(amax, amax8(v));
  }
  const Scale sc = block_scale(warp_max(amax), Q);
  if (lane == 0) scales[b] = sc.s;
#pragma unroll 4
  for (int i = lane; i < L; i += 32) {
    load8(xb + i * 8, (v0 + i) * 8, n, whole, v);
    store8<Q>(payload, v0 + i, v, sc.inv);
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

// the persistent vector kernel's grid: the CTAs the card holds at once,
// or fewer where the tiles do not fill them
template <typename T, int Q, int NV>
unsigned vec_ctas(long long tiles) {
  static const int per_sm = [] {
    int ctas = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, quantize_vec_kernel<T, Q, NV>, QUANT_THREADS, 0);
    return ctas;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (tiles + QUANT_WARPS - 1) / QUANT_WARPS;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return unsigned(want < most ? want : most);
}

template <typename T, int Q>
cudaError_t launch_quantize_q(const T* x, long long n, int block, long long nb,
                              bool vec, void* payload, __half* scales,
                              cudaStream_t st) {
  const int L = block / 8;
  int lshift = 0;
  while ((1 << lshift) < L) ++lshift;
  const bool pow2 = vec && (1 << lshift) == L;
  const int nv = !pow2 ? 0 : L <= 32 * BPW ? BPW : L <= 32 * NV_LONG ? NV_LONG : 0;
  const long long tiles = nv ? (nb * L + 32 * nv - 1) / (32 * nv) : 0;
  // the generic and stream kernels: one block a warp
  const long long grid = (nb + QUANT_WARPS - 1) / QUANT_WARPS;
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  if (!vec) {
    quantize_kernel<T><<<unsigned(grid), QUANT_THREADS, 0, st>>>(
        x, n, block, Q, nb, payload, scales);
  } else if (nv == BPW) {
    quantize_vec_kernel<T, Q, BPW><<<vec_ctas<T, Q, BPW>(tiles),
                                     QUANT_THREADS, 0, st>>>(
        x, n, lshift, nb, payload, scales);
  } else if (nv == NV_LONG) {
    quantize_vec_kernel<T, Q, NV_LONG><<<vec_ctas<T, Q, NV_LONG>(tiles),
                                         QUANT_THREADS, 0, st>>>(
        x, n, lshift, nb, payload, scales);
  } else {
    quantize_vec_stream_kernel<T, Q><<<unsigned(grid), QUANT_THREADS, 0, st>>>(
        x, n, L, nb, payload, scales);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_quantize(const void* x, long long n, int block, int q,
                            bool vec, void* payload, void* scales,
                            cudaStream_t st) {
  const long long nb = (n + block - 1) / block;
  const T* xt = static_cast<const T*>(x);
  __half* s = static_cast<__half*>(scales);
  return q == 127
             ? launch_quantize_q<T, 127>(xt, n, block, nb, vec, payload, s, st)
             : launch_quantize_q<T, 7>(xt, n, block, nb, vec, payload, s, st);
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
// ceil(n / block); vec: the vector route (block % 8 == 0, block / 8 a
// power of two up to 32 or a multiple of 32, x 16-byte aligned; the
// wrapper decides, as `quant_codec.route_of` says), else the generic
// one.  Returns the launch's cudaError_t (0 on success).
int quant_codec_quantize(const void* x, long long n, int block, int q,
                         void* payload, void* scales, int vec, int dtype,
                         void* stream) {
  (void)cudaGetLastError();  // report this launch's error, not an older one
  if (n <= 0 || block <= 0 || block % 2 || (q != 127 && q != 7))
    return cudaErrorInvalidValue;
  const int L = block / 8;
  if (vec && (block % 8 || ((L & (L - 1)) && L % 32) ||
              reinterpret_cast<uintptr_t>(x) % 16))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_quantize<float>(x, n, block, q, vec, payload, scales, st);
    case 1: return launch_quantize<__nv_bfloat16>(x, n, block, q, vec, payload, scales, st);
    case 2: return launch_quantize<__half>(x, n, block, q, vec, payload, scales, st);
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

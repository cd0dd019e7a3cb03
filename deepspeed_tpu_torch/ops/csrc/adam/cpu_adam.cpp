// Host-side vectorized Adam for optimizer-state offload.
//
// TPU-native equivalent of the reference's AVX/OpenMP CPU-Adam
// (/root/reference/csrc/adam/cpu_adam.cpp: SIMD macros cpu_adam.h:25-45,
// OpenMP tiling): the fp32 master params + moments live in host RAM while
// the device keeps bf16 working weights. Vectorization comes from
// `#pragma omp simd` + -O3 -march=native (AVX-512 on TPU-VM hosts) instead
// of hand-written intrinsics; same math, same memory traffic.
//
// C ABI (ctypes-loaded; no pybind11 in this image).

#include <cstdint>
#include <cmath>
#include <cstring>

extern "C" {

// One fused Adam step over a flat fp32 shard.
// adam_w != 0 -> decoupled weight decay (AdamW), else classic L2.
// bc1/bc2 are the bias-correction denominators (1 - beta^t), precomputed.
void ds_adam_step(int64_t n,
                  float* p,
                  const float* g,
                  float* m,
                  float* v,
                  float lr,
                  float beta1,
                  float beta2,
                  float eps,
                  float weight_decay,
                  int adam_w,
                  float bc1,
                  float bc2) {
    const float om_b1 = 1.0f - beta1;
    const float om_b2 = 1.0f - beta2;
#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float grad = g[i];
        if (!adam_w && weight_decay != 0.0f) grad += weight_decay * p[i];
        float mi = beta1 * m[i] + om_b1 * grad;
        float vi = beta2 * v[i] + om_b2 * grad * grad;
        m[i] = mi;
        v[i] = vi;
        float denom = sqrtf(vi / bc2) + eps;
        float update = (mi / bc1) / denom;
        if (adam_w && weight_decay != 0.0f) update += weight_decay * p[i];
        p[i] -= lr * update;
    }
}

// Same step but also emits the updated params as bf16 (round-to-nearest-even)
// into `out16` — the wire format copied back to device HBM.
void ds_adam_step_bf16(int64_t n,
                       float* p,
                       const float* g,
                       float* m,
                       float* v,
                       uint16_t* out16,
                       float lr,
                       float beta1,
                       float beta2,
                       float eps,
                       float weight_decay,
                       int adam_w,
                       float bc1,
                       float bc2) {
    ds_adam_step(n, p, g, m, v, lr, beta1, beta2, eps, weight_decay, adam_w,
                 bc1, bc2);
#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        uint32_t bits;
        memcpy(&bits, &p[i], sizeof(bits));
        uint32_t rounding = 0x7FFFu + ((bits >> 16) & 1u);
        out16[i] = static_cast<uint16_t>((bits + rounding) >> 16);
    }
}

}  // extern "C"

// Paged attention (paged_attention.cuh) over fp32 and bf16 dense caches:
// the split-keys route, and the tensor-core route at bf16.
#include "paged_attention.cuh"

namespace {

cudaError_t dispatch(int cache, int q_dtype, int Dh, int route, const Args& a) {
  if (cache == 0) return launch_dense<float>(q_dtype, Dh, route, a);
  if (cache == 1) return launch_dense<__nv_bfloat16>(q_dtype, Dh, route, a);
  return cudaErrorInvalidValue;
}

}  // namespace

PAGED_ATTENTION_ENTRY(dispatch)

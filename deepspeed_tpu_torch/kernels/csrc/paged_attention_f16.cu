// Paged attention (paged_attention.cuh) over fp16 dense caches: the
// split-keys and the tensor-core routes.
#include "paged_attention.cuh"

namespace {

cudaError_t dispatch(int cache, int q_dtype, int Dh, int route, const Args& a) {
  if (cache == 2) return launch_dense<__half>(q_dtype, Dh, route, a);
  return cudaErrorInvalidValue;
}

}  // namespace

PAGED_ATTENTION_ENTRY(dispatch)

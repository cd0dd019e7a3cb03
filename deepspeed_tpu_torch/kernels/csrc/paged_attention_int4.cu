// Paged attention (paged_attention.cuh) over int4 caches (two codes a
// byte and fp16 scales, dequantized in the gather): the split-keys route.
#include "paged_attention.cuh"

namespace {

cudaError_t dispatch(int cache, int q_dtype, int Dh, int route, const Args& a) {
  if (cache == 4 && route == 0) return launch_quant<Int4>(q_dtype, Dh, a);
  return cudaErrorInvalidValue;
}

}  // namespace

PAGED_ATTENTION_ENTRY(dispatch)

"""deepspeed_tpu_torch.kernels — hand-written Hopper kernels beside their
plain PyTorch versions, selected by `registry.dispatch`.

Importing this package builds nothing: `build.py` compiles a kernel's
library at its first launch.
"""

from .registry import KERNEL_IMPLS, KERNEL_OPS, dispatch, get_kernel, resolve_impl

__all__ = ["KERNEL_IMPLS", "KERNEL_OPS", "dispatch", "get_kernel",
           "resolve_impl"]

"""Kernel selection: the port's counterpart of
deepspeed_tpu/kernels/registry.py (`resolve_impl` :473, `dispatch` :508).

Each op pairs a hand-written kernel with its plain PyTorch version:

* `"auto"`  — the kernel for a CUDA tensor, the plain version for a CPU
  tensor.  The device of the first argument decides; nothing else does.
* `"cuda"`  — the kernel; on a CPU tensor this raises.
* `"torch"` — the plain version, also on a CUDA tensor, but only when
  asked for by name (the comparisons in chip_smoke.py do; the serving
  and training paths never do).

On a CUDA tensor the kernel launches or raises: no path catches a
kernel error and runs the plain version instead.  Every dispatch bumps
`kernel.dispatches` (kernel chosen) or `kernel.fallbacks` (plain
version chosen); the port runs eagerly, so these count calls.
"""

from __future__ import annotations

from typing import Dict

from ..monitor.counters import COUNTERS

KERNEL_IMPLS = ("auto", "cuda", "torch")


class KernelOp:
    NAME = "base"

    def kernel(self, *args, **kwargs):
        raise NotImplementedError

    def plain(self, *args, **kwargs):
        raise NotImplementedError


class PagedAttentionOp(KernelOp):
    """Paged attention over the PagedKVCache (kernels/paged.py)."""

    NAME = "paged_attention"

    def kernel(self, *args, **kwargs):
        from . import paged
        return paged.paged_attention_cuda(*args, **kwargs)

    def plain(self, *args, **kwargs):
        from . import paged
        return paged.paged_attention_reference(*args, **kwargs)


class FlashAttentionFwdOp(KernelOp):
    """Flash attention forward -> (out, lse) (kernels/flash.py)."""

    NAME = "flash_attention_fwd"

    def kernel(self, *args, **kwargs):
        from . import flash
        return flash.flash_fwd_cuda(*args, **kwargs)

    def plain(self, *args, **kwargs):
        from ..ops.transformer.flash_attention import _fwd_plain
        return _fwd_plain(*args, **kwargs)


class FlashAttentionDqOp(KernelOp):
    """Flash attention dQ (kernels/flash.py)."""

    NAME = "flash_attention_dq"

    def kernel(self, *args, **kwargs):
        from . import flash
        return flash.flash_dq_cuda(*args, **kwargs)

    def plain(self, *args, **kwargs):
        from ..ops.transformer.flash_attention import _dq_plain
        return _dq_plain(*args, **kwargs)


class FlashAttentionDkvOp(KernelOp):
    """Flash attention dK, dV (kernels/flash.py)."""

    NAME = "flash_attention_dkv"

    def kernel(self, *args, **kwargs):
        from . import flash
        return flash.flash_dkv_cuda(*args, **kwargs)

    def plain(self, *args, **kwargs):
        from ..ops.transformer.flash_attention import _dkv_plain
        return _dkv_plain(*args, **kwargs)


class FusedXentFwdOp(KernelOp):
    """Fused LM-head CE forward -> (lse, label logit) (kernels/fused_xent.py)."""

    NAME = "fused_xent_fwd"

    def kernel(self, *args, **kwargs):
        from . import fused_xent
        return fused_xent.fused_xent_fwd_cuda(*args, **kwargs)

    def plain(self, *args, **kwargs):
        from ..ops.transformer.fused_xent import _fwd_plain
        return _fwd_plain(*args, **kwargs)


class FusedXentDxOp(KernelOp):
    """Fused LM-head CE dx (kernels/fused_xent.py)."""

    NAME = "fused_xent_dx"

    def kernel(self, *args, **kwargs):
        from . import fused_xent
        return fused_xent.fused_xent_dx_cuda(*args, **kwargs)

    def plain(self, *args, **kwargs):
        from ..ops.transformer.fused_xent import _dx_plain
        return _dx_plain(*args, **kwargs)


class FusedXentDwOp(KernelOp):
    """Fused LM-head CE dW (kernels/fused_xent.py)."""

    NAME = "fused_xent_dw"

    def kernel(self, *args, **kwargs):
        from . import fused_xent
        return fused_xent.fused_xent_dw_cuda(*args, **kwargs)

    def plain(self, *args, **kwargs):
        from ..ops.transformer.fused_xent import _dw_plain
        return _dw_plain(*args, **kwargs)


class QuantCodecQuantizeOp(KernelOp):
    """Blockwise int8/int4 quantize (kernels/quant_codec.py)."""

    NAME = "quant_codec_quantize"

    def kernel(self, *args, **kwargs):
        from . import quant_codec
        return quant_codec.quantize_blockwise_cuda(*args, **kwargs)

    def plain(self, *args, **kwargs):
        from ..runtime.comm.quant import quantize_blockwise_ref
        return quantize_blockwise_ref(*args, **kwargs)


class QuantCodecDequantizeOp(KernelOp):
    """Blockwise int8/int4 dequantize (kernels/quant_codec.py)."""

    NAME = "quant_codec_dequantize"

    def kernel(self, *args, **kwargs):
        from . import quant_codec
        return quant_codec.dequantize_blockwise_cuda(*args, **kwargs)

    def plain(self, *args, **kwargs):
        from ..runtime.comm.quant import dequantize_blockwise_ref
        return dequantize_blockwise_ref(*args, **kwargs)


class MoEDispatchOp(KernelOp):
    """Sorted MoE dispatch, tokens -> expert buckets (kernels/moe_kernels.py)."""

    NAME = "moe_dispatch"

    def kernel(self, *args, **kwargs):
        from . import moe_kernels
        return moe_kernels.sorted_dispatch_cuda(*args, **kwargs)

    def plain(self, *args, **kwargs):
        from ..moe.dispatch import sorted_dispatch_ref
        return sorted_dispatch_ref(*args, **kwargs)


class MoECombineOp(KernelOp):
    """Sorted MoE gated combine (kernels/moe_kernels.py)."""

    NAME = "moe_combine"

    def kernel(self, *args, **kwargs):
        from . import moe_kernels
        return moe_kernels.sorted_combine_cuda(*args, **kwargs)

    def plain(self, *args, **kwargs):
        from ..moe.dispatch import sorted_combine_ref
        return sorted_combine_ref(*args, **kwargs)


KERNEL_OPS: Dict[str, KernelOp] = {
    op.NAME: op for op in (PagedAttentionOp(), FlashAttentionFwdOp(),
                           FlashAttentionDqOp(), FlashAttentionDkvOp(),
                           FusedXentFwdOp(), FusedXentDxOp(),
                           FusedXentDwOp(), QuantCodecQuantizeOp(),
                           QuantCodecDequantizeOp(), MoEDispatchOp(),
                           MoECombineOp())}


def get_kernel(name: str) -> KernelOp:
    if name not in KERNEL_OPS:
        raise ValueError(
            f"unknown kernel op {name!r}; valid ops: {sorted(KERNEL_OPS)}")
    return KERNEL_OPS[name]


def resolve_impl(name: str, impl: str, tensor) -> str:
    """-> "cuda" | "torch" for a call whose first tensor is `tensor`."""
    get_kernel(name)
    if impl not in KERNEL_IMPLS:
        raise ValueError(
            f"kernels.{name}: impl must be one of {KERNEL_IMPLS}, got "
            f"{impl!r}")
    if impl == "torch":
        return "torch"
    if impl == "cuda":
        if not tensor.is_cuda:
            raise RuntimeError(
                f"kernels.{name}: impl='cuda' forced on a tensor on "
                f"{tensor.device}; the kernel runs only on a CUDA device "
                f"(impl='auto' picks the plain version for CPU tensors)")
        return "cuda"
    return "cuda" if tensor.is_cuda else "torch"


def dispatch(name: str, *args, impl: str = "auto", **kwargs):
    """Run op `name` on `args` through the selection contract."""
    op = get_kernel(name)
    chosen = resolve_impl(name, impl, args[0])
    COUNTERS.add("kernel.dispatches" if chosen == "cuda"
                 else "kernel.fallbacks")
    if chosen == "cuda":
        return op.kernel(*args, **kwargs)
    return op.plain(*args, **kwargs)

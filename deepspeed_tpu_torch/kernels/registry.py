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

Products under a flop count (profiling/flops_profiler): a kernel launched
through ctypes is invisible to `torch.utils.flop_counter.FlopCounterMode`,
and a plain version's blocked loops are not the products of the dense
path.  So while a `product_count` is open, an op with a `products`
formula (flash attention #1-#3, the fused CE #4-#6; the formulas live
beside their wrappers, kernels/flash.py and kernels/fused_xent.py) is
credited the products of the dense path it replaces, and whatever the
flop counter saw inside the call is excluded: the count of a step is the
same with the kernels, their plain versions or the dense path.

`kernel_config(ops={...})` is the scoped per-op override of the JAX
package's `kernel_config` (registry.py:411) for the module-level
selections that read it (`SparseSelfAttention(impl="auto")`): within the
block, `op_impl(name)` returns the forced "auto" | "pallas" | "xla"
(alias "jnp") instead of "auto".
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Mapping

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


    def products(self, *args, **kwargs):
        from . import flash
        return flash.products("flash_attention_fwd", *args)

class FlashAttentionDqOp(KernelOp):
    """Flash attention dQ (kernels/flash.py)."""

    NAME = "flash_attention_dq"

    def kernel(self, *args, **kwargs):
        from . import flash
        return flash.flash_dq_cuda(*args, **kwargs)

    def plain(self, *args, **kwargs):
        from ..ops.transformer.flash_attention import _dq_plain
        return _dq_plain(*args, **kwargs)


    def products(self, *args, **kwargs):
        from . import flash
        return flash.products("flash_attention_dq", *args)

class FlashAttentionDkvOp(KernelOp):
    """Flash attention dK, dV (kernels/flash.py)."""

    NAME = "flash_attention_dkv"

    def kernel(self, *args, **kwargs):
        from . import flash
        return flash.flash_dkv_cuda(*args, **kwargs)

    def plain(self, *args, **kwargs):
        from ..ops.transformer.flash_attention import _dkv_plain
        return _dkv_plain(*args, **kwargs)


    def products(self, *args, **kwargs):
        from . import flash
        return flash.products("flash_attention_dkv", *args)

class FusedXentFwdOp(KernelOp):
    """Fused LM-head CE forward -> (lse, label logit) (kernels/fused_xent.py)."""

    NAME = "fused_xent_fwd"

    def kernel(self, *args, **kwargs):
        from . import fused_xent
        return fused_xent.fused_xent_fwd_cuda(*args, **kwargs)

    def plain(self, *args, **kwargs):
        from ..ops.transformer.fused_xent import _fwd_plain
        return _fwd_plain(*args, **kwargs)


    def products(self, *args, **kwargs):
        from . import fused_xent
        return fused_xent.products("fused_xent_fwd", *args)

class FusedXentDxOp(KernelOp):
    """Fused LM-head CE dx (kernels/fused_xent.py)."""

    NAME = "fused_xent_dx"

    def kernel(self, *args, **kwargs):
        from . import fused_xent
        return fused_xent.fused_xent_dx_cuda(*args, **kwargs)

    def plain(self, *args, **kwargs):
        from ..ops.transformer.fused_xent import _dx_plain
        return _dx_plain(*args, **kwargs)


    def products(self, *args, **kwargs):
        from . import fused_xent
        return fused_xent.products("fused_xent_dx", *args)

class FusedXentDwOp(KernelOp):
    """Fused LM-head CE dW (kernels/fused_xent.py)."""

    NAME = "fused_xent_dw"

    def kernel(self, *args, **kwargs):
        from . import fused_xent
        return fused_xent.fused_xent_dw_cuda(*args, **kwargs)

    def plain(self, *args, **kwargs):
        from ..ops.transformer.fused_xent import _dw_plain
        return _dw_plain(*args, **kwargs)


    def products(self, *args, **kwargs):
        from . import fused_xent
        return fused_xent.products("fused_xent_dw", *args)

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


class FlashSparseFwdOp(KernelOp):
    """Block-sparse flash forward -> (out, lse) (kernels/flash_sparse.py)."""

    NAME = "flash_sparse_fwd"

    def kernel(self, *args, **kwargs):
        from . import flash_sparse
        return flash_sparse.flash_sparse_fwd_cuda(*args, **kwargs)

    def plain(self, *args, **kwargs):
        from ..ops.sparse_attention.flash_sparse import _fwd_plain
        return _fwd_plain(*args, **kwargs)


class FlashSparseDqOp(KernelOp):
    """Block-sparse flash dQ over the forward table (kernels/flash_sparse.py)."""

    NAME = "flash_sparse_dq"

    def kernel(self, *args, **kwargs):
        from . import flash_sparse
        return flash_sparse.flash_sparse_dq_cuda(*args, **kwargs)

    def plain(self, *args, **kwargs):
        from ..ops.sparse_attention.flash_sparse import _dq_plain
        return _dq_plain(*args, **kwargs)


class FlashSparseDkvOp(KernelOp):
    """Block-sparse flash dK, dV over the reverse table
    (kernels/flash_sparse.py)."""

    NAME = "flash_sparse_dkv"

    def kernel(self, *args, **kwargs):
        from . import flash_sparse
        return flash_sparse.flash_sparse_dkv_cuda(*args, **kwargs)

    def plain(self, *args, **kwargs):
        from ..ops.sparse_attention.flash_sparse import _dkv_plain
        return _dkv_plain(*args, **kwargs)


KERNEL_OPS: Dict[str, KernelOp] = {
    op.NAME: op for op in (PagedAttentionOp(), FlashAttentionFwdOp(),
                           FlashAttentionDqOp(), FlashAttentionDkvOp(),
                           FusedXentFwdOp(), FusedXentDxOp(),
                           FusedXentDwOp(), QuantCodecQuantizeOp(),
                           QuantCodecDequantizeOp(), MoEDispatchOp(),
                           MoECombineOp(), FlashSparseFwdOp(),
                           FlashSparseDqOp(), FlashSparseDkvOp())}

# module-level selections that honour the scoped override, and the values
# it takes (the JAX package's op names and impls)
OVERRIDABLE_OPS = ("sparse_attention",)
OP_IMPLS = ("auto", "pallas", "xla")
_IMPL_ALIASES = {"jnp": "xla"}
_OP_OVERRIDES: Dict[str, str] = {}


@contextlib.contextmanager
def kernel_config(ops: Mapping[str, str]):
    """Scoped per-op selection: `with kernel_config(ops={"sparse_attention":
    "pallas"}): ...` makes `SparseSelfAttention(impl="auto")` take the
    kernel walk for its bias-free calls, as the JAX package's
    `kernel_config(ops=..., interpret=True)` does (on a CPU tensor the
    walk runs the kernels' plain versions)."""
    new = {}
    for name, impl in dict(ops).items():
        if name not in OVERRIDABLE_OPS:
            raise ValueError(f"kernels.{name}: no module-level selection to "
                             f"override; valid ops: {OVERRIDABLE_OPS}")
        impl = _IMPL_ALIASES.get(str(impl).lower(), str(impl).lower())
        if impl not in OP_IMPLS:
            raise ValueError(f"kernels.{name}: impl must be one of "
                             f"{OP_IMPLS} (or 'jnp'), got {impl!r}")
        new[name] = impl
    prev = dict(_OP_OVERRIDES)
    _OP_OVERRIDES.update(new)
    try:
        yield dict(_OP_OVERRIDES)
    finally:
        _OP_OVERRIDES.clear()
        _OP_OVERRIDES.update(prev)


def op_overrides() -> Dict[str, str]:
    """The overrides in force, to replay with `kernel_config(ops=...)`
    where a computation runs again later (a recomputation under
    torch.utils.checkpoint runs in the backward, outside the caller's
    scope, and must take the path the forward took)."""
    return dict(_OP_OVERRIDES)


def op_impl(name: str) -> str:
    """The selection in force for module-level op `name`: the innermost
    `kernel_config` override, else "auto"."""
    return _OP_OVERRIDES.get(name, "auto")


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


class ProductCount:
    """The products credited to the kernel ops while a count is open.
    `native` reads the flop counter's running per-op totals ({op: flops});
    `credited` is {kernel op: products of the dense path}, `excluded`
    {counter op: flops the counter saw inside those calls}."""

    def __init__(self, native: Callable[[], Dict[str, int]]):
        self.native = native
        self.credited: Dict[str, int] = {}
        self.excluded: Dict[str, int] = {}


# process-global, not per thread: on the card autograd runs a backward's
# kernels on its device threads, and their products count too
_PRODUCT_COUNTS: List[ProductCount] = []


@contextlib.contextmanager
def product_count(native: Callable[[], Dict[str, int]]):
    """Credit the kernel ops' products while the block runs; yields the
    `ProductCount`."""
    pc = ProductCount(native)
    _PRODUCT_COUNTS.append(pc)
    try:
        yield pc
    finally:
        _PRODUCT_COUNTS.remove(pc)


def _counted(name, op, run, args, kwargs):
    """`run(*args, **kwargs)` with its products credited to every open
    count and the flop counter's own reading of the call excluded."""
    before = [pc.native() for pc in _PRODUCT_COUNTS]
    out = run(*args, **kwargs)
    n = int(op.products(*args, **kwargs))
    for pc, b in zip(_PRODUCT_COUNTS, before):
        for k, v in pc.native().items():
            if v != b.get(k, 0):
                pc.excluded[k] = pc.excluded.get(k, 0) + v - b.get(k, 0)
        pc.credited[name] = pc.credited.get(name, 0) + n
    return out


def dispatch(name: str, *args, impl: str = "auto", **kwargs):
    """Run op `name` on `args` through the selection contract."""
    op = get_kernel(name)
    chosen = resolve_impl(name, impl, args[0])
    COUNTERS.add("kernel.dispatches" if chosen == "cuda"
                 else "kernel.fallbacks")
    run = op.kernel if chosen == "cuda" else op.plain
    if _PRODUCT_COUNTS and hasattr(op, "products"):
        return _counted(name, op, run, args, kwargs)
    return run(*args, **kwargs)

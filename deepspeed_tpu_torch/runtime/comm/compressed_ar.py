"""The 24-bit frexp all-reduce — the port of
deepspeed_tpu/runtime/comm/compressed_ar.py (:25-101), bit for bit.

Reference: deepspeed/runtime/comm/compressed_ar.py:22-48 — NCCL of that
era could not sum bf16 reliably, so the tensor goes as an fp16 mantissa
and an int8 exponent, each all-reduced, then ldexp-recombined.  The
bucketed gradient wire's `split` mode (runtime/comm/bucketing.py) rides
`decompose_int8_safe` with gather semantics.

`frexp` and `ldexp` follow jax.numpy's definitions as XLA computes them
(frexp of 0, inf and nan gives exponent 0 and the value itself as the
mantissa, XLA's arithmetic flushes subnormals; ldexp splits the exponent
so that a finite result never overflows on the way), so every function
here gives JAX's bits.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...comm import dist


_TINY = 2.0 ** -126   # the smallest normal fp32


def _frexp(x):
    """jnp.frexp of an fp32 tensor as XLA computes it on the CPU ->
    (fp32 mantissa in ±[0.5, 1), int32 exponent): 0, ±inf and nan pass
    through with exponent 0, and a subnormal, which XLA's arithmetic
    flushes to zero while normalizing it, comes out as (±0.5, -149)."""
    m, e = torch.frexp(x)
    special = ~torch.isfinite(x) | (x == 0)
    sub = ~special & (x.abs() < _TINY)
    m = torch.where(sub, torch.copysign(torch.full_like(x, 0.5), x), m)
    e = torch.where(sub, torch.full_like(e, -149), e)
    return (torch.where(special, x, m),
            torch.where(special, torch.zeros_like(e), e).to(torch.int32))


def _ldexp(x, n):
    """jnp.ldexp (x fp32, n int): the exponent split off x first, the
    product taken as m · 2**e with e one lower where positive, so a
    result one binade under the overflow stays finite; a subnormal
    result flushes to a signed zero, as XLA's arithmetic gives it."""
    m, e = _frexp(x)
    e = (e + n.to(torch.int32)).to(torch.float32)
    m = torch.where(e > 0, m * 2, m)
    e = torch.where(e > 0, e - 1, e)
    out = m * torch.pow(2.0, e)
    out = torch.where(out.abs() < _TINY, torch.copysign(
        torch.zeros_like(out), out), out)
    return torch.where(torch.isinf(x) | (x == 0), x, out)


def decompose(t):
    """float -> (fp16 mantissa in [0.5, 1), int8 exponent).  Reference-
    exact: the int8 cast WRAPS for fp32 frexp exponents outside
    [-128, 127] (subnormals reach -148, values >= 2^127 carry 128)."""
    mantissa, exponent = _frexp(t.to(torch.float32))
    return mantissa.to(torch.float16), exponent.to(torch.int8)


def decompose_int8_safe(t):
    """`decompose` made safe for reconstruction from the int8 exponent
    (the bucketed split wire): fp32 subnormals flush to zero, the
    >= 2^127 tail pushes the mantissa to ±inf so overflow checks fire.
    Returns (fp16 mantissa, int8-range int32 exponent)."""
    f32 = t.to(torch.float32)
    f32 = torch.where(f32.abs() < 2.0 ** -126, torch.zeros_like(f32), f32)
    mantissa, exponent = _frexp(f32)
    mantissa = torch.where(exponent > 127,
                           torch.sign(mantissa) * float("inf"), mantissa)
    return mantissa.to(torch.float16), exponent.clamp(-127, 127)


def reconstruct(mantissa, exponent, original_dtype=torch.bfloat16):
    return _ldexp(mantissa.to(torch.float32),
                  exponent.to(torch.int32)).to(original_dtype)


def compressed_all_reduce(tensor, group: Optional[object] = "data",
                          wire_parity: bool = False):
    """Sum `tensor` over the ranks of `group` (compressed_ar.py:62).

    Default: an fp32 sum, what the reference's split buys (bf16-safe
    summation).  `wire_parity=True`: the reference's exact wire — the
    fp16 mantissas and int8 exponents summed SEPARATELY, then
    ldexp-recombined (a lossy approximation kept for parity).  A group
    of one rank is the identity."""
    if group is None or dist.get_world_size(group) == 1:
        return tensor
    dtype = tensor.dtype
    if wire_parity:
        m, e = decompose(tensor)
        m_sum = dist.all_reduce(m.to(torch.float32), group)
        e_sum = dist.all_reduce(e.to(torch.int32), group)
        return reconstruct(m_sum.to(torch.float16), e_sum, dtype)
    return dist.all_reduce(tensor.to(torch.float32).clone(),
                           group).to(dtype)

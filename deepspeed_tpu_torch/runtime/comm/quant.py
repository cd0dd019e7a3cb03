"""Row-wise symmetric int8/int4 quantization — the port's copy of the
row codec of deepspeed_tpu/runtime/comm/quant.py (`qmax` :80,
`_flush_subnormals` :114, `quantize_rows` :207, `dequantize_rows` :243),
bit for bit: the same codes, scales and dequantized values for the same
input.

The paged KV cache stores its quantized blocks through these: one fp16
scale per trailing-axis row, so a scatter of N rows into the pool touches
exactly those rows' payload and scales.  Range semantics:

* fp32 subnormals flush to zero before the amax;
* the fp16-rounded scale amax / qmax is also the quantization scale, so
  encode and decode agree bit for bit (an fp16 overflow gives an inf scale
  and a row that dequantizes non-finite, an underflow a row of zeros);
* codes are round-half-to-even (`torch.round`, as `jnp.round`), clipped to
  [-qmax, qmax];
* non-finite elements carry the marker code -qmax-1, which no finite value
  produces, and dequantize as NaN;
* int4 packs two codes per byte, low nibble first (two's complement), and
  needs an even trailing axis.

The blockwise codecs of the same module (kernels #11/#12) come with the
qwZ slice.
"""

from __future__ import annotations

import numpy as np
import torch

# wire name -> integer levels per side (qmax)
QUANT_WIRES = ("int8", "int4")
_QMAX = {"int8": 127, "int4": 7}

_F32_MIN_NORMAL = float(np.float32(2.0 ** -126))


def qmax(wire: str) -> int:
    if wire not in _QMAX:
        raise ValueError(
            f"unknown quantized wire {wire!r}; choose from {QUANT_WIRES}")
    return _QMAX[wire]


def _flush_subnormals(f32):
    return torch.where(f32.abs() < _F32_MIN_NORMAL,
                       torch.zeros((), dtype=torch.float32,
                                   device=f32.device), f32)


def quantize_rows(x, wire: str = "int8"):
    """Quantize the trailing axis of `x` [..., D] with one fp16 scale per
    leading-index row -> (codes int8 [..., D] | packed uint8 [..., D // 2],
    scales fp16 [...])."""
    q = qmax(wire)
    marker = -q - 1
    d = x.shape[-1]
    if q != 127 and d % 2:
        raise ValueError(
            f"int4 row quantization needs an even trailing axis "
            f"(two codes per byte), got {d}")
    f32 = _flush_subnormals(x.to(torch.float32))
    finite = torch.isfinite(f32)
    amax = torch.where(finite, f32.abs(), 0.0).amax(dim=-1)
    scales = (amax / q).to(torch.float16)
    eff = scales.to(torch.float32)[..., None]
    inv = torch.where((eff > 0) & torch.isfinite(eff), 1.0 / eff, 0.0)
    # non-finite entries take the marker below; zero them first so no NaN
    # or inf reaches the integer conversion
    scaled = torch.where(finite, f32 * inv, 0.0)
    codes = torch.clamp(torch.round(scaled), -q, q).to(torch.int8)
    codes = torch.where(finite, codes,
                        torch.full((), marker, dtype=torch.int8,
                                   device=x.device))
    if q == 127:
        return codes, scales
    u = codes.to(torch.uint8) & 0x0F                  # two's-complement nibble
    packed = u[..., 0::2] | (u[..., 1::2] << 4)
    return packed, scales


def dequantize_rows(payload, scales, wire: str):
    """Inverse of `quantize_rows`: (payload [..., D | D // 2], scales
    [...]) -> fp32 [..., D].  Marker codes come back as NaN; an all-zero
    row round-trips exactly (scale 0, codes 0)."""
    q = qmax(wire)
    marker = -q - 1
    if q == 127:
        codes = payload.to(torch.int8)
    else:
        lo = (payload & 0x0F).to(torch.int8)
        hi = ((payload >> 4) & 0x0F).to(torch.int8)
        lo = torch.where(lo > 7, lo - 16, lo)
        hi = torch.where(hi > 7, hi - 16, hi)
        codes = torch.stack([lo, hi], dim=-1).reshape(
            payload.shape[:-1] + (payload.shape[-1] * 2,))
    vals = codes.to(torch.float32) * scales.to(torch.float32)[..., None]
    return torch.where(codes == marker, float("nan"), vals)

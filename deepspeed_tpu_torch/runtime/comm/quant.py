"""Symmetric int8/int4 quantization — the port's copy of the codecs of
deepspeed_tpu/runtime/comm/quant.py, bit for bit: the same codes, scales
and dequantized values for the same input.

* the blockwise codec (`validate_block_size` :66, `padded_elems` :87,
  `payload_bytes` :93, `quantize_blockwise` / `dequantize_blockwise`
  :119-138 through the kernel registry, their plain versions
  `quantize_blockwise_ref` / `dequantize_blockwise_ref` :141-201): one
  fp16 scale per `block` elements of the flattened tensor, zero-padded
  to a whole number of blocks.  The serving engine stores its weights
  through it (`ServeConfig(quantized_weights=...)`); on the card the
  registry runs kernels #11 and #12 (`kernels/quant_codec.py`).
* the row codec (`qmax` :80, `_flush_subnormals` :114, `quantize_rows`
  :207, `dequantize_rows` :243): one fp16 scale per trailing-axis row.
  The paged KV cache stores its quantized blocks through these, so a
  scatter of N rows into the pool touches exactly those rows' payload
  and scales.

Range semantics, shared by both:

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

`pack_wire` / `unpack_wire` (the fused wire buffer of the qwZ gather) are
not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

# wire name -> integer levels per side (qmax)
QUANT_WIRES = ("int8", "int4")
_QMAX = {"int8": 127, "int4": 7}

DEFAULT_BLOCK_SIZE = 256

_F32_MIN_NORMAL = float(np.float32(2.0 ** -126))


def validate_block_size(block) -> int:
    """Block sizes must be positive even ints: int4 packs two elements
    per byte, so an odd block would split a byte across blocks."""
    if isinstance(block, bool) or not isinstance(block, (int, np.integer)):
        raise ValueError(
            f"quant_block_size must be a positive even int, got {block!r}")
    block = int(block)
    if block <= 0 or block % 2:
        raise ValueError(
            f"quant_block_size must be a positive even int, got {block}")
    return block


def qmax(wire: str) -> int:
    if wire not in _QMAX:
        raise ValueError(
            f"unknown quantized wire {wire!r}; choose from {QUANT_WIRES}")
    return _QMAX[wire]


def padded_elems(n_elems: int, block: int) -> int:
    """Elements after zero-padding to a whole number of blocks."""
    block = validate_block_size(block)
    return n_elems + (-n_elems % block)


def payload_bytes(n_elems: int, wire: str, block: int, *,
                  padded: bool = True) -> int:
    """Exact bytes of a quantized tensor of `n_elems` elements: payload
    plus one fp16 scale per block.  padded=False prices the logical
    payload (no zero padding)."""
    q = qmax(wire)
    if padded:
        n = padded_elems(n_elems, block)
        n_blocks = n // block
    else:
        n = n_elems
        n_blocks = -(-n_elems // block) if n_elems else 0
    data = n if q == 127 else -(-n // 2)  # int4: two elements per byte
    return data + n_blocks * 2


def _flush_subnormals(f32):
    return torch.where(f32.abs() < _F32_MIN_NORMAL,
                       torch.zeros((), dtype=torch.float32,
                                   device=f32.device), f32)


def quantize_rows(x, wire: str = "int8"):
    """Quantize the trailing axis of `x` [..., D] with one fp16 scale per
    leading-index row -> (codes int8 [..., D] | packed uint8 [..., D // 2],
    scales fp16 [...])."""
    q = qmax(wire)
    d = x.shape[-1]
    if q != 127 and d % 2:
        raise ValueError(
            f"int4 row quantization needs an even trailing axis "
            f"(two codes per byte), got {d}")
    codes, scales = _encode_blocks(x.to(torch.float32), q)
    return (codes if q == 127 else _pack_int4(codes)), scales


def dequantize_rows(payload, scales, wire: str):
    """Inverse of `quantize_rows`: (payload [..., D | D // 2], scales
    [...]) -> fp32 [..., D].  Marker codes come back as NaN; an all-zero
    row round-trips exactly (scale 0, codes 0)."""
    q = qmax(wire)
    codes = payload.to(torch.int8) if q == 127 else _unpack_int4(payload)
    vals = codes.to(torch.float32) * scales.to(torch.float32)[..., None]
    return torch.where(codes == -q - 1, float("nan"), vals)


# -- blockwise codec ----------------------------------------------------------


def quantize_blockwise(x, block: int, wire: str = "int8"):
    """Flat (or any-shape) tensor -> (payload, fp16 scales) through the
    kernel registry: kernel #11 for a CUDA tensor, `quantize_blockwise_ref`
    for a CPU one, the same bits either way."""
    from ...kernels import registry

    return registry.dispatch("quant_codec_quantize", x, block, wire)


def dequantize_blockwise(payload, scales, wire: str, n_elems: int,
                         out_dtype=torch.float32):
    """The registry-dispatching inverse (kernel #12 on the card); see
    `dequantize_blockwise_ref`.  `out_dtype` rounds the fp32 values once
    to the leaf's dtype (the JAX program's `.astype(dtype)` after the
    dequantize)."""
    from ...kernels import registry

    return registry.dispatch("quant_codec_dequantize", payload, scales, wire,
                             n_elems, out_dtype=out_dtype)


def _encode_blocks(blocks, q):
    """fp32 [nb, block] -> (int8 codes, fp16 scales): the encode chain of
    quant.py:163-177 — flush, finite amax, fp16 scale reused as the
    quantization scale, inv 0 for a zero or non-finite scale, round half
    to even, clip, then the marker for non-finite input."""
    blocks = _flush_subnormals(blocks)
    finite = torch.isfinite(blocks)
    amax = torch.where(finite, blocks.abs(), 0.0).amax(dim=-1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its rounded reciprocal, which is not amax / q
    scales = (amax / torch.full((), float(q), device=amax.device)).to(
        torch.float16)
    eff = scales.to(torch.float32)[..., None]
    inv = torch.where((eff > 0) & torch.isfinite(eff), 1.0 / eff, 0.0)
    # non-finite entries take the marker below; zero them first so no NaN
    # or inf reaches the integer conversion
    scaled = torch.where(finite, blocks * inv, 0.0)
    codes = torch.clamp(torch.round(scaled), -q, q).to(torch.int8)
    codes = torch.where(finite, codes,
                        torch.full((), -q - 1, dtype=torch.int8,
                                   device=blocks.device))
    return codes, scales


def _pack_int4(codes):
    u = codes.to(torch.uint8) & 0x0F                  # two's-complement nibble
    return u[..., 0::2] | (u[..., 1::2] << 4)


def _unpack_int4(payload):
    lo = (payload & 0x0F).to(torch.int8)
    hi = ((payload >> 4) & 0x0F).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(
        payload.shape[:-1] + (payload.shape[-1] * 2,))


def quantize_blockwise_ref(x, block: int, wire: str = "int8"):
    """Flat (or any-shape) tensor -> (payload, fp16 scales [n_blocks]).

    payload: int8 [n_blocks, block] for "int8", uint8 [n_blocks,
    block // 2] packed low nibble first for "int4".  The input is
    flattened and zero-padded to a whole number of blocks;
    `dequantize_blockwise(..., n_elems=x.numel())` restores its length."""
    q = qmax(wire)
    block = validate_block_size(block)
    f32 = x.reshape(-1).to(torch.float32)
    pad = -f32.shape[0] % block
    if pad:
        f32 = torch.cat([f32, f32.new_zeros(pad)])
    codes, scales = _encode_blocks(f32.reshape(-1, block), q)
    return (codes if q == 127 else _pack_int4(codes)), scales


def dequantize_blockwise_ref(payload, scales, wire: str, n_elems: int,
                             out_dtype=torch.float32):
    """(payload [..., n_blocks, w], scales [..., n_blocks]) -> [...,
    n_elems] in `out_dtype` (fp32 by default: the JAX function's result;
    another dtype is that result rounded once).  Leading batch dims are
    kept; marker codes come back as NaN."""
    q = qmax(wire)
    codes = payload.to(torch.int8) if q == 127 else _unpack_int4(payload)
    vals = codes.to(torch.float32) * scales.to(torch.float32)[..., None]
    vals = torch.where(codes == -q - 1, float("nan"), vals)
    flat = vals.reshape(vals.shape[:-2] + (-1,))
    return flat[..., :n_elems].to(out_dtype)

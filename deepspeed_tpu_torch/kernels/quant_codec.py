"""Wrappers of the blockwise int8/int4 codec Hopper kernels
(`csrc/quant_codec.cu`), which replace the TPU kernels `_quant_kernel`
and `_dequant_kernel` of deepspeed_tpu/kernels/quant_codec.py (:64,
:128).

Each takes the arguments of its plain PyTorch version
(`runtime/comm/quant.py` `quantize_blockwise_ref`,
`dequantize_blockwise_ref`) and returns the same tensors, bit for bit
(NaN compared by position).  The JAX wrapper pads the block rows to a
tile of 8 and broadcasts each scale over 128 lanes; that is the TPU's
layout, and nothing of it is carried over: the kernels read the flat
tensor and write the (payload, scales) pair at their final shapes.  A
wrapper checks device, dtype and contiguity, launches its kernel on
PyTorch's current stream, raises on a launch error and counts the launch
in `LAUNCHES`; it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..runtime.comm.quant import qmax, validate_block_size

# kernel launches since the last reset, per kernel (the main path's proof
# of use)
LAUNCHES: Dict[str, int] = {"quant_codec_quantize": 0,
                            "quant_codec_dequantize": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PAYLOAD_DTYPES = {"int8": torch.int8, "int4": torch.uint8}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    # x, n, block, q, payload, scales, dtype, stream
    "quant_codec_quantize": [_P, _L, _I, _I, _P, _P, _I, _P],
    # payload, scales, block, q, nb, n, rows, out, vec, dtype, stream
    "quant_codec_dequantize": [_P, _P, _I, _I, _L, _L, _I, _P, _I, _I, _P]}


def _lib():
    from . import build

    lib = build.load("quant_codec.cu")
    if lib.quant_codec_quantize.argtypes is None:
        # without argtypes ctypes passes every int as a 32-bit C int and
        # cuts the pointers
        for name, types in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = types
            fn.restype = ctypes.c_int
        lib.quant_codec_error_string.argtypes = [ctypes.c_int]
        lib.quant_codec_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name, *args):
    lib = _lib()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: cudaError {err} "
            f"({lib.quant_codec_error_string(err).decode()})")
    LAUNCHES[name] += 1


def _check(cond, msg):
    if not cond:
        raise ValueError(f"quant codec kernel: {msg()}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def quantize_blockwise_cuda(x, block: int, wire: str = "int8"):
    """-> (payload int8 [nb, block] | uint8 [nb, block // 2], fp16 [nb])."""
    q = qmax(wire)
    block = validate_block_size(block)
    _check(x.is_cuda, lambda: f"x is on {x.device}, not a CUDA device")
    _check(x.dtype in _DTYPE_CODES,
           lambda: f"x dtype {x.dtype}; want one of "
           f"{sorted(map(str, _DTYPE_CODES))}")
    _check(x.is_contiguous(), lambda: "x must be contiguous")
    n = x.numel()
    _check(n > 0, lambda: "x is empty")
    nb = -(-n // block)
    payload = torch.empty((nb, block if q == 127 else block // 2),
                          dtype=_PAYLOAD_DTYPES[wire], device=x.device)
    scales = torch.empty((nb,), dtype=torch.float16, device=x.device)
    _launch("quant_codec_quantize", x.data_ptr(), n, block, q,
            payload.data_ptr(), scales.data_ptr(), _DTYPE_CODES[x.dtype],
            _stream(x))
    return payload, scales


def dequantize_blockwise_cuda(payload, scales, wire: str, n_elems: int,
                              out_dtype=torch.float32):
    """(payload [..., nb, w], scales [..., nb]) -> [..., n_elems] in
    `out_dtype` (fp32, bf16 or fp16)."""
    q = qmax(wire)
    for name, t in (("payload", payload), ("scales", scales)):
        _check(t.is_cuda, lambda: f"{name} is on {t.device}, not a CUDA "
               f"device")
        _check(t.is_contiguous(), lambda: f"{name} must be contiguous")
    _check(payload.dtype == _PAYLOAD_DTYPES[wire] and
           scales.dtype == torch.float16,
           lambda: f"payload/scales dtypes {payload.dtype}/{scales.dtype}; "
           f"want {_PAYLOAD_DTYPES[wire]}/float16 for {wire}")
    _check(out_dtype in _DTYPE_CODES,
           lambda: f"out_dtype {out_dtype}; want one of "
           f"{sorted(map(str, _DTYPE_CODES))}")
    _check(payload.dim() >= 2 and scales.shape == payload.shape[:-1],
           lambda: f"payload {tuple(payload.shape)} and scales "
           f"{tuple(scales.shape)} do not pair")
    lead = tuple(payload.shape[:-2])
    nb = payload.shape[-2]
    block = payload.shape[-1] * (1 if q == 127 else 2)
    n = int(n_elems)
    _check(0 < n <= nb * block,
           lambda: f"n_elems {n} outside (0, {nb * block}]")
    rows = 1
    for s in lead:
        rows *= int(s)
    out = torch.empty(lead + (n,), dtype=out_dtype, device=payload.device)
    vec = (block % 8 == 0 and n % 8 == 0 and payload.data_ptr() % 16 == 0
           and out.data_ptr() % 16 == 0)
    _launch("quant_codec_dequantize", payload.data_ptr(), scales.data_ptr(),
            block, q, nb, n, rows, out.data_ptr(), int(vec),
            _DTYPE_CODES[out_dtype], _stream(payload))
    return out

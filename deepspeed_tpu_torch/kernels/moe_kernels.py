"""Wrappers of the sort-based MoE dispatch and combine Hopper kernels
(`csrc/moe_dispatch.cu`), which replace the TPU kernels
`_dispatch_kernel` and `_combine_kernel` of
deepspeed_tpu/kernels/moe_kernels.py (:52, :100).

Each takes the arguments of its plain PyTorch version
(`moe/dispatch.py` `sorted_dispatch_ref`, `sorted_combine_ref`) for B
token groups at once — routing tensors [B, k, N], tokens [B, N, D],
expert buckets [B, E, C, D] — and returns the same tensor: the dispatch
bit for bit, the combine within `moe/dispatch.py` `combine_tolerance`.
Each call is one kernel launch and no other device operation: the
dispatch builds the inverse permutation slot -> assignment of
moe_kernels.py:67-74 inside the kernel, in shared memory.  A wrapper
checks device, dtype, shape
and contiguity, launches on PyTorch's current stream, raises on a launch
error and counts the launch in `LAUNCHES`; it never falls back to the
plain version.  A kept assignment whose expert or position lies outside
the [E, C] buckets (routing made for another capacity) stops the kernel,
as an out-of-range index stops PyTorch's own scatter on the card: the
next synchronisation raises, and the CUDA context is lost.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

# kernel launches since the last reset, per kernel (the main path's proof
# of use), and among them the calls over one expert's bucket — the
# dropless overflow pass (moe/dispatch.py `overflow_dispatch`)
LAUNCHES: Dict[str, int] = {"moe_dispatch": 0, "moe_combine": 0}
LAUNCHES_ONE_EXPERT: Dict[str, int] = {"moe_dispatch": 0, "moe_combine": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_ONE_EXPERT):
        for k in counts:
            counts[k] = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # x, eidx, pos, keep, gate, B, N, k, E, C, D, vec_bytes, out, dtype,
    # stream
    "moe_dispatch": [_P] * 5 + [_I] * 7 + [_P, _I, _P],
    # eo, eidx, gate, pos, keep, B, N, k, E, C, D, vec_bytes, y, dtype, stream
    "moe_combine": [_P] * 5 + [_I] * 7 + [_P, _I, _P]}


def _lib():
    from . import build

    lib = build.load("moe_dispatch.cu")
    if lib.moe_dispatch.argtypes is None:
        # without argtypes ctypes passes every int as a 32-bit C int and
        # cuts the pointers
        for name, types in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = types
            fn.restype = ctypes.c_int
        lib.moe_error_string.argtypes = [ctypes.c_int]
        lib.moe_error_string.restype = ctypes.c_char_p
    return lib


def _call(name, *args):
    lib = _lib()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: cudaError {err} "
            f"({lib.moe_error_string(err).decode()})")


def _check(cond, msg):
    if not cond:
        raise ValueError(f"MoE kernel: {msg()}")


def _vec_bytes(D, t, *others):
    """The widest vector (16, 8, 4 or 2 bytes) dividing a row's bytes and
    every tensor's base address."""
    row = D * t.element_size()
    for vb in (16, 8, 4, 2):
        if row % vb == 0 and all(a.data_ptr() % vb == 0 for a in
                                 (t, *others)) and vb >= t.element_size():
            return vb
    raise ValueError(f"MoE kernel: rows of {row} bytes take no vector")


def _routing(x, eidx, pos, keep, gate):
    """Validate the routing tensors against x [B, *, D]; -> (B, k, N)."""
    B = x.shape[0]
    _check(eidx.dim() == 3 and eidx.shape[0] == B,
           lambda: f"routing {tuple(eidx.shape)}, want [B={B}, k, N]")
    k, N = eidx.shape[1:]
    for name, t, dt in (("eidx", eidx, torch.int32), ("pos", pos, torch.int32),
                        ("keep", keep, torch.bool),
                        ("gate", gate, torch.float32)):
        if t is None:
            continue
        _check(t.is_cuda and t.device == x.device,
               lambda: f"{name} is on {t.device}, x on {x.device}")
        _check(t.dtype == dt and tuple(t.shape) == (B, k, N) and
               t.is_contiguous(),
               lambda: f"{name} {t.dtype} {tuple(t.shape)}, want contiguous "
               f"{dt} [{B}, {k}, {N}]")
    return B, k, N


def _tensor(x, name):
    _check(x.is_cuda, lambda: f"{name} is on {x.device}, not a CUDA device")
    _check(x.dtype in _DTYPE_CODES,
           lambda: f"{name} dtype {x.dtype}; want one of "
           f"{sorted(map(str, _DTYPE_CODES))}")
    _check(x.is_contiguous(), lambda: f"{name} must be contiguous")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def sorted_dispatch_cuda(x, eidx, pos, keep, num_experts: int,
                         capacity: int, gate=None):
    """x [B, N, D] -> expert inputs [B, E, C, D]; with `gate` each row is
    scaled by its assignment's weight (the combine's gradient)."""
    _tensor(x, "x")
    _check(x.dim() == 3, lambda: f"x {tuple(x.shape)}, want [B, N, D]")
    B, k, N = _routing(x, eidx, pos, keep, gate)
    _check(x.shape[1] == N, lambda: f"x has {x.shape[1]} tokens, routing {N}")
    D = x.shape[2]
    E, C = int(num_experts), int(capacity)
    out = torch.empty((B, E, C, D), dtype=x.dtype, device=x.device)
    _call("moe_dispatch", x.data_ptr(), eidx.data_ptr(), pos.data_ptr(),
          keep.data_ptr(), _ptr(gate), B, N, k, E, C, D,
          _vec_bytes(D, x, out), out.data_ptr(), _DTYPE_CODES[x.dtype],
          _stream(x))
    LAUNCHES["moe_dispatch"] += 1
    LAUNCHES_ONE_EXPERT["moe_dispatch"] += E == 1
    return out


def sorted_combine_cuda(expert_out, eidx, gate, pos, keep):
    """expert outputs [B, E, C, D] -> y [B, N, D]; gate None = unit
    weights (the dispatch's gradient)."""
    _tensor(expert_out, "expert_out")
    _check(expert_out.dim() == 4,
           lambda: f"expert_out {tuple(expert_out.shape)}, want [B, E, C, D]")
    B, k, N = _routing(expert_out, eidx, pos, keep, gate)
    _, E, C, D = expert_out.shape
    y = torch.empty((B, N, D), dtype=expert_out.dtype,
                    device=expert_out.device)
    _call("moe_combine", expert_out.data_ptr(), eidx.data_ptr(), _ptr(gate),
          pos.data_ptr(), keep.data_ptr(), B, N, k, E, C, D,
          _vec_bytes(D, expert_out, y), y.data_ptr(),
          _DTYPE_CODES[expert_out.dtype], _stream(expert_out))
    LAUNCHES["moe_combine"] += 1
    LAUNCHES_ONE_EXPERT["moe_combine"] += E == 1
    return y

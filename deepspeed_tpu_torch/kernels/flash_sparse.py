"""Wrappers of the block-sparse flash-attention Hopper kernels
(`csrc/flash_sparse.cu`), which replace the TPU kernels `_fwd_kernel`,
`_dq_kernel` and `_dkv_kernel` of
deepspeed_tpu/ops/sparse_attention/flash_sparse.py (:73, :171, :208).

Each takes the arguments of its plain PyTorch version
(`ops/sparse_attention/flash_sparse.py` `_fwd_plain`, `_dq_plain`,
`_dkv_plain`) and returns the same tensors.  The layout reaches the card
as int32 tables on q's device (`layout_tables`): the forward table
`[H, nb, W]` for the forward and dQ, the reverse table `[H, nb, Wq]` for
dK/dV, ascending and -1 padded at the end; a kernel block walks its row
up to the first -1.  The bf16 head_dim-64 dK/dV for blocks a multiple of
64 is a persistent wgmma kernel that takes its (bh, key tile) items
heaviest reverse walk first, in the order `dkv_work_order` computes once
per layout (`ops/sparse_attention/flash_sparse.py` `device_tables`).  The
bf16 / fp16 forward and dQ at head_dim 64 or 128 for blocks a multiple of
64 are persistent, warp-specialised wgmma kernels fed by TMA (the
forward's two 64-row tiles of a block-128 row share each key tile's
load); `fwd_route` and `dq_route` say which kernel a call takes.  A
wrapper checks device, dtype, shape, contiguity and alignment, launches
its kernel on PyTorch's current stream, raises on a launch error and
counts the launch in `LAUNCHES`; it never falls back to the plain
version.

The kernels take any layout block that is a multiple of 16 and divides S
(a multiple of 64 runs as block / 64 tiles of 64 rows on one table row,
others as 16-row tiles), head_dim 64, 128 or 256, fp32, bf16 and fp16,
causal or not, and dropout; anything else raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from .flash import _DTYPE_CODES, _bwd_checks

# kernel launches since the last reset, per kernel (the main path's proof
# of use)
LAUNCHES: Dict[str, int] = {"flash_sparse_fwd": 0,
                            "flash_sparse_dq": 0,
                            "flash_sparse_dkv": 0}

HEAD_DIMS = (64, 128, 256)
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# BH, H, S, D, blk, W, scale, causal, seed, thr, inv_keep, dropout, dtype,
# stream
_TAIL = [_I] * 6 + [_F, _I, _I, _U, _F, _I, _I, _P]
_ARGTYPES = {"flash_sparse_fwd": [_P] * 6 + _TAIL,
             "flash_sparse_dq": [_P] * 8 + _TAIL,
             "flash_sparse_dkv": [_P] * 10 + _TAIL,
             "flash_sparse_fwd_route": [_I] * 3,
             "flash_sparse_dq_route": [_I] * 3}


def _lib():
    from . import build

    lib = build.load("flash_sparse.cu")
    if lib.flash_sparse_fwd.argtypes is None:
        # without argtypes ctypes passes every int as a 32-bit C int and
        # cuts the pointers
        for name, types in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = types
            fn.restype = ctypes.c_int
        lib.flash_sparse_error_string.argtypes = [ctypes.c_int]
        lib.flash_sparse_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond, msg):
    if not cond:
        raise ValueError(f"sparse flash attention kernel: {msg()}")


def _common(q, k, v, tbl, block, n_heads, extra=()):
    """Validate the launch's tensors; returns the scalar tail's shape part
    (BH, H, S, D, blk, W)."""
    BH, S, D = q.shape
    for name, t in [("q", q), ("k", k), ("v", v), ("table", tbl), *extra]:
        _check(t.is_cuda, lambda: f"{name} is on {t.device}, not a CUDA "
               f"device")
        _check(t.device == q.device,
               lambda: f"{name} is on {t.device}, q on {q.device}")
        _check(t.is_contiguous(), lambda: f"{name} must be contiguous")
        _check(t.data_ptr() % 16 == 0,
               lambda: f"{name} storage must be 16-byte aligned")
    _check(q.dtype in _DTYPE_CODES and k.dtype == q.dtype and
           v.dtype == q.dtype,
           lambda: f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}; want one of "
           f"{sorted(map(str, _DTYPE_CODES))}, equal for all three")
    _check(D in HEAD_DIMS, lambda: f"head_dim {D} not in {HEAD_DIMS}")
    _check(k.shape == q.shape and v.shape == q.shape,
           lambda: f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
           f"q {tuple(q.shape)}")
    _check(block % 16 == 0 and block > 0,
           lambda: f"layout block {block} must be a positive multiple of 16")
    _check(S % block == 0, lambda: f"S {S} not a multiple of the block "
           f"{block}")
    _check(BH % n_heads == 0 and BH <= 65535,
           lambda: f"B*H = {BH} must be a multiple of n_heads {n_heads} "
           f"and at most 65535")
    nb = S // block
    _check(tbl.dtype == torch.int32 and tbl.dim() == 3 and
           tuple(tbl.shape[:2]) == (n_heads, nb) and tbl.shape[2] >= 1,
           lambda: f"table {tbl.dtype} {tuple(tbl.shape)}, want int32 "
           f"[{n_heads}, {nb}, W]")
    return BH, n_heads, S, D, block, int(tbl.shape[2])


def _tail(shape, q, causal, scale, rate, seed):
    from ..ops.transformer.dropout import keep_threshold

    _check(0.0 <= rate < 1.0, lambda: f"dropout rate {rate} not in [0, 1)")
    on = rate > 0.0
    return (*shape, ctypes.c_float(scale), int(bool(causal)),
            int(seed) if on else 0, keep_threshold(rate) if on else 0,
            ctypes.c_float(1.0 / (1.0 - rate)), int(on), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def _launch(name, *args):
    lib = _lib()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: cudaError {err} "
            f"({lib.flash_sparse_error_string(err).decode()})")
    LAUNCHES[name] += 1


def flash_sparse_fwd_cuda(q, k, v, fwd_tbl, *, causal, scale, block, rate,
                          seed, n_heads):
    """-> (out [BH, S, D] in q's dtype, lse [BH, S] fp32)."""
    shape = _common(q, k, v, fwd_tbl, block, n_heads)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch("flash_sparse_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            fwd_tbl.data_ptr(), out.data_ptr(), lse.data_ptr(),
            *_tail(shape, q, causal, scale, rate, seed))
    return out, lse


def flash_sparse_dq_cuda(q, k, v, dout, lse, delta, fwd_tbl, *, causal,
                         scale, block, rate, seed, n_heads):
    """-> dq [BH, S, D] in q's dtype."""
    shape = _common(q, k, v, fwd_tbl, block, n_heads,
                    _bwd_checks(q, dout, lse, delta))
    dq = torch.empty_like(q)
    _launch("flash_sparse_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            fwd_tbl.data_ptr(), dq.data_ptr(),
            *_tail(shape, q, causal, scale, rate, seed))
    return dq


def _route(name, q, block) -> str:
    code = getattr(_lib(), name)(_DTYPE_CODES[q.dtype], q.shape[-1], block)
    return {1: "wgmma", 2: "cuda-cores"}.get(code, "mma.sync")


def fwd_route(q, block) -> str:
    """The kernel `flash_sparse_fwd_cuda` launches for q's dtype and
    head_dim under layout block `block`, as the launcher picks it:
    "wgmma", "mma.sync" or "cuda-cores"."""
    return _route("flash_sparse_fwd_route", q, block)


def dq_route(q, block) -> str:
    """The kernel `flash_sparse_dq_cuda` launches for q's dtype and
    head_dim under layout block `block`, as the launcher picks it:
    "wgmma", "mma.sync" or "cuda-cores"."""
    return _route("flash_sparse_dq_route", q, block)


def flash_sparse_dkv_cuda(q, k, v, dout, lse, delta, rev_tbl, *, order,
                          causal, scale, block, rate, seed, n_heads):
    """-> (dk, dv) [BH, S, D] in k's and v's dtype.  `order`: the reverse
    table's `dkv_work_order` on q's device (`device_tables` keeps it
    beside the tables); the launcher picks the kernel, and only the wgmma
    one reads it."""
    shape = _common(q, k, v, rev_tbl, block, n_heads,
                    _bwd_checks(q, dout, lse, delta))
    n = rev_tbl.shape[0] * rev_tbl.shape[1]
    _check(order.is_cuda and order.device == q.device and
           order.dtype == torch.int32 and tuple(order.shape) == (n,) and
           order.is_contiguous(),
           lambda: f"work order {order.dtype} {tuple(order.shape)} on "
           f"{order.device}, want contiguous int32 [{n}] on {q.device}")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_sparse_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            rev_tbl.data_ptr(), order.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_tail(shape, q, causal, scale, rate, seed))
    return dk, dv


def kernel_tolerances(q, k, v, dout, layout, ref, *, causal, scale, block,
                      rate, seed, n_heads, rows_per_chunk=1 << 27, **_):
    """Per-element bounds on |kernel - plain| for the four outputs
    `ref = {"out", "dq", "dk", "dv"}` of the plain versions on these
    inputs ([BH, S, D] tensors, dout the upstream gradient), under the
    [H, nb, nb] 0/1 `layout`.

    The dense derivation of `kernels/flash.py` `kernel_tolerances`, with
    the scores restricted to the layout's active tiles
    (kron(layout, ones(block, block))) and causally masked inside them as
    the kernels do: with u the dtype's unit roundoff, 2u|ref| for the two
    sides' final roundings; (2u for out and dq, which round p and ds to
    the input dtype before their second product, + 1e-5)·M for fp32 sums
    in another order, M the output's absolute-value product (out
    P_d|V|, dq scale·|dS||K|, dk scale·|dS|ᵀ|Q|, dv P_dᵀ|dO|); and for dq
    and dk the error of dp = dO·Vᵀ where ds cancels, 1e-5 of its
    absolute-value sum E = |dO|·|V|ᵀ: (1 + 2u)·1e-5·scale·(P_d∘E)|K| and
    1e-5·scale·(P_d∘E)ᵀ|Q|.  The tiles' order of the online softmax
    differs between the kernels (64 or 16 keys at a time) and the plain
    versions (a layout block at a time); that is a difference of fp32 sums
    and of the reference point of p's rounding, both inside these terms.
    A row whose active entries are all causally masked takes p = 1 on
    them, as both sides do.  Computed densely over the batch-heads,
    `rows_per_chunk` score elements at a time."""
    from ..ops.transformer.dropout import _keep_mask
    from ..ops.transformer.flash_attention import NEG_INF
    from .flash import _UNIT_ROUNDOFF, bounds_from_probs

    u = _UNIT_ROUNDOFF[q.dtype]
    BH, S, D = q.shape
    dev = q.device
    lay = torch.as_tensor(np.asarray(layout) != 0, device=dev)
    allow = lay.repeat_interleave(block, 1).repeat_interleave(block, 2)
    causal_ok = (torch.arange(S, device=dev)[:, None] >=
                 torch.arange(S, device=dev)[None, :])
    tols = {name: torch.empty(BH, S, D, dtype=torch.float32, device=dev)
            for name in ("out", "dq", "dk", "dv")}
    step = max(1, rows_per_chunk // (S * S))
    for b0 in range(0, BH, step):
        sl = slice(b0, min(BH, b0 + step))
        bh = torch.arange(sl.start, sl.stop, device=dev)
        q32, k32, v32, do32 = (t[sl].float() for t in (q, k, v, dout))
        active = allow[bh % n_heads]
        s = (q32 * scale) @ k32.transpose(-1, -2)
        if causal:
            s = torch.where(causal_ok, s, NEG_INF)
        m = torch.where(active, s, float("-inf")).amax(dim=-1, keepdim=True)
        m = torch.where(torch.isinf(m), 0.0, m)
        p = torch.where(active, torch.exp(s - m), 0.0)
        del s
        den = p.sum(dim=-1, keepdim=True)
        p = p / torch.where(den == 0.0, 1.0, den)
        mask = 1.0
        if rate > 0.0:
            mask = _keep_mask(seed, bh, 0, 0, S, S, rate, dev)
        part = bounds_from_probs(p, mask, q32, k32, v32, do32,
                                 {n: r[sl] for n, r in ref.items()}, scale, u)
        for name, t in part.items():
            tols[name][sl] = t
    return tols

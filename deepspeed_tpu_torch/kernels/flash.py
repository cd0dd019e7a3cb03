"""Wrappers of the flash-attention Hopper kernels
(`csrc/flash_attention.cu`), which replace the TPU kernels `_fwd_kernel`,
`_dq_kernel` and `_dkv_kernel` of
deepspeed_tpu/ops/transformer/flash_attention.py (:113, :227, :280).

Each takes the arguments of its plain PyTorch version
(`ops/transformer/flash_attention.py` `_fwd_plain`, `_dq_plain`,
`_dkv_plain`) and returns the same tensors, at head_dim 64, 128 or 256.
The kernels tile the sequence themselves (64 rows or fewer), so
`block_q` / `block_k` only pass the divisibility checks of the entry point
and do not reach the card.  The launcher picks each kernel from the dtype
and head_dim alone: the forward is a warp-specialised wgmma kernel fed by
TMA for bf16 / fp16; dQ is one too for bf16 / fp16 at head_dim 64 and 128
(mma.sync at 256) and dK/dV for bf16 at 64 and 128 (its fp32 pd and ds fed
to the tensor cores as three bf16 terms); the rest run on the CUDA cores.
`dq_route` and `dkv_route` say which kernel a call takes.  A wrapper checks
device, dtype, shape, contiguity and alignment, launches its kernel on
PyTorch's current stream, raises on a launch error and counts the launch
in `LAUNCHES`; it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

# kernel launches since the last reset, per kernel (the main path's proof
# of use)
LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0,
                            "flash_attention_dq": 0,
                            "flash_attention_dkv": 0}

HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# BH, H, S, Sk, D, scale, causal, seed, bh_offset, thr, inv_keep, dropout,
# dtype, stream
_TAIL = [_I] * 5 + [_F, _I, _I, _I, _U, _F, _I, _I, _P]
_ARGTYPES = {"flash_attention_fwd": [_P] * 6 + _TAIL,
             "flash_attention_dq": [_P] * 8 + _TAIL,
             "flash_attention_dkv": [_P] * 9 + _TAIL,
             "flash_attention_dq_route": [_I, _I],
             "flash_attention_dkv_route": [_I, _I]}


def _lib():
    from . import build

    lib = build.load("flash_attention.cu")
    if lib.flash_attention_fwd.argtypes is None:
        # without argtypes ctypes passes every int as a 32-bit C int and
        # cuts the pointers
        for name, types in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = types
            fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond, msg):
    if not cond:
        raise ValueError(f"flash attention kernel: {msg()}")


def _common(q, k, v, kb, n_heads, extra=()):
    """Validate the launch's tensors; returns the scalar tail's shape part
    (BH, H, S, Sk, D)."""
    BH, S, D = q.shape
    Sk = k.shape[1]
    tensors = [("q", q), ("k", k), ("v", v), *extra]
    if kb is not None:
        tensors.append(("key_bias", kb))
    for name, t in tensors:
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
    _check(k.shape == (BH, Sk, D) and v.shape == k.shape,
           lambda: f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
           f"q {tuple(q.shape)}")
    _check(BH % n_heads == 0 and BH <= 65535,
           lambda: f"B*H = {BH} must be a multiple of n_heads {n_heads} "
           f"and at most 65535")
    if kb is not None:
        _check(kb.dtype == torch.float32 and
               kb.shape == (BH // n_heads, Sk),
               lambda: f"key_bias {kb.dtype} {tuple(kb.shape)}, want fp32 "
               f"[{BH // n_heads}, {Sk}]")
    return BH, n_heads, S, Sk, D


def _tail(shape, q, causal, scale, rate, seed, bh_offset):
    from ..ops.transformer.dropout import keep_threshold

    _check(0.0 <= rate < 1.0, lambda: f"dropout rate {rate} not in [0, 1)")
    on = rate > 0.0
    return (*shape, ctypes.c_float(scale), int(bool(causal)),
            int(seed) if on else 0, int(bh_offset),
            keep_threshold(rate) if on else 0,
            ctypes.c_float(1.0 / (1.0 - rate)), int(on), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def _launch(name, *args):
    lib = _lib()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: cudaError {err} "
            f"({lib.flash_attention_error_string(err).decode()})")
    LAUNCHES[name] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def products(name, q, k, *rest) -> int:
    """The products a flop count credits to one call of `name` (the
    registry's `product_count`): those of the dense attention the kernel
    replaces (ops/transformer/attention.py `xla_attention` and its
    autograd backward), 2·BH·S·Sk·D each — the forward's Q·Kᵀ and P·V,
    dQ's dO·Vᵀ and dS·K, dK/dV's Pᵀ·dO and dSᵀ·Q.  A causal call is
    counted as the full square the dense path computes (it masks and
    does not skip), as the JAX package's count of its plain path does;
    the kernels skip the blocks above the diagonal, so their achieved
    rate on this count overstates their own work by up to 2x."""
    del name, rest
    BH, S, D = q.shape
    return 2 * 2 * BH * S * k.shape[1] * D


def flash_fwd_cuda(q, k, v, kb, *, causal, scale, block_q, block_k, rate,
                   seed, bh_offset, n_heads):
    """-> (out [BH, S, D] in q's dtype, lse [BH, S] fp32)."""
    del block_q, block_k  # the kernel's own tiling
    shape = _common(q, k, v, kb, n_heads)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(kb), out.data_ptr(), lse.data_ptr(),
            *_tail(shape, q, causal, scale, rate, seed, bh_offset))
    return out, lse


def _bwd_checks(q, dout, lse, delta):
    BH, S, _ = q.shape
    _check(dout.shape == q.shape and dout.dtype == q.dtype,
           lambda: f"dout {dout.dtype} {tuple(dout.shape)} does not match q")
    for name, t in (("lse", lse), ("delta", delta)):
        _check(t.dtype == torch.float32 and t.shape == (BH, S),
               lambda: f"{name} {t.dtype} {tuple(t.shape)}, want fp32 "
               f"[{BH}, {S}]")
    return (("dout", dout), ("lse", lse), ("delta", delta))


def flash_dq_cuda(q, k, v, dout, lse, delta, kb, *, causal, scale, block_q,
                  block_k, rate, seed, bh_offset, n_heads):
    """-> dq [BH, S, D] in q's dtype."""
    del block_q, block_k
    shape = _common(q, k, v, kb, n_heads, _bwd_checks(q, dout, lse, delta))
    dq = torch.empty_like(q)
    _launch("flash_attention_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(kb),
            dq.data_ptr(),
            *_tail(shape, q, causal, scale, rate, seed, bh_offset))
    return dq


def flash_dkv_cuda(q, k, v, dout, lse, delta, kb, *, causal, scale, block_q,
                   block_k, rate, seed, bh_offset, n_heads):
    """-> (dk, dv) [BH, Sk, D] in k's and v's dtype."""
    del block_q, block_k
    shape = _common(q, k, v, kb, n_heads, _bwd_checks(q, dout, lse, delta))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_attention_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(kb),
            dk.data_ptr(), dv.data_ptr(),
            *_tail(shape, q, causal, scale, rate, seed, bh_offset))
    return dk, dv


def _route(name, q) -> str:
    _check(q.is_cuda, lambda: f"q is on {q.device}, not a CUDA device")
    _check(q.dtype in _DTYPE_CODES,
           lambda: f"dtype {q.dtype} not in {sorted(map(str, _DTYPE_CODES))}")
    _check(q.shape[-1] in HEAD_DIMS,
           lambda: f"head_dim {q.shape[-1]} not in {HEAD_DIMS}")
    code = getattr(_lib(), name)(_DTYPE_CODES[q.dtype], q.shape[-1])
    return {1: "wgmma", 0: "mma.sync", 2: "cuda-cores"}[code]


def dq_route(q) -> str:
    """The kernel `flash_dq_cuda` launches for q's dtype and head_dim, as
    the launcher picks it: "wgmma", "mma.sync" or "cuda-cores"."""
    return _route("flash_attention_dq_route", q)


def dkv_route(q) -> str:
    """The kernel `flash_dkv_cuda` launches for q's dtype and head_dim, as
    the launcher picks it: "wgmma" or "cuda-cores"."""
    return _route("flash_attention_dkv_route", q)


# unit roundoff (half an ulp, relative) of each dtype the kernels take
_UNIT_ROUNDOFF = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8,
                  torch.float16: 2.0 ** -11}


def kernel_tolerances(q, k, v, dout, kb, ref, *, causal, scale, rate, seed,
                      bh_offset, n_heads, **_):
    """Per-element bounds on |kernel - plain| for the four outputs
    `ref = {"out", "dq", "dk", "dv"}` of the plain versions on these
    inputs ([BH, S, D] tensors, dout the upstream gradient).

    With u the dtype's unit roundoff (0 for fp32), each side rounds its
    output once (at most u relative, so 2u|ref| between them).  Inside,
    the two compute the same fp32 numbers up to the order of fp32 sums
    and the last ulps of exp: 1e-5 of the output's absolute-value product
    M (below).  The forward rounds p to V's dtype and dQ rounds ds to K's
    dtype on both sides; a rounding can land on neighbouring values where
    the fp32 inputs straddle a rounding boundary, one ulp (2u) of that
    term at most, hence 2u·M for those two.  M, from a dense fp32
    recomputation on the card: out P_d|V|, dq scale·|dS||K|, dk
    scale·|dS|ᵀ|Q|, dv P_dᵀ|dO| (P_d the dropped probabilities).

    dq and dk also carry the error of dp = dO·Vᵀ, which M does not see:
    ds = p (dp·mask - delta), and the two sides' dp differ by the order of
    their fp32 sums, 1e-5 of dp's own absolute-value sum E = |dO|·|V|ᵀ —
    not of |dp - delta|, which cancels to nothing where delta equals dp
    (a causal row's first key, whose p is 1 and whose dp is delta, up to
    the rounding of the output delta is formed from).  There ds is little
    more than that rounding and the sums' noise, and M is small beside the
    noise (fp16 inputs most: products of 11-bit mantissas, so sums of Dh
    of them round; bf16 products have 8, and their sums rarely do).  Hence
    (1 + 2u)·1e-5·scale·(P_d∘E)|K| for dq (the factor covers dQ's
    rounding of the perturbed ds) and 1e-5·scale·(P_d∘E)ᵀ|Q| for dk."""
    from ..ops.transformer.dropout import _keep_mask
    from ..ops.transformer.flash_attention import NEG_INF

    u = _UNIT_ROUNDOFF[q.dtype]
    BH, S, _ = q.shape
    Sk = k.shape[1]
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, dout))
    s = (q32 * scale) @ k32.transpose(-1, -2)
    if causal:
        keep = (torch.arange(S, device=q.device)[:, None] >=
                torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(keep, s, NEG_INF)
    if kb is not None:
        s = s + kb[torch.arange(BH, device=q.device) // n_heads][:, None, :]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if kb is not None:
        p = torch.where(s <= NEG_INF * 0.5, 0.0, p)
    den = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(den == 0.0, 1.0, den)
    del s
    mask = 1.0
    if rate > 0.0:
        bh = torch.arange(BH, device=q.device) + int(bh_offset)
        mask = _keep_mask(seed, bh, 0, 0, S, Sk, rate, q.device)
    return bounds_from_probs(p, mask, q32, k32, v32, do32, ref, scale, u)


def bounds_from_probs(p, mask, q32, k32, v32, do32, ref, scale, u):
    """The four bounds of `kernel_tolerances` from the normalised fp32
    probabilities `p` [BH, S, Sk], the dropout `mask` (or 1.0), the fp32
    inputs and the plain outputs `ref` (the sparse kernels' bounds use it
    with p restricted to their layout)."""
    pd = p * mask
    dp = (do32 @ v32.transpose(-1, -2)) * mask
    delta = (do32 * ref["out"].float()).sum(dim=-1, keepdim=True)
    ds_abs = (p * (dp - delta)).abs()
    # the error of dp: 1e-5 of its absolute-value sum, where p weighs it
    dp_err = 1e-5 * pd * (do32.abs() @ v32.abs().transpose(-1, -2))
    del dp
    mags = {"out": pd @ v32.abs(),
            "dv": pd.transpose(-1, -2) @ do32.abs(),
            "dq": scale * (ds_abs @ k32.abs()),
            "dk": scale * (ds_abs.transpose(-1, -2) @ q32.abs())}
    extra = {"dq": (1 + 2 * u) * scale * (dp_err @ k32.abs()),
             "dk": scale * (dp_err.transpose(-1, -2) @ q32.abs())}
    tols = {}
    for name, m in mags.items():
        inner = 2 * u if name in ("out", "dq") else 0.0
        tols[name] = (2 * u * ref[name].float().abs() + (inner + 1e-5) * m
                      + extra.get(name, 0.0) + 1e-6)
    return tols

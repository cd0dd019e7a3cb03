"""Paged attention over the PagedKVCache: the plain PyTorch version and
the wrapper of the Hopper kernel (`csrc/paged_attention.cu`), which
replaces the TPU kernel `_paged_kernel` (deepspeed_tpu/kernels/paged.py:127).

`paged_attention_reference` is op for op the JAX
`paged_attention_reference` (paged.py:78), the expression the serving
block always ran: gather the slot's cache rows, fp32 scores scaled by
Dh**-0.5, a `where(q_pos >= k_idx, s, NEG_INF)` select, softmax, probs
cast to the cache dtype, then the PV product; the output is in the
cache dtype.

`paged_attention_cuda` launches the kernel.  It takes the same
arguments and serves decode (T = 1) and prefill (T = prefill_chunk)
alike, at head_dim 64 and 128, with the cache in fp32, bf16 or fp16.
The kernel reads q where it lies (the strided view of the fused QKV
output, in fp32 or the cache dtype) and the int64 rows and positions the
serving programs build once per step, so on the serving path a call
launches the kernel and no other device work.  Its probabilities stay
fp32 into the PV product, so against the reference it agrees to fp32
rounding on an fp32 cache, and on a bf16 cache to within the bound of
`bf16_tolerance`.

Only the dense cache is ported; the int8/int4 branches of the TPU kernel
come with the quantized-KV slice.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.generation import NEG_INF

# kernel launches since the last reset (the main path's proof of use)
LAUNCHES = 0

HEAD_DIMS = (64, 128)
# the kernel tiles query rows 8 to a thread block on grid.y (<= 65535)
MAX_Q_LEN = 65535 * 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# unit roundoff (half an ulp, relative) of the narrow cache dtypes
_UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}


def kv_read(c, rows, kv_mode: str = "dense"):
    """Gather cache rows `rows` [B, L] -> [B, L, H, Dh] at the cache
    dtype.  Dense only in this slice."""
    if kv_mode != "dense":
        raise NotImplementedError(
            f"kv_mode {kv_mode!r}: quantized KV is not ported yet (ROADMAP: "
            f"the quantized-KV and speculative slice)")
    return c[rows]


def paged_attention_reference(q, ck, cv, rows, q_pos, *,
                              kv_mode: str = "dense", block_size: int = 0):
    """q [B, T, H, Dh], caches addressed by flat rows [B, L], q_pos
    [B, T] absolute positions -> attn [B, T, H, Dh] at the cache dtype."""
    del block_size  # kernel tiling knob; the gather needs only rows
    Dh = q.shape[-1]
    keys = kv_read(ck, rows, kv_mode)      # [B, L, H, Dh]
    vals = kv_read(cv, rows, kv_mode)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          keys.float()) * (Dh ** -0.5)
    L = rows.shape[1]
    k_idx = torch.arange(L, device=q.device)[None, None, :]
    mask = q_pos[:, :, None] >= k_idx            # [B, T, L]
    scores = torch.where(mask[:, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(vals.dtype), vals)


def bf16_tolerance(q, ck, cv, rows, q_pos, ref):
    """Per-element bound on |kernel - reference| for a bf16 (or fp16)
    cache, with u its unit roundoff (2^-8 for bf16).  The reference
    rounds each probability to the cache dtype before PV (relative error
    at most u), the kernel keeps it fp32, so their fp32 sums differ by at
    most u * sum_k p_k |v_k|; then each side rounds its output once (at
    most u relative, each).  Bound: 4 u |ref| (two ulps of |ref|: one for
    the two roundings, one for the plain product's own reduction order)
    + 1.01 u (P |V|) + 1e-6."""
    u = _UNIT_ROUNDOFF[ck.dtype]
    p_abs_v = paged_attention_reference(q.float(), ck.float(),
                                        cv.float().abs(), rows, q_pos)
    return 4 * u * ref.float().abs() + 1.01 * u * p_abs_v + 1e-6


def _lib():
    from . import build

    lib = build.load("paged_attention.cu")
    fn = lib.paged_attention_fwd
    if fn.argtypes is None:
        # without argtypes ctypes passes every int as a 32-bit C int and
        # cuts the pointers
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3 +
                       [ctypes.c_int] + [ctypes.c_void_p] * 5 +
                       [ctypes.c_int] * 6 +
                       [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond, msg):
    """Raise ValueError with msg() when cond is false; the message is
    built only then (this wrapper runs 48 times per serving step on a
    path bound by the host)."""
    if not cond:
        raise ValueError(f"paged attention kernel: {msg()}")


def paged_attention_cuda(q, ck, cv, rows, q_pos, *, kv_mode: str = "dense",
                         block_size: int):
    """Launch the Hopper kernel; same contract as the reference.  Raises
    on anything the kernel does not take — it never falls back."""
    global LAUNCHES
    B, T, H, Dh = q.shape
    L = rows.shape[1]
    bs = int(block_size)
    if bs <= 0 or L % bs:
        raise ValueError(
            f"paged attention kernel needs rows ([{B}, {L}]) to cover "
            f"whole cache blocks of {bs}")
    if kv_mode != "dense":
        raise NotImplementedError(
            f"kv_mode {kv_mode!r}: the kernel's quantized branches are not "
            f"ported yet (ROADMAP: the quantized-KV and speculative slice)")
    for name, t in (("q", q), ("ck", ck), ("cv", cv), ("rows", rows),
                    ("q_pos", q_pos)):
        _check(t.is_cuda,
               lambda: f"{name} is on {t.device}, not a CUDA device")
        _check(t.device == q.device,
               lambda: f"{name} is on {t.device}, q on {q.device}")
    _check(ck.dtype in _DTYPE_CODES and cv.dtype == ck.dtype,
           lambda: f"cache dtypes {ck.dtype}/{cv.dtype}; want one of "
           f"{sorted(map(str, _DTYPE_CODES))}, equal for K and V")
    _check(Dh in HEAD_DIMS, lambda: f"head_dim {Dh} not in {HEAD_DIMS}")
    _check(1 <= T <= MAX_Q_LEN,
           lambda: f"q_len {T} outside [1, {MAX_Q_LEN}]")
    _check(ck.dim() == 3 and ck.shape == cv.shape and
           ck.shape[1] == H and ck.shape[2] == Dh,
           lambda: f"caches {tuple(ck.shape)}/{tuple(cv.shape)}, want "
           f"[rows, {H}, {Dh}]")
    _check(ck.shape[0] % bs == 0 and ck.shape[0] >= bs,
           lambda: f"cache rows {ck.shape[0]} not whole blocks of {bs}")
    _check(q_pos.shape == (B, T) and rows.shape[0] == B,
           lambda: f"q_pos {tuple(q_pos.shape)} / rows {tuple(rows.shape)} "
           f"do not match q [{B}, {T}, ...]")
    _check(ck.is_contiguous() and cv.is_contiguous(),
           lambda: "caches must be contiguous")
    _check(ck.data_ptr() % 16 == 0 and cv.data_ptr() % 16 == 0,
           lambda: "cache storage must be 16-byte aligned (cp.async)")
    # the serving programs pass q as a view of the QKV output in the cache
    # dtype, int64 rows and positions: none of these copies runs there
    if q.dtype not in (torch.float32, ck.dtype):
        q = q.float()
    if q.stride(-1) != 1:
        q = q.contiguous()
    rows = rows.to(torch.int64).contiguous()
    q_pos = q_pos.to(torch.int64).contiguous()
    out = torch.empty((B, T, H, Dh), dtype=ck.dtype, device=q.device)
    lib = _lib()
    err = lib.paged_attention_fwd(
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        int(q.dtype == torch.float32), ck.data_ptr(), cv.data_ptr(),
        rows.data_ptr(), q_pos.data_ptr(), out.data_ptr(), B, T, H, Dh, L,
        ck.shape[0], ctypes.c_float(Dh ** -0.5), _DTYPE_CODES[ck.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"paged attention kernel launch failed: cudaError {err} "
            f"({lib.paged_attention_error_string(err).decode()})")
    LAUNCHES += 1
    return out

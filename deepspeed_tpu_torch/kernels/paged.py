"""Paged attention over the PagedKVCache: the plain PyTorch version and
the wrapper of the Hopper kernel (`csrc/paged_attention.cuh`, built as one
library per cache kind), which
replaces the TPU kernel `_paged_kernel` (deepspeed_tpu/kernels/paged.py:127).

`paged_attention_reference` is op for op the JAX
`paged_attention_reference` (paged.py:78), the expression the serving
block always ran: gather the slot's cache rows (dequantized to fp32 when
the cache is int8/int4), fp32 scores scaled by Dh**-0.5, a
`where(q_pos >= k_idx, s, NEG_INF)` select, softmax, probs cast to the
value dtype, then the PV product; the output is in the cache dtype (fp32
for a quantized cache).

`paged_attention_cuda` launches the kernel.  It takes the same
arguments and serves decode (T = 1), verify (T = draft_len + 1) and
prefill (T = prefill_chunk) alike, at every head_dim (64 and 128 compiled
as such, the others through the kernel's head_dim-generic instantiation,
which streams the score over pieces of 1024 columns above that; an int4
cache needs an even head_dim, as its row codec does), with the cache in
fp32, bf16 or fp16, or as (payload, fp16 scales) pairs of int8 or int4
codes (`runtime/comm/quant.py` `quantize_rows`), dequantized in the
kernel's gather.  The kernel reads q where it lies (the strided view of
the fused QKV output) and the int64 rows and positions the serving
programs build once per step, so on the serving path a call is one
device operation: the kernel, no memset and no second pass.

Two routes (`route`): a prefill chunk (T >= 16) over a dense bf16/fp16
cache with q in its dtype at Dh 64 or 128 runs on the tensor cores and
carries its probabilities into P.V as two terms of the cache dtype (hi +
lo: p to the square of its unit roundoff); everything else splits the
keys over the card on the CUDA cores and keeps its probabilities fp32 into
P.V.  Either way the table width is cut into key ranges planned on the
host from the shapes alone (`split_plan`: no device value is read, no
sync), each range on its own thread block, and the last block of each
(slot, head, q tile) merges the ranges' partials in range order.  Against
the reference the kernel agrees to fp32 rounding on an fp32 or quantized
cache, and on a bf16 or fp16 cache to within the bound of
`bf16_tolerance`.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, Tuple

import torch

from ..models.generation import NEG_INF
from ..runtime.comm.quant import dequantize_rows, qmax

# kernel launches since the last reset (the main path's proof of use), and
# the same launches by route and by kind of call: decode (T = 1), verify
# (1 < T < TC_MIN_T, a draft and its bonus row) and prefill (T >= TC_MIN_T);
# bumped under _LAUNCH_LOCK, since serving worker threads launch at once
_LAUNCH_LOCK = threading.Lock()
LAUNCHES = 0
LAUNCHES_BY_ROUTE: Dict[str, int] = {"split-keys": 0, "tensor-cores": 0}
LAUNCHES_BY_KIND: Dict[str, int] = {"decode": 0, "verify": 0, "prefill": 0}

# the largest head_dim: a thread block accumulates 256 output columns and
# the grid holds at most 65535 such blocks of a row (grid.z)
COLS = 256
MAX_HEAD_DIM = 65535 * COLS
# the kernel tiles query rows 8 to a thread block on grid.y (<= 65535)
MAX_Q_LEN = 65535 * 8
# key splits are whole multiples of this many keys (one staged chunk)
SPLIT_UNIT = 128
# the split plan aims at this many thread blocks an SM on the H100 SXM's
# 132 SMs
SMS = 132
CTAS_PER_SM = 16
# the kernel's merge keeps a factor per (tile row, split) in shared memory:
# at most this many
MERGE_FACTORS = 1024
# the tensor-core route: query rows a block, head dims, the shortest chunk
TC_ROWS = 64
TC_HEAD_DIMS = (64, 128)
TC_MIN_T = 16
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the kernel's cache codes past the dense dtypes, and the payload dtypes
_QUANT_CODES = {"int8": 3, "int4": 4}
_PAYLOAD_DTYPES = {"int8": torch.int8, "int4": torch.uint8}
# unit roundoff (half an ulp, relative) of the narrow cache dtypes
_UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}


def kv_read(c, rows, kv_mode: str = "dense"):
    """Gather cache rows `rows` [B, L] -> [B, L, H, Dh].  Dense reads come
    back at the cache dtype; a quantized cache ((payload, scales) pairs)
    dequantizes the gathered rows to fp32."""
    if kv_mode == "dense":
        return c[rows]
    qmax(kv_mode)  # raises on an unknown mode
    payload, scales = c
    return dequantize_rows(payload[rows], scales[rows], kv_mode)


def paged_attention_reference(q, ck, cv, rows, q_pos, *,
                              kv_mode: str = "dense", block_size: int = 0):
    """q [B, T, H, Dh], caches addressed by flat rows [B, L], q_pos
    [B, T] absolute positions -> attn [B, T, H, Dh] at the cache dtype
    (fp32 for a quantized cache)."""
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
    at most u); the split-keys route keeps it fp32, so their fp32 sums
    differ by at most u * sum_k p_k |v_k|; then each side rounds its output
    once (at most u relative, each).  The tensor-core route carries each
    probability as two terms of the cache dtype whose sum is p to u^2
    relative (in fp16 down to p = 2^-18; below it at most 2^-40 a key), so
    it adds at most u^2 * sum_k p_k |v_k| to the same difference: 1.004 u
    at bf16.  Bound: 4 u |ref| (two ulps of |ref|: one for the two output
    roundings, one for the plain product's own reduction order) +
    1.01 u (P |V|) + 1e-6."""
    u = _UNIT_ROUNDOFF[ck.dtype]
    p_abs_v = paged_attention_reference(q.float(), ck.float(),
                                        cv.float().abs(), rows, q_pos)
    return 4 * u * ref.float().abs() + 1.01 * u * p_abs_v + 1e-6


def reset_launches():
    """Zero the launch counts: in all, by route and by kind."""
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES = 0
        for counts in (LAUNCHES_BY_ROUTE, LAUNCHES_BY_KIND):
            for k in counts:
                counts[k] = 0


def call_kind(T: int) -> str:
    """The kind of call a q of T rows makes: "decode" (T = 1), "verify"
    (1 < T < TC_MIN_T) or "prefill"."""
    return "decode" if T == 1 else "verify" if T < TC_MIN_T else "prefill"


def tile_rows(T: int, route: str = "split-keys") -> int:
    """Query rows of a thread block's tile: 64 on the tensor cores, one at
    decode (T = 1) and 8 otherwise on the split-keys route."""
    if route == "tensor-cores":
        return TC_ROWS
    return 1 if T == 1 else 8


def split_plan(B: int, H: int, T: int, L: int, bs: int, *,
               rows: int = 0, col_blocks: int = 1):
    """How the kernel cuts the table width L into key ranges, from the
    shapes alone (no device value): -> (n_splits, split_keys).

    A range is a whole multiple of 128 keys and of the cache block `bs`,
    ranges cover [0, L) once in order (the last may be short), and there
    are enough of them that the grid — B H x ceil(T / rows) x col_blocks
    groups x n_splits — reaches CTAS_PER_SM blocks on each of the SMS
    SMs, or one range a unit of keys where the table is too short for
    that, and no more than MERGE_FACTORS / rows ranges (the merge's
    shared memory).  At decode (T = 1) a grid whose groups alone cover
    every SM keeps one range: there the merge costs more than the split
    saves (GPT-2 XL decode, PERF.md section 6).  `rows` is the route's
    tile height (`tile_rows`)."""
    rows = rows or tile_rows(T)
    groups = B * H * -(-T // rows) * col_blocks
    unit = SPLIT_UNIT * bs // math.gcd(SPLIT_UNIT, bs)
    most = -(-L // unit)
    if T == 1 and groups >= SMS:
        return 1, most * unit
    want = -(-(SMS * CTAS_PER_SM) // groups)
    cap = MERGE_FACTORS // rows
    n = max(1, min(most, want, cap))
    if n == cap and cap < min(most, want):
        # capped: ranges rounded up, so that there are at most `cap`
        keys = -(-L // (n * unit)) * unit
    else:
        keys = max(1, L // n // unit) * unit
    return -(-L // keys), keys


def route(q, ck, kv_mode: str = "dense") -> str:
    """The route the kernel takes for these operands: "tensor-cores" for a
    prefill chunk (T >= 16) over a dense bf16/fp16 cache with q in its
    dtype at Dh 64 or 128 (q's strides even and its storage 4-byte
    aligned: its fragments are read as 32-bit words), else
    "split-keys"."""
    T, Dh = q.shape[1], q.shape[-1]
    if (kv_mode == "dense" and ck.dtype in (torch.bfloat16, torch.float16)
            and q.dtype == ck.dtype and T >= TC_MIN_T and
            Dh in TC_HEAD_DIMS and q.data_ptr() % 4 == 0 and
            all(st % 2 == 0 for st in q.stride()[:3])):
        return "tensor-cores"
    return "split-keys"


@functools.lru_cache(maxsize=1024)
def _plan(B, H, T, L, bs, Dh, way):
    """-> (n_splits, split_keys, groups, floats of partials): `split_plan`
    for the route and the scratch its merge needs, memoised — the serving
    path asks the same few shapes 48 times a step."""
    rows = tile_rows(T, way)
    col_blocks = 1 if way == "tensor-cores" else -(-Dh // COLS)
    n, keys = split_plan(B, H, T, L, bs, rows=rows, col_blocks=col_blocks)
    groups = B * H * -(-T // rows) * col_blocks
    # each split's (acc, m, l) per tile row
    return n, keys, groups, groups * n * rows * (min(Dh, COLS) + 2)


# per (device, stream): the merge's tickets, one a group, zero between
# launches (the merging block resets its own), and the splits' partials,
# written before they are read; both grown, never shrunk.  Calls on one
# stream are ordered, so one call's merge is done before the next call on
# that stream writes; calls on two streams (two serving replicas, each
# with a stream of its own) may run at once, so each stream has its own.
# A buffer is made on the stream that uses it (the tickets' zero fill
# lands before that stream's first launch); _SCRATCH_LOCK guards the maps
# against two worker threads growing them at once.
_SCRATCH_LOCK = threading.Lock()
_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}
_PARTS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _scratch(device, stream, groups, floats):
    key = (device, stream.cuda_stream)
    with _SCRATCH_LOCK:
        t = _TICKETS.get(key)
        if t is None or t.numel() < groups:
            t = _TICKETS[key] = torch.zeros(max(groups, 4096),
                                            dtype=torch.int32, device=device)
        p = _PARTS.get(key)
        if p is None or p.numel() < floats:
            p = _PARTS[key] = torch.empty(floats, dtype=torch.float32,
                                          device=device)
    return p, t


# the library of each cache code: one per cache kind, so that the kernel's
# instantiations compile in parallel (csrc/paged_attention.cuh)
_SOURCES = {0: "paged_attention.cu", 1: "paged_attention.cu",
            2: "paged_attention_f16.cu", 3: "paged_attention_int8.cu",
            4: "paged_attention_int4.cu"}


def _lib(code):
    from . import build

    lib = build.load(_SOURCES[code])
    fn = lib.paged_attention_fwd
    if lib.paged_attention_error_string.restype is ctypes.c_char_p:
        return lib
    with _LAUNCH_LOCK:
        # bound once, whole, before any thread calls: without argtypes
        # ctypes passes every int as a 32-bit C int and cuts the pointers
        # (the error string's restype, set last, marks a bound library)
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3 +
                       [ctypes.c_int] + [ctypes.c_void_p] * 7 +
                       [ctypes.c_int] * 6 +
                       [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 2 +
                       [ctypes.c_int] * 3 + [ctypes.c_void_p])
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


def _cache_parts(ck, cv, kv_mode, H, Dh):
    """-> (K payload, V payload, K scales, V scales, cache code, out
    dtype), checked against what the kernel takes."""
    if kv_mode == "dense":
        _check(ck.dtype in _DTYPE_CODES and cv.dtype == ck.dtype,
               lambda: f"cache dtypes {ck.dtype}/{cv.dtype}; want one of "
               f"{sorted(map(str, _DTYPE_CODES))}, equal for K and V")
        _check(ck.dim() == 3 and ck.shape == cv.shape and
               ck.shape[1:] == (H, Dh),
               lambda: f"caches {tuple(ck.shape)}/{tuple(cv.shape)}, want "
               f"[rows, {H}, {Dh}]")
        return ck, cv, None, None, _DTYPE_CODES[ck.dtype], ck.dtype
    _check(kv_mode in _QUANT_CODES,
           lambda: f"kv_mode {kv_mode!r}; want 'dense' or one of "
           f"{sorted(_QUANT_CODES)}")
    (pk, sk), (pv, sv) = ck, cv
    width = Dh if kv_mode == "int8" else Dh // 2
    pdt = _PAYLOAD_DTYPES[kv_mode]
    _check(pk.dtype == pdt and pv.dtype == pdt and
           pk.shape == pv.shape == (pk.shape[0], H, width),
           lambda: f"{kv_mode} payloads {pk.dtype} {tuple(pk.shape)} / "
           f"{pv.dtype} {tuple(pv.shape)}, want {pdt} [rows, {H}, {width}]")
    _check(sk.dtype == torch.float16 and sv.dtype == torch.float16 and
           sk.shape == sv.shape == (pk.shape[0], H),
           lambda: f"scales {sk.dtype} {tuple(sk.shape)} / {sv.dtype} "
           f"{tuple(sv.shape)}, want fp16 [{pk.shape[0]}, {H}]")
    _check(sk.is_contiguous() and sv.is_contiguous(),
           lambda: "scales must be contiguous")
    return pk, pv, sk, sv, _QUANT_CODES[kv_mode], torch.float32


def paged_attention_cuda(q, ck, cv, rows, q_pos, *, kv_mode: str = "dense",
                         block_size: int):
    """Launch the Hopper kernel on the calling thread's current stream;
    same contract as the reference.  Raises on anything the kernel does
    not take — it never falls back.  The split merge's tickets and
    partials are kept per (device, stream): calls on one stream are
    ordered, and calls on two streams may overlap without sharing
    them."""
    global LAUNCHES
    B, T, H, Dh = q.shape
    L = rows.shape[1]
    bs = int(block_size)
    if bs <= 0 or L % bs:
        raise ValueError(
            f"paged attention kernel needs rows ([{B}, {L}]) to cover "
            f"whole cache blocks of {bs}")
    _check(0 < Dh <= MAX_HEAD_DIM,
           lambda: f"head_dim {Dh} is above {MAX_HEAD_DIM}, the largest the "
           f"kernel takes: a block accumulates {COLS} output columns and the "
           f"grid holds at most 65535 blocks of a row")
    _check(kv_mode != "int4" or Dh % 2 == 0,
           lambda: f"head_dim {Dh}: an int4 cache packs two codes a byte "
           f"and needs an even head_dim (runtime/comm/quant.py "
           f"quantize_rows refuses it too)")
    pk, pv, sk, sv, code, out_dtype = _cache_parts(ck, cv, kv_mode, H, Dh)
    tensors = [("q", q), ("ck", pk), ("cv", pv), ("rows", rows),
               ("q_pos", q_pos)]
    if sk is not None:
        tensors += [("k scales", sk), ("v scales", sv)]
    for name, t in tensors:
        _check(t.is_cuda,
               lambda: f"{name} is on {t.device}, not a CUDA device")
        _check(t.device == q.device,
               lambda: f"{name} is on {t.device}, q on {q.device}")
    _check(1 <= T <= MAX_Q_LEN,
           lambda: f"q_len {T} outside [1, {MAX_Q_LEN}]")
    _check(pk.shape[0] % bs == 0 and pk.shape[0] >= bs,
           lambda: f"cache rows {pk.shape[0]} not whole blocks of {bs}")
    _check(q_pos.shape == (B, T) and rows.shape[0] == B,
           lambda: f"q_pos {tuple(q_pos.shape)} / rows {tuple(rows.shape)} "
           f"do not match q [{B}, {T}, ...]")
    _check(pk.is_contiguous() and pv.is_contiguous(),
           lambda: "caches must be contiguous")
    _check(pk.data_ptr() % 16 == 0 and pv.data_ptr() % 16 == 0,
           lambda: "cache storage must be 16-byte aligned (cp.async)")
    # the serving programs pass q as a view of the QKV output in the model
    # dtype (a dense cache's own), int64 rows and positions: none of these
    # copies runs there
    if kv_mode == "dense":
        if q.dtype not in (torch.float32, pk.dtype):
            q = q.float()
    elif q.dtype not in _DTYPE_CODES:
        q = q.float()
    if q.stride(-1) != 1:
        q = q.contiguous()
    rows = rows.to(torch.int64).contiguous()
    q_pos = q_pos.to(torch.int64).contiguous()
    out = torch.empty((B, T, H, Dh), dtype=out_dtype, device=q.device)
    way = route(q, pk, kv_mode)
    n_splits, split_keys, groups, floats = _plan(B, H, T, L, bs, Dh, way)
    stream = torch.cuda.current_stream(q.device)
    part = tickets = None
    if n_splits > 1:
        part, tickets = _scratch(q.device, stream, groups, floats)
    lib = _lib(code)
    err = lib.paged_attention_fwd(
        q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
        _DTYPE_CODES[q.dtype], pk.data_ptr(), pv.data_ptr(),
        None if sk is None else sk.data_ptr(),
        None if sv is None else sv.data_ptr(), rows.data_ptr(),
        q_pos.data_ptr(), out.data_ptr(), B, T, H, Dh, L, pk.shape[0],
        ctypes.c_float(Dh ** -0.5), code,
        None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(), n_splits,
        split_keys, 1 if way == "tensor-cores" else 0, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"paged attention kernel launch failed: cudaError {err} "
            f"({lib.paged_attention_error_string(err).decode()})")
    with _LAUNCH_LOCK:
        LAUNCHES += 1
        LAUNCHES_BY_ROUTE[way] += 1
        LAUNCHES_BY_KIND[call_kind(T)] += 1
    return out

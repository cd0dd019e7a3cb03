"""Wrappers of the fused LM-head cross-entropy Hopper kernels
(`csrc/fused_xent.cu`), which replace the TPU kernels `_fwd_kernel`,
`_dx_kernel` and `_dw_kernel` of
deepspeed_tpu/ops/transformer/fused_xent.py (:52, :127, :145).

Each takes the arguments of its plain PyTorch version
(`ops/transformer/fused_xent.py` `_fwd_plain`, `_dx_plain`, `_dw_plain`)
and returns the same tensors.  The kernels tile the rows and the vocab
themselves, so `block_rows` / `block_v` only pass the divisibility check
of the entry point and do not reach the card.  The head weight is read
where it lies: the tied head `wte.t()` (strides (1, D)) or a contiguous
[D, V] matrix; dW comes back as the transposed view of a [V, D] tensor,
the layout of the tied embedding.  Any D is taken, as the JAX kernel takes
it: the tiles zero the columns past D, and above D = 1600 the backward
kernels split the output columns between blocks and stream the logits'
columns (`csrc/fused_xent.cu`).  The forward has a route of its own for
the tied head in bf16/fp16 at any D that is a multiple of 8 (nano's 48,
GPT-2's 768, XL's 1600): a persistent wgmma product fed by TMA with the
logsumexp, the running max and the label's logit formed in its epilogue,
128 x 256 logits tiles at a time.  dx and dW have a route of their own
for the tied head in bf16/fp16 at D = 256, 512 and 768 (GPT-2 small's
width): one wgmma kernel fed by TMA on a persistent grid, in its dx or its
dW role.  The launcher picks each route, and `fwd_route`, `dx_route` /
`dw_route` say which kernel a call takes.  A wrapper checks device, dtype, shape,
strides and alignment, launches its kernel on PyTorch's current stream,
raises on a launch error and counts the launch in `LAUNCHES`; it never
falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

# kernel launches since the last reset, per kernel (the main path's proof
# of use)
LAUNCHES: Dict[str, int] = {"fused_xent_fwd": 0, "fused_xent_dx": 0,
                            "fused_xent_dw": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# x, w, w_sv, w_sd, then per kernel its pointers, N, D, V, dtype, stream
_ARGTYPES = {"fused_xent_fwd": [_P, _P, _L, _L] + [_P] * 5 + [_I] * 5 + [_P],
             "fused_xent_dx": [_P, _P, _L, _L] + [_P] * 5 + [_I] * 4 + [_P],
             "fused_xent_dw": [_P, _P, _L, _L] + [_P] * 5 + [_I] * 4 + [_P],
             "fused_xent_fwd_route": [_I, _I, _L, _L, _P, _P],
             "fused_xent_dx_route": [_I, _I, _L, _L] + [_P] * 5,
             "fused_xent_dw_route": [_I, _I, _L, _L] + [_P] * 5}


def _lib():
    from . import build

    lib = build.load("fused_xent.cu")
    if lib.fused_xent_fwd.argtypes is None:
        # without argtypes ctypes passes every int as a 32-bit C int and
        # cuts the pointers
        for name, types in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = types
            fn.restype = ctypes.c_int
        lib.fused_xent_error_string.argtypes = [ctypes.c_int]
        lib.fused_xent_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond, msg):
    if not cond:
        raise ValueError(f"fused cross-entropy kernel: {msg()}")


def _w_strides(w, D, V):
    """(stride of v, stride of d) of the [D, V] head weight's elements."""
    if w.stride() == (1, D):
        return D, 1            # wte.t(): row v of the [V, D] embedding
    if w.stride() == (V, 1):
        return 1, V            # a contiguous [D, V] matrix
    raise ValueError(
        f"fused cross-entropy kernel: w strides {w.stride()} for shape "
        f"{tuple(w.shape)}; want a contiguous [D, V] or the transpose of a "
        f"contiguous [V, D]")


def _common(x, w, labels, extra=()):
    """Validate the launch's tensors; returns (N, D, V, w_sv, w_sd)."""
    N, D = x.shape
    V = w.shape[1]
    for name, t in (("x", x), ("w", w), ("labels", labels), *extra):
        _check(t.is_cuda, lambda: f"{name} is on {t.device}, not a CUDA "
               f"device")
        _check(t.device == x.device,
               lambda: f"{name} is on {t.device}, x on {x.device}")
    _check(x.dtype in _DTYPE_CODES and w.dtype == x.dtype,
           lambda: f"x/w dtypes {x.dtype}/{w.dtype}; want one of "
           f"{sorted(map(str, _DTYPE_CODES))}, equal for both")
    _check(x.is_contiguous(), lambda: "x must be contiguous")
    _check(w.shape[0] == D, lambda: f"w {tuple(w.shape)} does not match x "
           f"{tuple(x.shape)}")
    _check(x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
           lambda: "x and w storage must be 16-byte aligned")
    _check(labels.dtype == torch.int64 and labels.shape == (N,) and
           labels.is_contiguous(),
           lambda: f"labels {labels.dtype} {tuple(labels.shape)}, want "
           f"contiguous int64 [{N}]")
    _check(N * max(D, V) < 2 ** 31, lambda: f"N = {N} too large")
    return (N, D, V, *_w_strides(w, D, V))


def _launch(name, *args):
    lib = _lib()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: cudaError {err} "
            f"({lib.fused_xent_error_string(err).decode()})")
    LAUNCHES[name] += 1


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


# resident forward blocks an SM takes (registers, at 72 a thread)
_FWD_BLOCKS_PER_SM = 7


def _fwd_splits(N, V, device):
    """Vocab splits per 64-row block: enough blocks to fill every SM's
    resident slots, at most one vocab tile of 64 each, at most 64."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    row_blocks = -(-N // 64)
    want = -(-sms * _FWD_BLOCKS_PER_SM // row_blocks)
    return max(1, min(64, -(-V // 64), want))


def _wgmma_fwd_splits(N, V, device):
    """Vocab splits per 128-row tile of the wgmma forward: the count
    whose units (row tile, split) of 256-row vocab tiles, one CTA an SM,
    finish in the fewest rounds of tiles (the smaller count on a tie), at
    most 64."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n_rt, n_vt = -(-N // 128), -(-V // 256)
    return min(range(1, min(64, n_vt) + 1),
               key=lambda vs: (-(-n_rt * vs // sms) * -(-n_vt // vs), vs))


def fwd_route(x, w, labels) -> str:
    """The kernel `fused_xent_fwd_cuda` launches for these operands, as
    the launcher picks it: "wgmma", "mma.sync" or "cuda-cores"."""
    del labels  # the route depends on x and w alone
    D = x.shape[1]
    sv, sd = _w_strides(w, D, w.shape[1])
    code = _lib().fused_xent_fwd_route(_DTYPE_CODES[x.dtype], D, sv, sd,
                                       x.data_ptr(), w.data_ptr())
    if code == 1:
        return "wgmma"
    return "cuda-cores" if x.dtype == torch.float32 else "mma.sync"


def fused_xent_fwd_cuda(x, w, labels, *, block_rows, block_v):
    """-> (lse [N] fp32, label logit [N] fp32)."""
    del block_rows, block_v  # the kernel's own tiling
    N, D, V, sv, sd = _common(x, w, labels)
    lse = torch.empty((N,), dtype=torch.float32, device=x.device)
    ll = torch.empty((N,), dtype=torch.float32, device=x.device)
    vs = (_wgmma_fwd_splits(N, V, x.device)
          if fwd_route(x, w, labels) == "wgmma"
          else _fwd_splits(N, V, x.device))
    # each split's partial (max, sum, label logit), and one ticket per 64
    # rows (per 128 on the wgmma route) that the last split to finish takes
    part = torch.empty((3, vs, N), dtype=torch.float32, device=x.device)
    tickets = torch.zeros((-(-N // 64),), dtype=torch.int32, device=x.device)
    _launch("fused_xent_fwd", x.data_ptr(), w.data_ptr(), sv, sd,
            labels.data_ptr(), lse.data_ptr(), ll.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), N, D, V, vs, _DTYPE_CODES[x.dtype],
            _stream(x))
    return lse, ll


def _bwd(name, x, w, labels, lse, valid, g):
    g = g.to(torch.float32).reshape(1)
    N, D, V, sv, sd = _common(x, w, labels, (("lse", lse), ("valid", valid),
                                             ("g", g)))
    _check(lse.dtype == torch.float32 and lse.shape == (N,) and
           lse.is_contiguous(),
           lambda: f"lse {lse.dtype} {tuple(lse.shape)}, want fp32 [{N}]")
    _check(valid.dtype == torch.bool and valid.shape == (N,) and
           valid.is_contiguous(),
           lambda: f"valid {valid.dtype} {tuple(valid.shape)}, want bool "
           f"[{N}]")
    out = torch.empty((N, D) if name == "fused_xent_dx" else (V, D),
                      dtype=x.dtype, device=x.device)
    _launch(name, x.data_ptr(), w.data_ptr(), sv, sd, labels.data_ptr(),
            lse.data_ptr(), valid.data_ptr(), g.data_ptr(), out.data_ptr(),
            N, D, V, _DTYPE_CODES[x.dtype], _stream(x))
    return out


def fused_xent_dx_cuda(x, w, labels, lse, valid, g, *, block_rows, block_v):
    """-> dx [N, D] in x's dtype."""
    del block_rows, block_v
    return _bwd("fused_xent_dx", x, w, labels, lse, valid, g)


def _route(name, x, w, labels, lse, valid) -> str:
    N, D = x.shape
    sv, sd = _w_strides(w, D, w.shape[1])
    code = getattr(_lib(), name)(
        _DTYPE_CODES[x.dtype], D, sv, sd, x.data_ptr(), w.data_ptr(),
        labels.data_ptr(), lse.data_ptr(), valid.data_ptr())
    if code == 1:
        return "wgmma"
    if code == 2:
        return "streamed"
    return "cuda-cores" if x.dtype == torch.float32 else "mma.sync"


def dx_route(x, w, labels, lse, valid) -> str:
    """The kernel `fused_xent_dx_cuda` launches for these operands, as the
    launcher picks it: "wgmma", "mma.sync", "cuda-cores" or "streamed"."""
    return _route("fused_xent_dx_route", x, w, labels, lse, valid)


def dw_route(x, w, labels, lse, valid) -> str:
    """The kernel `fused_xent_dw_cuda` launches for these operands, as the
    launcher picks it: "wgmma", "mma.sync", "cuda-cores" or "streamed"."""
    return _route("fused_xent_dw_route", x, w, labels, lse, valid)


def fused_xent_dw_cuda(x, w, labels, lse, valid, g, *, block_rows, block_v):
    """-> dW [D, V] in w's dtype: the transposed view of the kernel's
    [V, D] output."""
    del block_rows, block_v
    return _bwd("fused_xent_dw", x, w, labels, lse, valid, g).t()


# unit roundoff (half an ulp, relative) of each dtype the kernels take
_UNIT_ROUNDOFF = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8,
                  torch.float16: 2.0 ** -11}


def kernel_tolerances(x, w, labels, valid, g, ref, chunk: int = 4096):
    """Per-element bounds on |kernel - plain| for the four outputs
    `ref = {"lse", "ll", "dx", "dw"}` of the plain versions on these
    inputs (x [N, D], w [D, V], g the upstream gradient).

    lse, ll: the two sum the same exact fp32 products of each logit in
    another order: 1e-5 of the logit's absolute-value sum A = |x|.|w| (of
    the label's logit for ll, the row's largest for lse, which is a convex
    combination of its logits), plus 2^-22 |lse| for exp and log.

    dx, dW: with u the dtype's unit roundoff (0 for fp32) and, for fp16,
    a = 2^-25 (half its subnormal spacing, where small gradients and small
    dl' land; 0 otherwise):
    * each side rounds its output once: 2u |ref| + 2a between them;
    * the kernel rounds dl' = valid (p - onehot), |dl'| <= 1, to the
      dtype before the second product: u M + a S, with M = |g| |dl'|.|B|
      and S = |g| valid.|B| the second product's absolute-value sums
      (B = w^T for dx, x for dW);
    * both sum fp32 products in other orders, and the logits' order moves
      p by a relative 1e-5 of A: 1e-4 M;
    * 1e-7 max |ref| for an output whose terms cancel."""
    u = _UNIT_ROUNDOFF[x.dtype]
    a16 = 2.0 ** -25 if x.dtype == torch.float16 else 0.0
    gs = abs(float(g))
    N, D = x.shape
    V = w.shape[1]
    x32, w32 = x.float(), w.float()
    xa, wa = x32.abs(), w32.abs()
    vf = valid.float()
    lse = ref["lse"]
    a_max = torch.zeros(N, dtype=torch.float32, device=x.device)
    a_lab = torch.zeros(N, dtype=torch.float32, device=x.device)
    m_dx = torch.zeros((N, D), dtype=torch.float32, device=x.device)
    m_dw = torch.empty((D, V), dtype=torch.float32, device=x.device)
    cols = torch.arange(V, device=x.device)
    for v0 in range(0, V, chunk):
        sl = slice(v0, min(V, v0 + chunk))
        a = xa @ wa[:, sl]
        a_max = torch.maximum(a_max, a.amax(dim=1))
        hit = cols[sl][None, :] == labels[:, None]
        a_lab += (a * hit).sum(dim=1)
        p = torch.exp(x32 @ w32[:, sl] - lse[:, None])
        dl = ((p - hit.float()) * vf[:, None]).abs()
        m_dx += dl @ wa[:, sl].t()
        m_dw[:, sl] = xa.t() @ dl
        del a, p, dl
    tols = {"lse": 1e-5 * a_max + 2.0 ** -22 * lse.abs() + 1e-6,
            "ll": 1e-5 * a_lab + 1e-6}
    s_dx = gs * (wa.sum(dim=1)[None, :] * vf[:, None])      # [N, D]
    s_dw = gs * (xa.t() @ vf)[:, None]                       # [D, 1]
    for name, m, s in (("dx", gs * m_dx, s_dx), ("dw", gs * m_dw, s_dw)):
        r = ref[name].float().abs()
        tols[name] = (2 * u * r + (u + 1e-4) * m + a16 * s + 2 * a16 +
                      1e-7 * float(r.max()))
    return tols

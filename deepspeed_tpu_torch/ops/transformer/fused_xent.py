"""Fused LM-head projection + softmax cross-entropy — the port of
deepspeed_tpu/ops/transformer/fused_xent.py.

`fused_softmax_xent_sum(x, w, labels, valid, block_rows, block_v)` is
`_FusedXent`, the counterpart of the JAX custom VJP (:208-231): the
forward saves `(x, w, labels, valid, lse)` and never the [N, V] logits;
the backward forms `coef = g · valid` (:169) and runs the dx and dW
kernels, which re-form the logits tile by tile.  Each of the three goes
through the kernel registry (`kernels/registry.py`): on a CUDA tensor
the Hopper kernel (`kernels/csrc/fused_xent.cu`), on a CPU tensor the
plain version below.

The plain versions repeat the Pallas bodies' arithmetic (`_fwd_kernel`
:52, `_dl_block` :117, `_dx_kernel` :127, `_dw_kernel` :145), streamed
over vocab blocks of `block_v` with all rows at once (every quantity is
per row, so the row blocking of the TPU grid changes no number): logits
`x.float() @ w.float()`, an online logsumexp started at `NEG_INF` with
`l` at 0, the label logit summed through the one-hot, and
`dl = (exp(logit - lse) - onehot) · coef` in fp32.
"""

from __future__ import annotations

import torch

from ...kernels.registry import dispatch

DEFAULT_BLOCK_ROWS = 256
DEFAULT_BLOCK_V = 512
NEG_INF = -1e30


def _logits(x32, w, j, bv):
    return x32 @ w[:, j * bv:(j + 1) * bv].float()


def _onehot(labels, j, bv, device):
    return (j * bv + torch.arange(bv, device=device))[None, :] == \
        labels[:, None]


def _fwd_plain(x, w, labels, *, block_rows, block_v):
    """-> (lse [N] fp32, label logit [N] fp32)."""
    del block_rows
    N = x.shape[0]
    V = w.shape[1]
    bv = block_v
    x32 = x.float()
    m = torch.full((N,), NEG_INF, dtype=torch.float32, device=x.device)
    l = torch.zeros((N,), dtype=torch.float32, device=x.device)
    ll = torch.zeros((N,), dtype=torch.float32, device=x.device)
    for j in range(V // bv):
        logits = _logits(x32, w, j, bv)
        m_new = torch.maximum(m, logits.amax(dim=1))
        l = l * torch.exp(m - m_new) + \
            torch.exp(logits - m_new[:, None]).sum(dim=1)
        m = m_new
        ll = ll + torch.where(_onehot(labels, j, bv, x.device), logits,
                              0.0).sum(dim=1)
    return m + torch.log(l), ll


def _dl_block(x32, w, labels, lse, coef, j, bv):
    logits = _logits(x32, w, j, bv)
    p = torch.exp(logits - lse[:, None])
    onehot = _onehot(labels, j, bv, x32.device).float()
    return (p - onehot) * coef[:, None]


def _coef(valid, g):
    return g.float() * valid.float()


def _dx_plain(x, w, labels, lse, valid, g, *, block_rows, block_v):
    """-> dx [N, D] in x's dtype."""
    del block_rows
    V = w.shape[1]
    bv = block_v
    x32 = x.float()
    coef = _coef(valid, g)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(V // bv):
        dl = _dl_block(x32, w, labels, lse, coef, j, bv)
        acc = acc + dl @ w[:, j * bv:(j + 1) * bv].float().t()
    return acc.to(x.dtype)


def _dw_plain(x, w, labels, lse, valid, g, *, block_rows, block_v):
    """-> dW [D, V] in w's dtype."""
    del block_rows
    V = w.shape[1]
    bv = block_v
    x32 = x.float()
    coef = _coef(valid, g)
    dw = torch.empty(w.shape, dtype=w.dtype, device=w.device)
    for j in range(V // bv):
        dl = _dl_block(x32, w, labels, lse, coef, j, bv)
        dw[:, j * bv:(j + 1) * bv] = (x32.t() @ dl).to(w.dtype)
    return dw


class _FusedXent(torch.autograd.Function):
    """The custom VJP of `fused_softmax_xent_sum`."""

    @staticmethod
    def forward(ctx, x, w, labels, valid, block_rows, block_v):
        opts = dict(block_rows=block_rows, block_v=block_v)
        lse, ll = dispatch("fused_xent_fwd", x, w, labels, **opts)
        ctx.save_for_backward(x, w, labels, valid, lse)
        ctx.opts = opts
        return torch.sum(torch.where(valid, lse - ll, 0.0))

    @staticmethod
    def backward(ctx, g):
        x, w, labels, valid, lse = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = dispatch("fused_xent_dx", x, w, labels, lse, valid, g,
                          **ctx.opts)
        if ctx.needs_input_grad[1]:
            dw = dispatch("fused_xent_dw", x, w, labels, lse, valid, g,
                          **ctx.opts)
        return dx, dw, None, None, None, None


def fused_softmax_xent_sum(x, w, labels, valid,
                           block_rows: int = DEFAULT_BLOCK_ROWS,
                           block_v: int = DEFAULT_BLOCK_V):
    """Sum over valid rows of (logsumexp(x @ w) - (x @ w)[label]).

    x [N, D], w [D, V] (a transposed view of a [V, D] embedding is read
    where it lies), labels [N] int64 in range, valid [N] bool.  Requires
    N % block_rows == 0 and V % block_v == 0.  Not valid when w is
    vocab-sharded (the logsumexp is row-global)."""
    N = x.shape[0]
    V = w.shape[1]
    if N % block_rows or V % block_v:
        raise ValueError(f"fused_softmax_xent_sum: N={N}, V={V} not "
                         f"divisible by blocks ({block_rows}, {block_v})")
    labels = labels.to(torch.int64)
    valid = valid.to(torch.bool)
    return _FusedXent.apply(x, w, labels, valid, int(block_rows),
                            int(block_v))

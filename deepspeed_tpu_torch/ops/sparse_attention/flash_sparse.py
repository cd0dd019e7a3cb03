"""Block-sparse flash attention, forward and backward — the port of
deepspeed_tpu/ops/sparse_attention/flash_sparse.py.

`flash_sparse_attention` (BSHD in and out, `[B·H, S, D]` inside, :368)
runs `_FlashSparseBHSD`, the counterpart of the JAX custom VJP
`_flash_sparse_bhsd` (:345-365): the forward saves `out` and the row
logsumexp, the backward computes `delta = rowsum(dO·O)` (a plain op, as
`_bwd` does at :265) and then the dQ and dK/dV kernels.  Each of the three
goes through the kernel registry (`kernels/registry.py`): on a CUDA tensor
the Hopper kernel (`kernels/csrc/flash_sparse.cu`), on a CPU tensor the
plain version below.

The layout reaches the kernels as `layout_tables` (:45): the forward table
`[H, nq, W]` (each q-block's active k-blocks) and the reverse table
`[H, nk, Wq]` (each k-block's q-blocks), ascending, -1 padded; beside
them `dkv_work_order`, the dK/dV kernel's heaviest-walk-first schedule.  The plain
versions follow the Pallas bodies op for op (`_fwd_kernel` :73,
`_dq_kernel` :171, `_dkv_kernel` :208), vectorised over batch·head and
layout row: one step per table slot gathers every row's block at that
slot, and an empty slot (-1) leaves the row's state as it was.  fp32
`q·scale`, the `NEG_INF` causal select on token coordinates, the online
max and sum over the slots in table order, `p` cast to V's dtype before
P·V, `ds` cast to K's dtype before dS·K, `pd`, `ds` and `q` kept in fp32
in dK/dV, and dropout from the dense kernels' hash at the tile's token
coordinates with `bh = b·H + h` (:105, :197, :233).  A row with no active
block gives out 0 and lse -1e30.  The lse is stored as `[BH, S]` fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...kernels.registry import dispatch
from ..transformer.dropout import keep_mask_at

NEG_INF = -1e30


def layout_tables(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[H, nq, nk] 0/1 -> (fwd [H, nq, W], rev [H, nk, Wq]), -1 padded."""
    layout = np.asarray(layout)
    H, nq, nk = layout.shape
    W = max(1, int(layout.sum(-1).max()))
    Wq = max(1, int(layout.sum(-2).max()))
    fwd = np.full((H, nq, W), -1, np.int32)
    rev = np.full((H, nk, Wq), -1, np.int32)
    for h in range(H):
        for i in range(nq):
            nz = np.nonzero(layout[h, i])[0]
            fwd[h, i, :len(nz)] = nz
        for j in range(nk):
            nz = np.nonzero(layout[h, :, j])[0]
            rev[h, j, :len(nz)] = nz
    return fwd, rev


def dkv_work_order(rev: np.ndarray) -> np.ndarray:
    """The dK/dV kernel's schedule: the (head, k-block) pairs of the
    reverse table `rev` [H, nk, Wq], encoded h * nk + kj, ordered by the
    length of their walk (active q-blocks), heaviest first, ties in (h, kj)
    order -> int32 [H * nk].  The kernel takes every batch row and key
    tile of a pair before the next pair, so the global columns' long walks
    start first."""
    walk = (np.asarray(rev) >= 0).sum(-1).reshape(-1)
    return np.argsort(-walk, kind="stable").astype(np.int32)


def device_tables(layout: np.ndarray, device) -> Tuple[torch.Tensor,
                                                       torch.Tensor,
                                                       torch.Tensor]:
    """`layout_tables` and the reverse table's `dkv_work_order` as int32
    tensors on `device` (one upload each)."""
    fwd, rev = layout_tables(layout)
    return (torch.from_numpy(fwd).to(device), torch.from_numpy(rev).to(device),
            torch.from_numpy(dkv_work_order(rev)).to(device))


def _rows(tbl, BH, n_heads):
    """[H, n, W] table -> [BH, n, W] int64 (program bh reads head
    bh % H)."""
    return tbl.long()[torch.arange(BH, device=tbl.device) % n_heads]


def _positions(blocks, blk):
    """Token coordinates of the blocks `blocks` [...]: [..., blk]."""
    return blocks[..., None] * blk + torch.arange(blk, device=blocks.device)


def _fwd_plain(q, k, v, fwd_tbl, *, causal, scale, block, rate, seed,
               n_heads):
    """-> (out [BH, S, D] in q's dtype, lse [BH, S] fp32)."""
    BH, S, D = q.shape
    blk, nb = block, S // block
    dev = q.device
    tbl = _rows(fwd_tbl, BH, n_heads)
    bh = torch.arange(BH, device=dev)
    bi = bh[:, None]
    qb = (q.float() * scale).view(BH, nb, blk, D)
    kb, vb = k.view(BH, nb, blk, D), v.view(BH, nb, blk, D)
    qpos = _positions(torch.arange(nb, device=dev), blk)[None, :, :, None]
    acc = torch.zeros((BH, nb, blk, D), dtype=torch.float32, device=dev)
    m = torch.full((BH, nb, blk, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    for a in range(tbl.shape[-1]):
        kj = tbl[..., a]
        valid = (kj >= 0)[..., None, None]
        kj = kj.clamp_min(0)
        s = qb @ kb[bi, kj].float().transpose(-1, -2)
        kpos = _positions(kj, blk)[:, :, None, :]
        if causal:
            s = torch.where(qpos >= kpos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l_new = alpha * l + p.sum(dim=-1, keepdim=True)
        if rate > 0.0:
            p = p * keep_mask_at(seed, bh[:, None, None, None], qpos, kpos,
                                 rate)
        acc_new = acc * alpha + p.to(v.dtype).float() @ vb[bi, kj].float()
        acc = torch.where(valid, acc_new, acc)
        m = torch.where(valid, m_new, m)
        l = torch.where(valid, l_new, l)
    safe_l = torch.where(l == 0.0, 1.0, l)
    out = (acc / safe_l).to(q.dtype).view(BH, S, D)
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(safe_l))
    return out, lse.view(BH, S)


def _dq_plain(q, k, v, dout, lse, delta, fwd_tbl, *, causal, scale, block,
              rate, seed, n_heads):
    """-> dq [BH, S, D] in q's dtype."""
    BH, S, D = q.shape
    blk, nb = block, S // block
    dev = q.device
    tbl = _rows(fwd_tbl, BH, n_heads)
    bh = torch.arange(BH, device=dev)
    bi = bh[:, None]
    qb = (q.float() * scale).view(BH, nb, blk, D)
    kb, vb = k.view(BH, nb, blk, D), v.view(BH, nb, blk, D)
    do = dout.float().view(BH, nb, blk, D)
    lse_b = lse.view(BH, nb, blk, 1)
    delta_b = delta.view(BH, nb, blk, 1)
    qpos = _positions(torch.arange(nb, device=dev), blk)[None, :, :, None]
    acc = torch.zeros((BH, nb, blk, D), dtype=torch.float32, device=dev)
    for a in range(tbl.shape[-1]):
        kj = tbl[..., a]
        valid = (kj >= 0)[..., None, None]
        kj = kj.clamp_min(0)
        k_blk = kb[bi, kj]
        s = qb @ k_blk.float().transpose(-1, -2)
        kpos = _positions(kj, blk)[:, :, None, :]
        if causal:
            s = torch.where(qpos >= kpos, s, NEG_INF)
        p = torch.exp(s - lse_b)
        dp = do @ vb[bi, kj].float().transpose(-1, -2)
        if rate > 0.0:
            dp = dp * keep_mask_at(seed, bh[:, None, None, None], qpos, kpos,
                                   rate)
        ds = p * (dp - delta_b)
        upd = scale * (ds.to(k.dtype).float() @ k_blk.float())
        acc = torch.where(valid, acc + upd, acc)
    return acc.to(q.dtype).view(BH, S, D)


def _dkv_plain(q, k, v, dout, lse, delta, rev_tbl, *, order, causal, scale,
               block, rate, seed, n_heads):
    """-> (dk, dv) [BH, S, D] in k's and v's dtype.  `order` (the kernel's
    schedule, `dkv_work_order`) does not change the function."""
    del order
    BH, S, D = q.shape
    blk, nb = block, S // block
    dev = q.device
    tbl = _rows(rev_tbl, BH, n_heads)
    bh = torch.arange(BH, device=dev)
    bi = bh[:, None]
    qf = q.float().view(BH, nb, blk, D)
    kf = k.float().view(BH, nb, blk, D)
    vf = v.float().view(BH, nb, blk, D)
    dof = dout.float().view(BH, nb, blk, D)
    lse_b = lse.view(BH, nb, blk)
    delta_b = delta.view(BH, nb, blk)
    kpos = _positions(torch.arange(nb, device=dev), blk)[None, :, None, :]
    dk_acc = torch.zeros((BH, nb, blk, D), dtype=torch.float32, device=dev)
    dv_acc = torch.zeros_like(dk_acc)
    for a in range(tbl.shape[-1]):
        qi = tbl[..., a]
        valid = (qi >= 0)[..., None, None]
        qi = qi.clamp_min(0)
        q_blk = qf[bi, qi]
        s = (q_blk * scale) @ kf.transpose(-1, -2)
        qpos = _positions(qi, blk)[..., None]
        if causal:
            s = torch.where(qpos >= kpos, s, NEG_INF)
        p = torch.exp(s - lse_b[bi, qi][..., None])
        do = dof[bi, qi]
        mask = None
        pd = p
        if rate > 0.0:
            mask = keep_mask_at(seed, bh[:, None, None, None], qpos, kpos,
                                rate)
            pd = p * mask
        dv_upd = pd.transpose(-1, -2) @ do
        dp = do @ vf.transpose(-1, -2)
        if mask is not None:
            dp = dp * mask
        ds = p * (dp - delta_b[bi, qi][..., None])
        dk_upd = scale * (ds.transpose(-1, -2) @ q_blk)
        dv_acc = torch.where(valid, dv_acc + dv_upd, dv_acc)
        dk_acc = torch.where(valid, dk_acc + dk_upd, dk_acc)
    return (dk_acc.to(k.dtype).view(BH, S, D),
            dv_acc.to(v.dtype).view(BH, S, D))


class _FlashSparseBHSD(torch.autograd.Function):
    """The custom VJP of `_flash_sparse_bhsd` over [BH, S, D] tensors."""

    @staticmethod
    def forward(ctx, q, k, v, fwd_tbl, rev_tbl, order, opts):
        out, lse = dispatch("flash_sparse_fwd", q, k, v, fwd_tbl, **opts)
        ctx.save_for_backward(q, k, v, out, lse, fwd_tbl, rev_tbl, order)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, fwd_tbl, rev_tbl, order = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1)
        dq = dispatch("flash_sparse_dq", q, k, v, dout, lse, delta, fwd_tbl,
                      **ctx.opts)
        dk, dv = dispatch("flash_sparse_dkv", q, k, v, dout, lse, delta,
                          rev_tbl, order=order, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_sparse_attention(q, k, v, layout: np.ndarray, block: int,
                           causal: bool = False,
                           scale: Optional[float] = None,
                           dropout_rate: float = 0.0,
                           dropout_seed: Optional[int] = None,
                           tables: Optional[Tuple[torch.Tensor,
                                                  torch.Tensor,
                                                  torch.Tensor]] = None):
    """Block-sparse flash attention over [B, S, H, D] (BSHD), :368.

    layout: numpy [H, S/block, S/block] 0/1; `causal=True` additionally
    token-masks inside the active blocks.  dropout_rate > 0 with a
    `dropout_seed` (an int32, `dropout.derive_seed`) applies probability
    dropout inside the kernels, the dense kernels' hash mask over
    (seed, b·H + h, q, k).  `tables`: the layout's `device_tables` on q's
    device, when the caller keeps them (`SparseSelfAttention` does); else
    they are built and uploaded here."""
    B, S, Hh, D = q.shape
    if S % block:
        raise ValueError(f"seq len {S} not divisible by the layout block "
                         f"{block}")
    nb = S // block
    layout = np.asarray(layout)
    if layout.shape != (Hh, nb, nb):
        raise ValueError(f"layout shape {layout.shape}, want {(Hh, nb, nb)}")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got "
                         f"{dropout_rate}")
    if tables is None:
        tables = device_tables(layout, q.device)
    scale = (D ** -0.5) if scale is None else scale
    rate = float(dropout_rate) if dropout_seed is not None else 0.0
    seed = int(dropout_seed) if rate > 0.0 else 0

    def to_bhsd(t):
        return t.permute(0, 2, 1, 3).reshape(B * Hh, S, D).contiguous()

    opts = dict(causal=bool(causal), scale=float(scale), block=int(block),
                rate=rate, seed=seed, n_heads=Hh)
    out = _FlashSparseBHSD.apply(to_bhsd(q), to_bhsd(k), to_bhsd(v),
                                 *tables, opts)
    return out.reshape(B, Hh, S, D).permute(0, 2, 1, 3)

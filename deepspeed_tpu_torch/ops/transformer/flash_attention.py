"""Flash attention, forward and backward — the port of
deepspeed_tpu/ops/transformer/flash_attention.py.

`flash_attention` (BSHD in and out, `[B·H, S, D]` inside) runs
`_FlashBHSD`, the counterpart of the JAX custom VJP `_flash_bhsd`
(:423-440): the forward saves `out` and the row logsumexp, the backward
computes `delta = rowsum(dO·O)` (a plain op, as in JAX :350) and then the
dQ and dK/dV kernels.  Each of the three goes through the kernel registry
(`kernels/registry.py`): on a CUDA tensor the Hopper kernel
(`kernels/csrc/flash_attention.cu`), on a CPU tensor the plain version
below.

The plain versions follow the Pallas bodies op for op, block by block
(`_fwd_kernel` :113, `_dq_kernel` :227, `_dkv_kernel` :280), vectorised
over batch·head: fp32 `q·scale`, the `NEG_INF` causal select, the per-key
bias and its fully-masked guard, the online max and sum, `p` cast to V's
dtype before P·V, `ds` cast to K's dtype before dS·K, `pd`, `ds` and `q`
kept in fp32 in dK/dV, and dropout with `bh + bh_offset` as the hash's
batch·head.  The lse is stored as `[BH, S]` fp32 (the TPU layout's
128-lane broadcast is tiling and is not carried over).
"""

from __future__ import annotations

from typing import Optional

import torch

from ...kernels.registry import dispatch
from .dropout import _keep_mask

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
NEG_INF = -1e30  # large-negative instead of -inf: keeps masked rows NaN-free


def _scores(q_blk, k_blk, qi, ki, bq, bk, causal, scale, kb):
    """(q·scale)·kᵀ in fp32 with the causal select and the key bias."""
    q = q_blk.float() * scale
    s = q @ k_blk.float().transpose(-1, -2)
    if causal:
        qidx = qi * bq + torch.arange(bq, device=s.device)[:, None]
        kidx = ki * bk + torch.arange(bk, device=s.device)[None, :]
        s = torch.where(qidx >= kidx, s, NEG_INF)
    if kb is not None:
        s = s + kb[:, None, ki * bk:(ki + 1) * bk]
    return s


def _bias_rows(kb, BH, n_heads):
    """[B, Sk] per-key bias -> [BH, Sk] (program bh reads batch bh // H)."""
    if kb is None:
        return None
    return kb[torch.arange(BH, device=kb.device) // n_heads]


def _bh(BH, bh_offset, device):
    return torch.arange(BH, device=device) + int(bh_offset)


def _fwd_plain(q, k, v, kb, *, causal, scale, block_q, block_k, rate, seed,
               bh_offset, n_heads):
    """-> (out [BH, S, D] in q's dtype, lse [BH, S] fp32)."""
    BH, S, D = q.shape
    Sk = k.shape[1]
    bq, bk = block_q, block_k
    nq, nk = S // bq, Sk // bk
    kbr = _bias_rows(kb, BH, n_heads)
    bh = _bh(BH, bh_offset, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    for qi in range(nq):
        rows = slice(qi * bq, (qi + 1) * bq)
        acc = torch.zeros((BH, bq, D), dtype=torch.float32, device=q.device)
        m = torch.full((BH, bq, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        for ki in range(nk):
            if causal and not ki * bk <= qi * bq + bq - 1:
                break
            cols = slice(ki * bk, (ki + 1) * bk)
            s = _scores(q[:, rows], k[:, cols], qi, ki, bq, bk, causal,
                        scale, kbr)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            if kb is not None:
                p = torch.where(s <= NEG_INF * 0.5, 0.0, p)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            if rate > 0.0:
                p = p * _keep_mask(seed, bh, qi * bq, ki * bk, bq, bk, rate,
                                   q.device)
            acc = acc * alpha + p.to(v.dtype).float() @ v[:, cols].float()
            m = m_new
        safe_l = torch.where(l == 0.0, 1.0, l)
        out[:, rows] = (acc / safe_l).to(q.dtype)
        lse[:, rows] = (m + torch.log(safe_l))[..., 0]
    return out, lse


def _dq_plain(q, k, v, dout, lse, delta, kb, *, causal, scale, block_q,
              block_k, rate, seed, bh_offset, n_heads):
    """-> dq [BH, S, D] in q's dtype."""
    BH, S, D = q.shape
    Sk = k.shape[1]
    bq, bk = block_q, block_k
    nq, nk = S // bq, Sk // bk
    kbr = _bias_rows(kb, BH, n_heads)
    bh = _bh(BH, bh_offset, q.device)
    dq = torch.empty_like(q)
    for qi in range(nq):
        rows = slice(qi * bq, (qi + 1) * bq)
        acc = torch.zeros((BH, bq, D), dtype=torch.float32, device=q.device)
        do = dout[:, rows].float()
        for ki in range(nk):
            if causal and not ki * bk <= qi * bq + bq - 1:
                break
            cols = slice(ki * bk, (ki + 1) * bk)
            s = _scores(q[:, rows], k[:, cols], qi, ki, bq, bk, causal,
                        scale, kbr)
            p = torch.exp(s - lse[:, rows, None])
            if kb is not None:
                p = torch.where(s <= NEG_INF * 0.5, 0.0, p)
            dp = do @ v[:, cols].float().transpose(-1, -2)
            if rate > 0.0:
                dp = dp * _keep_mask(seed, bh, qi * bq, ki * bk, bq, bk,
                                     rate, q.device)
            ds = p * (dp - delta[:, rows, None])
            acc = acc + scale * (ds.to(k.dtype).float() @ k[:, cols].float())
        dq[:, rows] = acc.to(q.dtype)
    return dq


def _dkv_plain(q, k, v, dout, lse, delta, kb, *, causal, scale, block_q,
               block_k, rate, seed, bh_offset, n_heads):
    """-> (dk, dv) [BH, Sk, D] in k's and v's dtype."""
    BH, S, D = q.shape
    Sk = k.shape[1]
    bq, bk = block_q, block_k
    nq, nk = S // bq, Sk // bk
    kbr = _bias_rows(kb, BH, n_heads)
    bh = _bh(BH, bh_offset, q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for ki in range(nk):
        cols = slice(ki * bk, (ki + 1) * bk)
        dk_acc = torch.zeros((BH, bk, D), dtype=torch.float32,
                             device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for qi in range(nq):
            if causal and not qi * bq + bq - 1 >= ki * bk:
                continue
            rows = slice(qi * bq, (qi + 1) * bq)
            s = _scores(q[:, rows], k[:, cols], qi, ki, bq, bk, causal,
                        scale, kbr)
            p = torch.exp(s - lse[:, rows, None])
            if kb is not None:
                p = torch.where(s <= NEG_INF * 0.5, 0.0, p)
            do = dout[:, rows].float()
            if rate > 0.0:
                mask = _keep_mask(seed, bh, qi * bq, ki * bk, bq, bk, rate,
                                  q.device)
                pd = p * mask
            else:
                mask = None
                pd = p
            dv_acc = dv_acc + pd.transpose(-1, -2) @ do
            dp = do @ v[:, cols].float().transpose(-1, -2)
            if mask is not None:
                dp = dp * mask
            ds = p * (dp - delta[:, rows, None])
            dk_acc = dk_acc + scale * (ds.transpose(-1, -2) @
                                       q[:, rows].float())
        dk[:, cols] = dk_acc.to(k.dtype)
        dv[:, cols] = dv_acc.to(v.dtype)
    return dk, dv


class _FlashBHSD(torch.autograd.Function):
    """The custom VJP of `_flash_bhsd` over [BH, S, D] tensors."""

    @staticmethod
    def forward(ctx, q, k, v, kb, opts):
        out, lse = dispatch("flash_attention_fwd", q, k, v, kb, **opts)
        ctx.save_for_backward(q, k, v, kb, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kb, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1)
        dq = dispatch("flash_attention_dq", q, k, v, dout, lse, delta, kb,
                      **ctx.opts)
        dk, dv = dispatch("flash_attention_dkv", q, k, v, dout, lse, delta,
                          kb, **ctx.opts)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None,
                    key_bias=None,
                    bh_offset: int = 0):
    """Flash attention over [B, S, H, D] inputs (BSHD), causal or full
    (flash_attention.py:443).

    Requires S % block_q == 0 and S_k % block_k == 0.  dropout_rate > 0
    with a `dropout_seed` (an int32 from `dropout.derive_seed`) applies
    probability dropout inside the kernels, the mask hashed per element
    from (seed, bh + bh_offset, q, k).  key_bias is a per-key additive
    bias, [B, Sk] or [B, 1, 1, Sk] fp32; rows whose keys are all masked
    give zero output.  The key bias gets no gradient.
    """
    B, S, H, D = q.shape
    Sk = k.shape[1]
    if S % block_q or Sk % block_k:
        raise ValueError(f"seq lens ({S},{Sk}) not divisible by blocks "
                         f"({block_q},{block_k})")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got "
                         f"{dropout_rate}")
    scale = (D ** -0.5) if scale is None else scale
    rate = float(dropout_rate) if dropout_seed is not None else 0.0
    seed = int(dropout_seed) if rate > 0.0 else 0
    kb = None
    if key_bias is not None:
        kb = torch.as_tensor(key_bias, dtype=torch.float32,
                             device=q.device).detach().reshape(-1, Sk)
        # clamp so s + bias stays finite (finfo.min would NaN the exp)
        kb = torch.clamp_min(kb.expand(B, Sk), NEG_INF).contiguous()

    def to_bhsd(t):
        return t.permute(0, 2, 1, 3).reshape(B * H, t.shape[1],
                                             D).contiguous()

    opts = dict(causal=bool(causal), scale=float(scale), block_q=block_q,
                block_k=block_k, rate=rate, seed=seed,
                bh_offset=int(bh_offset), n_heads=H)
    out = _FlashBHSD.apply(to_bhsd(q), to_bhsd(k), to_bhsd(v), kb, opts)
    return out.reshape(B, H, S, D).permute(0, 2, 1, 3)

"""Multi-head attention dispatch — the port of
deepspeed_tpu/ops/transformer/attention.py.

`multihead_attention` (:98) takes the flash kernels
(`flash_attention.py`, hand-written Hopper kernels on a CUDA tensor) for
tileable shapes on the card, and `xla_attention` (:68), the dense path,
elsewhere: on the CPU, for short or untileable sequences and for a full
`[.., S, Sk]` bias.  The JAX package's `_on_tpu()` test becomes "q is on
a CUDA device"; the shape conditions, the explicit-block warning and the
`bh_offset` + dropout error are JAX's.  A caller whose batch is a
data-parallel rank's rows of a global batch passes `global_rows=True`:
the dense path then keys its dropout masks to those rows as the flash
kernels do with `bh_offset`, instead of raising.  `impl` keeps the JAX names
("auto", "pallas" for the flash path, "xla" for the dense one) so the
same model configs select the same paths.

Shapes follow [batch, seq, heads, head_dim] (BSHD).  Dropout takes an
int32 seed (`dropout.derive_seed`) where JAX takes a PRNG key.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...utils.logging import logger
from .dropout import hash_dropout
from .flash_attention import DEFAULT_BLOCK_K, DEFAULT_BLOCK_Q, flash_attention

_FLASH_MIN_SEQ = 256  # below this the [S,S] buffer fits easily


def xla_attention(q, k, v, causal=True, bias=None, dropout_rate=0.0,
                  dropout_seed: Optional[int] = None, train=False,
                  scale=None, bh_offset: int = 0):
    """The dense path, [B,S,H,D] -> [B,S,H,D] (attention.py:68): fp32
    scores and softmax whatever the input dtype, a `finfo.min` causal
    mask offset for cached decoding, hash dropout over the
    probabilities.  `bh_offset` (a data-parallel rank's first batch·head
    row) makes the probabilities' mask that of those rows of the global
    [B·H, S, Sk] tensor."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    scale = (D ** -0.5) if scale is None else scale
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    if causal:
        qi = torch.arange(S, device=q.device)[:, None] + (Sk - S)
        ki = torch.arange(Sk, device=q.device)[None, :]
        scores = torch.where(qi >= ki, scores,
                             torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    if train and dropout_rate > 0.0 and dropout_seed is not None:
        probs = hash_dropout(probs, dropout_rate, dropout_seed,
                             offset=int(bh_offset) * S * Sk)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def _use_flash(impl: str, *, on_card: bool, S: int, Sk: int, D: int,
               bias_ok: bool) -> bool:
    """The flash path for impl "pallas" (unless a full bias forbids it),
    and for "auto" on the card at tileable shapes (attention.py:123-132)."""
    if impl == "pallas":
        # the flash kernels carry per-key biases only; honouring a full
        # bias wins over the impl request
        return bias_ok
    if impl == "auto":
        return (on_card and bias_ok and S >= _FLASH_MIN_SEQ
                and S % 128 == 0 and Sk % 128 == 0 and D in (64, 128, 256))
    return False


def multihead_attention(q, k, v, causal: bool = True, impl: str = "auto",
                        bias=None, dropout_rate: float = 0.0,
                        dropout_seed: Optional[int] = None,
                        train: bool = False,
                        scale: Optional[float] = None,
                        block_q: Optional[int] = None,
                        block_k: Optional[int] = None,
                        bh_offset: int = 0, global_rows: bool = False):
    """Dispatching attention entry point used by the GPT family.

    impl: "auto" (flash on the card when tileable), "pallas" (flash),
    "xla" (dense).  The flash path applies probability dropout in-kernel
    and accepts per-key biases ([B, 1, 1, Sk], not themselves needing a
    gradient); a full [.., S, Sk] bias routes to the dense path.
    `global_rows`: q's rows are rows bh_offset / H on of a global batch,
    and the dense path's dropout follows them (else it refuses a
    bh_offset, as JAX's does)."""
    B, S, D = q.shape[0], q.shape[1], q.shape[3]
    Sk = k.shape[1]
    want_dropout = train and dropout_rate > 0.0 and dropout_seed is not None
    key_bias = None
    if bias is not None and bias.dim() == 4 and bias.shape[1] == 1 \
            and bias.shape[2] == 1 and bias.shape[3] == Sk \
            and bias.shape[0] in (1, B) and not bias.requires_grad:
        key_bias = bias
    if _use_flash(impl, on_card=q.is_cuda, S=S, Sk=Sk, D=D,
                  bias_ok=bias is None or key_bias is not None):
        bq = block_q or DEFAULT_BLOCK_Q
        bk = block_k or DEFAULT_BLOCK_K
        if S % bq == 0 and Sk % bk == 0:
            return flash_attention(
                q, k, v, causal=causal, scale=scale, block_q=bq, block_k=bk,
                dropout_rate=dropout_rate if want_dropout else 0.0,
                dropout_seed=dropout_seed if want_dropout else None,
                key_bias=key_bias, bh_offset=bh_offset)
        if block_q or block_k:
            # an explicit tuning request that cannot tile: say so instead
            # of silently paying the O(S^2) dense path
            logger.warning(
                f"flash blocks ({bq},{bk}) do not divide seq lens "
                f"({S},{Sk}); falling back to dense attention")
    if want_dropout and int(bh_offset) != 0 and not global_rows:
        # the dense path's dropout has no shard-offset notion — silently
        # dropping it would re-correlate the shard masks the caller is
        # explicitly decorrelating
        raise ValueError(
            "bh_offset is only honored by the flash kernels; this call "
            "dispatched to dense attention (a CPU tensor, untileable "
            "shapes, a full bias, or a bias that needs a gradient) with "
            "dropout active — use impl='pallas' with tileable shapes, or "
            "drop bh_offset")
    return xla_attention(q, k, v, causal=causal, bias=bias,
                         dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                         train=train, scale=scale, bh_offset=bh_offset)

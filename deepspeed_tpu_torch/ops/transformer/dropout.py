"""Counter-hash dropout — the port of deepspeed_tpu/ops/transformer/dropout.py
and of the hash it shares with the flash kernels (flash_attention.py:51-93).

The mask of element i (or of tile element (bh, q, k) in attention) is a
murmur3-finalizer hash of the element's counter and an int32 seed, in
uint32 arithmetic.  PyTorch has no full uint32 arithmetic on every
backend, so the hash runs on int64 tensors and every product is reduced
mod 2^32 with `_mul32`, which splits the left factor in 16-bit halves so
no intermediate exceeds 2^49: the bits are JAX's, for every input.

The seed is an explicit input.  JAX draws it with threefry from a PRNG
key (`derive_seed`), which PyTorch cannot reproduce; the port draws it
from a `torch.Generator` (`derive_seed` below), and the parity tests hand
both sides the same int.  The CUDA kernels compute the same hash
(`kernels/csrc/flash_tiles.cuh`, `keep_scale`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_M32 = 0xFFFFFFFF
SEED_MUL = 0x9E3779B1
BH_MUL = 0x7FEB352D
Q_MUL = 0x85EBCA6B
K_MUL = 0xC2B2AE35


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 `a` in [0, 2^32) and a uint32 constant."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & _M32) << 16
    return (lo + hi) & _M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """THE murmur3-style finalizer (flash_attention.py:51), on int64
    tensors holding uint32 values."""
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = _mul32(h, 0x297A2D39)
    h = h ^ (h >> 15)
    return h


def keep_threshold(rate: float) -> int:
    """uint32 threshold: keep iff hash < keep·2^32 (flash_attention.py:65)."""
    return min(0xFFFFFFFF, int((1.0 - rate) * 4294967296.0))


def _u32(x) -> torch.Tensor:
    """An int (or int tensor) as its uint32 value, in int64."""
    return torch.as_tensor(x, dtype=torch.int64) & _M32


def _keep_mask(seed: int, bh, q0: int, k0: int, bq: int, bk: int,
               rate: float, device=None) -> torch.Tensor:
    """fp32 {0, 1/keep} matrix for the (bq, bk) tile at rows q0+, cols
    k0+ (flash_attention.py:70).  `bh` is an int or an int tensor of any
    shape; the result has bh's shape + (bq, bk)."""
    bh = torch.as_tensor(bh, dtype=torch.int64, device=device)
    qi = (q0 + torch.arange(bq, device=device))[:, None]
    ki = (k0 + torch.arange(bk, device=device))[None, :]
    return keep_mask_at(seed, bh[..., None, None], qi, ki, rate)


def keep_mask_at(seed: int, bh: torch.Tensor, q: torch.Tensor,
                 k: torch.Tensor, rate: float) -> torch.Tensor:
    """The fp32 {0, 1/keep} mask of `_keep_mask` at arbitrary coordinates:
    `bh`, `q`, `k` are int tensors of global batch·head, query and key
    indices that broadcast together (the sparse kernels' tiles sit where
    the layout table puts them)."""
    h = fmix32(_mul32(_u32(seed).to(q.device), SEED_MUL)
               ^ _mul32(_u32(bh), BH_MUL) ^ _mul32(_u32(q), Q_MUL)
               ^ _mul32(_u32(k), K_MUL))
    return (h < keep_threshold(rate)).to(torch.float32) * \
        (1.0 / (1.0 - rate))


def derive_seed(dropout_rate: float,
                generator: Optional[torch.Generator]) -> Tuple[int, float]:
    """(int32 seed, rate) for the dropout hash — the counterpart of
    flash_attention.py:85.  The seed is drawn in [0, 2^31 - 1) from
    `generator`; no generator or a zero rate turns dropout off."""
    if dropout_rate > 0.0 and generator is not None:
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=generator.device)
        return int(seed), float(dropout_rate)
    return 0, 0.0


def hash_dropout(x: torch.Tensor, rate: float, seed: Optional[int],
                 train: bool = True) -> torch.Tensor:
    """Inverted dropout on x: zero with probability `rate`, survivors
    scaled by 1/keep.  No-op when not training, at rate 0, or without a
    seed (dropout.py:25, with the seed in place of the PRNG key)."""
    if not train or rate <= 0.0 or seed is None:
        return x
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if x.numel() >= 1 << 32:
        # JAX draws a threefry mask here; the uint32 counter would wrap
        raise ValueError(
            f"hash_dropout: {x.numel()} elements exceed the uint32 element "
            f"counter")
    keep = 1.0 - rate
    idx = torch.arange(x.numel(), dtype=torch.int64, device=x.device)
    h = fmix32(_mul32(_u32(seed).to(x.device), SEED_MUL)
               ^ _mul32(idx, Q_MUL))
    mask = (h < keep_threshold(rate)).reshape(x.shape)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device)
                       ).to(x.dtype)

"""Block-sparse attention for SparsityConfig layouts — the port of
deepspeed_tpu/ops/sparse_attention/sparse_attention.py.

Two functions compute attention under a layout:

* `block_sparse_attention` (:46), the static-gather path: each (head,
  q-block) row gathers its active key blocks and runs dense
  [blk x W·blk] attention, in plain PyTorch.  The JAX package runs it on
  its accelerator outside any Pallas kernel (the "XLA path"); it takes
  key-padding biases, attention biases / relative position embeddings
  and the causal token mask, and its dropout hashes the flat index of the
  gathered [B, H, nb, blk, W, blk] probabilities, as JAX's does.
* `flash_sparse_attention` (flash_sparse.py), the kernel walk: kernels
  #7-#9 on the card, their plain versions on the CPU.  Bias-free only;
  its dropout hashes token coordinates, so with dropout on the two are
  different functions (both JAX's).

`SparseSelfAttention` (:126) selects between them as JAX's registry does
(kernels/registry.py:150-193, `SparseAttentionOp`): `impl="auto"` takes
the kernel walk only for a bias-free call on a CUDA tensor with a layout
block that is a multiple of 128 and head_dim 64, 128 or 256 (the kernels
take every one of those); `impl="pallas"` takes it for
every bias-free call; biased calls and `impl="xla"` take the gather path.
`kernels.registry.kernel_config(ops={"sparse_attention": ...})` overrides
an "auto" module for its scope.  A call on the gather path bumps
`kernel.fallbacks`; the kernel walk's three ops count themselves in the
registry (`kernel.dispatches` on the card).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...kernels import registry
from ...monitor.counters import COUNTERS
from ..transformer.dropout import hash_dropout
from .flash_sparse import device_tables, flash_sparse_attention
from .sparsity_config import SparsityConfig

NEG_INF = -1e30
AUTO_HEAD_DIMS = (64, 128, 256)


def layout_to_gather(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[H, nb, nb] 0/1 layout -> (idx [H, nb, W], valid [H, nb, W]).

    W = max nonzeros per row; rows pad with index 0 + valid=False."""
    layout = np.asarray(layout)
    H, nb, _ = layout.shape
    counts = layout.sum(-1)
    W = max(1, int(counts.max()))
    idx = np.zeros((H, nb, W), np.int32)
    valid = np.zeros((H, nb, W), bool)
    for h in range(H):
        for i in range(nb):
            nz = np.nonzero(layout[h, i])[0]
            idx[h, i, :len(nz)] = nz
            valid[h, i, :len(nz)] = True
    return idx, valid


def block_sparse_attention(q, k, v, layout, block: int,
                           causal_token_mask: bool = False,
                           scale=None, key_padding_bias=None,
                           attn_bias=None, dropout_rate: float = 0.0,
                           dropout_seed: Optional[int] = None):
    """Sparse attention over [B, S, H, D] inputs (:46).

    layout: [H, nb, nb] numpy array (from SparsityConfig).
    causal_token_mask: additionally mask within-block future tokens.
    key_padding_bias: [B, S] additive fp32 bias on key positions.
    attn_bias: [S, S] or [Hb, S, S] additive bias, gathered along the key
    axis with the same indices as K/V.  dropout_rate > 0 with a
    `dropout_seed` applies `hash_dropout` to the gathered probabilities."""
    B, S, H, D = q.shape
    nb = S // block
    if S % block:
        raise ValueError(f"seq len {S} not divisible by block {block}")
    layout = np.asarray(layout)
    if layout.shape != (H, nb, nb):
        raise ValueError(f"layout shape {layout.shape}, want {(H, nb, nb)}")
    scale = (D ** -0.5) if scale is None else scale
    dev = q.device

    idx_np, valid_np = layout_to_gather(layout)
    W = idx_np.shape[-1]
    idx = torch.from_numpy(idx_np).long().to(dev)
    valid = torch.from_numpy(valid_np).to(dev)

    def to_blocks(t):   # [B, H, nb, blk, D]
        return t.permute(0, 2, 1, 3).reshape(B, H, nb, block, D)

    qb, kb, vb = to_blocks(q), to_blocks(k), to_blocks(v)
    h_ix = torch.arange(H, device=dev)[:, None, None]
    kg = kb[:, h_ix, idx]  # [B, H, nb, W, blk, D]
    vg = vb[:, h_ix, idx]

    scores = torch.einsum("bhiqd,bhiwkd->bhiqwk", qb.float(),
                          kg.float()) * scale

    if key_padding_bias is not None:
        kpb = torch.as_tensor(key_padding_bias, dtype=torch.float32,
                              device=dev).reshape(B, nb, block)[:, idx]
        scores = scores + kpb[:, :, :, None, :, :]   # [B, H, nb, W, blk]
    if attn_bias is not None:
        ab = torch.as_tensor(attn_bias, dtype=torch.float32, device=dev)
        if ab.dim() == 2:
            ab = ab[None]
        # [Hb, nb, blk_q, nb, blk_k] -> gather key blocks per (h, i, w)
        abb = ab.reshape(ab.shape[0], nb, block, nb, block)
        abb = abb[torch.arange(H, device=dev) % ab.shape[0]]
        gathered = torch.gather(
            abb, 3, idx[:, :, None, :, None].expand(H, nb, block, W, block))
        scores = scores + gathered[None]             # [H, nb, blk_q, W, blk_k]

    mask = valid[None, :, :, None, :, None]          # block-level validity
    if causal_token_mask:
        ar = torch.arange(block, device=dev)
        qpos = torch.arange(nb, device=dev)[:, None] * block + ar
        kpos = idx[..., None] * block + ar            # [H, nb, W, blk]
        tok = qpos[None, :, :, None, None] >= kpos[:, :, None, :, :]
        mask = torch.logical_and(mask, tok[None])
    scores = torch.where(mask, scores, NEG_INF)

    flat = scores.reshape(B, H, nb, block, W * block)
    probs = torch.softmax(flat, dim=-1).reshape(scores.shape)
    probs = torch.where(mask, probs, 0.0)  # fully-masked rows -> zero output
    if dropout_rate > 0.0 and dropout_seed is not None:
        probs = hash_dropout(probs, dropout_rate, dropout_seed)

    out = torch.einsum("bhiqwk,bhiwkd->bhiqd", probs, vg.float())
    return out.reshape(B, H, S, D).permute(0, 2, 1, 3).to(q.dtype)


def auto_supports(plain: bool, block: int, head_dim: int) -> Tuple[bool, str]:
    """The JAX `SparseAttentionOp.auto_supports` rule (registry.py:158-171),
    verbatim: the kernel only for bias-free calls with 128-multiple layout
    blocks and head_dim 64, 128 or 256."""
    if not plain:
        return False, "biases route to the gather path"
    if block % 128 != 0:
        return False, f"layout block {block} not a multiple of 128"
    if head_dim not in AUTO_HEAD_DIMS:
        return False, f"head_dim {head_dim} not in {AUTO_HEAD_DIMS}"
    return True, ""


class SparseSelfAttention:
    """Module-level wrapper (reference sparse_self_attention.py:14).

    Computes softmax(QK^T)V under a SparsityConfig layout; inputs BSHD.
    The layout is drawn once per seq_len, on the first call at that
    length, and kept with its kernel tables on each device it is used on
    (uploaded once), so a random layout (BigBird, Variable) stays fixed
    from step to step, as a JAX program traced once keeps it."""

    def __init__(self, sparsity_config: SparsityConfig = None,
                 key_padding_mask_mode: str = "add",
                 attn_mask_mode: str = "mul", impl: str = "auto"):
        self.sparsity_config = sparsity_config or SparsityConfig(num_heads=4)
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        impl = {"jnp": "xla"}.get(impl, impl)
        if impl not in registry.OP_IMPLS:
            raise ValueError(f"impl must be one of {registry.OP_IMPLS} (or "
                             f"'jnp'), got {impl!r}")
        self.impl = impl  # auto|pallas|xla
        self._layouts: Dict[int, np.ndarray] = {}
        self._tables: Dict[Tuple[int, str], Tuple[torch.Tensor, ...]] = {}

    def get_layout(self, seq_len: int) -> np.ndarray:
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.sparsity_config.make_layout(seq_len)
        return self._layouts[seq_len]

    def get_tables(self, seq_len: int, device) -> Tuple[torch.Tensor, ...]:
        """The layout's forward and reverse kernel tables and the dK/dV
        kernel's work order on `device`."""
        key = (seq_len, str(torch.device(device)))
        if key not in self._tables:
            self._tables[key] = device_tables(self.get_layout(seq_len),
                                              device)
        return self._tables[key]

    def _impl(self) -> str:
        if self.impl != "auto":
            return self.impl
        return registry.op_impl("sparse_attention")

    def __call__(self, query, key, value, rpe=None, key_padding_mask=None,
                 attn_mask=None, dropout_rate: float = 0.0,
                 dropout_seed: Optional[int] = None):
        """reference sparse_self_attention.py forward(query, key, value,
        rpe, key_padding_mask, attn_mask).  Masks follow the configured
        modes: "add" = already-additive float bias, "mul" = 0/1 keep mask
        converted to additive large-negative.  Dropout takes an int32 seed
        where JAX takes a PRNG key."""
        B, S, H, D = query.shape
        layout = self.get_layout(S)
        block = self.sparsity_config.block
        causal = getattr(self.sparsity_config, "attention",
                         "bidirectional") == "unidirectional"

        def to_additive(m, mode):
            m = torch.as_tensor(m, device=query.device)
            if mode == "mul" or m.dtype == torch.bool:
                return (1.0 - m.float()) * NEG_INF
            return m.float()

        key_padding_bias = None
        if key_padding_mask is not None:
            key_padding_bias = to_additive(key_padding_mask,
                                           self.key_padding_mask_mode)
        attn_bias = None
        if attn_mask is not None:
            attn_bias = to_additive(attn_mask, self.attn_mask_mode)
        if rpe is not None:
            rpe = torch.as_tensor(rpe, dtype=torch.float32,
                                  device=query.device)
            attn_bias = rpe if attn_bias is None else attn_bias + rpe

        plain = key_padding_bias is None and attn_bias is None
        impl = self._impl()
        if impl == "pallas":
            # the kernels have no bias path: a biased call takes the
            # gather path rather than losing its mask
            walk = plain
        elif impl == "auto":
            walk = query.is_cuda and auto_supports(plain, block, D)[0]
        else:
            walk = False
        if walk:
            return flash_sparse_attention(
                query, key, value, layout, block, causal=causal,
                dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                tables=self.get_tables(S, query.device))
        COUNTERS.add("kernel.fallbacks")
        return block_sparse_attention(
            query, key, value, layout, block, causal_token_mask=causal,
            key_padding_bias=key_padding_bias, attn_bias=attn_bias,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed)

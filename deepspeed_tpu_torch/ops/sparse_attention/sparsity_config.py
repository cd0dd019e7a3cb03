"""Block-sparse attention layout generators — a copy of
deepspeed_tpu/ops/sparse_attention/sparsity_config.py, which needs only
numpy and Python's `random` (the port imports nothing of the JAX
package).

Classes: SparsityConfig, Dense, Fixed, Variable, BigBird, BSLongformer,
LocalSlidingWindow (reference sparsity_config.py :9-678).  Layouts are
[num_heads, num_blocks, num_blocks] 0/1 numpy matrices over
block-granular attention, equal to the JAX package's bit for bit; the
Variable and BigBird random blocks draw from the global `random`, so
seeding it the same way on both sides gives the same layouts.
"""

from __future__ import annotations

import random
from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base: block size, head count, per-head layout toggle."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(
                f"sequence length {seq_len} must be divisible by block size "
                f"{self.block}")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks), np.int64)

    def check_and_propagate_first_head_layout(self, layout: np.ndarray):
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All-ones layout (testing/fallback; reference :63)."""

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


def _set_sliding_window(h: int, layout: np.ndarray,
                        num_sliding_window_blocks: int) -> np.ndarray:
    """Symmetric block sliding window around the diagonal (shared by
    BigBird / BSLongformer / LocalSlidingWindow configs)."""
    nb = layout.shape[1]
    if num_sliding_window_blocks > nb:
        raise ValueError("window wider than the sequence")
    w = num_sliding_window_blocks // 2
    for row in range(nb):
        lo = max(0, row - w)
        hi = min(nb, row + w + 1)
        layout[h, row, lo:hi] = 1
    return layout


def _apply_unidirectional(layout: np.ndarray) -> np.ndarray:
    """Zero the strict upper block-triangle (autoregressive masking)."""
    nb = layout.shape[1]
    tril = np.tril(np.ones((nb, nb), np.int64))
    return layout * tril[None]


class FixedSparsityConfig(SparsityConfig):
    """Fixed pattern (Sparse Transformers): local windows of
    `num_local_blocks`, plus global attention to the last
    `num_global_blocks` representative block(s) of each preceding window
    (reference :94-242)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention="bidirectional", horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        if num_global_blocks > 0 and num_local_blocks % num_global_blocks:
            raise ValueError(
                f"num_local_blocks {num_local_blocks} must be divisible by "
                f"num_global_blocks {num_global_blocks}")
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only uni/bidirectional attention supported")
        self.attention = attention
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError("horizontal global attention requires "
                             "bidirectional attention")
        self.horizontal_global_attention = horizontal_global_attention
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("multiple global patterns require "
                             "different_layout_per_head=True")
        if num_global_blocks > 0 and num_different_global_patterns > \
                num_local_blocks // num_global_blocks:
            raise ValueError("too many global patterns for window size")
        self.num_different_global_patterns = num_different_global_patterns

    def set_local_layout(self, h, layout):
        nb = layout.shape[1]
        for start in range(0, nb, self.num_local_blocks):
            end = min(start + self.num_local_blocks, nb)
            layout[h, start:end, start:end] = 1
        return layout

    def set_global_layout(self, h, layout):
        nb = layout.shape[1]
        if self.num_global_blocks == 0:
            return layout
        # representative blocks: a num_global_blocks-wide slice of each
        # local window, version selected per head pattern (reference
        # sparsity_config.py:176-224). Vertical global attention is visible
        # to ALL rows; make_layout's trailing tril restores causality for
        # unidirectional attention.
        version = h % self.num_different_global_patterns
        first = (self.num_local_blocks -
                 (version + 1) * self.num_global_blocks)
        full_end = nb - (nb % self.num_local_blocks)
        starts = list(range(first, full_end, self.num_local_blocks))
        if full_end < nb:  # short last window still gets a representative
            starts.append(max(0, min(full_end + first,
                                     nb - self.num_global_blocks)))
        for start in starts:
            end = min(start + self.num_global_blocks, nb)
            layout[h, :, start:end] = 1
            if self.horizontal_global_attention:
                layout[h, start:end, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_local_layout(h, layout)
            self.set_global_layout(h, layout)
        layout = self.check_and_propagate_first_head_layout(layout)
        if self.attention == "unidirectional":
            layout = _apply_unidirectional(layout)
        return layout


class VariableSparsityConfig(SparsityConfig):
    """Variable-size local windows + explicit global block indices +
    random blocks (reference :244-420)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks: List[int] = None,
                 global_block_indices: List[int] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention="bidirectional",
                 horizontal_global_attention=False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError("global start/end index lists must have "
                                 "equal length")
            for s, e in zip(self.global_block_indices,
                            global_block_end_indices):
                if s >= e:
                    raise ValueError(f"global start {s} must precede end {e}")
        self.global_block_end_indices = global_block_end_indices
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError
        self.attention = attention
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError("horizontal global attention requires "
                             "bidirectional attention")
        self.horizontal_global_attention = horizontal_global_attention

    def set_random_layout(self, h, layout):
        nb = layout.shape[1]
        if self.num_random_blocks > nb:
            raise ValueError(f"num_random_blocks {self.num_random_blocks} "
                             f"exceeds {nb} blocks")
        for row in range(nb):
            cols = random.sample(range(nb), self.num_random_blocks)
            layout[h, row, cols] = 1
        return layout

    def set_local_layout(self, h, layout):
        nb = layout.shape[1]
        start = 0
        for i, w in enumerate(self.local_window_blocks):
            end = min(start + w, nb)
            layout[h, start:end, start:end] = 1
            start = end
        # last window size repeats for the remainder
        w = self.local_window_blocks[-1]
        while start < nb:
            end = min(start + w, nb)
            layout[h, start:end, start:end] = 1
            start = end
        return layout

    def set_global_layout(self, h, layout):
        nb = layout.shape[1]
        if self.global_block_end_indices is None:
            for idx in self.global_block_indices:
                if idx < nb:
                    layout[h, :, idx] = 1
                    if self.horizontal_global_attention:
                        layout[h, idx, :] = 1
        else:
            for s, e in zip(self.global_block_indices,
                            self.global_block_end_indices):
                e = min(e, nb)
                layout[h, :, s:e] = 1
                if self.horizontal_global_attention:
                    layout[h, s:e, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_random_layout(h, layout)
            self.set_local_layout(h, layout)
            self.set_global_layout(h, layout)
        layout = self.check_and_propagate_first_head_layout(layout)
        if self.attention == "unidirectional":
            layout = _apply_unidirectional(layout)
        return layout


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird: random + sliding window + global blocks (reference
    :422-550)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention

    def set_random_layout(self, h, layout):
        nb = layout.shape[1]
        if self.num_random_blocks > nb:
            raise ValueError("more random blocks than blocks in the row")
        for row in range(nb):
            if self.attention == "unidirectional":
                pool = range(row + 1)
                k = min(self.num_random_blocks, row + 1)
            else:
                pool = range(nb)
                k = self.num_random_blocks
            cols = random.sample(pool, k)
            layout[h, row, cols] = 1
        return layout

    def set_sliding_window_layout(self, h, layout):
        return _set_sliding_window(h, layout, self.num_sliding_window_blocks)

    def set_global_layout_itc(self, h, layout):
        nb = layout.shape[1]
        if self.num_global_blocks > nb:
            raise ValueError("more global blocks than blocks")
        g = self.num_global_blocks
        layout[h, :g, :] = 1
        layout[h, :, :g] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_random_layout(h, layout)
            self.set_sliding_window_layout(h, layout)
            self.set_global_layout_itc(h, layout)
        layout = self.check_and_propagate_first_head_layout(layout)
        if self.attention == "unidirectional":
            layout = _apply_unidirectional(layout)
        return layout


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + global indices
    (reference :552-676)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=None,
                 global_block_end_indices=None, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError("global start/end index length mismatch")
            for s, e in zip(self.global_block_indices,
                            global_block_end_indices):
                if s >= e:
                    raise ValueError("global start must precede end")
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def set_sliding_window_layout(self, h, layout):
        return _set_sliding_window(h, layout, self.num_sliding_window_blocks)

    def set_global_layout(self, h, layout):
        nb = layout.shape[1]
        if self.global_block_end_indices is None:
            for idx in self.global_block_indices:
                if idx < nb:
                    layout[h, :, idx] = 1
                    layout[h, idx, :] = 1
        else:
            for s, e in zip(self.global_block_indices,
                            self.global_block_end_indices):
                e = min(e, nb)
                layout[h, :, s:e] = 1
                layout[h, s:e, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_sliding_window_layout(h, layout)
            self.set_global_layout(h, layout)
        layout = self.check_and_propagate_first_head_layout(layout)
        if self.attention == "unidirectional":
            layout = _apply_unidirectional(layout)
        return layout


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Pure sliding-window attention (reference :678)."""

    def __init__(self, num_heads, block=16, num_sliding_window_blocks=3,
                 attention="unidirectional"):
        super().__init__(num_heads, block)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            _set_sliding_window(h, layout, self.num_sliding_window_blocks)
        layout = self.check_and_propagate_first_head_layout(layout)
        if self.attention == "unidirectional":
            layout = _apply_unidirectional(layout)
        return layout

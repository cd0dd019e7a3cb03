"""Block-sparse attention (the port of deepspeed_tpu/ops/sparse_attention/):
layouts, the static-gather path, the kernel walk over kernels #7-#9, and
the BERT adaptation helpers."""

from .sparsity_config import (BigBirdSparsityConfig, BSLongformerSparsityConfig,
                              DenseSparsityConfig, FixedSparsityConfig,
                              LocalSlidingWindowSparsityConfig, SparsityConfig,
                              VariableSparsityConfig)
from .sparse_attention import (SparseSelfAttention, block_sparse_attention,
                               layout_to_gather)
from .flash_sparse import flash_sparse_attention, layout_tables
from .sparse_attention_utils import (BertSparseSelfAttention,
                                     SparseAttentionUtils)

__all__ = ["SparsityConfig", "DenseSparsityConfig", "FixedSparsityConfig",
           "VariableSparsityConfig", "BigBirdSparsityConfig",
           "BSLongformerSparsityConfig", "LocalSlidingWindowSparsityConfig",
           "SparseSelfAttention", "block_sparse_attention",
           "layout_to_gather", "flash_sparse_attention", "layout_tables",
           "BertSparseSelfAttention", "SparseAttentionUtils"]

"""Attention and dropout (the port of deepspeed_tpu/ops/transformer/)."""

from .attention import multihead_attention, xla_attention
from .dropout import derive_seed, hash_dropout
from .flash_attention import flash_attention

__all__ = ["multihead_attention", "xla_attention", "flash_attention",
           "hash_dropout", "derive_seed"]

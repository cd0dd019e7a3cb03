"""Attention, dropout and the fused transformer layer (the port of
deepspeed_tpu/ops/transformer/)."""

from .attention import multihead_attention, xla_attention
from .dropout import derive_seed, hash_dropout
from .flash_attention import flash_attention
from .transformer import (DeepSpeedTransformerConfig,
                          DeepSpeedTransformerLayer, init_transformer_params,
                          transformer_layer_forward)

__all__ = ["multihead_attention", "xla_attention", "flash_attention",
           "hash_dropout", "derive_seed", "DeepSpeedTransformerConfig",
           "DeepSpeedTransformerLayer", "init_transformer_params",
           "transformer_layer_forward"]

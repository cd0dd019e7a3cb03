"""Kernel injection over parameter trees (deepspeed_tpu/module_inject)."""

from .replace_module import (FUSED_KEYS, HFBertLayerPolicy, InjectionPolicy,
                             replace_module, replace_transformer_layer,
                             revert_transformer_layer)

__all__ = ["FUSED_KEYS", "InjectionPolicy", "HFBertLayerPolicy",
           "replace_module", "replace_transformer_layer",
           "revert_transformer_layer"]

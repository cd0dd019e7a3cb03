"""Model family: GPT parameters, generation, and the JAX weight import."""

from .convert import load_jax_params
from .generation import generate
from .gpt import GPT, GPT2_SIZES, GPTConfig, gpt2_config, layer_norm

__all__ = ["GPT", "GPTConfig", "gpt2_config", "GPT2_SIZES", "layer_norm",
           "generate", "load_jax_params"]

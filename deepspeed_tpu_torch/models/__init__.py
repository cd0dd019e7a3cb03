"""Model family: GPT and BERT parameters, generation, and the JAX weight
import."""

from .bert import BERT_SIZES, Bert, BertConfig, bert_config
from .convert import load_jax_params
from .generation import generate
from .gpt import GPT, GPT2_SIZES, GPTConfig, gpt2_config, layer_norm

__all__ = ["GPT", "GPTConfig", "gpt2_config", "GPT2_SIZES", "layer_norm",
           "Bert", "BertConfig", "bert_config", "BERT_SIZES", "generate",
           "load_jax_params"]

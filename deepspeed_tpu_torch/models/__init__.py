"""Model family: GPT and BERT parameters, generation, the JAX weight
import and the HuggingFace import."""

from .bert import BERT_SIZES, Bert, BertConfig, bert_config
from .convert import load_jax_params
from .generation import generate
from .gpt import GPT, GPT2_SIZES, GPTConfig, gpt2_config, layer_norm
from .hf import (bert_config_from_hf, gpt2_config_from_hf,
                 hf_bert_state_dict_to_params, hf_gpt2_state_dict_to_params,
                 load_hf_bert, load_hf_gpt2)

__all__ = ["GPT", "GPTConfig", "gpt2_config", "GPT2_SIZES", "layer_norm",
           "Bert", "BertConfig", "bert_config", "BERT_SIZES", "generate",
           "load_jax_params", "gpt2_config_from_hf", "load_hf_gpt2",
           "hf_gpt2_state_dict_to_params", "bert_config_from_hf",
           "load_hf_bert", "hf_bert_state_dict_to_params"]

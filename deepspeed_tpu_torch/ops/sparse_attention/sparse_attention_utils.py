"""Sparse-attention model adaptation helpers — the port of
deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py.

`BertSparseSelfAttention` (:20) is an `nn.Module` holding the q/k/v
projections (`query.kernel`, `query.bias`, ... as in the JAX params tree,
`[hidden, hidden]` kernels) in front of a `SparseSelfAttention`.
`SparseAttentionUtils` (:75) pads and unpads sequences to the block size,
extends position embeddings for longer contexts and swaps a config's
attention for block-sparse, on tensors and configs.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...utils.device import resolve_device
from .sparse_attention import SparseSelfAttention
from .sparsity_config import SparsityConfig


class BertSparseSelfAttention(nn.Module):
    """BERT-style self-attention over block-sparse scores (reference
    bert_sparse_self_attention.py): q/k/v projections +
    SparseSelfAttention.  Parameters `query`, `key`, `value`, each with
    `kernel` [hidden, hidden] and `bias` [hidden], drawn as the JAX init
    draws them (normal 0.02, zero bias) from `generator`."""

    def __init__(self, num_attention_heads: int, hidden_size: int,
                 sparsity_config: Optional[SparsityConfig] = None,
                 key_padding_mask_mode: str = "mul", device="cuda",
                 generator: Optional[torch.Generator] = None,
                 param_dtype=torch.float32):
        super().__init__()
        if hidden_size % num_attention_heads:
            raise ValueError(
                f"hidden size {hidden_size} not a multiple of heads "
                f"{num_attention_heads}")
        self.num_attention_heads = num_attention_heads
        self.hidden_size = hidden_size
        self.head_dim = hidden_size // num_attention_heads
        # default "mul": attention_mask here is the BERT 0/1 keep mask
        # (converted to large-negative bias); pass "add" for pre-built
        # additive biases
        self.sparse_self_attention = SparseSelfAttention(
            sparsity_config or SparsityConfig(num_heads=num_attention_heads),
            key_padding_mask_mode=key_padding_mask_mode)
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        h = hidden_size

        def proj():
            return nn.ParameterDict({
                "kernel": nn.Parameter((0.02 * torch.randn(
                    (h, h), generator=generator, device=dev)).to(param_dtype)),
                "bias": nn.Parameter(torch.zeros(h, dtype=param_dtype,
                                                 device=dev))})

        self.query, self.key, self.value = proj(), proj(), proj()

    def forward(self, hidden_states, attention_mask=None):
        B, S, H = hidden_states.shape
        heads, hd = self.num_attention_heads, self.head_dim

        def project(p):
            y = hidden_states @ p["kernel"].to(hidden_states.dtype) + \
                p["bias"].to(hidden_states.dtype)
            return y.reshape(B, S, heads, hd)

        ctx = self.sparse_self_attention(
            project(self.query), project(self.key), project(self.value),
            key_padding_mask=attention_mask)
        return ctx.reshape(B, S, H)


class SparseAttentionUtils:
    """reference sparse_attention_utils.py — all @staticmethod surface."""

    @staticmethod
    def extend_position_embedding(position_embeddings, max_position: int):
        """Tile an existing [old_max, d] position table to `max_position`
        (reference :38-73 repeats the learned table); returns the extended
        tensor."""
        pe = torch.as_tensor(position_embeddings)
        old_max = pe.shape[0]
        if max_position <= old_max:
            return pe[:max_position]
        reps = -(-max_position // old_max)
        return pe.repeat(reps, 1)[:max_position]

    @staticmethod
    def update_tokenizer_model_max_length(tokenizer, max_position: int):
        """reference :75-88."""
        tokenizer.model_max_length = max_position
        if hasattr(tokenizer, "init_kwargs"):
            tokenizer.init_kwargs["model_max_length"] = max_position
        return tokenizer

    @staticmethod
    def replace_model_self_attention_with_sparse_self_attention(
            config, sparsity_config: SparsityConfig):
        """reference :90-128 swaps nn.Module attention layers in place;
        here the model/layer CONFIG is flipped so its attention dispatch
        routes through SparseSelfAttention (BertConfig.sparsity_config /
        DeepSpeedTransformerConfig.sparsity_config).  Returns the
        config."""
        config.sparsity_config = sparsity_config
        return config

    @staticmethod
    def pad_to_block_size(block_size: int, input_ids, attention_mask=None,
                          token_type_ids=None, position_ids=None,
                          inputs_embeds=None, pad_token_id: int = 0,
                          model_embeddings=None):
        """reference :130-200: right-pad sequence tensors to a multiple of
        the sparsity block size.  Returns (pad_len, padded tensors...)."""
        seq_len = (input_ids.shape[1] if input_ids is not None
                   else inputs_embeds.shape[1])
        pad_len = (block_size - seq_len % block_size) % block_size
        if pad_len == 0:
            return (0, input_ids, attention_mask, token_type_ids,
                    position_ids, inputs_embeds)

        def pad(x, value=0):
            if x is None:
                return None
            x = torch.as_tensor(x)
            # F.pad's widths run from the last axis: pad axis 1 only
            widths = [0, 0] * (x.dim() - 2) + [0, pad_len]
            return torch.nn.functional.pad(x, widths, value=value)

        input_ids = pad(input_ids, pad_token_id)
        attention_mask = pad(attention_mask, 0)
        token_type_ids = pad(token_type_ids, 0)
        position_ids = pad(position_ids, 0)
        if inputs_embeds is not None:
            inputs_embeds = torch.as_tensor(inputs_embeds)
            if model_embeddings is not None:
                # pad with the pad token's embedding (reference :180-189),
                # not zeros; model_embeddings is the [vocab, d] table
                pad_vec = torch.as_tensor(model_embeddings)[pad_token_id]
                tail = pad_vec.to(inputs_embeds.dtype).expand(
                    inputs_embeds.shape[0], pad_len, inputs_embeds.shape[2])
                inputs_embeds = torch.cat([inputs_embeds, tail], dim=1)
            else:
                inputs_embeds = pad(inputs_embeds, 0)
        return (pad_len, input_ids, attention_mask, token_type_ids,
                position_ids, inputs_embeds)

    @staticmethod
    def unpad_sequence_output(pad_len: int, sequence_output):
        """reference :202-214."""
        if pad_len > 0:
            return sequence_output[:, :-pad_len]
        return sequence_output

"""BERT model family — the port of deepspeed_tpu/models/bert.py.

* `BertConfig` (:32) and `layer_config()`, `BERT_SIZES`, `bert_config`
  (:77-87), with torch dtypes;
* `Bert(nn.Module)`: embeddings + N fused encoder layers
  (`ops/transformer/transformer.py`) + MLM / NSP heads, its parameters
  named by the JAX params tree's paths (`embeddings.word`,
  `layers.3.attn_qkvw`, `final_ln_w`, `mlm_head.decoder_b`, ...), at the
  same shapes and in the `[in, out]` layout, so `models/convert.py`
  carries JAX weights across unchanged.  The initialiser draws JAX's
  distributions from an explicit `torch.Generator`.

`encode`, `apply` and `loss` follow the JAX functions op for op (the
tied-decoder MLM loss through `_softmax_xent_from_hidden` with the
decoder bias, :241; NSP from the tanh pooler).  The call
`forward(batch, generator=None, train=True)` is the training loss, as
the engine runs it.  Each layer's dropout seeds are drawn from
`generator` before the layer runs (`layer_seeds`), so a layer recomputed
under `remat` (torch.utils.checkpoint) draws the same masks and takes
the same attention path.  With a
`sparsity_config`, each layer keeps its own `SparseSelfAttention`: the
layer's layout is drawn on its first forward at a given S, in layer
order, and kept with its device tables — a random layout (BigBird) is
fixed from then on, as the JAX program traced once fixes it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import registry
from ..ops.transformer.transformer import (DeepSpeedTransformerConfig,
                                           _layer_norm,
                                           init_transformer_params,
                                           layer_seeds,
                                           transformer_layer_forward)
from ..utils.device import resolve_device
from .gpt import _softmax_xent_from_hidden


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30528          # 30522 padded to a 64 multiple
    max_seq_len: int = 512
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: Optional[int] = None
    type_vocab_size: int = 2
    attn_dropout: float = 0.1
    hidden_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    pre_layer_norm: bool = True      # reference ships both (modelingpreln.py)
    sparsity_config: Any = None      # block-sparse attention (SparseAttentionUtils)
    remat: bool = False
    attn_impl: str = "auto"
    loss_chunks: int = 0             # MLM CE chunking: 0 auto, 1 off, n chunks
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16

    def __post_init__(self):
        if self.d_ff is None:
            self.d_ff = 4 * self.d_model
        if self.d_model % self.num_heads:
            raise ValueError(
                f"d_model {self.d_model} is not a multiple of num_heads "
                f"{self.num_heads}")
        for name in ("param_dtype", "compute_dtype"):
            if not isinstance(getattr(self, name), torch.dtype):
                raise TypeError(f"{name} must be a torch dtype, got "
                                f"{getattr(self, name)!r}")

    def layer_config(self) -> DeepSpeedTransformerConfig:
        return DeepSpeedTransformerConfig(
            hidden_size=self.d_model,
            intermediate_size=self.d_ff,
            heads=self.num_heads,
            attn_dropout_ratio=self.attn_dropout,
            hidden_dropout_ratio=self.hidden_dropout,
            num_hidden_layers=self.num_layers,
            initializer_range=self.initializer_range,
            layer_norm_eps=self.layer_norm_eps,
            pre_layer_norm=self.pre_layer_norm,
            attn_impl=self.attn_impl,
            sparsity_config=self.sparsity_config,
            dtype=self.compute_dtype)


# bert-large @ seq 128/512 is the reference's headline benchmark config
# (docs/_tutorials/bert-pretraining.md:387)
BERT_SIZES = {
    "bert-tiny": dict(num_layers=2, num_heads=2, d_model=64,
                      vocab_size=512, max_seq_len=128),
    "bert-base": dict(num_layers=12, num_heads=12, d_model=768),
    "bert-large": dict(num_layers=24, num_heads=16, d_model=1024),
}


def bert_config(name: str = "bert-base", **overrides) -> BertConfig:
    return BertConfig(**{**BERT_SIZES[name], **overrides})


def _normal(shape, std, dtype, device, generator):
    # drawn in fp32 and cast, as the JAX init does
    return nn.Parameter((std * torch.randn(
        shape, generator=generator, device=device,
        dtype=torch.float32)).to(dtype))


def _const(shape, value, dtype, device):
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))


class Bert(nn.Module):
    """Masked-LM + next-sentence-prediction BERT on `device` (the card by
    default).

    batch dict: input_ids [B,S], token_type_ids [B,S] (optional),
    attention_mask [B,S] 1=keep (optional), mlm_labels [B,S] with -100 at
    unmasked positions, nsp_labels [B] (optional)."""

    def __init__(self, config: BertConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        pd, d, std = cfg.param_dtype, cfg.d_model, cfg.initializer_range
        self.embeddings = nn.ParameterDict({
            "word": _normal((cfg.vocab_size, d), std, pd, dev, generator),
            "position": _normal((cfg.max_seq_len, d), std, pd, dev,
                                generator),
            "token_type": _normal((cfg.type_vocab_size, d), std, pd, dev,
                                  generator),
            "ln_w": _const((d,), 1.0, pd, dev),
            "ln_b": _const((d,), 0.0, pd, dev)})
        layer_cfg = cfg.layer_config()
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: nn.Parameter(v) for k, v in
                              init_transformer_params(layer_cfg, generator,
                                                      pd, dev).items()})
            for _ in range(cfg.num_layers))
        self.final_ln_w = _const((d,), 1.0, pd, dev)
        self.final_ln_b = _const((d,), 0.0, pd, dev)
        self.pooler = nn.ParameterDict({
            "w": _normal((d, d), std, pd, dev, generator),
            "b": _const((d,), 0.0, pd, dev)})
        self.mlm_head = nn.ParameterDict({
            "w": _normal((d, d), std, pd, dev, generator),
            "b": _const((d,), 0.0, pd, dev),
            "ln_w": _const((d,), 1.0, pd, dev),
            "ln_b": _const((d,), 0.0, pd, dev),
            "decoder_b": _const((cfg.vocab_size,), 0.0, pd, dev)})
        self.nsp_head = nn.ParameterDict({
            "w": _normal((d, 2), std, pd, dev, generator),
            "b": _const((2,), 0.0, pd, dev)})
        self._sparse = None
        if cfg.sparsity_config is not None:
            from ..ops.sparse_attention import SparseSelfAttention

            self._sparse = [SparseSelfAttention(cfg.sparsity_config,
                                                key_padding_mask_mode="add")
                            for _ in range(cfg.num_layers)]

    @property
    def device(self) -> torch.device:
        return self.final_ln_w.device

    def _ln(self, x, w, b):
        return _layer_norm(x, w, b, self.config.layer_norm_eps)

    def _ids(self, t):
        if t is None:
            return None
        return torch.as_tensor(np.asarray(t) if not torch.is_tensor(t)
                               else t, device=self.device).long()

    def encode(self, input_ids, token_type_ids=None, attention_mask=None,
               generator=None, train=False):
        """[B, S] tokens -> [B, S, d] hidden states (bert.py:183)."""
        cfg = self.config
        dtype = cfg.compute_dtype
        input_ids = self._ids(input_ids)
        B, S = input_ids.shape
        emb = self.embeddings
        x = emb["word"][input_ids] + emb["position"][:S][None, :, :]
        if token_type_ids is not None:
            x = x + emb["token_type"][self._ids(token_type_ids)]
        x = self._ln(x.to(dtype), emb["ln_w"], emb["ln_b"])

        bias = None
        if attention_mask is not None:
            # additive mask broadcastable to [B, heads, S, S]
            keep = torch.as_tensor(attention_mask, device=self.device)
            bias = (1.0 - keep[:, None, None, :].float()) * \
                torch.finfo(torch.float32).min

        layer_cfg = cfg.layer_config()
        # the selection in force now, replayed when remat recomputes a layer
        ops = registry.op_overrides()
        for i, lp in enumerate(self.layers):
            seeds = layer_seeds(layer_cfg, generator, train)
            sparse = self._sparse[i] if self._sparse is not None else None

            def block(x, lp=lp, seeds=seeds, sparse=sparse):
                with registry.kernel_config(ops=ops):
                    return transformer_layer_forward(
                        lp, x, bias, config=layer_cfg, seeds=seeds,
                        train=train, sparse_attention=sparse)

            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        if cfg.pre_layer_norm:
            x = self._ln(x, self.final_ln_w, self.final_ln_b)
        return x

    def _mlm_hidden(self, x):
        """MLM-head transform (gelu + LN) shared by apply() and loss()."""
        mh = self.mlm_head
        h = F.gelu(x @ mh["w"].to(x.dtype) + mh["b"].to(x.dtype),
                   approximate="tanh")
        return self._ln(h, mh["ln_w"], mh["ln_b"])

    def _nsp_logits(self, x):
        pooled = torch.tanh(x[:, 0, :] @ self.pooler["w"].to(x.dtype) +
                            self.pooler["b"].to(x.dtype))
        return pooled @ self.nsp_head["w"].to(x.dtype) + \
            self.nsp_head["b"].to(x.dtype)

    def _encode_batch(self, batch, generator, train):
        return self.encode(batch["input_ids"], batch.get("token_type_ids"),
                           batch.get("attention_mask"), generator=generator,
                           train=train)

    def apply(self, batch, generator=None, train=False):
        """-> (MLM logits [B, S, V], NSP logits [B, 2]) (bert.py:227)."""
        x = self._encode_batch(batch, generator, train)
        h = self._mlm_hidden(x)
        # tied decoder: embeddings.word^T
        logits = h @ self.embeddings["word"].to(x.dtype).t() + \
            self.mlm_head["decoder_b"].to(x.dtype)
        return logits, self._nsp_logits(x)

    def loss(self, batch, generator=None, train=True):
        """MLM cross entropy over the labelled positions (the tied decoder
        and its bias streamed through `_softmax_xent_from_hidden`, no
        [B, S, V] log-softmax kept) plus the NSP loss when the batch has
        `nsp_labels` (bert.py:236).  `generator` draws the dropout seeds
        (no generator: no dropout)."""
        x = self._encode_batch(batch, generator, train)
        h = self._mlm_hidden(x)
        labels = self._ids(batch["mlm_labels"])
        mask = labels != -100
        safe = torch.where(mask, labels, 0)
        B, S, D = h.shape
        w = self.embeddings["word"].to(h.dtype).t()
        total = _softmax_xent_from_hidden(
            h.reshape(B * S, D), w, safe.reshape(-1), mask.reshape(-1),
            self.config.loss_chunks, bias=self.mlm_head["decoder_b"])
        loss = total / torch.clamp_min(mask.sum(), 1)
        if "nsp_labels" in batch:
            nsp = self._nsp_logits(x)
            logp = torch.log_softmax(nsp.float(), dim=-1)
            nsp_labels = self._ids(batch["nsp_labels"])
            loss = loss - torch.mean(
                torch.gather(logp, 1, nsp_labels[:, None]))
        return loss

    # the module's call is the training loss: the engine runs it through
    # torch.func.functional_call on the compute-dtype replica
    forward = loss

"""Fused BERT-style transformer layer — the port of
deepspeed_tpu/ops/transformer/transformer.py.

* `DeepSpeedTransformerConfig` (:47) with `from_dict` / `from_json_file`;
  `dtype` is a torch dtype (bf16 when `fp16`, else fp32).
* `init_transformer_params` (:113): normal(0, initializer_range), the
  output-facing matrices at 1/sqrt(2·num_layers) of it when
  `adjust_init_range`, drawn from an explicit `torch.Generator` (equal in
  distribution to JAX's, not bit for bit), `[in, out]` weights.
* `transformer_layer_forward` (:146): pre-LN or post-LN; QKV as one
  [h, 3h] product; attention through `multihead_attention` (dense, the
  flash kernels on the card with the BERT `[B, 1, 1, S]` mask as a per-key
  bias) or, with a `sparsity_config`, through `SparseSelfAttention` with
  the mask as an additive key-padding bias (:184-200) — bias-free calls
  take kernels #7-#9 on the card.  `attn_dropout_checkpoint` /
  `normalize_invertible` and `gelu_checkpoint` recompute the attention or
  FFN half under `torch.utils.checkpoint`, with the same dropout seeds
  and the same attention path (the `kernels.registry.kernel_config`
  selection in force at the call is replayed in the recomputation).
* `DeepSpeedTransformerLayer` (:229): an `nn.Module` holding the twelve
  parameters, adopting `initial_weights` / `initial_biases` (6 tensors in
  this layout, or the 8-tensor HF `[out, in]` split-QKV form, :272-290).

Dropout takes int32 seeds (`dropout.derive_seed`) where JAX splits a PRNG
key: `layer_seeds` draws the attention and the two residual seeds of one
layer before it runs, so a recomputed half draws the same masks.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...kernels import registry
from ...utils.device import resolve_device
from .attention import multihead_attention
from .dropout import derive_seed, hash_dropout

PARAM_NAMES = ("attn_qkvw", "attn_qkvb", "attn_ow", "attn_ob", "attn_nw",
               "attn_nb", "inter_w", "inter_b", "output_w", "output_b",
               "norm_w", "norm_b")


@dataclasses.dataclass
class DeepSpeedTransformerConfig:
    """Config surface of reference transformer.py:19-139 (see the JAX
    package's notes: `batch_size` / `max_seq_length` are accepted and not
    needed, `stochastic_mode` is accepted and ignored)."""
    batch_size: int = -1
    hidden_size: int = -1
    intermediate_size: int = -1
    max_seq_length: int = -1
    heads: int = -1
    attn_dropout_ratio: float = -1
    hidden_dropout_ratio: float = -1
    num_hidden_layers: int = -1
    initializer_range: float = -1
    layer_norm_eps: float = 1e-12
    local_rank: int = -1
    seed: int = -1
    fp16: bool = False
    pre_layer_norm: bool = True
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    adjust_init_range: bool = True
    attn_dropout_checkpoint: bool = False
    stochastic_mode: bool = False
    huggingface: bool = False
    training: bool = True
    dtype: Any = None                 # compute dtype; None -> bf16 if fp16 else fp32
    attn_impl: str = "auto"           # auto|pallas|xla (ops/transformer)
    layer_id: int = -1
    sparsity_config: Any = None       # block-sparse attention

    def __post_init__(self):
        if self.intermediate_size in (-1, None) and self.hidden_size > 0:
            self.intermediate_size = 4 * self.hidden_size
        if self.dtype is None:
            self.dtype = torch.bfloat16 if self.fp16 else torch.float32

    @classmethod
    def from_dict(cls, json_object: Dict[str, Any]
                  ) -> "DeepSpeedTransformerConfig":
        """reference transformer.py:141-146."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in json_object.items() if k in fields})

    @classmethod
    def from_json_file(cls, json_file: str) -> "DeepSpeedTransformerConfig":
        """reference transformer.py:148-151."""
        with open(json_file, "r", encoding="utf-8") as reader:
            return cls.from_dict(json.loads(reader.read()))


def _layer_norm(x, w, b, eps):
    """fp32 statistics whatever the activation dtype; returns x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def _rates(cfg: DeepSpeedTransformerConfig) -> Tuple[float, float]:
    return (float(max(cfg.attn_dropout_ratio, 0.0)),
            float(max(cfg.hidden_dropout_ratio, 0.0)))


def layer_seeds(cfg: DeepSpeedTransformerConfig, generator, train: bool):
    """(attention, attention-residual, FFN-residual) dropout seeds of one
    layer, None where inactive — the counterpart of the JAX layer's
    `jax.random.split(rng, 3)`."""
    if not train or generator is None:
        return (None, None, None)
    attn, hidden = _rates(cfg)
    return tuple(derive_seed(r, generator)[0] if r > 0.0 else None
                 for r in (attn, hidden, hidden))


def init_transformer_params(config: DeepSpeedTransformerConfig,
                            generator: Optional[torch.Generator] = None,
                            param_dtype=torch.float32, device="cuda"
                            ) -> Dict[str, torch.Tensor]:
    """Weight init of reference transformer.py:519-527: normal(0,
    initializer_range), the output-facing matrices rescaled by
    1/sqrt(2·num_layers) when adjust_init_range."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    h, ffn = config.hidden_size, config.intermediate_size
    std = config.initializer_range if config.initializer_range > 0 else 0.02
    out_std = std
    if config.adjust_init_range and config.num_hidden_layers > 0:
        out_std = std / math.sqrt(2.0 * config.num_hidden_layers)

    def n(shape, sd):
        return (sd * torch.randn(shape, generator=generator, device=dev,
                                 dtype=torch.float32)).to(param_dtype)

    def z(*shape):
        return torch.zeros(shape, dtype=param_dtype, device=dev)

    return {
        "attn_qkvw": n((h, 3 * h), std), "attn_qkvb": z(3 * h),
        "attn_ow": n((h, h), out_std), "attn_ob": z(h),
        "attn_nw": torch.ones(h, dtype=param_dtype, device=dev),
        "attn_nb": z(h),
        "inter_w": n((h, ffn), std), "inter_b": z(ffn),
        "output_w": n((ffn, h), out_std), "output_b": z(h),
        "norm_w": torch.ones(h, dtype=param_dtype, device=dev),
        "norm_b": z(h),
    }


def adopt_initial_params(initial_weights, initial_biases,
                         param_dtype=torch.float32, device="cuda"
                         ) -> Dict[str, torch.Tensor]:
    """The JAX layer's adoption (:272-290): 6 tensors in this layout
    ([qkvw, ow, nw, inter_w, output_w, norm_w], `[in, out]`), or 8 with
    q, k, v separate in the HF / torch `nn.Linear` `[out, in]` layout,
    transposed and concatenated."""
    dev = resolve_device(device)
    def tensor(a):
        return a if torch.is_tensor(a) else torch.from_numpy(np.array(a))

    ws = [tensor(w) for w in initial_weights]
    bs = [tensor(b) for b in initial_biases]
    if len(ws) == 8:
        ws = [w.t() if w.dim() == 2 else w for w in ws]
        ws = [torch.cat(ws[0:3], dim=-1)] + ws[3:]
        bs = [torch.cat(bs[0:3], dim=-1)] + bs[3:]
    if len(ws) != 6 or len(bs) != 6:
        raise ValueError(f"initial weights/biases: want 6 (or 8 with q, k, v "
                         f"split) tensors each, got {len(initial_weights)} "
                         f"and {len(initial_biases)}")
    out = {}
    for name, w, b in zip(("attn_qkv", "attn_o", "attn_n", "inter_",
                           "output_", "norm_"), ws, bs):
        out[name + "w"] = w.to(dev, param_dtype).contiguous()
        out[name + "b"] = b.to(dev, param_dtype).contiguous()
    return out


def transformer_layer_forward(params: Dict[str, torch.Tensor],
                              hidden_states: torch.Tensor,
                              attention_mask: Optional[torch.Tensor] = None,
                              *,
                              config: DeepSpeedTransformerConfig,
                              seeds=(None, None, None),
                              train: bool = False,
                              sparse_attention=None) -> torch.Tensor:
    """One fused encoder layer, [B, S, H] -> [B, S, H] (:146).

    attention_mask follows the BERT additive convention: broadcastable to
    [B, heads, S, S], large-negative at masked positions.  `seeds`: the
    layer's three dropout seeds (`layer_seeds`).  `sparse_attention`: the
    layer's own `SparseSelfAttention`, which keeps its layout from call to
    call (the caller owns it; without one a fresh module is built, as the
    JAX layer does on every call).

    Order as reference ds_transformer_cuda.cpp:147-293: [pre-LN?] -> QKV
    gemm -> attention -> proj -> dropout -> +residual -> [post-LN?] -> LN
    -> FFN gemm -> gelu -> gemm -> dropout -> +residual -> [post-LN?]."""
    cfg = config
    dtype = cfg.dtype
    x = hidden_states.to(dtype)
    B, S, H = x.shape
    heads = cfg.heads
    hd = H // heads
    s_attn, s_hid1, s_hid2 = seeds
    attn_rate, hidden_rate = _rates(cfg)
    p = {k: params[k].to(dtype) for k in PARAM_NAMES}
    # the selection in force now, replayed when a checkpoint recomputes
    ops = registry.op_overrides()

    def attention_block(x):
        with registry.kernel_config(ops=ops):
            return _attention(x)

    def _attention(x):
        inp = (_layer_norm(x, p["attn_nw"], p["attn_nb"], cfg.layer_norm_eps)
               if cfg.pre_layer_norm else x)
        q, k, v = (inp @ p["attn_qkvw"] + p["attn_qkvb"]).split(H, dim=-1)
        shape = (B, S, heads, hd)
        if cfg.sparsity_config is not None:
            from ..sparse_attention import SparseSelfAttention

            sparse = sparse_attention or SparseSelfAttention(
                cfg.sparsity_config, key_padding_mask_mode="add")
            # the BERT additive mask [B,1,1,S] is a per-key bias: an
            # (already-additive) padding bias for the sparse module
            kpm = None
            if attention_mask is not None:
                kpm = torch.as_tensor(attention_mask, dtype=torch.float32,
                                      device=x.device).expand(
                    B, 1, 1, S)[:, 0, 0, :]
            ctx = sparse(q.reshape(shape), k.reshape(shape),
                         v.reshape(shape), key_padding_mask=kpm,
                         dropout_rate=attn_rate if train else 0.0,
                         dropout_seed=s_attn)
        else:
            ctx = multihead_attention(
                q.reshape(shape), k.reshape(shape), v.reshape(shape),
                causal=False, impl=cfg.attn_impl, bias=attention_mask,
                dropout_rate=attn_rate, dropout_seed=s_attn, train=train)
        out = ctx.reshape(B, S, H) @ p["attn_ow"] + p["attn_ob"]
        out = hash_dropout(out, hidden_rate, s_hid1, train) + x
        if not cfg.pre_layer_norm:
            out = _layer_norm(out, p["attn_nw"], p["attn_nb"],
                              cfg.layer_norm_eps)
        return out

    def ffn_block(a):
        inp = (_layer_norm(a, p["norm_w"], p["norm_b"], cfg.layer_norm_eps)
               if cfg.pre_layer_norm else a)
        inter = F.gelu(inp @ p["inter_w"] + p["inter_b"], approximate="tanh")
        out = inter @ p["output_w"] + p["output_b"]
        out = hash_dropout(out, hidden_rate, s_hid2, train) + a
        if not cfg.pre_layer_norm:
            out = _layer_norm(out, p["norm_w"], p["norm_b"],
                              cfg.layer_norm_eps)
        return out

    # memory-saving modes -> recomputation (the JAX layer's jax.checkpoint)
    remat = torch.is_grad_enabled()
    if remat and (cfg.attn_dropout_checkpoint or cfg.normalize_invertible):
        a = checkpoint(attention_block, x, use_reentrant=False)
    else:
        a = attention_block(x)
    if remat and (cfg.gelu_checkpoint or cfg.normalize_invertible):
        out = checkpoint(ffn_block, a, use_reentrant=False)
    else:
        out = ffn_block(a)
    return out.to(hidden_states.dtype)


class DeepSpeedTransformerLayer(nn.Module):
    """API-parity module (reference transformer.py:463-614): the twelve
    parameters of `PARAM_NAMES` (the reference layer's names), initialised
    by `init_transformer_params` or adopted from `initial_weights` /
    `initial_biases` (`adopt_initial_params`).  The call
    `layer(hidden_states, attention_mask, generator=None, train=None)`
    runs `transformer_layer_forward` with seeds drawn from `generator`."""

    layer_id = 0  # class-level running id, parity with reference :483

    def __init__(self, config: DeepSpeedTransformerConfig,
                 initial_weights=None, initial_biases=None, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 param_dtype=torch.float32):
        super().__init__()
        self.config = config
        self.config.layer_id = DeepSpeedTransformerLayer.layer_id
        DeepSpeedTransformerLayer.layer_id += 1
        if initial_weights is not None and initial_biases is not None:
            params = adopt_initial_params(initial_weights, initial_biases,
                                          param_dtype, device)
        else:
            params = init_transformer_params(config, generator, param_dtype,
                                             device)
        for name in PARAM_NAMES:
            setattr(self, name, nn.Parameter(params[name]))
        self._sparse = None

    def params(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def sparse_attention(self):
        """The layer's SparseSelfAttention (layout kept across calls), or
        None without a sparsity_config."""
        if self.config.sparsity_config is None:
            return None
        if self._sparse is None:
            from ..sparse_attention import SparseSelfAttention

            self._sparse = SparseSelfAttention(self.config.sparsity_config,
                                               key_padding_mask_mode="add")
        return self._sparse

    def forward(self, hidden_states, attention_mask=None, generator=None,
                train: Optional[bool] = None):
        train = self.config.training if train is None else train
        return transformer_layer_forward(
            self.params(), hidden_states, attention_mask, config=self.config,
            seeds=layer_seeds(self.config, generator, train), train=train,
            sparse_attention=self.sparse_attention())

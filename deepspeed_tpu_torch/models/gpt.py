"""GPT model family — what serving needs of deepspeed_tpu/models/gpt.py.

* `GPTConfig`, `GPT2_SIZES`, `gpt2_config` (gpt.py:37-113), with
  `param_dtype` a torch dtype;
* the fp32 `layer_norm` (gpt.py:209);
* `GPT(nn.Module)`: the parameters of the JAX params pytree, named by
  its tree paths joined with "." (`wte`, `wpe`, `blocks.3.attn.qkv.w`,
  `blocks.3.mlp.fc2.b`, `ln_f.scale`, `lm_head` when untied), at the
  same shapes and in the same `[in, out]` weight layout, so `x @ w`
  reproduces the JAX `h @ p[...]["w"]` and `models/convert.py` is a
  plain copy.

The initialiser draws the same distributions as `GPT.init` (normal with
std 0.02; 0.02/sqrt(2·L) for proj and fc2; 0.01 for wpe; zero biases,
unit LayerNorm scales) from an explicit `torch.Generator` — equal in
distribution, not bit for bit.  The forward pass over a full sequence
(`GPT.apply`) and the training loss belong to the training slice; the
serving programs (`serving/programs.py`) and `generation.py` read the
parameters directly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..utils.device import resolve_device


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304          # GPT-2 50257 padded to a 128 multiple
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: Optional[int] = None       # default 4*d_model
    layer_norm_eps: float = 1e-5
    tie_embeddings: bool = True
    param_dtype: Any = torch.float32
    pipeline_stages: int = 1
    sequence_parallel: bool = False
    num_experts: int = 1

    def __post_init__(self):
        if self.d_ff is None:
            self.d_ff = 4 * self.d_model
        if self.d_model % self.num_heads:
            raise ValueError(
                f"d_model {self.d_model} is not a multiple of num_heads "
                f"{self.num_heads}")
        if not isinstance(self.param_dtype, torch.dtype):
            raise TypeError(
                f"param_dtype must be a torch dtype, got "
                f"{self.param_dtype!r}")

    @property
    def head_dim(self):
        return self.d_model // self.num_heads


# Standard GPT-2 sizes; "xl" is the 1.5B north-star model.
GPT2_SIZES: Dict[str, Dict[str, int]] = {
    "nano":   dict(num_layers=3,  num_heads=3,  d_model=48,  max_seq_len=128,
                   vocab_size=256),
    "small":  dict(num_layers=12, num_heads=12, d_model=768),
    "medium": dict(num_layers=24, num_heads=16, d_model=1024),
    "large":  dict(num_layers=36, num_heads=20, d_model=1280),
    "xl":     dict(num_layers=48, num_heads=25, d_model=1600),
}


def gpt2_config(size: str = "small", **overrides) -> GPTConfig:
    base = dict(GPT2_SIZES[size])
    base.update(overrides)
    return GPTConfig(**base)


def layer_norm(x, p, eps):
    """fp32 LayerNorm over the last axis; `p` has `scale` and `bias`.
    Returns x's dtype (gpt.py:209, op for op: biased variance)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p.scale.float() + p.bias.float()).to(x.dtype)


def linear(a, p, dtype):
    """`a @ w.astype(dtype) + b.astype(dtype)` with the JAX package's
    type promotion: a bf16 operand against fp32 weights computes in fp32
    (torch.matmul refuses mixed dtypes, jnp promotes)."""
    ct = torch.promote_types(a.dtype, dtype)
    return a.to(ct) @ p.w.to(dtype).to(ct) + p.b.to(dtype).to(ct)


# ---------------------------------------------------------------------------
# modules (parameter containers named after the JAX tree)
# ---------------------------------------------------------------------------


def _normal(shape, std, dtype, device, generator):
    # drawn in fp32 and cast, as the JAX init does
    return (torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) * std).to(dtype)


class Affine(nn.Module):
    """`w` [d_in, d_out] (the JAX layout) and `b` [d_out]."""

    def __init__(self, d_in, d_out, std, dtype, device, generator):
        super().__init__()
        self.w = nn.Parameter(_normal((d_in, d_out), std, dtype, device,
                                      generator))
        self.b = nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device))


class Norm(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))


class Attention(nn.Module):
    def __init__(self, cfg: GPTConfig, std, proj_std, device, generator):
        super().__init__()
        d, dt = cfg.d_model, cfg.param_dtype
        self.qkv = Affine(d, 3 * d, std, dt, device, generator)
        self.proj = Affine(d, d, proj_std, dt, device, generator)


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig, std, proj_std, device, generator):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
        self.fc1 = Affine(d, f, std, dt, device, generator)
        self.fc2 = Affine(f, d, proj_std, dt, device, generator)


class Block(nn.Module):
    """One pre-LN decoder block's parameters (gpt.py:143-166)."""

    def __init__(self, cfg: GPTConfig, device, generator):
        super().__init__()
        std = 0.02
        proj_std = std / math.sqrt(2 * cfg.num_layers)  # GPT-2 residual scaling
        self.ln1 = Norm(cfg.d_model, cfg.param_dtype, device)
        self.attn = Attention(cfg, std, proj_std, device, generator)
        self.ln2 = Norm(cfg.d_model, cfg.param_dtype, device)
        self.mlp = MLP(cfg, std, proj_std, device, generator)


class GPT(nn.Module):
    """Decoder-only LM parameters on `device` (the card by default)."""

    def __init__(self, config: GPTConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        if cfg.num_experts > 1 or cfg.pipeline_stages > 1 or \
                cfg.sequence_parallel:
            raise NotImplementedError(
                "the port supports plain dense GPT configs (no MoE layers, "
                "no pipeline-stacked blocks, no sequence parallelism) — the "
                "serving contract")
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.config = cfg
        dt = cfg.param_dtype
        self.wte = nn.Parameter(_normal((cfg.vocab_size, cfg.d_model), 0.02,
                                        dt, dev, generator))
        self.wpe = nn.Parameter(_normal((cfg.max_seq_len, cfg.d_model), 0.01,
                                        dt, dev, generator))
        self.blocks = nn.ModuleList(
            Block(cfg, dev, generator) for _ in range(cfg.num_layers))
        self.ln_f = Norm(cfg.d_model, dt, dev)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(_normal((cfg.d_model, cfg.vocab_size),
                                                0.02, dt, dev, generator))

    @property
    def device(self) -> torch.device:
        return self.wte.device

    def head_weight(self):
        """The [D, V] LM-head matrix: wte.T when tied, else lm_head."""
        return self.wte.t() if self.config.tie_embeddings else self.lm_head

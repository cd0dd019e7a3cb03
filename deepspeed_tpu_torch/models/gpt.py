"""GPT model family — the port of deepspeed_tpu/models/gpt.py.

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
distribution, not bit for bit.

Training (gpt.py:218-619): `gpt_block` (the dense and MoE branches; no
ulysses or ring), `_trunk`, `GPT.apply` and `GPT.loss`, with the chunked,
checkpointed cross-entropy `_softmax_xent_from_hidden` (with
`loss_impl="pallas"`, the fused CE of `ops/transformer/fused_xent.py`,
kernels #4-#6 on the card).  The functions
read the module's parameters, so the engine runs them through
`torch.func.functional_call` on a compute-dtype replica of its fp32
masters.  Under ZeRO stage 3 each block runs inside its gather scope
(`runtime/zero/stage3.py` `gathered`), and the engine gathers the
leaves outside the blocks (`wte`, `wpe`, `ln_f`, `lm_head`) around the
whole call.  Dropout seeds are drawn from an explicit `torch.Generator`
(`ops/transformer/dropout.py`) before each block, so a block recomputed
under `remat` draws the same masks; an MoE block's gate-noise seed is
drawn there too.

Mixture of Experts (gpt.py:67-92, :159, :314-318, :614-616): with
`num_experts > 1`, layers `idx % moe_layer_freq == moe_layer_freq - 1`
hold a `moe` module (`moe/layer.py`: `gate.w`, `experts.{w1,b1,w2,b2}`)
in place of `mlp`; its load-balancing loss, summed over the layers and
weighted by `moe_aux_loss_weight`, is added to the training loss only.
The serving programs
(`serving/programs.py`) and `generation.py` read the parameters directly.

ZeRO-Infinity's streaming protocol (gpt.py:621-725): `stream_supported`,
`stream_init` (the groups drawn one at a time from an explicit
generator, in `__init__`'s order), `stream_groups` / `assemble_groups`
(the JAX tree's embed / block:i / head cover), `stream_embed`,
`stream_block` and `stream_head_loss` (through
`_softmax_xent_from_hidden` with the config's `loss_impl`), over nested
dicts of tensors.  `GPT(cfg, device="meta")` builds the module without
parameter memory, for a model streamed from the host.
"""

from __future__ import annotations

import dataclasses
import math
import types
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..moe.layer import MoE, MoEConfig
from ..ops.transformer.attention import multihead_attention
from ..ops.transformer.dropout import derive_seed, hash_dropout
from ..runtime.zero import stage3 as zero3
from ..utils.device import resolve_device
from ..utils.logging import logger


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304          # GPT-2 50257 padded to a 128 multiple
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: Optional[int] = None       # default 4*d_model
    dropout: float = 0.0
    embed_dropout: float = 0.0
    attn_dropout: float = -1.0       # attention-probability dropout;
                                     # -1 -> follow `dropout`
    layer_norm_eps: float = 1e-5
    tie_embeddings: bool = True
    loss_chunks: int = 0             # CE chunking: 0 auto, 1 off, n chunks
    loss_impl: str = "auto"          # auto/xla: chunked CE; pallas: the
                                     # fused LM-head CE kernels (#4-#6)
    remat: bool = False              # per-block rematerialisation
    attn_impl: str = "auto"          # auto|pallas|xla (ops/transformer)
    flash_block_q: int = 0           # 0 -> kernel default
    flash_block_k: int = 0
    param_dtype: Any = torch.float32
    pipeline_stages: int = 1
    sequence_parallel: bool = False
    # Mixture-of-Experts: an MoE FFN every moe_layer_freq layers
    num_experts: int = 1             # >1: MoE on idx % freq == freq - 1
    moe_top_k: int = 1
    moe_layer_freq: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 1e-2

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
        if self.num_experts > 1 and self.pipeline_stages > 1:
            raise ValueError("MoE and pipeline mode are mutually exclusive "
                             "for now (stacked stage params must be uniform)")

    def is_moe_layer(self, idx: int) -> bool:
        # freq f -> layers f-1, 2f-1, ... (f=1: every layer; f=2: odd layers)
        return (self.num_experts > 1 and
                idx % self.moe_layer_freq == self.moe_layer_freq - 1)

    def moe_config(self):
        return MoEConfig(d_model=self.d_model, d_ff=self.d_ff,
                         num_experts=self.num_experts, top_k=self.moe_top_k,
                         capacity_factor=self.moe_capacity_factor)

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


def _attn_rate(cfg: GPTConfig) -> float:
    return cfg.dropout if cfg.attn_dropout < 0 else cfg.attn_dropout


def _dropout(x, rate, seed, train, row_offset=0):
    # counter-hash mask (ops/transformer/dropout.py), gpt.py:218; a
    # data-parallel rank's rows take the global batch's mask
    return hash_dropout(x, rate, seed, train,
                        offset=row_offset * (x.numel() // max(1, x.shape[0])))


def _block_seeds(cfg: GPTConfig, generator, train, moe=False):
    """(attention, attention-residual, MLP-residual dropout seeds, MoE
    gate-noise seed) of one block, drawn before the block runs (None where
    inactive) — the counterpart of the JAX block's
    `jax.random.split(rng, 3)` and, in an MoE block, its split of r3."""
    if not train or generator is None:
        return (None, None, None, None)
    noise = cfg.moe_config().noisy_gate_std if moe else 0.0
    return tuple(derive_seed(r, generator)[0] if r > 0.0 else None
                 for r in (_attn_rate(cfg), cfg.dropout, cfg.dropout, noise))


def gpt_block(x, blk, cfg: GPTConfig, seeds=(None, None, None, None),
              train=True, row_offset=0, batch_rows=None):
    """One pre-LN transformer block over x [B, S, D] (gpt.py:244) ->
    (x, MoE aux loss: 0 for a dense block).  `row_offset`: the global
    batch row of x's first row (its dropout masks are those rows');
    `batch_rows`: the global batch's rows (an MoE block's gate noise is
    drawn for all of them; None: x is the whole batch)."""
    B, S, D = x.shape
    H = cfg.num_heads
    s_attn, s_res1, s_res2, s_moe = seeds
    h = layer_norm(x, blk.ln1, cfg.layer_norm_eps)
    q, kk, v = linear(h, blk.attn.qkv, h.dtype).split(D, dim=-1)
    split_heads = lambda t: t.reshape(B, S, H, D // H)
    attn = multihead_attention(split_heads(q), split_heads(kk),
                               split_heads(v), causal=True,
                               impl=cfg.attn_impl,
                               dropout_rate=_attn_rate(cfg),
                               dropout_seed=s_attn, train=train,
                               block_q=cfg.flash_block_q or None,
                               block_k=cfg.flash_block_k or None,
                               bh_offset=row_offset * H,
                               global_rows=True)
    attn = linear(attn.reshape(B, S, D), blk.attn.proj, h.dtype)
    x = x + _dropout(attn, cfg.dropout, s_res1, train, row_offset)
    h = layer_norm(x, blk.ln2, cfg.layer_norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if hasattr(blk, "moe"):
        gen = (None if s_moe is None else
               torch.Generator(device=x.device).manual_seed(s_moe))
        h, aux = MoE(cfg.moe_config())(blk.moe, h, generator=gen,
                                       train=train, row_offset=row_offset,
                                       batch_rows=batch_rows)
    else:
        h = F.gelu(linear(h, blk.mlp.fc1, h.dtype), approximate="tanh")
        h = linear(h, blk.mlp.fc2, h.dtype)
    return x + _dropout(h, cfg.dropout, s_res2, train, row_offset), aux


def draw_pld_mask(num_layers: int, theta, generator=None):
    """Progressive layer drop's keep gates: layer i runs with probability
    `theta` — Bernoulli(theta) as uniform < theta, drawn on the host from
    `generator` (a fresh seed-0 generator without one, as JAX falls back
    to PRNGKey(0)).  The stream is not JAX's threefry draw: tests hand
    both sides the same mask."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    u = torch.rand(num_layers, generator=generator, device=generator.device)
    return (u < float(theta)).tolist()


def _gathered_block(x, blk, cfg, seeds, train, row_offset, batch_rows,
                    remat):
    """`gpt_block` inside the block's stage-3 gather scope (a no-op
    outside a stage-3 engine): the block's leaves are gathered for it,
    and again for its backward — by the mark on its output, or under
    `remat` by the recomputation, which re-enters the scope."""
    with zero3.gathered(blk, remat=remat) as scope:
        x, aux = gpt_block(x, blk, cfg, seeds, train, row_offset, batch_rows)
        return scope.output(x), aux


def _ce_rows(logits32, labels, valid):
    """Sum of masked next-token NLL over rows, from fp32 logits
    (gpt.py:330): `logsumexp - label_logit`."""
    lse = torch.logsumexp(logits32, dim=-1)
    ll = torch.gather(logits32, -1, labels[:, None])[:, 0]
    return torch.sum(torch.where(valid, lse - ll, 0.0))


def _xent_blocks(n_rows, vocab):
    """(row block, vocab block) of the fused CE, or None where the shapes
    have no lane-aligned divisor (gpt.py:377-388): vocab 50304 = 393*128
    takes 384 (the padded GPT-2 family always has one); GPT-2's own 50257
    has none."""
    br = next((b for b in (256, 128) if n_rows % b == 0), None)
    bv = next((b for b in (512, 448, 384, 256, 128) if vocab % b == 0),
              None)
    return (br, bv) if br and bv else None


def xent_route(n_rows, vocab, impl, bias=False) -> str:
    """The route `_softmax_xent_from_hidden` takes for these shapes:
    "fused" (kernels #4-#6 on the card) or "plain"."""
    if impl != "pallas" or bias or _xent_blocks(n_rows, vocab) is None:
        return "plain"
    return "fused"


def _softmax_xent_from_hidden(x, w, labels, valid, n_chunks=0,
                              impl="auto", bias=None):
    """Projection + cross entropy (gpt.py:341): hidden states [N, D] and
    the [D, V] head weight -> summed NLL.  The projection multiplies the
    compute-dtype operands exactly in fp32 and accumulates in fp32 (JAX's
    `preferred_element_type=float32`), so no rounded logits buffer
    exists.  With n_chunks > 1 the rows go through the CE chunk by chunk,
    each under `torch.utils.checkpoint` (the JAX `jax.checkpoint` scan),
    so backward recomputes each chunk's logits.

    n_chunks: 0 = auto (only past 4 GiB of fp32 logits, ~2 GiB a chunk),
    1 = one projection, n = a count, raised to a divisor of N.

    impl="pallas" (and no bias) takes the fused CE of
    `ops/transformer/fused_xent.py` (kernels #4-#6 on the card), which
    never writes the logits, where block divisors of N and V exist."""
    N, D = x.shape
    V = w.shape[-1]
    if impl == "pallas" and bias is not None:
        logger.warning("loss_impl='pallas': fused kernel carries no "
                       "decoder bias; using the plain path")
        impl = "xla"
    if impl == "pallas":
        # the JAX package refuses a vocab-parallel mesh here (gpt.py:371);
        # the port runs on one device (a mesh > 1 raises in the config),
        # so there is no sharded head to refuse
        from ..ops.transformer.fused_xent import fused_softmax_xent_sum

        blocks = _xent_blocks(N, V)
        if blocks is not None:
            return fused_softmax_xent_sum(x, w, labels, valid, *blocks)
        logger.warning(f"loss_impl='pallas': shapes N={N}, V={V} have no "
                       f"lane-aligned block divisor; using the plain path")

    def project(rows):
        out = rows.float() @ w.float()
        if bias is not None:
            out = out + bias.float()
        return out

    if n_chunks == 0:
        total = N * V * 4
        n_chunks = -(-total // (2 << 30)) if total > 4 << 30 else 1
    # clamp before the fix-up walk (a count above N has no divisor of N
    # above it); N itself is always reachable
    n_chunks = min(n_chunks, N)
    while n_chunks > 1 and N % n_chunks:
        n_chunks += 1
    if n_chunks <= 1:
        return _ce_rows(project(x), labels, valid)

    def body(rows, lc, vc):
        return _ce_rows(project(rows), lc, vc)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for rows, lc, vc in zip(x.chunk(n_chunks), labels.chunk(n_chunks),
                            valid.chunk(n_chunks)):
        total = total + checkpoint(body, rows, lc, vc, use_reentrant=False)
    return total


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
    """One pre-LN decoder block's parameters (gpt.py:143-166): `mlp`, or
    `moe` on an MoE layer.  Under ZeRO stage 3 a block is a gather unit:
    its sharded leaves are gathered together, for its forward and again
    for its backward (runtime/zero/stage3.py)."""

    zero3_gather_unit = True

    def __init__(self, cfg: GPTConfig, device, generator, layer_idx=0):
        super().__init__()
        std = 0.02
        proj_std = std / math.sqrt(2 * cfg.num_layers)  # GPT-2 residual scaling
        self.ln1 = Norm(cfg.d_model, cfg.param_dtype, device)
        self.attn = Attention(cfg, std, proj_std, device, generator)
        self.ln2 = Norm(cfg.d_model, cfg.param_dtype, device)
        if cfg.is_moe_layer(layer_idx):
            self.moe = MoE(cfg.moe_config()).init(generator, cfg.param_dtype,
                                                  device)
        else:
            self.mlp = MLP(cfg, std, proj_std, device, generator)


class GPT(nn.Module):
    """Decoder-only LM parameters on `device` (the card by default)."""

    def __init__(self, config: GPTConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        if cfg.pipeline_stages > 1 or cfg.sequence_parallel:
            raise NotImplementedError(
                "pipeline-stacked blocks and sequence parallelism are not "
                "ported yet (ROADMAP queue 1: pipeline; tensor and sequence "
                "parallelism)")
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        self.config = cfg
        dt = cfg.param_dtype
        self.wte = nn.Parameter(_normal((cfg.vocab_size, cfg.d_model), 0.02,
                                        dt, dev, generator))
        self.wpe = nn.Parameter(_normal((cfg.max_seq_len, cfg.d_model), 0.01,
                                        dt, dev, generator))
        self.blocks = nn.ModuleList(
            Block(cfg, dev, generator, i) for i in range(cfg.num_layers))
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

    # -- training forward (gpt.py:481-619) -----------------------------

    def _tokens(self, t):
        return torch.as_tensor(np.asarray(t) if not torch.is_tensor(t)
                               else t, dtype=torch.long, device=self.device)

    def _trunk(self, tokens, generator=None, train=False, pld_mask=None,
               capture_layers=None, row_offset=0, batch_rows=None):
        """Everything up to and including the final layer norm: tokens
        [B, S] -> ([B, S, D] hidden states, summed MoE aux loss)
        (gpt.py:481).  `pld_mask`: progressive layer drop's per-layer
        keep gates (a sequence of bools, or a bool tensor); a dropped
        block is skipped, so it contributes neither output nor aux loss
        and its parameters get zero gradients — JAX's
        `where(pld_mask[i], out, x)` (gpt.py:543-547) without computing
        the block.  Its dropout seeds are drawn all the same, so the
        later blocks' masks do not depend on the gates."""
        if pld_mask is not None:
            keep = (pld_mask.tolist() if torch.is_tensor(pld_mask)
                    else [bool(k) for k in np.asarray(pld_mask).ravel()])
            if len(keep) != self.config.num_layers:
                raise ValueError(f"pld_mask has {len(keep)} gates for "
                                 f"{self.config.num_layers} layers")
        if capture_layers:
            raise NotImplementedError(
                "layer-output capture is not ported yet (ROADMAP queue 1, "
                "the production runtime)")
        cfg = self.config
        S = tokens.shape[1]
        x = self.wte[tokens] + self.wpe[:S][None, :, :]
        if train and generator is not None and cfg.embed_dropout > 0.0:
            x = _dropout(x, cfg.embed_dropout,
                         derive_seed(cfg.embed_dropout, generator)[0], train,
                         row_offset)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, blk in enumerate(self.blocks):
            seeds = _block_seeds(cfg, generator, train, hasattr(blk, "moe"))
            if pld_mask is not None and not keep[i]:
                continue
            if cfg.remat and torch.is_grad_enabled():
                # recomputed in backward, with the same seeds
                x, aux = checkpoint(_gathered_block, x, blk, cfg, seeds,
                                    train, row_offset, batch_rows, True,
                                    use_reentrant=False)
            else:
                x, aux = _gathered_block(x, blk, cfg, seeds, train,
                                         row_offset, batch_rows, False)
            aux_total = aux_total + aux
        return layer_norm(x, self.ln_f, cfg.layer_norm_eps), aux_total

    def apply(self, tokens, generator=None, train=False):
        """tokens [B, S] -> logits [B, S, V] in the compute dtype
        (gpt.py:566)."""
        x, _ = self._trunk(self._tokens(tokens), generator, train)
        return x @ self.head_weight().to(x.dtype)

    def loss(self, batch, generator=None, train=True,
             progressive_layer_drop=False, pld_theta=None,
             capture_layers=None, row_offset=0, batch_rows=None):
        """Next-token cross entropy (gpt.py:577).  batch: (tokens, labels)
        or a dict with input_ids/labels; labels == -100 positions are
        masked; without labels the tokens are split into inputs
        tokens[:, :-1] and targets tokens[:, 1:].  `generator` draws the
        dropout seeds (no generator: no dropout); `row_offset` is the
        global batch row of the batch's first row (a data-parallel
        rank's slice), so its dropout masks are those rows', and
        `batch_rows` the global batch's rows, for the MoE gate noise."""
        if isinstance(batch, dict):
            tokens, labels = batch["input_ids"], batch.get("labels")
        else:
            tokens, labels = batch
        tokens = self._tokens(tokens)
        if labels is None:
            tokens, labels = tokens[:, :-1], tokens[:, 1:]
        else:
            labels = self._tokens(labels)
        pld_mask = None
        if progressive_layer_drop and pld_theta is not None and train:
            # per-layer keep gates drawn once a micro step (gpt.py:593-600)
            pld_mask = draw_pld_mask(self.config.num_layers, pld_theta,
                                     generator)
            self.last_pld_mask = pld_mask
        x, moe_aux = self._trunk(tokens, generator, train, pld_mask=pld_mask,
                                 capture_layers=capture_layers,
                                 row_offset=row_offset,
                                 batch_rows=batch_rows)
        valid = labels >= 0
        safe_labels = torch.where(valid, labels, 0)
        B, S, D = x.shape
        nll_sum = _softmax_xent_from_hidden(
            x.reshape(B * S, D), self.head_weight(), safe_labels.reshape(-1),
            valid.reshape(-1), self.config.loss_chunks,
            impl=self.config.loss_impl)
        ce = nll_sum / torch.clamp_min(valid.sum(), 1)
        if self.config.num_experts > 1 and train:
            # aux applies to the training objective only: the eval loss
            # stays pure CE
            ce = ce + self.config.moe_aux_loss_weight * moe_aux
        return ce

    # the module's call is the training loss: the engine runs it through
    # torch.func.functional_call on the compute-dtype replica
    forward = loss

    # -- ZeRO-Infinity streaming protocol (gpt.py:621-725) --------------
    # runtime/zero/infinity.py trains a model larger than the card by
    # holding one block's weights on it at a time: the model as embed ->
    # blocks -> head stages over nested dicts of tensors (the JAX tree's
    # groups), and a group-wise init.  A model built on the "meta" device
    # holds no parameter memory at all.

    def stream_supported(self) -> bool:
        cfg = self.config
        return (cfg.num_experts == 1 and cfg.pipeline_stages == 1
                and cfg.dropout == 0.0 and cfg.embed_dropout == 0.0)

    def stream_init(self, generator: torch.Generator):
        """Yield (group name, nested dict of host fp32 tensors), drawn on
        the generator's device one group at a time, in `GPT.__init__`'s
        order: the same generator state gives the resident model's
        weights."""
        cfg = self.config
        dev = generator.device
        f32 = dataclasses.replace(cfg, param_dtype=torch.float32)

        def host(module):
            out = {}
            for name, p in module.named_parameters():
                node = out
                *path, last = name.split(".")
                for k in path:
                    node = node.setdefault(k, {})
                node[last] = p.detach().cpu()
            return out

        wte = _normal((cfg.vocab_size, cfg.d_model), 0.02, torch.float32,
                      dev, generator).cpu()
        wpe = _normal((cfg.max_seq_len, cfg.d_model), 0.01, torch.float32,
                      dev, generator).cpu()
        yield "embed", {"wte": wte, "wpe": wpe}
        del wte, wpe
        for i in range(cfg.num_layers):
            yield f"block:{i}", host(Block(f32, dev, generator, i))
        head = {"ln_f": host(Norm(cfg.d_model, torch.float32, dev))}
        if not cfg.tie_embeddings:
            head["lm_head"] = _normal((cfg.d_model, cfg.vocab_size), 0.02,
                                      torch.float32, dev, generator).cpu()
        yield "head", head

    def stream_groups(self, params):
        """Disjoint group cover of a nested params tree (the inverse of
        assemble_groups)."""
        groups = [("embed", {"wte": params["wte"], "wpe": params["wpe"]})]
        for i, bp in enumerate(params["blocks"]):
            groups.append((f"block:{i}", bp))
        head = {"ln_f": params["ln_f"]}
        if not self.config.tie_embeddings:
            head["lm_head"] = params["lm_head"]
        groups.append(("head", head))
        return groups

    def assemble_groups(self, groups: Dict[str, Any]):
        params = {"wte": groups["embed"]["wte"],
                  "wpe": groups["embed"]["wpe"],
                  "blocks": [groups[f"block:{i}"]
                             for i in range(self.config.num_layers)],
                  "ln_f": groups["head"]["ln_f"]}
        if not self.config.tie_embeddings:
            params["lm_head"] = groups["head"]["lm_head"]
        return params

    def stream_embed(self, embed_p, tokens):
        S = tokens.shape[1]
        return embed_p["wte"][tokens] + embed_p["wpe"][:S][None, :, :]

    def stream_block(self, block_p, x):
        return gpt_block(x, _attrs(block_p), self.config)[0]

    def stream_head_loss(self, head_p, wte_or_lm_head, x, labels, valid):
        """ln_f + the projection CE (`loss_impl` selects the fused kernels
        #4-#6).  `wte_or_lm_head`: the tied wte [V, D] or lm_head [D, V];
        the caller takes the tied gradient."""
        cfg = self.config
        x = layer_norm(x, _attrs(head_p["ln_f"]), cfg.layer_norm_eps)
        w = wte_or_lm_head.t() if cfg.tie_embeddings else wte_or_lm_head
        B, S, D = x.shape
        nll = _softmax_xent_from_hidden(
            x.reshape(B * S, D), w, labels.reshape(-1), valid.reshape(-1),
            cfg.loss_chunks, impl=cfg.loss_impl)
        return nll / torch.clamp_min(valid.sum(), 1)


def _attrs(tree):
    """A nested dict as nested namespaces, the attribute access the block
    functions read parameters with (`blk.attn.qkv.w`)."""
    if isinstance(tree, dict):
        return types.SimpleNamespace(**{k: _attrs(v) for k, v in tree.items()})
    return tree

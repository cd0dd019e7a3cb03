"""Autoregressive generation with a contiguous static KV cache — the
port of deepspeed_tpu/models/generation.py (:34-191).

This is the serving engine's oracle: a prefill pass caches K/V per block
in `[B, L, H, Dh]` tensors, then one token per step is decoded against
them with plain PyTorch attention (no kernel).  The attention math is
op for op the JAX one (fp32 scores scaled by Dh**-0.5, a NEG_INF select
on `q_pos >= k_idx`, softmax, probs cast to the cache dtype, PV
product), so greedy serving through the paged kernel path matches it.

PyTorch idiom: the caches are updated in place (JAX threads new arrays
through `dynamic_update_slice`), and sampling draws from a caller-
supplied `torch.Generator` (JAX's threefry stream is not reproduced;
greedy decoding is what the cross-package tests compare).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import check_same_device, resolve_device
from .gpt import GPT, layer_norm, linear

NEG_INF = -1e30


def _split_qkv(h, qkv_p, B, T, H, Dh):
    qkv = linear(h, qkv_p, h.dtype)
    q, k, v = qkv.split(H * Dh, dim=-1)
    return (q.reshape(B, T, H, Dh), k.reshape(B, T, H, Dh),
            v.reshape(B, T, H, Dh))


def _block_with_cache(blk, cfg, x, ck, cv, pos: int):
    """One decoder block over x [B, T, D]; writes this step's K/V into
    the caches [B, L, H, Dh] at `pos` (in place) and attends causally
    over cache positions <= pos + t."""
    B, T, D = x.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    L = ck.shape[1]
    h = layer_norm(x, blk.ln1, cfg.layer_norm_eps)
    q, k, v = _split_qkv(h, blk.attn.qkv, B, T, H, Dh)
    # cast to the cache dtype on write (identity when they agree)
    ck[:, pos:pos + T] = k.to(ck.dtype)
    cv[:, pos:pos + T] = v.to(cv.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          ck.float()) * (Dh ** -0.5)
    q_idx = pos + torch.arange(T, device=x.device)[:, None]
    k_idx = torch.arange(L, device=x.device)[None, :]
    scores = torch.where(q_idx >= k_idx, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs.to(cv.dtype), cv)
    attn = linear(attn.reshape(B, T, D), blk.attn.proj, h.dtype)
    x = x + attn
    h = layer_norm(x, blk.ln2, cfg.layer_norm_eps)
    h = F.gelu(linear(h, blk.mlp.fc1, h.dtype), approximate="tanh")
    h = linear(h, blk.mlp.fc2, h.dtype)
    return x + h


def _forward_cached(model: GPT, tokens, caches, pos: int):
    """tokens [B, T] at absolute position `pos` -> last-token fp32
    logits [B, V]; the caches are written in place."""
    cfg = model.config
    T = tokens.shape[1]
    x = model.wte[tokens] + model.wpe[pos:pos + T][None]
    for blk, (ck, cv) in zip(model.blocks, caches):
        x = _block_with_cache(blk, cfg, x, ck, cv, pos)
    x = layer_norm(x, model.ln_f, cfg.layer_norm_eps)
    logits = x[:, -1, :] @ model.head_weight().to(x.dtype)
    return logits.float()


def _init_caches(model: GPT, B, L, dtype):
    cfg = model.config
    shape = (B, L, cfg.num_heads, cfg.head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=model.device),
             torch.zeros(shape, dtype=dtype, device=model.device))
            for _ in range(cfg.num_layers)]


def _sample(logits, temperature, top_k, top_p, generator):
    """logits [B, V] -> tokens [B] (generation.py's `sample`: top-k
    first, then the nucleus over the survivors, HF semantics)."""
    greedy = torch.argmax(logits, dim=-1)
    if temperature == 0.0:
        return greedy
    logits = logits.float() / temperature
    V = logits.shape[-1]
    if top_k > 0 or top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        if top_k > 0:
            kth = sorted_desc[..., min(top_k, V) - 1][..., None]
            logits = logits.masked_fill(logits < kth, -torch.inf)
            # ties at the k-th logit survive, so they stay in the nucleus
            sorted_desc = sorted_desc.masked_fill(sorted_desc < kth,
                                                  -torch.inf)
        if top_p < 1.0:
            probs = torch.softmax(sorted_desc, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            keep = torch.sum(cum - probs < top_p, dim=-1, keepdim=True)
            cutoff = torch.gather(sorted_desc, -1, keep - 1)
            logits = logits.masked_fill(logits < cutoff, -torch.inf)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0]


@torch.no_grad()
def generate(model: GPT, prompt, max_new_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             cache_len: Optional[int] = None, top_k: int = 0,
             top_p: float = 1.0, cache_dtype=None, device="cuda"):
    """Generate continuations.  prompt [B, T] ints -> [B, max_new_tokens]
    int64 on `device` (the card by default; the model must live there).
    temperature 0 = greedy; otherwise categorical sampling from
    `generator`, optionally truncated to the top_k logits and/or the
    top_p nucleus.  `cache_dtype` overrides the KV cache's storage dtype
    (default: the param dtype)."""
    dev = resolve_device(device)
    check_same_device("model", model.device, dev)
    cfg = model.config
    if cfg.num_experts > 1:
        raise NotImplementedError(
            "generate() supports plain dense GPT configs (no MoE layers)")
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                             device=dev)
    B, T = prompt.shape
    L = cache_len or min(cfg.max_seq_len, T + max_new_tokens)
    if T + max_new_tokens > cfg.max_seq_len:
        raise ValueError(f"prompt {T} + new {max_new_tokens} exceeds "
                         f"max_seq_len {cfg.max_seq_len}")
    if T + max_new_tokens > L:
        raise ValueError(f"cache_len {L} < prompt {T} + new "
                         f"{max_new_tokens}")
    if top_k < 0 or not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_k must be >= 0 and 0 < top_p <= 1, got "
                         f"{top_k}, {top_p}")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    caches = _init_caches(model, B, L, cache_dtype or model.wte.dtype)
    logits = _forward_cached(model, prompt, caches, 0)
    toks = []
    for i in range(max_new_tokens):
        tok = _sample(logits, float(temperature), int(top_k), float(top_p),
                      generator)
        toks.append(tok)
        if i + 1 < max_new_tokens:
            logits = _forward_cached(model, tok[:, None], caches, T + i)
    return torch.stack(toks, dim=1)

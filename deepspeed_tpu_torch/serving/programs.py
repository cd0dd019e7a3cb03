"""The serving programs: prefill, decode and verify, as plain functions
over `(model, caches, ...)` — the port of deepspeed_tpu/serving/programs.py.

* **prefill** — one prompt CHUNK of static length `prefill_chunk` for
  one request: embeds, writes the chunk's K/V through the block table,
  attends causally against everything cached so far, and samples the
  request's FIRST token (meaningful on the final chunk only).
* **decode** — one token for every slot of the packed batch
  `[max_batch]`: per-slot block-table write + paged attention + per-slot
  sampling.  Every operation is row-wise at a fixed batch shape, so a
  request's tokens do not depend on which other requests share the
  batch.
* **verify** — the speculative-decoding forward: decode at
  `draft_len + 1` tokens per slot, scoring a slot's drafted candidates in
  one pass, every position sampled with the same position-keyed rule as
  sequential decode (the engine's accept/reject loop rides this).

KV storage (`ServeSchedule.kv_dtype`): "dense" keeps K/V rows at the
cache tensors' dtype; "int8"/"int4" store (payload, per-(row, head) fp16
scale) pairs written through `runtime/comm/quant.py` `quantize_rows` and
dequantized in the paged-attention gather.  The surrounding math is
shared, so parity contracts hold at a matched kv_dtype.

The block is `_paged_block`: LayerNorm, the fused QKV matmul, a K/V row
scatter into the paged cache, paged attention through the kernel
registry (the Hopper kernel on the card, the plain version on the CPU),
the output projection and a tanh-GELU MLP.  The attention math mirrors
models/generation.py `_block_with_cache` op for op, so greedy serving
matches `generate()`.

PyTorch idiom: the caches are written in place (`index_copy_` on the
cache tensors), and the per-slot state arrives as host numpy arrays and
is copied to the device each call.

Sampling determinism: the token generated at absolute position p is
drawn from a `torch.Generator` seeded from (request seed, p) — a pure
function of the request, never of the batch composition, so sampled
output is identical under seed across join/leave (the JAX rule of
`_row_key`, programs.py:129; the stream itself is not JAX's threefry).

qwZ weights are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import registry
from ..models.gpt import GPT, layer_norm, linear
from ..runtime.comm.quant import quantize_rows
from .kv_cache import rows_for_tables

# how the cache stores K/V: "dense" = at the cache tensors' own dtype,
# "int8"/"int4" = (payload, scales) rows quantized on write and dequantized
# in the attention gather
KV_MODES = ("dense", "int8", "int4")


class ServeSchedule(NamedTuple):
    """Declarative description of the serving program pair."""

    max_batch: int
    prefill_chunk: int
    block_size: int
    num_blocks: int
    table_width: int
    kv_dtype: str = "dense"        # "dense" | "int8" | "int4"
    draft_len: int = 0             # speculative candidates per verify

    def describe(self) -> str:
        cap = self.table_width * self.block_size
        kv = "" if self.kv_dtype == "dense" else f", kv={self.kv_dtype}"
        spec = "" if not self.draft_len else \
            f", spec draft {self.draft_len}"
        return (f"serve schedule: decode[{self.max_batch} slots] + "
                f"prefill[chunk {self.prefill_chunk}], paged KV "
                f"{self.num_blocks} x {self.block_size} tok "
                f"(per-request cap {cap}){kv}{spec}")


# -- sampling ---------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def _row_seed(seed: int, position: int) -> int:
    """THE sampling-seed rule: a splitmix64 mix of (seed, position), so
    every bit of both reaches the generator (the CPU generator keeps
    only the low 32 bits of its seed)."""
    z = ((int(seed) & 0xFFFFFFFF) << 32 | (int(position) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def row_generator(seed: int, position: int, device) -> torch.Generator:
    """The generator for the token sampled at absolute `position`."""
    return torch.Generator(device=device).manual_seed(
        _row_seed(seed, position))


def sample_token(logits, temperature: float, top_k: int,
                 generator: torch.Generator) -> int:
    """One row [V]: greedy at temperature 0, else temperature + optional
    top-k truncation (ties at the k-th logit survive), sampled with
    `generator` by the Gumbel-max rule."""
    if temperature <= 0:
        return int(torch.argmax(logits))
    v = logits.shape[-1]
    scaled = logits.float() / temperature
    if top_k > 0:
        kth = torch.sort(scaled, descending=True).values[min(top_k, v) - 1]
        scaled = scaled.masked_fill(scaled < kth, -torch.inf)
    u = torch.rand(v, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return int(torch.argmax(scaled + gumbel))


# -- paged attention block (mirrors generation._block_with_cache) -----------


def _gather_rows(table, block_size):
    """Block table [W] -> flat cache row indices [W * block_size]."""
    return (table[:, None] * block_size +
            torch.arange(block_size, device=table.device)[None, :]).reshape(-1)


def _kv_write(c, idx, val, kv_mode="dense"):
    """Scatter `val` [N, H, Dh] into cache entry `c` at flat rows `idx`,
    in place (the JAX package returns new arrays from `.at[idx].set`).
    Dense: a row scatter at the cache's own dtype.  Quantized: the rows
    are quantized (`quantize_rows`, one fp16 scale per row and head) and
    the payload and the scales scatter at the same rows, so a write never
    touches another row's scale.  Rows that repeat in `idx` only ever
    point into the trash block, whose contents are never attended."""
    if kv_mode == "dense":
        c.index_copy_(0, idx, val.to(c.dtype))
        return
    payload, scales = c
    codes, s = quantize_rows(val.float(), kv_mode)
    payload.index_copy_(0, idx, codes)
    scales.index_copy_(0, idx, s)


def _paged_block(blk, cfg, x, ck, cv, write_idx, rows, q_pos, block_size,
                 kv_mode="dense"):
    """One decoder block over x [B, T, D] with paged KV.

    `write_idx` [B*T] flat cache rows this chunk's K/V land in, `rows`
    [B, L] flat cache rows the attention reads (the gathered block
    table), `q_pos` [B, T] absolute positions of x's tokens, `kv_mode`
    the storage codec.  A quantized cache's attention comes back in fp32,
    and the output projection then computes in fp32, as the JAX
    package's type promotion does."""
    B, T, D = x.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    h = layer_norm(x, blk.ln1, cfg.layer_norm_eps)
    q, k, v = linear(h, blk.attn.qkv, h.dtype).split(D, dim=-1)
    q = q.reshape(B, T, H, Dh)
    _kv_write(ck, write_idx, k.reshape(B * T, H, Dh), kv_mode)
    _kv_write(cv, write_idx, v.reshape(B * T, H, Dh), kv_mode)
    attn = registry.dispatch("paged_attention", q, ck, cv, rows, q_pos,
                             kv_mode=kv_mode, block_size=block_size)
    attn = linear(attn.reshape(B, T, D), blk.attn.proj, h.dtype)
    x = x + attn
    h = layer_norm(x, blk.ln2, cfg.layer_norm_eps)
    h = F.gelu(linear(h, blk.mlp.fc1, h.dtype), approximate="tanh")
    h = linear(h, blk.mlp.fc2, h.dtype)
    return x + h


def _proj_logits(model: GPT, x_rows):
    """[B, D] hidden rows -> fp32 logits [B, V] (generation.py's head)."""
    return (x_rows @ model.head_weight().to(x_rows.dtype)).float()


def _forward_blocks(model, caches, schedule, x, write_idx, rows, q_pos):
    cfg = model.config
    for blk, (ck, cv) in zip(model.blocks, caches):
        x = _paged_block(blk, cfg, x, ck, cv, write_idx, rows, q_pos,
                         schedule.block_size, schedule.kv_dtype)
    return layer_norm(x, model.ln_f, cfg.layer_norm_eps)


@torch.no_grad()
def prefill(model: GPT, caches, schedule: ServeSchedule, tokens, pos: int,
            n_valid: int, table, temperature: float, top_k: int, seed: int):
    """tokens [1, C] (zero-padded past n_valid) at absolute position
    `pos`; writes the chunk's K/V through `table` [W] and returns
    (first-token sample, last-valid-row fp32 logits [V])."""
    dev = model.device
    C, bs, W = schedule.prefill_chunk, schedule.block_size, \
        schedule.table_width
    tokens = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    table = torch.as_tensor(table, dtype=torch.long, device=dev)
    abs_pos = pos + torch.arange(C, device=dev)
    # per-row gather with a clip, not a slice: when the final chunk's
    # pad rows run past the wpe table, the valid rows keep their exact
    # positional embeddings and only pad rows see the clamped last row
    wpe_rows = model.wpe[abs_pos.clamp(0, model.wpe.shape[0] - 1)]
    x = model.wte[tokens] + wpe_rows[None]
    blk_i = abs_pos // bs
    # positions past the table (pad rows of the final chunk) write to
    # the trash block, never a neighbour's memory
    blk = torch.where(blk_i < W, table[blk_i.clamp(0, W - 1)], 0)
    write_idx = blk * bs + abs_pos % bs
    rows = _gather_rows(table, bs)[None, :]
    x = _forward_blocks(model, caches, schedule, x, write_idx, rows,
                        abs_pos[None, :])
    logits = _proj_logits(model, x[:, n_valid - 1, :])[0]      # [V]
    tok = sample_token(logits, temperature, top_k,
                       row_generator(seed, pos + n_valid, dev))
    return tok, logits


@torch.no_grad()
def decode(model: GPT, caches, schedule: ServeSchedule, tokens, positions,
           active, tables, temperatures, top_ks, seeds) -> np.ndarray:
    """One token for every slot: tokens [R] (each slot's last token),
    positions [R] (its write position = current cached length), active
    [R] bool, tables [R, W], sampling params [R] — host arrays.
    Inactive slots write to the trash block; the engine discards their
    outputs.  Returns the sampled tokens [R] on the host."""
    dev = model.device
    bs = schedule.block_size
    tok_d = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    pos_d = torch.as_tensor(positions, dtype=torch.long, device=dev)
    act_d = torch.as_tensor(active, dtype=torch.bool, device=dev)
    tab_d = torch.as_tensor(tables, dtype=torch.long, device=dev)
    # the clip only reaches inactive slots (whose stale position is
    # discarded); an out-of-range index would be a device-side fault
    wpe_rows = model.wpe[pos_d.clamp(0, model.wpe.shape[0] - 1)]
    x = (model.wte[tok_d] + wpe_rows)[:, None, :]                # [R, 1, D]
    blk = torch.gather(tab_d, 1, (pos_d // bs).clamp(
        0, schedule.table_width - 1)[:, None])[:, 0]
    write_idx = torch.where(act_d, blk * bs + pos_d % bs, 0)
    rows = rows_for_tables(tab_d, bs)
    x = _forward_blocks(model, caches, schedule, x, write_idx, rows,
                        pos_d[:, None])
    logits = _proj_logits(model, x[:, -1, :])                   # [R, V]
    toks = torch.argmax(logits, dim=-1).cpu().numpy()
    for r in np.flatnonzero((np.asarray(temperatures) > 0) &
                            np.asarray(active, bool)):
        toks[r] = sample_token(
            logits[r], float(temperatures[r]), int(top_ks[r]),
            row_generator(int(seeds[r]), int(positions[r]) + 1, dev))
    return toks


@torch.no_grad()
def verify(model: GPT, caches, schedule: ServeSchedule, tokens, positions,
           n_draft, active, tables, temperatures, top_ks,
           seeds) -> np.ndarray:
    """The speculative forward: decode's math at T = draft_len + 1 tokens
    per slot.  tokens [R, T] = column 0 each slot's last committed token,
    columns 1..draft_len its drafted candidates (pad past n_draft[r]
    ignored); positions [R] = the committed token's write position.  All
    candidate K/V are written through the table (rows past a slot's
    drafts, and inactive slots, write to the trash block), attention is
    causal (row i sees rows <= i plus everything cached), and every
    position is sampled with the rule decode uses, so toks[r, i] is the
    token sequential decode would emit at position positions[r] + 1 + i
    given the prefix through column i.  Rejected rows need no undo: the
    engine rewinds its position and the stale rows are written again
    before any later query's mask reaches them.  Returns the samples
    [R, T] on the host."""
    dev = model.device
    bs, W = schedule.block_size, schedule.table_width
    T = int(schedule.draft_len) + 1
    tok_d = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    pos_d = torch.as_tensor(positions, dtype=torch.long, device=dev)
    nd_d = torch.as_tensor(n_draft, dtype=torch.long, device=dev)
    act_d = torch.as_tensor(active, dtype=torch.bool, device=dev)
    tab_d = torch.as_tensor(tables, dtype=torch.long, device=dev)
    R = tok_d.shape[0]
    cols = torch.arange(T, device=dev)
    abs_pos = pos_d[:, None] + cols[None, :]                      # [R, T]
    # per-row gather with a clip, the prefill rule: pad rows past the wpe
    # table clamp (their writes land in trash, their samples are dropped)
    wpe_rows = model.wpe[abs_pos.clamp(0, model.wpe.shape[0] - 1)]
    x = model.wte[tok_d] + wpe_rows                               # [R, T, D]
    blk_i = abs_pos // bs
    valid = act_d[:, None] & (cols[None, :] <= nd_d[:, None]) & (blk_i < W)
    blk = torch.gather(tab_d, 1, blk_i.clamp(0, W - 1))
    write_idx = torch.where(valid, blk * bs + abs_pos % bs, 0).reshape(R * T)
    rows = rows_for_tables(tab_d, bs)
    x = _forward_blocks(model, caches, schedule, x, write_idx, rows, abs_pos)
    logits = _proj_logits(model, x.reshape(R * T, -1)).reshape(R, T, -1)
    toks = torch.argmax(logits, dim=-1).cpu().numpy()
    for r in np.flatnonzero((np.asarray(temperatures) > 0) &
                            np.asarray(active, bool)):
        for i in range(T):
            toks[r, i] = sample_token(
                logits[r, i], float(temperatures[r]), int(top_ks[r]),
                row_generator(int(seeds[r]), int(positions[r]) + 1 + i, dev))
    return toks

"""Paged KV cache: fixed-size blocks, a refcounted free-list allocator,
per-request block tables, and a block-level prefix cache — the port of
deepspeed_tpu/serving/kv_cache.py (dense storage).

A request holds exactly the blocks its length needs and returns them the
step it finishes; the programs address K/V through a per-request block
table, so fragmentation is bounded at one partial block per request and
admission is a free-list check.

Prefix cache: a FULL block's content is named by a token-id chain hash
`h_i = H(h_{i-1}, tokens_in_block_i)` salted with the model fingerprint,
kv storage dtype and block size — byte for byte the JAX package's hash,
so the two packages name the same blocks.  N requests alias one
physical block by putting the same id in their tables; a finished
holder's registered blocks park in an LRU of refcount-0 blocks, evicted
only when the free list runs dry.  The one write that can land in a
shared block (recomputing the final prompt token of a fully cached
prompt) goes copy-on-write.  Session pins take one extra reference on a
finished request's blocks so a follow-up turn adopts them.

Device layout: per layer, K and V each live in ONE tensor
`[num_blocks * block_size, H, Dh]`, so the decode write is a row
scatter at `table[pos // bs] * bs + pos % bs` and the attention read a
row gather of the table's blocks.  The tensors are updated in place
(`index_copy_`), where the JAX package threads new arrays.

Block 0 is the reserved TRASH block: never handed out, pads every table,
and takes the writes of inactive decode slots — its contents are never
attended unmasked.

Storage modes: fp32, bf16 and fp16.  The int8/int4 row codecs are not
ported yet and raise NotImplementedError (ROADMAP: the quantized-KV and
speculative slice).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..monitor.counters import COUNTERS

TRASH_BLOCK = 0

KV_QUANT_WIRES = ("int8", "int4")

_KV_DTYPE_ALIASES = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "fp16": torch.float16, "float16": torch.float16,
    "fp32": torch.float32, "float32": torch.float32,
}
# the dtype names the JAX package folds into the prefix-hash salt
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16"}


def resolve_kv_dtype(dtype):
    """Normalize a kv_dtype spec -> ("dense", torch dtype).  Accepts the
    dense dtype names ("bf16", "float32", ...) or a torch dtype; the
    quantized wires raise NotImplementedError."""
    if isinstance(dtype, str):
        name = dtype.lower()
        if name in KV_QUANT_WIRES:
            raise NotImplementedError(
                f"kv_dtype {dtype!r}: quantized KV is not ported yet "
                f"(ROADMAP: the quantized-KV and speculative slice)")
        if name in _KV_DTYPE_ALIASES:
            return "dense", _KV_DTYPE_ALIASES[name]
        raise ValueError(
            f"kv_dtype {dtype!r} not understood; use one of "
            f"{sorted(_KV_DTYPE_ALIASES)}")
    if dtype not in _DTYPE_NAMES:
        raise ValueError(
            f"kv_dtype {dtype!r} not supported; use one of "
            f"{sorted(map(str, _DTYPE_NAMES))}")
    return "dense", dtype


def rows_for_tables(tables, block_size: int):
    """Block tables [R, W] -> flat cache row indices [R, W * block_size]
    (row-major walk of each slot's blocks).  THE addressing the programs
    attend through; the paged-attention kernel reads it as it is
    (`rows[:, ::block_size] // block_size` recovers the table)."""
    R, W = tables.shape
    return (tables[:, :, None] * block_size +
            torch.arange(block_size, device=tables.device)[None, None, :]
            ).reshape(R, -1)


def kv_block_bytes(num_layers: int, num_heads: int, head_dim: int,
                   block_size: int, kv_dtype) -> int:
    """Device bytes ONE block costs across all layers (K and V).  The
    quantized sizes are the JAX package's (int8: head_dim payload bytes
    + a 2-byte scale per row-head; int4 halves the payload)."""
    if isinstance(kv_dtype, str) and kv_dtype.lower() in KV_QUANT_WIRES:
        payload = head_dim if kv_dtype.lower() == "int8" else head_dim // 2
        per_row = num_heads * (payload + 2)
    else:
        _, dense = resolve_kv_dtype(kv_dtype)
        per_row = num_heads * head_dim * dense.itemsize
    return 2 * num_layers * block_size * per_row


class PagedKVCache:
    """Device block pool + host allocator for one serving engine.

    `caches` is a list of (k, v) per layer, each
    `[num_blocks * block_size, H, Dh]` on `device`; the programs write
    into them in place.  Owners are opaque hashable keys: request rids,
    or `("session", sid, rid)` tuples for pins."""

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 num_blocks: int, block_size: int, table_width: int,
                 dtype=torch.float32, device="cpu",
                 prefix_cache: bool = True, min_match_blocks: int = 1,
                 prefix_salt: str = ""):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the reserved trash "
                f"block), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if table_width < 1:
            raise ValueError(f"table_width must be >= 1, got {table_width}")
        if int(min_match_blocks) < 1:
            raise ValueError(
                f"min_match_blocks must be >= 1, got {min_match_blocks}")
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.table_width = int(table_width)
        self.dtype = dtype
        _, self.dense_dtype = resolve_kv_dtype(dtype)
        self.device = torch.device(device)
        self.caches = self._init_caches()
        # block 0 reserved as trash; LIFO free list so just-freed blocks
        # are reused at once
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._owned: Dict[Any, List[int]] = {}
        # holders per block (live requests + session pins); absent = 0
        self._ref: Dict[int, int] = {}
        self.evictions = 0
        # -- prefix cache state ---------------------------------------
        self.prefix_enabled = bool(prefix_cache)
        self.min_match_blocks = int(min_match_blocks)
        mode_name = _DTYPE_NAMES[self.dense_dtype]
        self._salt = hashlib.blake2b(
            f"{prefix_salt}|{mode_name}|{self.block_size}".encode(),
            digest_size=16).digest()
        self._hash_index: Dict[bytes, int] = {}   # chain hash -> block
        self._block_hash: Dict[int, bytes] = {}   # block -> chain hash
        # refcount-0 registered blocks, oldest first (the eviction order)
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.cow_copies = 0
        self.prefix_evictions = 0

    # -- device state -------------------------------------------------

    def _init_caches(self):
        shape = (self.num_blocks * self.block_size, self.num_heads,
                 self.head_dim)

        def mk():
            return torch.zeros(shape, dtype=self.dense_dtype,
                               device=self.device)

        return [(mk(), mk()) for _ in range(self.num_layers)]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for kv in self.caches for t in kv)

    def bytes_per_block(self) -> int:
        """Device bytes one block costs across all layers (K and V)."""
        return kv_block_bytes(self.num_layers, self.num_heads,
                              self.head_dim, self.block_size, self.dtype)

    # -- allocator ----------------------------------------------------

    @property
    def capacity_blocks(self) -> int:
        """Allocatable blocks (the trash block is not capacity)."""
        return self.num_blocks - 1

    @property
    def blocks_in_use(self) -> int:
        """Blocks with a live holder (request or session pin);
        refcount-0 cached blocks parked in the LRU are not in use."""
        return self.capacity_blocks - len(self._free) - len(self._lru)

    @property
    def free_blocks(self) -> int:
        """The free list plus the refcount-0 cached blocks the LRU would
        evict to serve an allocation."""
        return len(self._free) + len(self._lru)

    @property
    def cached_blocks(self) -> int:
        """Hash-registered blocks (live holders + LRU residents)."""
        return len(self._hash_index)

    def blocks_needed(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.block_size)

    def _take_free(self) -> int:
        """Pop one allocatable block, evicting the coldest refcount-0
        cached block when the free list is dry."""
        if self._free:
            return self._free.pop()
        block, _ = self._lru.popitem(last=False)   # oldest first
        h = self._block_hash.pop(block, None)
        if h is not None:
            self._hash_index.pop(h, None)
        self.prefix_evictions += 1
        COUNTERS.add("kv.prefix_evictions")
        return block

    def alloc(self, rid, n_blocks: int,
              shared: Optional[Sequence[int]] = None,
              privatize_last: bool = False) -> Optional[np.ndarray]:
        """Allocate `n_blocks` table entries for request `rid`; returns
        the padded block table `[table_width] int32` (unused entries
        point at the trash block) or None when the pool cannot cover
        the FRESH share.  `shared` aliases already-cached blocks as the
        table's leading entries.  `privatize_last` handles the
        whole-prompt-cached case: a refcount-0 (LRU) last block is
        adopted in place, a live-shared one is copied to a private block
        first (copy-on-write)."""
        n_blocks = int(n_blocks)
        shared = list(shared or ())
        if rid in self._owned:
            raise ValueError(f"request {rid} already holds blocks")
        if n_blocks > self.table_width:
            raise ValueError(
                f"request {rid} needs {n_blocks} blocks > table width "
                f"{self.table_width} (engine capacity "
                f"{self.table_width * self.block_size} tokens)")
        if len(shared) > n_blocks:
            raise ValueError(
                f"request {rid}: {len(shared)} shared blocks exceed the "
                f"{n_blocks}-block table")
        cow = (privatize_last and bool(shared)
               and self._ref.get(shared[-1], 0) > 0)
        fresh = n_blocks - len(shared) + (1 if cow else 0)
        # matched blocks may BE LRU residents; aliasing removes them from
        # the LRU, so they are not also capacity for the fresh share
        lru_shared = sum(1 for b in set(shared)
                         if self._ref.get(b, 0) == 0)
        if fresh > len(self._free) + len(self._lru) - lru_shared:
            return None
        blocks: List[int] = []
        cow_pair = None
        for i, b in enumerate(shared):
            if privatize_last and i == len(shared) - 1:
                if self._ref.get(b, 0) == 0:
                    self._lru.pop(b, None)
                    self._ref[b] = 1
                    blocks.append(b)
                else:
                    nb = self._take_free()
                    self._ref[nb] = 1
                    cow_pair = (b, nb)
                    blocks.append(nb)
                continue
            if self._ref.get(b, 0) == 0:
                self._lru.pop(b, None)
            self._ref[b] = self._ref.get(b, 0) + 1
            blocks.append(b)
        for _ in range(n_blocks - len(shared)):
            nb = self._take_free()
            self._ref[nb] = 1
            blocks.append(nb)
        self._owned[rid] = blocks
        if cow_pair is not None:
            self._cow_copy(*cow_pair)
        table = np.full((self.table_width,), TRASH_BLOCK, np.int32)
        table[:n_blocks] = blocks
        return table

    def blocks_of(self, rid) -> List[int]:
        return list(self._owned.get(rid, ()))

    def free(self, rid, evicted: bool = False) -> int:
        """Drop `rid`'s references.  A block whose refcount reaches zero
        returns to the free list, or parks in the LRU when it is
        hash-registered.  `evicted=True` marks a FORCED reclaim
        (shed/errored request) and bumps `kv.evictions` for every block
        actually released."""
        blocks = self._owned.pop(rid, None)
        if not blocks:
            return 0
        released = 0
        for b in reversed(blocks):
            r = self._ref.get(b, 1) - 1
            if r > 0:
                self._ref[b] = r
                continue
            self._ref.pop(b, None)
            released += 1
            if b in self._block_hash:
                self._lru[b] = None            # park at the MRU end
            else:
                self._free.append(b)
        if evicted and released:
            self.evictions += released
            COUNTERS.add("kv.evictions", calls=released)
        return len(blocks)

    # -- prefix cache -------------------------------------------------

    def prefix_hashes(self, tokens: Sequence[int]) -> List[bytes]:
        """Chain hashes of `tokens`' FULL blocks, seeded with the salt.
        The partial tail block is never hashed."""
        if not self.prefix_enabled:
            return []
        bs = self.block_size
        out: List[bytes] = []
        h = self._salt
        for i in range(len(tokens) // bs):
            blk = np.asarray(tokens[i * bs:(i + 1) * bs], np.int64)
            h = hashlib.blake2b(h + blk.tobytes(),
                                digest_size=16).digest()
            out.append(h)
        return out

    def match_prefix(self, hashes: Sequence[bytes]) -> List[int]:
        """The longest registered prefix of `hashes` -> block ids; empty
        below `min_match_blocks`."""
        if not self.prefix_enabled:
            return []
        blocks: List[int] = []
        for h in hashes:
            b = self._hash_index.get(h)
            if b is None:
                break
            blocks.append(b)
        if len(blocks) < self.min_match_blocks:
            return []
        return blocks

    def register_prefix(self, rid, hashes: Sequence[bytes],
                        start: int = 0) -> int:
        """Publish `rid`'s blocks `start..len(hashes)-1` under their
        chain hashes (first registration wins).  Only blocks of a
        pure-prefill chain may be published."""
        if not self.prefix_enabled:
            return 0
        blocks = self._owned.get(rid)
        if not blocks:
            return 0
        n = 0
        for i in range(int(start), min(len(hashes), len(blocks))):
            h = hashes[i]
            if h in self._hash_index:
                continue
            b = blocks[i]
            old = self._block_hash.get(b)
            if old is not None and old != h:
                continue
            self._hash_index[h] = b
            self._block_hash[b] = h
            n += 1
        return n

    def _cow_copy(self, src: int, dst: int) -> None:
        """Device row copy of one block (every layer, K and V), in place
        on the cache tensors — the copy-on-write of a write into a
        live-shared block."""
        bs = self.block_size
        rows = torch.arange(bs, device=self.device)
        src_rows, dst_rows = rows + src * bs, rows + dst * bs
        for kv in self.caches:
            for t in kv:
                t.index_copy_(0, dst_rows, t[src_rows])
        self.cow_copies += 1
        COUNTERS.add("kv.cow_copies", nbytes=self.bytes_per_block())

    # -- session pins -------------------------------------------------

    def pin(self, owner, rid) -> int:
        """Take one extra reference on `rid`'s blocks under `owner` so
        they survive the request's `free()`.  Returns the block count."""
        if owner in self._owned:
            raise ValueError(f"owner {owner!r} already holds blocks")
        blocks = self._owned.get(rid)
        if not blocks:
            return 0
        for b in blocks:
            self._ref[b] = self._ref.get(b, 0) + 1
        self._owned[owner] = list(blocks)
        return len(blocks)

    def alloc_from_pin(self, rid, n_blocks: int,
                       pin_owner) -> Optional[np.ndarray]:
        """Transfer a session pin's blocks to request `rid` wholesale and
        top up with fresh blocks to `n_blocks`.  Returns the table, or
        None (pin left intact) when the fresh share cannot be covered."""
        if rid in self._owned:
            raise ValueError(f"request {rid} already holds blocks")
        blocks = self._owned.get(pin_owner)
        if not blocks:
            return None
        n_blocks = max(int(n_blocks), len(blocks))
        if n_blocks > self.table_width:
            raise ValueError(
                f"request {rid} needs {n_blocks} blocks > table width "
                f"{self.table_width}")
        fresh = n_blocks - len(blocks)
        if fresh > self.free_blocks:
            return None
        self._owned.pop(pin_owner)
        blocks = list(blocks)
        for _ in range(fresh):
            nb = self._take_free()
            self._ref[nb] = 1
            blocks.append(nb)
        self._owned[rid] = blocks
        table = np.full((self.table_width,), TRASH_BLOCK, np.int32)
        table[:n_blocks] = blocks
        return table

    # -- telemetry ----------------------------------------------------

    def sample_occupancy(self) -> None:
        """Per-step occupancy sample (mean = bytes/calls)."""
        COUNTERS.add("kv.blocks_in_use", nbytes=self.blocks_in_use)

    def describe(self) -> str:
        return (f"PagedKVCache(layers={self.num_layers}, "
                f"blocks={self.num_blocks} x {self.block_size} tok, "
                f"table_width={self.table_width}, heads={self.num_heads}, "
                f"head_dim={self.head_dim}, "
                f"kv={_DTYPE_NAMES[self.dense_dtype]}, "
                f"prefix_cache={'on' if self.prefix_enabled else 'off'}, "
                f"device={self.device}, "
                f"{self.nbytes() / (1 << 20):.2f} MiB)")

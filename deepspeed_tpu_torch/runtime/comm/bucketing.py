"""The bucketed gradient-reduction wire — the port of
deepspeed_tpu/runtime/comm/bucketing.py (`BucketPlan` :145-470).

`BucketPlan` is computed once at `initialize()` from the gradient
leaves (their shapes and dtypes, in the JAX tree's leaf order, so every
bucket, offset and padding is JAX's): dtype-segregated flat buckets
capped by `reduce_bucket_size` elements, with per-leaf offsets.  Each
step the local fp32 gradients concatenate into the buckets (`flatten`)
and ride one collective per bucket (two for the split wire) instead of
one per leaf (`reduce`), then come apart again (`unflatten`).

Wire modes (what crosses between ranks):

* "fp32"  an fp32 all-reduce of the bucket (the default);
* "bf16"  the bucket cast to bf16 for the collective;
* "split" the EleutherAI 24-bit frexp wire with gather semantics: each
          rank's bucket decomposes into an fp16 mantissa + int8 exponent
          (`compressed_ar.decompose_int8_safe`), both all-gathered, then
          ldexp-reconstructed in fp32 and summed locally.

At ZeRO stage >= 2 the reduction is a reduce-scatter: each rank keeps
the 1/n chunk of a bucket; `OwnerExchange` then moves each element of
the chunks to the rank whose optimizer partition owns it
(runtime/zero/partition.py), one uneven all-to-all a bucket — the
placement XLA's sharding propagation makes after JAX's psum_scatter.
A gather-structured wire (split) stays all-reduce-lowered.

With a hierarchical data axis (comm/mesh.py; the ZeRO++ two-level
recipe) a bucket lowers per level: reduce-scatter over `data_inner`,
the inter-group collective over `data_outer` on the 1/inner shard with
its own wire, then an all-gather over `data_inner` — skipped at stage
>= 2, where the bucket stays sharded over `data_inner`, where the
optimizer partitions live.

Every collective adds its payload to a `bucket.*` counter (`_record`);
the engine adds `grad_wire.reduce` from `wire_bytes_per_reduction` /
`collectives_per_reduction` each reduction, so the two can be held
against each other.  Not ported: the int8/int4 wires
(`_quant_gather_sum`) and the overlapped lowering (`overlap_*`), ROADMAP
queue 1: the quantized wires.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ...comm import dist
from ...comm.mesh import DATA_AXIS
from ...monitor.counters import COUNTERS
from .compressed_ar import _ldexp, decompose_int8_safe
from .quant import (DEFAULT_BLOCK_SIZE, QUANT_WIRES, payload_bytes,
                    validate_block_size)

WIRE_MODES = ("fp32", "bf16", "split", "int8", "int4")

# wires that ride all-gather semantics (the narrow dtypes stay on the
# wire)
GATHER_WIRES = ("split",) + QUANT_WIRES

# bytes per element handed to the collective, per fixed-width wire
_WIRE_ITEMSIZE = {"fp32": 4, "bf16": 2, "split": 3}  # fp16 m + int8 e


def wire_nbytes(n_elems: int, wire: str, block: int, *,
                padded: bool = True) -> int:
    """Per-rank wire bytes for `n_elems` elements in `wire` mode;
    `padded=False` prices the logical payload (bucketing.py:96)."""
    if wire in QUANT_WIRES:
        return payload_bytes(n_elems, wire, block, padded=padded)
    return n_elems * _WIRE_ITEMSIZE[wire]


def _record(op: str, nbytes: int) -> None:
    COUNTERS.add(f"bucket.{op}", int(nbytes))


def refuse_quantized(wire: str, where: str = "comm.wire_dtype") -> None:
    if wire in QUANT_WIRES:
        raise NotImplementedError(
            f"{where}={wire!r}: the blockwise-quantized gradient wire is "
            f"not ported to deepspeed_tpu_torch yet (ROADMAP queue 1: the "
            f"explicit MoE wire and the quantized wires)")


class WireLevel(NamedTuple):
    """One level of a hierarchical reduction: the mesh axis it rides,
    the group size, and its wire mode."""

    axis: str
    size: int
    wire: str


class LeafSlot(NamedTuple):
    """Where one gradient leaf lives inside its bucket."""

    leaf_id: int          # index in the plan's leaf order
    offset: int           # element offset into the flat bucket
    size: int             # element count
    shape: Tuple[int, ...]


class BucketSpec(NamedTuple):
    dtype: Any            # torch dtype of the leaves in this bucket
    slots: Tuple[LeafSlot, ...]
    n_elems: int          # payload elements (sum of slot sizes)
    padded: int           # n_elems rounded up for reduce-scatter


class BucketPlan:
    """Static flat-bucket layout and the reduction that consumes it.

    `leaves`: tensors (or anything with `.shape` and `.dtype`) in the
    order the buckets fill, the JAX gradient tree's leaf order."""

    def __init__(self, leaves: Sequence, *, dp_size: int,
                 axis: str = DATA_AXIS, bucket_elems: int,
                 wire: str = "fp32", scatter: bool = False,
                 levels: Optional[Tuple[WireLevel, WireLevel]] = None,
                 quant_block: int = DEFAULT_BLOCK_SIZE):
        if wire not in WIRE_MODES:
            raise ValueError(
                f"unknown wire mode {wire!r}; choose from {WIRE_MODES}")
        if bucket_elems <= 0:
            raise ValueError(f"reduce_bucket_size must be > 0, "
                             f"got {bucket_elems}")
        refuse_quantized(wire)
        if levels is not None:
            inner, outer = levels[0], levels[1]
            for name, lvl in (("inner", inner), ("outer", outer)):
                if lvl.wire not in WIRE_MODES:
                    raise ValueError(
                        f"unknown {name}-level wire mode {lvl.wire!r}; "
                        f"choose from {WIRE_MODES}")
                refuse_quantized(lvl.wire, f"comm.wire_dtype_{name}")
            if inner.size * outer.size != int(dp_size):
                raise ValueError(
                    f"hierarchy levels {outer.size} x {inner.size} do not "
                    f"factor the data-parallel size {dp_size}")
            if inner.size <= 1 or outer.size <= 1:
                raise ValueError(
                    f"hierarchy levels must both be > 1 (got outer="
                    f"{outer.size}, inner={inner.size}); use a flat plan "
                    "for a single-level reduction")
            if inner.wire in GATHER_WIRES:
                raise ValueError(
                    f"the {inner.wire} wire is gather-structured and "
                    "cannot run the intra-group scatter level; use fp32 "
                    "or bf16 for the inner wire")
            self.levels: Optional[Tuple[WireLevel, WireLevel]] = \
                (inner, outer)
        else:
            self.levels = None
        if scatter and wire in GATHER_WIRES and levels is None:
            # a gather wire rebuilds the whole bucket on every rank
            scatter = False
        self.axis = axis
        self.dp_size = int(dp_size)
        self.wire = wire
        self.scatter = bool(scatter)
        self.bucket_elems = int(bucket_elems)
        self.quant_block = validate_block_size(quant_block)
        self._leaf_shapes = [tuple(int(n) for n in l.shape) for l in leaves]
        self._leaf_dtypes = [l.dtype for l in leaves]

        self.buckets: List[BucketSpec] = []
        open_by_dtype = {}  # dtype -> (slots, fill)
        for lid, (shape, dt) in enumerate(zip(self._leaf_shapes,
                                              self._leaf_dtypes)):
            size = int(np.prod(shape or (1,), dtype=np.int64))
            slots, fill = open_by_dtype.get(dt, ([], 0))
            if slots and fill + size > self.bucket_elems:
                self._close(dt, slots, fill)
                slots, fill = [], 0
            slots.append(LeafSlot(lid, fill, size, shape))
            fill += size
            open_by_dtype[dt] = (slots, fill)
            if fill >= self.bucket_elems:
                self._close(dt, slots, fill)
                open_by_dtype[dt] = ([], 0)
        for dt, (slots, fill) in open_by_dtype.items():
            if slots:
                self._close(dt, slots, fill)

        blk = self.quant_block
        if self.levels is not None:
            inner, outer = self.levels
            intra_legs = 1 if self.scatter else 2
            self.wire_bytes_intra_per_reduction = sum(
                wire_nbytes(b.padded, inner.wire, blk) * intra_legs
                for b in self.buckets)
            self.wire_bytes_intra_logical_per_reduction = sum(
                wire_nbytes(b.n_elems, inner.wire, blk, padded=False)
                * intra_legs for b in self.buckets)
            self.collectives_intra_per_reduction = (
                intra_legs * len(self.buckets))
            self.wire_bytes_inter_per_reduction = sum(
                wire_nbytes(b.padded // inner.size, outer.wire, blk)
                for b in self.buckets)
            self.wire_bytes_inter_logical_per_reduction = sum(
                wire_nbytes(-(-b.n_elems // inner.size), outer.wire, blk,
                            padded=False) for b in self.buckets)
            self.collectives_inter_per_reduction = (
                (2 if outer.wire == "split" else 1) * len(self.buckets))
            self.wire_bytes_per_reduction = (
                self.wire_bytes_intra_per_reduction
                + self.wire_bytes_inter_per_reduction)
            self.wire_bytes_logical_per_reduction = (
                self.wire_bytes_intra_logical_per_reduction
                + self.wire_bytes_inter_logical_per_reduction)
            self.collectives_per_reduction = (
                self.collectives_intra_per_reduction
                + self.collectives_inter_per_reduction)
        else:
            self.wire_bytes_per_reduction = sum(
                wire_nbytes(b.padded, self.wire, blk)
                for b in self.buckets)
            self.wire_bytes_logical_per_reduction = sum(
                wire_nbytes(b.n_elems, self.wire, blk, padded=False)
                for b in self.buckets)
            self.collectives_per_reduction = (
                (2 if self.wire == "split" else 1) * len(self.buckets))
            self.wire_bytes_intra_per_reduction = 0
            self.wire_bytes_inter_per_reduction = 0
            self.wire_bytes_intra_logical_per_reduction = 0
            self.wire_bytes_inter_logical_per_reduction = 0
            self.collectives_intra_per_reduction = 0
            self.collectives_inter_per_reduction = 0

    def _close(self, dtype, slots, fill):
        # scatter lowerings split a bucket into equal chunks
        chunks = 1
        if self.levels is not None:
            chunks = self.levels[0].size
        elif self.scatter:
            chunks = self.dp_size
        pad = -fill % chunks if chunks > 1 else 0
        self.buckets.append(BucketSpec(dtype, tuple(slots), fill,
                                       fill + pad))

    # -- layout ----------------------------------------------------------

    def flatten(self, grads) -> List[torch.Tensor]:
        """Leaves (plan order) -> flat buckets, zero-padded for the
        reduce-scatter lowering."""
        out = []
        for b in self.buckets:
            parts = [grads[s.leaf_id].reshape(-1) for s in b.slots]
            if b.padded > b.n_elems:
                parts.append(parts[0].new_zeros((b.padded - b.n_elems,)))
            out.append(torch.cat(parts) if len(parts) > 1 else parts[0])
        return out

    def unflatten(self, buckets) -> List[torch.Tensor]:
        """Flat (reduced) buckets -> leaves (plan order), as views."""
        leaves: List[Optional[torch.Tensor]] = [None] * len(self._leaf_shapes)
        for b, flat in zip(self.buckets, buckets):
            for s in b.slots:
                leaves[s.leaf_id] = flat[s.offset:s.offset + s.size].view(
                    s.shape)
        return leaves

    # -- reduction ---------------------------------------------------------

    def reduce(self, buckets) -> List[torch.Tensor]:
        """Mean-reduce each flat bucket over the data axis: one
        collective a bucket (two for the split wire).  Scatter plans
        return this rank's chunk of each bucket."""
        if self.levels is not None:
            return [self._reduce_one_hier(flat, b) for flat, b in
                    zip(buckets, self.buckets)]
        return [self._reduce_one(flat, b) for flat, b in
                zip(buckets, self.buckets)]

    @property
    def scatter_axis(self) -> str:
        """The axis whose ranks split a scattered bucket into chunks."""
        return self.levels[0].axis if self.levels is not None else self.axis

    @staticmethod
    def _split_gather_sum(x, n_elems: int, axis: str, prefix: str):
        """The 24-bit frexp wire (bucketing.py:339): fp16 mantissa + int8
        exponent of `x` all-gathered over `axis`, ldexp-reconstructed and
        summed locally in fp32."""
        mantissa, exponent = decompose_int8_safe(x)
        _record(f"{prefix}all_gather", n_elems * 2)
        m_all = dist.all_gather(mantissa, axis, tiled=False)
        _record(f"{prefix}all_gather", n_elems * 1)
        e_all = dist.all_gather(exponent.to(torch.int8), axis, tiled=False)
        return torch.sum(_ldexp(m_all.to(torch.float32),
                                e_all.to(torch.int32)), dim=0)

    def _reduce_one_hier(self, flat, spec: BucketSpec):
        """Two levels (bucketing.py:374): reduce-scatter over the inner
        group (the whole bucket), the outer collective on the 1/inner
        shard with its own wire, then an all-gather over the inner group
        (skipped at stage >= 2)."""
        inner, outer = self.levels
        isz_in = _WIRE_ITEMSIZE[inner.wire]
        shard_elems = spec.padded // inner.size
        wired = flat.to(torch.bfloat16 if inner.wire == "bf16"
                        else torch.float32)
        _record("intra.psum_scatter", spec.padded * isz_in)
        shard = dist.reduce_scatter(wired, inner.axis).to(torch.float32)
        if outer.wire == "split":
            shard = self._split_gather_sum(shard, shard_elems, outer.axis,
                                           "inter.")
        elif outer.wire == "bf16":
            _record("inter.psum", shard_elems * 2)
            shard = dist.all_reduce(shard.to(torch.bfloat16),
                                    outer.axis).to(torch.float32)
        else:
            _record("inter.psum", shard_elems * 4)
            shard = dist.all_reduce(shard, outer.axis)
        shard = shard / self.dp_size
        if self.scatter:
            return shard.to(flat.dtype)
        gathered = shard.to(torch.bfloat16) if inner.wire == "bf16" \
            else shard
        _record("intra.all_gather", spec.padded * isz_in)
        return dist.all_gather(gathered, inner.axis).to(flat.dtype)

    def _reduce_one(self, flat, spec: BucketSpec):
        axis, dp = self.axis, self.dp_size
        nbytes = wire_nbytes(spec.padded, self.wire, self.quant_block)
        if self.wire == "bf16":
            wired = flat.to(torch.bfloat16)
            if self.scatter:
                _record("psum_scatter", nbytes)
                red = dist.reduce_scatter(wired, axis)
            else:
                _record("psum", nbytes)
                red = dist.all_reduce(wired, axis)
            return red.to(flat.dtype) / dp
        if self.wire == "split":
            total = self._split_gather_sum(flat, spec.padded, axis, "")
            return (total / dp).to(flat.dtype)
        wired = flat.to(torch.float32)
        if self.scatter:
            _record("psum_scatter", nbytes)
            red = dist.reduce_scatter(wired, axis)
        else:
            _record("psum", nbytes)
            red = dist.all_reduce(wired, axis)
        return (red / dp).to(flat.dtype)

    # -- accounting ----------------------------------------------------------

    @property
    def n_leaves(self) -> int:
        return len(self._leaf_shapes)

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def hierarchical(self) -> bool:
        return self.levels is not None

    def account(self, events: int = 1) -> None:
        """`grad_wire.*` for `events` reductions (step_builder.py:114)."""
        COUNTERS.add("grad_wire.reduce",
                     self.wire_bytes_per_reduction * events,
                     calls=self.collectives_per_reduction * events)
        COUNTERS.add("grad_wire.reduce_logical",
                     self.wire_bytes_logical_per_reduction * events,
                     calls=self.collectives_per_reduction * events)
        if self.hierarchical:
            for name, nbytes, calls in (
                    ("intra", self.wire_bytes_intra_per_reduction,
                     self.collectives_intra_per_reduction),
                    ("intra_logical",
                     self.wire_bytes_intra_logical_per_reduction,
                     self.collectives_intra_per_reduction),
                    ("inter", self.wire_bytes_inter_per_reduction,
                     self.collectives_inter_per_reduction),
                    ("inter_logical",
                     self.wire_bytes_inter_logical_per_reduction,
                     self.collectives_inter_per_reduction)):
                COUNTERS.add(f"grad_wire.{name}", nbytes * events,
                             calls=calls * events)

    def describe(self) -> str:
        sizes = ", ".join(f"{b.n_elems}" + (f"+{b.padded - b.n_elems}pad"
                                            if b.padded > b.n_elems else "")
                          for b in self.buckets)
        lowering = "reduce-scatter" if self.scatter else "allreduce"
        if self.levels is not None:
            inner, outer = self.levels
            return (f"BucketPlan: {self.n_leaves} grad leaves -> "
                    f"{self.n_buckets} bucket(s) [{sizes}] elems, "
                    f"hierarchical ({lowering}): intra {inner.axis}="
                    f"{inner.size} wire={inner.wire} "
                    f"({self.wire_bytes_intra_per_reduction} B / "
                    f"{self.collectives_intra_per_reduction} coll), "
                    f"inter {outer.axis}={outer.size} wire={outer.wire} "
                    f"({self.wire_bytes_inter_per_reduction} B / "
                    f"{self.collectives_inter_per_reduction} coll) "
                    f"per reduction over dp={self.dp_size}")
        return (f"BucketPlan: {self.n_leaves} grad leaves -> "
                f"{self.n_buckets} bucket(s) [{sizes}] elems, "
                f"wire={self.wire} ({lowering}), "
                f"{self.wire_bytes_per_reduction} wire bytes / "
                f"{self.collectives_per_reduction} collective(s) per "
                f"reduction over dp={self.dp_size}")


class OwnerExchange:
    """After a scattered reduction, move each element of this rank's
    bucket chunks to the ranks whose optimizer partitions hold it.

    `partitions[leaf_id]` is the leaf's `zero.partition.LeafPartition`
    at this rank (plan leaf order); chunk and partition indices are the
    same axis (`plan.scatter_axis`).  For each bucket the plan is static
    and made once: the chunk elements each rank needs, in bucket order,
    sent by one uneven all-to-all.  A rank then holds, in bucket order,
    the elements of its owned slices — which, in the leaf's row-major
    order, ARE those slices — and the whole of every unsharded leaf."""

    def __init__(self, plan: BucketPlan, partitions, device):
        self.plan = plan
        self.axis = plan.scatter_axis
        self.parts = dist.get_world_size(self.axis)
        me = dist.get_rank(self.axis)
        self.exchanges = []   # per bucket: (send idx, send n, recv n)
        for b in plan.buckets:
            L = b.padded // self.parts
            need = [self._needed(b, partitions, q) for q in range(self.parts)]
            bounds = [np.searchsorted(n, [me * L, (me + 1) * L])
                      for n in need]
            send = np.concatenate([n[lo:hi] - me * L
                                   for n, (lo, hi) in zip(need, bounds)])
            mine = need[me]
            recv = np.diff(np.searchsorted(
                mine, np.arange(self.parts + 1) * L)).tolist()
            self.exchanges.append((
                torch.from_numpy(send.astype(np.int64)).to(device),
                [int(hi - lo) for lo, hi in bounds], recv))
        self.partitions = partitions

    @staticmethod
    def _needed(spec: BucketSpec, partitions, q: int) -> np.ndarray:
        """Sorted bucket indices partition q keeps (its slices of the
        sharded leaves, the whole of the rest)."""
        out = []
        for s in spec.slots:
            lp = partitions[s.leaf_id]
            if not lp.sharded:
                out.append(np.arange(s.offset, s.offset + s.size,
                                     dtype=np.int64))
                continue
            flat = np.arange(s.size, dtype=np.int64).reshape(s.shape)
            sl = [slice(None)] * len(s.shape)
            sl[lp.dim] = slice(q * lp.length, (q + 1) * lp.length)
            out.append(flat[tuple(sl)].reshape(-1) + s.offset)
        return np.concatenate(out) if out else np.zeros(0, np.int64)

    def owned(self, chunks) -> List[torch.Tensor]:
        """Reduced bucket chunks -> this rank's owned gradient of every
        leaf (plan order; owned-slice shaped)."""
        leaves: List[Optional[torch.Tensor]] = [None] * self.plan.n_leaves
        for b, chunk, (idx, send_n, recv_n) in zip(
                self.plan.buckets, chunks, self.exchanges):
            vals = dist.all_to_all_uneven(chunk.index_select(0, idx),
                                          send_n, recv_n, self.axis)
            off = 0
            for s in b.slots:
                shape = self.partitions[s.leaf_id].owned_shape
                n = int(np.prod(shape or (1,), dtype=np.int64))
                leaves[s.leaf_id] = vals[off:off + n].view(shape)
                off += n
        return leaves

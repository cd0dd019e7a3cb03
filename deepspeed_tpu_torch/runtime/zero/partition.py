"""ZeRO stages 1-3 as per-leaf partitions over the data ranks — the
port of deepspeed_tpu/runtime/zero/partition.py (`add_data_axis`
:62-87, `ZeroShardingPlan` :88-322, `QuantizedWeightGather` :324-446
and :567-580, `describe_reshard` :583).

JAX writes a stage as PartitionSpecs and lets XLA place the shards;
here the same specs decide which slice of each leaf a rank owns:

  stage 1  optimizer state (the Adam moments) partitioned
  stage 2  + gradients reduce-scattered to their owner
  stage 3  + parameters: a rank STORES only its slice of each sharded
           leaf (`LeafPartition.gathered`), and the whole leaf exists
           only while a gather for its use holds it
           (runtime/zero/stage3.py); the spec is JAX's `with_full_dp`
           (:132-156), the largest dimension divisible by the whole
           data width

The rule per leaf is JAX's: shard the largest dimension divisible by the
partition count, leave a leaf of fewer than `min_size_to_shard` (1024)
elements, or with no divisible dimension, whole on every rank.  A rank
owns the slice of each sharded leaf that JAX's NamedSharding gives its
data index: the `index`-th of `parts` equal slices along that dimension.

Hierarchical data axis (hpZ secondary shards, ZeRO++ arXiv:2306.10209):
when `comm.hierarchy` factors the data axis into outer × inner groups,
the partitions lie over `data_inner` only — the rank's inner index picks
its slice, and the outer groups hold replicas — so the post-step
parameter all-gather stays inside an inner group, where the two-level
wire's reduce-scatter leaves the gradients (runtime/comm/bucketing.py).

Expert parallelism (the explicit MoE wire, moe/dispatch.py): an expert
leaf's spec shards its expert dim over the expert axes (JAX
moe/layer.py:110-122: over `data`, which `_translate_data_axes`,
partition.py:169, narrows to `data_inner` under inner placement), and
`add_data_axis` leaves an already data-sharded leaf alone (:75).  The
engine keeps only a rank's El experts of such a leaf, so its partition
is `local`: the rank's tensor IS its slice, its optimizer state is the
owner's experts at every stage, and no post-step gather touches it.

Stage 3 keeps the data axis flat: the engine does not factor it
(JAX engine.py:623), and the plan refuses a hierarchical mesh there.

qwZ (`QuantizedWeightGather`): the stage-3 gather of a group of leaves
as ONE blockwise int8/int4 collective — kernel #11 over this rank's
compute-dtype slices, each zero-padded to whole blocks so every leaf
keeps JAX's own per-leaf blocks, one all-gather of the fused
payload+scales buffer, kernel #12 over every rank's row — priced per
leaf exactly as JAX prices it (`wire_bytes_per_gather`).  Not ported:
its overlap half (`overlap_layout` .. `build_overlap`, JAX :448-565;
ROADMAP queue 1: comm.overlap).

Specs are tuples with one entry a dimension (None, an axis name, or a
tuple of axis names), what `tuple(PartitionSpec(...))` gives in JAX.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ...comm import dist
from ...monitor.counters import COUNTERS
from ...comm.mesh import (DATA_AXIS, DATA_INNER_AXIS, DATA_OUTER_AXIS,
                          MeshInfo)

_DATA_AXIS_NAMES = (DATA_AXIS, DATA_INNER_AXIS, DATA_OUTER_AXIS)


def _spec_to_list(spec, ndim: int):
    out = [None] * ndim
    if spec is not None:
        for i, s in enumerate(spec):
            if i < ndim:
                out[i] = s
    return out


def add_data_axis(spec, shape, dp_size: int, min_size_to_shard: int = 1024,
                  axes: Sequence[str] = (DATA_AXIS,)) -> tuple:
    """Extend a spec with the data axis (`axes`: one axis name, or the
    hierarchical pair with `dp_size` their product) on the best free
    dimension; the spec unchanged if nothing divides (partition.py:62)."""
    dims = _spec_to_list(spec, len(shape))
    if dp_size <= 1 or math.prod(shape or (1,)) < min_size_to_shard:
        return tuple(dims)
    flat = [a for d in dims if d is not None
            for a in (d if isinstance(d, tuple) else (d,))]
    if any(a in flat for a in _DATA_AXIS_NAMES):
        return tuple(dims)
    best, best_len = None, 0
    for i, d in enumerate(shape):
        if dims[i] is None and d % dp_size == 0 and d > best_len:
            best, best_len = i, d
    if best is None:
        return tuple(dims)
    axes = tuple(axes)
    dims[best] = axes[0] if len(axes) == 1 else axes
    return tuple(dims)


def _sharded_dim(spec) -> Optional[int]:
    for i, d in enumerate(spec):
        names = d if isinstance(d, tuple) else (d,)
        if any(a in _DATA_AXIS_NAMES for a in names):
            return i
    return None


class LeafPartition(NamedTuple):
    """This rank's part of one leaf: `length` elements along `dim` from
    `start` (dim None: the whole leaf, on every rank).  `local`: the
    rank holds only that part (an expert leaf under the explicit MoE
    wire); `gathered`: the rank stores only that part and gathers the
    whole leaf on use (a stage-3 leaf); otherwise it holds the whole
    leaf and owns the part."""

    dim: Optional[int]
    parts: int
    index: int
    start: int
    length: int
    shape: Tuple[int, ...]
    local: bool = False
    gathered: bool = False

    @property
    def held_sliced(self) -> bool:
        """The rank's tensor for the leaf IS its slice."""
        return self.local or self.gathered

    @property
    def sharded(self) -> bool:
        return self.dim is not None

    @property
    def owned_shape(self) -> Tuple[int, ...]:
        if self.dim is None:
            return self.shape
        s = list(self.shape)
        s[self.dim] = self.length
        return tuple(s)

    def owned(self, t):
        """The owned slice of the tensor this rank holds for the leaf (a
        view; a local or gathered leaf's tensor is that slice already)."""
        return t if self.dim is None or self.held_sliced else \
            t.narrow(self.dim, self.start, self.length)

    def from_full(self, t):
        """This rank's part of the WHOLE leaf `t` (a restored checkpoint
        leaf), a view."""
        return t if self.dim is None else t.narrow(self.dim, self.start,
                                                   self.length)

    def piece_index(self, q: int) -> List[List[int]]:
        """[[start, stop] per dim] of partition q's slice — the `index`
        of a checkpoint piece (checkpointing.py `_split_sharded`)."""
        idx = [[0, int(n)] for n in self.shape]
        if self.dim is not None:
            idx[self.dim] = [q * self.length, (q + 1) * self.length]
        return idx


class ZeroShardingPlan:
    """Per-stage specs and per-leaf partitions for params / grads /
    optimizer state, made once at engine init from the leaves' shapes
    (`shapes`, in the engine's parameter order)."""

    def __init__(self, stage: int, mesh_info: MeshInfo, shapes,
                 min_size_to_shard: int = 1024, expert=None,
                 expert_axes: Sequence[str] = ()):
        """`shapes`: the whole leaves' shapes; `expert[i]`: leaf i is an
        expert leaf a rank holds only its experts of, sharded over
        `expert_axes` (the explicit MoE wire's)."""
        self.stage = int(stage)
        self.mesh_info = mesh_info
        self.min_size_to_shard = min_size_to_shard
        dp = mesh_info.axis_size(DATA_AXIS)
        if mesh_info.hierarchical:
            if self.stage >= 3:
                raise ValueError(
                    "ZeRO stage 3 keeps the flat data axis (parameter "
                    "sharding owns the layout): build the mesh without "
                    "comm.hierarchy")
            part_axes: Tuple[str, ...] = (DATA_INNER_AXIS,)
            part_size = mesh_info.data_inner_size
        else:
            part_axes = (DATA_AXIS,)
            part_size = dp
        self.partition_index = mesh_info.axis_index(part_axes[0])
        self.partition_axes = part_axes
        self.partition_size = part_size
        self.shapes = [tuple(int(n) for n in s) for s in shapes]
        self.expert = [bool(e) for e in (expert or [False] * len(shapes))]
        self.expert_axes = tuple(expert_axes)
        ep, e_index = mesh_info.axes_extent(self.expert_axes)
        self.expert_parallel = ep
        e_spec = (self.expert_axes[0] if len(self.expert_axes) == 1
                  else self.expert_axes)

        base = [((e_spec,) + (None,) * (len(s) - 1)) if is_exp
                else tuple([None] * len(s))
                for s, is_exp in zip(self.shapes, self.expert)]
        with_partition = [add_data_axis(b, s, part_size,
                                        min_size_to_shard, axes=part_axes)
                          for b, s in zip(base, self.shapes)]
        # stage 3: the parameters too, over the whole (flat) data axis —
        # JAX's with_full_dp, the same spec as the partitions here
        self.param_spec = with_partition if self.stage >= 3 else base
        self.grad_spec = with_partition if self.stage >= 2 else base
        self.opt_spec = with_partition if self.stage >= 1 else base
        self.leaves = []
        for shape, spec, is_exp in zip(self.shapes, self.opt_spec,
                                       self.expert):
            dim = _sharded_dim(spec)
            if is_exp:
                n = shape[0] // ep
                self.leaves.append(LeafPartition(0, ep, e_index,
                                                 e_index * n, n, shape,
                                                 local=True))
            elif dim is None:
                self.leaves.append(LeafPartition(None, 1, 0, 0, 0, shape))
            else:
                n = shape[dim] // part_size
                q = self.partition_index
                self.leaves.append(LeafPartition(
                    dim, part_size, q, q * n, n, shape,
                    gathered=self.stage >= 3))

    @property
    def partitioned(self) -> bool:
        """True when a rank owns part of a leaf it holds whole (ZeRO's
        partitions; the local expert leaves are not counted)."""
        return any(leaf.sharded and not leaf.local for leaf in self.leaves)

    @property
    def gathered(self) -> List[int]:
        """The indices of the leaves a rank stores as its slice and
        gathers whole on use (stage 3)."""
        return [i for i, lp in enumerate(self.leaves) if lp.gathered]

    @property
    def expert_local(self) -> bool:
        """True when a rank holds only its experts of some leaf."""
        return any(leaf.local for leaf in self.leaves)

    @property
    def expert_group_axis(self) -> str:
        """The axis whose ranks hold distinct experts: `data_inner` under
        inner placement, the whole data axis otherwise."""
        return (DATA_INNER_AXIS if self.expert_axes == (DATA_INNER_AXIS,)
                else DATA_AXIS)

    @property
    def expert_replica_axis(self) -> Optional[str]:
        """The axis the experts are replicated over (`data_outer` under
        inner placement), whose ranks sum the expert gradients; None when
        every rank holds distinct experts."""
        return (DATA_OUTER_AXIS if self.expert_axes == (DATA_INNER_AXIS,)
                else None)

    @torch.no_grad()
    def all_gather_slices(self, full, owned, dtype) -> None:
        """Every partition's slices of the sharded leaves into `full`
        (leaf tensors, plan order) from `owned` (this rank's slices), as
        ONE all-gather in `dtype` over the partition group; this rank's
        own slices are left as they are."""
        sharded = [i for i, lp in enumerate(self.leaves)
                   if lp.sharded and not lp.held_sliced]
        if not sharded:
            return
        flat = torch.cat([owned[i].to(dtype).reshape(-1) for i in sharded])
        rows = dist.all_gather(flat, self.partition_axes[0], tiled=False)
        for q in range(rows.shape[0]):
            if q == self.partition_index:
                continue
            off = 0
            for i in sharded:
                lp = self.leaves[i]
                n = owned[i].numel()
                full[i].narrow(lp.dim, q * lp.length, lp.length).copy_(
                    rows[q, off:off + n].view(lp.owned_shape))
                off += n

    def gather_whole(self, indices, owned, dtype) -> list:
        """The whole leaves `indices` from every rank's slices (`owned`:
        this rank's slices of those leaves, in that order), in `dtype`,
        by ONE all-gather of their concatenation over the partition
        group; each whole leaf is a fresh contiguous tensor."""
        flat = torch.cat([o.detach().to(dtype).reshape(-1) for o in owned])
        rows = dist.all_gather(flat, self.partition_axes[0], tiled=False)
        return reassemble_rows(rows, [self.leaves[i] for i in indices],
                               [o.numel() for o in owned])

    def partition_layout(self) -> dict:
        """What a checkpoint records for resharding on restore
        (partition.py:288)."""
        mi = self.mesh_info
        return {
            "zero_stage": self.stage,
            "dp_world_size": mi.axis_size(DATA_AXIS),
            "data_outer": mi.data_outer_size if mi.hierarchical else 1,
            "data_inner": (mi.data_inner_size if mi.hierarchical
                           else mi.axis_size(DATA_AXIS)),
            "partition_size": self.partition_size,
            "hierarchical": bool(mi.hierarchical),
        }

    def describe(self) -> str:
        n_total = len(self.opt_spec)
        n_shard = sum(_sharded_dim(s) is not None for s in self.opt_spec)
        where = (f"{self.partition_size} intra-group shards "
                 f"(hpZ: replicated across "
                 f"{self.mesh_info.data_outer_size} outer groups)"
                 if self.mesh_info.hierarchical
                 else f"{self.partition_size} shards")
        n_exp = sum(self.expert)
        experts = (f"; {n_exp} expert tensors sharded over "
                   f"{'/'.join(self.expert_axes)} (ep="
                   f"{self.expert_parallel})" if n_exp else "")
        return (f"ZeRO stage {self.stage}: {n_shard - n_exp}/"
                f"{n_total - n_exp} tensors dp-sharded over {where}"
                f"{experts}")


def reassemble_rows(rows, parts, sizes, offsets=None) -> list:
    """Whole leaves from gathered rows [world, n]: leaf j's slices sit in
    columns [offsets[j], offsets[j] + sizes[j]) of every rank's row, and
    rank q's slice lies at q * length along the leaf's dimension (JAX's
    `moveaxis(deq, 0, dim)` reassembly, partition.py:425-428).  Each
    leaf is copied once into a fresh contiguous tensor."""
    world = rows.shape[0]
    out = []
    off = 0
    for j, (lp, n) in enumerate(zip(parts, sizes)):
        o = off if offsets is None else offsets[j]
        off = o + n
        full = torch.empty(lp.shape, dtype=rows.dtype, device=rows.device)
        split = lp.shape[:lp.dim] + (world, lp.length) + \
            lp.shape[lp.dim + 1:]
        full.view(split).copy_(
            rows[:, o:o + n].view((world,) + lp.owned_shape)
            .movedim(0, lp.dim))
        out.append(full)
    return out


class QuantizedWeightGather:
    """qwZ (ZeRO++ arXiv:2306.10209; JAX partition.py:324-446): the
    stage-3 parameter gather rides blockwise int8/int4 payloads plus
    fp16 scales instead of full-width weights, and every rank
    dequantizes right after the gather.  The fp32 masters and the
    optimizer's update of them stay full precision: only the
    compute-side replica the forward and backward read is
    quantize-roundtripped.

    The placements are JAX's (each leaf whose parameter spec carries the
    data axis, at its dimension; an expert leaf a rank keeps only its
    experts of is not gathered), and so are the bytes: a leaf's slice is
    zero-padded to whole blocks and priced `payload_bytes(slice)`.  The
    port gathers a GROUP of leaves (a model block) at a time, as one
    collective (`gather_leaves`): `collectives_per_gather` counts the
    groups holding a quantized leaf (JAX issues one a leaf)."""

    def __init__(self, plan: ZeroShardingPlan, *, wire: str = "int8",
                 block: int = 256, groups: Optional[Sequence] = None):
        from ..comm.quant import payload_bytes, qmax, validate_block_size

        qmax(wire)  # validates the wire name
        self.wire = wire
        self.block = validate_block_size(block)
        self.plan = plan
        self._placements = []
        self.leaf_bytes = []
        for shape, spec, lp in zip(plan.shapes, plan.param_spec,
                                   plan.leaves):
            dim = _sharded_dim(spec) if lp.gathered else None
            if dim is None:
                self._placements.append((None, (), shape))
                self.leaf_bytes.append(0)
                continue
            self._placements.append((dim, plan.partition_axes, shape))
            local = math.prod(shape) // plan.partition_size
            # one hop: the flat data axis (the stage-3 mesh is flat)
            self.leaf_bytes.append(payload_bytes(local, wire, self.block))
        self.n_quantized_leaves = sum(b > 0 for b in self.leaf_bytes)
        self.wire_bytes_per_gather = sum(self.leaf_bytes)
        quantized = set(i for i, b in enumerate(self.leaf_bytes) if b)
        groups = [list(range(len(plan.leaves)))] if groups is None \
            else groups
        self.collectives_per_gather = sum(
            1 for g in groups if quantized.intersection(g))

    @property
    def active(self) -> bool:
        return self.n_quantized_leaves > 0

    def gather_leaves(self, indices, slices, out_dtype) -> list:
        """The whole leaves `indices` from every rank's `slices` (this
        rank's compute-dtype slices of them, in that order): each slice
        zero-padded to whole blocks and concatenated, ONE #11 launch, one
        all-gather of the fused buffer, ONE #12 launch over every rank's
        row (to `out_dtype`, JAX's `.astype(x.dtype)` after the
        dequantize), then the reassembly.  The buffer's bytes (the sum of
        the group's `leaf_bytes`) go to the `qwz.gather` counter."""
        from ..comm.quant import padded_elems, quantized_all_gather

        flats, offsets, sizes, off = [], [], [], 0
        for x in slices:
            n = x.numel()
            pad = padded_elems(n, self.block) - n
            flat = x.reshape(-1)
            flats.append(torch.cat([flat, flat.new_zeros(pad)]) if pad
                         else flat)
            offsets.append(off)
            sizes.append(n)
            off += n + pad
        buf = torch.cat(flats) if len(flats) > 1 else flats[0]
        rows = quantized_all_gather(
            buf, self.plan.partition_axes, self.block, self.wire,
            record=lambda nbytes: COUNTERS.add("qwz.gather", nbytes),
            out_dtype=out_dtype)
        return reassemble_rows(rows, [self.plan.leaves[i] for i in indices],
                               sizes, offsets)

    def describe(self) -> str:
        return (f"qwZ quantized weight gather: {self.n_quantized_leaves} "
                f"stage-3 leaves ride {self.wire} blocks of {self.block} "
                f"(+fp16 scales), {self.wire_bytes_per_gather} wire bytes "
                f"/ {self.collectives_per_gather} collective(s) per "
                f"gather; master weights stay full precision")


def describe_reshard(saved: Optional[dict], current: dict,
                     reason: Optional[str] = None) -> Optional[str]:
    """A checkpoint topology transition in words, or None when the saved
    and restoring layouts match (partition.py:583)."""
    if not saved:
        return None

    def fmt(lay: dict) -> str:
        dp = lay.get("dp_world_size", "?")
        outer = int(lay.get("data_outer", 1) or 1)
        hier = (f"hierarchy {outer}x{lay.get('data_inner', '?')}"
                if outer > 1 else "flat")
        return f"dp={dp} ({hier}), ZeRO stage {lay.get('zero_stage', '?')}"

    keys = ("zero_stage", "dp_world_size", "data_outer", "data_inner")
    if all(saved.get(k) == current.get(k) for k in keys):
        return None
    return (f"resharding checkpoint state: saved at {fmt(saved)} -> "
            f"restoring at {fmt(current)} (ZeRO-1/2 partitions, including "
            f"hpZ secondary shards, re-partition to the new layout on "
            f"load)"
            + (f" [elastic trigger: {reason}]" if reason else ""))

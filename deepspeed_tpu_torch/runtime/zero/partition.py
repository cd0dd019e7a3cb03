"""ZeRO stages 1 and 2 as per-leaf partitions over the data ranks — the
port of deepspeed_tpu/runtime/zero/partition.py (`add_data_axis`
:62-87, `ZeroShardingPlan` :88-322, `describe_reshard` :583).

JAX writes a stage as PartitionSpecs and lets XLA place the shards;
here the same specs decide which slice of each leaf a rank owns:

  stage 1  optimizer state (the Adam moments) partitioned
  stage 2  + gradients reduce-scattered to their owner

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

Specs are tuples with one entry a dimension (None, an axis name, or a
tuple of axis names), what `tuple(PartitionSpec(...))` gives in JAX.
Not ported: stage 3's parameter sharding and `QuantizedWeightGather`
(qwZ; ROADMAP queue 1: the quantized wires).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ...comm import dist
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
    `start` (dim None: the whole leaf, on every rank)."""

    dim: Optional[int]
    parts: int
    index: int
    start: int
    length: int
    shape: Tuple[int, ...]

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
        """The owned slice of a leaf-shaped tensor (a view)."""
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
                 min_size_to_shard: int = 1024):
        self.stage = int(stage)
        self.mesh_info = mesh_info
        self.min_size_to_shard = min_size_to_shard
        dp = mesh_info.axis_size(DATA_AXIS)
        if mesh_info.hierarchical:
            part_axes: Tuple[str, ...] = (DATA_INNER_AXIS,)
            part_size = mesh_info.data_inner_size
        else:
            part_axes = (DATA_AXIS,)
            part_size = dp
        self.partition_index = mesh_info.axis_index(part_axes[0])
        self.partition_axes = part_axes
        self.partition_size = part_size
        self.shapes = [tuple(int(n) for n in s) for s in shapes]

        replicated = [tuple([None] * len(s)) for s in self.shapes]
        with_partition = [add_data_axis(None, s, part_size,
                                        min_size_to_shard, axes=part_axes)
                          for s in self.shapes]
        self.param_spec = replicated
        self.grad_spec = with_partition if self.stage >= 2 else replicated
        self.opt_spec = with_partition if self.stage >= 1 else replicated
        self.leaves = []
        for shape, spec in zip(self.shapes, self.opt_spec):
            dim = _sharded_dim(spec)
            if dim is None:
                self.leaves.append(LeafPartition(None, 1, 0, 0, 0, shape))
            else:
                n = shape[dim] // part_size
                q = self.partition_index
                self.leaves.append(LeafPartition(dim, part_size, q, q * n, n,
                                                 shape))

    @property
    def partitioned(self) -> bool:
        """True when a rank owns part of the optimizer state."""
        return any(leaf.sharded for leaf in self.leaves)

    @torch.no_grad()
    def all_gather_slices(self, full, owned, dtype) -> None:
        """Every partition's slices of the sharded leaves into `full`
        (leaf tensors, plan order) from `owned` (this rank's slices), as
        ONE all-gather in `dtype` over the partition group; this rank's
        own slices are left as they are."""
        sharded = [i for i, lp in enumerate(self.leaves) if lp.sharded]
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
        return (f"ZeRO stage {self.stage}: {n_shard}/{n_total} tensors "
                f"dp-sharded over {where}")


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

"""The data axis as process groups — the data-axis part of
deepspeed_tpu/comm/mesh.py (`MeshInfo` :71-146, `_resolve_sizes` :150,
`derive_data_outer` :173, `largest_divisible_axis` :344).

JAX lays every parallelism axis over one `jax.sharding.Mesh`; here the
one axis the port runs, `data`, is the set of `torch.distributed`
ranks, and a collective over an axis is a collective over that axis's
process group (`MeshInfo.group`):

    data         every rank (the default group)
    data_outer   ranks {i, i + inner, i + 2·inner, ...}: one per node
    data_inner   ranks [o·inner, (o+1)·inner): the ranks of one node

`data_outer` × `data_inner` exist only when `comm.hierarchy` factors the
axis, for the two consumers that ride it: the ZeRO++ two-level gradient
wire (runtime/comm/bucketing.py) and the explicit MoE expert exchange
(moe/dispatch.py: two hops, or one over `data_inner` under inner
placement).  Rank r has
outer index r // inner and inner index r % inner, outer-major as the JAX
mesh lays its devices, so "auto" — one outer group per node, the
`LOCAL_WORLD_SIZE` ranks of a node inner — is JAX's one outer group per
process.  Without a process group the mesh is one rank and has no
groups: every collective over it is the identity.

Model, pipe and seq axes above 1 are not ported (ROADMAP queue 1:
tensor and sequence parallelism; pipeline).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch.distributed as tdist

from ..utils.logging import logger

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
DATA_OUTER_AXIS = "data_outer"
DATA_INNER_AXIS = "data_inner"

AXIS_ORDER = (PIPE_AXIS, DATA_AXIS, SEQ_AXIS, MODEL_AXIS)

_CURRENT_MESH: Optional["MeshInfo"] = None


@dataclass
class MeshInfo:
    """The axis sizes, this rank's place on them and its process groups
    (the counterpart of the JAX MeshInfo over a device mesh)."""

    axis_sizes: Dict[str, int] = field(default_factory=dict)
    # (outer, inner) factorization of the data axis; None when flat.
    # axis_sizes keeps the LOGICAL "data" size (the product).
    data_hierarchy: Optional[Tuple[int, int]] = None
    rank: int = 0
    # axis name -> this rank's process group over it (none at one rank)
    groups: Dict[str, object] = field(default_factory=dict)

    def axis_size(self, axis: str) -> int:
        if self.data_hierarchy is not None:
            if axis == DATA_OUTER_AXIS:
                return self.data_hierarchy[0]
            if axis == DATA_INNER_AXIS:
                return self.data_hierarchy[1]
        return self.axis_sizes.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along `axis` (JAX's lax.axis_index)."""
        if axis == DATA_OUTER_AXIS:
            return self.rank // self.data_inner_size
        if axis == DATA_INNER_AXIS:
            return self.rank % self.data_inner_size
        return self.rank if axis == DATA_AXIS else 0

    def group(self, axis: str):
        """The process group of `axis`, or None (one rank, no group)."""
        return self.groups.get(axis)

    @property
    def hierarchical(self) -> bool:
        return self.data_hierarchy is not None

    def axes_extent(self, axes: Sequence[str]) -> Tuple[int, int]:
        """(the product of `axes`' sizes, this rank's rank-major index over
        them): the width and this rank's shard of a dim sharded over
        `axes`, as a NamedSharding lays it."""
        size, index = 1, 0
        for a in axes:
            n = self.axis_size(a)
            size, index = size * n, index * n + self.axis_index(a)
        return size, index

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """The axes the data dimension lives on, outermost first:
        ("data",) flat, ("data_outer", "data_inner") factored (mesh.py:105)."""
        if self.data_hierarchy is not None:
            return (DATA_OUTER_AXIS, DATA_INNER_AXIS)
        return (DATA_AXIS,)

    @property
    def data_outer_size(self) -> int:
        return self.data_hierarchy[0] if self.data_hierarchy else 1

    @property
    def data_inner_size(self) -> int:
        return (self.data_hierarchy[1] if self.data_hierarchy
                else self.axis_size(DATA_AXIS))


def _resolve_sizes(n_devices: int, sizes: Dict[str, int]) -> Dict[str, int]:
    """Resolve -1 ("take the rest") axis sizes against the rank count."""
    resolved = {a: int(sizes.get(a, 1)) for a in AXIS_ORDER}
    free = [a for a, s in resolved.items() if s == -1]
    fixed = int(math.prod(s for s in resolved.values() if s != -1))
    if n_devices % fixed != 0:
        raise ValueError(
            f"device count {n_devices} not divisible by fixed axis product "
            f"{fixed} (sizes={sizes})")
    rest = n_devices // fixed
    if not free:
        if fixed != n_devices:
            raise ValueError(
                f"axis sizes {resolved} use {fixed} devices but {n_devices} "
                f"are present")
    elif len(free) == 1:
        resolved[free[0]] = rest
    else:
        raise ValueError("at most one axis size may be -1")
    return resolved


def _world() -> Tuple[int, int]:
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size(), tdist.get_rank()
    return 1, 0


def derive_data_outer(dp_size: int) -> int:
    """The outer factor of `comm.hierarchy: "auto"`: one outer group per
    node (`LOCAL_WORLD_SIZE` ranks each), as JAX takes one per process.
    1 (flat) when a two-level wire cannot win: one node, dp not
    divisible by the node count, or one rank a node."""
    world, _ = _world()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world) or world)
    nodes = max(1, world // max(1, local))
    if nodes <= 1 or dp_size % nodes != 0 or dp_size // nodes <= 1:
        return 1
    return nodes


def make_mesh(data: int = -1, model: int = 1, pipe: int = 1, seq: int = 1,
              data_outer: int = 1, set_current: bool = True) -> MeshInfo:
    """The mesh over the `torch.distributed` world (one rank without a
    process group).  Every rank must call it, in the same order, since
    the hierarchy's groups are made collectively."""
    world, rank = _world()
    sizes = _resolve_sizes(world, {DATA_AXIS: data, MODEL_AXIS: model,
                                   PIPE_AXIS: pipe, SEQ_AXIS: seq})
    for ax, item in ((MODEL_AXIS, "tensor and sequence parallelism"),
                     (SEQ_AXIS, "tensor and sequence parallelism"),
                     (PIPE_AXIS, "pipeline")):
        if sizes[ax] > 1:
            raise NotImplementedError(
                f"mesh axis {ax!r} of size {sizes[ax]}: not ported to "
                f"deepspeed_tpu_torch yet (ROADMAP queue 1: {item})")
    dp = sizes[DATA_AXIS]
    hierarchy = None
    data_outer = int(data_outer)
    if data_outer > 1:
        if dp % data_outer != 0:
            raise ValueError(
                f"data axis hierarchy: data_outer={data_outer} does not "
                f"divide the data-parallel size {dp} (data_inner would be "
                f"{dp / data_outer:g})")
        if dp // data_outer == 1:
            logger.debug(f"data hierarchy ({data_outer}, 1) is degenerate; "
                         "using the flat data axis")
        else:
            hierarchy = (data_outer, dp // data_outer)
    groups = {}
    if tdist.is_available() and tdist.is_initialized():
        groups[DATA_AXIS] = tdist.group.WORLD
        if hierarchy is not None:
            outer, inner = hierarchy
            for o in range(outer):       # every rank makes every group
                g = tdist.new_group(list(range(o * inner, (o + 1) * inner)))
                if rank // inner == o:
                    groups[DATA_INNER_AXIS] = g
            for i in range(inner):
                g = tdist.new_group(list(range(i, dp, inner)))
                if rank % inner == i:
                    groups[DATA_OUTER_AXIS] = g
    info = MeshInfo(axis_sizes=sizes, data_hierarchy=hierarchy, rank=rank,
                    groups=groups)
    if set_current:
        set_current_mesh(info)
    return info


def set_current_mesh(info: Optional[MeshInfo]) -> None:
    global _CURRENT_MESH
    _CURRENT_MESH = info


def peek_mesh() -> Optional[MeshInfo]:
    """The current mesh or None; never makes one (mesh.py:319)."""
    return _CURRENT_MESH


def get_current_mesh() -> MeshInfo:
    global _CURRENT_MESH
    if _CURRENT_MESH is None:
        _CURRENT_MESH = make_mesh(set_current=False)
    return _CURRENT_MESH


def largest_divisible_axis(shape: Sequence[int], size: int) -> Optional[int]:
    """The best dimension to shard `size`-ways: the largest dim divisible
    by `size` (ties -> earliest); None if nothing divides."""
    best, best_len = None, 0
    for i, d in enumerate(shape):
        if size > 0 and d % size == 0 and d > best_len:
            best, best_len = i, d
    return best

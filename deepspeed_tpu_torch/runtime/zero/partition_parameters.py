"""ZeRO-3's parameter-partitioning surface — the port of
deepspeed_tpu/runtime/zero/partition_parameters.py (`Init` :30-89,
`GatheredParameters` :92-126; the reference's partition_parameters.py
:265 and :1002).

`Init` materialises a model's stage-3 leaves as this rank's slices: the
model is built on the CPU, each leaf the stage-3 plan shards is cut to
the rank's slice, and only the slice moves to the card, so no whole
sharded leaf ever sits there.  A sliced parameter carries `ds_shape`
(its whole shape) and `ds_partition` (its `LeafPartition`), which the
engine reads instead of slicing again.

`GatheredParameters` gathers such parameters whole for its body (one
all-gather over the data ranks) and cuts them back to the slices on
exit: with `modifier_rank`, that rank's whole values are broadcast
first, so its edits survive; without, the edits are discarded and the
slices stay as they were (the reference's read-only gather).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ...comm import dist
from ...comm.mesh import DATA_AXIS, MeshInfo, make_mesh, peek_mesh
from ...utils.device import resolve_device
from ...utils.logging import log_dist
from .partition import ZeroShardingPlan, reassemble_rows


def _mesh(mesh_info: Optional[MeshInfo]) -> MeshInfo:
    return mesh_info or peek_mesh() or make_mesh(set_current=False)


def _partitioned(params):
    """The parameters among `params` (a module, one parameter or an
    iterable of them) that hold a stage-3 slice."""
    if isinstance(params, torch.nn.Module):
        params = list(params.parameters())
    elif torch.is_tensor(params):
        params = [params]
    return [p for p in params if hasattr(p, "ds_partition")]


class Init:
    """Materialise parameters as this rank's stage-3 slices (reference
    zero.Init :265).

        with zero.Init(mesh_info=info) as zinit:
            model = zinit.materialize(lambda: GPT(cfg, device="cpu"))

    `materialize(build, *args)` runs `build(*args)` (which builds the
    model on the CPU), then `partition`s it; `Init(module=model)`
    partitions a model built already.  The slices go to `device` (the
    card by default), or stay on the host with `remote_device="cpu"`;
    leaves the plan keeps whole go to `device`.  `pin_memory`,
    `data_parallel_group`, `mem_efficient_linear`, `deepspeed_config`
    and `param_dict` are accepted for API parity."""

    def __init__(self, module=None, data_parallel_group=None,
                 mem_efficient_linear=True, remote_device: Optional[str] = None,
                 pin_memory: bool = False, deepspeed_config=None,
                 param_dict=None, enabled: bool = True,
                 mesh_info: Optional[MeshInfo] = None, device="cuda"):
        self.enabled = enabled
        self.mesh_info = mesh_info
        self.remote_device = remote_device
        self.device = device
        self._plan = None
        if module is not None and enabled:
            self.partition(module)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def materialize(self, build: Callable, *args):
        """`build(*args)` (a model built on the CPU), partitioned."""
        model = build(*args)
        return self.partition(model) if self.enabled else model

    @torch.no_grad()
    def partition(self, model):
        """Cut `model`'s stage-3 leaves to this rank's slices in place
        (each cut on the host, then moved); returns the model."""
        mesh = _mesh(self.mesh_info)
        named = list(model.named_parameters())
        plan = ZeroShardingPlan(3, mesh, [tuple(p.shape) for _, p in named])
        self._plan = plan
        dev = resolve_device(self.device)
        host = self.remote_device == "cpu"
        for (name, p), lp in zip(named, plan.leaves):
            if lp.gathered:
                piece = lp.from_full(p.data.cpu()).clone()
                data = piece if host else piece.to(dev)
            else:
                data = p.data.to(dev)
            # a new parameter on the owning module: `.data` cannot take
            # every device change
            new = torch.nn.Parameter(data, requires_grad=p.requires_grad)
            if lp.gathered:
                new.ds_shape = torch.Size(lp.shape)
                new.ds_partition = lp
            mod, _, attr = name.rpartition(".")
            model.get_submodule(mod)._parameters[attr] = new
        log_dist(f"zero.Init: {len(plan.gathered)} parameters materialized "
                 f"as this rank's slices (stage-3 plan over "
                 f"{plan.partition_size} ranks)", ranks=[0])
        return model

    @property
    def plan(self) -> Optional[ZeroShardingPlan]:
        return self._plan


class GatheredParameters:
    """Gather partitioned parameters whole for the body (reference
    partition_parameters.py:1002).

        with zero.GatheredParameters(model.parameters(), modifier_rank=0):
            ...   # whole values; rank 0's edits are kept

    A collective on entry (one all-gather) and, with `modifier_rank`, on
    exit (a broadcast a parameter): every rank enters together.
    `g.params` lists the gathered parameters."""

    def __init__(self, params, modifier_rank: Optional[int] = None,
                 fwd_module=None, enabled: bool = True,
                 mesh_info: Optional[MeshInfo] = None):
        self.enabled = enabled
        self.modifier_rank = modifier_rank
        self.mesh_info = mesh_info
        self.params = _partitioned(params) if enabled else []
        self._slices = None

    def _group(self):
        mesh = self.mesh_info or peek_mesh()
        return None if mesh is None else mesh.group(DATA_AXIS)

    @torch.no_grad()
    def __enter__(self):
        if not self.params:
            return self
        self._slices = [p.data for p in self.params]
        flat = torch.cat([s.reshape(-1) for s in self._slices])
        rows = dist.all_gather(flat, self._group(), tiled=False)
        whole = reassemble_rows(rows, [p.ds_partition for p in self.params],
                                [s.numel() for s in self._slices])
        for p, w in zip(self.params, whole):
            p.data = w
        return self

    @torch.no_grad()
    def __exit__(self, exc_type, *exc):
        if not self.params:
            return False
        for p, old in zip(self.params, self._slices):
            lp = p.ds_partition
            if self.modifier_rank is None or exc_type is not None:
                p.data = old
                continue
            whole = dist.broadcast(p.data, self._group(),
                                   src=self.modifier_rank)
            p.data = lp.from_full(whole).clone()
        self._slices = None
        return False

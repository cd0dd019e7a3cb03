"""Process bootstrap and collectives over `torch.distributed` — the port
of deepspeed_tpu/comm/dist.py (:36-232).

JAX's collectives are `jax.lax` ops over a named mesh axis inside
`shard_map`; here they are `torch.distributed` calls over a process
group.  `group` is an axis name of the current mesh ("data",
"data_outer", "data_inner"; comm/mesh.py), a process group, or None for
every rank.  A group of one rank without a process group (a world-1 run
that never called `init_distributed`) makes every collective the
identity.  Each call adds its input's bytes to the `dist.<kind>` counter
(`_record_volume`, :155); JAX counts once per traced program, the port
once per call.

The backend follows the device, chosen explicitly: `nccl` for CUDA,
`gloo` for the CPU.  `gloo` over CUDA tensors runs only when the caller
names it; nothing switches from one backend to the other by itself.
The rendezvous is `env://` (MASTER_ADDR / MASTER_PORT, WORLD_SIZE,
RANK) or an `init_method` the caller passes (`file://<path>`, or a
`tcp://` address).

`all_reduce` reduces in place and returns its input; every other
collective returns a new tensor.  `ppermute` and `all_to_all` wait for
their own work items only.  The quantized wires' fused uint8 buffers
(runtime/comm/quant.py `pack_wire`) ride `all_gather` and `all_to_all`
as int8 views of the same bytes (`_as_sendable`).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as tdist

from ..monitor.counters import COUNTERS
from ..utils.logging import logger
from . import mesh as mesh_mod

TORCH_DISTRIBUTED_DEFAULT_PORT = 29500

_INITIALIZED = False


class ReduceOp:
    """torch.distributed.ReduceOp parity (the JAX package's names)."""

    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"
    PROD = "prod"


_TORCH_OPS = {ReduceOp.SUM: tdist.ReduceOp.SUM,
              ReduceOp.MAX: tdist.ReduceOp.MAX,
              ReduceOp.MIN: tdist.ReduceOp.MIN,
              ReduceOp.PROD: tdist.ReduceOp.PRODUCT}


# ---------------------------------------------------------------------------
# bootstrap (reference deepspeed.init_distributed)
# ---------------------------------------------------------------------------

def backend_for(device, dist_backend: Optional[str] = None) -> str:
    """`nccl` for a CUDA device and `gloo` for the CPU, unless the caller
    names one; NCCL cannot carry CPU tensors."""
    dev = torch.device(device)
    if dist_backend is None:
        return "nccl" if dev.type == "cuda" else "gloo"
    backend = str(dist_backend).lower()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"dist_backend must be 'nccl' or 'gloo', got "
                         f"{dist_backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend carries CUDA tensors only; use "
                         "gloo on the CPU")
    return backend


def init_distributed(dist_backend: Optional[str] = None,
                     auto_mpi_discovery: bool = True,
                     distributed_port: int = TORCH_DISTRIBUTED_DEFAULT_PORT,
                     verbose: bool = True, timeout=None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, device="cuda") -> None:
    """Join the process group (dist.py:36).  Discovery order: an explicit
    `init_method` (with `world_size` / `rank`, or WORLD_SIZE / RANK from
    the environment), then MASTER_ADDR (`env://`), then OpenMPI's
    OMPI_COMM_WORLD_SIZE / _RANK with a rendezvous on MASTER_ADDR or
    127.0.0.1 at `distributed_port`.  With none of them it is a no-op:
    one process, no group.  Calling it again, or after the caller
    initialized torch.distributed itself, is a no-op."""
    global _INITIALIZED
    if _INITIALIZED or (tdist.is_available() and tdist.is_initialized()):
        _INITIALIZED = True
        return
    env = os.environ
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if init_method is None and env.get("MASTER_ADDR"):
        init_method = "env://"
        env.setdefault("MASTER_PORT", str(distributed_port))
    if init_method is None and auto_mpi_discovery and \
            env.get("OMPI_COMM_WORLD_SIZE"):
        world_size = world_size or int(env["OMPI_COMM_WORLD_SIZE"])
        rank = rank if rank is not None else int(
            env.get("OMPI_COMM_WORLD_RANK", 0))
        init_method = (f"tcp://{env.get('MASTER_ADDR', '127.0.0.1')}:"
                       f"{distributed_port}")
    if init_method is None:
        return
    world_size = 1 if world_size is None else int(world_size)
    rank = 0 if rank is None else int(rank)
    backend = backend_for(device, dist_backend)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(get_local_rank() % torch.cuda.device_count())
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = (timeout if isinstance(timeout,
                                                   datetime.timedelta)
                             else datetime.timedelta(seconds=float(timeout)))
    tdist.init_process_group(backend, init_method=init_method,
                             world_size=world_size, rank=rank, **kwargs)
    _INITIALIZED = True
    if verbose:
        logger.info(f"torch.distributed initialized: {backend} over "
                    f"{init_method}, rank {rank} of {world_size}")


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def destroy() -> None:
    """Leave the process group and forget the mesh."""
    global _INITIALIZED
    if is_initialized():
        tdist.destroy_process_group()
    _INITIALIZED = False
    mesh_mod.set_current_mesh(None)


def get_world_size(group=None) -> int:
    """Every rank, or the size of one mesh axis (`group` = axis name)."""
    if isinstance(group, str):
        return mesh_mod.get_current_mesh().axis_size(group)
    if not is_initialized():
        return 1
    return tdist.get_world_size(group)


def get_rank(group=None) -> int:
    """This process's rank, or its index along a mesh axis."""
    if isinstance(group, str):
        return mesh_mod.get_current_mesh().axis_index(group)
    if not is_initialized():
        return 0
    return tdist.get_rank(group)


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK",
                              os.environ.get("DSTPU_LOCAL_RANK", 0)))


def barrier(group=None) -> None:
    """Every rank of `group` reaches this point before any leaves."""
    g = _group(group)
    if g is not None:
        tdist.barrier(group=g)


def store():
    """The key-value store of the default process group (the checkpoint
    commit barrier's rendezvous), or None without one."""
    if not is_initialized():
        return None
    return tdist.distributed_c10d._get_default_store()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _group(group):
    """Axis name / process group / None -> the process group to call, or
    None when the group is one rank with no process group."""
    if isinstance(group, str):
        return mesh_mod.get_current_mesh().group(group)
    if group is None:
        return tdist.group.WORLD if is_initialized() else None
    return group


def _as_sendable(x):
    """A uint8 tensor as an int8 view of the same bytes (the collectives
    move bits, and int8 is a type every backend carries), else `x`."""
    return x.view(torch.int8) if x.dtype == torch.uint8 else x


def _record_volume(kind: str, x) -> None:
    COUNTERS.add(f"dist.{kind}", x.numel() * x.element_size())


def all_reduce(x, group=None, op: str = ReduceOp.SUM):
    """Reduce `x` over `group` in place; returns `x`."""
    _record_volume("all_reduce", x)
    g = _group(group)
    if g is None:
        return x
    if op == ReduceOp.AVG:
        # gloo has no AVG: a sum, then the division
        tdist.all_reduce(x, op=tdist.ReduceOp.SUM, group=g)
        return x.div_(tdist.get_world_size(g))
    if op not in _TORCH_OPS:
        raise ValueError(f"unknown reduce op {op}")
    tdist.all_reduce(x, op=_TORCH_OPS[op], group=g)
    return x


def _gather_into(out, x, g):
    fn = getattr(tdist, "all_gather_single", None) or \
        tdist.all_gather_into_tensor
    fn(out, x, group=g)


def _scatter_into(out, x, g):
    fn = getattr(tdist, "reduce_scatter_single", None) or \
        tdist.reduce_scatter_tensor
    fn(out, x, group=g)


def all_gather(x, group=None, *, tiled: bool = True, gather_axis: int = 0):
    """Gather every rank's `x`: concatenated along `gather_axis` (tiled)
    or stacked on a new leading dim."""
    _record_volume("all_gather", x)
    g = _group(group)
    n = 1 if g is None else tdist.get_world_size(g)
    dtype = x.dtype
    x = _as_sendable(x)
    src = x.movedim(gather_axis, 0).contiguous() if tiled else x.contiguous()
    if not tiled:
        src = src.unsqueeze(0)
    if g is None:
        out = src.clone()
    else:
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        _gather_into(out, src, g)
    out = out.view(dtype)
    return out.movedim(0, gather_axis) if tiled else out


def reduce_scatter(x, group=None, *, scatter_axis: int = 0):
    """Sum over `group`, then keep this rank's 1/n slice of
    `scatter_axis` — the ZeRO gradient primitive."""
    _record_volume("reduce_scatter", x)
    g = _group(group)
    src = x.movedim(scatter_axis, 0).contiguous()
    if g is None:
        out = src.clone()
    else:
        n = tdist.get_world_size(g)
        if src.shape[0] % n:
            raise ValueError(f"reduce_scatter: dim {scatter_axis} of "
                             f"{tuple(x.shape)} does not split {n} ways")
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        _scatter_into(out, src, g)
    return out.movedim(0, scatter_axis)


def broadcast(x, group=None, src: int = 0):
    """Every rank gets group rank `src`'s value (a new tensor)."""
    _record_volume("broadcast", x)
    g = _group(group)
    out = x.detach().clone().contiguous()
    if g is not None:
        tdist.broadcast(out, src=tdist.get_global_rank(g, src), group=g)
    return out


def ppermute(x, group, perm):
    """Point-to-point exchange over group ranks: each (src, dst) pair of
    `perm` sends src's `x` to dst; a rank nobody sends to gets zeros (as
    lax.ppermute gives)."""
    _record_volume("ppermute", x)
    g = _group(group)
    out = torch.zeros_like(x)
    if g is None:
        for s, d in perm:
            if s == d == 0:
                out.copy_(x)
        return out
    me = tdist.get_rank(g)
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(x)
        elif s == me:
            ops.append(tdist.P2POp(tdist.isend, x.contiguous(),
                                   tdist.get_global_rank(g, d), g))
        elif d == me:
            ops.append(tdist.P2POp(tdist.irecv, out,
                                   tdist.get_global_rank(g, s), g))
    if ops:
        for work in tdist.batch_isend_irecv(ops):
            work.wait()
    return out


def all_to_all(x, group=None, *, split_axis: int, concat_axis: int):
    """dist.all_to_all_single with lax.all_to_all's tiled semantics: x
    splits into n chunks along `split_axis`, chunk j goes to rank j, and
    the chunks received concatenate along `concat_axis`."""
    _record_volume("all_to_all", x)
    g = _group(group)
    if g is None:
        return x.clone()
    n = tdist.get_world_size(g)
    src = _as_sendable(x.movedim(split_axis, 0).contiguous())
    if src.shape[0] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not split {n} ways")
    out = torch.empty_like(src)
    tdist.all_to_all_single(out, src, group=g, async_op=True).wait()
    out = out.view(x.dtype)
    chunks = [c.movedim(0, split_axis) for c in out.chunk(n, dim=0)]
    return torch.cat(chunks, dim=concat_axis)


def all_to_all_uneven(x, send_counts, recv_counts, group=None):
    """1-d all-to-all with per-rank counts: the first send_counts[0]
    elements of `x` go to group rank 0, the next send_counts[1] to rank
    1, ...; the result holds what each rank sent here, in rank order."""
    _record_volume("all_to_all", x)
    g = _group(group)
    if g is None:
        return x.clone()
    out = x.new_empty((int(sum(recv_counts)),))
    tdist.all_to_all_single(out, x.contiguous(),
                            output_split_sizes=list(recv_counts),
                            input_split_sizes=list(send_counts), group=g,
                            async_op=True).wait()
    return out


def allgather_bytes(payload: bytes, group=None) -> list:
    """Every rank's `payload` (any length), in rank order: an
    `all_gather_object` over `group` (default: every rank).  The port's
    counterpart of the JAX package's HostWire.allgather_bytes
    (runtime/comm/hostwire.py:353), which carries the run monitor's
    heartbeats, its summary merge and the tracer's clock sync; counted
    as `hostwire.allgather` (bytes = this rank's payload), as there."""
    COUNTERS.add("hostwire.allgather", len(payload))
    g = _group(group)
    if g is None:
        return [bytes(payload)]
    out = [None] * tdist.get_world_size(g)
    tdist.all_gather_object(out, bytes(payload), group=g)
    return out


class ProcessGroupWire:
    """The duck-typed `wire` of monitor/monitor.py and monitor/tracing.py
    (`allgather_bytes(payload) -> [bytes]`) over a process group."""

    def __init__(self, group=None):
        self.group = group

    def allgather_bytes(self, payload: bytes) -> list:
        return allgather_bytes(payload, self.group)

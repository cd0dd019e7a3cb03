"""ZeRO-Offload — the optimizer state in host RAM or on NVMe (the port of
deepspeed_tpu/runtime/zero/offload.py).

The device keeps only the compute-dtype working weights and the fp32
gradient accumulators; the fp32 masters and the Adam moments live on the
host, where the native Adam (`ops/adam/cpu_adam.py`, the JAX package's
`cpu_adam.cpp`) updates them.  With offload device "nvme" the moments
page through the aio engine (`ops/aio`) to files, one leaf at a time.

A step on the card (offload.py:120-188):

1. D2H: every fp32 gradient is copied into its pinned host buffer on a
   copy stream, all of them enqueued first, each with its own event;
   the host takes leaf i's float32 `np.dot` for the norm while leaves
   i+1... are still copying (a finite dot proves the leaf finite; only
   a non-finite one is tested element by element).  A non-finite value in
   any leaf skips the whole step (the loss scaler's rule), so every
   leaf lands before the first update;
2. norm and clip exactly as JAX's (:143-151): the per-leaf dots summed
   in Python floats, times `inv * inv`, on the same host arrays;
3. the host Adam over each leaf, scaling its gradient in place in the
   pinned buffer, writing the bf16 weights straight into a pinned wire
   buffer (`ds_adam_step_bf16`), whose upload is enqueued on the copy
   stream with `non_blocking=True` at once: leaf i uploads while leaf
   i+1 is updated.  fp32 weights upload from the (pinned) masters,
   fp16 from a pinned cast of them.

Pinned staging is allocated once, in one block a kind, and reused; a
buffer is rewritten only after its last copy's event has completed, and
the compute stream waits for the uploads before the next forward.  With
gradients that are not CUDA tensors (the CPU, or numpy) the same step
runs synchronously: the host arrays are the gradients themselves.
`last_timing` holds the last step's split: `d2h_ms` (the copy stream's
span over the downloads) and `h2d_ms` (the uploads' own device time,
summed) on events, `host_check_ms` (finite check and norm) and
`adam_ms` on the host clock.

Leaves are in the JAX tree's leaf order (`models/convert.py`
`jax_leaf_order`): the Adam state's keys and the checkpoint's `masters`
list are JAX's.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from ...utils.logging import log_dist


def _host_f32(x) -> np.ndarray:
    """A flat fp32 numpy view (or copy) of a host array or CPU tensor."""
    if torch.is_tensor(x):
        return x.detach().float().reshape(-1).numpy()
    return np.asarray(x, np.float32).reshape(-1)


def pinned_block(sizes, dtype, pin: bool):
    """One host block holding `sizes` elements of `dtype` (pinned when
    `pin`), cut into flat views, each starting on a 64-element boundary;
    returns (block, views)."""
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += -(-int(n) // 64) * 64
    block = torch.empty(max(total, 1), dtype=dtype, pin_memory=pin)
    return block, [block[o:o + int(n)] for o, n in zip(offs, sizes)]


class NvmeStateStore:
    """Pages per-leaf Adam moments to files through the aio engine."""

    def __init__(self, nvme_path: str, n_threads: int = 4):
        import shutil
        import uuid
        import weakref

        from ...ops.aio import AsyncIOHandle

        # instance-unique: two runtimes in one process (a save and a
        # fresh reload) never share moment files; removed with the store
        self.dir = os.path.join(
            nvme_path, f"dstpu_offload_{os.getpid()}_{uuid.uuid4().hex[:8]}")
        os.makedirs(self.dir, exist_ok=True)
        self.handle = AsyncIOHandle(n_threads=n_threads)
        self._initialized = set()
        self.bytes_read = 0
        self.bytes_written = 0
        self._cleanup = weakref.finalize(self, shutil.rmtree, self.dir, True)

    def _path(self, key: int, name: str) -> str:
        return os.path.join(self.dir, f"leaf{key}_{name}.bin")

    def has(self, key: int) -> bool:
        """True iff this leaf's moments were ever stored (load() makes
        zeros for an unknown key)."""
        return key in self._initialized

    def load(self, key: int, n: int):
        m = np.zeros(n, np.float32)
        v = np.zeros(n, np.float32)
        if key in self._initialized:
            self.handle.async_pread(m, self._path(key, "m"))
            self.handle.async_pread(v, self._path(key, "v"))
            self.handle.wait()
            self.bytes_read += m.nbytes + v.nbytes
        return {"m": m, "v": v}

    def store(self, key: int, state):
        m = np.ascontiguousarray(state["m"], np.float32)
        v = np.ascontiguousarray(state["v"], np.float32)
        self.handle.async_pwrite(m, self._path(key, "m"))
        self.handle.async_pwrite(v, self._path(key, "v"))
        self.handle.wait()
        self.bytes_written += m.nbytes + v.nbytes
        self._initialized.add(key)


class CPUOffloadRuntime:
    """The host-side optimizer step of the engine's offload path.

    leaves: the fp32 masters' initial values (tensors or arrays), in the
    JAX leaf order; `param_dtype` the device weights' dtype; `device` the
    card the weights live on (None: no pinned staging)."""

    def __init__(self, leaves, hparams: dict, adam_w_mode: bool = True,
                 nvme_path: Optional[str] = None,
                 param_dtype=torch.float32, device=None):
        from ...ops.adam.cpu_adam import HostAdam

        self.shapes = [tuple(np.shape(l)) for l in leaves]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.param_dtype = param_dtype
        self.device = torch.device(device) if device is not None else None
        cuda = self.device is not None and self.device.type == "cuda"
        self._cuda = cuda
        # fp32 masters: host numpy buffers (pinned when they are the
        # upload's source, fp32 weights on the card)
        pin_masters = cuda and param_dtype == torch.float32
        self._master_block, views = pinned_block(self.sizes, torch.float32,
                                                 pin_masters)
        self.masters: List[np.ndarray] = []
        for v, l in zip(views, leaves):
            v.copy_(l.detach().reshape(-1).float().cpu() if torch.is_tensor(l)
                    else torch.from_numpy(_host_f32(l)))
            self.masters.append(v.numpy())
        self.adam = HostAdam(
            lr=hparams.get("lr", 1e-3),
            betas=tuple(hparams.get("betas", (0.9, 0.999))),
            eps=hparams.get("eps", 1e-8),
            weight_decay=hparams.get("weight_decay", 0.0),
            adam_w_mode=adam_w_mode)
        self.nvme: Optional[NvmeStateStore] = None
        if nvme_path is not None:
            self.nvme = NvmeStateStore(nvme_path)
            log_dist(f"ZeRO-Offload: Adam moments paging to {nvme_path}",
                     ranks=[0])
        else:
            log_dist("ZeRO-Offload: optimizer state in host RAM", ranks=[0])
        # pinned staging, made at the first step on the card
        self._grad_block = self._grad_bufs = None
        self._wire_block = self._wire_bufs = None
        self._stream = None
        self._h2d_events: List[Optional[torch.cuda.Event]] = \
            [None] * len(self.sizes)
        self.last_timing = {}

    def pinned_bytes(self) -> int:
        blocks = [self._grad_block, self._wire_block]
        if self._master_block.is_pinned():
            blocks.append(self._master_block)
        return sum(b.numel() * b.element_size() for b in blocks
                   if b is not None)

    def host_bytes(self) -> int:
        """Host memory the runtime holds: masters, moments, staging."""
        n = self._master_block.numel() * 4
        for blk in (self._grad_block, self._wire_block):
            if blk is not None:
                n += blk.numel() * blk.element_size()
        n += sum(a.nbytes for s in self.adam._state.values()
                 for a in s.values())
        return n

    # -- staging ---------------------------------------------------------

    def _staging(self):
        if self._grad_block is None:
            self._grad_block, self._grad_bufs = pinned_block(
                self.sizes, torch.float32, True)
            if self.param_dtype != torch.float32:
                self._wire_block, self._wire_bufs = pinned_block(
                    self.sizes, self.param_dtype, True)
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _grads_to_host(self, grad_leaves):
        """-> (one host fp32 array a leaf, as it lands; copy stream or
        None).  On the card the copies are all enqueued first."""
        if not (self._cuda and torch.is_tensor(grad_leaves[0])
                and grad_leaves[0].is_cuda):
            for g in grad_leaves:
                yield _host_f32(g), False
            return
        stream = self._staging()
        stream.wait_stream(torch.cuda.current_stream(self.device))
        events = []
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            t0.record(stream)
            for buf, g in zip(self._grad_bufs, grad_leaves):
                buf.copy_(g.detach().reshape(-1), non_blocking=True)
                g.record_stream(stream)   # the accumulator outlives the step
                ev = torch.cuda.Event()
                ev.record(stream)
                events.append(ev)
            t1.record(stream)
        for buf, ev in zip(self._grad_bufs, events):
            ev.synchronize()
            yield buf.numpy(), True
        self.last_timing["d2h_ms"] = t0.elapsed_time(t1)

    # -- the step --------------------------------------------------------

    def step(self, grad_leaves, denom: float, lr: Optional[float],
             clip: float = 0.0, out=None):
        """grad_leaves: the fp32 gradient accumulators (device tensors,
        CPU tensors or arrays), scaled by `denom`, which is divided out
        here.  out: the device weight tensors to write (None: return the
        host weights).  Returns (weights, overflow, norm); weights None
        on overflow."""
        self.last_timing = {}
        inv = 1.0 / denom
        host_grads, own = [], []
        sq = 0.0
        overflow = False
        t = time.perf_counter()
        check_s = 0.0
        for g, staged in self._grads_to_host(grad_leaves):
            c = time.perf_counter()
            host_grads.append(g)
            own.append(staged)
            if not overflow:
                d = float(np.dot(g, g))
                # a finite sum of squares has no inf or NaN under it; only
                # a non-finite one needs the element test
                if not np.isfinite(d) and not np.isfinite(g).all():
                    overflow = True
                else:
                    sq += d
            check_s += time.perf_counter() - c
        self.last_timing["host_check_ms"] = check_s * 1e3
        self.last_timing["d2h_wait_ms"] = \
            (time.perf_counter() - t - check_s) * 1e3
        if overflow:
            return None, True, 0.0
        sq = sq * inv * inv
        norm = float(np.sqrt(sq))
        scale = inv
        if clip > 0.0 and norm > clip:
            scale = inv * (clip / (norm + 1e-6))

        uploading = out is not None and self._cuda and out[0].is_cuda
        stream = self._staging() if uploading else None
        uploads = []
        emit_bf16 = self.param_dtype == torch.bfloat16
        self.adam.begin_step()
        adam_s = 0.0
        results = []
        for i, (master, g) in enumerate(zip(self.masters, host_grads)):
            # the staging buffer is this step's own: scaled in place; a
            # caller's array is never written
            if own[i]:
                np.multiply(g, np.float32(scale), out=g)
            else:
                g = np.multiply(g, np.float32(scale), dtype=np.float32)
            if self._h2d_events[i] is not None:
                # last step's upload from this leaf's buffers has landed
                self._h2d_events[i].synchronize()
                self._h2d_events[i] = None
            a = time.perf_counter()
            if self.nvme is not None:
                self.adam._state[i] = self.nvme.load(i, master.size)
            if emit_bf16:
                wire = (self._wire_bufs[i] if uploading else
                        torch.empty(master.size, dtype=torch.bfloat16))
                self.adam.update_flat(i, master, g, lr=lr, out_bf16=wire)
                src = wire
            else:
                self.adam.update_flat(i, master, g, lr=lr)
                src = torch.from_numpy(master)
                if self.param_dtype != torch.float32:
                    wire = (self._wire_bufs[i] if uploading else
                            torch.empty(master.size, dtype=self.param_dtype))
                    wire.copy_(src)
                    src = wire
            if self.nvme is not None:
                self.nvme.store(i, self.adam._state.pop(i))
            adam_s += time.perf_counter() - a
            src = src.view(self.shapes[i])
            if out is None:
                results.append(src.clone() if src.dtype == torch.bfloat16
                               else src.numpy().copy())
            elif uploading:
                with torch.cuda.stream(stream):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e0.record(stream)
                    out[i].data.copy_(src, non_blocking=True)
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record(stream)
                self._h2d_events[i] = ev
                uploads.append((e0, ev))
                results.append(out[i])
            else:
                out[i].data.copy_(src)
                results.append(out[i])
        self.last_timing["adam_ms"] = adam_s * 1e3
        if uploading:
            # the next forward reads the new weights
            torch.cuda.current_stream(self.device).wait_stream(stream)
            uploads[-1][1].synchronize()
            # the copies' own device time (the stream idles between them
            # while the host updates the next leaf)
            self.last_timing["h2d_ms"] = sum(a.elapsed_time(b)
                                             for a, b in uploads)
        return results, False, norm

    # -- checkpoints ------------------------------------------------------

    def state_dict(self):
        sd = self.adam.state_dict()
        if self.nvme is not None:
            # the moments live on files between steps: read them back
            sd["state"] = {
                str(i): {k: v.copy()
                         for k, v in self.nvme.load(i, m.size).items()}
                for i, m in enumerate(self.masters)}
        sd["masters"] = [m.copy() for m in self.masters]
        return sd

    def load_masters(self, leaves):
        """The masters from fp32 values (a list in the JAX leaf order)."""
        if len(leaves) != len(self.masters):
            raise ValueError(f"{len(leaves)} master leaves for "
                             f"{len(self.masters)}")
        for m, v, n in zip(self.masters, leaves, self.sizes):
            v = _host_f32(v)
            if v.size != n:
                raise ValueError(f"a master leaf of {v.size} elements for "
                                 f"{n}")
            m[...] = v

    def load_state_dict(self, sd):
        self.adam.load_state_dict({k: sd[k] for k in ("step", "state")})
        self.load_masters(sd["masters"])
        if self.nvme is not None:
            # written through to this runtime's own store
            for key, st in list(self.adam._state.items()):
                self.nvme.store(int(key), st)
            self.adam._state = {}

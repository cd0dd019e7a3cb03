"""ZeRO-Infinity — training a model larger than the card by streaming its
parameters from host RAM (optionally paging them and the Adam moments
to NVMe); the port of deepspeed_tpu/runtime/zero/infinity.py.

* The fp32 masters live on the HOST, grouped by the model's stages
  (`embed`, `block:i`, `head`: the model's streaming protocol,
  `models/gpt.py` `stream_*`); each group's leaves are kept in the JAX
  tree's leaf order, and a leaf's key is its group's base plus its index
  (the Adam state's and the checkpoint's keys, as in JAX).
* Forward: the embed and head groups stay on the card for the step; the
  blocks stream through it double-buffered: the next block's
  compute-dtype weights are copied up (a side stream, from pinned
  memory, `non_blocking`) while the current block computes, no gradient
  is recorded, and each block's input is saved.
* Backward: the blocks stream again in reverse; each is recomputed from
  its saved input and differentiated (`torch.autograd.grad`: gradients
  in the compute dtype, then cast to fp32, as `block_bwd` does,
  infinity.py:361-365).  Block i's fp32 gradients copy to the host on a
  second side stream while block i-1 computes; the host adds them into
  the gradient sink (pinned, allocated once: a leaf's first gradient of
  a step lands in it directly, a later one through a staging slot).
  The tied `wte`'s gradient is the embedding lookup's plus the
  projection's (:456-461).
* `micro_step` fills the sink, `apply_accumulated` runs the host Adam
  (`ops/adam/cpu_adam.py`) over it at the boundary: every value finite
  (else the whole step is skipped), the norm of the summed gradients
  divided by the micro-step count (:493-496), the clip, then each leaf's
  update, its moments paged through the aio engine with an NVMe path.
* Weights upload from a persistent pinned compute-dtype copy of each
  group, which the Adam rewrites at each update (`ds_adam_step_bf16`:
  bitwise the cast of the new masters); fp32 weights from the pinned
  masters; NVMe-paged masters (`params_on_nvme`) are read one group
  ahead, cast by torch into a pinned staging ring, and the forward's
  last block is kept in RAM for the backward's first read.

The runtime runs one process: gradients are never reduced across ranks
(the JAX package's `CrossProcessGradReducer` is not ported; the config
refuses offload at world > 1).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...models.convert import flatten_tree, jax_ordered_leaves, unflatten_tree
from ...utils.logging import log_dist
from .offload import NvmeStateStore, pinned_block


def _tokens_labels(batch):
    if isinstance(batch, dict):
        tokens, labels = batch["input_ids"], batch.get("labels")
    else:
        tokens, labels = batch
    if labels is None:
        tokens, labels = tokens[:, :-1], tokens[:, 1:]
    return tokens, labels


def _as_long(x, device):
    t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=torch.long)


class NvmeMasterPager:
    """fp32 masters on NVMe: one file a leaf, read and written a group at
    a time through the aio engine, with one group read ahead
    (infinity.py:150-213)."""

    def __init__(self, nvme_path: str, n_threads: int = 4):
        import shutil
        import uuid
        import weakref

        from ...ops.aio import AsyncIOHandle

        # instance-unique; the directory holds a whole fp32 model image
        # and is removed with the pager
        self.dir = os.path.join(
            nvme_path, f"dstpu_masters_{os.getpid()}_{uuid.uuid4().hex[:8]}")
        os.makedirs(self.dir, exist_ok=True)
        self._cleanup = weakref.finalize(self, shutil.rmtree, self.dir, True)
        self._h_main = AsyncIOHandle(n_threads=n_threads)
        self._h_pre = AsyncIOHandle(n_threads=2)
        self.engine = self._h_main.engine
        self._pending: Dict[str, List[np.ndarray]] = {}
        self.bytes_read = 0
        self.bytes_written = 0

    def _path(self, name: str, j: int) -> str:
        safe = name.replace(":", "_").replace("/", "_")
        return os.path.join(self.dir, f"{safe}.leaf{j}.f32")

    def write_group(self, name: str, flat: List[np.ndarray]) -> None:
        for j, arr in enumerate(flat):
            arr = np.ascontiguousarray(arr, np.float32)
            self._h_main.async_pwrite(arr, self._path(name, j))
            self.bytes_written += arr.nbytes
        self._h_main.wait()

    def prefetch(self, name: str, sizes: List[int]) -> None:
        """Start the reads of a group; read_group() collects them.  One
        prefetch in flight at a time (the handle waits for all)."""
        if name in self._pending:
            return
        bufs = [np.empty(n, np.float32) for n in sizes]
        for j, buf in enumerate(bufs):
            self._h_pre.async_pread(buf, self._path(name, j))
            self.bytes_read += buf.nbytes
        self._pending[name] = bufs

    def read_group(self, name: str, sizes: List[int]) -> List[np.ndarray]:
        bufs = self._pending.pop(name, None)
        if bufs is not None:
            self._h_pre.wait()
            return bufs
        bufs = [np.empty(n, np.float32) for n in sizes]
        for j, buf in enumerate(bufs):
            self._h_main.async_pread(buf, self._path(name, j))
            self.bytes_read += buf.nbytes
        self._h_main.wait()
        return bufs


class _Group:
    """One stream group: its leaves' dotted names, shapes and sizes (JAX
    order), fp32 masters (None when paged), the persistent pinned
    compute-dtype copy (None when absent), and its first leaf key."""

    def __init__(self, name, names, shapes, base):
        self.name = name
        self.names, self.shapes, self.base = names, shapes, base
        self.sizes = [int(np.prod(s)) if s else 1 for s in shapes]
        self.flat: Optional[List[np.ndarray]] = None
        self.wire: Optional[List[torch.Tensor]] = None
        self.block = None      # the pinned tensor holding `flat`, if any
        self.event = None      # the last upload from this group's memory


class _Staged:
    """A group's weights on the device and the event of their upload."""

    def __init__(self, tree, event):
        self.tree, self.event = tree, event

    def use(self):
        if self.event is not None:
            torch.cuda.current_stream().wait_event(self.event)
            self.event = None
        return self.tree


class InfinityRuntime:
    """groups: (name, nested tree of fp32 values) for every stream group,
    in the model's order (`model.stream_init(generator)`, or
    `model.stream_groups(params)`)."""

    def __init__(self, model, groups, hparams: dict, adam_w_mode: bool = True,
                 compute_dtype=torch.bfloat16, device="cpu",
                 nvme_path: Optional[str] = None,
                 params_on_nvme: bool = False):
        from ...ops.adam.cpu_adam import HostAdam

        if not model.stream_supported():
            raise ValueError(
                "model does not support parameter streaming (needs "
                "homogeneous blocks, no MoE/pipeline, dropout=0)")
        if params_on_nvme and not nvme_path:
            raise ValueError("params_on_nvme requires an nvme_path")
        self.model = model
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self.pager = NvmeMasterPager(nvme_path) if params_on_nvme else None
        self.groups: Dict[str, _Group] = {}
        self.group_order: List[str] = []
        base = 0
        for name, tree in groups:
            leaves = jax_ordered_leaves(tree)
            g = _Group(name, [n for n, _ in leaves],
                       [tuple(np.shape(l)) for _, l in leaves], base)
            self.groups[name] = g
            self.group_order.append(name)
            base += len(leaves)
            self._set_masters(g, [l for _, l in leaves], fresh=True)
        self.n_elements = sum(sum(g.sizes) for g in self.groups.values())
        self.adam = HostAdam(
            lr=hparams.get("lr", 1e-3),
            betas=tuple(hparams.get("betas", (0.9, 0.999))),
            eps=hparams.get("eps", 1e-8),
            weight_decay=hparams.get("weight_decay", 0.0),
            adam_w_mode=adam_w_mode)
        self.nvme = NvmeStateStore(nvme_path) if nvme_path else None
        # the gradient sink: key -> this step's fp32 sum (views of one
        # persistent block, allocated at the first step)
        self._acc_sink: Dict[int, np.ndarray] = {}
        self._acc_count = 0
        self._sink_block = self._sink_views = None
        # NVMe-paged masters: the forward's last block read, kept for the
        # backward's first
        self._kept: Dict[str, List[np.ndarray]] = {}
        self._up = self._down = None        # side streams
        self._ring = []                     # paged uploads' pinned slots
        self._ring_next = 0
        self._stage = []                    # D2H slots for sink additions
        self.profile = False                # collect the timing split
        self._timed: Dict[str, list] = {"compute": [], "h2d": [], "d2h": []}
        self.last_adam_ms = self.last_check_ms = 0.0
        log_dist(f"ZeRO-Infinity: {self.n_elements / 1e6:.1f}M params "
                 f"streamed from {'NVMe' if self.pager else 'host RAM'} "
                 f"({'moments on NVMe' if nvme_path else 'moments in RAM'})",
                 ranks=[0])

    # -- host masters ------------------------------------------------------

    def _set_masters(self, g: _Group, values, fresh=False):
        """Install a group's fp32 masters from a list of values."""
        flat = []
        for v, n in zip(values, g.sizes):
            a = (v.detach().float().reshape(-1).cpu().numpy()
                 if torch.is_tensor(v) else np.asarray(v, np.float32).ravel())
            if a.size != n:
                raise ValueError(f"a leaf of {a.size} elements for {n} "
                                 f"(checkpoint/model config mismatch)")
            flat.append(a)
        if self.pager is not None:
            self.pager.write_group(g.name, flat)
            return
        if fresh:
            # fp32 weights upload from the masters themselves: pinned
            pin = self._cuda and self.compute_dtype == torch.float32
            g.block, views = pinned_block(g.sizes, torch.float32, pin)
            g.flat = [v.numpy() for v in views]
            if self._cuda and self.compute_dtype != torch.float32:
                _, g.wire = pinned_block(g.sizes, self.compute_dtype, True)
        self._wait_upload(g)
        for m, a in zip(g.flat, flat):
            m[...] = a
        if g.wire is not None:
            for w, m in zip(g.wire, g.flat):
                w.copy_(torch.from_numpy(m))

    def _masters_flat(self, name: str) -> List[np.ndarray]:
        g = self.groups[name]
        if g.flat is not None:
            return g.flat
        return self.pager.read_group(name, g.sizes)

    def _prefetch_masters(self, name: Optional[str]) -> None:
        if name is not None and self.pager is not None:
            self.pager.prefetch(name, self.groups[name].sizes)

    @staticmethod
    def _wait_upload(g: _Group):
        if g.event is not None:
            g.event.synchronize()
            g.event = None

    # -- host <-> device ---------------------------------------------------

    def _event(self, stream=None):
        ev = torch.cuda.Event(enable_timing=self.profile)
        ev.record(stream)
        return ev

    def _ring_slot(self, n: int):
        """A pinned compute-dtype staging slot of >= n elements whose last
        upload has landed (paged masters)."""
        if not self._ring:
            most = max(sum(g.sizes) for g in self.groups.values())
            self._ring = [[torch.empty(most, dtype=self.compute_dtype,
                                       pin_memory=True), None]
                          for _ in range(3)]
        slot = self._ring[self._ring_next]
        self._ring_next = (self._ring_next + 1) % len(self._ring)
        if slot[1] is not None:
            slot[1].synchronize()
        return slot

    def _to_device(self, name: str, prefetch: Optional[str] = None,
                   keep: bool = False) -> _Staged:
        """Start the copy of a group's compute-dtype weights to the card;
        with paged masters also start the read-ahead of `prefetch` (after
        collecting this group's own read: the handle waits for all).
        keep=True keeps the host buffers for the group's next read."""
        g = self.groups[name]
        flat = g.flat
        if flat is None:
            flat = self._kept.pop(name, None)
            if flat is None:
                flat = self.pager.read_group(name, g.sizes)
        self._prefetch_masters(prefetch)
        if keep and self.pager is not None:
            self._kept[name] = flat
        if not self._cuda:
            leaves = [torch.from_numpy(m).reshape(s).to(self.compute_dtype,
                                                        copy=True)
                      for m, s in zip(flat, g.shapes)]
            return _Staged(unflatten_tree(dict(zip(g.names, leaves))), None)
        slot = None
        if g.wire is not None:
            srcs = g.wire
        elif g.flat is not None:      # fp32: the pinned masters
            srcs = [torch.from_numpy(m) for m in flat]
        else:                         # paged: cast into a pinned slot
            slot = self._ring_slot(sum(g.sizes))
            srcs, off = [], 0
            for m in flat:
                v = slot[0][off:off + m.size]
                v.copy_(torch.from_numpy(m))
                srcs.append(v)
                off += m.size
        cur = torch.cuda.current_stream(self.device)
        leaves = [torch.empty(s, dtype=self.compute_dtype, device=self.device)
                  for s in g.shapes]
        if self._up is None:
            self._up = torch.cuda.Stream(self.device)
            self._down = torch.cuda.Stream(self.device)
        # the new tensors' memory may be a freed block the compute stream
        # still reads: the copy waits for the work enqueued so far
        self._up.wait_stream(cur)
        with torch.cuda.stream(self._up):
            t0 = self._event(self._up) if self.profile else None
            for d, s in zip(leaves, srcs):
                d.view(-1).copy_(s, non_blocking=True)
            ev = self._event(self._up)
        if t0 is not None:
            self._timed["h2d"].append((t0, ev))
        if slot is not None:
            slot[1] = ev
        else:
            g.event = ev
        return _Staged(unflatten_tree(dict(zip(g.names, leaves))), ev)

    def _sink_view(self, key: int) -> np.ndarray:
        if self._sink_block is None:
            sizes = [n for name in self.group_order
                     for n in self.groups[name].sizes]
            self._sink_block, views = pinned_block(sizes, torch.float32,
                                                   self._cuda)
            self._sink_views = [v.numpy() for v in views]
        return self._sink_views[key]

    def _grads_to_host(self, name: str, grads: List[torch.Tensor]):
        """Start moving a group's fp32 gradients (JAX leaf order) into the
        sink; returns what `_land` finishes.  A leaf's first gradient of
        the step lands in its sink view directly, a later one (the next
        micro step's) through a staging slot and a host add."""
        g = self.groups[name]
        sink = self._acc_sink
        plan = []
        if not self._cuda:
            for j, t in enumerate(grads):
                key = g.base + j
                a = t.detach().reshape(-1).numpy()
                if key in sink:
                    np.add(sink[key], a, out=sink[key])
                else:
                    sink[key] = self._sink_view(key)
                    sink[key][...] = a
            return None
        if not self._stage:
            most = max(sum(x.sizes) for x in self.groups.values())
            self._stage = [[torch.empty(most, dtype=torch.float32,
                                        pin_memory=True), None]
                           for _ in range(2)]
        slot = self._stage.pop(0)
        if slot[1] is not None:
            slot[1].synchronize()
        self._stage.append(slot)
        self._down.wait_stream(torch.cuda.current_stream(self.device))
        off = 0
        with torch.cuda.stream(self._down):
            t0 = self._event(self._down) if self.profile else None
            for j, t in enumerate(grads):
                key = g.base + j
                n = t.numel()
                if key in sink:
                    dst = slot[0][off:off + n]
                    plan.append((key, dst.numpy()))
                    off += n
                else:
                    sink[key] = self._sink_view(key)
                    dst = torch.from_numpy(sink[key])
                dst.copy_(t.detach().reshape(-1), non_blocking=True)
                t.record_stream(self._down)
            ev = self._event(self._down)
        slot[1] = ev
        if t0 is not None:
            self._timed["d2h"].append((t0, ev))
        return ev, plan

    def _land(self, pending):
        """Finish a `_grads_to_host`: wait for its copies, add the staged
        gradients into the sink."""
        if pending is None:
            return
        ev, plan = pending
        ev.synchronize()
        for key, staged in plan:
            np.add(self._acc_sink[key], staged, out=self._acc_sink[key])

    def _compute(self, fn, *args):
        """Run a stage, bracketed by timing events when profiling."""
        if not (self.profile and self._cuda):
            return fn(*args)
        t0 = self._event()
        out = fn(*args)
        self._timed["compute"].append((t0, self._event()))
        return out

    # -- the stage programs ---------------------------------------------------

    def _block_bwd(self, p, x, dy):
        leaves = [t.requires_grad_() for _, t in jax_ordered_leaves(p)]
        xin = x.detach().requires_grad_()
        with torch.enable_grad():
            y = self.model.stream_block(p, xin)
            *dp, dx = torch.autograd.grad(y, [*leaves, xin], dy)
        return [d.float() for d in dp], dx

    def _head(self, head_p, proj, x, labels, valid):
        ln = head_p["ln_f"]
        ln = {"bias": ln["bias"].detach().requires_grad_(),
              "scale": ln["scale"].detach().requires_grad_()}
        w = proj.detach().requires_grad_()
        xh = x.detach().requires_grad_()
        with torch.enable_grad():
            loss = self.model.stream_head_loss({"ln_f": ln}, w, xh, labels,
                                               valid)
            db, ds, dw, dx = torch.autograd.grad(
                loss, [ln["bias"], ln["scale"], w, xh])
        return loss.detach(), [db.float(), ds.float()], dw.float(), dx

    def _embed_bwd(self, embed_p, tokens, dx):
        wpe = embed_p["wpe"].detach().requires_grad_()
        wte = embed_p["wte"].detach().requires_grad_()
        with torch.enable_grad():
            y = self.model.stream_embed({"wte": wte, "wpe": wpe}, tokens)
            dwpe, dwte = torch.autograd.grad(y, [wpe, wte], dx)
        return dwpe.float(), dwte.float()

    # -- training step -------------------------------------------------------

    def micro_step(self, batch):
        """Streamed forward and backward of ONE micro batch; the fp32
        gradients add into the host sink until apply_accumulated()."""
        model = self.model
        cfg = model.config
        tokens, labels = _tokens_labels(batch)
        tokens = _as_long(tokens, self.device)
        labels = _as_long(labels, self.device)
        valid = labels >= 0
        labels = torch.where(valid, labels, 0)
        L = cfg.num_layers
        # forward: the embed and head groups stay; the blocks stream
        embed_s = self._to_device("embed", prefetch="head")
        head_s = self._to_device("head", prefetch="block:0" if L else None)
        embed_p = embed_s.use()
        with torch.no_grad():
            x = self._compute(model.stream_embed, embed_p, tokens)
            acts = [x]
            nxt = (self._to_device("block:0",
                                   prefetch="block:1" if L > 1 else None,
                                   keep=L == 1) if L else None)
            for i in range(L):
                if i + 1 < L:
                    pre = f"block:{i + 2}" if i + 2 < L else None
                    cur, nxt = nxt, self._to_device(
                        f"block:{i + 1}", prefetch=pre, keep=i + 1 == L - 1)
                else:
                    cur, nxt = nxt, None
                x = self._compute(model.stream_block, cur.use(), x)
                acts.append(x)
        head_p = head_s.use()
        proj = embed_p["wte"] if cfg.tie_embeddings else head_p["lm_head"]
        loss, dln, dproj, dx = self._compute(self._head, head_p, proj,
                                             acts[-1], labels, valid)
        # backward: the blocks stream again, in reverse
        head_grads = dln if cfg.tie_embeddings else [dproj, *dln]
        pending = self._grads_to_host("head", head_grads)
        nxt = (self._to_device(f"block:{L - 1}",
                               prefetch=f"block:{L - 2}" if L > 1 else None)
               if L else None)
        for i in range(L - 1, -1, -1):
            if i - 1 >= 0:
                pre = f"block:{i - 2}" if i - 2 >= 0 else None
                cur, nxt = nxt, self._to_device(f"block:{i - 1}",
                                                prefetch=pre)
            else:
                cur, nxt = nxt, None
            dp, dx = self._compute(self._block_bwd, cur.use(), acts[i], dx)
            acts[i + 1] = None
            nxt_pending = self._grads_to_host(f"block:{i}", dp)
            self._land(pending)    # block i+1's gradients, while i computes
            pending = nxt_pending
        dwpe, dwte = self._compute(self._embed_bwd, embed_p, tokens, dx)
        if cfg.tie_embeddings:
            dwte = dwte + dproj
        nxt_pending = self._grads_to_host("embed", [dwpe, dwte])
        self._land(pending)
        self._land(nxt_pending)
        self._acc_count += 1
        return loss

    def apply_accumulated(self, lr: Optional[float] = None,
                          clip: float = 0.0) -> bool:
        """The host Adam over the accumulated sink (the mean over the
        micro steps).  Returns the overflow flag: any non-finite value
        skips the whole step."""
        sink = self._acc_sink
        count = max(1, self._acc_count)
        self._acc_sink = {}
        self._acc_count = 0
        t = time.perf_counter()
        # a finite sum of squares has no inf or NaN under it; only a
        # non-finite one needs the element test
        dots = [float(np.dot(g, g)) for g in sink.values()]
        overflow = not all(np.isfinite(d) or np.isfinite(g).all()
                           for d, g in zip(dots, sink.values()))
        self.last_check_ms = (time.perf_counter() - t) * 1e3
        if overflow:
            return True
        scale = 1.0 / count   # the sum over micro steps -> the mean
        if clip > 0.0:
            norm = float(np.sqrt(sum(dots))) / count
            if norm > clip:
                scale *= clip / (norm + 1e-6)
        t = time.perf_counter()
        self.adam.begin_step()
        order = self.group_order
        for idx, name in enumerate(order):
            g = self.groups[name]
            flat = self._masters_flat(name)
            self._prefetch_masters(order[idx + 1]
                                   if idx + 1 < len(order) else None)
            self._wait_upload(g)
            for j, master in enumerate(flat):
                key = g.base + j
                grad = sink.get(key)
                if grad is None:
                    continue
                if scale != 1.0:
                    np.multiply(grad, np.float32(scale), out=grad)
                if self.nvme is not None:
                    self.adam._state[key] = self.nvme.load(key, master.size)
                self.adam.update_flat(
                    key, master, grad, lr=lr,
                    out_bf16=(g.wire[j] if g.wire is not None and
                              self.compute_dtype == torch.bfloat16 else None))
                if g.wire is not None and \
                        self.compute_dtype != torch.bfloat16:
                    g.wire[j].copy_(torch.from_numpy(master))
                if self.nvme is not None:
                    self.nvme.store(key, self.adam._state.pop(key))
            if self.pager is not None:
                self.pager.write_group(name, flat)
        self.last_adam_ms = (time.perf_counter() - t) * 1e3
        return False

    def timing(self) -> Dict[str, float]:
        """The device ms of the stage computations, uploads and gradient
        downloads recorded since the last call (profile=True), and the
        last host update's finite check and norm and Adam ms; synchronizes."""
        out = {"adam_ms": self.last_adam_ms,
               "host_check_ms": self.last_check_ms}
        if self._cuda:
            torch.cuda.synchronize(self.device)
        for k, pairs in self._timed.items():
            out[f"{k}_ms"] = sum(a.elapsed_time(b) for a, b in pairs)
            pairs.clear()
        return out

    def host_bytes(self) -> int:
        """Host memory held: masters, their pinned copies, moments, the
        sink and the staging."""
        n = 0
        for g in self.groups.values():
            if g.flat is not None:
                n += sum(g.sizes) * 4
            if g.wire is not None:
                n += sum(w.numel() * w.element_size() for w in g.wire)
        for blk in [self._sink_block] + [s[0] for s in self._ring + self._stage]:
            if blk is not None:
                n += blk.numel() * blk.element_size()
        n += sum(a.nbytes for s in self.adam._state.values()
                 for a in s.values())
        return n

    def pinned_bytes(self) -> int:
        n = 0
        for g in self.groups.values():
            if g.block is not None and g.block.is_pinned():
                n += g.block.numel() * 4
            if g.wire is not None:
                n += sum(w.numel() * w.element_size() for w in g.wire)
        for blk in [self._sink_block] + [s[0] for s in self._ring + self._stage]:
            if blk is not None and blk.is_pinned():
                n += blk.numel() * blk.element_size()
        return n

    # -- eval -----------------------------------------------------------------

    @torch.no_grad()
    def eval_loss(self, batch):
        model = self.model
        cfg = model.config
        tokens, labels = _tokens_labels(batch)
        tokens = _as_long(tokens, self.device)
        labels = _as_long(labels, self.device)
        valid = labels >= 0
        labels = torch.where(valid, labels, 0)
        embed_p = self._to_device("embed").use()
        head_p = self._to_device("head").use()
        x = model.stream_embed(embed_p, tokens)
        for i in range(cfg.num_layers):
            x = model.stream_block(self._to_device(f"block:{i}").use(), x)
        proj = embed_p["wte"] if cfg.tie_embeddings else head_p["lm_head"]
        return model.stream_head_loss({"ln_f": head_p["ln_f"]}, proj, x,
                                      labels, valid)

    # -- checkpoints ------------------------------------------------------------

    def _group_tree(self, name: str, leaves) -> Any:
        return unflatten_tree(dict(zip(self.groups[name].names, leaves)))

    def save_streamed(self, ckpt_dir: str):
        """The RAM-bounded checkpoint of NVMe-paged masters
        (infinity.py:549-620): one `stream_group_*.msgpack` file a group
        with its fp32 masters, its Adam moments and any mid-accumulation
        sink entries, at most about two groups resident.  Returns (module
        skeleton, optimizer skeleton) of stream markers."""
        from .. import checkpointing as ckpt_io

        os.makedirs(ckpt_dir, exist_ok=True)
        groups_markers: Dict[str, Any] = {}
        state_markers: Dict[str, str] = {}
        acc_markers: Dict[str, str] = {}
        order = self.group_order
        for idx, name in enumerate(order):
            g = self.groups[name]
            groups_markers[name] = self._group_tree(
                name, [ckpt_io.stream_marker(name, f"leaf:{j}")
                       for j in range(len(g.shapes))])
            flat = self._masters_flat(name)
            self._prefetch_masters(order[idx + 1]
                                   if idx + 1 < len(order) else None)
            payload: Dict[str, Any] = {
                "leaves": {str(j): m.reshape(s).copy()
                           for j, (m, s) in enumerate(zip(flat, g.shapes))},
                "optim": {}, "acc": {}}
            for j, n in enumerate(g.sizes):
                key = g.base + j
                if self.nvme is not None:
                    st = self.nvme.load(key, n) if self.nvme.has(key) \
                        else None
                else:
                    st = self.adam._state.get(key)
                if st is not None:
                    payload["optim"][str(key)] = {
                        k: np.asarray(v).copy() for k, v in st.items()}
                    state_markers[str(key)] = ckpt_io.stream_marker(
                        name, f"optim:{key}")
                if key in self._acc_sink:
                    payload["acc"][str(key)] = self._acc_sink[key].copy()
                    acc_markers[str(key)] = ckpt_io.stream_marker(
                        name, f"acc:{key}")
            ckpt_io.write_stream_group(ckpt_dir, name, payload)
        sd: Dict[str, Any] = {"step": self.adam.step_count,
                              "state": state_markers,
                              "n_elements": self.n_elements}
        if self._acc_count:
            sd["acc_count"] = self._acc_count
            sd["acc_sink"] = acc_markers
        return self.model.assemble_groups(groups_markers), sd

    def load_streamed(self, ckpt_dir: str, sd: Optional[dict]) -> None:
        """The RAM-bounded inverse of save_streamed (infinity.py:622-672):
        group file by group file, masters straight to their pages, moments
        into their store.  sd: the optimizer skeleton (None: masters
        only)."""
        from .. import checkpointing as ckpt_io

        missing = [name for name in self.group_order
                   if not os.path.isfile(
                       ckpt_io.stream_group_ckpt_name(ckpt_dir, name))]
        if missing:
            raise ckpt_io.CheckpointIntegrityError(
                f"streamed checkpoint incomplete: missing group files for "
                f"{missing} in {ckpt_dir}")
        self._kept.clear()
        load_opt = sd is not None
        if load_opt:
            self.adam.step_count = int(sd["step"])
            self.adam._state = {}
            self._acc_count = int(sd.get("acc_count", 0))
            self._acc_sink = {}
        for name in self.group_order:
            g = self.groups[name]
            payload = ckpt_io.read_stream_group(ckpt_dir, name)
            self._set_masters(g, [payload["leaves"][str(j)]
                                  for j in range(len(g.shapes))])
            if not load_opt:
                continue
            for key_s, st in (payload.get("optim") or {}).items():
                st = {k: np.array(v, np.float32) for k, v in st.items()}
                if self.nvme is not None:
                    self.nvme.store(int(key_s), st)
                else:
                    self.adam._state[int(key_s)] = st
            for key_s, acc in (payload.get("acc") or {}).items():
                self._restore_sink(int(key_s), acc)

    def _restore_sink(self, key: int, value) -> None:
        view = self._sink_view(key)
        view[...] = np.asarray(value, np.float32).ravel()
        self._acc_sink[key] = view

    def masters_tree(self):
        """The whole fp32 masters as a nested tree of numpy copies (with
        paged masters this holds them all in RAM; a save streams instead)."""
        if self.pager is not None:
            log_dist(f"materializing {self.n_elements * 4 / 2**30:.1f} GiB "
                     f"of NVMe-paged fp32 masters in host RAM", ranks=[0])
        groups = {}
        for name in self.group_order:
            g = self.groups[name]
            flat = self._masters_flat(name)
            groups[name] = self._group_tree(
                name, [m.reshape(s).copy() for m, s in zip(flat, g.shapes)])
        return self.model.assemble_groups(groups)

    def load_masters_tree(self, params):
        """The masters from a nested params tree (a JAX tree of arrays, or
        the module's tensors)."""
        for name, tree in self.model.stream_groups(params):
            g = self.groups[name]
            flat = flatten_tree(tree)
            if sorted(flat) != sorted(g.names):
                raise KeyError(f"group {name!r}: leaves {sorted(flat)}, "
                               f"expected {sorted(g.names)}")
            self._set_masters(g, [flat[n] for n in g.names])
            self._kept.pop(name, None)

    def state_dict(self):
        sd = self.adam.state_dict()
        if self.nvme is not None:
            state = {}
            for name in self.group_order:
                g = self.groups[name]
                for j, n in enumerate(g.sizes):
                    st = self.nvme.load(g.base + j, n)
                    state[str(g.base + j)] = {k: v.copy()
                                              for k, v in st.items()}
            sd["state"] = state
        sd["n_elements"] = self.n_elements
        if self._acc_count:
            sd["acc_count"] = self._acc_count
            sd["acc_sink"] = {str(k): v.copy()
                              for k, v in self._acc_sink.items()}
        return sd

    def load_state_dict(self, sd):
        self.adam.load_state_dict({k: sd[k] for k in ("step", "state")})
        self._kept.clear()
        self._acc_count = int(sd.get("acc_count", 0))
        self._acc_sink = {}
        for k, v in (sd.get("acc_sink") or {}).items():
            self._restore_sink(int(k), v)
        if self.nvme is not None:
            for key, st in list(self.adam._state.items()):
                self.nvme.store(int(key), st)
            self.adam._state = {}

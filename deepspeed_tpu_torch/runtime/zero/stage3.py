"""ZeRO stage 3's gather on use: what XLA does for the JAX package's
stage-3 parameter specs (all-gather a sharded parameter where it is
read, discard it after; deepspeed_tpu/runtime/zero/partition.py
:132-156), written out for eager PyTorch — the role of the reference's
stage3.py fetch / release hooks.

A rank stores only its fp32 slice of each stage-3 leaf (the zero plan's
`gathered` leaves, `partition.py`).  The model names its gather units:
a module whose class sets `zero3_gather_unit = True` (`models.gpt.Block`,
a `TiledLinear` tile).  Its sharded leaves form one group, gathered as
one collective; the leaves outside every unit (GPT's `wte`, `wpe`,
`ln_f`, an untied `lm_head`) form the root group, which the engine
gathers around the whole model call.  The model runs a unit inside
`gathered(unit)`:

* forward: the group's compute-dtype replica is gathered (`_GatherFn`:
  each slice cast, one all-gather, or the qwZ wire's one #11 launch,
  one collective and one #12 launch) and swapped into the unit's
  modules in place of the slices, with the unit's other leaves cast to
  the compute dtype; on exit the slices are swapped back and nothing
  holds the replica: a tensor an op saves for its backward that lies in
  a replica's storage is saved as a token (`saved_tensors_hooks`);
* backward: `scope.output(x)` puts an identity on the unit's output
  whose backward gathers the group again before the unit's own backward
  runs (an unpacked token gathers it if something reaches it first);
  every token of the group unpacks into that one gather, which is
  released when the group's gradients are complete;
* gradients: `_GatherFn`'s backward receives each leaf's gradient
  summed over all its uses on the compute-dtype replica (the tied
  `wte`, read by the embedding and the LM head, is one leaf of the root
  group: autograd sums both reads there, as it does at stage 2 on the
  one cast replica), casts it to fp32 and reduce-scatters it to its
  owner divided by dp — stage 2's `reduce_implicit` on that leaf — as
  soon as the group's gradients are complete;
* under `remat` the unit's scope runs inside `torch.utils.checkpoint`:
  no token is taken, and the recomputation in the backward re-enters
  the scope, which gathers again; a recomputation outside every unit
  reads the root group's backward gather, installed in the modules for
  the backward (`backward_scope`).

So every group is gathered exactly twice a micro step (its forward and
its backward), and at any time the live replicas are the root group's
and at most one unit's.  `live_bytes` / `peak_bytes` count the gathered
replicas alive (weak references, so they see what really holds them).
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Dict, List, Optional

import torch

from ...comm import dist
from ...comm.mesh import DATA_AXIS

# the engine's Stage3Gather while it runs the model (its forward, its
# backward's recomputation and eval)
_ACTIVE: List[Optional["Stage3Gather"]] = [None]


@contextlib.contextmanager
def active(gather: Optional["Stage3Gather"]):
    """Make `gather` the one `gathered()` scopes use, for the body."""
    prev, _ACTIVE[0] = _ACTIVE[0], gather
    try:
        yield
    finally:
        _ACTIVE[0] = prev


class _NoScope:
    """`gathered()` where nothing is gathered: the module reads its own
    parameters."""

    @staticmethod
    def output(x):
        return x


@contextlib.contextmanager
def gathered(module, remat: bool = False):
    """Run a gather unit: inside, `module`'s stage-3 leaves read as whole
    compute-dtype replicas (a no-op outside a stage-3 engine's call).
    `remat`: the body runs under `torch.utils.checkpoint`, whose
    recomputation gathers again.  Yields the scope; pass the unit's
    output through `scope.output(x)`."""
    g = _ACTIVE[0]
    unit = None if g is None else g.unit_of(module)
    if unit is None:
        yield _NoScope
        return
    with g.scope(unit, remat=remat) as scope:
        yield scope


def unit_leaves(model, names):
    """The gather units of `model` — ([(unit name, module, [leaf index])],
    [root leaf indices]), by index into `names` (its parameter names):
    a module flagged `zero3_gather_unit` owns the leaves under it that
    no unit nested in it owns; the root group is every other leaf."""
    unit_mods = [(n, m) for n, m in model.named_modules()
                 if n and getattr(m, "zero3_gather_unit", False)]
    owner_of = {}
    for un, _ in sorted(unit_mods, key=lambda x: -x[0].count(".")):
        for i, n in enumerate(names):
            if i not in owner_of and n.startswith(un + "."):
                owner_of[i] = un
    units = [(un, m, sorted(i for i, u in owner_of.items() if u == un))
             for un, m in unit_mods]
    return units, [i for i in range(len(names)) if i not in owner_of]


def unit_groups(model, names):
    """The leaf groups gathered one collective each: the root group, then
    each unit's."""
    units, root = unit_leaves(model, names)
    return [root] + [idx for _, _, idx in units]


class _Token:
    """A saved tensor that lies in a replica's storage: the group's pass,
    the leaf, and the view's geometry."""

    __slots__ = ("group", "pos", "size", "stride", "offset")

    def __init__(self, group, pos, t):
        self.group, self.pos = group, pos
        self.size, self.stride = tuple(t.size()), tuple(t.stride())
        self.offset = t.storage_offset()


class _GatherFn(torch.autograd.Function):
    """owned fp32 slices -> whole compute-dtype replicas; backward: each
    replica's gradient cast to fp32 and reduce-scattered to its owner."""

    @staticmethod
    def forward(ctx, group, *owned):
        ctx.group = group
        return tuple(group.gather_forward(owned))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(ctx.group.reduce(grads))


class _PreBackward(torch.autograd.Function):
    """The identity on a unit's output; its backward gathers the unit's
    group before the unit's own backward runs."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.group.ensure_backward()
        return None, grad


class _Unit:
    """The leaves of one gather unit (or of the root group), by plan
    index: the gathered ones and the others."""

    def __init__(self, gathered, others):
        self.gathered = gathered
        self.others = others


class _GroupPass:
    """One forward's gather of one group, and its backward."""

    def __init__(self, owner: "Stage3Gather", unit: _Unit):
        self.owner = owner
        self.unit = unit
        self.cache = None       # the backward's replicas
        self.released = False

    def gather_forward(self, owned):
        return self.owner._gather(self.unit.gathered, owned)

    def ensure_backward(self):
        if self.cache is None and not self.released:
            with torch.no_grad():
                self.cache = self.owner._gather(
                    self.unit.gathered,
                    [self.owner.masters[i] for i in self.unit.gathered])

    def replica(self, pos):
        self.ensure_backward()
        return self.cache[pos]

    def reduce(self, grads):
        self.cache = None
        self.released = True
        return self.owner._reduce(self.unit.gathered, grads)


class _Scope:
    def __init__(self, group: _GroupPass, marks: bool):
        self.group = group
        self._marks = marks

    def output(self, x):
        """`x`, marked as the unit's output: the unit is gathered again
        when x's gradient arrives (a no-op without autograd or under
        remat, where the recomputation gathers)."""
        if not self._marks or not torch.is_tensor(x) or \
                not x.requires_grad:
            return x
        return _PreBackward.apply(self.group, x)


class Stage3Gather:
    """The engine's stage-3 gather on use over `model`, whose parameters
    `masters` (plan order, named `names`) are the fp32 slices of the
    plan's gathered leaves and the whole fp32 masters of the others.
    `qwz`: a `QuantizedWeightGather` that carries the gathers, or None
    for the compute-dtype all-gather."""

    def __init__(self, model, plan, names, masters, compute_dtype,
                 qwz=None):
        self.plan = plan
        self.names = list(names)
        self.masters = list(masters)
        self.compute_dtype = compute_dtype
        self.qwz = qwz
        self.dp = plan.mesh_info.axis_size(DATA_AXIS)
        self._slots = []
        for n in self.names:
            mod, _, attr = n.rpartition(".")
            self._slots.append((model.get_submodule(mod), attr))
        units, root = unit_leaves(model, self.names)
        self._units: Dict[int, _Unit] = {
            id(m): self._make_unit(idx) for _, m, idx in units}
        self.root = self._make_unit(root)
        self.groups = [u.gathered for u in [self.root,
                                            *self._units.values()]
                       if u.gathered]
        self._storages: Dict[int, tuple] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.gathers = 0

    def _make_unit(self, idx):
        gathered = [i for i in idx if self.plan.leaves[i].gathered]
        return _Unit(gathered, [i for i in idx if i not in gathered])

    def unit_of(self, module) -> Optional[_Unit]:
        return self._units.get(id(module))

    def group_bytes(self) -> List[int]:
        """Each group's replica bytes (root first)."""
        size = torch.finfo(self.compute_dtype).bits // 8
        return [sum(_numel(self.plan.leaves[i].shape) for i in g) * size
                for g in self.groups]

    # -- the collectives -------------------------------------------------

    def _gather(self, idx, owned) -> list:
        slices = [o.detach().to(self.compute_dtype) for o in owned]
        if self.qwz is not None:
            reps = self.qwz.gather_leaves(idx, slices, self.compute_dtype)
        else:
            reps = self.plan.gather_whole(idx, slices, self.compute_dtype)
        for r in reps:
            nbytes = r.numel() * r.element_size()
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(r, self._freed, nbytes)
        self.gathers += 1
        return reps

    def _freed(self, nbytes):
        self.live_bytes -= nbytes

    def _reduce(self, idx, grads) -> list:
        """The replicas' gradients -> the owners' fp32 slices of the
        data-parallel mean (a reduce-scatter a leaf, in plan order)."""
        out = []
        for i, g in zip(idx, grads):
            lp = self.plan.leaves[i]
            if g is None:
                out.append(torch.zeros(lp.owned_shape, dtype=torch.float32,
                                       device=self.masters[i].device))
                continue
            g = dist.reduce_scatter(g.to(torch.float32), DATA_AXIS,
                                    scatter_axis=lp.dim)
            out.append(g.div_(self.dp))
        return out

    # -- the scopes ------------------------------------------------------

    def _pack(self, t):
        try:
            ptr = t.untyped_storage().data_ptr()
        except (RuntimeError, NotImplementedError):
            return t
        hit = self._storages.get(ptr) if ptr else None
        return t if hit is None else _Token(hit[0], hit[1], t)

    @staticmethod
    def _unpack(obj):
        if not isinstance(obj, _Token):
            return obj
        base = obj.group.replica(obj.pos)
        return base.as_strided(obj.size, obj.stride, obj.offset)

    @contextlib.contextmanager
    def scope(self, unit: _Unit, remat: bool = False):
        group = _GroupPass(self, unit)
        grad = torch.is_grad_enabled()
        reps = []
        if unit.gathered:
            owned = [self.masters[i] for i in unit.gathered]
            reps = list(_GatherFn.apply(group, *owned) if grad
                        else group.gather_forward(owned))
        track = grad and not remat
        swapped = []
        try:
            for pos, (i, r) in enumerate(zip(unit.gathered, reps)):
                swapped.append(self._install(i, r))
                if track:
                    self._storages[r.untyped_storage().data_ptr()] = (
                        group, pos)
            for i in unit.others:
                swapped.append(self._install(
                    i, self.masters[i].to(self.compute_dtype)))
            del reps
            yield _Scope(group, marks=track and bool(unit.gathered))
        finally:
            for mod, attr, old in reversed(swapped):
                mod._parameters[attr] = old
            if track:
                for ptr, (g, _) in list(self._storages.items()):
                    if g is group:
                        del self._storages[ptr]

    def _install(self, i, tensor):
        mod, attr = self._slots[i]
        old = mod._parameters[attr]
        mod._parameters[attr] = tensor
        return mod, attr, old

    @contextlib.contextmanager
    def backward_scope(self, root):
        """Through the backward, the root group's leaves read as their
        compute-dtype replicas (its backward gather, `root` the forward's
        root scope): a recomputation outside every gather unit (a region
        under `torch.utils.checkpoint` that reads the module's parameters)
        sees what the forward saw."""
        group = root.group
        swapped = []
        try:
            # leaves that need a gradient, as the forward's did, so that
            # a recomputation saves what the forward saved
            if self.root.gathered:
                group.ensure_backward()
                for i, r in zip(self.root.gathered, group.cache):
                    swapped.append(self._install(
                        i, r.detach().requires_grad_()))
            for i in self.root.others:
                swapped.append(self._install(
                    i, self.masters[i].detach().to(self.compute_dtype)
                    .requires_grad_()))
            yield
        finally:
            for mod, attr, old in reversed(swapped):
                mod._parameters[attr] = old

    @contextlib.contextmanager
    def root_scope(self):
        """The root group around the whole model call, with the saved
        tensor hooks under autograd.  The caller makes this gather
        `active` for the call and for its backward."""
        hooks = (torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          self._unpack)
                 if torch.is_grad_enabled() else contextlib.nullcontext())
        with hooks, self.scope(self.root) as scope:
            yield scope


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n

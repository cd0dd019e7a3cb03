"""Sort-based MoE dispatch and combine — the single-device part of
deepspeed_tpu/moe/dispatch.py.

* `MoEWireConfig` (:91), `parse_moe_config` (:135), `get_wire_config` /
  `set_wire_config` / `moe_wire` (:257-285): the validated `comm.moe`
  block, installed process-globally by `initialize`.
* `topk_routing` (:287): the one routing core of both dispatch engines —
  iterative argmax-and-mask expert choice, then queue positions from one
  stable argsort of the round-major assignment list, in exact int32;
  `keep = pos < capacity`.
* `sorted_dispatch` / `sorted_combine` (:337-355): token movement through
  the kernel registry (kernels #13 and #14 on the card), each a
  `torch.autograd.Function`; their plain versions `sorted_dispatch_ref` /
  `sorted_combine_ref` (:358-394) are the JAX expressions.
* dropless mode (`overflow_capacity`, `overflow_dispatch`,
  `overflow_ffn`, `overflow_combine`, :396-446): assignments past their
  expert's capacity take a second bucket of ceil(f·k·S) slots a token
  row, kept by JAX's rule (`overflow_keep`).  JAX computes that bucket's
  FFN as a one-hot contraction over the experts (O·E·d·f); here each
  kept assignment gets a slot in its expert's contiguous segment of the
  B rows' buckets together (`overflow_slots`), the bucket moves through
  kernels #13/#14 as one group with one "expert" of B·O slots, and each
  expert segment takes one GEMM.  The function is JAX's; only the
  slot order inside the bucket is the port's own.
* `record_dispatch_stats` (:455-468): the `moe.dropped_tokens` /
  `moe.capacity_frac` counters.

The JAX functions take one token group and are vmapped over the batch
rows by their caller; these take the rows as a leading batch dimension:
routing tensors [B, k, N], tokens [B, N, D], expert buckets
[B, E, C, D].  Autograd: the JAX package differentiates the plain
expressions (it has no backward kernel); here the dispatch's gradient is
a combine with unit weights, and the combine's gradient is a per-slot
gather of w·g (a weighted dispatch) and, for the gate, a row dot product
rounded through the output dtype as the JAX cotangent of `astype` is —
the first two through the same registry ops, all in a fixed summation
order (no atomics).

Counters are read without stalling the host: `record_dispatch_stats`
keeps the per-layer device tensors, and `flush_dispatch_stats` (the
engine calls it once a step) moves them to the host in one asynchronous
copy and credits the counters once the copy has landed (`wait=True`
waits for it).

Not ported (they need more than one device): the explicit all-to-all
wire (`build_a2a_plan`, `wire_all_to_all`, `wire_engagement`) and
`overlap`; asking for them raises NotImplementedError naming the ROADMAP
item.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional

import torch

from ..kernels import registry
from ..monitor.counters import COUNTERS
from ..runtime.comm.quant import DEFAULT_BLOCK_SIZE, validate_block_size
from ..utils.logging import logger

DISPATCH_MODES = ("dense", "sorted")
A2A_WIRES = ("fp32", "bf16", "int8", "int4")
PLACEMENT_MODES = ("auto", "data", "inner")
OVERLAP_MODES = ("none", "auto", "on")


# ---------------------------------------------------------------------------
# wire configuration (the validated `comm.moe` block)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEWireConfig:
    """Process-global MoE token-movement selection.  The default is the
    JAX package's: dense one-hot dispatch, counters on."""

    dispatch: str = "dense"            # "dense" | "sorted"
    a2a_wire_dtype: Optional[str] = None   # None -> implicit exchange
    a2a_wire_dtype_inner: Optional[str] = None
    a2a_wire_dtype_outer: Optional[str] = None
    placement: str = "auto"            # "auto" | "data" | "inner"
    dropless: bool = False
    overflow_factor: float = 0.25
    quant_block_size: int = DEFAULT_BLOCK_SIZE
    overlap: str = "none"
    counters: bool = True

    @property
    def explicit(self) -> bool:
        return (self.a2a_wire_dtype is not None
                or self.a2a_wire_dtype_inner is not None
                or self.a2a_wire_dtype_outer is not None)

    def describe(self) -> str:
        return (f"moe wire: dispatch={self.dispatch}, a2a=implicit, "
                f"dropless={self.dropless}")


def _refuse_unported(cfg: MoEWireConfig) -> MoEWireConfig:
    """A valid selection that needs what the port has not got yet."""
    if cfg.explicit:
        raise NotImplementedError(
            "comm.moe.a2a_wire_dtype: the explicit expert all-to-all wire "
            "needs more than one device and is not ported yet (ROADMAP "
            "queue 1: the explicit MoE wire)")
    if cfg.overlap != "none":
        raise NotImplementedError(
            f"comm.moe.overlap={cfg.overlap!r}: the overlapped wire is not "
            f"ported yet (ROADMAP queue 1: the explicit MoE wire)")
    return cfg


def parse_moe_config(d, default_block: int = DEFAULT_BLOCK_SIZE
                     ) -> MoEWireConfig:
    """Validate the `comm.moe` dict -> MoEWireConfig, with the JAX
    package's errors (ValueError naming the key and the valid set) for
    unknown keys and bad values, then NotImplementedError for a valid
    selection the port does not run yet."""
    d = d or {}
    if not isinstance(d, dict):
        raise ValueError(
            f"comm.moe must be an object, got {type(d).__name__}")
    known = {"dispatch", "a2a_wire_dtype", "a2a_wire_dtype_inner",
             "a2a_wire_dtype_outer", "placement", "dropless",
             "overflow_factor", "quant_block_size", "overlap", "counters"}
    unknown = set(d) - known
    if unknown:
        raise ValueError(
            f"comm.moe: unknown key(s) {sorted(unknown)}; expected a "
            f"subset of {sorted(known)}")

    def wire_param(key):
        w = d.get(key)
        if w is None:
            return None
        w = str(w).lower()
        if w not in A2A_WIRES:
            raise ValueError(
                f"comm.moe.{key} must be one of {A2A_WIRES}, got {w!r}")
        return w

    base = wire_param("a2a_wire_dtype")
    inner = wire_param("a2a_wire_dtype_inner")
    outer = wire_param("a2a_wire_dtype_outer")
    if base is None and (inner is not None or outer is not None):
        base = "fp32"
    dispatch = str(d.get("dispatch",
                         "sorted" if base is not None else "dense")).lower()
    if dispatch not in DISPATCH_MODES:
        raise ValueError(
            f"comm.moe.dispatch must be one of {DISPATCH_MODES}, "
            f"got {dispatch!r}")
    if base is not None and "dispatch" in d and dispatch != "sorted":
        raise ValueError(
            "comm.moe.a2a_wire_dtype requires comm.moe.dispatch='sorted' "
            f"(got dispatch={dispatch!r}; valid: ('sorted',))")
    placement = str(d.get("placement", "auto")).lower()
    if placement not in PLACEMENT_MODES:
        raise ValueError(
            f"comm.moe.placement must be one of {PLACEMENT_MODES}, "
            f"got {placement!r}")
    if placement != "auto" and base is None:
        raise ValueError(
            f"comm.moe.placement={placement!r} only applies to the "
            f"explicit a2a wire; set comm.moe.a2a_wire_dtype (valid: "
            f"{A2A_WIRES}) or leave placement 'auto'")
    dropless = d.get("dropless", False)
    if not isinstance(dropless, bool):
        raise ValueError(
            f"comm.moe.dropless must be a bool, got {dropless!r}")
    if dropless and dispatch != "sorted":
        raise ValueError(
            "comm.moe.dropless requires comm.moe.dispatch='sorted'")
    if dropless and base is not None:
        raise ValueError(
            "comm.moe.dropless cannot ride the explicit a2a wire "
            "(valid: dropless with a2a_wire_dtype null)")
    of = d.get("overflow_factor", 0.25)
    if isinstance(of, bool) or not isinstance(of, (int, float)) or of <= 0:
        raise ValueError(
            f"comm.moe.overflow_factor must be a number > 0, got {of!r}")
    overlap = d.get("overlap", "none")
    if isinstance(overlap, bool):
        overlap = "on" if overlap else "none"
    overlap = str(overlap).lower()
    if overlap not in OVERLAP_MODES:
        raise ValueError(
            f"comm.moe.overlap must be one of {OVERLAP_MODES} (or a "
            f"bool), got {d.get('overlap')!r}")
    block = d.get("quant_block_size", default_block)
    try:
        block = validate_block_size(block)
    except ValueError as e:
        raise ValueError(f"comm.moe.quant_block_size: {e}")
    counters = d.get("counters", True)
    if not isinstance(counters, bool):
        raise ValueError(
            f"comm.moe.counters must be a bool, got {counters!r}")
    return _refuse_unported(MoEWireConfig(
        dispatch=dispatch, a2a_wire_dtype=base,
        a2a_wire_dtype_inner=inner, a2a_wire_dtype_outer=outer,
        placement=placement, dropless=dropless,
        overflow_factor=float(of), quant_block_size=block,
        overlap=overlap, counters=bool(counters)))


_WIRE_CONFIG = MoEWireConfig()


def get_wire_config() -> MoEWireConfig:
    return _WIRE_CONFIG


def set_wire_config(cfg: MoEWireConfig) -> MoEWireConfig:
    """Install `cfg` process-globally; returns the previous config."""
    global _WIRE_CONFIG
    prev = _WIRE_CONFIG
    _WIRE_CONFIG = _refuse_unported(cfg)
    if cfg != prev:
        logger.debug(cfg.describe())
    return prev


@contextlib.contextmanager
def moe_wire(cfg: Optional[MoEWireConfig] = None, **kwargs):
    """Scoped wire config for direct layer users and tests:
    `with moe_wire(dispatch="sorted"): ...`"""
    prev = set_wire_config(cfg if cfg is not None
                           else MoEWireConfig(**kwargs))
    try:
        yield get_wire_config()
    finally:
        set_wire_config(prev)


# ---------------------------------------------------------------------------
# routing core (shared by the dense one-hot and sorted engines)
# ---------------------------------------------------------------------------

def topk_routing(probs, k: int, capacity: int):
    """GShard top-k routing for token groups.

    probs [..., N, E] fp32 -> (eidx int32, gate fp32, pos int32, keep
    bool), each [..., k, N] round-major, and aux [...].  Round r picks
    each token's r-th expert by argmax (the first of equal maxima) and
    masks it; an assignment's queue position is its rank within its
    expert's segment of one stable argsort of the round-major list, so
    earlier rounds queue first (GShard's priority order)."""
    *lead, N, E = probs.shape
    masked = probs
    eidxs, gates = [], []
    aux = torch.zeros(lead, dtype=torch.float32, device=probs.device)
    for _ in range(k):
        idx = torch.argmax(masked, dim=-1)                       # [..., N]
        onehot = torch.nn.functional.one_hot(idx, E).to(torch.float32)
        gates.append(torch.gather(probs, -1, idx[..., None])[..., 0])
        eidxs.append(idx)
        aux = aux + (onehot.mean(dim=-2) * probs.mean(dim=-2)).sum(-1) * E
        masked = masked * (1.0 - onehot)  # the next round picks a new expert
    eidx = torch.stack(eidxs, dim=-2)                            # [..., k, N]
    gate = torch.stack(gates, dim=-2)
    e_flat = eidx.reshape(*lead, k * N)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    counts = torch.zeros(*lead, E, dtype=torch.int64, device=probs.device)
    counts.scatter_add_(-1, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, dim=-1) - counts
    rank = (torch.arange(k * N, device=probs.device) -
            torch.gather(starts, -1, torch.gather(e_flat, -1, order)))
    pos = torch.zeros_like(e_flat).scatter_(-1, order, rank)
    pos = pos.reshape(*lead, k, N).to(torch.int32)
    return eidx.to(torch.int32), gate, pos, pos < capacity, aux / k


# ---------------------------------------------------------------------------
# sorted dispatch / combine
# ---------------------------------------------------------------------------

def _slot_sources(eidx, pos, keep, capacity, trash):
    """Flat slot index e * C + pos of each assignment [B, k * N], or
    `trash` where it is dropped."""
    B = eidx.shape[0]
    return torch.where(keep, eidx.long() * capacity + pos.long(),
                       trash).reshape(B, -1)


def _weights(gate, keep, dtype):
    """The combine weight (gate * keep) cast through the output dtype;
    the unit weight keep without a gate."""
    w = keep.to(torch.float32) if gate is None else gate * keep
    return w.to(dtype)


def sorted_dispatch_ref(x, eidx, pos, keep, num_experts: int,
                        capacity: int, gate=None):
    """x [B, N, D] + routing [B, k, N] -> expert inputs [B, E, C, D]
    (dispatch.py:358): the selected token rows scatter-added into a
    zeroed [E * C + 1 trash, D] buffer per group; kept destinations are
    unique, dropped ones land on the trash row.  With `gate`, each row is
    first scaled by its weight (the combine's gradient)."""
    B, N, D = x.shape
    k = eidx.shape[1]
    E, C = int(num_experts), int(capacity)
    dest = _slot_sources(eidx, pos, keep, C, E * C)             # [B, kN]
    tok = torch.arange(N, device=x.device).repeat(k)
    w = _weights(gate, keep, x.dtype).reshape(B, k * N, 1)
    vals = x[:, tok] * w
    buf = x.new_zeros((B, E * C + 1, D))
    buf.scatter_add_(1, dest[..., None].expand(B, k * N, D), vals)
    return buf[:, :E * C].reshape(B, E, C, D)


def _picked(expert_out, eidx, pos, keep):
    """Each assignment's slot row [B, k, N, D]; a dropped assignment reads
    the zero trash row."""
    B, E, C, D = expert_out.shape
    k, N = eidx.shape[1:]
    flat = torch.cat([expert_out.reshape(B, E * C, D),
                      expert_out.new_zeros((B, 1, D))], dim=1)
    src = _slot_sources(eidx, pos, keep, C, E * C)
    return torch.gather(flat, 1, src[..., None].expand(B, k * N, D)).reshape(
        B, k, N, D)


def sorted_combine_ref(expert_out, eidx, gate, pos, keep):
    """expert outputs [B, E, C, D] + routing -> y [B, N, D]
    (dispatch.py:380): each assignment's slot gathered, times its weight
    in the output dtype, summed over the k rounds."""
    w = _weights(gate, keep, expert_out.dtype)
    return (_picked(expert_out, eidx, pos, keep) * w[..., None]).sum(dim=1)


_UNIT_ROUNDOFF = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8,
                  torch.float16: 2.0 ** -11}


def combine_tolerance(expert_out, eidx, gate, pos, keep):
    """Per-element bound on |kernel - plain| of the combine, one ulp of
    the output per term: with t_r the exact products w_r · e_r, the plain
    version forms a = sum_r T(t_r) (the products rounded to the output
    dtype T, unit roundoff u, then summed) and rounds a; the kernel
    forms b = sum_r t_r in fp32 and rounds b.  |a - b| <= u sum|t_r|, and
    each final rounding adds at most u |a| or u |b|, so the two differ by
    at most 3u sum_r |t_r|, plus 2^-22 sum_r |t_r| for the fp32 sums
    (k <= 4 terms) and one FMA against a multiply and an add."""
    u = _UNIT_ROUNDOFF[expert_out.dtype]
    terms = sorted_combine_ref(expert_out.float().abs(), eidx,
                               None if gate is None else gate.abs(), pos,
                               keep)
    return (3 * u + 2.0 ** -22) * terms.float()


class _DispatchFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, eidx, pos, keep, num_experts, capacity):
        ctx.save_for_backward(eidx, pos, keep)
        return registry.dispatch("moe_dispatch", x, eidx, pos, keep,
                                 num_experts, capacity)

    @staticmethod
    def backward(ctx, g):
        eidx, pos, keep = ctx.saved_tensors
        # each token's gradient: the sum of its kept slots' gradients
        dx = registry.dispatch("moe_combine", g.contiguous(), eidx, None,
                               pos, keep)
        return dx, None, None, None, None, None


class _CombineFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, expert_out, eidx, gate, pos, keep):
        ctx.save_for_backward(expert_out, eidx, gate, pos, keep)
        return registry.dispatch("moe_combine", expert_out, eidx, gate, pos,
                                 keep)

    @staticmethod
    def backward(ctx, gy):
        expert_out, eidx, gate, pos, keep = ctx.saved_tensors
        E, C = expert_out.shape[1:3]
        gy = gy.contiguous()
        d_out = d_gate = None
        if ctx.needs_input_grad[0]:
            # slot s of assignment a gets w_a · gy[token of a]
            d_out = registry.dispatch("moe_dispatch", gy, eidx, pos, keep, E,
                                      C, gate=gate)
        if ctx.needs_input_grad[2]:
            d_gate = combine_gate_grad(expert_out, eidx, gate, pos, keep, gy)
        return d_out, None, d_gate, None, None


def combine_gate_grad(expert_out, eidx, gate, pos, keep, gy):
    """The combine's gradient in `gate` [B, k, N]: d w[r, n] = gy[n] .
    out[slot of (r, n)], in the output dtype (the cotangent of the JAX
    `astype`), times keep.  Plain PyTorch: a gather, an fp32 product and a
    sum (no Pallas kernel computes it)."""
    acc = torch.promote_types(expert_out.dtype, torch.float32)
    dw = (_picked(expert_out, eidx, pos, keep).to(acc) *
          gy[:, None].to(acc)).sum(-1)
    return dw.to(expert_out.dtype).to(gate.dtype) * keep


def sorted_dispatch(x, eidx, pos, keep, num_experts: int, capacity: int):
    """x [B, N, D] -> expert inputs [B, E, C, D] through the registry
    (kernel #13 for CUDA tensors; bit-exact with `sorted_dispatch_ref`)."""
    return _DispatchFn.apply(x, eidx.contiguous(), pos.contiguous(),
                             keep.contiguous(), int(num_experts),
                             int(capacity))


def sorted_combine(expert_out, eidx, gate, pos, keep):
    """expert outputs [B, E, C, D] -> y [B, N, D] through the registry
    (kernel #14 for CUDA tensors; within `combine_tolerance` of
    `sorted_combine_ref`)."""
    return _CombineFn.apply(expert_out.contiguous(), eidx.contiguous(),
                            gate.contiguous(), pos.contiguous(),
                            keep.contiguous())


# ---------------------------------------------------------------------------
# dropless: the overflow bucket
# ---------------------------------------------------------------------------

def overflow_capacity(k: int, tokens: int, factor: float) -> int:
    """Overflow-bucket slots of one token row: ceil(factor · k · tokens)
    (dispatch.py:396); factor 1.0 holds every assignment."""
    return max(1, int(math.ceil(factor * k * tokens - 1e-9)))


def overflow_keep(keep, ov_cap: int):
    """JAX's rule for the overflow bucket (dispatch.py:403-408), per token
    row: an assignment past its expert's capacity ranks by its place in
    the row's round-major list of such assignments, and is kept iff that
    rank is below `ov_cap`.  keep [B, k, N] -> (ov_rank int32, ov_keep
    bool), each [B, k, N]."""
    B, k, N = keep.shape
    ov_mask = ~keep.reshape(B, k * N)
    ov_rank = torch.cumsum(ov_mask.to(torch.int32), dim=-1,
                           dtype=torch.int32) - 1
    ov_keep = ov_mask & (ov_rank < ov_cap)
    return ov_rank.reshape(B, k, N), ov_keep.reshape(B, k, N)


def overflow_slots(eidx, ov_keep, num_experts: int):
    """Expert-grouped slots of the kept overflow assignments, over the B
    rows' buckets together: a stable sort by (expert, row, rank) — a
    row's round-major order is its rank order — so each expert's kept
    assignments fill a contiguous segment.  -> (slot int32 [B, k, N], 0
    where not kept; per-expert counts int64 [E])."""
    E = int(num_experts)
    e = torch.where(ov_keep, eidx.long(), E).reshape(-1)
    order = torch.argsort(e, stable=True)
    slot = torch.empty_like(e).scatter_(
        0, order, torch.arange(e.numel(), device=e.device))
    slot = torch.where(ov_keep.reshape(-1), slot, 0)
    counts = torch.zeros(E + 1, dtype=torch.int64, device=e.device)
    counts.scatter_add_(0, e, torch.ones_like(e))
    return slot.reshape(ov_keep.shape).to(torch.int32), counts[:E]


def _one_group(t):
    """Routing [B, k, N] -> [1, k, B·N]: the B rows as one token group,
    token b·N + n (the layout of x.reshape(1, B·N, D))."""
    B, k, N = t.shape
    return t.permute(1, 0, 2).reshape(1, k, B * N).contiguous()


def overflow_dispatch(x, slot, ov_keep, capacity: int):
    """x [B, N, D] -> the overflow bucket [capacity, D] (capacity = B·O):
    kernel #13 with one "expert" and the B rows as one group, each kept
    assignment's token row copied to its slot, empty slots zero — JAX's
    bucket rows (dispatch.py:410-414), in expert-grouped order."""
    B, N, D = x.shape
    zeros = torch.zeros_like(slot)
    return sorted_dispatch(x.reshape(1, B * N, D), _one_group(zeros),
                           _one_group(slot), _one_group(ov_keep), 1,
                           capacity).reshape(capacity, D)


def overflow_ffn(bucket, counts: List[int], w1, b1, w2, b2):
    """The expert FFN over the expert-grouped bucket: one GEMM pair per
    non-empty expert segment.  JAX's `overflow_ffn` (:424) selects each
    row's weights by a one-hot contraction, O·E·d·f operations and an
    [O, E, f] intermediate; the segments cost O·d·f.  Rows past the kept
    ones stay zero (the combine never reads them).  The experts' weights
    are taken apart by one `unbind` each, whose gradient is one stack:
    indexing `w1[e]` an expert would make each expert's gradient a
    zero-filled tensor of every expert's weights."""
    w1s, b1s, w2s, b2s = (t.unbind(0) for t in (w1, b1, w2, b2))
    outs, start = [], 0
    for e, n in enumerate(counts):
        if n:
            h = bucket[start:start + n] @ w1s[e] + b1s[e]
            h = torch.nn.functional.gelu(h, approximate="tanh")
            outs.append(h @ w2s[e] + b2s[e])
            start += n
    if start < bucket.shape[0]:
        outs.append(bucket.new_zeros((bucket.shape[0] - start,
                                      bucket.shape[1])))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def overflow_combine(ov_out, gate, slot, ov_keep, B: int, N: int):
    """The bucket's outputs back to tokens, gated like the primary
    combine (dispatch.py:434): kernel #14 over the one-group view ->
    y_ov [B, N, D]."""
    C, D = ov_out.shape
    zeros = torch.zeros_like(slot)
    y = sorted_combine(ov_out.reshape(1, 1, C, D), _one_group(zeros),
                       _one_group(gate), _one_group(slot),
                       _one_group(ov_keep))
    return y.reshape(B, N, D)


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

_PENDING: List[tuple] = []     # (dropped, used) device scalars, total slots
_IN_FLIGHT: List[tuple] = []   # (event or None, host tensor, total slots)


def record_dispatch_stats(dropped, used, total_slots: int) -> None:
    """Keep one MoE call's routing stats (device scalars) for the next
    `flush_dispatch_stats`; nothing is read here.  A caller that never
    flushes (a layer driven without the engine) has them sent on every
    256 calls."""
    _PENDING.append((dropped.detach(), used.detach(), int(total_slots)))
    if len(_PENDING) >= 256:
        flush_dispatch_stats()


def _credit(host, totals) -> None:
    for (dropped, used), total in zip(host.tolist(), totals):
        COUNTERS.add("moe.dropped_tokens", int(dropped))
        # ppm-in-bytes convention: mean utilisation % = bytes / calls / 1e4
        COUNTERS.add("moe.capacity_frac",
                     int(round(1e6 * float(used) / max(total, 1))))


def flush_dispatch_stats(wait: bool = False) -> None:
    """Copy the pending stats to the host in one asynchronous transfer,
    and credit `moe.dropped_tokens` / `moe.capacity_frac` for every
    transfer that has landed (all of them with `wait`)."""
    if _PENDING:
        vals = torch.stack([torch.stack([d, u]) for d, u, _ in _PENDING])
        totals = [t for _, _, t in _PENDING]
        _PENDING.clear()
        if vals.is_cuda:
            host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
            host.copy_(vals, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            _IN_FLIGHT.append((event, host, totals))
        else:
            _IN_FLIGHT.append((None, vals, totals))
    while _IN_FLIGHT:
        event, host, totals = _IN_FLIGHT[0]
        if event is not None and not wait and not event.query():
            break
        if event is not None:
            event.synchronize()
        _credit(host, totals)
        _IN_FLIGHT.pop(0)

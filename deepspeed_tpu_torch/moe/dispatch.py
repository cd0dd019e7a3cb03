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
* the explicit expert all-to-all wire (:471-754): `A2AHop` / `A2APlan`
  (the hop sequence and its exact bytes), `resolve_placement`,
  `expert_axes`, `build_a2a_plan`, `_hop_a2a` (one hop over one mesh
  axis's process group: fp32 / bf16 cast and exchanged, int8 / int4
  quantized per destination chunk with kernel #11, the fused buffers
  exchanged, dequantized per source chunk with kernel #12),
  `wire_all_to_all` (the hops with a mirrored backward) and
  `wire_engagement` (whether a call can take the wire, each fallback
  logged once).  `moe/layer.py` `_sorted_wire` drives them.

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

`comm.moe.overlap` "auto" / "on" is accepted and logged, and the wire
runs serially, as in the JAX package (:740-752).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..comm import dist
from ..comm.mesh import (DATA_AXIS, DATA_INNER_AXIS, DATA_OUTER_AXIS,
                         MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, MeshInfo, peek_mesh)
from ..kernels import registry
from ..monitor.counters import COUNTERS
from ..runtime.comm.quant import (DEFAULT_BLOCK_SIZE, dequantize_blockwise,
                                  pack_wire, payload_bytes,
                                  quantize_blockwise, unpack_wire,
                                  validate_block_size)
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

    def wire_inner(self) -> str:
        return self.a2a_wire_dtype_inner or self.a2a_wire_dtype or "fp32"

    def wire_outer(self) -> str:
        return self.a2a_wire_dtype_outer or self.a2a_wire_dtype or "fp32"

    def describe(self) -> str:
        if not self.explicit:
            return (f"moe wire: dispatch={self.dispatch}, a2a=implicit, "
                    f"dropless={self.dropless}")
        return (f"moe wire: dispatch={self.dispatch}, a2a=explicit "
                f"inner={self.wire_inner()} outer={self.wire_outer()} "
                f"placement={self.placement} block={self.quant_block_size}")


def parse_moe_config(d, default_block: int = DEFAULT_BLOCK_SIZE
                     ) -> MoEWireConfig:
    """Validate the `comm.moe` dict -> MoEWireConfig, with the JAX
    package's errors (ValueError naming the key and the valid set) for
    unknown keys and bad values."""
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
    return MoEWireConfig(
        dispatch=dispatch, a2a_wire_dtype=base,
        a2a_wire_dtype_inner=inner, a2a_wire_dtype_outer=outer,
        placement=placement, dropless=dropless,
        overflow_factor=float(of), quant_block_size=block,
        overlap=overlap, counters=bool(counters))


_WIRE_CONFIG = MoEWireConfig()


def get_wire_config() -> MoEWireConfig:
    return _WIRE_CONFIG


def set_wire_config(cfg: MoEWireConfig) -> MoEWireConfig:
    """Install `cfg` process-globally; returns the previous config."""
    global _WIRE_CONFIG
    prev = _WIRE_CONFIG
    _WIRE_CONFIG = cfg
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


# ---------------------------------------------------------------------------
# the explicit expert all-to-all wire
# ---------------------------------------------------------------------------

_WIRE_ITEMSIZE = {"fp32": 4, "bf16": 2}


def _bump_a2a(nbytes: int, inter: bool) -> None:
    COUNTERS.add("moe.a2a_bytes", nbytes)
    if inter:
        COUNTERS.add("moe.a2a_inter", nbytes)


@dataclasses.dataclass(frozen=True)
class A2AHop:
    axis: str        # mesh axis name
    dim: int         # which leading buffer dim this hop exchanges
    world: int
    wire: str        # fp32 | bf16 | int8 | int4
    inter: bool      # True = the slow-fabric (data_outer) hop


@dataclasses.dataclass(frozen=True)
class A2APlan:
    """One MoE layer's expert exchange on this mesh (dispatch.py:481):
    the hop sequence (fast to slow on dispatch) and each hop's exact wire
    bytes for one traversal of one rank, which `moe.a2a_bytes` is held
    to."""

    hops: Tuple[A2AHop, ...]
    ep: int                  # expert-parallel width (product of worlds)
    local_elems: int         # buffer elements a rank (the same every hop)
    quant_block: int

    def hop_bytes(self, hop: A2AHop) -> int:
        if hop.wire in _WIRE_ITEMSIZE:
            return self.local_elems * _WIRE_ITEMSIZE[hop.wire]
        chunk = self.local_elems // hop.world
        return hop.world * payload_bytes(chunk, hop.wire, self.quant_block)

    @property
    def bytes_per_traversal(self) -> int:
        """Wire bytes one rank moves in one direction (dispatch or
        combine); a training step runs 4 traversals a layer (the forward
        dispatch and combine and their mirrored backward), eval 2."""
        return sum(self.hop_bytes(h) for h in self.hops)

    @property
    def inter_bytes_per_traversal(self) -> int:
        return sum(self.hop_bytes(h) for h in self.hops if h.inter)

    @property
    def hops_per_traversal(self) -> int:
        return len(self.hops)

    def describe(self) -> str:
        legs = ", ".join(
            f"{h.axis}[{h.world}]={h.wire}"
            f"{' (slow)' if h.inter else ''}" for h in self.hops)
        return (f"moe a2a: ep={self.ep}, {legs}, "
                f"{self.bytes_per_traversal} B/traversal/shard")


def resolve_placement(wcfg: MoEWireConfig, mesh_info: MeshInfo) -> str:
    """"inner" keeps the experts on `data_inner` (the exchange never
    leaves the fast fabric) where the mesh is factored; a flat mesh and
    placement "data" use the whole data axis (dispatch.py:523)."""
    if wcfg.placement == "inner":
        return "inner" if mesh_info.hierarchical else "data"
    if wcfg.placement == "data":
        return "data"
    return "inner" if mesh_info.hierarchical else "data"


def expert_axes(wcfg: MoEWireConfig, mesh_info: MeshInfo
                ) -> Tuple[str, ...]:
    """The mesh axes the expert dim is sharded over under the explicit
    wire (= the hops' axes, outermost first)."""
    if resolve_placement(wcfg, mesh_info) == "inner":
        return (DATA_INNER_AXIS,)
    return mesh_info.data_axes


def build_a2a_plan(wcfg: MoEWireConfig, mesh_info: MeshInfo,
                   num_experts: int, local_rows: int, capacity: int,
                   d_model: int) -> A2APlan:
    """The static plan of one MoE layer's exchange (dispatch.py:546):
    `local_rows` is this rank's batch rows (B / dp); the buffer holds
    E · local_rows · C · D elements on every hop (an all-to-all
    permutes, never grows)."""
    axes = expert_axes(wcfg, mesh_info)
    local_elems = num_experts * local_rows * capacity * d_model
    hops = []
    if len(axes) == 1:
        wire = (wcfg.wire_inner() if axes[0] == DATA_INNER_AXIS
                else wcfg.wire_outer() if axes[0] == DATA_OUTER_AXIS
                else (wcfg.a2a_wire_dtype or "fp32"))
        hops.append(A2AHop(axis=axes[0], dim=0,
                           world=mesh_info.axis_size(axes[0]), wire=wire,
                           inter=axes[0] == DATA_OUTER_AXIS))
    else:
        # dispatch takes the fast hop first (regroup inside the node,
        # then one aggregated slow exchange)
        outer_ax, inner_ax = axes
        hops.append(A2AHop(axis=inner_ax, dim=1,
                           world=mesh_info.axis_size(inner_ax),
                           wire=wcfg.wire_inner(), inter=False))
        hops.append(A2AHop(axis=outer_ax, dim=0,
                           world=mesh_info.axis_size(outer_ax),
                           wire=wcfg.wire_outer(), inter=True))
    return A2APlan(hops=tuple(hops), ep=mesh_info.axes_extent(axes)[0],
                   local_elems=local_elems,
                   quant_block=wcfg.quant_block_size)


def _hop_a2a(buf, hop: A2AHop, plan: A2APlan, record: bool):
    """One all-to-all hop on `buf` (leading dims: the hop grid) over
    `hop.axis`'s process group (dispatch.py:579).  fp32 / bf16: cast and
    exchanged.  int8 / int4: the hop dim moved first and each destination
    chunk quantized on its own (blocks never straddle chunks), with
    kernel #11 in one launch over every chunk, each chunk zero-padded to
    whole blocks first when the block does not divide it (the bits of a
    per-chunk quantize); payload and scales fused into one uint8 buffer a
    chunk, exchanged by one all-to-all, and every received chunk
    dequantized by kernel #12 in one launch, rounded once to `buf`'s
    dtype."""
    if record:
        _bump_a2a(plan.hop_bytes(hop), hop.inter)
    if hop.wire in _WIRE_ITEMSIZE:
        wired = buf.to(torch.float32 if hop.wire == "fp32"
                       else torch.bfloat16)
        return dist.all_to_all(wired, hop.axis, split_axis=hop.dim,
                               concat_axis=hop.dim).to(buf.dtype)
    shape = buf.shape
    chunks = buf.movedim(hop.dim, 0).reshape(hop.world, -1)
    chunk_elems = chunks.shape[1]
    block = plan.quant_block
    pad = -chunk_elems % block
    src = F.pad(chunks, (0, pad)) if pad else chunks.contiguous()
    payload, scales = quantize_blockwise(src, block, hop.wire)
    nb = payload.shape[0] // hop.world
    wire_buf = pack_wire(payload.reshape((hop.world, nb) +
                                         tuple(payload.shape[1:])),
                         scales.reshape(hop.world, nb))
    wire_buf = dist.all_to_all(wire_buf, hop.axis, split_axis=0,
                               concat_axis=0)
    p, s = unpack_wire(wire_buf, hop.wire, block, chunk_elems)
    out = dequantize_blockwise(p, s, hop.wire, chunk_elems,
                               out_dtype=buf.dtype)
    moved = (shape[hop.dim],) + shape[:hop.dim] + shape[hop.dim + 1:]
    return out.reshape(moved).movedim(0, hop.dim)


def _run_hops(x, hops, plan: A2APlan, record: bool):
    for hop in hops:
        x = _hop_a2a(x, hop, plan, record)
    return x


class _WireA2A(torch.autograd.Function):
    """The exchange with a mirrored backward (dispatch.py:619): the
    cotangent crosses the same hops in reverse order on the same wires.
    A hop is its own inverse on its dim, so for fp32 that is the exact
    transpose; a quantized hop quantizes the cotangent once a crossing
    (straight-through)."""

    @staticmethod
    def forward(ctx, buf, hops, plan, record):
        ctx.hops, ctx.plan, ctx.record = hops, plan, record
        return _run_hops(buf, hops, plan, record)

    @staticmethod
    def backward(ctx, g):
        return (_run_hops(g.contiguous(), tuple(reversed(ctx.hops)),
                          ctx.plan, ctx.record), None, None, None)


def wire_all_to_all(buf, plan: A2APlan, reverse: bool, record: bool):
    """The whole (one- or two-hop) exchange of `buf`, whose leading dims
    are the hop grid ([outer, inner, ...] factored, [ep, ...] flat);
    `reverse` takes the hops in the combine's order."""
    hops = tuple(reversed(plan.hops)) if reverse else plan.hops
    return _WireA2A.apply(buf, hops, plan, record)


# ---------------------------------------------------------------------------
# engagement
# ---------------------------------------------------------------------------

_warned: set = set()
_LOCAL_GRADS_REGION = [False]


def _warn_once(key: str, msg: str) -> None:
    if key not in _warned:
        _warned.add(key)
        logger.warning(msg)


@contextlib.contextmanager
def local_grads_region():
    """The bucketed gradient wire's local-gradients region: the engine
    computes each rank's gradients with the experts whole on every rank
    (JAX hands that shard_map replicated parameters,
    step_builder.py:300-304), so the wire falls back to the local
    dispatch inside it (`wire_engagement`'s "manual-region" case)."""
    prev = _LOCAL_GRADS_REGION[0]
    _LOCAL_GRADS_REGION[0] = True
    try:
        yield
    finally:
        _LOCAL_GRADS_REGION[0] = prev


def wire_engagement(wcfg: MoEWireConfig, num_experts: int, batch: int
                    ) -> Optional[Tuple[MeshInfo, Tuple[str, ...]]]:
    """Whether the explicit wire serves this call (dispatch.py:677): ->
    (mesh, expert axes), or None with the reason logged once.  `batch`
    is the global batch's rows."""
    if not wcfg.explicit:
        return None
    mesh_info = peek_mesh()
    if mesh_info is None:
        _warn_once("no-mesh", "comm.moe a2a wire requested but no mesh "
                   "is current: running the local dispatch")
        return None
    for ax in (MODEL_AXIS, SEQ_AXIS, PIPE_AXIS):
        if mesh_info.axis_size(ax) > 1:
            _warn_once(
                f"axis-{ax}",
                f"comm.moe a2a wire requires a pure data-parallel mesh "
                f"({ax} axis is {mesh_info.axis_size(ax)}): running the "
                "local dispatch")
            return None
    axes = expert_axes(wcfg, mesh_info)
    if wcfg.placement == "inner" and not mesh_info.hierarchical:
        _warn_once("inner-flat",
                   "comm.moe.placement='inner' on a flat mesh: no "
                   "data_inner axis exists, the exchange runs over the "
                   "whole data axis")
    ep = mesh_info.axes_extent(axes)[0]
    dp = mesh_info.axis_size(DATA_AXIS)
    if dp <= 1 or ep <= 1:
        reason = ("data-parallel width is 1" if dp <= 1 else
                  f"the expert-parallel width over {'/'.join(axes)} "
                  f"is 1 (dp={dp})")
        _warn_once(f"ep1-{dp}-{ep}",
                   f"comm.moe a2a wire: {reason}: nothing to exchange, "
                   "running the local dispatch")
        return None
    if num_experts % ep != 0:
        _warn_once(
            f"experts-{num_experts}-{ep}",
            f"comm.moe a2a wire: num_experts={num_experts} is not "
            f"divisible by the expert-parallel width {ep}: running the "
            "local dispatch")
        return None
    if batch % dp != 0:
        _warn_once(
            f"batch-{batch}-{dp}",
            f"comm.moe a2a wire: batch rows {batch} not divisible by "
            f"the data width {dp}: running the local dispatch")
        return None
    if _LOCAL_GRADS_REGION[0]:
        _warn_once(
            "manual-region",
            "comm.moe a2a wire: inside the bucketed gradient wire's "
            "local-gradients region (the experts are whole on every "
            "rank there): running the local dispatch")
        return None
    if wcfg.overlap in ("auto", "on"):
        key = f"overlap-{wcfg.overlap}"
        if key not in _warned:
            _warned.add(key)
            level = logger.warning if wcfg.overlap == "on" else logger.info
            level("comm.moe.overlap: the expert all-to-all feeds the very "
                  "next expert product, so it has no independent compute "
                  "to hide behind: running the serial wire")
    return mesh_info, axes

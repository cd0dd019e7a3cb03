"""Mixture-of-Experts FFN — the port of deepspeed_tpu/moe/layer.py
(`MoEConfig` :41, `top_k_gating` :59, `MoE` :91-303).

Experts are stacked on a leading dim [E, ...]; the parameters are
`gate.w` [d, E] and `experts.{w1 [E, d, f], b1 [E, f], w2 [E, f, d],
b2 [E, d]}`, the JAX tree's names, layouts and initial distributions
(equal in distribution, drawn from a `torch.Generator`).  Two dispatch
engines, chosen by the process-global wire config (`moe/dispatch.py`,
the `"comm": {"moe": ...}` block), share one routing core
(`dispatch.topk_routing`), so expert choice, gate weights and capacity
drops are identical:

* "dense" (the default): GShard one-hot combine/dispatch tensors and
  einsum token movement (`_dense`);
* "sorted": gather tokens into [B, E, C, D] expert buckets and back
  through `dispatch.sorted_dispatch` / `sorted_combine` (kernels #13 and
  #14 on the card; `_sorted_local`), or, where `comm.moe.a2a_wire_dtype`
  asks for it and `dispatch.wire_engagement` allows it, with the experts
  sharded over the data ranks and the buckets moved to their owners by
  the explicit all-to-all (`_sorted_wire`).

Both return (y, aux): the Switch-Transformer load-balancing loss, which
the model adds to its training objective only.

Gate noise (`noisy_gate_std`, on when training with a generator) is
drawn by `gate_noise` — the one place the router takes its draw, so a
test can feed it the JAX package's draw.  It is drawn for the whole
global batch (`batch_rows` rows) and a rank takes its rows from
`row_offset`, as JAX draws one key a global row: every data-parallel
world computes the function world 1 does.  With `comm.moe.dropless` the
sorted engine adds the overflow bucket's pass (`_overflow_route`,
`_overflow`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import dispatch as _dsp


@dataclasses.dataclass
class MoEConfig:
    d_model: int
    d_ff: int
    num_experts: int
    top_k: int = 1
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    noisy_gate_std: float = 1e-2   # jitter on gate logits during training

    def __post_init__(self):
        if self.top_k > self.num_experts:
            raise ValueError(
                f"top_k ({self.top_k}) cannot exceed num_experts "
                f"({self.num_experts}): after masking every expert once, "
                f"further rounds would re-route to expert 0")


def gate_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard-normal fp32 jitter of the gate logits [B, S, E], drawn
    from `generator` (the JAX package draws `jax.random.normal` from one
    key per batch row)."""
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device)


def top_k_gating(logits, k: int, capacity: int, noise=None,
                 noise_std: float = 0.0):
    """GShard top-k gating with capacity, the dense one-hot form, for
    token groups: logits [..., N, E] -> (combine [..., N, E, C] fp32,
    dispatch [..., N, E, C] bool, aux [...]).  `noise` is the standard
    normal draw added at `noise_std`.  Routing comes from the shared
    sort-based core."""
    *lead, N, E = logits.shape
    if noise is not None and noise_std > 0.0:
        logits = logits + noise_std * noise
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    eidx, gate, pos, keep, aux = _dsp.topk_routing(probs, k, capacity)
    combine = torch.zeros((*lead, N, E, capacity), dtype=torch.float32,
                          device=logits.device)
    dispatch = torch.zeros(combine.shape, dtype=torch.bool,
                           device=logits.device)
    for r in range(k):
        onehot = F.one_hot(eidx[..., r, :].long(), E).to(torch.float32)
        slot = F.one_hot(torch.where(keep[..., r, :], pos[..., r, :],
                                     capacity).long(),
                         capacity + 1).to(torch.float32)[..., :capacity]
        contrib = onehot[..., :, None] * slot[..., None, :]
        combine = combine + (gate[..., r, :] *
                             keep[..., r, :])[..., None, None] * contrib
        dispatch = dispatch | (contrib > 0)
    return combine, dispatch, aux


class _Gate(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = nn.Parameter(w)


class _Experts(nn.Module):
    def __init__(self, w1, b1, w2, b2):
        super().__init__()
        self.w1, self.b1 = nn.Parameter(w1), nn.Parameter(b1)
        self.w2, self.b2 = nn.Parameter(w2), nn.Parameter(b2)


class MoEParams(nn.Module):
    """The MoE layer's parameters: `gate.w`, `experts.{w1,b1,w2,b2}`."""

    def __init__(self, gate_w, w1, b1, w2, b2):
        super().__init__()
        self.gate = _Gate(gate_w)
        self.experts = _Experts(w1, b1, w2, b2)


class MoE:
    """Functional MoE FFN: __call__(params, x, generator, train) ->
    (y, aux)."""

    def __init__(self, config: MoEConfig):
        self.config = config

    def init(self, generator: Optional[torch.Generator] = None,
             param_dtype=torch.float32, device="cpu") -> MoEParams:
        cfg = self.config
        d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts

        def n(shape, std):
            return (torch.randn(shape, generator=generator, device=device,
                                dtype=torch.float32) * std).to(param_dtype)

        zeros = lambda shape: torch.zeros(shape, dtype=param_dtype,
                                          device=device)
        return MoEParams(n((d, E), 0.02), n((E, d, f), d ** -0.5),
                         zeros((E, f)), n((E, f, d), f ** -0.5),
                         zeros((E, d)))

    def capacity(self, tokens_per_group: int, train: bool) -> int:
        """Per-expert slot count for one token group: ceiling division,
        floored at min_capacity (layer.py:146)."""
        cfg = self.config
        factor = cfg.capacity_factor if train else cfg.eval_capacity_factor
        cap = int(math.ceil(factor * tokens_per_group * cfg.top_k /
                            max(cfg.num_experts, 1) - 1e-9))
        return max(cap, cfg.min_capacity)

    def __call__(self, params: MoEParams, x,
                 generator: Optional[torch.Generator] = None, train=True,
                 row_offset: int = 0, batch_rows: Optional[int] = None):
        """x [B, S, D] -> (y [B, S, D], aux fp32 scalar).  Gating runs per
        batch row (GShard groups), so C ~ S / E.  Under data parallelism x
        is this rank's rows [row_offset, row_offset + B) of a global batch
        of `batch_rows` rows (default B: the whole batch), and aux is this
        rank's mean (the engine's gradient mean makes it the global one,
        as JAX's is the mean over shards)."""
        cfg = self.config
        wcfg = _dsp.get_wire_config()
        B, S, D = x.shape
        rows = B if batch_rows is None else int(batch_rows)
        cap = self.capacity(S, train)
        noise_std = cfg.noisy_gate_std if (train and generator is not None) \
            else 0.0
        logits = x @ params.gate.w.to(x.dtype)                  # [B, S, E]
        noise = None
        if noise_std > 0.0:
            noise = gate_noise((rows,) + tuple(logits.shape[1:]), generator,
                               x.device)
            if rows != B:
                noise = noise[row_offset:row_offset + B]
        if wcfg.dispatch == "sorted":
            engaged = _dsp.wire_engagement(wcfg, cfg.num_experts, rows)
            if engaged is not None:
                return self._sorted_wire(params, x, logits, noise,
                                         noise_std, cap, wcfg, *engaged)
            return self._sorted_local(params, x, logits, noise, noise_std,
                                      cap, wcfg)
        return self._dense(params, x, logits, noise, noise_std, cap)

    # -- shared pieces -------------------------------------------------

    def _route(self, logits, noise, noise_std, cap):
        """Noisy logits -> the shared sort-based routing core."""
        if noise is not None:
            logits = logits + noise_std * noise
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        return _dsp.topk_routing(probs, self.config.top_k, cap)

    def _expert_ffn(self, expert_in, params, dtype, experts=None):
        """[E, B, C, D] expert compute — the same products on every
        engine, so their parity reduces to the token movement.  `experts`
        (w1, b1, w2, b2) overrides the parameters' (the wire's local
        experts)."""
        w1, b1, w2, b2 = experts or (params.experts.w1, params.experts.b1,
                                     params.experts.w2, params.experts.b2)
        E, B, C, D = expert_in.shape
        h = torch.bmm(expert_in.reshape(E, B * C, D), w1.to(dtype)) + \
            b1.to(dtype)[:, None, :]
        h = F.gelu(h, approximate="tanh")
        out = torch.bmm(h, w2.to(dtype)) + b2.to(dtype)[:, None, :]
        return out.reshape(E, B, C, D)

    # -- dense one-hot engine ------------------------------------------

    def _dense(self, params, x, logits, noise, noise_std, cap):
        cfg = self.config
        combine, dispatch, aux = top_k_gating(logits, cfg.top_k, cap,
                                              noise, noise_std)
        expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(x.dtype), x)
        expert_out = self._expert_ffn(expert_in, params, x.dtype)
        y = torch.einsum("bsec,ebcd->bsd", combine.to(x.dtype), expert_out)
        return y, aux.mean().to(torch.float32)

    # -- sorted (gather / combine) engine ------------------------------

    def _sorted_local(self, params, x, logits, noise, noise_std, cap, wcfg):
        cfg = self.config
        B, S, D = x.shape
        E = cfg.num_experts
        eidx, gate, pos, keep, aux = self._route(logits, noise, noise_std,
                                                 cap)
        # the overflow bucket's routing first: its segment lengths travel
        # to the host while the primary bucket's work runs
        ov = self._overflow_route(eidx, keep, S, wcfg) if wcfg.dropless \
            else None
        expert_in = _dsp.sorted_dispatch(x, eidx, pos, keep, E, cap)
        expert_out = self._expert_ffn(expert_in.transpose(0, 1), params,
                                      x.dtype)
        y = _dsp.sorted_combine(expert_out.transpose(0, 1), eidx, gate, pos,
                                keep)
        dropped = (~keep).sum()
        if ov is not None:
            y = y + self._overflow(params, x, gate, ov)
            dropped = B * cfg.top_k * S - keep.sum() - ov[1].sum()
        if wcfg.counters:
            _dsp.record_dispatch_stats(dropped, keep.sum(), B * E * cap)
        return y, aux.mean().to(torch.float32)

    def _overflow_route(self, eidx, keep, S, wcfg):
        """The dropless second pass's routing (layer.py:218-239): JAX's
        kept set and the expert-grouped slots (`dispatch.overflow_*`),
        and the per-expert segment lengths on their way to the host (an
        asynchronous copy on the card, read in `_overflow`) ->
        (slot, ov_keep, capacity, (lengths, event))."""
        cfg = self.config
        ov_cap = _dsp.overflow_capacity(cfg.top_k, S, wcfg.overflow_factor)
        _, ov_keep = _dsp.overflow_keep(keep, ov_cap)
        slot, counts = _dsp.overflow_slots(eidx, ov_keep, cfg.num_experts)
        event = None
        if counts.is_cuda:
            host = torch.empty(counts.shape, dtype=counts.dtype,
                               pin_memory=True)
            host.copy_(counts, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            counts = host
        return slot, ov_keep, eidx.shape[0] * ov_cap, (counts, event)

    def _overflow(self, params, x, gate, ov):
        """The overflow bucket through the experts and back: one host read
        a call, the segment lengths `_overflow_route` sent."""
        slot, ov_keep, capacity, (counts, event) = ov
        B, S, D = x.shape
        ex = params.experts
        if event is not None:
            event.synchronize()
        bucket = _dsp.overflow_dispatch(x, slot, ov_keep, capacity)
        ov_out = _dsp.overflow_ffn(bucket, counts.tolist(),
                                   ex.w1.to(x.dtype), ex.b1.to(x.dtype),
                                   ex.w2.to(x.dtype), ex.b2.to(x.dtype))
        return _dsp.overflow_combine(ov_out, gate, slot, ov_keep, B, S)

    # -- sorted engine over the explicit all-to-all wire -----------------

    def _local_experts(self, params, ep: int, index: int):
        """This rank's El = E / ep experts: the parameters as they are
        where the engine keeps only them, else their slice of the full
        stack (a direct caller's whole experts)."""
        ex = params.experts
        E = self.config.num_experts
        El = E // ep
        out = []
        for t in (ex.w1, ex.b1, ex.w2, ex.b2):
            if t.shape[0] == El:
                out.append(t)
            elif t.shape[0] == E:
                out.append(t.narrow(0, index * El, El))
            else:
                raise ValueError(
                    f"expert leaf of {t.shape[0]} experts: the wire at "
                    f"ep {ep} takes {E} (whole) or {El} (this rank's)")
        return tuple(out)

    def _sorted_wire(self, params, x, logits, noise, noise_std, cap, wcfg,
                     mesh_info, axes):
        """The explicit wire (layer.py:246-303), on this rank's Bl rows:
        route, dispatch through #13, the [E, Bl, C, D] buckets onto the
        hop grid, the all-to-all to the experts' owners, the local
        experts' FFN over [El, ep·Bl, C, D] (source rank-major rows), the
        reverse all-to-all, and the combine through #14."""
        cfg = self.config
        Bl, S, D = x.shape
        E = cfg.num_experts
        plan = _dsp.build_a2a_plan(wcfg, mesh_info, E, Bl, cap, D)
        ep = plan.ep
        El = E // ep
        grid = tuple(mesh_info.axis_size(a) for a in axes)
        _, index = mesh_info.axes_extent(axes)
        experts = self._local_experts(params, ep, index)
        eidx, gate, pos, keep, aux = self._route(logits, noise, noise_std,
                                                 cap)
        expert_in = _dsp.sorted_dispatch(x, eidx, pos, keep, E, cap)
        buf = expert_in.transpose(0, 1).reshape(grid + (El, Bl, cap, D))
        buf = _dsp.wire_all_to_all(buf, plan, reverse=False,
                                   record=wcfg.counters)
        # the leading grid dims now index the SOURCE ranks, rank-major
        buf = buf.reshape(ep, El, Bl, cap, D).transpose(0, 1).reshape(
            El, ep * Bl, cap, D)
        out = self._expert_ffn(buf, params, x.dtype, experts)
        out = out.reshape(El, ep, Bl, cap, D).transpose(0, 1).reshape(
            grid + (El, Bl, cap, D))
        out = _dsp.wire_all_to_all(out, plan, reverse=True,
                                   record=wcfg.counters)
        out = out.reshape(E, Bl, cap, D).transpose(0, 1)
        y = _dsp.sorted_combine(out, eidx, gate, pos, keep)
        if wcfg.counters:
            _dsp.record_dispatch_stats((~keep).sum(), keep.sum(),
                                       Bl * E * cap)
        return y, aux.mean().to(torch.float32)

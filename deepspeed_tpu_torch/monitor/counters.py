"""Process-global named counters (the port's copy of the `Counters` /
`COUNTERS` part of deepspeed_tpu/monitor/counters.py).

Every instrumented site bumps a named (calls, bytes) accumulator as it
runs; readers take a `snapshot()` and read `delta_since(snap)`.  The
families the serving slice writes keep the JAX package's names and
meanings:

* `serve.requests` (bytes = generated tokens), `serve.tokens`,
  `serve.decode_steps` (bytes = active slots), `serve.prefill_chunks`
  (bytes = prompt tokens), `serve.ttft_ms` (integer MICROSECONDS in the
  bytes slot), `serve.shed`;
* `kv.blocks_in_use` (sampled once per engine step), `kv.evictions`,
  `kv.prefix_hits`, `kv.prefix_hit_tokens`, `kv.cow_copies`,
  `kv.session_pins`, `kv.prefix_evictions`;
* `kernel.dispatches` / `kernel.fallbacks` — registry resolutions that
  launched the hand-written kernel / ran the plain PyTorch version.  The
  port runs eagerly, so these count every call (the JAX package counts
  once per traced program).

Training's wires write, with the JAX names, once per collective a rank
makes (bytes = what this rank hands to it):

* `bucket.psum`, `bucket.psum_scatter`, `bucket.all_gather` (the split
  and int8/int4 gather wires: one fused buffer a bucket), and per level
  of a hierarchy `bucket.intra.*` / `bucket.inter.*`; `grad_wire.*` the
  plan's bytes a reduction (runtime/comm/bucketing.py);
* `moe.a2a_bytes` — one explicit expert all-to-all hop, its plan bytes
  (`A2APlan.hop_bytes`), and `moe.a2a_inter` the same for a hop over
  `data_outer` (moe/dispatch.py `_bump_a2a`); `moe.dropped_tokens`,
  `moe.capacity_frac` the routing stats;
* `dist.<collective>` — every `comm/dist.py` collective's input bytes.
"""

from __future__ import annotations

from typing import Dict, Optional


class CounterRegistry:
    """Named (calls, bytes) accumulators with snapshot/delta reads."""

    __slots__ = ("_c",)

    def __init__(self):
        self._c: Dict[str, list] = {}

    def add(self, name: str, nbytes: int = 0, calls: int = 1) -> None:
        e = self._c.get(name)
        if e is None:
            self._c[name] = [calls, nbytes]
        else:
            e[0] += calls
            e[1] += nbytes

    def snapshot(self) -> Dict[str, tuple]:
        return {k: (v[0], v[1]) for k, v in self._c.items()}

    def delta_since(self, snap: Optional[Dict[str, tuple]]) -> Dict[str, dict]:
        snap = snap or {}
        out = {}
        for k, v in self._c.items():
            c0, b0 = snap.get(k, (0, 0))
            dc, db = v[0] - c0, v[1] - b0
            if dc or db:
                out[k] = {"calls": dc, "bytes": db}
        return out

    def totals(self) -> Dict[str, dict]:
        return {k: {"calls": v[0], "bytes": v[1]} for k, v in self._c.items()}

    def reset(self) -> None:
        self._c.clear()


# THE process-global registry every instrumented site writes to.
COUNTERS = CounterRegistry()


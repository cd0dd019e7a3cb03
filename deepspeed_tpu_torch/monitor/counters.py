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

Serving's fleet, telemetry and chaos families (the JAX names and
meanings):

* `router.dispatches` — requests dispatched to a replica (bytes += the
  chosen replica's `kv.blocks_in_use` at dispatch, so bytes/calls is the
  mean load a dispatch landed on); `router.spills` — dispatches
  deflected from the least-loaded pick because its queue was full;
  `router.shed` — requests refused at the front door with every replica
  queue saturated (returned in state 'error', never enqueued)
  (serving/router.py);
* `trace.events` — span events flushed to the rank-local trace file
  (bytes = JSONL bytes written, bounded by `max_file_bytes`);
  `trace.dropped` — events the byte cap rejected (the ring buffer still
  holds them for the watchdog's flight recorder); `slo.windows` — SLO
  windows emitted by `ServingSLO` (monitor/tracing.py);
* `fault.injected` — FaultPlan injections fired; `fault.retried` —
  retry_transient attempts after a transient failure;
  `fault.recovered_ms` — time spent recovering before a success
  (integer MICROSECONDS in the bytes slot); `watchdog.trips` —
  StepWatchdog deadline trips, each with its snapshot and escalation
  file (runtime/resilience.py).

The registry takes a lock around every read and write: serving worker
threads bump it at once, and an unlocked read-modify-write could lose
an update, or a key inserted during `snapshot()` break the iteration.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class CounterRegistry:
    """Named (calls, bytes) accumulators with snapshot/delta reads, safe
    from any thread."""

    __slots__ = ("_c", "_lock")

    def __init__(self):
        self._c: Dict[str, list] = {}
        self._lock = threading.Lock()

    def add(self, name: str, nbytes: int = 0, calls: int = 1) -> None:
        with self._lock:
            e = self._c.get(name)
            if e is None:
                self._c[name] = [calls, nbytes]
            else:
                e[0] += calls
                e[1] += nbytes

    def snapshot(self) -> Dict[str, tuple]:
        with self._lock:
            return {k: (v[0], v[1]) for k, v in self._c.items()}

    def delta_since(self, snap: Optional[Dict[str, tuple]]) -> Dict[str, dict]:
        snap = snap or {}
        out = {}
        for k, v in self.snapshot().items():
            c0, b0 = snap.get(k, (0, 0))
            dc, db = v[0] - c0, v[1] - b0
            if dc or db:
                out[k] = {"calls": dc, "bytes": db}
        return out

    def totals(self) -> Dict[str, dict]:
        return {k: {"calls": v[0], "bytes": v[1]}
                for k, v in self.snapshot().items()}

    def reset(self) -> None:
        with self._lock:
            self._c.clear()


# THE process-global registry every instrumented site writes to.
COUNTERS = CounterRegistry()


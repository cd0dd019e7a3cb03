"""Fleet router: admission over N in-process ServeEngine replicas — the
port of deepspeed_tpu/serving/router.py.

* **Least-loaded dispatch** — a request lands on the replica holding
  the fewest live KV blocks (`kv.blocks_in_use`, queue depth as the
  tiebreak): block occupancy is what gates admission in a paged engine.
* **Session affinity** — a pinned session's KV blocks are resident on
  exactly one replica, so a request carrying that `session_id` MUST
  land there (even over the queue limit: re-prefilling the history
  elsewhere costs more than queueing).  The router learns the mapping
  at dispatch; at the next dispatch for that session it probes the
  replica (`ServeEngine.session_active`) and drops a stale mapping (pin
  expired, released under pressure, or its chain errored), falling back
  to least-loaded.  The map is swept of stale entries whenever it
  outgrows `affinity_cap`.
* **Queue spill-over** — when the least-loaded pick's waiting queue is
  at `queue_limit`, the request spills to the next-least-loaded replica
  with room (`router.spills`).
* **Shed-on-saturation** — when EVERY replica's queue is full the
  request is refused at once in state "error" (`router.shed`), never
  enqueued.

Replicas are in-process engines sharing ONE set of prepared weights
(`build_fleet` builds the first engine, the rest take its `model` — the
GPT itself, or under `quantized_weights` the one `QuantizedWeights`
store kernel #11 built), each with its OWN PagedKVCache and therefore
its own prefix cache.  `start()` runs one `ServeWorker` thread per
replica (see serving/engine.py for its stream policy); `run()` drives
them synchronously, as the tests do.

Counters (`router.*`): `router.dispatches` — requests dispatched
(bytes += the chosen replica's `kv.blocks_in_use` at dispatch);
`router.spills` — dispatches deflected from a full queue;
`router.shed` — requests refused with every queue full.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from ..monitor.counters import COUNTERS
from ..utils.logging import logger
from .engine import ServeConfig, ServeEngine, ServeWorker
from .scheduler import ERROR, Request


def build_fleet(model, config: Optional[ServeConfig] = None,
                replicas: int = 2, device="cuda", prepared=None,
                clock=time.monotonic) -> List[ServeEngine]:
    """N ServeEngine replicas sharing one set of prepared weights: the
    first engine prepares them (or adopts `prepared`, another engine's
    `model`), the rest reuse its `model` (ServeEngine checks the quant
    mode).  Each replica owns its KV pool and prefix cache."""
    if int(replicas) < 1:
        raise ValueError(f"fleet replicas must be >= 1, got {replicas}")
    first = ServeEngine(model, config, device=device, clock=clock,
                        prepared=prepared)
    engines = [first]
    for _ in range(int(replicas) - 1):
        engines.append(ServeEngine(model, config, device=device,
                                   clock=clock, prepared=first.model))
    return engines


class FleetRouter:
    """Front door over a list of ServeEngine replicas.  `submit()` is
    the whole API a frontend needs — safe from any thread (a mutex
    serializes choose/dispatch/affinity, so concurrent first turns of
    one session land on ONE replica); `start()`/`close()` run one
    ServeWorker per replica so the engines step concurrently (kernel
    launches and most ATen calls release the GIL, so replicas' host work
    overlaps in one process), and `run()` drives them synchronously."""

    def __init__(self, engines: Sequence[ServeEngine],
                 queue_limit: int = 64, session_affinity: bool = True,
                 affinity_cap: int = 1024):
        if not engines:
            raise ValueError("FleetRouter needs at least one engine")
        if int(queue_limit) < 1:
            raise ValueError(
                f"fleet queue_limit must be >= 1, got {queue_limit}")
        if int(affinity_cap) < 1:
            raise ValueError(
                f"fleet affinity_cap must be >= 1, got {affinity_cap}")
        self.engines: List[ServeEngine] = list(engines)
        self.queue_limit = int(queue_limit)
        self.session_affinity = bool(session_affinity)
        self.affinity_cap = int(affinity_cap)
        self._session_replica: Dict[Any, int] = {}
        self._lock = threading.Lock()
        self._workers: List[ServeWorker] = []
        self.dispatched = 0
        self.spilled = 0
        self.shed = 0

    # -- dispatch ------------------------------------------------------

    def _load(self, i: int):
        eng = self.engines[i]
        return (eng.kv.blocks_in_use, eng.scheduler.n_waiting, i)

    def _queue_depth(self, i: int) -> int:
        return self.engines[i].scheduler.n_waiting

    def _choose(self, session_id) -> Optional[int]:
        """The replica this request lands on, or None (saturated)."""
        if self.session_affinity and session_id is not None:
            i = self._session_replica.get(session_id)
            if i is not None:
                if self.engines[i].session_active(session_id):
                    # hard affinity: the pin's blocks live there; even a
                    # full queue beats re-prefilling the history cold
                    return i
                # pin expired / pressure-released / chain errored:
                # nothing to be warm on — route by load like a cold turn
                del self._session_replica[session_id]
        order = sorted(range(len(self.engines)), key=self._load)
        first_choice = order[0]
        for i in order:
            if self._queue_depth(i) < self.queue_limit:
                if i != first_choice:
                    self.spilled += 1
                    COUNTERS.add("router.spills")
                return i
        return None

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               temperature: float = 0.0, top_k: int = 0, seed: int = 0,
               eos_token: Optional[int] = None,
               session_id: Optional[Any] = None) -> Request:
        """Route one request.  Returns the live Request from the chosen
        replica — or, with every queue at the limit, a Request already
        in state "error" that was never enqueued anywhere."""
        with self._lock:
            i = self._choose(session_id)
            if i is None:
                self.shed += 1
                COUNTERS.add("router.shed")
                req = Request(prompt=[int(t) for t in prompt],
                              max_new_tokens=int(max_new_tokens),
                              session_id=session_id)
                req.state = ERROR
                req.error = (f"fleet saturated: every replica queue >= "
                             f"{self.queue_limit}")
                logger.warning(
                    f"fleet router: shed a request ({req.error})")
                return req
            eng = self.engines[i]
            COUNTERS.add("router.dispatches", nbytes=eng.kv.blocks_in_use)
            self.dispatched += 1
            req = eng.submit(prompt, max_new_tokens,
                             temperature=temperature, top_k=top_k,
                             seed=seed, eos_token=eos_token,
                             session_id=session_id)
            if self.session_affinity and session_id is not None:
                # recorded AFTER eng.submit so the sweep's liveness
                # probe already sees this session's waiting request
                self._session_replica[session_id] = i
                if len(self._session_replica) > self.affinity_cap:
                    self._sweep_affinity()
        req.replica = i
        return req

    def _sweep_affinity(self) -> None:
        """Drop every mapping whose replica no longer has the session
        active (caller holds the lock) — the bound that keeps many
        distinct one-shot session ids from growing the map forever."""
        self._session_replica = {
            sid: i for sid, i in self._session_replica.items()
            if self.engines[i].session_active(sid)}

    # -- driving -------------------------------------------------------

    def has_work(self) -> bool:
        return any(e.has_work() for e in self.engines)

    def step_all(self) -> bool:
        did = False
        for e in self.engines:
            if e.has_work():
                did = e.step() or did
        return did

    def run(self) -> None:
        """Synchronous drive: step every replica until the fleet is
        idle."""
        while self.has_work():
            self.step_all()

    def start(self) -> None:
        """One ServeWorker daemon per replica — concurrent decoding."""
        if self._workers:
            return
        for e in self.engines:
            w = ServeWorker(e)
            w.start()
            self._workers.append(w)

    def close(self) -> None:
        """Stop every worker (re-raising the first one's error after all
        are stopped) and close every engine."""
        errors = []
        for w in self._workers:
            try:
                w.stop()
            except RuntimeError as e:
                errors.append(e)
        self._workers = []
        for e in self.engines:
            e.close()
        if errors:
            raise errors[0]

    # -- telemetry -----------------------------------------------------

    @property
    def resident_sessions(self) -> int:
        return sum(e.resident_sessions for e in self.engines)

    def describe(self) -> str:
        return (f"FleetRouter({len(self.engines)} replicas, "
                f"queue_limit={self.queue_limit}, session_affinity="
                f"{'on' if self.session_affinity else 'off'})")

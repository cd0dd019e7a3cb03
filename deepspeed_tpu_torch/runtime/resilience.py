"""The chaos runtime — the port of deepspeed_tpu/runtime/resilience.py:
deterministic fault injection, bounded retry of transient faults, and an
in-process hang watchdog.

* **FaultPlan** — seedable rules keyed by injection site, fault kind
  (`raise` / `delay_ms` / `corrupt` / `hang` / `kill`), rank and a
  step / call schedule.  Layers that can fail carry named
  `fault_point(site)` hooks (the serving engine's `serve.step`,
  `serve.admit`, `serve.prefill`, `serve.decode`); with no plan
  installed a hook is one module-global read.  The same (seed, rules)
  against the same invocation sequence injects the same faults, in the
  JAX package too: each rule's coin is `random.Random(seed * 1_000_003 +
  rule index)`, the JAX stream.  The plan's rank is
  `torch.distributed.get_rank()` when a process group is up, else 0.
* **retry_transient()** — bounded exponential backoff with jitter around
  an idempotent operation, with the transient-vs-fatal taxonomy
  (`is_transient`; an injected transient fault retries, an injected
  fatal one does not), at the process-global `RetryPolicy`
  (`install_retry_policy`; the engine installs the `faults.retry`
  block's).  The checkpoint writer (`runtime/checkpointing.py`
  `_atomic_write`) runs every file write through it.
* **StepWatchdog** — a daemon thread that trips when no step-boundary
  `beat()` lands within `deadline_s`: it dumps a snapshot (every
  thread's stack, the counter totals, registered thread groups, a
  flight-recorder trace tail) and writes `watchdog_trip.json`, the
  file format of the JAX package (`read_watchdog_trip` reads either's),
  then calls `on_trip`.  Wired to `ServeEngine.request_shed`, a wedged
  decode step sheds its batch instead of hanging the replica.

The training engine installs the `faults` config block at construction
(runtime/engine.py `_init_resilience`: the plan with its rank, the retry
policy, a StepWatchdog beside the run monitor).  Chaos sites: the
serving engine's (above), the training step boundary's `engine.step`
(`step_boundary`), the checkpoint writer's `ckpt.atomic_write` (and the
`corrupt`-able payload filter `ckpt.atomic_write.payload`),
`ckpt.commit` and `ckpt.background_write`, and the input pipeline's
`dataloader.worker`.

Counters: `fault.injected`, `fault.retried`, `fault.recovered_ms` (µs in
the bytes slot), `watchdog.trips`.
"""

from __future__ import annotations

import errno
import fnmatch
import json
import os
import random
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from ..monitor.counters import COUNTERS
from ..utils.logging import logger

FAULT_KINDS = ("raise", "delay_ms", "corrupt", "hang", "kill")

# the escalation file a supervisor polls for in the run directory
WATCHDOG_TRIP_FILE = "watchdog_trip.json"


class TransientFault(RuntimeError):
    """A fault the taxonomy classifies as retryable (a storage hiccup, a
    coordination blip).  Injected transient faults are instances."""


class InjectedFault(TransientFault):
    """A fault raised by a FaultPlan `raise` rule (transient=true)."""


class InjectedFatalFault(RuntimeError):
    """A fault raised by a `raise` rule with transient=false: retry_transient
    must not absorb it."""


# exception types that are retryable by nature
_TRANSIENT_TYPES = (TransientFault, TimeoutError, ConnectionError,
                    InterruptedError, BrokenPipeError)
_TRANSIENT_MARKERS = ("DEADLINE_EXCEEDED", "DEADLINE EXCEEDED",
                      "UNAVAILABLE", "ABORTED", "RESOURCE_EXHAUSTED",
                      "connection reset", "temporarily unavailable")
# OSError errnos worth retrying; ENOSPC/EROFS/ENOENT stay fatal
_TRANSIENT_ERRNOS = frozenset(
    getattr(errno, name)
    for name in ("EIO", "EAGAIN", "EBUSY", "EINTR", "ETIMEDOUT",
                 "ECONNRESET", "ECONNREFUSED", "ENETUNREACH"))


def is_transient(exc: BaseException) -> bool:
    """True when retrying the SAME operation can plausibly succeed."""
    if isinstance(exc, InjectedFatalFault):
        return False
    if isinstance(exc, _TRANSIENT_TYPES):
        return True
    if isinstance(exc, (FileNotFoundError, PermissionError, IsADirectoryError,
                        NotADirectoryError)):
        return False
    if isinstance(exc, OSError):
        return exc.errno in _TRANSIENT_ERRNOS
    if isinstance(exc, (ValueError, TypeError, KeyError, AssertionError)):
        return False
    msg = str(exc).lower()
    return any(m.lower() in msg for m in _TRANSIENT_MARKERS)


def _is_timeoutish(exc: BaseException) -> bool:
    return isinstance(exc, TimeoutError) or \
        "deadline" in str(exc).lower() or "timed out" in str(exc).lower()


def is_transient_not_timeout(exc: BaseException) -> bool:
    """Taxonomy variant for BLOCKING waits whose timeout is itself the
    dead-peer detector (a barrier rendezvous): retrying a deadline there
    multiplies the effective timeout and delays the legitimate failure,
    so timeouts stay fatal while genuine transport blips (UNAVAILABLE,
    connection reset, injected transient faults) still retry."""
    return is_transient(exc) and not _is_timeoutish(exc)


# -- retry ------------------------------------------------------------------


class RetryPolicy:
    """Bounded exponential backoff + jitter for transient faults.

    `max_attempts` counts TOTAL tries (1 = no retry); the delay before
    retry k is base_delay_ms * 2^(k-1), capped at max_delay_ms, times a
    uniform jitter in [1-jitter, 1+jitter] so a fleet of ranks does not
    hammer a recovering store in lockstep.  `rng`/`sleep` are injectable
    for tests: the same `random.Random(seed)` gives the JAX package's
    delays bit for bit."""

    def __init__(self, max_attempts: int = 4, base_delay_ms: float = 50.0,
                 max_delay_ms: float = 2000.0, jitter: float = 0.25,
                 rng=None, sleep=time.sleep):
        if int(max_attempts) < 1:
            raise ValueError(
                f"retry max_attempts must be >= 1, got {max_attempts}")
        if not 0.0 <= float(jitter) < 1.0:
            raise ValueError(f"retry jitter must be in [0, 1), got {jitter}")
        if float(base_delay_ms) < 0 or float(max_delay_ms) < 0:
            raise ValueError("retry delays must be >= 0")
        self.max_attempts = int(max_attempts)
        self.base_delay_ms = float(base_delay_ms)
        self.max_delay_ms = float(max_delay_ms)
        self.jitter = float(jitter)
        self._rng = rng if rng is not None else random.Random()
        self._sleep = sleep

    def delay_s(self, attempt: int) -> float:
        """Backoff before retry `attempt` (1-based)."""
        d = min(self.base_delay_ms * (2.0 ** (attempt - 1)),
                self.max_delay_ms)
        return d * self._rng.uniform(1.0 - self.jitter,
                                     1.0 + self.jitter) / 1000.0


_DEFAULT_RETRY = RetryPolicy()


def default_retry_policy() -> RetryPolicy:
    return _DEFAULT_RETRY


def install_retry_policy(policy: Optional[RetryPolicy]) -> None:
    """Install the process-global retry policy (config-driven; None
    restores the built-in defaults)."""
    global _DEFAULT_RETRY
    _DEFAULT_RETRY = policy if policy is not None else RetryPolicy()


def retry_transient(fn: Callable[[], Any], site: str = "",
                    policy: Optional[RetryPolicy] = None,
                    classify: Callable[[BaseException], bool] = is_transient):
    """Run the idempotent `fn()`, retrying TRANSIENT failures with the
    installed policy's bounded backoff (or `policy`'s); fatal faults and
    the last attempt re-raise unchanged.  `fault.retried` counts retries,
    `fault.recovered_ms` (µs in the bytes slot) the time spent
    recovering before a success."""
    policy = policy or _DEFAULT_RETRY
    t0 = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            out = fn()
            if t0 is not None:
                COUNTERS.add("fault.recovered_ms",
                             int((time.perf_counter() - t0) * 1e6))
            return out
        except BaseException as e:  # noqa: BLE001 — classified below
            if not classify(e) or attempt >= policy.max_attempts:
                raise
            if t0 is None:
                t0 = time.perf_counter()
            COUNTERS.add("fault.retried")
            delay = policy.delay_s(attempt)
            logger.warning(
                f"transient fault at {site or 'op'} (attempt {attempt}/"
                f"{policy.max_attempts}): {type(e).__name__}: {e}; "
                f"retrying in {delay * 1000:.0f} ms")
            policy._sleep(delay)


def _process_rank() -> int:
    """This process's rank: torch.distributed's when a group is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


# -- fault rules / plan -----------------------------------------------------

_RULE_KEYS = {"site", "kind", "rank", "steps", "calls", "every", "prob",
              "times", "delay_ms", "hang_s", "exit_code", "transient",
              "truncate_to"}


class FaultRule:
    """One injection rule.  `site` is an fnmatch pattern over injection
    site names; the schedule is any combination of `rank` (None = every
    rank), `steps` (engine global steps; None = any), and per-site
    invocation selectors — `calls` (0-based site-invocation indices),
    `every` (every Nth matching invocation), `prob` (seeded coin per
    invocation).  With no invocation selector the rule fires on every
    matching invocation.  `times` caps total injections (default: 1 for
    hang/kill — a second one can never be reached anyway — else
    unbounded)."""

    def __init__(self, site: str, kind: str, rank: Optional[int] = None,
                 steps: Optional[List[int]] = None,
                 calls: Optional[List[int]] = None,
                 every: Optional[int] = None, prob: Optional[float] = None,
                 times: Optional[int] = None, delay_ms: float = 100.0,
                 hang_s: float = 3600.0, exit_code: int = 173,
                 transient: bool = True, truncate_to: int = 8):
        if not site:
            raise ValueError("fault rule needs a non-empty 'site'")
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"fault rule kind must be one of {FAULT_KINDS}, got {kind!r}")
        if prob is not None and not 0.0 <= float(prob) <= 1.0:
            raise ValueError(f"fault rule prob must be in [0, 1], got {prob}")
        if every is not None and int(every) < 1:
            raise ValueError(f"fault rule every must be >= 1, got {every}")
        # config-time validation is the contract: a malformed schedule
        # or negative sleep must never surface mid-training-step
        for name, val in (("steps", steps), ("calls", calls)):
            if val is not None and (isinstance(val, (str, bytes))
                                    or not hasattr(val, "__iter__")):
                raise ValueError(
                    f"fault rule {name} must be a list of ints, got "
                    f"{val!r}")
        for name, val in (("delay_ms", delay_ms), ("hang_s", hang_s)):
            if float(val) < 0:
                raise ValueError(
                    f"fault rule {name} must be >= 0, got {val}")
        if times is not None and int(times) < 0:
            raise ValueError(f"fault rule times must be >= 0, got {times}")
        if int(truncate_to) < 0:
            raise ValueError(
                f"fault rule truncate_to must be >= 0, got {truncate_to}")
        self.site = str(site)
        self.kind = str(kind)
        self.rank = None if rank is None else int(rank)
        self.steps = None if steps is None else [int(s) for s in steps]
        self.calls = None if calls is None else [int(c) for c in calls]
        self.every = None if every is None else int(every)
        self.prob = None if prob is None else float(prob)
        if times is None and kind in ("hang", "kill"):
            times = 1
        self.times = None if times is None else int(times)
        self.delay_ms = float(delay_ms)
        self.hang_s = float(hang_s)
        self.exit_code = int(exit_code)
        self.transient = bool(transient)
        self.truncate_to = int(truncate_to)
        self.fired = 0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultRule":
        if not isinstance(d, dict):
            raise ValueError(f"each faults.rules entry must be an object, "
                             f"got {type(d).__name__}")
        unknown = set(d) - _RULE_KEYS
        if unknown:
            raise ValueError(
                f"faults rule: unknown key(s) {sorted(unknown)}; expected "
                f"a subset of {sorted(_RULE_KEYS)}")
        if "site" not in d or "kind" not in d:
            raise ValueError("faults rule needs 'site' and 'kind'")
        return cls(**d)

    def describe(self) -> Dict[str, Any]:
        out = {"site": self.site, "kind": self.kind}
        for k in ("rank", "steps", "calls", "every", "prob", "times"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        return out


class FaultPlan:
    """Deterministic, seedable fault injector.

    Site hooks call `check(site)` (may raise/sleep/exit) and data sites
    `filter(site, payload)` (corrupt rules).  Rule matching consumes a
    per-rule `random.Random(seed * 1_000_003 + rule_index)` stream only
    on `prob` evaluation of MATCHING invocations, and everything else
    keys off per-site invocation counts and the engine-advanced step — so
    the same plan against the same invocation sequence injects the
    identical fault sequence (the `injection_log` records it), the JAX
    package's too.

    Thread-safe: sites fire from every serving worker thread."""

    def __init__(self, rules: List[FaultRule], seed: int = 0,
                 rank: Optional[int] = None, enabled: bool = True,
                 clock=time.monotonic):
        self.rules = list(rules)
        self.seed = int(seed)
        self.rank = rank  # resolved lazily when None (pre-distributed init)
        self.enabled = bool(enabled)
        self._clock = clock
        self._lock = threading.Lock()
        self._site_calls: Dict[str, int] = {}
        self._step = 0
        # one independent, deterministic stream per rule (int-seeded:
        # tuple seeding is deprecated and hash-dependent)
        self._rngs = [random.Random(self.seed * 1_000_003 + i)
                      for i in range(len(self.rules))]
        self.injection_log: List[Dict[str, Any]] = []

    @classmethod
    def from_config(cls, rules: List[Dict[str, Any]], seed: int = 0,
                    enabled: Optional[bool] = None) -> "FaultPlan":
        parsed = [FaultRule.from_dict(r) for r in rules]
        if enabled is None:
            enabled = bool(parsed)
        return cls(parsed, seed=seed, enabled=enabled)

    # -- schedule state ----------------------------------------------------

    def set_step(self, step: int) -> None:
        self._step = int(step)

    def _resolve_rank(self) -> int:
        if self.rank is None:
            self.rank = _process_rank()
        return self.rank

    def _select(self, site: str):
        """The first rule firing at this (site, rank, step, invocation),
        or None.  Increments the site invocation count either way."""
        with self._lock:
            idx = self._site_calls.get(site, 0)
            self._site_calls[site] = idx + 1
            if not self.enabled:
                return None, idx
            rank = self._resolve_rank()
            for i, rule in enumerate(self.rules):
                if not fnmatch.fnmatch(site, rule.site):
                    continue
                if rule.rank is not None and rule.rank != rank:
                    continue
                if rule.steps is not None and self._step not in rule.steps:
                    continue
                if rule.times is not None and rule.fired >= rule.times:
                    continue
                if rule.calls is not None:
                    if idx not in rule.calls:
                        continue
                elif rule.every is not None:
                    if idx % rule.every != 0:
                        continue
                elif rule.prob is not None:
                    # the rng stream advances ONLY on matching
                    # invocations: deterministic across identical runs
                    if self._rngs[i].random() >= rule.prob:
                        continue
                rule.fired += 1
                entry = {"site": site, "kind": rule.kind, "rule": i,
                         "rank": rank, "step": self._step, "call": idx}
                self.injection_log.append(entry)
                return rule, idx
        return None, idx

    def targets(self, site: str) -> bool:
        """Whether any rule's site pattern matches `site` (a caller may
        then skip preparing what only a rule there would read)."""
        return any(fnmatch.fnmatch(site, r.site) for r in self.rules)

    # -- site hooks --------------------------------------------------------

    def check(self, site: str) -> None:
        """Evaluate `site`: may raise InjectedFault/InjectedFatalFault,
        sleep (delay/hang), or kill the process."""
        rule, idx = self._select(site)
        if rule is None:
            return
        COUNTERS.add("fault.injected")
        if rule.kind == "raise":
            exc = (InjectedFault if rule.transient else InjectedFatalFault)(
                f"injected {'transient' if rule.transient else 'fatal'} "
                f"fault at {site} (call {idx}, step {self._step})")
            logger.warning(f"fault injection: raising at {site}: {exc}")
            raise exc
        if rule.kind == "delay_ms":
            logger.warning(f"fault injection: delaying {site} by "
                           f"{rule.delay_ms:.0f} ms")
            time.sleep(rule.delay_ms / 1000.0)
            return
        if rule.kind == "hang":
            logger.warning(f"fault injection: HANGING {site} for "
                           f"{rule.hang_s:.0f}s (watchdog bait)")
            time.sleep(rule.hang_s)
            return
        if rule.kind == "kill":
            logger.error(f"fault injection: KILLING process at {site} "
                         f"(exit {rule.exit_code})")
            sys.stderr.flush()
            os._exit(rule.exit_code)
        # "corrupt" selected through check(): the site carries no
        # payload here, treat as a transient raise so the schedule
        # still advances loudly instead of silently no-oping
        raise InjectedFault(
            f"injected corrupt-at-non-payload-site fault at {site}")

    def filter(self, site: str, payload: bytes) -> bytes:
        """Payload sites: apply a matching `corrupt` rule (truncation —
        the torn-write shape checksum/commit layers must catch); other
        kinds behave like check()."""
        rule, idx = self._select(site)
        if rule is None:
            return payload
        COUNTERS.add("fault.injected")
        if rule.kind == "corrupt":
            keep = min(len(payload), max(0, rule.truncate_to))
            logger.warning(
                f"fault injection: corrupting payload at {site} "
                f"({len(payload)} -> {keep} bytes)")
            return payload[:keep]
        if rule.kind == "raise":
            raise (InjectedFault if rule.transient
                   else InjectedFatalFault)(
                f"injected fault at {site} (call {idx})")
        if rule.kind == "delay_ms":
            time.sleep(rule.delay_ms / 1000.0)
        elif rule.kind == "hang":
            time.sleep(rule.hang_s)
        elif rule.kind == "kill":
            os._exit(rule.exit_code)
        return payload

    def describe(self) -> str:
        return (f"FaultPlan(seed={self.seed}, enabled={self.enabled}, "
                f"rules={[r.describe() for r in self.rules]})")


# -- process-global installation -------------------------------------------

_PLAN: Optional[FaultPlan] = None


def install_fault_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install (or clear, with None) THE process-global fault plan every
    `fault_point` hook consults.  Returns the previous plan."""
    global _PLAN
    prev, _PLAN = _PLAN, plan
    if plan is not None and plan.enabled and plan.rules:
        logger.warning(f"fault injection ACTIVE: {plan.describe()}")
    return prev


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


def fault_point(site: str) -> None:
    """Named injection site.  One global read when no plan is installed
    — cheap enough to live on hot paths unconditionally (the counter
    discipline, monitor/counters.py)."""
    if _PLAN is not None:
        _PLAN.check(site)


def fault_filter(site: str, payload: bytes) -> bytes:
    """Payload-carrying injection site (corrupt rules)."""
    if _PLAN is not None:
        return _PLAN.filter(site, payload)
    return payload


def step_boundary(step: int) -> None:
    """Advance the plan's step schedule + fire the engine step site.
    Called by the engine at every optimizer-step boundary."""
    if _PLAN is not None:
        _PLAN.set_step(step)
        _PLAN.check("engine.step")



# -- watchdog ---------------------------------------------------------------


def _all_stacks() -> Dict[str, List[str]]:
    """Stack traces for every live thread (the snapshot's core: WHAT is
    the hung step blocked on)."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in frames.items():
        name = names.get(ident, f"thread-{ident}")
        out[f"{name} ({ident})"] = traceback.format_stack(frame)
    return out


class StepWatchdog:
    """In-process hang detector: a background thread that trips when no
    step-boundary `beat()` lands within `deadline_s`.

    On a trip it (1) dumps a diagnostic snapshot — all-thread stack
    traces + the monitor counter totals + the last beat — to
    `<snapshot_dir>/watchdog_snapshot.rank<r>.<n>.json`, (2) bumps the
    `watchdog.trips` counter, (3) escalates by atomically writing
    `watchdog_trip.json` (machine-readable reason + snapshot path) into
    `escalate_dir`, the file a supervisor polls for, and (4) calls
    `on_trip(trip)` — `ServeEngine.request_shed` sheds the wedged batch
    even though the stuck thread cannot act on its own.  One trip per
    stall: it re-arms only after a fresh beat.

    Size `deadline_s` above the worst-case LEGITIMATE inter-beat gap —
    a first step's kernel builds and a synchronous checkpoint's write
    both land between beats — or slow-but-progressing steps trip it
    spuriously; chaos tests use a second or less.

    First-beat grace (`first_beat_mult`): BEFORE the first beat lands,
    the effective deadline is `deadline_s * first_beat_mult` anchored
    at construction (the window before beat 1 holds the first builds).
    `first_beat_mult=None` keeps it unarmed until the first beat.

    The thread is daemonized and wakes every `poll_s`; `clock` and
    `on_trip` are injectable for tests."""

    def __init__(self, deadline_s: float, snapshot_dir: str,
                 escalate_dir: Optional[str] = None, poll_s: float = 1.0,
                 rank: int = 0, clock=time.monotonic,
                 on_trip: Optional[Callable[[Dict[str, Any]], None]] = None,
                 first_beat_mult: Optional[float] = None):
        if float(deadline_s) <= 0:
            raise ValueError(
                f"watchdog deadline_s must be > 0, got {deadline_s}")
        if float(poll_s) <= 0:
            # Event.wait(0) never blocks: a zero poll busy-spins the
            # daemon thread on a core for the whole run
            raise ValueError(f"watchdog poll_s must be > 0, got {poll_s}")
        if first_beat_mult is not None and float(first_beat_mult) < 1.0:
            # a sub-1 multiplier would make the COMPILE window stricter
            # than steady state — always wrong
            raise ValueError(f"watchdog first_beat_mult must be >= 1, "
                             f"got {first_beat_mult}")
        self.deadline_s = float(deadline_s)
        self.first_beat_mult = (None if first_beat_mult is None
                                else float(first_beat_mult))
        self.snapshot_dir = snapshot_dir
        self.escalate_dir = escalate_dir or snapshot_dir
        self.poll_s = float(poll_s)
        self.rank = int(rank)
        self._clock = clock
        self._on_trip = on_trip
        self._lock = threading.Lock()
        self._armed_at = clock()
        self._last_beat: Optional[float] = None
        self._last_step: Optional[int] = None
        self._tripped = False
        self._trips = 0
        self._thread_groups: Dict[str, Callable[[], list]] = {}
        self._flight_recorder: Optional[Callable[[], list]] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="dstpu-watchdog", daemon=True)
        self._thread.start()

    def beat(self, step: Optional[int] = None) -> None:
        """Progress heartbeat from the training thread; arms the
        deadline on the first call and re-arms after a trip."""
        with self._lock:
            self._last_beat = self._clock()
            if step is not None:
                self._last_step = int(step)
            self._tripped = False

    @property
    def trips(self) -> int:
        return self._trips

    def register_threads(self, group: str, threads_fn) -> None:
        """Register a named group of service threads (`threads_fn()` ->
        live threading.Thread list) whose liveness the trip snapshot
        reports explicitly — e.g. the overlap exchange's sender/
        receiver threads, so a hung exchange reads as 'exchange' in the
        snapshot instead of an anonymous 300 s stall.  Re-registering a
        group replaces it; a dead provider is dropped silently (the
        snapshot must never crash the watchdog)."""
        with self._lock:
            self._thread_groups[group] = threads_fn

    def unregister_threads(self, group: str) -> None:
        """Drop a registered thread group — the provider closure holds
        its owner alive, so tearing a service down (e.g. a demoted
        overlap exchange) must unregister or the watchdog pins the
        dead object (and its buffers) for the rest of the process."""
        with self._lock:
            self._thread_groups.pop(group, None)

    def set_flight_recorder(self, tail_fn) -> None:
        """Register a trace-tail provider (`tail_fn()` -> the newest
        trace events, e.g. monitor/tracing.py TraceRecorder.last_events)
        — the trip snapshot then ships a `trace_tail` timeline of what
        the wedged step was doing.  Like register_threads, a raising
        provider is reported, never propagated."""
        with self._lock:
            self._flight_recorder = tail_fn

    def _flight_recorder_tail(self) -> Optional[list]:
        with self._lock:
            fn = self._flight_recorder
        if fn is None:
            return None
        try:
            return list(fn())
        except Exception as e:
            return [{"error": f"{type(e).__name__}: {e}"}]

    def _thread_group_report(self) -> Dict[str, Any]:
        with self._lock:
            groups = dict(self._thread_groups)
        report = {}
        for name, fn in groups.items():
            try:
                report[name] = [
                    {"name": t.name, "alive": t.is_alive(),
                     "daemon": t.daemon, "ident": t.ident}
                    for t in fn()]
            except Exception as e:
                report[name] = [{"error": f"{type(e).__name__}: {e}"}]
        return report

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                beat, step = self._last_beat, self._last_step
                tripped = self._tripped
                armed_at = self._armed_at
            if tripped:
                continue
            if beat is None:
                # pre-first-beat: only armed when a first-beat grace
                # multiplier was configured (recompile after an elastic
                # restart legitimately lands in this window)
                if self.first_beat_mult is None:
                    continue
                stalled = self._clock() - armed_at
                if stalled > self.deadline_s * self.first_beat_mult:
                    try:
                        self.trip(stalled, None, first_beat=True)
                    except Exception as e:
                        logger.error(
                            f"watchdog trip handling failed: {e}")
                continue
            stalled = self._clock() - beat
            if stalled > self.deadline_s:
                try:
                    self.trip(stalled, step)
                except Exception as e:  # the watchdog must never crash
                    logger.error(f"watchdog trip handling failed: {e}")

    def trip(self, stalled_s: float, step: Optional[int],
             first_beat: bool = False) -> None:
        with self._lock:
            if self._tripped:
                return
            self._tripped = True
            self._trips += 1
            n = self._trips
        if first_beat:
            reason = (f"first step never completed: no step-boundary "
                      f"beat in {stalled_s:.1f}s since arming (> "
                      f"{self.deadline_s:.1f}s x first_beat_mult "
                      f"{self.first_beat_mult:g} — sized to cover "
                      f"first-step compile, incl. an elastic restart's "
                      f"recompile at the new mesh shape)")
        else:
            reason = (f"step deadline exceeded: no step-boundary progress "
                      f"in {stalled_s:.1f}s (> {self.deadline_s:.1f}s) "
                      f"after step {step}")
        logger.error(f"watchdog TRIP (rank {self.rank}): {reason}")
        COUNTERS.add("watchdog.trips")
        snapshot = {
            "reason": reason,
            "rank": self.rank,
            "last_step": step,
            "stalled_s": round(float(stalled_s), 3),
            "deadline_s": self.deadline_s,
            "trip": n,
            "unix_time": time.time(),
            "counters": COUNTERS.totals(),
            "stacks": _all_stacks(),
            "thread_groups": self._thread_group_report(),
        }
        tail = self._flight_recorder_tail()
        if tail is not None:
            snapshot["trace_tail"] = tail
        snap_path = os.path.join(
            self.snapshot_dir,
            f"watchdog_snapshot.rank{self.rank:05d}.{n}.json")
        try:
            os.makedirs(self.snapshot_dir, exist_ok=True)
            self._atomic_json(snap_path, snapshot)
        except OSError as e:
            logger.error(f"watchdog snapshot write failed: {e}")
            snap_path = None
        trip = {
            "reason": reason,
            "rank": self.rank,
            "last_step": step,
            "stalled_s": round(float(stalled_s), 3),
            "snapshot": snap_path,
            "unix_time": time.time(),
        }
        try:
            os.makedirs(self.escalate_dir, exist_ok=True)
            self._atomic_json(
                os.path.join(self.escalate_dir, WATCHDOG_TRIP_FILE), trip)
        except OSError as e:
            logger.error(f"watchdog escalation write failed: {e}")
        if self._on_trip is not None:
            self._on_trip(trip)

    @staticmethod
    def _atomic_json(path: str, payload: Dict[str, Any]) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True, default=str)
        os.replace(tmp, path)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


def read_watchdog_trip(run_dir: str) -> Optional[Dict[str, Any]]:
    """The machine-readable escalation payload under `run_dir`, or None
    (StepWatchdog writes it)."""
    path = os.path.join(run_dir, WATCHDOG_TRIP_FILE)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None

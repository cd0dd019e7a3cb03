"""Trace timelines: a bounded, sampled span recorder and serving SLO
windows — the port of deepspeed_tpu/monitor/tracing.py, whole.

`TraceRecorder` writes structured span events (here: the serving
engine's per-request lifecycle and per-step spans) to a rank-local
`trace.rank<r>.jsonl` in a run directory: a `trace_meta` header line,
one JSON event a line (Chrome trace-event `ph` / `name` / `cat` / `ts`
/ `dur` / `args`), and a `trace_summary` footer at `close()`.  The file
format is the JAX package's, so its `tools/trace_report.py` merges a
port trace unchanged into a Chrome/Perfetto trace (pid = rank, tid =
subsystem).

Safe to leave on:

  * no instrumentation site synchronises the device (host walls at
    dispatch only), so a traced and an untraced run give the same
    tokens and the same kernel launches;
  * sampled — `sample_rate` gates whole steps / requests through a
    seeded crc32 hash (`_sample_hash`): the same seed and keys make the
    same decisions as the JAX package's recorder;
  * byte-bounded — the rank file stops growing at `max_file_bytes`
    (dropped writes are counted, never raised);
  * ring-buffered — the last `buffer_events` events stay in memory
    whatever the file cap; `StepWatchdog` dumps this flight recorder
    into its trip snapshot so a wedged step ships a timeline.

`wire` stays duck-typed: any object with `allgather_bytes(payload) ->
[bytes]` aligns the ranks' clocks at construction; serving passes none.

Counters: `trace.events` (calls = events flushed, bytes = bytes
written), `trace.dropped` (events the byte cap rejected), `slo.windows`
(SLO windows emitted).

`ServingSLO` keeps a sliding window over request lifecycle
observations (TTFT, emitted tokens, queue depth, speculative accepts,
sheds) and emits a snapshot every `emit_interval_s`; its p50 / p99 are
NEAREST-RANK percentiles (`percentile_nearest_rank`), rounded to 3
decimals of a ms, bit for bit the JAX package's.
"""

from __future__ import annotations

import collections
import json
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

from .counters import COUNTERS

TRACE_SCHEMA_VERSION = 1
TRACE_FILE_PREFIX = "trace.rank"

# subsystem categories (the merged trace's tid lanes)
TRACE_CATEGORIES = ("train", "input", "wire", "ckpt", "autotune",
                    "watchdog", "serve", "slo")


def percentile_nearest_rank(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an ALREADY-SORTED list (the JAX
    package's definition, so both windows give the same numbers)."""
    if not sorted_vals:
        return 0.0
    import math

    k = max(0, math.ceil(q / 100.0 * len(sorted_vals)) - 1)
    return sorted_vals[min(k, len(sorted_vals) - 1)]


def _sample_hash(seed: int, key) -> float:
    """Deterministic [0, 1) hash of (seed, key) — crc32, stable across
    processes and runs (unlike hash())."""
    return zlib.crc32(f"{seed}:{key}".encode()) / 2**32


class _SpanCtx:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("_rec", "_name", "_cat", "_args", "_t0")

    def __init__(self, rec: "TraceRecorder", name: str, cat: str,
                 args: Dict[str, Any]):
        self._rec = rec
        self._name = name
        self._cat = cat
        self._args = args
        self._t0 = rec.now_us()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        t0 = self._t0
        self._rec.add_complete(self._name, self._cat, ts_us=t0,
                               dur_us=self._rec.now_us() - t0,
                               **self._args)
        return False


class TraceRecorder:
    """Bounded span recorder, one per rank (a serving process attaches
    one to each engine with `ServeEngine.attach_tracing`).

    `wire`: an optional object with `allgather_bytes` — when given,
    construction performs ONE
    collective allgather so every rank captures its (wall, mono) clock
    pair at an approximately simultaneous instant; the merger aligns
    rank timelines on those sync points, cancelling wall-clock skew.
    `clock`/`wall` are injectable for deterministic tests.
    """

    def __init__(self, run_dir: str, rank: int = 0, world: int = 1, *,
                 buffer_events: int = 2048,
                 max_file_bytes: int = 16 << 20,
                 sample_rate: float = 1.0,
                 seed: int = 0,
                 flush_interval_s: float = 0.5,
                 wire=None,
                 clock: Callable[[], float] = time.perf_counter,
                 wall: Callable[[], float] = time.time):
        import os

        self.rank = int(rank)
        self.world = int(world)
        self.sample_rate = float(sample_rate)
        self.seed = int(seed)
        self.max_file_bytes = int(max_file_bytes)
        self._clock = clock
        self._wall = wall
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=max(16, int(buffer_events)))
        self._pending: List[str] = []
        self._bytes_written = 0
        self._n_events = 0
        self._n_dropped = 0
        self._closed = False

        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(
            run_dir, f"{TRACE_FILE_PREFIX}{self.rank:05d}.jsonl")
        self._f = open(self.path, "a")

        skew_est_s = self._clock_sync(wire)
        meta = {"type": "trace_meta", "v": TRACE_SCHEMA_VERSION,
                "rank": self.rank, "world": self.world,
                "sync_mono_us": self._sync_mono_us,
                "sync_wall": self._sync_wall,
                "skew_est_s": skew_est_s,
                "sample_rate": self.sample_rate, "seed": self.seed}
        self._f.write(json.dumps(meta) + "\n")
        self._f.flush()

        self._stop = threading.Event()
        self._flush_interval_s = max(0.05, float(flush_interval_s))
        self._thread = threading.Thread(
            target=self._flush_loop, name="dstpu-trace-flush", daemon=True)
        self._thread.start()

    # -- clocks --------------------------------------------------------

    def now_us(self) -> int:
        return int(self._clock() * 1e6)

    def _clock_sync(self, wire) -> Optional[float]:
        """Capture the (wall, mono) pair defining this rank's timeline
        origin.  With a wire, all ranks allgather first so the capture
        happens right after a collective returns — an approximately
        simultaneous instant on every rank (within wire latency), which
        is what lets the merger cancel wall-clock skew."""
        skew_est_s = None
        if wire is not None:
            try:
                payload = json.dumps(
                    {"rank": self.rank, "wall": self._wall()}).encode()
                parts = wire.allgather_bytes(payload)
                peers = []
                for p in parts:
                    try:
                        peers.append(json.loads(p.decode()))
                    except Exception:
                        continue
                sends = [p["wall"] for p in peers if "wall" in p]
                if sends:
                    # my send-time offset from the earliest sender: a
                    # rough per-rank skew indicator for the report (the
                    # ALIGNMENT itself uses the sync instant below)
                    skew_est_s = round(
                        dict((p["rank"], p["wall"]) for p in peers)
                        .get(self.rank, min(sends)) - min(sends), 6)
            except Exception:
                pass  # tracing must never take the run down
        self._sync_wall = self._wall()
        self._sync_mono_us = self.now_us()
        return skew_est_s

    # -- sampling ------------------------------------------------------

    def sampled(self, key) -> bool:
        """Deterministic per-step / per-request gate: same seed + same
        key sequence => the same decisions on every run and rank."""
        if self.sample_rate >= 1.0:
            return True
        return _sample_hash(self.seed, key) < self.sample_rate

    # -- recording -----------------------------------------------------

    def span(self, name: str, cat: str = "train", **args) -> _SpanCtx:
        """Measure a host-side block as one complete event.  Dispatch
        walls only — never synchronizes device values."""
        return _SpanCtx(self, name, cat, args)

    def add_complete(self, name: str, cat: str = "train",
                     ts_us: Optional[int] = None, dur_us: int = 0,
                     **args) -> None:
        """An externally-measured span (e.g. a queue wait whose start
        predates the recording site)."""
        if ts_us is None:
            ts_us = self.now_us() - int(dur_us)
        self._record({"ph": "X", "name": name, "cat": cat,
                      "ts": int(ts_us), "dur": max(0, int(dur_us)),
                      **({"args": args} if args else {})})

    def instant(self, name: str, cat: str = "train", **args) -> None:
        self._record({"ph": "i", "name": name, "cat": cat,
                      "ts": self.now_us(),
                      **({"args": args} if args else {})})

    def _record(self, event: Dict[str, Any]) -> None:
        if self._closed:
            return
        with self._lock:
            self._ring.append(event)
            self._pending.append(json.dumps(event))
            self._n_events += 1

    def last_events(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """The flight recorder: a snapshot of the newest events in the
        ring (newest last).  Safe to call from the watchdog thread."""
        with self._lock:
            tail = list(self._ring)
        return tail if n is None else tail[-int(n):]

    # -- writer --------------------------------------------------------

    def _flush_loop(self) -> None:
        while not self._stop.wait(self._flush_interval_s):
            self.flush()

    def flush(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return
        wrote = dropped = nbytes = 0
        for line in pending:
            ln = len(line) + 1
            if self._bytes_written + ln > self.max_file_bytes:
                dropped += 1
                continue
            try:
                self._f.write(line + "\n")
            except ValueError:  # closed file under teardown races
                return
            self._bytes_written += ln
            wrote += 1
            nbytes += ln
        if wrote:
            try:
                self._f.flush()
            except ValueError:
                return
            COUNTERS.add("trace.events", nbytes, calls=wrote)
        if dropped:
            self._n_dropped += dropped
            COUNTERS.add("trace.dropped", calls=dropped)

    def close(self) -> None:
        """Stop the flush thread, drain, and write the footer summary.
        Idempotent; the footer rides past the byte cap so a capped file
        still ends with its own accounting."""
        if self._closed:
            return
        self._stop.set()
        self._thread.join(timeout=10)
        self.flush()
        self._closed = True
        footer = {"type": "trace_summary", "rank": self.rank,
                  "events": self._n_events, "dropped": self._n_dropped,
                  "bytes": self._bytes_written}
        try:
            self._f.write(json.dumps(footer) + "\n")
            self._f.flush()
            self._f.close()
        except ValueError:
            pass


def read_trace_file(path: str):
    """Parse one rank's trace JSONL into ([(meta, events), ...],
    summary).  A restarted run appends a fresh meta line; events belong
    to the meta that precedes them (one segment per process lifetime,
    each with its own clock origin), so the merger aligns per
    segment."""
    segments = []
    meta, events, summary = None, [], None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except Exception:
                continue
            t = obj.get("type")
            if t == "trace_meta":
                if meta is not None:
                    segments.append((meta, events))
                meta, events = obj, []
            elif t == "trace_summary":
                summary = obj
            elif "ph" in obj:
                events.append(obj)
    if meta is not None:
        segments.append((meta, events))
    return segments, summary


class ServingSLO:
    """Sliding-window serving telemetry: p50/p99 TTFT (nearest-rank),
    tokens/s, mean queue depth, speculative
    acceptance rate, shed count.  `tick()` (called from the serve loop)
    emits an `slo` monitor event every `emit_interval_s`; `force()`
    emits unconditionally (lane teardown).  Clock injectable — serving
    tests drive a fake clock."""

    def __init__(self, emit: Optional[Callable[[Dict[str, Any]], None]]
                 = None, window_s: float = 10.0,
                 emit_interval_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic,
                 tracer: Optional[TraceRecorder] = None):
        if window_s <= 0 or emit_interval_s <= 0:
            raise ValueError("ServingSLO: window_s and emit_interval_s "
                             "must be > 0")
        self.emit = emit
        self.window_s = float(window_s)
        self.emit_interval_s = float(emit_interval_s)
        self.clock = clock
        self.tracer = tracer
        self._ttft: collections.deque = collections.deque()
        self._tokens: collections.deque = collections.deque()
        self._queue: collections.deque = collections.deque()
        self._accept: collections.deque = collections.deque()
        self._shed: collections.deque = collections.deque()
        self._last_emit: Optional[float] = None
        self.windows_emitted = 0

    # -- observations --------------------------------------------------

    def _now(self, t: Optional[float]) -> float:
        return self.clock() if t is None else float(t)

    def observe_ttft(self, ttft_s: float, t: Optional[float] = None):
        self._ttft.append((self._now(t), float(ttft_s) * 1e3))

    def observe_tokens(self, n: int, t: Optional[float] = None):
        if n:
            self._tokens.append((self._now(t), int(n)))

    def observe_queue_depth(self, depth: int, t: Optional[float] = None):
        self._queue.append((self._now(t), int(depth)))

    def observe_accept(self, accepted: int, drafted: int,
                       t: Optional[float] = None):
        self._accept.append((self._now(t), int(accepted), int(drafted)))

    def observe_shed(self, n: int = 1, t: Optional[float] = None):
        self._shed.append((self._now(t), int(n)))

    def _trim(self, now: float) -> None:
        cutoff = now - self.window_s
        for dq in (self._ttft, self._tokens, self._queue, self._accept,
                   self._shed):
            while dq and dq[0][0] < cutoff:
                dq.popleft()

    # -- window math ---------------------------------------------------

    def snapshot(self, t: Optional[float] = None) -> Dict[str, Any]:
        now = self._now(t)
        self._trim(now)
        ttfts = sorted(ms for _, ms in self._ttft)
        toks = sum(n for _, n in self._tokens)
        # tokens/s over the span the window actually covers, not the
        # nominal width — a 2 s old lane must not read as 1/5 the rate
        tmin = min((dq[0][0] for dq in (self._tokens, self._ttft)
                    if dq), default=now)
        span = min(self.window_s, max(now - tmin, 1e-9))
        depths = [d for _, d in self._queue]
        acc = sum(a for _, a, _d in self._accept)
        drafted = sum(d for _, _a, d in self._accept)
        return {
            "window_s": self.window_s,
            "requests": len(ttfts),
            "ttft_ms": {
                "p50": round(percentile_nearest_rank(ttfts, 50), 3),
                "p99": round(percentile_nearest_rank(ttfts, 99), 3),
                "n": len(ttfts)},
            "tok_per_s": round(toks / span, 2) if toks else 0.0,
            "queue_depth_mean": (round(sum(depths) / len(depths), 2)
                                 if depths else 0.0),
            "accept_rate": (round(acc / drafted, 4) if drafted else None),
            "drafted": drafted,
            "shed": sum(n for _, n in self._shed),
        }

    # -- emission ------------------------------------------------------

    def tick(self, t: Optional[float] = None) -> Optional[Dict[str, Any]]:
        now = self._now(t)
        if self._last_emit is None:
            self._last_emit = now
            return None
        if now - self._last_emit < self.emit_interval_s:
            return None
        return self.force(now)

    def force(self, t: Optional[float] = None) -> Dict[str, Any]:
        now = self._now(t)
        snap = self.snapshot(now)
        self._last_emit = now
        self.windows_emitted += 1
        COUNTERS.add("slo.windows", calls=1)
        if self.tracer is not None:
            self.tracer.instant("slo_window", "slo",
                                p99_ttft_ms=snap["ttft_ms"]["p99"],
                                tok_per_s=snap["tok_per_s"])
        if self.emit is not None:
            self.emit(snap)
        return snap

"""Continuous-batching scheduler: in-flight admission over the paged
KV cache — a copy of deepspeed_tpu/serving/scheduler.py (:65-305), on
the port's counters and cache, with its tracing hook (`tracer`: one
back-dated `queue_wait` span per sampled admitted request).

The scheduling loop the engine drives once per `step()`:

1. **admit** — move waiting requests into free decode slots whenever
   the pool can cover their UNSHARED KV budget.  The whole-life budget
   is ceil((prompt + max_new + draft_len) / block_size) blocks, clamped
   to the table width, but the prefix cache discounts it: blocks whose
   chain hash is already registered are aliased (one refcount, zero
   fresh blocks) and a request arriving with a live session pin adopts
   the pin's blocks outright — admission charges only what is actually
   new.  Prefill then starts at the first non-cached position.  The
   `draft_len` tail matters under speculative decoding: a verify step
   writes up to `draft_len` candidate K/V rows PAST the committed
   length, and without the reservation those rows would spill into the
   trash-padded tail of the block table — an accepted draft's K/V
   silently living in the trash block, corrupting every later
   attention read (the off-by-draft starvation
   tests/test_spec_decode.py pins).  Admission policy:

   * `"continuous"` (the subsystem's reason to exist): a request joins
     the RUNNING batch at ANY decode step, and a finished request frees
     its slot + blocks the same step — the decode batch stays full
     under load instead of draining to the longest request.
   * `"static"` (the baseline serve_bench beats): a new batch is
     admitted only when every slot is empty — classic static batching,
     head-of-line blocked on the longest request of the previous batch.

2. **prefill** — admitted requests stream their prompt through the
   chunked prefill program, at most `max_prefill_chunks_per_step`
   chunks per engine step, so a long prompt never stalls the decode
   batch for more than one chunk's worth of compute.  A prefix-cached
   request's stream starts at its first non-cached token.

3. **decode** — every RUNNING slot advances one token.

Requests own their block table for their whole life; finishing
(naturally or shed) drops their references immediately — a block a
finished request shared with a live holder survives, its private
blocks return to the pool (registered ones park in the prefix LRU).
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

from ..monitor.counters import COUNTERS
from .kv_cache import PagedKVCache

WAITING = "waiting"
PREFILL = "prefill"
RUNNING = "running"
FINISHED = "finished"
ERROR = "error"

ADMISSION_POLICIES = ("continuous", "static")


@dataclass
class Request:
    """One generation request and its whole lifecycle."""

    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    eos_token: Optional[int] = None
    session_id: Optional[Any] = None  # pin blocks for a follow-up turn
    rid: int = -1
    state: str = WAITING
    out: List[int] = field(default_factory=list)
    error: Optional[str] = None
    # engine book-keeping
    slot: Optional[int] = None
    table = None                      # np.int32 [table_width]
    prefill_pos: int = 0              # tokens already prefilled
    cached_len: int = 0               # cache positions written (real)
    prefix_cached_tokens: int = 0     # prompt tokens skipped at admit
    block_hashes: List[bytes] = field(default_factory=list)
    # timestamps (engine clock)
    t_submit: float = 0.0
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None
    token_times: List[float] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.state in (FINISHED, ERROR)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit


class Scheduler:
    """Slot + admission book-keeping for one ServeEngine.  Thread-safe
    submission (the bench submits from an arrival thread while a worker
    thread drives steps); everything else runs on the engine thread."""

    def __init__(self, kv: PagedKVCache, max_batch: int,
                 admission: str = "continuous",
                 clock=time.monotonic, draft_len: int = 0):
        if admission not in ADMISSION_POLICIES:
            raise ValueError(
                f"admission must be one of {ADMISSION_POLICIES}, got "
                f"{admission!r}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if int(draft_len) < 0:
            raise ValueError(f"draft_len must be >= 0, got {draft_len}")
        self.kv = kv
        self.max_batch = int(max_batch)
        self.admission = admission
        self.draft_len = int(draft_len)
        self.clock = clock
        self.slots: List[Optional[Request]] = [None] * self.max_batch
        self._waiting: List[Request] = []
        self._lock = threading.Lock()
        self._rid = itertools.count()
        self.requests: List[Request] = []
        # monitor.tracing.TraceRecorder (or None) — set by
        # ServeEngine.attach_tracing; admit() emits one `queue_wait`
        # complete event per sampled admitted request.
        self.tracer = None
        # session hooks (set by ServeEngine when sessions are enabled):
        # session_lookup(req) -> pin info or None; session_consumed(req,
        # pin) runs after the pin's blocks transferred to the request.
        self.session_lookup = None
        self.session_consumed = None

    # -- submission (any thread) --------------------------------------

    def submit(self, req: Request) -> Request:
        req.rid = next(self._rid)
        req.t_submit = self.clock()
        needed = self.kv.blocks_needed(len(req.prompt) + req.max_new_tokens)
        if needed > self.kv.table_width:
            raise ValueError(
                f"request needs {needed} KV blocks > table width "
                f"{self.kv.table_width}: prompt {len(req.prompt)} + "
                f"max_new {req.max_new_tokens} exceeds the engine's "
                f"{self.kv.table_width * self.kv.block_size}-token "
                f"per-request capacity")
        reserved = self.blocks_reserved(req)
        if reserved > self.kv.capacity_blocks:
            raise ValueError(
                f"request needs {reserved} KV blocks (incl. the "
                f"{self.draft_len}-token speculative tail) but the cache "
                f"only has {self.kv.capacity_blocks}")
        with self._lock:
            self._waiting.append(req)
            self.requests.append(req)
        return req

    def blocks_reserved(self, req: Request) -> int:
        """The request's whole-life block budget INCLUDING the
        speculative tail: verify writes up to `draft_len` candidate
        rows past the committed length, so those rows must be backed
        by real blocks (never the trash-padded table tail) or an
        accepted draft's K/V would be silently lost.  Clamped to the
        table width — the engine clamps per-step draft proposals to
        the allocated rows, so the cap is never overrun.  This is the
        TABLE budget; the prefix cache discounts what admission
        actually charges against the pool."""
        tokens = min(len(req.prompt) + req.max_new_tokens + self.draft_len,
                     self.kv.table_width * self.kv.block_size)
        return self.kv.blocks_needed(tokens)

    # -- engine-thread scheduling -------------------------------------

    def _try_alloc(self, req: Request):
        """One admission attempt: session-pin adoption first, then the
        hash-chain prefix match, then a plain allocation.  Returns the
        block table or None; on success the request's cached offsets
        and registration hashes are set."""
        needed = self.blocks_reserved(req)
        pin = None
        if req.session_id is not None and self.session_lookup is not None:
            pin = self.session_lookup(req)
        if pin is not None:
            table = self.kv.alloc_from_pin(req.rid, needed, pin.owner)
            if table is None:
                return None
            # block_hashes stays EMPTY: the adopted blocks hold
            # decode-written rows, which are not pinned bitwise against
            # a cold-prefill recompute, and every block this request
            # prefills attends over them — so none of its blocks may be
            # published under token-only chain hashes for third-party
            # matching (the cache-on/off exactness contract)
            req.cached_len = req.prefill_pos = pin.cached_len
            req.prefix_cached_tokens = pin.cached_len
            if pin.cached_len:
                COUNTERS.add("kv.prefix_hit_tokens",
                             nbytes=pin.cached_len)
            if self.session_consumed is not None:
                self.session_consumed(req, pin)
            return table
        hashes = self.kv.prefix_hashes(req.prompt)
        matched = self.kv.match_prefix(hashes)
        m = len(matched)
        # a fully-cached, block-aligned prompt still recomputes its
        # final token (prefill samples the first output there) — that
        # write lands in the last shared block, the one COW case
        privatize = bool(m) and m * self.kv.block_size >= len(req.prompt)
        table = self.kv.alloc(req.rid, needed, shared=matched,
                              privatize_last=privatize)
        if table is None:
            return None
        req.block_hashes = hashes
        if m:
            skipped = min(m * self.kv.block_size, len(req.prompt) - 1)
            req.cached_len = req.prefill_pos = skipped
            req.prefix_cached_tokens = skipped
            COUNTERS.add("kv.prefix_hits", nbytes=m)
            COUNTERS.add("kv.prefix_hit_tokens", nbytes=skipped)
        return table

    def admit(self) -> List[Request]:
        """Admission pass; returns the newly admitted requests."""
        if self.admission == "static" and any(
                s is not None for s in self.slots):
            return []
        admitted = []
        with self._lock:
            while self._waiting:
                free_slots = [i for i, s in enumerate(self.slots)
                              if s is None]
                if not free_slots:
                    break
                req = self._waiting[0]
                table = self._try_alloc(req)
                if table is None:
                    break  # FIFO: never starve the head of the queue
                self._waiting.pop(0)
                req.table = table
                req.slot = free_slots[0]
                req.state = PREFILL
                self.slots[req.slot] = req
                admitted.append(req)
        tr = self.tracer
        if tr is not None and admitted:
            # Queue wait is measured on the SCHEDULER clock (injectable
            # for tests) and back-dated onto the tracer clock so the
            # span ends at the admission instant.
            now = self.clock()
            for req in admitted:
                if not tr.sampled(f"rid:{req.rid}"):
                    continue
                dur_us = max(0, int((now - req.t_submit) * 1e6))
                tr.add_complete("queue_wait", "serve",
                                ts_us=tr.now_us() - dur_us,
                                dur_us=dur_us, rid=req.rid,
                                prompt=len(req.prompt),
                                cached=req.prefix_cached_tokens)
        return admitted

    def prefilling(self) -> List[Request]:
        return [r for r in self.slots if r is not None and
                r.state == PREFILL]

    def running(self) -> List[Request]:
        return [r for r in self.slots if r is not None and
                r.state == RUNNING]

    def occupied(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    def finish(self, req: Request, state: str = FINISHED,
               error: Optional[str] = None) -> None:
        """Terminal transition: free the slot and drop the KV
        references NOW — immediate reclaim is what lets the next
        waiting request join at the very next step."""
        req.state = state
        req.error = error
        req.t_finish = self.clock()
        if req.slot is not None:
            self.slots[req.slot] = None
            req.slot = None
        self.kv.free(req.rid, evicted=(state == ERROR))

    def has_work(self) -> bool:
        with self._lock:
            waiting = bool(self._waiting)
        return waiting or any(s is not None for s in self.slots)

    def has_session(self, sid) -> bool:
        """A live (waiting or slot-resident) request carries `sid`."""
        with self._lock:
            if any(r.session_id == sid for r in self._waiting):
                return True
        return any(r is not None and r.session_id == sid
                   for r in self.slots)

    @property
    def n_waiting(self) -> int:
        with self._lock:
            return len(self._waiting)

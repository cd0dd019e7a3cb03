"""Bounded retry of transient I/O faults — the port's copy of the
`is_transient` / `retry_transient` part of
deepspeed_tpu/runtime/resilience.py (:120-240), with the JAX package's
default policy.

The checkpoint writer (`runtime/checkpointing.py` `_atomic_write`) runs
every file write through `retry_transient`: a storage hiccup (EIO,
EAGAIN, ...) retries with exponential backoff and jitter, a fatal fault
(ENOSPC, a missing directory, a ValueError) re-raises at once.  The
configurable policy, the fault-injection plan, the watchdog and the chaos
sites of the JAX module belong to the production-runtime item of ROADMAP
queue 1.
"""

from __future__ import annotations

import errno
import random
import time
from typing import Any, Callable

from ..monitor.counters import COUNTERS
from ..utils.logging import logger

# the JAX package's default RetryPolicy: 4 tries in all, the delay before
# retry k 50 ms * 2^(k-1) capped at 2 s, times a jitter in [0.75, 1.25]
MAX_ATTEMPTS = 4
BASE_DELAY_MS = 50.0
MAX_DELAY_MS = 2000.0
JITTER = 0.25

# exception types that are retryable by nature
_TRANSIENT_TYPES = (TimeoutError, ConnectionError, InterruptedError,
                    BrokenPipeError)
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


def retry_transient(fn: Callable[[], Any], site: str = ""):
    """Run the idempotent `fn()`, retrying TRANSIENT failures with bounded
    backoff; fatal faults and the last attempt re-raise unchanged.
    `fault.retried` counts retries, `fault.recovered_ms` (µs in the bytes
    slot) the time spent recovering before a success."""
    t0 = None
    for attempt in range(1, MAX_ATTEMPTS + 1):
        try:
            out = fn()
            if t0 is not None:
                COUNTERS.add("fault.recovered_ms",
                             int((time.perf_counter() - t0) * 1e6))
            return out
        except Exception as e:  # classified below
            if not is_transient(e) or attempt >= MAX_ATTEMPTS:
                raise
            if t0 is None:
                t0 = time.perf_counter()
            COUNTERS.add("fault.retried")
            delay = min(BASE_DELAY_MS * 2.0 ** (attempt - 1), MAX_DELAY_MS) \
                * random.uniform(1.0 - JITTER, 1.0 + JITTER) / 1000.0
            logger.warning(
                f"transient fault at {site or 'op'} (attempt {attempt}/"
                f"{MAX_ATTEMPTS}): {type(e).__name__}: {e}; retrying in "
                f"{delay * 1000:.0f} ms")
            time.sleep(delay)

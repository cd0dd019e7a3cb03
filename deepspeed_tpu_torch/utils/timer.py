"""Wall-clock timers — the port of deepspeed_tpu/utils/timer.py
(reference: deepspeed/utils/timer.py:19-103 SynchronizedWallClockTimer).

CUDA work is asynchronous, so timing a region that ends in device work
requires passing that work's output to stop(sync=...): the timer then
waits for the current stream of that tensor's card before it reads the
clock (a CPU tensor needs no wait).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from .device import wait_for
from .logging import log_dist


class _Timer:
    """reference timer.py:25-69."""

    def __init__(self, name: str):
        self.name_ = name
        self.elapsed_ = 0.0
        self.started_ = False
        self.start_time = 0.0

    def start(self):
        assert not self.started_, f"timer {self.name_} already started"
        self.start_time = time.time()
        self.started_ = True

    def stop(self, sync=None):
        assert self.started_, f"timer {self.name_} not started"
        if sync is not None:
            wait_for(sync)
        self.elapsed_ += time.time() - self.start_time
        self.started_ = False

    def reset(self):
        self.elapsed_ = 0.0
        self.started_ = False

    def elapsed(self, reset=True) -> float:
        started = self.started_
        if started:
            self.stop()
        out = self.elapsed_
        if reset:
            self.reset()
        if started:
            self.start()
        return out

    def mean(self, count: int) -> float:
        return self.elapsed(reset=False) / max(count, 1)


class SynchronizedWallClockTimer:
    """Named-timer registry (reference timer.py:19-103)."""

    def __init__(self):
        self.timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name)
        return self.timers[name]

    def has(self, name: str) -> bool:
        return name in self.timers

    @staticmethod
    def memory_usage() -> str:
        """Device-memory line (the reference reports the CUDA allocator's
        allocated and peak bytes): the caching allocator's
        `memory_allocated` / `max_memory_allocated` of the current card,
        in the JAX package's layout (sum and hottest device)."""
        try:
            from ..monitor.monitor import device_memory_stats

            stats = device_memory_stats()
            if not stats:
                return "mem: unavailable"
            gb = 2 ** 30
            return (f"mem: in_use {stats['bytes_in_use_sum'] / gb:.2f} GB "
                    f"(max/dev {stats['bytes_in_use_max'] / gb:.2f}) | "
                    f"peak {stats['peak_bytes_in_use_sum'] / gb:.2f} GB "
                    f"(max/dev {stats['peak_bytes_in_use_max'] / gb:.2f})")
        except Exception:
            return "mem: unavailable"

    def log(self, names: List[str], normalizer: float = 1.0,
            reset: bool = True, ranks: Optional[List[int]] = None,
            memory_breakdown: bool = False):
        assert normalizer > 0.0
        parts = []
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) * 1000.0 / \
                    normalizer
                parts.append(f"{name}: {ms:.2f}")
        if not parts and not memory_breakdown:
            return  # nothing matched: no bare "time (ms) |" line
        line = "time (ms) | " + " | ".join(parts)
        if memory_breakdown:
            line += " | " + self.memory_usage()
        log_dist(line, ranks=ranks or [0])


# reference utils/timer.py:105 defines ThroughputTimer here; the port
# keeps it with the runtime helpers, as the JAX package does
from ..runtime.utils import ThroughputTimer  # noqa: E402,F401

"""Device-aware timing spans and the config-driven profiler window — the
port of deepspeed_tpu/monitor/spans.py.

CUDA work is asynchronous: wall-clocking a region that ends in device
work measures the enqueue unless the caller waits for that work's
output.  `_Timer.stop(sync=)` (utils/timer.py) hard-codes that pattern
for two named timers; `Span` generalizes it — any region, any sink,
close on a marker tensor — and `TraceWindow` turns a hand-written
`torch.profiler` script into a config key (start step / num steps /
output dir).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

from ..utils.device import wait_for
from ..utils.logging import log_dist, logger


class Span:
    """One timed region, started at construction.

    close(sync=x) waits for the device work that produced x (the current
    stream of x's card; nothing for a CPU tensor) before reading the
    clock, so the span covers that work, not just its enqueue.
    close(sync=None) reads the clock immediately — the honest
    measurement is then host time, which is what you want for regions
    that are pure Python.  Also usable as a context manager (no sync on
    exit — pass the marker to close() instead for device-bounded
    regions)."""

    __slots__ = ("name", "t0", "elapsed", "_sink", "_closed")

    def __init__(self, name: str,
                 sink: Optional[Callable[[str, float], None]] = None):
        self.name = name
        self._sink = sink
        self.elapsed = 0.0
        self._closed = False
        self.t0 = time.perf_counter()

    def close(self, sync=None) -> float:
        if self._closed:
            return self.elapsed
        if sync is not None:
            wait_for(sync)
        self.elapsed = time.perf_counter() - self.t0
        self._closed = True
        if self._sink is not None:
            self._sink(self.name, self.elapsed)
        return self.elapsed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class SpanSet:
    """Step-scoped span accumulator: name -> (seconds, count).  The
    monitor drains it into each step event."""

    __slots__ = ("_acc",)

    def __init__(self):
        self._acc: Dict[str, list] = {}

    def record(self, name: str, seconds: float) -> None:
        e = self._acc.get(name)
        if e is None:
            self._acc[name] = [seconds, 1]
        else:
            e[0] += seconds
            e[1] += 1

    def span(self, name: str) -> Span:
        return Span(name, sink=self.record)

    def drain_ms(self) -> Dict[str, float]:
        out = {k: round(v[0] * 1000.0, 3) for k, v in self._acc.items()}
        self._acc.clear()
        return out


class TraceWindow:
    """Config-driven `torch.profiler.profile` capture (CPU and, where a
    card is present, CUDA activities): starts at `start_step`, stops
    after `num_steps` steps (or at close()) and exports a Chrome trace,
    `trace.step<start>.json`, into `output_dir` (`path` once written).
    Feed it every step via tick(step); it is a no-op outside the window
    and after completion, and any profiler failure disables it loudly
    rather than killing the run.  `on_start`, when set, is called once
    the capture runs, before the window's first step (a caller's marker
    launches)."""

    def __init__(self, start_step: int, num_steps: int, output_dir: str):
        self.start_step = int(start_step)
        self.num_steps = max(1, int(num_steps))
        self.output_dir = output_dir
        self.active = False
        self.done = self.start_step < 0
        self.path: Optional[str] = None
        self.on_start: Optional[Callable[[], None]] = None
        self._prof = None

    def tick(self, step: int) -> None:
        if self.done:
            return
        if not self.active and step >= self.start_step:
            try:
                import torch
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(ProfilerActivity.CUDA)
                os.makedirs(self.output_dir, exist_ok=True)
                self._prof = profile(activities=acts)
                self._prof.__enter__()
                self.active = True
                log_dist(f"profiler trace started at step {step} -> "
                         f"{self.output_dir}", ranks=[0])
            except Exception as e:
                logger.warning(f"profiler trace failed to start: {e}")
                self._prof = None
                self.done = True
                return
            if self.on_start is not None:
                self.on_start()
        elif self.active and step >= self.start_step + self.num_steps:
            self._stop(step)

    def _stop(self, step) -> None:
        try:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            path = os.path.join(self.output_dir,
                                f"trace.step{self.start_step}.json")
            self._prof.export_chrome_trace(path)
            self.path = path
            log_dist(f"profiler trace stopped at step {step} ({path})",
                     ranks=[0])
        except Exception as e:
            logger.warning(f"profiler trace failed to stop: {e}")
        self._prof = None
        self.active = False
        self.done = True

    def close(self) -> None:
        if self.active:
            self._stop(self.start_step + self.num_steps)

"""TensorBoard scalar monitor — the port of
deepspeed_tpu/utils/tensorboard.py.

Reference: the engine writes Train/Samples/* scalars from rank 0 when
tensorboard is configured (runtime/engine.py:1058-1068,1223-1237). Same
here; the writer is torch.utils.tensorboard's SummaryWriter when the
`tensorboard` package imports, else the monitor is disabled with a
warning; `writer=` injects any object with `add_scalar(tag, value,
step)` and `flush()`.  In the telemetry pipeline this is one SINK beside
the JSONL event stream (monitor/monitor.py), not the primary record.
"""

from __future__ import annotations

import math
import os

from .logging import logger


class TensorBoardMonitor:
    def __init__(self, output_path: str = "", job_name: str = "DeepSpeedJobName",
                 flush_interval: int = 20, writer=None):
        """flush_interval: flush the event file every N distinct steps
        (the writer's own flush only runs at close/large buffers, so a
        killed run used to lose everything since the last explicit
        flush).  writer: injectable SummaryWriter-shaped object (tests,
        alternative sinks)."""
        self.enabled = False
        self.summary_writer = None
        self.flush_interval = max(1, int(flush_interval))
        self._last_flush_step = {}
        self._warned_nonfinite = set()
        if writer is not None:
            self.summary_writer = writer
            self.enabled = True
            return
        base = output_path or os.path.join(os.path.expanduser("~"),
                                           "tensorboard")
        log_dir = os.path.join(base, job_name)
        try:
            from torch.utils.tensorboard import SummaryWriter

            os.makedirs(log_dir, exist_ok=True)
            self.summary_writer = SummaryWriter(log_dir=log_dir)
            self.enabled = True
        except Exception as e:  # pragma: no cover - no tensorboard install
            logger.warning(f"tensorboard disabled: {e}")

    def add_scalar(self, tag: str, value, step: int):
        if not self.enabled:
            return
        value = float(value)
        if not math.isfinite(value):
            # a NaN loss used to poison the event file silently; drop the
            # point and say so once per tag
            if tag not in self._warned_nonfinite:
                self._warned_nonfinite.add(tag)
                logger.warning(
                    f"tensorboard: dropping non-finite value for {tag!r} "
                    f"at step {step} (further drops for this tag are "
                    f"silent)")
            return
        self.summary_writer.add_scalar(tag, value, step)
        # per-tag step tracking: different writers use different x-scales
        # (engine: global_samples; run monitor: step) — a single shared
        # last-flush mark would thrash or never fire across them
        prev = self._last_flush_step.setdefault(tag, step)
        if step - prev >= self.flush_interval:
            self.flush()
            self._last_flush_step[tag] = step

    def flush(self):
        if self.enabled:
            self.summary_writer.flush()

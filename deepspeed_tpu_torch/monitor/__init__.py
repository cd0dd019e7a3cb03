"""deepspeed_tpu_torch.monitor — structured run telemetry (the port of
deepspeed_tpu/monitor):

* `RunMonitor` — per-rank schema-versioned JSONL event stream + manifest
  + end-of-run summaries, TensorBoard as one sink beside it, multi-rank
  heartbeats with rank-0 straggler detection (monitor.py).
* `Span` / `TraceWindow` — device-aware timing and the config-driven
  `torch.profiler` capture window (spans.py).
* `COUNTERS` — the process-global counter registry (counters.py).
* `TraceRecorder` / `ServingSLO` — span timelines and serving SLO
  windows (tracing.py).
* `report` — renders any run's JSONL back into a BENCH.md-style table.
"""

from .config import MONITOR, DeepSpeedMonitorConfig  # noqa: F401
from .counters import COUNTERS, CounterRegistry  # noqa: F401
from .monitor import (SCHEMA_VERSION, RunMonitor,  # noqa: F401
                      device_memory_stats)
from .spans import Span, SpanSet, TraceWindow  # noqa: F401
from .tracing import (TRACE_SCHEMA_VERSION, ServingSLO,  # noqa: F401
                      TraceRecorder, percentile_nearest_rank,
                      read_trace_file)

__all__ = ["COUNTERS", "CounterRegistry", "DeepSpeedMonitorConfig",
           "MONITOR", "RunMonitor", "SCHEMA_VERSION", "ServingSLO", "Span",
           "SpanSet", "TRACE_SCHEMA_VERSION", "TraceRecorder", "TraceWindow",
           "device_memory_stats", "percentile_nearest_rank",
           "read_trace_file"]

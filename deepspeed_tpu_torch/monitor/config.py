"""Monitor config block — the port's copy of
deepspeed_tpu/monitor/config.py (no reference analogue; the reference's
observability is TensorBoard scalars + rank-0 log lines).

JSON schema:

    "monitor": {
        "enabled": true,
        "output_path": "runs",          # run dirs land under here
        "job_name": "my_run",           # -> <output_path>/<job_name>/
        "flush_interval": 10,           # steps between event-file flushes
        "sync_timing": true,            # synchronize the device before
                                        # reading span clocks (real step
                                        # time; one device sync per step)
        "flops": true,                  # achieved-TFLOPs via the flops
                                        # profiler's product count over
                                        # the first step
        "tokens_per_sample": 1024,      # optional: emit tokens/s
        "heartbeat_interval": 0,        # steps; >0 enables multi-rank
                                        # heartbeats over the process group
        "straggler_factor": 1.5,        # rank-0 straggler flag threshold
        "profiler": {                   # torch.profiler window
            "start_step": -1,           # -1: disabled
            "num_steps": 1,
            "output_dir": ""            # default: <run_dir>/profile
        },
        "tracing": {                    # monitor/tracing.py TraceRecorder
            "enabled": false,           # off by default: zero files,
                                        # zero threads when disabled
            "buffer_events": 2048,      # flight-recorder ring capacity
            "max_file_bytes": 16777216, # per-rank trace file byte bound
            "sample_rate": 1.0,         # fraction of steps/requests
                                        # traced (seeded, deterministic)
            "seed": 0,
            "flush_interval_s": 0.5,    # background writer cadence
            "slo": {                    # serving SLO window (ServingSLO)
                "window_s": 10.0,
                "emit_interval_s": 2.0
            }
        }
    }

Unlike the tolerant top-level monitor keys (which predate the strict
convention), the `tracing` block validates like the serving/autotune
blocks: unknown keys and out-of-range values raise at config time.
"""

from ..runtime.config_utils import DeepSpeedConfigObject, get_scalar_param

MONITOR = "monitor"
MONITOR_ENABLED = "enabled"
MONITOR_OUTPUT_PATH = "output_path"
MONITOR_JOB_NAME = "job_name"
MONITOR_FLUSH_INTERVAL = "flush_interval"
MONITOR_SYNC_TIMING = "sync_timing"
MONITOR_FLOPS = "flops"
MONITOR_TOKENS_PER_SAMPLE = "tokens_per_sample"
MONITOR_HEARTBEAT_INTERVAL = "heartbeat_interval"
MONITOR_STRAGGLER_FACTOR = "straggler_factor"
MONITOR_PROFILER = "profiler"
MONITOR_PROFILER_START_STEP = "start_step"
MONITOR_PROFILER_NUM_STEPS = "num_steps"
MONITOR_PROFILER_OUTPUT_DIR = "output_dir"
MONITOR_TRACING = "tracing"
MONITOR_TRACING_ENABLED = "enabled"
MONITOR_TRACING_BUFFER_EVENTS = "buffer_events"
MONITOR_TRACING_MAX_FILE_BYTES = "max_file_bytes"
MONITOR_TRACING_SAMPLE_RATE = "sample_rate"
MONITOR_TRACING_SEED = "seed"
MONITOR_TRACING_FLUSH_INTERVAL_S = "flush_interval_s"
MONITOR_TRACING_SLO = "slo"
MONITOR_TRACING_SLO_WINDOW_S = "window_s"
MONITOR_TRACING_SLO_EMIT_INTERVAL_S = "emit_interval_s"

MONITOR_TRACING_ENABLED_DEFAULT = False
MONITOR_TRACING_BUFFER_EVENTS_DEFAULT = 2048
MONITOR_TRACING_MAX_FILE_BYTES_DEFAULT = 16 << 20
MONITOR_TRACING_SAMPLE_RATE_DEFAULT = 1.0
MONITOR_TRACING_SEED_DEFAULT = 0
MONITOR_TRACING_FLUSH_INTERVAL_S_DEFAULT = 0.5
MONITOR_TRACING_SLO_WINDOW_S_DEFAULT = 10.0
MONITOR_TRACING_SLO_EMIT_INTERVAL_S_DEFAULT = 2.0

_TRACING_VALID_KEYS = frozenset((
    MONITOR_TRACING_ENABLED, MONITOR_TRACING_BUFFER_EVENTS,
    MONITOR_TRACING_MAX_FILE_BYTES, MONITOR_TRACING_SAMPLE_RATE,
    MONITOR_TRACING_SEED, MONITOR_TRACING_FLUSH_INTERVAL_S,
    MONITOR_TRACING_SLO))
_TRACING_SLO_VALID_KEYS = frozenset((
    MONITOR_TRACING_SLO_WINDOW_S, MONITOR_TRACING_SLO_EMIT_INTERVAL_S))


def _tracing_int(d, key, default, lo):
    v = d.get(key, default)
    if isinstance(v, bool) or not isinstance(v, int):
        raise ValueError(
            f"monitor.tracing.{key} must be an int, got {v!r}")
    if v < lo:
        raise ValueError(f"monitor.tracing.{key} must be >= {lo}, got {v}")
    return v


def _tracing_float(d, key, default, lo, hi=None, prefix="monitor.tracing"):
    v = d.get(key, default)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise ValueError(f"{prefix}.{key} must be a number, got {v!r}")
    v = float(v)
    if v <= lo or (hi is not None and v > hi):
        bound = f"in ({lo}, {hi}]" if hi is not None else f"> {lo}"
        raise ValueError(f"{prefix}.{key} must be {bound}, got {v}")
    return v


class DeepSpeedMonitorConfig(DeepSpeedConfigObject):
    def __init__(self, param_dict):
        super().__init__()
        d = param_dict.get(MONITOR, {}) or {}
        self.enabled = bool(get_scalar_param(d, MONITOR_ENABLED, False))
        self.output_path = get_scalar_param(d, MONITOR_OUTPUT_PATH, "runs")
        self.job_name = get_scalar_param(d, MONITOR_JOB_NAME, "run")
        self.flush_interval = int(get_scalar_param(
            d, MONITOR_FLUSH_INTERVAL, 10))
        self.sync_timing = bool(get_scalar_param(
            d, MONITOR_SYNC_TIMING, True))
        self.flops = bool(get_scalar_param(d, MONITOR_FLOPS, True))
        self.tokens_per_sample = get_scalar_param(
            d, MONITOR_TOKENS_PER_SAMPLE, None)
        self.heartbeat_interval = int(get_scalar_param(
            d, MONITOR_HEARTBEAT_INTERVAL, 0))
        self.straggler_factor = float(get_scalar_param(
            d, MONITOR_STRAGGLER_FACTOR, 1.5))
        prof = d.get(MONITOR_PROFILER, {}) or {}
        self.profiler_start_step = int(get_scalar_param(
            prof, MONITOR_PROFILER_START_STEP, -1))
        self.profiler_num_steps = int(get_scalar_param(
            prof, MONITOR_PROFILER_NUM_STEPS, 1))
        self.profiler_output_dir = get_scalar_param(
            prof, MONITOR_PROFILER_OUTPUT_DIR, "")
        self._parse_tracing(d)

    def _parse_tracing(self, d):
        tr = d.get(MONITOR_TRACING, {}) or {}
        if not isinstance(tr, dict):
            raise ValueError(
                f"monitor.tracing must be an object, got {tr!r}")
        unknown = set(tr) - _TRACING_VALID_KEYS
        if unknown:
            raise ValueError(
                f"monitor.tracing: unknown key(s) {sorted(unknown)}; "
                f"valid keys: {sorted(_TRACING_VALID_KEYS)}")
        enabled = tr.get(MONITOR_TRACING_ENABLED,
                         MONITOR_TRACING_ENABLED_DEFAULT)
        if not isinstance(enabled, bool):
            raise ValueError("monitor.tracing.enabled must be a bool, "
                             f"got {enabled!r}")
        self.tracing_enabled = enabled
        if enabled and not self.enabled:
            raise ValueError(
                "monitor.tracing.enabled requires monitor.enabled: the "
                "trace files land in the monitor run dir")
        self.tracing_buffer_events = _tracing_int(
            tr, MONITOR_TRACING_BUFFER_EVENTS,
            MONITOR_TRACING_BUFFER_EVENTS_DEFAULT, 16)
        self.tracing_max_file_bytes = _tracing_int(
            tr, MONITOR_TRACING_MAX_FILE_BYTES,
            MONITOR_TRACING_MAX_FILE_BYTES_DEFAULT, 4096)
        self.tracing_sample_rate = _tracing_float(
            tr, MONITOR_TRACING_SAMPLE_RATE,
            MONITOR_TRACING_SAMPLE_RATE_DEFAULT, 0.0, 1.0)
        self.tracing_seed = _tracing_int(
            tr, MONITOR_TRACING_SEED, MONITOR_TRACING_SEED_DEFAULT, 0)
        self.tracing_flush_interval_s = _tracing_float(
            tr, MONITOR_TRACING_FLUSH_INTERVAL_S,
            MONITOR_TRACING_FLUSH_INTERVAL_S_DEFAULT, 0.0)
        slo = tr.get(MONITOR_TRACING_SLO, {}) or {}
        if not isinstance(slo, dict):
            raise ValueError(
                f"monitor.tracing.slo must be an object, got {slo!r}")
        unknown = set(slo) - _TRACING_SLO_VALID_KEYS
        if unknown:
            raise ValueError(
                f"monitor.tracing.slo: unknown key(s) {sorted(unknown)}; "
                f"valid keys: {sorted(_TRACING_SLO_VALID_KEYS)}")
        self.tracing_slo_window_s = _tracing_float(
            slo, MONITOR_TRACING_SLO_WINDOW_S,
            MONITOR_TRACING_SLO_WINDOW_S_DEFAULT, 0.0,
            prefix="monitor.tracing.slo")
        self.tracing_slo_emit_interval_s = _tracing_float(
            slo, MONITOR_TRACING_SLO_EMIT_INTERVAL_S,
            MONITOR_TRACING_SLO_EMIT_INTERVAL_S_DEFAULT, 0.0,
            prefix="monitor.tracing.slo")

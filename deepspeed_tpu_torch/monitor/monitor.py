"""RunMonitor — the structured telemetry pipeline; the port of
deepspeed_tpu/monitor/monitor.py, writing the JAX package's records.

One instance per engine per process.  Every training step produces one
schema-versioned JSONL event on every rank (`events.rank*.jsonl` in the
run directory), carrying the wall-time breakdown (device-aware spans),
throughput, achieved TFLOPs, loss-scale/overflow bookkeeping, the
caching allocator's memory stats of the rank's card, and the per-step
counter deltas (monitor/counters.py).  A manifest written at
construction makes the run self-describing; `report.render_markdown`
(or the JAX package's `tools/run_report.py`) renders any run dir back
into a BENCH.md-style table.

Sinks: the JSONL stream is primary; an attached `TensorBoardMonitor`
(utils/tensorboard.py) receives the scalar subset of every event.

Multi-rank: every rank writes its own event stream (no cross-process
traffic per step).  With `heartbeat_interval > 0`, every N steps all
ranks exchange a tiny summary over the process group (`wire`, by default
comm/dist.py's `allgather_bytes`, where JAX's goes over its host wire —
a collective call, naturally aligned since train steps are already
collective) and rank 0 flags stragglers whose step time exceeds
`straggler_factor` x the median.  `close()` writes a per-rank summary;
with more than one rank it also merges all ranks' summaries into one
`summary.json` on rank 0.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, Optional

from ..utils.logging import log_dist, logger
from .config import DeepSpeedMonitorConfig
from .counters import COUNTERS
from .spans import Span, SpanSet, TraceWindow
from .tracing import TraceRecorder

SCHEMA_VERSION = 1


def device_memory_stats(device=None) -> Dict[str, Any]:
    """in_use/peak bytes of the caching allocator on this rank's card
    (`torch.cuda.memory_stats`: allocated bytes, current and peak), in
    the JAX package's keys (sum and per-device max over one device).
    Empty dict on the CPU, or before the process has touched CUDA, as
    the JAX package's is where the backend exposes no stats."""
    try:
        import torch

        if device is not None and torch.device(device).type != "cuda":
            return {}
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return {}
        idx = (torch.device(device).index if device is not None else None)
        if idx is None:
            idx = torch.cuda.current_device()
        stats = torch.cuda.memory_stats(idx) or {}
    except Exception:
        return {}
    in_use = int(stats.get("allocated_bytes.all.current", 0))
    peak = int(stats.get("allocated_bytes.all.peak", 0))
    if not in_use and not peak:
        return {}
    return {
        "n_devices": 1,
        "bytes_in_use_sum": in_use,
        "bytes_in_use_max": in_use,
        "peak_bytes_in_use_sum": peak,
        "peak_bytes_in_use_max": peak,
    }


def _finite(x) -> Optional[float]:
    try:
        x = float(x)
    except (TypeError, ValueError):
        return None
    return x if math.isfinite(x) else None


class RunMonitor:
    def __init__(self, config: Optional[DeepSpeedMonitorConfig] = None,
                 rank: Optional[int] = None, world: Optional[int] = None,
                 manifest_extra: Optional[Dict[str, Any]] = None,
                 tensorboard=None, wire=None, device=None):
        """config: the parsed "monitor" block (defaults when None).
        rank/world default to this process's place in the process group
        (comm/dist.py).  tensorboard: an optional
        utils.tensorboard.TensorBoardMonitor sink.  wire: an object with
        `allgather_bytes(payload) -> [bytes]` for the heartbeats, the
        summary merge and the tracer's clock sync (default, with more
        than one rank: the process group's).  device: the engine's
        device (the memory stats read its card; None: the current
        card)."""
        from ..comm import dist

        self.config = config or DeepSpeedMonitorConfig({})
        self.rank = dist.get_rank() if rank is None else int(rank)
        self.world = dist.get_world_size() if world is None else int(world)
        self.device = device
        self.tensorboard = tensorboard
        self._wire_obj = wire
        self.spans = SpanSet()
        self.flops_per_step: Optional[float] = None
        # baseline counter snapshot at CONSTRUCTION: activity between
        # engine init and the first step (a resumed checkpoint's load —
        # incl. elastic.shrinks/regrows and ckpt.skipped_tags) attributes
        # to the first step event instead of vanishing before the first
        # step_start's lazy snapshot
        self._counter_snap = COUNTERS.snapshot()
        self._step_t0 = None
        self._events_since_flush = 0
        self._n_events = 0
        self._step_walls = []  # rolling per-step wall seconds (summary)
        self._last_event: Optional[Dict[str, Any]] = None
        self._closed = False

        self.run_dir = os.path.join(self.config.output_path,
                                    self.config.job_name)
        os.makedirs(self.run_dir, exist_ok=True)
        self._events_path = os.path.join(
            self.run_dir, f"events.rank{self.rank:05d}.jsonl")
        self._f = open(self._events_path, "a")

        prof_dir = self.config.profiler_output_dir or \
            os.path.join(self.run_dir, "profile")
        self.trace_window = TraceWindow(self.config.profiler_start_step,
                                        self.config.profiler_num_steps,
                                        prof_dir)
        # span tracing (monitor/tracing.py): constructed ONLY when
        # enabled — a disabled run creates zero trace files and zero
        # threads.  With >1 process the recorder's init allgather (the
        # clock-skew sync) is collective, like close().
        self.tracer = None
        if getattr(self.config, "tracing_enabled", False):
            wire = None
            if self.world > 1 or self._wire_obj is not None:
                wire = self._wire()
            self.tracer = TraceRecorder(
                self.run_dir, rank=self.rank, world=self.world,
                buffer_events=self.config.tracing_buffer_events,
                max_file_bytes=self.config.tracing_max_file_bytes,
                sample_rate=self.config.tracing_sample_rate,
                seed=self.config.tracing_seed,
                flush_interval_s=self.config.tracing_flush_interval_s,
                wire=wire)
        if self.rank == 0:
            self._write_manifest(manifest_extra or {})

    # ------------------------------------------------------------------
    # manifest / event plumbing
    # ------------------------------------------------------------------

    def _write_manifest(self, extra: Dict[str, Any]) -> None:
        try:
            import torch

            cuda = torch.cuda.is_available() and (
                self.device is None or
                torch.device(self.device).type == "cuda")
            backend = "cuda" if cuda else "cpu"
            n_dev = torch.cuda.device_count() if cuda else 1
        except Exception:
            backend, n_dev = "unknown", 0
        manifest = {
            "schema_version": SCHEMA_VERSION,
            "created_unix": time.time(),
            "world_size": self.world,
            "backend": backend,
            "device_count": n_dev,
            "monitor_config": {
                k: v for k, v in sorted(self.config.__dict__.items())},
            **extra,
        }
        path = os.path.join(self.run_dir, "manifest.json")
        with open(path, "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True, default=str)

    def emit(self, event_type: str, payload: Dict[str, Any]) -> None:
        event = {"v": SCHEMA_VERSION, "type": event_type, "rank": self.rank,
                 "t": round(time.time(), 6), **payload}
        self._f.write(json.dumps(event, default=str) + "\n")
        self._n_events += 1
        self._events_since_flush += 1
        if self._events_since_flush >= max(1, self.config.flush_interval):
            self._f.flush()
            self._events_since_flush = 0
        self._last_event = event

    # ------------------------------------------------------------------
    # step lifecycle
    # ------------------------------------------------------------------

    def span(self, name: str) -> Span:
        return self.spans.span(name)

    @property
    def sync_timing(self) -> bool:
        return self.config.sync_timing

    def step_start(self, step: int) -> None:
        """Call at the start of a global batch (accumulation boundary).
        The counter snapshot carries over from the previous step_end
        when one exists, so work BETWEEN steps (checkpoint saves, user
        collectives) is attributed to the next step event instead of
        vanishing into the gap."""
        self.trace_window.tick(step)
        if self._counter_snap is None:
            self._counter_snap = COUNTERS.snapshot()
        self._step_t0 = time.perf_counter()

    def step_end(self, step: int, **metrics) -> None:
        """Emit one step event.  Accepted metric keys (all optional):
        loss, lr, loss_scale, grad_norm, overflow, skipped_steps,
        samples_per_sec, flops_per_step, pipe (dict of pipeline
        accounting).  Unknown keys pass through verbatim."""
        wall = (time.perf_counter() - self._step_t0
                if self._step_t0 is not None else None)
        self._step_t0 = None
        payload: Dict[str, Any] = {"step": int(step)}
        if wall is not None:
            payload["wall_ms"] = round(wall * 1000.0, 3)
            self._step_walls.append(wall)
        spans_ms = self.spans.drain_ms()
        if spans_ms:
            payload["spans_ms"] = spans_ms
        comm = COUNTERS.delta_since(self._counter_snap)
        # re-snapshot HERE (not at the next step_start) so inter-step
        # counter activity lands in the next event's delta
        self._counter_snap = COUNTERS.snapshot()
        if comm:
            payload["comm"] = comm
        mem = device_memory_stats(self.device)
        if mem:
            payload["memory"] = mem

        flops = metrics.pop("flops_per_step", None) or self.flops_per_step
        sps = metrics.get("samples_per_sec")
        if sps is not None and self.config.tokens_per_sample:
            payload["tokens_per_sec"] = round(
                float(sps) * float(self.config.tokens_per_sample), 1)
        if flops and wall:
            payload["tflops"] = float(f"{flops / wall / 1e12:.4g}")
        for k, v in metrics.items():
            if v is None:
                continue
            payload[k] = _finite(v) if isinstance(v, float) else v
        self.emit("step", payload)
        self._emit_tensorboard(step, payload)
        hb = self.config.heartbeat_interval
        if hb > 0 and step > 0 and step % hb == 0:
            self.heartbeat(step, wall)

    def _emit_tensorboard(self, step: int, payload: Dict[str, Any]) -> None:
        # step-scoped Train/Step/* tags ONLY: the engine's own
        # _emit_monitor_scalars writes Train/Samples/* at x=global_samples;
        # reusing those tags here (x=step) would zigzag the shared series
        tb = self.tensorboard
        if tb is None:
            return
        for key, tag in (("loss", "Train/Step/loss"),
                         ("lr", "Train/Step/lr"),
                         ("loss_scale", "Train/Step/loss_scale"),
                         ("wall_ms", "Train/Step/wall_ms"),
                         ("tflops", "Train/Step/tflops")):
            v = payload.get(key)
            if v is not None:
                tb.add_scalar(tag, v, step)

    # ------------------------------------------------------------------
    # multi-host aggregation
    # ------------------------------------------------------------------

    def _wire(self):
        if self._wire_obj is None:
            from ..comm.dist import ProcessGroupWire

            self._wire_obj = ProcessGroupWire()
        return self._wire_obj

    def heartbeat(self, step: int, wall_s: Optional[float]) -> None:
        """Collective: every rank ships (rank, step, step wall time);
        rank 0 merges, flags stragglers, and emits a heartbeat event.
        Aligned by construction — train steps are already collective."""
        if self.world <= 1 and self._wire_obj is None:
            return
        mine = {"rank": self.rank, "step": int(step),
                "wall_s": wall_s, "t": time.time()}
        try:
            parts = self._wire().allgather_bytes(
                json.dumps(mine).encode("utf-8"))
        except Exception as e:
            logger.warning(f"monitor heartbeat failed: {e}")
            return
        if self.rank != 0:
            return
        beats = []
        for p in parts:
            try:
                beats.append(json.loads(p.decode("utf-8")))
            except Exception:
                continue
        walls = sorted(b["wall_s"] for b in beats
                       if b.get("wall_s") is not None)
        stragglers = []
        if len(walls) >= 2:
            median = walls[len(walls) // 2]
            if median > 0:
                stragglers = [b["rank"] for b in beats
                              if (b.get("wall_s") or 0)
                              > self.config.straggler_factor * median]
        min_step = min((b["step"] for b in beats), default=step)
        self.emit("heartbeat", {"step": int(step), "beats": beats,
                                "stragglers": stragglers,
                                "min_step": min_step})
        if stragglers:
            log_dist(f"monitor: straggler rank(s) {stragglers} at step "
                     f"{step} (> {self.config.straggler_factor}x median "
                     f"step time)", ranks=[0])

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------

    def _local_summary(self) -> Dict[str, Any]:
        walls = self._step_walls
        mean = sum(walls) / len(walls) if walls else None
        return {
            "rank": self.rank,
            "steps": len(walls),
            "events": self._n_events,
            "mean_step_ms": round(mean * 1000.0, 3) if mean else None,
            "counters": COUNTERS.totals(),
        }

    def close(self) -> None:
        """Flush the event stream and write end-of-run summaries.  With
        more than one rank this is COLLECTIVE (rank summaries merge over
        the wire) — call it on every rank or not at all."""
        if self._closed:
            return
        self._closed = True
        self.trace_window.close()
        if self.tracer is not None:
            self.tracer.close()
        summary = self._local_summary()
        merged = [summary]
        if self.world > 1 or self._wire_obj is not None:
            try:
                parts = self._wire().allgather_bytes(
                    json.dumps(summary, default=str).encode("utf-8"))
                merged = [json.loads(p.decode("utf-8")) for p in parts]
            except Exception as e:
                logger.warning(f"monitor summary merge failed: {e}")
        with open(os.path.join(
                self.run_dir, f"summary.rank{self.rank:05d}.json"),
                "w") as f:
            json.dump(summary, f, indent=2, sort_keys=True, default=str)
        if self.rank == 0:
            with open(os.path.join(self.run_dir, "summary.json"), "w") as f:
                json.dump({"schema_version": SCHEMA_VERSION,
                           "ranks": merged}, f, indent=2, sort_keys=True,
                          default=str)
        self.emit("run_end", {"summary": summary})
        self._f.flush()
        self._f.close()

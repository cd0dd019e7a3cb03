"""Run-report rendering: JSONL event stream -> BENCH.md-style table —
the port's copy of deepspeed_tpu/monitor/report.py, whole.

The port's `RunMonitor` (monitor.py) writes the JAX package's records,
so this reader and the JAX package's `tools/run_report.py` both render a
port run directory; the copy keeps every schema assumption next to the
port's writer."""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 1

# required keys per event type; value is the required python type(s)
_STEP_REQUIRED = {"v": int, "type": str, "rank": int, "t": (int, float),
                  "step": int}


def validate_event(event: Dict[str, Any]) -> List[str]:
    """Return a list of schema violations (empty = valid)."""
    errs = []
    if not isinstance(event, dict):
        return ["event is not an object"]
    for key, typ in _STEP_REQUIRED.items():
        if event.get("type") != "step" and key == "step":
            continue
        if key not in event:
            errs.append(f"missing key {key!r}")
        elif not isinstance(event[key], typ):
            errs.append(f"key {key!r} has type {type(event[key]).__name__}")
    if isinstance(event.get("v"), int) and event["v"] > SCHEMA_VERSION:
        errs.append(f"schema version {event['v']} is newer than reader "
                    f"({SCHEMA_VERSION})")
    if event.get("type") == "slo" and not isinstance(event.get("slo"),
                                                     dict):
        errs.append("slo event missing its 'slo' snapshot object")
    return errs


def read_events(path: str) -> List[Dict[str, Any]]:
    events = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: invalid JSON: {e}")
    return events


def load_run(run_dir: str) -> Dict[str, Any]:
    """Load a run directory: manifest (optional) + every rank's events
    + the supervisor restart ledger and watchdog trip file when
    present (elasticity/supervisor.py, runtime/resilience.py)."""
    manifest = None
    mpath = os.path.join(run_dir, "manifest.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)
    ranks: Dict[int, List[Dict[str, Any]]] = {}
    for path in sorted(glob.glob(os.path.join(run_dir,
                                              "events.rank*.jsonl"))):
        events = read_events(path)
        rank = int(os.path.basename(path)[len("events.rank"):-len(".jsonl")])
        ranks[rank] = events
    # a serving-bench run dir (tools/serve_bench.py) carries its lane
    # table as serving.json — with it present, telemetry event streams
    # are optional (a pure serving run has no training steps to report)
    serving = None
    serving_err = None
    spath = os.path.join(run_dir, "serving.json")
    if os.path.exists(spath):
        try:
            with open(spath) as f:
                serving = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            serving_err = e
    if not ranks and serving is None:
        if serving_err is not None:
            # a serving-only dir with a torn serving.json: name the
            # REAL defect instead of claiming telemetry is missing
            raise ValueError(
                f"{spath}: unreadable serving.json "
                f"({type(serving_err).__name__}: {serving_err}) and no "
                f"events.rank*.jsonl to fall back on")
        raise FileNotFoundError(
            f"no events.rank*.jsonl under {run_dir!r}")
    restarts = _read_jsonl_ledger(os.path.join(run_dir, "restarts.jsonl"))
    watchdog_trip = None
    wpath = os.path.join(run_dir, "watchdog_trip.json")
    if os.path.exists(wpath):
        try:
            with open(wpath) as f:
                watchdog_trip = json.load(f)
        except (OSError, json.JSONDecodeError):
            watchdog_trip = None
    # the autotune ledger (runtime/autotune/runtime.py, rank 0):
    # search/cache_hit/retune/swap events, rendered as the "Autotune"
    # section's event table
    autotune = _read_jsonl_ledger(os.path.join(run_dir, "autotune.jsonl"))
    return {"dir": run_dir, "manifest": manifest, "ranks": ranks,
            "restarts": restarts, "watchdog_trip": watchdog_trip,
            "serving": serving, "autotune": autotune}


def _read_jsonl_ledger(path: str) -> List[Dict[str, Any]]:
    """Best-effort append-only ledger reader (restarts.jsonl,
    autotune.jsonl): blank lines and the torn tail of a live writer are
    skipped, a missing file is an empty ledger."""
    rows: List[Dict[str, Any]] = []
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail of a live ledger
    return rows


def _mean(xs):
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else None


def summarize(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate one rank's event list."""
    steps = [e for e in events if e.get("type") == "step"]
    hbs = [e for e in events if e.get("type") == "heartbeat"]
    comm: Dict[str, Dict[str, int]] = {}
    for e in steps:
        for name, d in (e.get("comm") or {}).items():
            acc = comm.setdefault(name, {"calls": 0, "bytes": 0})
            acc["calls"] += int(d.get("calls", 0))
            acc["bytes"] += int(d.get("bytes", 0))
    spans: Dict[str, float] = {}
    for e in steps:
        for name, ms in (e.get("spans_ms") or {}).items():
            spans[name] = spans.get(name, 0.0) + float(ms)
    losses = [e.get("loss") for e in steps if e.get("loss") is not None]
    mems = [e.get("memory") for e in steps if e.get("memory")]
    peak = max((m.get("peak_bytes_in_use_sum", 0) for m in mems),
               default=None) if mems else None
    pipe = next((e.get("pipe") for e in reversed(steps)
                 if e.get("pipe")), None)
    stragglers = sorted({r for e in hbs for r in (e.get("stragglers") or [])})
    return {
        "n_steps": len(steps),
        "first_step": steps[0]["step"] if steps else None,
        "last_step": steps[-1]["step"] if steps else None,
        "mean_wall_ms": _mean([e.get("wall_ms") for e in steps]),
        "mean_samples_per_sec": _mean([e.get("samples_per_sec")
                                       for e in steps]),
        "mean_tokens_per_sec": _mean([e.get("tokens_per_sec")
                                      for e in steps]),
        "mean_tflops": _mean([e.get("tflops") for e in steps]),
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "skipped_steps": max((e.get("skipped_steps", 0) for e in steps),
                             default=0),
        "comm": comm,
        "spans_ms_total": spans,
        "peak_bytes_in_use_sum": peak,
        "pipe": pipe,
        "stragglers": stragglers,
    }


def _fmt(x, nd=2, unit=""):
    if x is None:
        return "—"
    if isinstance(x, float):
        return f"{x:,.{nd}f}{unit}"
    return f"{x:,}{unit}"


def _fmt_bytes(b):
    if b is None:
        return "—"
    for mag, suffix in ((1 << 30, "GiB"), (1 << 20, "MiB"), (1 << 10, "KiB")):
        if b >= mag:
            return f"{b / mag:.2f} {suffix}"
    return f"{b} B"


def render_markdown(run: Dict[str, Any]) -> str:
    """BENCH.md-style report for a loaded run (load_run output)."""
    lines = [f"# Run report: `{run['dir']}`", ""]
    man = run.get("manifest")
    if man:
        lines.append(f"schema v{man.get('schema_version', '?')} · "
                     f"backend {man.get('backend', '?')} · "
                     f"{man.get('device_count', '?')} device(s) · "
                     f"world {man.get('world_size', '?')}")
        lines.append("")
    if run["ranks"]:
        lines.append("| rank | steps | wall ms/step | samples/s | tokens/s "
                     "| TFLOPs | loss first→last | skipped | peak mem |")
        lines.append("|---|---|---|---|---|---|---|---|---|")
    summaries = {}
    for rank in sorted(run["ranks"]):
        s = summarize(run["ranks"][rank])
        summaries[rank] = s
        loss = (f"{_fmt(s['first_loss'], 4)} → {_fmt(s['last_loss'], 4)}"
                if s["first_loss"] is not None else "—")
        lines.append(
            f"| {rank} | {s['n_steps']} | {_fmt(s['mean_wall_ms'])} | "
            f"{_fmt(s['mean_samples_per_sec'], 1)} | "
            f"{_fmt(s['mean_tokens_per_sec'], 1)} | "
            f"{_fmt(s['mean_tflops'])} | {loss} | {s['skipped_steps']} | "
            f"{_fmt_bytes(s['peak_bytes_in_use_sum'])} |")
    lines.append("")

    any_comm = {}
    for s in summaries.values():
        for name, d in s["comm"].items():
            acc = any_comm.setdefault(name, {"calls": 0, "bytes": 0})
            acc["calls"] += d["calls"]
            acc["bytes"] += d["bytes"]
    # input.*/ckpt.*/fault.*/watchdog.* counters carry pipeline/
    # checkpoint/resilience metrics (µs, queue depths, injection
    # counts), not wire bytes — split them out of the comm table into
    # their own sections
    input_counters = {k: v for k, v in any_comm.items()
                      if k.startswith("input.")}
    ckpt_counters = {k: v for k, v in any_comm.items()
                     if k.startswith("ckpt.")}
    # grad_wire.exposed_ms / qwz.prefetch_hits carry µs (the
    # ckpt.stall_ms convention), not wire bytes — they render in the
    # gradient-wire section below, not the comm byte table
    _WIRE_TIME_COUNTERS = ("grad_wire.exposed_ms", "qwz.prefetch_hits")
    # elastic.* counts world-size transitions (shrinks/regrows), not
    # wire bytes — Resilience rows, like fault.*; serve.*/kv.* carry
    # serving-engine metrics (tokens, µs, block occupancy) and render
    # as the "Serving" section below
    # moe.* carries MoE-wire metrics (hop bytes, µs, drop counts, ppm
    # occupancy) and renders as the "MoE wire" section below
    # autotune.* carries search/retune bookkeeping (probe µs in the
    # bytes slot, swap/rejection counts) and renders as the "Autotune"
    # section below
    # trace.*/slo.* carry trace-recorder bookkeeping (JSONL bytes,
    # drop counts, SLO window counts), not wire bytes — rendered as
    # the "Serving SLO" section's Tracing rows below
    # kernel.* counts registry dispatches (Pallas vs jnp-fallback
    # resolutions), not wire bytes — the "Kernels" section below
    wire_counters = {k: v for k, v in any_comm.items()
                     if not k.startswith(("input.", "ckpt.", "fault.",
                                          "watchdog.", "exchange.",
                                          "elastic.", "serve.", "kv.",
                                          "router.", "moe.", "autotune.",
                                          "trace.", "slo.", "kernel."))
                     and k not in _WIRE_TIME_COUNTERS}
    if wire_counters:
        lines.append("## Comm counters (all ranks, whole run)")
        lines.append("")
        lines.append("| counter | calls | bytes |")
        lines.append("|---|---|---|")
        for name in sorted(wire_counters):
            d = wire_counters[name]
            lines.append(f"| `{name}` | {d['calls']:,} | "
                         f"{_fmt_bytes(d['bytes'])} |")
        lines.append("")

    if input_counters:
        lines.append("## Input pipeline")
        lines.append("")
        lines.append("| metric | value |")
        lines.append("|---|---|")
        hw = input_counters.get("input.host_wait_ms")
        if hw:
            total_ms = hw["bytes"] / 1000.0  # stored as integer µs
            per = total_ms / hw["calls"] if hw["calls"] else 0.0
            lines.append(f"| host wait (batch fetch) | {total_ms:,.1f} ms "
                         f"total over {hw['calls']:,} fetches "
                         f"({per:.2f} ms/fetch) |")
        h2d = input_counters.get("input.h2d_bytes")
        if h2d:
            lines.append(f"| H2D batch transfer | "
                         f"{_fmt_bytes(h2d['bytes'])} over "
                         f"{h2d['calls']:,} device_put dispatches |")
        qd = input_counters.get("input.queue_depth")
        if qd and qd["calls"]:
            lines.append(f"| mean prefetch queue depth | "
                         f"{qd['bytes'] / qd['calls']:.2f} "
                         f"(sampled at {qd['calls']:,} pops) |")
        rep = input_counters.get("input.replicated_batches")
        if rep:
            lines.append(f"| replicated (indivisible) batches | "
                         f"{rep['calls']:,} x dp-replicated, "
                         f"{_fmt_bytes(rep['bytes'])} |")
        lines.append("")

    if ckpt_counters:
        lines.append("## Checkpointing")
        lines.append("")
        lines.append("| metric | value |")
        lines.append("|---|---|")
        stall = ckpt_counters.get("ckpt.stall_ms")
        if stall:
            total_ms = stall["bytes"] / 1000.0  # stored as integer µs
            per = total_ms / stall["calls"] if stall["calls"] else 0.0
            lines.append(f"| training stall (blocked in save) | "
                         f"{total_ms:,.1f} ms total over "
                         f"{stall['calls']:,} saves "
                         f"({per:.2f} ms/save) |")
        cb = ckpt_counters.get("ckpt.bytes")
        if cb:
            lines.append(f"| committed checkpoint bytes | "
                         f"{_fmt_bytes(cb['bytes'])} over {cb['calls']:,} "
                         f"committed tag(s) |")
        pend = ckpt_counters.get("ckpt.pending")
        if pend and pend["calls"]:
            lines.append(f"| mean async writer queue depth | "
                         f"{pend['bytes'] / pend['calls']:.2f} "
                         f"(sampled at {pend['calls']:,} saves) |")
        lines.append("")

    # serving engine counters (deepspeed_tpu/serving): requests/tokens
    # decoded, batch occupancy, KV block pressure — their own section,
    # like input.*/ckpt.*
    serve_counters = {k: v for k, v in any_comm.items()
                      if k.startswith(("serve.", "kv."))}
    if serve_counters:
        lines.append("## Serving")
        lines.append("")
        lines.append("| metric | value |")
        lines.append("|---|---|")
        reqs = serve_counters.get("serve.requests")
        if reqs:
            lines.append(f"| requests completed | {reqs['calls']:,} "
                         f"({reqs['bytes']:,} tokens generated) |")
        toks = serve_counters.get("serve.tokens")
        if toks:
            lines.append(f"| tokens decoded | {toks['calls']:,} |")
        dec = serve_counters.get("serve.decode_steps")
        if dec and dec["calls"]:
            lines.append(f"| decode steps | {dec['calls']:,} (mean batch "
                         f"occupancy {dec['bytes'] / dec['calls']:.2f} "
                         f"slots) |")
        pre = serve_counters.get("serve.prefill_chunks")
        if pre:
            lines.append(f"| prefill chunks | {pre['calls']:,} "
                         f"({pre['bytes']:,} prompt tokens) |")
        ttft = serve_counters.get("serve.ttft_ms")
        if ttft and ttft["calls"]:
            total_ms = ttft["bytes"] / 1000.0  # stored as integer µs
            lines.append(f"| mean time-to-first-token | "
                         f"{total_ms / ttft['calls']:.2f} ms over "
                         f"{ttft['calls']:,} first tokens |")
        blk = serve_counters.get("kv.blocks_in_use")
        if blk and blk["calls"]:
            lines.append(f"| mean KV blocks in use | "
                         f"{blk['bytes'] / blk['calls']:.2f} "
                         f"(sampled at {blk['calls']:,} steps) |")
        ev = serve_counters.get("kv.evictions")
        if ev:
            lines.append(f"| KV blocks force-reclaimed (evictions) | "
                         f"{ev['calls']:,} |")
        shed = serve_counters.get("serve.shed")
        if shed:
            lines.append(f"| requests shed (wedged decode) | "
                         f"{shed['calls']:,} |")
        # speculative decoding (serve.draft_tokens/accepted_tokens,
        # kv.dequant_ms) — rendered as sub-rows of the same table
        drafts = serve_counters.get("serve.draft_tokens")
        acc = serve_counters.get("serve.accepted_tokens")
        dq = serve_counters.get("kv.dequant_ms")
        if drafts or acc or dq:
            lines.append("| **Speculative decoding** | |")
            if drafts:
                rate = (f" ({acc['calls'] / drafts['calls']:.0%} accepted)"
                        if acc and drafts["calls"] else "")
                lines.append(f"| draft tokens proposed | "
                             f"{drafts['calls']:,}{rate} |")
            if acc:
                per = ""
                if dec and dec["calls"]:
                    per = (f" (+{acc['calls'] / dec['calls']:.2f} bonus "
                           f"tokens/step)")
                lines.append(f"| draft tokens accepted | "
                             f"{acc['calls']:,}{per} |")
            if dq and dq["calls"]:
                total_ms = dq["bytes"] / 1000.0  # stored as integer µs
                lines.append(f"| quantized-KV decode dispatch | "
                             f"{total_ms:,.1f} ms total over "
                             f"{dq['calls']:,} dispatches "
                             f"({total_ms / dq['calls']:.2f} ms each) |")
        # prefix caching + pinned sessions (kv.prefix_*, kv.cow_copies,
        # kv.session_pins) — sub-rows like speculative decoding
        hits = serve_counters.get("kv.prefix_hits")
        hit_tok = serve_counters.get("kv.prefix_hit_tokens")
        cow = serve_counters.get("kv.cow_copies")
        pins = serve_counters.get("kv.session_pins")
        pev = serve_counters.get("kv.prefix_evictions")
        if hits or hit_tok or cow or pins or pev:
            lines.append("| **Prefix cache** | |")
            if hits:
                lines.append(f"| prefix-hit admissions | "
                             f"{hits['calls']:,} "
                             f"({hits['bytes']:,} blocks aliased) |")
            if hit_tok:
                rate = ""
                if pre and (hit_tok["bytes"] + pre["bytes"]):
                    frac = (hit_tok["bytes"] /
                            (hit_tok["bytes"] + pre["bytes"]))
                    rate = f" ({frac:.0%} of prefill tokens)"
                lines.append(f"| prompt tokens skipped | "
                             f"{hit_tok['bytes']:,}{rate} |")
            if cow:
                lines.append(f"| copy-on-write privatizations | "
                             f"{cow['calls']:,} "
                             f"({_fmt_bytes(cow['bytes'])} copied) |")
            if pins:
                lines.append(f"| session pins | {pins['calls']:,} "
                             f"({pins['bytes']:,} blocks held) |")
            if pev:
                lines.append(f"| cached blocks reclaimed (LRU) | "
                             f"{pev['calls']:,} |")
        lines.append("")

    # fleet router counters (serving/router.py): dispatch balance,
    # queue spill-over, front-door shedding — their own section
    router_counters = {k: v for k, v in any_comm.items()
                      if k.startswith("router.")}
    if router_counters:
        lines.append("## Fleet router")
        lines.append("")
        lines.append("| metric | value |")
        lines.append("|---|---|")
        disp = router_counters.get("router.dispatches")
        if disp and disp["calls"]:
            lines.append(f"| requests dispatched | {disp['calls']:,} "
                         f"(mean load at dispatch "
                         f"{disp['bytes'] / disp['calls']:.2f} KV "
                         f"blocks) |")
        spill = router_counters.get("router.spills")
        if spill:
            lines.append(f"| queue spill-overs | {spill['calls']:,} |")
        rshed = router_counters.get("router.shed")
        if rshed:
            lines.append(f"| requests shed at front door | "
                         f"{rshed['calls']:,} |")
        lines.append("")

    # live SLO telemetry: monitor.tracing.ServingSLO windows land in
    # the event stream as type="slo" events; trace.*/slo.* counters
    # (excluded from the comm byte table above) ride along as the
    # Tracing rows
    slo_events = [e for rank in sorted(run["ranks"])
                  for e in run["ranks"][rank]
                  if e.get("type") == "slo"
                  and isinstance(e.get("slo"), dict)]
    trace_counters = {k: v for k, v in any_comm.items()
                      if k.startswith(("trace.", "slo."))}
    if slo_events or trace_counters:
        lines.append("## Serving SLO")
        lines.append("")
        lines.append("| metric | value |")
        lines.append("|---|---|")
        if slo_events:
            last = slo_events[-1]["slo"]
            ttft = last.get("ttft_ms") or {}
            p99s = [(e["slo"].get("ttft_ms") or {}).get("p99")
                    for e in slo_events]
            p99s = [p for p in p99s if p is not None]
            lines.append(f"| SLO windows emitted | {len(slo_events):,} "
                         f"({last.get('window_s', '?')} s sliding) |")
            lines.append(f"| last window: requests | "
                         f"{last.get('requests', 0):,} |")
            if ttft.get("p50") is not None:
                lines.append(f"| last window: TTFT p50/p99 | "
                             f"{_fmt(ttft.get('p50'))} / "
                             f"{_fmt(ttft.get('p99'))} ms "
                             f"(n={ttft.get('n', 0)}) |")
            if last.get("tok_per_s") is not None:
                lines.append(f"| last window: decode throughput | "
                             f"{_fmt(last['tok_per_s'])} tokens/s |")
            if last.get("queue_depth_mean") is not None:
                lines.append(f"| last window: mean admission queue "
                             f"depth | {_fmt(last['queue_depth_mean'])} |")
            if last.get("accept_rate") is not None:
                lines.append(f"| last window: draft accept rate | "
                             f"{100.0 * last['accept_rate']:.1f}% "
                             f"({last.get('drafted', 0):,} drafted) |")
            if last.get("shed"):
                lines.append(f"| last window: requests shed | "
                             f"{last['shed']:,} |")
            if p99s:
                lines.append(f"| worst window TTFT p99 | "
                             f"{_fmt(max(p99s))} ms |")
        if trace_counters:
            lines.append("| **Tracing** | |")
            tev = trace_counters.get("trace.events")
            if tev:
                lines.append(f"| trace events recorded | {tev['calls']:,} "
                             f"({_fmt_bytes(tev['bytes'])} JSONL) |")
            tdr = trace_counters.get("trace.dropped")
            if tdr:
                lines.append(f"| trace events dropped (byte cap) | "
                             f"{tdr['calls']:,} |")
            wnd = trace_counters.get("slo.windows")
            if wnd:
                lines.append(f"| SLO windows aggregated | "
                             f"{wnd['calls']:,} |")
        lines.append("")

    # serving-bench lane table (serving.json from tools/serve_bench.py)
    sv = run.get("serving")
    if sv and sv.get("lanes"):
        lines.append("## Serving bench (continuous batching)")
        lines.append("")
        m = sv.get("model") or {}
        if m:
            lines.append(f"model: {m.get('layers', '?')}L x "
                         f"d{m.get('d_model', '?')} x "
                         f"{m.get('heads', '?')}h, vocab "
                         f"{m.get('vocab', '?')} · "
                         f"{sv.get('n_requests', '?')} requests, Poisson "
                         f"{sv.get('rate_hz', '?')}/s")
            lines.append("")
        lines.append("| lane | done | tokens | tokens/s | TTFT p50/p99 ms "
                     "| ITL p50/p99 ms | KV blocks mean/peak | shed |")
        lines.append("|---|---|---|---|---|---|---|---|")
        for name in sorted(sv["lanes"]):
            lane = sv["lanes"][name]
            if "requests" not in lane:
                continue  # session lanes render below, not as ?/? rows
            ttft_l, itl = lane.get("ttft_ms", {}), lane.get("itl_ms", {})
            kvb = lane.get("kv_blocks", {})
            lines.append(
                f"| {name} | {lane.get('completed', '?')}/"
                f"{lane.get('requests', '?')} | "
                f"{_fmt(lane.get('tokens'), 0)} | "
                f"{_fmt(lane.get('tokens_per_sec'))} | "
                f"{_fmt(ttft_l.get('p50'))} / {_fmt(ttft_l.get('p99'))} | "
                f"{_fmt(itl.get('p50'))} / {_fmt(itl.get('p99'))} | "
                f"{_fmt(kvb.get('mean'))} / {_fmt(kvb.get('peak'), 0)} "
                f"(cap {_fmt(kvb.get('capacity'), 0)}) | "
                f"{lane.get('shed', 0)} |")
        spec_lanes = {n: l for n, l in sv["lanes"].items()
                      if l.get("accepted_per_step") is not None}
        if spec_lanes:
            lines.append("")
            lines.append("Speculative decoding lanes (extra accepted "
                         "draft tokens per decode step):")
            for name in sorted(spec_lanes):
                lane = spec_lanes[name]
                lines.append(f"- {name}: "
                             f"+{lane['accepted_per_step']:.2f} tok/step "
                             f"(kv {lane.get('kv_dtype', 'dense')}, "
                             f"draft {lane.get('draft_len', 0)})")
        pfx_lanes = {n: l for n, l in sv["lanes"].items()
                     if l.get("prefix_hit_rate") is not None
                     and "requests" in l}
        if any(l["prefix_hit_rate"] > 0 for l in pfx_lanes.values()):
            lines.append("")
            lines.append("Prefix-cache lanes (fraction of prompt tokens "
                         "served from cache):")
            for name in sorted(pfx_lanes):
                lane = pfx_lanes[name]
                per = lane.get("dispatch_per_replica")
                lines.append(
                    f"- {name}: {lane['prefix_hit_rate']:.1%} hit rate"
                    + (f", dispatches/replica {per}" if per else ""))
        ses_lanes = {n: l for n, l in sv["lanes"].items()
                     if "turn2plus_ttft_ms" in l}
        if ses_lanes:
            lines.append("")
            lines.append("Session lanes (multi-turn; TTFT on turns >= 2):")
            for name in sorted(ses_lanes):
                lane = ses_lanes[name]
                t = lane["turn2plus_ttft_ms"]
                lines.append(
                    f"- {name}: TTFT p50 {_fmt(t.get('p50'))} ms, "
                    f"prefill tokens computed "
                    f"{_fmt(lane.get('prefill_tokens_computed'), 0)}, "
                    f"served from cache "
                    f"{_fmt(lane.get('prefix_hit_tokens'), 0)}")
        cont = sv["lanes"].get("continuous")
        stat = sv["lanes"].get("static")
        if cont and stat and cont.get("tokens_per_sec") and \
                stat.get("tokens_per_sec"):
            lines.append("")
            lines.append(
                f"continuous vs static batching: "
                f"{cont['tokens_per_sec'] / stat['tokens_per_sec']:.2f}x "
                f"tokens/s at p99 TTFT "
                f"{_fmt(cont.get('ttft_ms', {}).get('p99'))} vs "
                f"{_fmt(stat.get('ttft_ms', {}).get('p99'))} ms")
        lines.append("")

    # resilience: fault injection + transient-retry + watchdog activity
    # (runtime/resilience.py) — a run that absorbed faults should say
    # so in its report, not hide it in the counter soup
    res_rows = []
    inj = any_comm.get("fault.injected")
    if inj:
        res_rows.append(f"| faults injected | {inj['calls']:,} |")
    ret = any_comm.get("fault.retried")
    if ret:
        res_rows.append(f"| transient retries | {ret['calls']:,} |")
    rec = any_comm.get("fault.recovered_ms")
    if rec:
        total_ms = rec["bytes"] / 1000.0  # stored as integer µs
        res_rows.append(f"| time to recover (retry backoff, wall) | "
                        f"{total_ms:,.1f} ms over {rec['calls']:,} "
                        f"recovered op(s) |")
    trips = any_comm.get("watchdog.trips")
    if trips:
        res_rows.append(f"| watchdog trips | {trips['calls']:,} |")
    resp = any_comm.get("input.worker_respawns")
    if resp:
        res_rows.append(f"| prefetch workers respawned | "
                        f"{resp['calls']:,} |")
    skip = any_comm.get("ckpt.skipped_tags")
    if skip:
        res_rows.append(f"| uncommitted checkpoint tags skipped | "
                        f"{skip['calls']:,} |")
    # overlap-exchange self-healing (runtime/comm/overlap.py): healed
    # connection drops, replayed frames, and coordinated demotions to
    # the serial wire — `exchange.resends` bytes are replayed payload
    recon = any_comm.get("exchange.reconnects")
    if recon:
        res_rows.append(f"| exchange connections healed (reconnects) | "
                        f"{recon['calls']:,} |")
    rsnd = any_comm.get("exchange.resends")
    if rsnd:
        res_rows.append(f"| exchange frames resent after reconnect | "
                        f"{rsnd['calls']:,} ({rsnd['bytes']:,} B "
                        f"replayed) |")
    dem = any_comm.get("exchange.demotions")
    if dem:
        res_rows.append(f"| overlap wire demotions to the serial path | "
                        f"{dem['calls']:,} |")
    # elastic world-size transitions consumed on restore
    # (engine._log_checkpoint_reshard; the supervisor side renders in
    # the "Elastic transitions" ledger block below)
    shr = any_comm.get("elastic.shrinks")
    if shr:
        res_rows.append(f"| elastic shrinks (resumed at a smaller dp) | "
                        f"{shr['calls']:,} |")
    reg = any_comm.get("elastic.regrows")
    if reg:
        res_rows.append(f"| elastic regrows (resumed at a larger dp) | "
                        f"{reg['calls']:,} |")
    wd = run.get("watchdog_trip")
    if wd:
        res_rows.append(f"| last watchdog trip | rank "
                        f"{wd.get('rank', '?')}: "
                        f"{wd.get('reason', '?')} (snapshot: "
                        f"`{wd.get('snapshot', '—')}`) |")
    if res_rows:
        lines.append("## Resilience")
        lines.append("")
        lines.append("| metric | value |")
        lines.append("|---|---|")
        lines.extend(res_rows)
        lines.append("")

    # supervisor restart ledger (elasticity/supervisor.py restarts.jsonl)
    restarts = run.get("restarts") or []
    if restarts:
        lines.append("## Restarts (supervisor ledger)")
        lines.append("")
        lines.append("| # | event | reason | ran for | exit | "
                     "dead ranks | backoff | diagnostics |")
        lines.append("|---|---|---|---|---|---|---|---|")
        for i, r in enumerate(restarts):
            dead = ",".join(str(d) for d in (r.get("dead_ranks") or [])) \
                or "—"
            backoff = (f"{r['backoff_s']:.1f}s"
                       if r.get("backoff_s") is not None else "—")
            diag = f"`{r['diagnostics']}`" if r.get("diagnostics") else "—"
            lines.append(
                f"| {i + 1} | {r.get('event', 'restart')} | "
                f"{r.get('reason', '?')} | "
                f"{_fmt(r.get('ran_for_s'), 1, 's')} | "
                f"{r.get('exit_code', '—')} | {dead} | {backoff} | "
                f"{diag} |")
        lines.append("")

    # elastic world-size transitions out of the same ledger
    # (supervisor --elastic-shrink: relaunch on the survivors, grow
    # back when capacity returns) — their own block beside Restarts so
    # the shrink->grow story reads without grepping reasons
    transitions = [r for r in restarts
                   if r.get("transition") in ("shrink", "regrow")
                   or (r.get("from_world") is not None
                       and r.get("to_world") is not None
                       and r["from_world"] != r["to_world"])]
    if transitions:
        lines.append("## Elastic transitions")
        lines.append("")
        lines.append("| # | transition | world | dead ranks | "
                     "incarnation | reason | resharding |")
        lines.append("|---|---|---|---|---|---|---|")
        for i, r in enumerate(transitions):
            f_w, t_w = r.get("from_world"), r.get("to_world")
            kind = r.get("transition") or (
                "shrink" if (f_w or 0) > (t_w or 0) else "regrow")
            dead = ",".join(str(d) for d in (r.get("dead_ranks") or [])) \
                or "—"
            lines.append(
                f"| {i + 1} | {kind} | {f_w if f_w is not None else '?'} "
                f"→ {t_w if t_w is not None else '?'} | {dead} | "
                f"{r.get('incarnation', '—')} | {r.get('reason', '?')} | "
                f"ZeRO state re-partitions dp {f_w}→{t_w} on restore |")
        lines.append("")

    # hierarchical gradient wire: the per-level (fast/slow fabric) byte
    # split the two-level plan exists to produce — surfaced as its own
    # section so the slow-fabric saving is legible without arithmetic
    intra = any_comm.get("grad_wire.intra")
    inter = any_comm.get("grad_wire.inter")
    exposed = any_comm.get("grad_wire.exposed_ms")
    hits = any_comm.get("qwz.prefetch_hits")
    if (intra or inter) and not (exposed or hits):
        lines.append("## Gradient wire levels (hierarchical reduction)")
    elif intra or inter or exposed or hits:
        lines.append("## Gradient wire levels")
        if not (intra or inter):
            lines.append("")
    if intra or inter:
        lines.append("")
        lines.append("| level | fabric | collectives | wire bytes | "
                     "logical payload |")
        lines.append("|---|---|---|---|---|")

        def _logical(name):
            d = any_comm.get(name)
            # wire bytes include inner/block padding; the logical twin
            # prices the same wire pad-free (absent on pre-quant runs)
            return _fmt_bytes(d["bytes"]) if d else "—"

        if intra:
            lines.append(f"| intra-group | fast (ICI/intra-process) | "
                         f"{intra['calls']:,} | "
                         f"{_fmt_bytes(intra['bytes'])} | "
                         f"{_logical('grad_wire.intra_logical')} |")
        if inter:
            lines.append(f"| inter-group | slow (DCN/TCP) | "
                         f"{inter['calls']:,} | "
                         f"{_fmt_bytes(inter['bytes'])} | "
                         f"{_logical('grad_wire.inter_logical')} |")
        if intra and inter and inter["bytes"]:
            lines.append("")
            lines.append(f"slow-fabric share of grad-wire traffic: "
                         f"{100.0 * inter['bytes'] / (intra['bytes'] + inter['bytes']):.1f}%")
        lines.append("")

    if exposed:
        # µs stored in the bytes slot (the ckpt.stall_ms convention):
        # host time blocked on the overlapped wire AFTER the backward —
        # the non-hidden remainder comm.overlap exists to shrink
        total_ms = exposed["bytes"] / 1000.0
        per = total_ms / exposed["calls"] if exposed["calls"] else 0.0
        lines.append(f"exposed (non-overlapped) wire time: "
                     f"{total_ms:,.1f} ms over {exposed['calls']:,} "
                     f"step drain(s) ({per:.2f} ms/step)")
        lines.append("")
    if hits:
        head_ms = hits["bytes"] / 1000.0
        lines.append(f"qwZ prefetch hits: {hits['calls']:,} gather(s) "
                     f"ready before the forward asked "
                     f"({head_ms:,.1f} ms total head start)")
        lines.append("")

    # MoE wire (moe/dispatch.py): the expert all-to-all's byte/fabric
    # split, capacity discipline and exposed time — its own section,
    # like the gradient-wire levels (moe.* is excluded from the comm
    # byte table above)
    moe_counters = {k: v for k, v in any_comm.items()
                    if k.startswith("moe.")}
    if moe_counters:
        lines.append("## MoE wire (expert all-to-all)")
        lines.append("")
        lines.append("| metric | value |")
        lines.append("|---|---|")
        a2a = moe_counters.get("moe.a2a_bytes")
        if a2a:
            lines.append(f"| a2a wire bytes (all local ranks) | "
                         f"{_fmt_bytes(a2a['bytes'])} over "
                         f"{a2a['calls']:,} hop(s) |")
        inter = moe_counters.get("moe.a2a_inter")
        if inter and a2a and a2a["bytes"]:
            lines.append(f"| slow-fabric (inter-group) share | "
                         f"{_fmt_bytes(inter['bytes'])} "
                         f"({100.0 * inter['bytes'] / a2a['bytes']:.1f}%) |")
        elif a2a:
            # zero either because inner placement pinned the exchange
            # to data_inner or because the mesh is flat (one fabric)
            lines.append("| slow-fabric (inter-group) share | 0 B "
                         "(no data_outer hop: flat mesh or inner "
                         "placement) |")
        exp = moe_counters.get("moe.a2a_exposed_ms")
        if exp and exp["calls"]:
            total_ms = exp["bytes"] / 1000.0  # stored as integer µs
            lines.append(f"| exposed a2a time | {total_ms:,.1f} ms over "
                         f"{exp['calls']:,} step(s) "
                         f"({total_ms / exp['calls']:.2f} ms/step) |")
        drop = moe_counters.get("moe.dropped_tokens")
        if drop:
            lines.append(f"| tokens dropped at capacity | "
                         f"{drop['bytes']:,} over {drop['calls']:,} "
                         f"dispatch(es) |")
        frac = moe_counters.get("moe.capacity_frac")
        if frac and frac["calls"]:
            # ppm-in-bytes: mean utilisation % = bytes / calls / 1e4
            lines.append(f"| mean expert-bucket utilisation | "
                         f"{frac['bytes'] / frac['calls'] / 1e4:.1f}% "
                         f"(sampled at {frac['calls']:,} dispatches) |")
        lines.append("")

    # the self-tuning runtime (runtime/autotune/): probe/swap counters
    # + the rank-0 search/retune ledger — its own section, excluded
    # from the comm byte table like the other bookkeeping counters
    at_counters = {k: v for k, v in any_comm.items()
                   if k.startswith("autotune.")}
    at_ledger = run.get("autotune") or []
    if at_counters or at_ledger:
        lines.append("## Autotune")
        lines.append("")
        if at_counters:
            lines.append("| metric | value |")
            lines.append("|---|---|")
            probes = at_counters.get("autotune.probes")
            if probes:
                total_ms = probes["bytes"] / 1000.0  # µs in the bytes slot
                lines.append(f"| candidate probes | {probes['calls']:,} "
                             f"({total_ms:,.1f} ms probing) |")
            hits = at_counters.get("autotune.cache_hits")
            if hits:
                lines.append(f"| winner-cache hits (zero probes) | "
                             f"{hits['calls']:,} |")
            rej = at_counters.get("autotune.rejected")
            if rej:
                lines.append(f"| candidates pruned by config validators | "
                             f"{rej['calls']:,} |")
            ret = at_counters.get("autotune.retunes")
            if ret:
                lines.append(f"| online retunes (sustained regression) | "
                             f"{ret['calls']:,} |")
            swaps = at_counters.get("autotune.swaps")
            if swaps:
                lines.append(f"| live config swaps applied | "
                             f"{swaps['calls']:,} |")
            lines.append("")
        events = [e for e in at_ledger
                  if e.get("event") in ("search", "cache_hit", "retune",
                                        "swap")]
        if events:
            lines.append("| # | event | step | detail |")
            lines.append("|---|---|---|---|")
            for i, e in enumerate(events):
                ev = e.get("event")
                if ev == "swap":
                    detail = (f"-> `{e.get('candidate', '?')}` "
                              f"({e.get('reason', '?')})")
                elif ev == "retune":
                    detail = (f"{e.get('reason', '?')}; "
                              f"{e.get('probes', 0)} probe(s), "
                              + ("swapped to "
                                 f"`{e.get('winner', '?')}`"
                                 if e.get("swapped")
                                 else "incumbent stands"))
                elif ev == "cache_hit":
                    detail = (f"`{e.get('candidate', '?')}` (fingerprint "
                              f"{e.get('fingerprint', '?')})")
                else:
                    detail = (f"{e.get('probes', 0)} probe(s), baseline "
                              f"{_fmt(e.get('baseline_ms'))} ms/step")
                lines.append(f"| {i + 1} | {ev} | {e.get('step', '—')} | "
                             f"{detail} |")
            lines.append("")

    # the Pallas kernel registry (deepspeed_tpu/kernels): trace-time
    # dispatch resolutions — how often a hot loop ran its Pallas path
    # vs its jnp oracle fallback (kernel.* is excluded from the comm
    # byte table above)
    kern_counters = {k: v for k, v in any_comm.items()
                     if k.startswith("kernel.")}
    if kern_counters:
        lines.append("## Kernels")
        lines.append("")
        lines.append("| metric | value |")
        lines.append("|---|---|")
        disp = kern_counters.get("kernel.dispatches")
        if disp:
            lines.append(f"| Pallas kernel dispatches (trace-time) | "
                         f"{disp['calls']:,} |")
        falls = kern_counters.get("kernel.fallbacks")
        if falls:
            lines.append(f"| jnp oracle fallbacks (trace-time) | "
                         f"{falls['calls']:,} |")
        lines.append("")

    qwz = any_comm.get("qwz.gather")
    if qwz:
        lines.append("## qwZ quantized parameter gather (ZeRO-3)")
        lines.append("")
        lines.append(f"Stage-3 parameters gathered as quantized blocks + "
                     f"fp16 scales: {_fmt_bytes(qwz['bytes'])} over "
                     f"{qwz['calls']:,} collectives (master weights stay "
                     f"full precision).")
        lines.append("")

    pipe = next((s["pipe"] for s in summaries.values() if s["pipe"]), None)
    if pipe and pipe.get("occupancy"):
        lines.append("## Pipeline occupancy (schedule ticks)")
        lines.append("")
        lines.append("| stage | ticks | compute ticks | bubble |")
        lines.append("|---|---|---|---|")
        for st in pipe["occupancy"]:
            lines.append(f"| {st['stage']} | {st['ticks']} | "
                         f"{st['compute_ticks']} | "
                         f"{100.0 * st['bubble_frac']:.1f}% |")
        lines.append("")

    spans = {}
    for s in summaries.values():
        for name, ms in s["spans_ms_total"].items():
            spans[name] = spans.get(name, 0.0) + ms
    if spans:
        lines.append("## Wall-time by span (all ranks, whole run)")
        lines.append("")
        lines.append("| span | total ms |")
        lines.append("|---|---|")
        for name in sorted(spans, key=lambda k: -spans[k]):
            lines.append(f"| `{name}` | {spans[name]:,.1f} |")
        lines.append("")

    stragglers = sorted({r for s in summaries.values()
                         for r in s["stragglers"]})
    if stragglers:
        lines.append(f"**Stragglers flagged:** ranks {stragglers}")
        lines.append("")
    return "\n".join(lines)

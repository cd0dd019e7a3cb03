"""Port parity: trace and SLO telemetry (deepspeed_tpu_torch/monitor/
tracing.py, the serving engine's spans) against the JAX package's
monitor/tracing.py and serving engine.

* The recorder's file is the JAX format: JAX's `read_trace_file` and
  `tools/trace_report.py` read a port trace unchanged.
* Sampling decisions, nearest-rank percentiles and `ServingSLO`
  snapshots are compared for equality (`==` on floats: bit for bit —
  both sides run the same Python arithmetic on the same inputs).
* A traced port engine and a traced JAX engine on the same traffic,
  seed and `sample_rate` 0.5 write the same `(ph, name, cat, args)`
  sequence once the times (`ts`, `dur`, `ttft_ms`) are removed; the
  engines are a tiny fp32 GPT (2 layers, 4 heads, d32, vocab 64) on
  shared weights, with one JAX program pair for this module, and their
  greedy tokens are compared exactly, as tests/test_torch_serving.py
  holds them.
* Tracing never changes what is served: a traced and an untraced port
  engine give the same tokens and the same paged-attention dispatches.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deepspeed_tpu import serving as jserving  # noqa: E402
from deepspeed_tpu.models import GPT as JaxGPT  # noqa: E402
from deepspeed_tpu.models import gpt2_config as jax_gpt2_config  # noqa: E402
from deepspeed_tpu.monitor import tracing as jtracing  # noqa: E402
from deepspeed_tpu_torch import serving  # noqa: E402
from deepspeed_tpu_torch.models import GPT, gpt2_config  # noqa: E402
from deepspeed_tpu_torch.models import load_jax_params  # noqa: E402
from deepspeed_tpu_torch.monitor import tracing  # noqa: E402
from deepspeed_tpu_torch.monitor.counters import COUNTERS  # noqa: E402
from deepspeed_tpu_torch.runtime.resilience import StepWatchdog  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, MAX_SEQ, BS = 64, 64, 4
MODEL = dict(num_layers=2, num_heads=4, d_model=32, vocab_size=VOCAB,
             max_seq_len=MAX_SEQ)
SERVE = dict(block_size=BS, num_blocks=40, max_batch=4, prefill_chunk=8,
             max_seq_len=MAX_SEQ)


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxGPT(jax_gpt2_config("nano", **MODEL))
    jparams = jmodel.init(jax.random.PRNGKey(1))
    model = GPT(gpt2_config("nano", **MODEL), device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, jparams))
    sched = jserving.ServeSchedule(
        max_batch=SERVE["max_batch"], prefill_chunk=SERVE["prefill_chunk"],
        block_size=BS, num_blocks=SERVE["num_blocks"],
        table_width=MAX_SEQ // BS)
    progs = jserving.ServeProgramBuilder(jmodel, sched).build()
    return jmodel, jparams, progs, model


def _flush_threads():
    return [t for t in threading.enumerate()
            if t.name == "dstpu-trace-flush" and t.is_alive()]


def _trace(d, rank=0):
    return os.path.join(str(d), f"{tracing.TRACE_FILE_PREFIX}{rank:05d}.jsonl")


# -- the recorder ------------------------------------------------------------


def test_recorder_file_read_by_jax(tmp_path):
    """Spans, instants and a back-dated span, written by the port and
    read by JAX's reader; the footer counts them; close() joins the
    writer thread and is idempotent."""
    rec = tracing.TraceRecorder(str(tmp_path), rank=3, flush_interval_s=10)
    with rec.span("prefill_chunk", "serve", rid=1):
        pass
    rec.instant("first_token", "serve", rid=1)
    rec.add_complete("queue_wait", "serve", dur_us=1500, rid=0)
    rec.close()
    rec.close()
    assert not _flush_threads()
    segments, summary = jtracing.read_trace_file(_trace(tmp_path, 3))
    (meta, events), = segments
    assert meta["type"] == "trace_meta" and meta["rank"] == 3
    assert meta["v"] == jtracing.TRACE_SCHEMA_VERSION
    assert set(meta) == {"type", "v", "rank", "world", "sync_mono_us",
                         "sync_wall", "skew_est_s", "sample_rate", "seed"}
    assert [(e["ph"], e["name"]) for e in events] == [
        ("X", "prefill_chunk"), ("i", "first_token"), ("X", "queue_wait")]
    assert events[2]["dur"] == 1500
    assert summary == {"type": "trace_summary", "rank": 3, "events": 3,
                       "dropped": 0, "bytes": summary["bytes"]}
    assert tracing.read_trace_file(_trace(tmp_path, 3)) == (segments,
                                                            summary)


def test_recorder_byte_cap_drops_and_counts(tmp_path):
    snap = COUNTERS.snapshot()
    rec = tracing.TraceRecorder(str(tmp_path), max_file_bytes=4096,
                                flush_interval_s=10)
    for i in range(500):
        rec.instant("beat", "watchdog", i=i, pad="x" * 64)
    rec.close()
    segments, summary = jtracing.read_trace_file(_trace(tmp_path))
    assert summary["events"] == 500 and summary["dropped"] > 0
    assert len(segments[0][1]) == 500 - summary["dropped"]
    assert os.path.getsize(_trace(tmp_path)) < 4096 + 1024
    d = COUNTERS.delta_since(snap)
    assert d["trace.dropped"]["calls"] == summary["dropped"]
    assert d["trace.events"]["calls"] == 500 - summary["dropped"]


def test_recorder_segments_and_ring(tmp_path):
    """A second recorder on the same directory appends a segment; the
    flight recorder keeps the newest events."""
    for run in range(2):
        rec = tracing.TraceRecorder(str(tmp_path), buffer_events=16,
                                    flush_interval_s=10)
        for i in range(40):
            rec.instant("start", "serve", run=run, i=i)
        tail = rec.last_events()
        assert len(tail) == 16 and tail[-1]["args"]["i"] == 39
        assert rec.last_events(4)[0]["args"]["i"] == 36
        rec.close()
    segments, summary = jtracing.read_trace_file(_trace(tmp_path))
    assert [seg[1][0]["args"]["run"] for seg in segments] == [0, 1]
    assert summary["events"] == 40


@pytest.mark.parametrize("seed,rate", [(0, 0.5), (11, 0.4), (999983, 0.1),
                                       (7, 1.0)])
def test_sampling_decisions_match_jax(tmp_path, seed, rate):
    """`sampled(key)` on the port's recorder decides as JAX's does for
    step and request keys (crc32 of "seed:key")."""
    port = tracing.TraceRecorder(str(tmp_path / "p"), sample_rate=rate,
                                 seed=seed, flush_interval_s=10)
    ref = jtracing.TraceRecorder(str(tmp_path / "j"), sample_rate=rate,
                                 seed=seed, flush_interval_s=10)
    try:
        keys = list(range(200)) + [f"rid:{i}" for i in range(200)] + \
            [f"step:{i}" for i in range(200)]
        got = [port.sampled(k) for k in keys]
        assert got == [ref.sampled(k) for k in keys]
        assert [tracing._sample_hash(seed, k) for k in keys] == \
            [jtracing._sample_hash(seed, k) for k in keys]
        if rate < 1.0:
            assert 0 < sum(got) < len(keys)
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("n", [1, 2, 7, 37, 100])
def test_nearest_rank_percentiles_match_jax(n):
    xs = sorted(np.random.RandomState(n).gamma(2.0, 10.0, size=n).tolist())
    for q in (0, 1, 50, 90, 99, 100):
        assert tracing.percentile_nearest_rank(xs, q) == \
            jtracing.percentile_nearest_rank(xs, q)
    assert tracing.percentile_nearest_rank([], 50) == 0.0


def _slo_stream(seed, n=300):
    """(time, kind, values) observations, times increasing."""
    rs = np.random.RandomState(seed)
    t = 100.0
    out = []
    for _ in range(n):
        t += float(rs.exponential(0.05))
        kind = rs.choice(["ttft", "tokens", "queue", "accept", "shed"])
        if kind == "ttft":
            out.append((t, kind, (float(rs.gamma(2.0, 0.05)),)))
        elif kind == "tokens":
            out.append((t, kind, (int(rs.randint(0, 9)),)))
        elif kind == "queue":
            out.append((t, kind, (int(rs.randint(0, 5)),)))
        elif kind == "accept":
            d = int(rs.randint(0, 9))
            out.append((t, kind, (int(rs.randint(0, d + 1)), d)))
        else:
            out.append((t, kind, (int(rs.randint(1, 3)),)))
    return out


@pytest.mark.parametrize("seed,window,interval", [(0, 10.0, 2.0),
                                                  (1, 1.0, 0.25),
                                                  (2, 600.0, 1e-6)])
def test_slo_snapshots_bitwise_equal_to_jax(seed, window, interval):
    """The same observation stream at explicit times: every tick's
    emitted window, every snapshot and the forced tail are equal to
    JAX's, float for float."""
    emitted = {"p": [], "j": []}
    port = tracing.ServingSLO(emit=emitted["p"].append, window_s=window,
                              emit_interval_s=interval, clock=lambda: 0.0)
    ref = jtracing.ServingSLO(emit=emitted["j"].append, window_s=window,
                              emit_interval_s=interval, clock=lambda: 0.0)
    snaps = {"p": [], "j": []}
    for i, (t, kind, vals) in enumerate(_slo_stream(seed)):
        for key, slo in (("p", port), ("j", ref)):
            {"ttft": slo.observe_ttft, "tokens": slo.observe_tokens,
             "queue": slo.observe_queue_depth, "accept": slo.observe_accept,
             "shed": slo.observe_shed}[kind](*vals, t=t)
            slo.tick(t)
            if i % 25 == 0:
                snaps[key].append(slo.snapshot(t))
    end = t + window / 2
    assert port.force(end) == ref.force(end)
    assert snaps["p"] == snaps["j"]
    assert emitted["p"] == emitted["j"] and emitted["p"]
    assert port.windows_emitted == ref.windows_emitted
    with pytest.raises(ValueError):
        tracing.ServingSLO(window_s=0.0)


# -- the serving engine's timeline -------------------------------------------


def _traffic(seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, VOCAB, (int(n),)).tolist()
            for n in (5, 9, 3, 14, 6, 11)]


def _events(path):
    (meta, events), = jtracing.read_trace_file(path)[0]
    return [(e["ph"], e["name"], e["cat"],
             {k: v for k, v in e.get("args", {}).items() if k != "ttft_ms"})
            for e in events]


def _serve_traced(engine, tracer, prompts, n_new=6):
    engine.attach_tracing(tracer=tracer)
    reqs = [engine.submit(p, n_new) for p in prompts[:3]]
    for _ in range(3):
        engine.step()
    reqs += [engine.submit(p, n_new, session_id="s" if i == 0 else None)
             for i, p in enumerate(prompts[3:])]
    engine.run()
    # a session's second turn: its admission carries cached tokens
    r = reqs[3]
    reqs.append(engine.submit(r.prompt + r.out + [1, 2, 3], 4,
                              session_id="s"))
    engine.run()
    tracer.close()
    return [x.out for x in reqs]


@pytest.mark.parametrize("rate", [0.5, 1.0])
def test_engine_trace_matches_jax(pair, tmp_path, rate):
    """Same traffic, same seed and rate: the port's engine writes JAX's
    event sequence, and serves JAX's tokens."""
    jmodel, jparams, progs, model = pair
    prompts = _traffic()
    jeng = jserving.ServeEngine(jmodel, jparams,
                                jserving.ServeConfig(**SERVE),
                                programs=progs)
    jtoks = _serve_traced(jeng, jtracing.TraceRecorder(
        str(tmp_path / "j"), sample_rate=rate, seed=3, flush_interval_s=10),
        prompts)
    eng = serving.ServeEngine(model, serving.ServeConfig(**SERVE),
                              device="cpu")
    toks = _serve_traced(eng, tracing.TraceRecorder(
        str(tmp_path / "p"), sample_rate=rate, seed=3, flush_interval_s=10),
        prompts)
    assert toks == jtoks
    got, want = _events(_trace(tmp_path / "p")), _events(_trace(tmp_path / "j"))
    assert got == want
    names = [e[1] for e in got]
    for needed in ("queue_wait", "prefill_chunk", "first_token",
                   "decode_step", "finish"):
        assert needed in names
    if rate < 1.0:
        assert names.count("finish") < len(toks)
    else:
        assert names.count("first_token") == len(toks)


def test_tracing_changes_nothing_served(pair, tmp_path):
    """A traced engine and an untraced one: the same tokens, the same
    registry dispatches of the paged attention, and per decode step
    one span; the SLO sees every request unsampled."""
    model = pair[3]
    prompts = _traffic(4)

    def serve(tracer=None, slo=None):
        eng = serving.ServeEngine(model, serving.ServeConfig(**SERVE),
                                  device="cpu")
        if tracer is not None:
            eng.attach_tracing(tracer=tracer, slo=slo)
        snap = COUNTERS.snapshot()
        out = eng.generate(prompts, 6)
        d = COUNTERS.delta_since(snap)
        return out, d["kernel.fallbacks"]["calls"], \
            d["serve.decode_steps"]["calls"]

    plain = serve()
    rec = tracing.TraceRecorder(str(tmp_path), sample_rate=1.0,
                                flush_interval_s=10)
    slo = tracing.ServingSLO(window_s=600.0, emit_interval_s=600.0)
    traced = serve(rec, slo)
    rec.close()
    assert traced == plain
    names = [e[1] for e in _events(_trace(tmp_path))]
    assert names.count("decode_step") == plain[2]
    assert names.count("first_token") == len(prompts)
    assert slo.snapshot()["requests"] == len(prompts)


def test_trace_report_merges_a_port_trace(pair, tmp_path):
    """JAX's tools/trace_report.py merges a port serving trace unchanged:
    one pid, the serve lane, every event."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import trace_report
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    eng = serving.ServeEngine(pair[3], serving.ServeConfig(**SERVE),
                              device="cpu")
    rec = tracing.TraceRecorder(str(tmp_path / "run"), flush_interval_s=10)
    _serve_traced(eng, rec, _traffic(2))
    events = []
    min_ts, stats = trace_report.merge_dir(str(tmp_path / "run"),
                                           events=events)
    n = len(_events(_trace(tmp_path / "run")))
    assert sum(1 for e in events if e["ph"] != "M") == n
    merged = trace_report.merge_runs([str(tmp_path / "run")])
    evs = [e for e in merged["traceEvents"] if e["ph"] != "M"]
    assert len(evs) == n and min(e["ts"] for e in evs) == 0
    assert {e["pid"] for e in evs} == {0}
    assert {e["tid"] for e in evs} == {tracing.TRACE_CATEGORIES.index(
        "serve")}
    json.loads(json.dumps(merged))


def test_watchdog_snapshot_ships_the_trace_tail(tmp_path):
    rec = tracing.TraceRecorder(str(tmp_path), buffer_events=32,
                                flush_interval_s=10)
    for i in range(5):
        rec.instant("decode_step", "serve", step=i)
    run_dir = str(tmp_path / "wd")
    wd = StepWatchdog(600.0, run_dir, rank=0)
    try:
        wd.set_flight_recorder(rec.last_events)
        wd.trip(1.0, step=5)
        with open(os.path.join(
                run_dir, "watchdog_snapshot.rank00000.1.json")) as f:
            snap = json.load(f)
        assert [e["args"]["step"] for e in snap["trace_tail"]] == \
            list(range(5))
        # a raising provider is reported, never propagated
        wd.beat(6)
        wd.set_flight_recorder(lambda: 1 / 0)
        wd.trip(1.0, step=6)
        with open(os.path.join(
                run_dir, "watchdog_snapshot.rank00000.2.json")) as f:
            snap2 = json.load(f)
        assert snap2["trace_tail"] == [
            {"error": "ZeroDivisionError: division by zero"}]
    finally:
        wd.stop()
        rec.close()

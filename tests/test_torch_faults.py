"""Port parity: the chaos runtime (deepspeed_tpu_torch/runtime/
resilience.py) and the serving engine's fault sites and shed-on-trip,
against the JAX package's runtime/resilience.py and serving engine.

* A FaultPlan with `calls`, `every`, `prob`, `steps` and `rank` rules
  gives the same `injection_log` as JAX's over the same site sequence
  (exact: both draw each rule's coin from `random.Random(seed *
  1_000_003 + rule index)`).
* The serving engine fires its `serve.*` sites in JAX's order: one plan
  over the same traffic logs the same injections on both (a tiny fp32
  GPT on shared weights, one JAX program pair for this module; greedy
  tokens compared exactly).
* The chaos scenario (JAX's tools/serve_bench.py `run_dry_chaos`): a
  hang at the third decode call trips a 0.5 s watchdog whose on_trip
  sheds the wedged batch; the waiting requests finish with the tokens
  they get alone, and JAX's `read_watchdog_trip` reads the trip file.
"""

import errno
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deepspeed_tpu import serving as jserving  # noqa: E402
from deepspeed_tpu.models import GPT as JaxGPT  # noqa: E402
from deepspeed_tpu.models import gpt2_config as jax_gpt2_config  # noqa: E402
from deepspeed_tpu.runtime import resilience as jres  # noqa: E402
from deepspeed_tpu_torch import serving  # noqa: E402
from deepspeed_tpu_torch.models import GPT, gpt2_config  # noqa: E402
from deepspeed_tpu_torch.models import load_jax_params  # noqa: E402
from deepspeed_tpu_torch.monitor import tracing  # noqa: E402
from deepspeed_tpu_torch.monitor.counters import COUNTERS  # noqa: E402
from deepspeed_tpu_torch.runtime import resilience as res  # noqa: E402

torch.set_num_threads(1)

VOCAB, MAX_SEQ, BS = 64, 64, 4
MODEL = dict(num_layers=2, num_heads=4, d_model=32, vocab_size=VOCAB,
             max_seq_len=MAX_SEQ)
SERVE = dict(block_size=BS, num_blocks=48, max_batch=2, prefill_chunk=8,
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


@pytest.fixture(autouse=True)
def no_plan_left():
    yield
    res.install_fault_plan(None)
    jres.install_fault_plan(None)


# -- the plan ----------------------------------------------------------------

SITES = ("serve.step", "serve.admit", "serve.prefill", "serve.decode",
         "ckpt.atomic_write", "hostwire.kv_get")

PLANS = {
    "calls": ([{"site": "serve.decode", "kind": "raise", "calls": [0, 3, 7]},
               {"site": "ckpt.*", "kind": "delay_ms", "delay_ms": 0,
                "calls": [1]}], 0, None),
    "every": ([{"site": "serve.*", "kind": "delay_ms", "delay_ms": 0,
                "every": 5},
               {"site": "hostwire.kv_get", "kind": "raise", "every": 2,
                "times": 3, "transient": False}], 1, None),
    "prob": ([{"site": "*", "kind": "delay_ms", "delay_ms": 0,
               "prob": 0.3},
              {"site": "serve.prefill", "kind": "raise", "prob": 0.5}],
             7, None),
    "steps": ([{"site": "serve.step", "kind": "raise", "steps": [2, 5]},
               {"site": "serve.admit", "kind": "delay_ms", "delay_ms": 0,
                "steps": [3], "every": 2}], 3, None),
    "rank": ([{"site": "*", "kind": "raise", "rank": 1, "prob": 0.25},
              {"site": "serve.decode", "kind": "delay_ms", "delay_ms": 0,
               "rank": 0}], 11, 1),
}


def _drive(mod, rules, seed, rank, n=400):
    """Fire a seeded site sequence through the installed plan, advancing
    the step every 20 calls; -> (injection log, outcome per call)."""
    plan = mod.FaultPlan.from_config(rules, seed=seed)
    if rank is not None:
        plan.rank = rank
    mod.install_fault_plan(plan)
    rs = np.random.RandomState(seed)
    outcomes = []
    try:
        for i in range(n):
            site = SITES[rs.randint(len(SITES))]
            try:
                if i % 20 == 0:         # fires the engine.step site too
                    mod.step_boundary(i // 20)
                mod.fault_point(site)
                outcomes.append("ok")
            except (mod.InjectedFault, mod.InjectedFatalFault) as e:
                outcomes.append(type(e).__name__)
    finally:
        mod.install_fault_plan(None)
    return plan.injection_log, outcomes


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fault_plan_injects_as_jax(name):
    rules, seed, rank = PLANS[name]
    got = _drive(res, rules, seed, rank)
    want = _drive(jres, rules, seed, rank)
    assert got == want
    assert got[0], "the plan never fired"
    assert set(got[1]) - {"ok"}


BAD_RULES = [
    {"site": "", "kind": "raise"},
    {"site": "x", "kind": "explode"},
    {"site": "x", "kind": "raise", "prob": 1.5},
    {"site": "x", "kind": "raise", "every": 0},
    {"site": "x", "kind": "raise", "steps": "3"},
    {"site": "x", "kind": "delay_ms", "delay_ms": -1},
    {"site": "x", "kind": "raise", "times": -2},
    {"site": "x", "kind": "raise", "nope": 1},
    {"kind": "raise"},
    "raise at x",
]


@pytest.mark.parametrize("i", range(len(BAD_RULES)))
def test_bad_rules_raise_as_jax(i):
    msgs = []
    for mod in (res, jres):
        with pytest.raises(ValueError) as e:
            mod.FaultPlan.from_config([BAD_RULES[i]])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


EXCEPTIONS = [
    res.InjectedFault("x"), res.InjectedFatalFault("x"),
    res.TransientFault("x"), TimeoutError(), ConnectionResetError(),
    OSError(errno.EIO, "io"), OSError(errno.ENOSPC, "full"),
    FileNotFoundError(), ValueError("UNAVAILABLE"),
    RuntimeError("DEADLINE_EXCEEDED: rpc"), RuntimeError("boom"),
]
_JAX_TWIN = {res.InjectedFault: jres.InjectedFault,
             res.InjectedFatalFault: jres.InjectedFatalFault,
             res.TransientFault: jres.TransientFault}


@pytest.mark.parametrize("i", range(len(EXCEPTIONS)))
def test_taxonomy_matches_jax(i):
    e = EXCEPTIONS[i]
    twin = _JAX_TWIN.get(type(e))
    je = twin(*e.args) if twin else e
    assert res.is_transient(e) == jres.is_transient(je)


def test_retry_absorbs_an_injected_transient_fault_only(monkeypatch):
    """A `raise` rule at a retried site is retried (transient) or
    re-raised at once (transient=false)."""
    monkeypatch.setattr(res.time, "sleep", lambda s: None)
    snap = COUNTERS.snapshot()
    res.install_fault_plan(res.FaultPlan.from_config(
        [{"site": "io.write", "kind": "raise", "calls": [0, 1]}]))

    def op():
        res.fault_point("io.write")
        return "done"

    assert res.retry_transient(op, "io.write") == "done"
    d = COUNTERS.delta_since(snap)
    assert d["fault.injected"]["calls"] == 2
    assert d["fault.retried"]["calls"] == 2
    res.install_fault_plan(res.FaultPlan.from_config(
        [{"site": "io.write", "kind": "raise", "transient": False}]))
    with pytest.raises(res.InjectedFatalFault):
        res.retry_transient(op, "io.write")
    assert COUNTERS.delta_since(snap)["fault.retried"]["calls"] == 2


def test_corrupt_filter_and_disabled_plan():
    res.install_fault_plan(res.FaultPlan.from_config(
        [{"site": "ckpt.payload", "kind": "corrupt", "truncate_to": 3}]))
    assert res.fault_filter("ckpt.payload", b"abcdefgh") == b"abc"
    with pytest.raises(res.InjectedFault, match="non-payload"):
        res.fault_point("ckpt.payload")
    plan = res.FaultPlan.from_config(
        [{"site": "*", "kind": "raise"}], enabled=False)
    res.install_fault_plan(plan)
    res.fault_point("anything")
    assert plan.injection_log == [] and plan._site_calls == {"anything": 1}
    assert res.active_plan() is plan
    assert res.install_fault_plan(None) is plan
    res.fault_point("anything")                     # no plan: a no-op


def test_plan_rank_comes_from_torch_distributed(monkeypatch):
    """With a process group up, the plan's rank is get_rank()."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    plan = res.FaultPlan.from_config(
        [{"site": "x", "kind": "delay_ms", "delay_ms": 0, "rank": 3}])
    plan.check("x")
    assert plan.rank == 3 and plan.injection_log[0]["rank"] == 3
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    assert res.FaultPlan([])._resolve_rank() == 0


# -- the serving engine's sites ------------------------------------------------


def _prompts():
    rs = np.random.RandomState(7)
    return [rs.randint(0, VOCAB, (n,)).tolist() for n in (5, 7, 4, 6)]


def test_engine_sites_fire_as_jax(pair):
    """One plan over the same traffic on both engines: the same sites in
    the same order, the same injections, the same tokens."""
    jmodel, jparams, progs, model = pair
    rules = [{"site": "serve.*", "kind": "delay_ms", "delay_ms": 0,
              "every": 3},
             {"site": "serve.decode", "kind": "delay_ms", "delay_ms": 0,
              "prob": 0.5}]
    out = {}
    for mod, make in ((res, lambda: serving.ServeEngine(
            model, serving.ServeConfig(**SERVE), device="cpu")),
            (jres, lambda: jserving.ServeEngine(
                jmodel, jparams, jserving.ServeConfig(**SERVE),
                programs=progs))):
        plan = mod.FaultPlan.from_config(rules, seed=5)
        mod.install_fault_plan(plan)
        try:
            toks = make().generate(_prompts(), 6)
        finally:
            mod.install_fault_plan(None)
        out[mod.__name__] = (toks, plan.injection_log, plan._site_calls)
    got, want = out[res.__name__], out[jres.__name__]
    assert got == want
    assert set(got[2]) == {"serve.step", "serve.admit", "serve.prefill",
                           "serve.decode"}


# -- the watchdog and the chaos scenario ---------------------------------------


def test_watchdog_validates_and_trips_once_a_stall(tmp_path):
    for kw in ({"deadline_s": 0}, {"deadline_s": 1, "poll_s": 0},
               {"deadline_s": 1, "first_beat_mult": 0.5}):
        with pytest.raises(ValueError):
            res.StepWatchdog(snapshot_dir=str(tmp_path), **kw)
    trips = []
    wd = res.StepWatchdog(0.1, str(tmp_path / "snap"),
                          escalate_dir=str(tmp_path / "esc"), poll_s=0.02,
                          rank=2, on_trip=trips.append, first_beat_mult=2.0)
    try:
        t0 = time.monotonic()
        while not trips and time.monotonic() - t0 < 10:
            time.sleep(0.01)
        time.sleep(0.2)                 # tripped: no second trip unbeaten
        assert wd.trips == 1 and "first step never completed" in \
            trips[0]["reason"]
        wd.beat(4)
        # on_trip runs after the trip count and the files: wait for it
        while len(trips) < 2 and time.monotonic() - t0 < 10:
            time.sleep(0.01)
        assert wd.trips == 2 and trips[1]["last_step"] == 4
    finally:
        wd.stop()
    trip = jres.read_watchdog_trip(str(tmp_path / "esc"))
    assert trip["rank"] == 2 and trip["last_step"] == 4
    with open(trip["snapshot"]) as f:
        snap = json.load(f)
    assert snap["trip"] == 2 and snap["counters"]["watchdog.trips"]
    assert res.read_watchdog_trip(str(tmp_path)) is None


def _chaos(model, snap_dir, worker):
    """JAX's run_dry_chaos on the port: two requests running, the third
    decode call hangs 1.5 s past a 0.5 s watchdog, on_trip sheds; then
    two more requests run to the end."""
    cfg = serving.ServeConfig(**SERVE)
    prompts = _prompts()
    oracle = serving.ServeEngine(model, cfg, device="cpu")
    want = [oracle.generate([p], 6)[0] for p in prompts]
    eng = serving.ServeEngine(model, cfg, device="cpu", prepared=model)
    rec = tracing.TraceRecorder(snap_dir, flush_interval_s=10)
    eng.attach_tracing(tracer=rec)
    wd = res.StepWatchdog(deadline_s=0.5, snapshot_dir=snap_dir, poll_s=0.05,
                          on_trip=lambda trip: eng.request_shed(
                              trip["reason"]))
    eng.attach_watchdog(wd)
    plan = res.FaultPlan([res.FaultRule(site="serve.decode", kind="hang",
                                        hang_s=1.5, calls=[2])], seed=0)
    res.install_fault_plan(plan)
    snap = COUNTERS.snapshot()
    w = serving.ServeWorker(eng) if worker else None
    try:
        if w is not None:
            w.start()
        r01 = [eng.submit(prompts[0], 6), eng.submit(prompts[1], 6)]
        while any(not r.done for r in r01):
            if w is None:
                eng.step()
            else:
                time.sleep(0.01)
        r23 = [eng.submit(prompts[2], 6), eng.submit(prompts[3], 6)]
        if w is None:
            eng.run()
        else:
            while any(not r.done for r in r23):
                time.sleep(0.01)
    finally:
        res.install_fault_plan(None)
        eng.close()
        wd.stop()
        rec.close()
    return r01, r23, want, wd, plan, COUNTERS.delta_since(snap), eng


@pytest.mark.parametrize("worker", [False, True])
def test_chaos_sheds_exactly_the_wedged_batch(pair, tmp_path, worker):
    r01, r23, want, wd, plan, d, eng = _chaos(pair[3], str(tmp_path), worker)
    assert [r.state for r in r01] == [serving.ERROR] * 2
    assert all("deadline exceeded" in r.error for r in r01)
    assert wd.trips == 1
    assert d["serve.shed"]["calls"] == 2
    assert d["kv.evictions"]["calls"] > 0
    assert d["fault.injected"]["calls"] == 1
    assert d["watchdog.trips"]["calls"] == 1
    assert plan.injection_log == [{"site": "serve.decode", "kind": "hang",
                                   "rule": 0, "rank": 0, "step": 0,
                                   "call": 2}]
    assert [r.out for r in r23] == want[2:]
    assert eng.kv.blocks_in_use == 0
    trip = jres.read_watchdog_trip(str(tmp_path))
    assert "step deadline exceeded" in trip["reason"]
    with open(trip["snapshot"]) as f:
        snap = json.load(f)
    assert snap["trace_tail"] and "serving" in snap["thread_groups"]
    assert len(snap["thread_groups"]["serving"]) == int(worker)
    names = [e["name"] for e in tracing.read_trace_file(
        os.path.join(str(tmp_path), "trace.rank00000.jsonl"))[0][0][1]]
    assert names.count("shed") == 1

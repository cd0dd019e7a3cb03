"""Port parity: the fleet router, its worker threads and the serving
config block (deepspeed_tpu_torch/serving/router.py, engine.py
`ServeWorker`, runtime/config.py `DeepSpeedServingConfig`) against the
JAX package's, on shared weights.

One tiny fp32 GPT (2 layers, 4 heads, d32, vocab 64, max_seq 64, KV
block 4; JAX's tests/test_prefix_cache.py shape), its weights made by
the JAX init and carried across with `load_jax_params`, one JAX program
pair built for this module.  Prompts come from numpy seeds.  Every
comparison is exact: the replica each request lands on, the `router.*`,
`serve.*` and `kv.*` counter deltas (calls; bytes where they count
blocks or tokens, not time), the request states and the greedy token
streams (fp32 on both sides; the tokens are argmaxes whose margins the
order of fp32 sums does not reach at this size, as
tests/test_torch_serving.py holds)."""

import sys
import tempfile
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deepspeed_tpu import serving as jserving  # noqa: E402
from deepspeed_tpu.models import GPT as JaxGPT  # noqa: E402
from deepspeed_tpu.models import gpt2_config as jax_gpt2_config  # noqa: E402
from deepspeed_tpu.monitor.counters import \
    COUNTERS as JAX_COUNTERS  # noqa: E402
from deepspeed_tpu.runtime.config import \
    DeepSpeedServingConfig as JaxServingConfig  # noqa: E402
from deepspeed_tpu_torch import serving  # noqa: E402
from deepspeed_tpu_torch.models import GPT, gpt2_config  # noqa: E402
from deepspeed_tpu_torch.models import load_jax_params  # noqa: E402
from deepspeed_tpu_torch.monitor.counters import (COUNTERS,  # noqa: E402
                                                  CounterRegistry)
from deepspeed_tpu_torch.runtime.config import \
    DeepSpeedServingConfig  # noqa: E402
from deepspeed_tpu_torch.runtime.resilience import StepWatchdog  # noqa: E402
from deepspeed_tpu_torch.serving import programs  # noqa: E402

torch.set_num_threads(1)

VOCAB, MAX_SEQ, BS = 64, 64, 4
MODEL = dict(num_layers=2, num_heads=4, d_model=32, vocab_size=VOCAB,
             max_seq_len=MAX_SEQ)
SERVE = dict(block_size=BS, num_blocks=40, max_batch=4, prefill_chunk=8,
             max_seq_len=MAX_SEQ)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, jax programs, port model): one weight set
    and one JAX program pair for the module."""
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


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class _Side:
    """One package's fleet surface, so that a scenario runs unchanged on
    both."""

    def __init__(self, pkg, pair):
        self.pkg = pkg
        jmodel, jparams, progs, model = pair
        if pkg == "jax":
            self.serving, self.counters = jserving, JAX_COUNTERS
            self._build = lambda cfg, n, clock: jserving.build_fleet(
                jmodel, jparams, cfg, replicas=n, programs=progs,
                clock=clock)
        else:
            self.serving, self.counters = serving, COUNTERS
            self._build = lambda cfg, n, clock: serving.build_fleet(
                model, cfg, replicas=n, device="cpu", clock=clock)

    def fleet(self, replicas=2, clock=time.monotonic, **over):
        cfg = self.serving.ServeConfig(**dict(SERVE, **over))
        return self._build(cfg, replicas, clock)

    def router(self, engines, **kw):
        return self.serving.FleetRouter(engines, **kw)


def _tokens(n, seed):
    return np.random.RandomState(seed).randint(0, VOCAB, (n,)).tolist()


_COUNTED = ("router.", "serve.", "kv.")
# counters whose bytes slot holds time, not blocks or tokens
_TIMED = ("serve.ttft_ms",)


def _delta(counters, snap):
    out = {}
    for k, v in counters.delta_since(snap).items():
        if k.startswith(_COUNTED):
            out[k] = (v["calls"], None if k in _TIMED else v["bytes"])
    return out


def _req(r):
    return (getattr(r, "replica", None), r.state, list(r.out),
            r.prefix_cached_tokens)


# -- scenarios: each runs on one side and returns what it observed -----------


def _least_loaded(side):
    router = side.router(side.fleet(), queue_limit=4)
    r1 = router.submit(_tokens(6, 41), 4)
    r2 = router.submit(_tokens(9, 42), 4)   # replica 0 now has a queue of 1
    router.run()
    router.close()
    return [_req(r1), _req(r2)], router.dispatched


def _session_affinity(side):
    engines = side.fleet()
    router = side.router(engines, queue_limit=4)
    p1 = _tokens(10, 43)
    r1 = router.submit(p1, 5, session_id="aff")
    router.run()
    home = r1.replica
    pinned = (engines[home].resident_sessions, engines[home].kv.blocks_in_use)
    other = router.submit(_tokens(6, 44), 4)   # home is the loaded one now
    r2 = router.submit(p1 + r1.out + _tokens(4, 45), 5, session_id="aff")
    router.run()
    router.close()
    return [_req(r1), _req(other), _req(r2)], pinned, home


def _stale_affinity(side):
    clk = _Clock()
    engines = side.fleet(clock=clk)
    router = side.router(engines, queue_limit=4)
    r1 = router.submit(_tokens(10, 61), 5, session_id="aff")
    router.run()
    home = r1.replica
    busy = engines[home].submit(_tokens(8, 62), 12)
    engines[home].step()
    clk.t += engines[home].config.session_ttl_s + 1
    engines[home].step()                        # the TTL releases the pin
    released = engines[home].resident_sessions
    r2 = router.submit(_tokens(6, 63), 4, session_id="aff")
    mapped = router._session_replica["aff"]
    router.run()
    router.close()
    return [_req(r1), _req(busy), _req(r2)], released, mapped


def _sweep_at_cap(side):
    engines = side.fleet()
    router = side.router(engines, queue_limit=4, affinity_cap=1)
    ra = router.submit(_tokens(6, 64), 3, session_id="a")
    router.run()
    released = engines[ra.replica].release_session("a")
    rb = router.submit(_tokens(6, 65), 3, session_id="b")
    kept = sorted(router._session_replica)
    router.run()
    router.close()
    return [_req(ra), _req(rb)], released, kept


def _spill_and_shed(side):
    engines = side.fleet()
    router = side.router(engines, queue_limit=1)
    busy = engines[1].submit(_tokens(8, 46), 12)
    engines[1].step()
    ra = router.submit(_tokens(5, 47), 4)       # -> 0, its queue full
    rb = router.submit(_tokens(5, 48), 4)       # 0 full -> spill to 1
    rc = router.submit(_tokens(5, 49), 4)       # both full -> shed
    shed = (rc.state, rc.error, getattr(rc, "replica", None))
    router.run()
    router.close()
    return ([_req(busy), _req(ra), _req(rb)], shed, router.spilled,
            router.shed)


def _mixed_traffic(side):
    """Twelve requests, three two-turn sessions among them, submitted in
    waves between fleet steps."""
    router = side.router(side.fleet(), queue_limit=3)
    rs = np.random.RandomState(5)
    reqs, firsts = [], {}
    for wave in range(4):
        for i in range(3):
            sid = f"s{i}" if wave in (0, 2) else None
            if sid is not None and sid in firsts:
                r0 = firsts[sid]
                prompt = r0.prompt + r0.out + _tokens(3, 100 + i)
            else:
                prompt = _tokens(int(rs.randint(3, 14)), 10 * wave + i)
            r = router.submit(prompt, int(rs.randint(2, 7)), session_id=sid)
            if sid is not None:
                firsts.setdefault(sid, r)
            reqs.append(r)
        for _ in range(2):
            router.step_all()
    router.run()
    router.close()
    return [_req(r) for r in reqs], router.spilled, router.shed


SCENARIOS = {"least_loaded": _least_loaded,
             "session_affinity": _session_affinity,
             "stale_affinity": _stale_affinity,
             "sweep_at_cap": _sweep_at_cap,
             "spill_and_shed": _spill_and_shed,
             "mixed_traffic": _mixed_traffic}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_matches_jax(pair, name):
    """The same traffic through both packages' FleetRouter(build_fleet(...))
    driven by run(): every request's replica, state, tokens and cached
    prefix, the scenario's own observations, and the counter deltas."""
    got = {}
    for pkg in ("jax", "torch"):
        side = _Side(pkg, pair)
        snap = side.counters.snapshot()
        got[pkg] = (SCENARIOS[name](side), _delta(side.counters, snap))
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][1] == got["jax"][1]
    # the scenario exercised what it names
    deltas = got["torch"][1]
    assert deltas["router.dispatches"][0] > 0
    if name == "spill_and_shed":
        assert deltas["router.spills"][0] == 1
        assert deltas["router.shed"][0] == 1
    if name == "session_affinity":
        assert deltas["kv.prefix_hit_tokens"][1] > 0


def test_build_fleet_shares_prepared_weights_and_validates(pair):
    model = pair[3]
    cfg = serving.ServeConfig(**SERVE)
    with pytest.raises(ValueError, match="replicas"):
        serving.build_fleet(model, cfg, replicas=0, device="cpu")
    engines = serving.build_fleet(model, cfg, replicas=3, device="cpu")
    assert all(e.model is model for e in engines)
    assert len({id(e.kv) for e in engines}) == 3        # a pool each
    with pytest.raises(ValueError, match="at least one"):
        serving.FleetRouter([])
    with pytest.raises(ValueError, match="queue_limit"):
        serving.FleetRouter(engines, queue_limit=0)
    with pytest.raises(ValueError, match="affinity_cap"):
        serving.FleetRouter(engines, affinity_cap=0)
    for e in engines:
        e.close()
    # under quantized weights the replicas share the first engine's store
    qcfg = serving.ServeConfig(**SERVE, quantized_weights="int8")
    q = serving.build_fleet(model, qcfg, replicas=2, device="cpu")
    assert isinstance(q[0].model, programs.QuantizedWeights)
    assert q[1].model is q[0].model
    # a store prepared for another quant mode is refused
    with pytest.raises(ValueError, match="quantized_weights='int8'"):
        serving.ServeEngine(model, serving.ServeConfig(
            **SERVE, quantized_weights="int4"), device="cpu",
            prepared=q[0].model)
    with pytest.raises(ValueError, match="quantized_weights='none'"):
        serving.ServeEngine(model, qcfg, device="cpu", prepared=model)
    other = GPT(gpt2_config("nano", **dict(MODEL, num_layers=1)),
                device="cpu")
    with pytest.raises(ValueError, match="prepared weights"):
        serving.ServeEngine(model, cfg, device="cpu", prepared=other)


def test_quantized_fleet_streams_equal_one_engine(pair):
    """Two replicas reading one shared int8 store serve each request's
    tokens as one engine of its own does."""
    model = pair[3]
    qcfg = serving.ServeConfig(**SERVE, quantized_weights="int8")
    router = serving.FleetRouter(
        serving.build_fleet(model, qcfg, replicas=2, device="cpu"))
    prompts = [_tokens(n, 80 + n) for n in (5, 11, 7, 3)]
    reqs = [router.submit(p, 5) for p in prompts]
    router.run()
    router.close()
    assert {r.replica for r in reqs} == {0, 1}
    alone = serving.ServeEngine(model, qcfg, device="cpu")
    assert [r.out for r in reqs] == [alone.generate([p], 5)[0]
                                     for p in prompts]


@pytest.mark.parametrize("replicas", [2, 3])
def test_workers_give_the_tokens_of_run(pair, replicas):
    """start() drives each replica from its own ServeWorker thread while
    the main thread submits; the streams equal the synchronous run()'s
    and one session's turns stay on their replica."""
    model = pair[3]
    prompts = [_tokens(n, 200 + n) for n in (4, 9, 13, 6, 3, 11)]

    def serve(threaded):
        router = serving.FleetRouter(serving.build_fleet(
            model, serving.ServeConfig(**SERVE), replicas=replicas,
            device="cpu"))
        if threaded:
            router.start()
            assert len(router._workers) == replicas
        reqs = [router.submit(p, 6) for p in prompts]
        first = router.submit(_tokens(8, 300), 4, session_id="chat")
        if threaded:
            t0 = time.monotonic()
            while not all(r.done for r in reqs + [first]):
                assert time.monotonic() - t0 < 60
                time.sleep(0.005)
        else:
            router.run()
        second = router.submit(first.prompt + first.out + _tokens(3, 301), 4,
                               session_id="chat")
        if threaded:
            while not second.done:
                time.sleep(0.005)
        else:
            router.run()
        router.close()
        return reqs + [first, second]

    sync, threaded = serve(False), serve(True)
    assert all(r.state == serving.FINISHED for r in threaded)
    assert [r.out for r in threaded] == [r.out for r in sync]
    assert threaded[-1].replica == threaded[-2].replica
    assert threaded[-1].prefix_cached_tokens > 0


def test_worker_death_fails_requests_and_reraises(pair):
    """A ServeWorker whose step raises marks every request that is not
    terminal 'error' (never a silent hang) and re-raises on stop()."""
    eng = serving.ServeEngine(pair[3], serving.ServeConfig(**SERVE),
                              device="cpu")

    def boom():
        raise RuntimeError("injected engine failure")

    eng.step = boom
    w = serving.ServeWorker(eng)
    w.start()
    r = eng.submit(_tokens(5, 7), 4)
    w.join(timeout=10.0)
    assert not w.is_alive()
    assert r.state == serving.ERROR and "injected engine failure" in r.error
    with pytest.raises(RuntimeError, match="injected engine failure"):
        w.stop()
    eng.close()                         # the worker is detached: no re-raise


def test_idle_worker_does_not_trip_the_watchdog(pair):
    """A ServeWorker with no traffic beats the watchdog from its idle
    loop: a quiet period is not a hang."""
    eng = serving.ServeEngine(pair[3], serving.ServeConfig(**SERVE),
                              device="cpu")
    with tempfile.TemporaryDirectory() as d:
        wd = StepWatchdog(deadline_s=0.2, snapshot_dir=d, poll_s=0.05,
                          on_trip=lambda t: eng.request_shed(t["reason"]))
        eng.attach_watchdog(wd)
        w = serving.ServeWorker(eng)
        w.start()
        try:
            r = eng.submit(_tokens(5, 8), 4)
            t0 = time.monotonic()
            while not r.done and time.monotonic() - t0 < 30:
                time.sleep(0.01)
            assert wd._thread_group_report()["serving"][0]["alive"]
            time.sleep(0.6)             # idle for three deadlines
            assert wd.trips == 0, "an idle period tripped the watchdog"
            assert r.state == serving.FINISHED
        finally:
            eng.close()
            wd.stop()
        assert "serving" not in wd._thread_groups


def test_router_submit_is_thread_safe(pair):
    """Eight frontend threads submitting at once: the dispatch count is
    exact and one session's concurrent first turns land on one replica."""
    router = serving.FleetRouter(serving.build_fleet(
        pair[3], serving.ServeConfig(**SERVE), replicas=2, device="cpu"),
        queue_limit=64)
    reqs, guard = [], threading.Lock()

    def frontend(k):
        for _ in range(4):
            r = router.submit(_tokens(5, 70 + k), 2,
                              session_id="t" if k % 2 == 0 else None)
            with guard:
                reqs.append(r)

    threads = [threading.Thread(target=frontend, args=(k,))
               for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert router.dispatched == len(reqs) == 32
    assert len({r.replica for r in reqs if r.session_id == "t"}) == 1
    router.run()
    assert all(r.state == serving.FINISHED for r in reqs)
    router.close()


@pytest.mark.parametrize("threads", [2, 8])
def test_counters_exact_under_threads(threads):
    """COUNTERS.add from many threads at once gives exact totals, and a
    snapshot taken while new keys appear never breaks."""
    reg = CounterRegistry()
    n = 5000
    stop = threading.Event()
    snaps = []

    def writer(k):
        for i in range(n):
            reg.add("shared", nbytes=3)
            reg.add(f"own.{k}.{i % 50}")

    def reader():
        while not stop.is_set():
            try:
                snaps.append(len(reg.snapshot()))
            except RuntimeError as e:  # "dictionary changed size ..."
                snaps.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)       # switch threads as often as it can
    try:
        r = threading.Thread(target=reader)
        r.start()
        ws = [threading.Thread(target=writer, args=(k,))
              for k in range(threads)]
        for w in ws:
            w.start()
        for w in ws:
            w.join(timeout=60)
        stop.set()
        r.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not r.is_alive() and not any(w.is_alive() for w in ws)
    tot = reg.totals()
    assert tot["shared"] == {"calls": threads * n, "bytes": 3 * threads * n}
    assert sum(v["calls"] for k, v in tot.items()
               if k.startswith("own.")) == threads * n
    assert snaps and all(isinstance(n, int) for n in snaps)


# -- the serving config block -----------------------------------------------

SERVING_BLOCKS = [
    {},
    {"kv_dtype": "INT8"},
    {"kv_dtype": "bf16", "speculative": {"enabled": True, "draft_len": 6,
                                         "ngram": 2}},
    {"speculative": {"draft_len": 2}},
    {"prefix_cache": {"enabled": False, "min_match_blocks": 3,
                      "session_ttl_s": 5}},
    {"fleet": {"replicas": 3, "queue_limit": 8, "session_affinity": False}},
    {"kv_dtype": "int3"},
    {"kv_dtype": 8},
    {"bogus": 1},
    {"speculative": {"draft_len": 0}},
    {"speculative": {"ngram": True}},
    {"speculative": {"extra": 1}},
    {"prefix_cache": {"min_match_blocks": 0}},
    {"prefix_cache": {"session_ttl_s": "soon"}},
    {"prefix_cache": {"session_ttl_s": -1}},
    {"fleet": {"replicas": 0}},
    {"fleet": {"queue_limit": 2.5}},
    {"fleet": {"affinity_cap": 4}},
]


@pytest.mark.parametrize("i", range(len(SERVING_BLOCKS)))
def test_serving_config_matches_jax(i):
    """Each block gives the same ServeConfig and fleet kwargs in both
    parsers, or the same error."""
    pd = {"serving": SERVING_BLOCKS[i]}
    out = {}
    for name, cls in (("jax", JaxServingConfig),
                      ("torch", DeepSpeedServingConfig)):
        try:
            c = cls(pd)
            out[name] = ("ok", c.to_serve_kwargs(), c.to_fleet_kwargs())
        except Exception as e:         # compared across the packages
            out[name] = ("error", type(e).__name__, str(e))
    assert out["torch"] == out["jax"]
    if out["torch"][0] == "ok":
        # and the port's engine and router take what it selects
        kw = out["torch"][1]
        serving.ServeConfig(**SERVE, **kw)

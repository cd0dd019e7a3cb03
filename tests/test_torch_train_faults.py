"""Port parity: the training engine's resilience (the `faults` block,
runtime/resilience.py's retry policy and watchdog, the checkpoint and
loader chaos sites, the SIGTERM preemption checkpoint) against the JAX
package, on GPT-2 nano in fp32.

* Checkpoint faults: a seeded transient `ckpt.atomic_write` plan retries
  and injects exactly as often as under the JAX engine; a `corrupt`
  payload fails the load as the JAX engine's load fails; a fatal
  `ckpt.commit` leaves the tag uncommitted and `latest` on the one
  before.
* Loader faults: a transient `dataloader.worker` fault kills a prefetch
  worker, which is respawned, and the run's losses and masters are
  bitwise those of the undisturbed run.
* The retry policy's delays for a seed are bitwise JAX's.
* The engine's watchdog trips on a wedged step (its trip file carries
  the trace's flight-recorder tail) and not on normal steps.
* Preemption: a SIGTERM during step k gives a committed `preempt_step{k}`
  and SystemExit(0) at that boundary; a fresh engine resumes from
  `latest` bitwise (losses and masters) and the JAX engine loads the tag.

Bitwise comparisons run under deterministic algorithms (the embedding
backward sums rows in any order otherwise, on the CPU too).
"""

import json
import os
import random
import signal
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu.models import GPT as JaxGPT  # noqa: E402
from deepspeed_tpu.models import gpt2_config as jax_gpt2_config  # noqa: E402
from deepspeed_tpu.monitor.counters import COUNTERS as JCOUNTERS  # noqa: E402
from deepspeed_tpu.runtime import resilience as jres  # noqa: E402
from deepspeed_tpu_torch.models import GPT, gpt2_config  # noqa: E402
from deepspeed_tpu_torch.models.convert import flatten_tree  # noqa: E402
from deepspeed_tpu_torch.monitor.counters import COUNTERS  # noqa: E402
from deepspeed_tpu_torch.runtime import checkpointing as ck  # noqa: E402
from deepspeed_tpu_torch.runtime import resilience as res  # noqa: E402

torch.set_num_threads(1)

SEQ, VOCAB, MICRO = 32, 64, 16


@pytest.fixture(autouse=True)
def _clean_plans():
    yield
    res.install_fault_plan(None)
    res.install_retry_policy(None)
    jres.install_fault_plan(None)
    jres.install_retry_policy(None)


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _data(n=4 * MICRO, seed=0):
    toks = np.random.RandomState(seed).randint(0, VOCAB, (n, SEQ + 1))
    return [(t[:-1].astype(np.int64), t[1:].astype(np.int64)) for t in toks]


def _cfg(micro=MICRO, **extra):
    return dict({"train_batch_size": MICRO,
                 "train_micro_batch_size_per_gpu": micro,
                 "optimizer": {"type": "Adam", "params": {"lr": 3e-3}},
                 "steps_per_print": 0, "gradient_clipping": 1.0,
                 "scheduler": {"type": "WarmupLR",
                               "params": {"warmup_max_lr": 3e-3,
                                          "warmup_num_steps": 5}}},
                **extra)


@pytest.fixture(scope="module")
def tree():
    jm = JaxGPT(jax_gpt2_config("nano", max_seq_len=SEQ, vocab_size=VOCAB,
                                shard_activations=False))
    return jm, jax.tree_util.tree_map(np.asarray,
                                      jm.init(jax.random.PRNGKey(1234)))


def _port(tree, **extra):
    eng, *_ = dt.initialize(
        model=GPT(gpt2_config("nano", max_seq_len=SEQ, vocab_size=VOCAB),
                  device="cpu"),
        model_parameters=tree[1], config_params=_cfg(**extra),
        training_data=_data(), device="cpu")
    return eng


def _jax(tree, **extra):
    je, *_ = deepspeed_tpu.initialize(
        model=tree[0], model_parameters=tree[1],
        config_params=_cfg(micro=MICRO // jax.device_count(), **extra),
        training_data=_data())
    return je


def _delta(counters, snap, name):
    return counters.delta_since(snap).get(name, {"calls": 0})["calls"]


# -- checkpoint faults --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_transient_write_faults_retry_as_jax(tree, tmp_path, seed):
    """A seeded coin on every `ckpt.atomic_write` attempt (at most three
    injections), retried by the installed policy (no sleep): the same
    injections and retries as the JAX engine's save of the same tag."""
    faults = {"seed": seed,
              "rules": [{"site": "ckpt.atomic_write", "kind": "raise",
                         "prob": 0.5, "times": 3}],
              "retry": {"max_attempts": 5, "base_delay_ms": 0}}
    out = {}
    for name, make, counters in (("jax", _jax, JCOUNTERS),
                                 ("port", _port, COUNTERS)):
        eng = make(tree, faults=faults)
        snap = counters.snapshot()
        eng.save_checkpoint(str(tmp_path / name), tag="t")
        out[name] = (_delta(counters, snap, "fault.injected"),
                     _delta(counters, snap, "fault.retried"))
        assert ck.is_tag_committed(str(tmp_path / name), "t")
    assert out["port"] == out["jax"]
    assert out["port"][0] >= 1 and out["port"][0] == out["port"][1]


def _failure(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the comparison is the test
        return type(e).__name__
    return None


def test_corrupt_payload_fails_the_load_as_jax(tree, tmp_path):
    """`corrupt` truncates the first two payloads (the model and the
    optimizer files, written in parallel before the commit): the tag
    commits, and loading it fails on both engines with the same error
    type."""
    faults = {"rules": [{"site": "ckpt.atomic_write.payload",
                         "kind": "corrupt", "calls": [0, 1]}]}
    errs = {}
    for name, make in (("jax", _jax), ("port", _port)):
        eng = make(tree, faults=faults)
        eng.save_checkpoint(str(tmp_path / name), tag="t")
        assert ck.is_tag_committed(str(tmp_path / name), "t")
        assert os.path.getsize(tmp_path / name / "t" /
                               "mp_rank_00_model_states.msgpack") == 8
        fresh = make(tree)
        errs[name] = _failure(
            lambda: fresh.load_checkpoint(str(tmp_path / name)))
    assert errs["port"] == errs["jax"] is not None


def test_fatal_commit_leaves_the_tag_uncommitted(tree, tmp_path):
    eng = _port(tree, faults={"rules": [{"site": "ckpt.commit",
                                         "kind": "raise", "calls": [1],
                                         "transient": False}]})
    eng.train_batch()
    eng.save_checkpoint(str(tmp_path), tag="a")
    eng.train_batch()
    with pytest.raises(res.InjectedFatalFault):
        eng.save_checkpoint(str(tmp_path), tag="b")
    assert ck.is_tag_committed(str(tmp_path), "a")
    assert not ck.is_tag_committed(str(tmp_path), "b")
    assert os.path.exists(tmp_path / "b" / "mp_rank_00_model_states.msgpack")
    assert ck.read_latest_tag(str(tmp_path)) == "a"
    fresh = _port(tree)
    path, client = fresh.load_checkpoint(str(tmp_path))
    assert path == str(tmp_path / "a") and fresh.global_steps == 1


# -- loader faults --------------------------------------------------------------------


def _train(eng, steps):
    losses = [float(eng.train_batch()) for _ in range(steps)]
    return losses, {n: p.detach().clone() for n, p in eng.params.items()}


def test_worker_fault_respawns_and_batches_are_unchanged(tree, deterministic):
    base = _train(_port(tree), 4)
    snap = COUNTERS.snapshot()
    eng = _port(tree, faults={"rules": [{"site": "dataloader.worker",
                                         "kind": "raise", "calls": [1]}]})
    hit = _train(eng, 4)
    eng.finalize_monitoring()
    assert _delta(COUNTERS, snap, "fault.injected") == 1
    assert _delta(COUNTERS, snap, "input.worker_respawns") == 1
    assert hit[0] == base[0]
    assert all(torch.equal(hit[1][n], base[1][n]) for n in base[1])


# -- retry policy -----------------------------------------------------------------------


@pytest.mark.parametrize("seed,kw", [(0, {}), (7, {"jitter": 0.5}),
                                     (11, {"base_delay_ms": 3.0,
                                           "max_delay_ms": 40.0})])
def test_retry_delays_are_jax_bitwise(seed, kw):
    t = res.RetryPolicy(rng=random.Random(seed), **kw)
    j = jres.RetryPolicy(rng=random.Random(seed), **kw)
    assert [t.delay_s(k) for k in range(1, 9)] == \
        [j.delay_s(k) for k in range(1, 9)]
    assert res.is_transient_not_timeout(res.InjectedFault("x"))
    assert not res.is_transient_not_timeout(TimeoutError("deadline"))


def test_installed_policy_drives_retry_transient():
    slept = []
    res.install_retry_policy(res.RetryPolicy(max_attempts=3,
                                             base_delay_ms=10,
                                             rng=random.Random(1),
                                             sleep=slept.append))
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise res.InjectedFault("x")
        return 5

    assert res.retry_transient(flaky) == 5
    want = res.RetryPolicy(base_delay_ms=10, rng=random.Random(1))
    assert slept == [want.delay_s(1), want.delay_s(2)]

    def broken():
        raise res.InjectedFault("always")

    with pytest.raises(res.InjectedFault):
        res.retry_transient(broken)
    assert len(slept) == 4   # two more sleeps, then the third try raises


# -- watchdog ---------------------------------------------------------------------------


def test_engine_watchdog_trips_on_a_wedged_step(tree, tmp_path):
    eng = _port(tree, monitor={"enabled": True, "output_path": str(tmp_path),
                               "job_name": "run",
                               "tracing": {"enabled": True}},
                faults={"watchdog": {"enabled": True, "deadline_s": 1.5,
                                     "poll_s": 0.05,
                                     "first_beat_mult": 4.0}})
    run_dir = str(tmp_path / "run")
    try:
        _train(eng, 3)
        assert eng._watchdog.trips == 0
        assert res.read_watchdog_trip(run_dir) is None
        full = eng._step_fns["full"]

        def wedged(*args):
            t0 = time.time()
            while eng._watchdog.trips == 0 and time.time() - t0 < 20:
                time.sleep(0.02)
            return full(*args)

        eng._step_fns["full"] = wedged
        eng.train_batch()
        assert eng._watchdog.trips == 1
        trip = res.read_watchdog_trip(run_dir)
        assert trip is not None and trip["last_step"] == 2
        snap = json.load(open(trip["snapshot"]))
        names = [e["name"] for e in snap["trace_tail"]]
        assert "watchdog_beat" in names and "input_wait" in names
    finally:
        eng.finalize_monitoring()


# -- preemption -------------------------------------------------------------------------


def test_sigterm_saves_exits_and_resumes_bitwise(tree, tmp_path,
                                                 deterministic):
    save_dir = str(tmp_path / "pre")
    ref_eng = _port(tree)
    ref = _train(ref_eng, 6)
    ref_eng.finalize_monitoring()

    eng = _port(tree, checkpoint={"preempt_save_dir": save_dir})
    losses = _train(eng, 2)[0]
    os.kill(os.getpid(), signal.SIGTERM)
    assert eng.preemption_requested
    with pytest.raises(SystemExit) as exc:
        eng.train_batch()
    assert exc.value.code == 0
    losses.append(float(eng._last_loss))
    assert ck.committed_tags(save_dir) == ["preempt_step3"]
    assert ck.read_latest_tag(save_dir) == "preempt_step3"
    assert signal.getsignal(signal.SIGTERM) is not None

    fresh = _port(tree, checkpoint={"preempt_save_dir": save_dir})
    try:
        path, _ = fresh.load_checkpoint(save_dir)
        assert path.endswith("preempt_step3") and fresh.global_steps == 3
        got = _train(fresh, 3)
    finally:
        fresh.finalize_monitoring()
    assert losses + got[0] == ref[0]
    assert all(torch.equal(got[1][n], ref[1][n]) for n in ref[1])

    je = _jax(tree)
    je.load_checkpoint(save_dir)
    assert je.global_steps == 3
    want = {n: p.detach().numpy()
            for n, p in _port_state_at_3(tree).items()}
    got3 = flatten_tree(jax.tree_util.tree_map(np.asarray, je.params))
    for n in want:
        assert np.array_equal(got3[n], want[n]), n


def _port_state_at_3(tree):
    eng = _port(tree)
    _train(eng, 3)
    eng.finalize_monitoring()
    return eng.params

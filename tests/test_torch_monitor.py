"""Port parity: the training run's monitor (deepspeed_tpu_torch/monitor/,
utils/timer.py, utils/tensorboard.py, profiling/, the engine's hooks)
against the JAX package on GPT-2 nano in fp32, from one JAX init carried
across by models/convert.py.

* Config: the monitor, faults, flops-profiler and elasticity blocks parse
  into the JAX package's fields, and bad keys raise its messages; the
  elastic batch triple is JAX's; every config section the JAX engine
  honours is honoured by the port or refused (none is accepted
  silently).
* Events, trace, TensorBoard, timers: three steps of both engines with
  everything on.  Event types, step keys, the trace's (name, cat)
  sequence, the TensorBoard tags and x values and the timer line's
  layout are equal; loss, lr and loss_scale agree within atol 1e-5 (the
  fp32 engine curves of tests/test_torch_train.py: the same fp32
  arithmetic with sums in other orders); JAX's `validate_event`,
  `load_run` and `render_markdown` read the port's run directory.
* Monitoring changes no bit: the losses and fp32 masters of a run with
  the monitor, tracing, the timers, TensorBoard, the flops profiler and
  the watchdog on are bitwise those of the same run with all of them
  off.
* Flops: the port's product count of one micro step equals the JAX
  count's `by_primitive["dot_general"]` exactly, with the dense path and
  with the kernels' path (attention and CE through the kernel wrappers'
  plain versions); the engine's flops a step is that count.
* Two ranks (a spawned gloo world): the merged summary lists both, the
  heartbeat flags the rank slowed by a sleep, and the tracer's clock sync
  runs over the process group.
"""

import json
import logging
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu.models import GPT as JaxGPT  # noqa: E402
from deepspeed_tpu.models import gpt2_config as jax_gpt2_config  # noqa: E402
from deepspeed_tpu.monitor import report as jreport  # noqa: E402
from deepspeed_tpu.monitor import tracing as jtracing  # noqa: E402
from deepspeed_tpu.runtime import config as jconfig  # noqa: E402
from deepspeed_tpu.utils.tensorboard import \
    TensorBoardMonitor as JaxTB  # noqa: E402
from deepspeed_tpu_torch.models import GPT, gpt2_config  # noqa: E402
from deepspeed_tpu_torch.models import load_jax_params  # noqa: E402
from deepspeed_tpu_torch.monitor import report, tracing  # noqa: E402
from deepspeed_tpu_torch.runtime import config as tconfig  # noqa: E402
from deepspeed_tpu_torch.runtime import resilience  # noqa: E402
from deepspeed_tpu_torch.utils.tensorboard import TensorBoardMonitor  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_qgz import run_once  # noqa: E402

torch.set_num_threads(1)

FP32_ATOL = 1e-5
STEPS = 3
SEQ, VOCAB, MICRO = 32, 64, 64


class RecordingWriter:
    """A SummaryWriter-shaped sink: (tag, value, step) a call."""

    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, float(value), int(step)))

    def flush(self):
        pass


class LogLines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _data(n=3 * MICRO, seed=0):
    toks = np.random.RandomState(seed).randint(0, VOCAB, (n, SEQ + 1))
    return [(t[:-1].astype(np.int64), t[1:].astype(np.int64)) for t in toks]


def _cfg(run_dir=None, micro=MICRO, everything=True):
    cfg = {"train_batch_size": MICRO, "train_micro_batch_size_per_gpu": micro,
           "optimizer": {"type": "Adam", "params": {"lr": 3e-3}},
           "steps_per_print": 1, "gradient_clipping": 1.0,
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_max_lr": 3e-3,
                                    "warmup_num_steps": 5}}}
    if everything:
        cfg.update({
            "wall_clock_breakdown": True,
            "monitor": {"enabled": True, "output_path": str(run_dir),
                        "job_name": "run", "sync_timing": True,
                        "flops": True, "tokens_per_sample": SEQ,
                        "tracing": {"enabled": True, "sample_rate": 1.0}},
            "flops_profiler": {"enabled": True, "profile_step": 1},
            "faults": {"watchdog": {"enabled": True, "deadline_s": 600}},
        })
    return cfg


def _tree(seed=1234):
    jm = JaxGPT(jax_gpt2_config("nano", max_seq_len=SEQ, vocab_size=VOCAB,
                                shard_activations=False))
    return jm, jax.tree_util.tree_map(np.asarray,
                                      jm.init(jax.random.PRNGKey(seed)))


def _port_engine(cfg, tree, data=None):
    eng, *_ = dt.initialize(
        model=GPT(gpt2_config("nano", max_seq_len=SEQ, vocab_size=VOCAB),
                  device="cpu"),
        model_parameters=tree, config_params=cfg,
        training_data=data if data is not None else _data(), device="cpu")
    return eng


def _attach_tb(eng, cls):
    writer = RecordingWriter()
    eng.monitor = cls(writer=writer)
    if eng.run_monitor is not None:
        eng.run_monitor.tensorboard = eng.monitor
    return writer


def _run(eng, logger_name):
    lines = LogLines()
    lg = logging.getLogger(logger_name)
    lg.addHandler(lines)
    try:
        losses = [float(eng.train_batch()) for _ in range(STEPS)]
    finally:
        lg.removeHandler(lines)
    eng.finalize_monitoring()
    return losses, lines.lines


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both engines, three steps each, with the monitor, tracing, the
    timers, TensorBoard, the flops profiler and the watchdog on."""
    jm, tree = _tree()
    jdir = tmp_path_factory.mktemp("jax_run")
    tdir = tmp_path_factory.mktemp("port_run")
    je, *_ = deepspeed_tpu.initialize(
        model=jm, model_parameters=tree,
        config_params=_cfg(jdir, micro=MICRO // jax.device_count()),
        training_data=_data())
    jtb = _attach_tb(je, JaxTB)
    jl, jlog = _run(je, "deepspeed_tpu")
    te = _port_engine(_cfg(tdir), tree)
    ttb = _attach_tb(te, TensorBoardMonitor)
    tl, tlog = _run(te, "deepspeed_tpu_torch")
    return dict(jax=dict(losses=jl, log=jlog, tb=jtb.rows, eng=je,
                         dir=str(jdir / "run")),
                port=dict(losses=tl, log=tlog, tb=ttb.rows, eng=te,
                          dir=str(tdir / "run")))


def _events(run_dir):
    with open(os.path.join(run_dir, "events.rank00000.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


# -- config -------------------------------------------------------------------


CONFIG_CASES = [
    {},
    {"monitor": {"enabled": True, "output_path": "/x", "job_name": "j",
                 "flush_interval": 3, "sync_timing": False, "flops": False,
                 "tokens_per_sample": 128, "heartbeat_interval": 2,
                 "straggler_factor": 2.0,
                 "profiler": {"start_step": 5, "num_steps": 2,
                              "output_dir": "/p"},
                 "tracing": {"enabled": True, "buffer_events": 64,
                             "max_file_bytes": 8192, "sample_rate": 0.5,
                             "seed": 3, "flush_interval_s": 0.25,
                             "slo": {"window_s": 5.0,
                                     "emit_interval_s": 1.0}}}},
    {"faults": {"seed": 7, "enabled": False,
                "rules": [{"site": "ckpt.atomic_write", "kind": "raise",
                           "calls": [0, 2]},
                          {"site": "dataloader.worker", "kind": "delay_ms",
                           "delay_ms": 5, "every": 3}],
                "retry": {"max_attempts": 6, "base_delay_ms": 10,
                          "max_delay_ms": 100, "jitter": 0.5},
                "watchdog": {"enabled": True, "deadline_s": 30,
                             "poll_s": 0.5, "first_beat_mult": None,
                             "snapshot_dir": "/s"}}},
    {"flops_profiler": {"enabled": True, "profile_step": 4,
                        "module_depth": 2, "top_modules": 5,
                        "detailed": False}},
    {"wall_clock_breakdown": True, "memory_breakdown": True,
     "tensorboard": {"enabled": True, "output_path": "/tb",
                     "job_name": "tbj"},
     "checkpoint": {"preempt_save_dir": "/pre"}},
]


def _plain(x):
    if hasattr(x, "describe") and callable(x.describe):
        return x.describe()
    if hasattr(x, "max_attempts"):
        return {k: getattr(x, k) for k in ("max_attempts", "base_delay_ms",
                                           "max_delay_ms", "jitter")}
    return x


def _fields(obj):
    return {k: _plain(v) for k, v in vars(obj).items()
            if not k.startswith("_")}


@pytest.mark.parametrize("case", range(len(CONFIG_CASES)))
def test_config_blocks_equal_jax(case):
    """Field by field, with the nested objects (the fault plan, the retry
    policy) compared through what they describe."""
    pd = dict({"train_batch_size": 8}, **CONFIG_CASES[case])
    j = jconfig.DeepSpeedConfig(pd, world_size=1)
    t = tconfig.DeepSpeedConfig(pd, world_size=1)
    assert _fields(t.monitor_config) == _fields(j.monitor_config)
    assert _fields(t.faults_config) == _fields(j.faults_config)
    assert _fields(t.flops_profiler_config) == \
        _fields(j.flops_profiler_config)
    for k in ("wall_clock_breakdown", "memory_breakdown",
              "tensorboard_enabled", "tensorboard_output_path",
              "tensorboard_job_name", "checkpoint_preempt_save_dir",
              "amp_enabled", "elasticity_enabled"):
        assert getattr(t, k) == getattr(j, k), k


BAD_BLOCKS = [
    {"monitor": {"tracing": {"bogus": 1}}},
    {"monitor": {"tracing": {"enabled": 1}}},
    {"monitor": {"tracing": {"enabled": True}}},
    {"monitor": {"enabled": True, "tracing": {"sample_rate": 0.0}}},
    {"monitor": {"tracing": {"buffer_events": 4}}},
    {"monitor": {"tracing": {"slo": {"window": 1}}}},
    {"faults": {"bogus": 1}},
    {"faults": {"rules": {"site": "x"}}},
    {"faults": {"rules": [{"site": "x", "kind": "explode"}]}},
    {"faults": {"rules": [{"site": "x", "kind": "raise", "when": 1}]}},
    {"faults": {"retry": {"max_attempts": 0}}},
    {"faults": {"retry": {"tries": 2}}},
    {"faults": {"watchdog": {"enabled": True, "deadline_s": 0}}},
    {"faults": {"watchdog": {"first_beat_mult": 0.5}}},
    {"faults": {"watchdog": {"first_beat_mult": "x"}}},
    {"checkpoint": {"preempt_save_dir": 5}},
]


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the comparison is the test
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", range(len(BAD_BLOCKS)))
def test_bad_blocks_raise_jax_messages(case):
    pd = dict({"train_batch_size": 8}, **BAD_BLOCKS[case])
    j = _raised(lambda: jconfig.DeepSpeedConfig(pd, world_size=1))
    t = _raised(lambda: tconfig.DeepSpeedConfig(pd, world_size=1))
    assert j is not None and t == j


ELASTIC = {"enabled": True, "max_train_batch_size": 1000,
           "micro_batch_sizes": [2, 4, 6], "min_gpus": 1, "max_gpus": 64}


@pytest.mark.parametrize("elastic,world,extra", [
    (ELASTIC, 1, {}),
    (ELASTIC, 4, {}),
    (dict(ELASTIC, micro_batch_sizes=[8], max_train_batch_size=256), 2, {}),
    (dict(ELASTIC, prefer_larger_batch=False), 3, {}),
    (dict(ELASTIC, ignore_non_elastic_batch_info=True), 2,
     {"train_batch_size": 7}),
    # errors: batch keys beside elasticity, a world outside the valid set,
    # a missing required key, an unsupported version
    (ELASTIC, 2, {"train_batch_size": 8}),
    (dict(ELASTIC, max_gpus=4), 7, {}),
    ({"enabled": True, "micro_batch_sizes": [2]}, 1, {}),
    (dict(ELASTIC, version=0.2), 1, {}),
])
def test_elastic_batch_triple_equals_jax(elastic, world, extra):
    pd = dict({"elasticity": elastic}, **extra)
    j = _raised(lambda: jconfig.DeepSpeedConfig(pd, world_size=world))
    t = _raised(lambda: tconfig.DeepSpeedConfig(pd, world_size=world))
    assert t == j
    if j is None:
        jc = jconfig.DeepSpeedConfig(pd, world_size=world)
        tc = tconfig.DeepSpeedConfig(pd, world_size=world)
        triple = ("train_batch_size", "train_micro_batch_size_per_gpu",
                  "gradient_accumulation_steps")
        assert [getattr(tc, k) for k in triple] == \
            [getattr(jc, k) for k in triple]
        assert tc.elastic_valid_world_sizes == jc.elastic_valid_world_sizes


def _engine_with(extra, tmp_path):
    cfg = dict(_cfg(everything=False), **extra)
    return _port_engine(cfg, None, data=_data(MICRO))


def _log_of(fn):
    lines = LogLines()
    lg = logging.getLogger("deepspeed_tpu_torch")
    lg.addHandler(lines)
    try:
        out = fn()
    finally:
        lg.removeHandler(lines)
    return out, lines.lines


# each section the JAX engine honours (an `*_enabled` attribute of its
# DeepSpeedConfig, or a section object with `enabled`, and their nested
# `*_enabled` switches): the config that turns it on, and what the port
# engine built from it must show (None: the port refuses it)
HONOURED = {
    "amp_enabled": ({"amp": {"enabled": True}}, None),
    "autotune_config": ({"autotune": {"enabled": True}}, None),
    "autotune_config.online_enabled": (
        {"autotune": {"online": {"enabled": True}}}, None),
    "checkpoint_tag_validation_enabled": (
        {"checkpoint": {"tag_validation": "Fail"}},
        lambda e, d, log: e._config.checkpoint_tag_validation_fail),
    "data_pipeline_config": (
        {"data_pipeline": {"enabled": False}},
        lambda e, d, log: e._wrap_prefetch(e.training_dataloader)
        is e.training_dataloader),
    "elasticity_enabled": (
        {"elasticity": dict(ELASTIC, micro_batch_sizes=[4],
                            max_train_batch_size=8)},
        lambda e, d, log: e.get_batch_info() == (8, 4, 2)),
    "faults_config": (
        {"faults": {"rules": [{"site": "nowhere", "kind": "raise"}]}},
        lambda e, d, log: resilience.active_plan() is not None),
    "faults_config.watchdog_enabled": (
        {"faults": {"watchdog": {"enabled": True,
                                 "snapshot_dir": "{dir}"}}},
        lambda e, d, log: e._watchdog is not None),
    "flops_profiler_config": (
        {"flops_profiler": {"enabled": True, "profile_step": 0}},
        lambda e, d, log: e._flops_stats["flops"] > 0),
    "fp16_enabled": ({"fp16": {"enabled": True}},
                     lambda e, d, log: e.compute_dtype == torch.float16),
    "monitor_config": (
        {"monitor": {"enabled": True, "output_path": "{dir}"}},
        lambda e, d, log: os.path.exists(
            os.path.join(d, "run", "events.rank00000.jsonl"))),
    "monitor_config.tracing_enabled": (
        {"monitor": {"enabled": True, "output_path": "{dir}",
                     "tracing": {"enabled": True}}},
        lambda e, d, log: e._tracer is not None),
    "pld_enabled": ({"progressive_layer_drop": {"enabled": True}},
                    lambda e, d, log: e.progressive_layer_drop is not None),
    "sparse_gradients_enabled": (
        {"sparse_gradients": True},
        lambda e, d, log: any("sparse_gradients: accepted" in s
                              for s in log)),
    "tensorboard_enabled": (
        {"tensorboard": {"enabled": True, "output_path": "{dir}"}},
        lambda e, d, log: e.monitor is not None and e.monitor.enabled),
    "zero_enabled": ({"zero_optimization": {"stage": 1}},
                     lambda e, d, log: e.zero_optimization_stage() == 1),
}


def _jax_switches():
    c = jconfig.DeepSpeedConfig({"train_batch_size": 8}, world_size=1)
    out = set()
    for k, v in vars(c).items():
        if k.endswith("_enabled") or hasattr(v, "enabled"):
            out.add(k)
        if hasattr(v, "enabled"):
            out.update(f"{k}.{n}" for n in vars(v)
                       if n.endswith("_enabled"))
    return out


def test_every_jax_section_switch_is_listed():
    assert _jax_switches() == set(HONOURED)


@pytest.mark.parametrize("name", sorted(HONOURED))
def test_no_section_is_accepted_silently(name, tmp_path):
    """Each switch either works in the port (one step, then what it
    must show) or raises DeepSpeedConfigError naming its ROADMAP item."""
    extra, check = HONOURED[name]
    extra = json.loads(json.dumps(extra).replace("{dir}", str(tmp_path)))
    if check is None:
        with pytest.raises(tconfig.DeepSpeedConfigError,
                           match="the production runtime"):
            _engine_with(extra, tmp_path)
        return
    cfg = dict(_cfg(everything=False), **extra)
    if "elasticity" in extra:
        for k in ("train_batch_size", "train_micro_batch_size_per_gpu"):
            cfg.pop(k)

    def build_and_step():
        eng = _port_engine(cfg, None, data=_data(2 * MICRO))
        eng.train_batch()
        return eng

    eng, log = _log_of(build_and_step)
    try:
        assert check(eng, str(tmp_path), log)
    finally:
        eng.finalize_monitoring()
        resilience.install_fault_plan(None)


# -- events, report, trace, TensorBoard, timers ---------------------------------


def test_event_stream_matches_jax(runs):
    je, te = _events(runs["jax"]["dir"]), _events(runs["port"]["dir"])
    assert [e["type"] for e in te] == [e["type"] for e in je]
    jsteps = [e for e in je if e["type"] == "step"]
    tsteps = [e for e in te if e["type"] == "step"]
    assert len(tsteps) == STEPS
    for a, b in zip(tsteps, jsteps):
        assert set(a) == set(b), set(a) ^ set(b)
        assert set(a["spans_ms"]) == set(b["spans_ms"])
        assert a["step"] == b["step"]
        assert a["skipped_steps"] == b["skipped_steps"] == 0
        for k in ("loss", "lr", "loss_scale"):
            assert abs(a[k] - b[k]) <= FP32_ATOL, (k, a[k], b[k])
        assert a["tflops"] > 0
    for e in te:
        assert jreport.validate_event(e) == [], e
    # the losses the events carry are the ones train_batch returned
    assert [e["loss"] for e in tsteps] == runs["port"]["losses"]


def _headings(md):
    return [line for line in md.splitlines() if line.startswith("## ")]


def test_jax_report_renders_the_port_run(runs):
    """JAX's reader renders the port's run with the sections of JAX's
    own run, less two whose rows depend on what is not compared here:
    "Comm counters" (the JAX engine's step program runs its
    data-parallel reduction over the harness's 8 CPU devices, the port's
    single process has no collective) and "Serving SLO" (its tracing
    rows are the trace writer's `trace.*` counters, which land in the
    step during which the background writer happened to flush)."""
    trun = jreport.load_run(runs["port"]["dir"])
    jrun = jreport.load_run(runs["jax"]["dir"])
    tmd, jmd = jreport.render_markdown(trun), jreport.render_markdown(jrun)
    timing = ("## Comm", "## Serving SLO")
    assert [h for h in _headings(tmd) if not h.startswith(timing)] == \
        [h for h in _headings(jmd) if not h.startswith(timing)]
    assert "## Input pipeline" in _headings(tmd)
    assert trun["manifest"]["model"] == "GPT"
    # the port's copy renders the same text
    assert report.render_markdown(report.load_run(runs["port"]["dir"])) \
        == tmd


def _trace_names(run_dir, reader):
    segments, summary = reader(os.path.join(run_dir,
                                            "trace.rank00000.jsonl"))
    assert summary is not None
    return [(e["name"], e["cat"]) for _, evs in segments for e in evs]


def test_training_trace_sequence_matches_jax(runs):
    j = _trace_names(runs["jax"]["dir"], jtracing.read_trace_file)
    t = _trace_names(runs["port"]["dir"], tracing.read_trace_file)
    assert t == j
    assert ("input_wait", "input") in t and \
        t.count(("watchdog_beat", "watchdog")) == STEPS


def test_tensorboard_scalars_match_jax(runs):
    """Same tags at the same x values; loss, lr and loss scale within
    fp32 tolerance (wall time and TFLOP/s are clocks, not compared)."""
    j, t = runs["jax"]["tb"], runs["port"]["tb"]
    assert [(tag, step) for tag, _, step in t] == \
        [(tag, step) for tag, _, step in j]
    for (tag, a, _), (_, b, _) in zip(t, j):
        if tag.endswith(("loss", "lr", "loss_scale")):
            assert abs(a - b) <= FP32_ATOL, (tag, a, b)
    assert {tag for tag, _, _ in t} >= {
        "Train/Samples/train_loss", "Train/Samples/lr",
        "Train/Samples/loss_scale", "Train/Step/wall_ms"}


def _timer_layout(lines):
    return [re.sub(r"\d+\.\d+", "N", s) for s in lines
            if s.startswith("[Rank 0] time (ms)")]


def test_wall_clock_breakdown_line_matches_jax(runs):
    """The fused step (gas 1) times `forward` only, as JAX's does."""
    t = _timer_layout(runs["port"]["log"])
    assert t == _timer_layout(runs["jax"]["log"])
    assert t == ["[Rank 0] time (ms) | forward: N"] * STEPS


def test_split_step_timers_and_spans_match_jax(tmp_path):
    """gas 2 through forward / backward / step: the split path's apply at
    the boundary runs under the `step` span and timer, in both engines
    (the micro steps under `forward`)."""
    from convergence_common import synthetic_batches

    jm, tree = _tree()
    out = {}
    for name, make, logger_name in (
            ("jax", lambda cfg: deepspeed_tpu.initialize(
                model=jm, model_parameters=tree, config_params=dict(
                    cfg, train_micro_batch_size_per_gpu=MICRO // 2 //
                    jax.device_count()))[0], "deepspeed_tpu"),
            ("port", lambda cfg: _port_engine(
                dict(cfg, train_micro_batch_size_per_gpu=MICRO // 2), tree),
             "deepspeed_tpu_torch")):
        cfg = {k: v for k, v in _cfg(tmp_path / name).items()
               if k not in ("flops_profiler", "faults")}
        cfg["monitor"] = dict(cfg["monitor"], tracing={"enabled": False})
        eng = make(cfg)
        lines = LogLines()
        lg = logging.getLogger(logger_name)
        lg.addHandler(lines)
        try:
            for x, y in synthetic_batches(4, MICRO // 2, SEQ, VOCAB, 3):
                eng.forward((x, y))
                eng.backward()
                eng.step()
        finally:
            lg.removeHandler(lines)
        eng.finalize_monitoring()
        steps = [e for e in _events(str(tmp_path / name / "run"))
                 if e["type"] == "step"]
        out[name] = (_timer_layout(lines.lines),
                     [sorted(e["spans_ms"]) for e in steps],
                     [e["loss"] for e in steps])
    assert out["port"][:2] == out["jax"][:2]
    assert out["port"][0] == ["[Rank 0] time (ms) | forward: N | step: N"] * 2
    assert out["port"][1] == [["forward", "step"]] * 2
    np.testing.assert_allclose(out["port"][2], out["jax"][2], atol=FP32_ATOL,
                               rtol=0)


@pytest.mark.parametrize("path,zero,gas", [
    ("fused", {"stage": 0}, 1),
    ("split", {"stage": 0}, 2),
    ("offload", {"stage": 1, "offload_optimizer": {"device": "cpu"}}, 1),
    ("infinity", {"stage": 3, "offload_param": {"device": "cpu"}}, 2)])
def test_every_step_path_reports(path, zero, gas, tmp_path):
    """Each of the engine's step paths goes through step(): a step event
    with its spans, a watchdog beat and a `dispatch.*` span or not (the
    streamed path runs no step function) on the trace, the timers' line
    (none on the streamed path) and the TensorBoard scalars, a step."""
    from convergence_common import synthetic_batches

    cfg = dict(_cfg(tmp_path), train_micro_batch_size_per_gpu=MICRO // gas,
               zero_optimization=zero, steps_per_print=1)
    cfg.pop("flops_profiler")
    if path == "infinity":    # the streamed path needs a dropout-free GPT
        eng, *_ = dt.initialize(
            model=GPT(gpt2_config("nano", max_seq_len=SEQ, vocab_size=VOCAB,
                                  dropout=0.0), device="cpu"),
            config_params=cfg, device="cpu")
    else:
        eng = _port_engine(cfg, _tree()[1])
    writer = _attach_tb(eng, TensorBoardMonitor)
    lines = LogLines()
    lg = logging.getLogger("deepspeed_tpu_torch")
    lg.addHandler(lines)
    try:
        for x, y in synthetic_batches(2 * gas, MICRO // gas, SEQ, VOCAB, 1):
            eng.forward((x, y))
            eng.backward()
            eng.step()
    finally:
        lg.removeHandler(lines)
        eng.finalize_monitoring()
    run = str(tmp_path / "run")
    steps = [e for e in _events(run) if e["type"] == "step"]
    assert [e["step"] for e in steps] == [1, 2]
    assert all("forward" in e["spans_ms"] and np.isfinite(e["loss"])
               for e in steps)
    names = [n for n, _ in _trace_names(run, tracing.read_trace_file)]
    assert names.count("watchdog_beat") == 2
    assert any(n.startswith("dispatch.") for n in names) != \
        (path == "infinity")
    # the streamed micro step runs no timer (engine.py:1832-1854): its
    # boundary logs no line, as in JAX
    assert len(_timer_layout(lines.lines)) == (0 if path == "infinity"
                                               else 2)
    assert sum(tag == "Train/Samples/train_loss"
               for tag, _, _ in writer.rows) == 2


def test_flops_profiler_and_monitor_flops(runs):
    te = runs["port"]["eng"]
    stats = te._flops_stats
    assert stats["flops"] == te.run_monitor.flops_per_step > 0
    assert stats["params"] == sum(p.numel() for p in te.module.parameters())
    ev = [e for e in _events(runs["port"]["dir"]) if e["type"] == "flops"]
    assert ev == [dict(ev[0], flops_per_step=stats["flops"])]


# -- monitoring changes no bit ---------------------------------------------------


def _trained(cfg, tree, tb=False):
    eng = _port_engine(cfg, tree)
    if tb:
        _attach_tb(eng, TensorBoardMonitor)
    losses = [eng.train_batch() for _ in range(STEPS)]
    eng.finalize_monitoring()
    return ([float(x) for x in losses],
            {n: p.detach().clone() for n, p in eng.params.items()})


def test_monitoring_changes_no_bit(tmp_path):
    """Under deterministic algorithms (the embedding backward's row sums
    are in any order otherwise, on the CPU too)."""
    _, tree = _tree(seed=5)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        on = _trained(_cfg(tmp_path), tree, tb=True)
        off = _trained(_cfg(everything=False), tree)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert on[0] == off[0]
    assert all(torch.equal(on[1][n], off[1][n]) for n in off[1])


# -- flops ------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["dense", "kernels"])
def test_product_flops_equal_jax_dot_general(impl):
    """One micro step, forward and backward, at S 128 (a multiple of the
    flash blocks).  The kernels' path credits the dense path's products
    (causal attention as the full square) and leaves out its plain
    versions' own loops, so the count is the same; the JAX total adds
    XLA's elementwise work (softmax, norms, GELU: 8% here), which the
    port's product count leaves out — held within [0.85, 1]."""
    from deepspeed_tpu.profiling.flops_profiler.profiler import \
        analyze_fn as janalyze
    from deepspeed_tpu_torch.profiling.flops_profiler.profiler import \
        analyze_fn

    S, V = 128, 512
    jm = JaxGPT(jax_gpt2_config("nano", max_seq_len=S, vocab_size=V,
                                shard_activations=False))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jm.init(jax.random.PRNGKey(0)))
    toks = np.random.RandomState(0).randint(0, V, (2, S + 1))
    x, y = toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
    js = janalyze(lambda p: jax.value_and_grad(
        lambda q: jm.loss(q, (jnp.asarray(x), jnp.asarray(y)),
                          train=True))(p),
        jax.tree_util.tree_map(jnp.asarray, tree))
    over = ({} if impl == "dense"
            else dict(attn_impl="pallas", loss_impl="pallas"))
    model = GPT(gpt2_config("nano", max_seq_len=S, vocab_size=V, **over),
                device="cpu")
    load_jax_params(model, tree)

    def step():
        loss = model.loss((x, y))
        loss.backward()
        return loss

    ts = analyze_fn(step)
    assert ts["flops"] == js["by_primitive"]["dot_general"]
    if impl == "kernels":
        assert {"flash_attention_fwd", "flash_attention_dq",
                "flash_attention_dkv", "fused_xent_fwd", "fused_xent_dx",
                "fused_xent_dw"} <= set(ts["by_primitive"])
    assert 0.85 <= ts["flops"] / js["flops"] <= 1.0


# -- two ranks --------------------------------------------------------------------


def _rank_job(out_dir):
    """One rank of the gloo world: nano, 3 steps, heartbeats every step,
    rank 1 asleep 1.5 s in its first step's tail."""
    import time

    from deepspeed_tpu_torch.comm import dist
    from deepspeed_tpu_torch.monitor.counters import COUNTERS

    cfg = _cfg(everything=False, micro=MICRO // 2)
    cfg["monitor"] = {"enabled": True, "output_path": out_dir,
                      "job_name": "run", "heartbeat_interval": 1,
                      "straggler_factor": 0.5, "flops": False,
                      "tracing": {"enabled": True}}
    eng = _port_engine(cfg, None)
    if dist.get_rank() == 1:
        finish = eng._finish_step

        def slow(overflow):
            finish(overflow)
            if eng.global_steps == 1:
                time.sleep(1.5)

        eng._finish_step = slow
    for _ in range(STEPS):
        eng.train_batch()
    eng.finalize_monitoring()
    return COUNTERS.totals().get("hostwire.allgather", {})


def _world_worker(rank, store, out_dir):
    torch.set_num_threads(1)
    from deepspeed_tpu_torch.comm import dist

    dt.init_distributed(init_method=f"file://{store}", world_size=2,
                        rank=rank, device="cpu", verbose=False)
    try:
        res = _rank_job(out_dir)
    finally:
        dist.barrier()
        dist.destroy()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _two_ranks(d):
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_world_worker,
                         args=(r, str(d / "store"), str(d)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(240)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive and all(p.exitcode == 0 for p in procs)
    run = os.path.join(str(d), "run")
    out = {"summary": json.load(open(os.path.join(run, "summary.json"))),
           "events": _events(run),
           "metas": [tracing.read_trace_file(os.path.join(
               run, f"trace.rank{r:05d}.jsonl"))[0][0][0] for r in range(2)],
           "allgathers": [json.load(open(d / f"rank{r}.json"))
                          for r in range(2)]}
    return out


def test_two_ranks_summary_heartbeat_and_clock_sync(tmp_path_factory):
    """JAX's straggler rule flags ranks above `straggler_factor` x the
    median, the upper middle of the sorted step times; at two ranks that
    is the slower one's own time, so the factor is set below 1 (0.5)."""
    res = run_once(tmp_path_factory, "torch_monitor_world2", _two_ranks)
    assert [r["rank"] for r in res["summary"]["ranks"]] == [0, 1]
    assert all(r["steps"] == STEPS for r in res["summary"]["ranks"])
    beats = [e for e in res["events"] if e["type"] == "heartbeat"]
    assert [b["step"] for b in beats] == [1, 2, 3]
    assert beats[0]["stragglers"] == [1]
    assert sorted(b["rank"] for b in beats[0]["beats"]) == [0, 1]
    for meta in res["metas"]:
        assert meta["world"] == 2 and meta["skew_est_s"] is not None
    # clock sync + 3 heartbeats + the summary merge, on each rank
    assert [a["calls"] for a in res["allgathers"]] == [5, 5]

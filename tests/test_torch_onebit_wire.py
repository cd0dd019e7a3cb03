"""Port parity at world 2: the compressed collectives
(runtime/comm/compressed.py) and 1-bit Adam / LAMB on the engine's
compressed path (`engine._use_onebit_comm`, step_builder's onebit step).

The port's ranks are a spawned gloo world on the CPU, made once a test
session and shared through the file lock of tests/test_torch_qgz.py
(`run_once`); JAX runs in a subprocess with 2 XLA host devices (its
shard_map'd `compressed_allreduce` / `int8_compressed_allreduce` and its
`_build_onebit_step` on the int8 wire).  chip_smoke.py's
`onebit_wire_model` (the numpy model its `onebit-exact` gate uses) is
held to JAX's collectives here, and every compressed call of the port's
engines to it.  Tolerances, with their reasons:

* the mean over the two ranks: the port's all-reduce sum / 2 and JAX's
  pmean are both exact at world 2 (one addition, a halving), so the int8
  wire is bitwise JAX's, each rank's output and errors (XLA's algebraic
  simplifier turns JAX's `amax / 127` into a reciprocal product, an ulp
  off; the wire's JAX process runs without it, as tests/test_torch_zero3
  does for qwZ);
* the sign wire: the scales mean(|c|) are summed in fp64 by the port and
  in fp32 by XLA, an ulp of each scale: outputs 2e-6 relative, errors
  atol 5e-7 (differences of nearly equal numbers, |c| < 2);
* every compressed call of the port's engines (both wires, Adam's one
  flat buffer and LAMB's per-leaf calls): bitwise the numpy model of the
  two ranks' gathered inputs and errors;
* the int8 engines against JAX's, 4 steps (2 warm, 2 compressed), fp32:
  loss atol 1e-4 at every step, the final weights and each rank's
  worker / server errors atol 1e-4 (tests/test_torch_train.py's bound
  for Adam's normalised steps) except for at most 1% of all the
  elements and 5% of each leaf's — each rank's gradients sum in other
  orders, and an int8 code at a rounding boundary moves by one step
  where its input differs by an ulp, which the error feedback carries
  on (3.3e-5 of loss; 1-bit Adam's parameters 2.3% of a 2304-element
  leaf and 2 of 48, its errors 2.1% seen; LAMB's none).  The outliers
  are bounded too: a parameter by lr · max_coeff a step (after the
  freeze 1-bit Adam's step m / (sqrt(v) + eps) has no bound of its own
  where the frozen v is tiny; 5.6 lr over the run seen), an error by
  twice its leaf's largest (one quantization step of its group; 2.0x
  seen);
* LAMB over parameter slices (ZeRO stage 1, 2 and 3, and a client
  FusedLamb at stage 1, over the two ranks: each rank's slices' squared
  norms summed over the data axis) against the same engine at world 1
  on the global batches: each rank's half-batch mean summed and halved
  against the whole batch's mean, fp32 sums in another order, no
  quantization: loss atol 1e-4, every element atol 1e-6 (4.8e-7 of loss
  and 9.6e-8 seen; trust ratios of the slices, not summed over the
  ranks, move them by 4.7e-6); 1-bit Adam and LAMB there are refused;
* the sign engines: JAX's sign-wire step crashes XLA:CPU (SIGSEGV) in
  most runs on this JAX (ROADMAP queue 3), so they are held to the numpy
  model above and their warm-up losses to the int8 runs' bit for bit.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_qgz import run_once  # noqa: E402

torch.set_num_threads(1)

WORLD_TIMEOUT_S = 300
STEPS = 4
WIRE_N = (37, 2048 * 2 + 5)     # a small buffer and two int8 groups + 5
OPTS = {"adam-sign": ("OneBitAdam", "sign"), "adam-int8": ("OneBitAdam",
                                                            "int8"),
        "lamb-sign": ("OneBitLamb", "sign"), "lamb-int8": ("OneBitLamb",
                                                            "int8")}


def _chip_smoke():
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_onebit", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wire_inputs():
    rs = np.random.RandomState(11)
    out = {}
    for n in WIRE_N:
        for k in ("x", "we", "se"):
            scale = 1.0 if k == "x" else 1e-2
            out[f"{n}:{k}"] = (rs.randn(2, n) * scale).astype(np.float32)
    return out


def _tree():
    import jax

    from deepspeed_tpu.models import GPT as JaxGPT
    from deepspeed_tpu.models import gpt2_config as jax_gpt2_config

    jm = JaxGPT(jax_gpt2_config("nano", max_seq_len=32, vocab_size=64,
                                shard_activations=False))
    return jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(7)))


def _batches():
    rs = np.random.RandomState(9)
    t = rs.randint(0, 64, (STEPS, 8, 33)).astype(np.int32)
    return [(b[:, :-1], b[:, 1:]) for b in t]


def _cfg(opt, wire):
    return {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
            "optimizer": {"type": opt, "params": {
                "lr": 3e-3, "freeze_step": 2, "wire": wire,
                "weight_decay": 0.01}},
            "steps_per_print": 0}


# -- the port's world ---------------------------------------------------------


def _worker(rank, world, store, inputs, out_dir):
    torch.set_num_threads(1)
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.comm import dist
    from deepspeed_tpu_torch.comm.mesh import make_mesh
    from deepspeed_tpu_torch.models import GPT, gpt2_config
    from deepspeed_tpu_torch.runtime.comm import compressed as tc

    dt.init_distributed(init_method=f"file://{store}", world_size=world,
                        rank=rank, device="cpu", verbose=False)
    res = {}
    try:
        make_mesh(data=-1)
        for n in WIRE_N:
            for wire, fn in (("sign", tc.compressed_allreduce),
                             ("int8", tc.int8_compressed_allreduce)):
                x, we, se = (torch.from_numpy(inputs["wire"][f"{n}:{k}"][rank])
                             for k in ("x", "we", "se"))
                # two rounds: the second feeds the first's errors back
                for it in range(2):
                    out, we, se = fn(x, we, se, "data")
                    for k, v in (("out", out), ("we", we), ("se", se)):
                        res[f"wire:{n}:{wire}:{it}:{k}"] = v.numpy().copy()
        cs = _chip_smoke()
        for name, (opt, wire) in OPTS.items():
            model = GPT(gpt2_config("nano", max_seq_len=32, vocab_size=64),
                        device="cpu")
            eng, *_ = dt.initialize(model=model,
                                    model_parameters=inputs["tree"],
                                    config_params=_cfg(opt, wire),
                                    device="cpu")
            assert eng._onebit_hot
            losses = []
            with cs.OnebitWireCheck() as check:
                for b in inputs["batches"]:
                    losses.append(float(eng.forward(b)))
                    eng.backward()
                    eng.step()
            res[f"{name}:losses"] = np.asarray(losses)
            res[f"{name}:check"] = np.asarray(
                [check.calls, check.elements, check.mismatches])
            res[f"{name}:leaves"] = np.asarray(len(eng._param_names))
            for n, v in eng.module_state_dict().items():
                res[f"{name}:param:{n}"] = v
            for k, v in eng._opt_state.items():
                if isinstance(v, list):
                    for n, t in zip(eng._param_names, v):
                        res[f"{name}:{k}:{n}"] = t.numpy().copy()
        for name, (opt, stage) in Z1_OPTS.items():
            res.update(_z1_run(name, opt, stage, inputs))
        for opt in ("OneBitAdam", "OneBitLamb"):
            try:
                _z1_run(opt, opt, 1, inputs)
            except NotImplementedError as e:
                res[f"refused:{opt}"] = np.asarray(str(e))
    finally:
        dist.barrier()
        dist.destroy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


# LAMB over parameter slices: the config's, at ZeRO stage 1, 2 and 3, and a
# client FusedLamb handed to initialize() at stage 1
Z1_OPTS = {"lamb-z1": ("Lamb", 1), "lamb-z2": ("Lamb", 2),
           "lamb-z3": ("Lamb", 3), "client-lamb-z1": ("client", 1)}


def _z1_run(name, opt, stage, inputs):
    """`opt` at ZeRO `stage` (at world 1 without a process group) on the
    global batches -> losses and masters."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.comm import dist
    from deepspeed_tpu_torch.models import GPT, gpt2_config
    from deepspeed_tpu_torch.ops.lamb import FusedLamb

    # the int8 wire: the sign wire at freeze_step 2 diverges (m / sqrt(v)
    # with a v of two steps), which no fp32 bound holds
    cfg = _cfg(opt, "int8")
    client = None
    if opt == "client":
        del cfg["optimizer"]
        client = FusedLamb(lr=3e-3, weight_decay=0.01)
    elif opt == "Lamb":
        cfg["optimizer"]["params"] = {"lr": 3e-3, "weight_decay": 0.01}
    cfg["zero_optimization"] = {"stage": stage}
    cfg["zero_allow_untested_optimizer"] = True
    world = dist.get_world_size() if dist.is_initialized() else 1
    cfg["train_micro_batch_size_per_gpu"] = 8 // world
    eng, *_ = dt.initialize(model=GPT(gpt2_config("nano", max_seq_len=32,
                                                  vocab_size=64),
                                      device="cpu"),
                            model_parameters=inputs["tree"],
                            optimizer=client, config_params=cfg,
                            device="cpu")
    # over two ranks the update gets slices and sums their norms
    assert world == 1 or (eng.zero_plan.partitioned
                          and any(eng.optimizer.norm_axes))
    out = {}
    losses = []
    for b in inputs["batches"]:
        losses.append(float(eng.forward(b)))
        eng.backward()
        eng.step()
    out[f"{name}:losses"] = np.asarray(losses)
    for n, v in eng.module_state_dict().items():
        out[f"{name}:param:{n}"] = v
    return out


JAX_PARTS = ("wire", "adam-int8", "lamb-int8")


def _jax_oracle(tmp):
    """JAX's side: the wire and each int8 engine, a subprocess each."""
    from deepspeed_tpu_torch.models.convert import flatten_tree

    inp = tmp / "jin.npz"
    flat = flatten_tree(_tree())
    b = _batches()
    np.savez(inp, **_wire_inputs(),
             **{f"tree:{k}": v for k, v in flat.items()},
             **{f"batch:{i}:{j}": a for i, bb in enumerate(b)
                for j, a in enumerate(bb)})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = (_JAX_ORACLE.replace("__WIRE_N__", repr(WIRE_N))
              .replace("__OPTS__", repr(OPTS))
              .replace("__STEPS__", repr(STEPS))
              .replace("__CFG__", repr(_cfg("OPT", "WIRE"))
                       .replace("'OPT'", "opt").replace("'WIRE'", "wire")))
    # one process a part, run together (two JAX engines in one process
    # trip over each other's meshes); the wire without XLA's algebraic
    # simplifier, the engines with it (they do not compile without it);
    # XLA:CPU at the suite's O0 (conftest.py); no torch in the process
    procs = {}
    for part in JAX_PARTS:
        extra = " --xla_disable_hlo_passes=algsimp" if part == "wire" else ""
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=2 "
                   "--xla_backend_optimization_level=0" + extra,
                   PYTHONPATH=root + os.pathsep +
                   os.environ.get("PYTHONPATH", ""))
        out = tmp / f"jout-{part}.npz"
        procs[part] = (subprocess.Popen(
            [sys.executable, "-c", script, str(inp), str(out), part],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), out)
    got = {}
    for part, (proc, out) in procs.items():
        log, _ = proc.communicate(timeout=WORLD_TIMEOUT_S)
        assert proc.returncode == 0, (part, proc.returncode,
                                      log.decode()[-3000:])
        got.update(dict(np.load(out)))
    return got


_JAX_ORACLE = r"""
import sys
from functools import partial
import numpy as np
import jax, jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from jax.sharding import PartitionSpec as P
import deepspeed_tpu
from deepspeed_tpu.comm.mesh import make_mesh
from deepspeed_tpu.models import GPT, gpt2_config
from deepspeed_tpu.runtime.comm import compressed as jc

WIRE_N, OPTS, STEPS = __WIRE_N__, __OPTS__, __STEPS__


def _cfg(opt, wire):
    return __CFG__


def flatten_tree(t, prefix=""):
    if isinstance(t, dict):
        items = t.items()
    elif isinstance(t, (list, tuple)):
        items = enumerate(t)
    else:
        return {prefix: t}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten_tree(flat):
    root = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and set(out) == {str(i) for i in range(len(out))}:
            return [out[str(i)] for i in range(len(out))]
        return out
    return listify(root)


z = dict(np.load(sys.argv[1]))
parts = sys.argv[3].split(",")
out = {}
mesh = make_mesh(data=2).mesh
for n in (WIRE_N if "wire" in parts else ()):
    for wire, fn in (("sign", jc.compressed_allreduce),
                     ("int8", jc.int8_compressed_allreduce)):
        @partial(jax.shard_map, mesh=mesh, in_specs=(P("data"),) * 3,
                 out_specs=(P("data"),) * 3, check_vma=False)
        def run(x, we, se, fn=fn):
            o, w, s = fn(x[0], we[0], se[0], "data")
            return o[None], w[None], s[None]
        x, we, se = (jnp.asarray(z[f"{n}:{k}"]) for k in ("x", "we", "se"))
        for it in range(2):
            o, we, se = jax.jit(run)(x, we, se)
            for k, v in (("out", o), ("we", we), ("se", se)):
                out[f"wire:{n}:{wire}:{it}:{k}"] = np.asarray(v)
tree = unflatten_tree({k[5:]: v for k, v in z.items()
                       if k.startswith("tree:")})
batches = [(z[f"batch:{i}:0"], z[f"batch:{i}:1"]) for i in range(STEPS)]
for name, (opt, wire) in OPTS.items():
    if name not in parts:
        continue
    model = GPT(gpt2_config("nano", max_seq_len=32, vocab_size=64,
                            shard_activations=False))
    eng, *_ = deepspeed_tpu.initialize(model=model, model_parameters=tree,
                                       config_params=_cfg(opt, wire))
    losses = []
    for b in batches:
        losses.append(float(eng.forward(b)))
        eng.backward()
        eng.step()
    assert eng._onebit_hot
    out[f"{name}:losses"] = np.asarray(losses)
    for k, v in flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                    eng.params)).items():
        out[f"{name}:param:{k}"] = v
    for k, tree in eng._opt_state.items():
        if not isinstance(tree, (dict, list)):
            continue
        for n, v in flatten_tree(jax.tree_util.tree_map(
                np.asarray, tree)).items():
            out[f"{name}:{k}:{n}"] = v
np.savez(sys.argv[2], **out)
"""


def _world(tmp):
    import multiprocessing as mp

    import threading

    jax_side = {}

    def run_jax():
        try:
            jax_side["out"] = _jax_oracle(tmp)
        except BaseException as e:   # raised below, in the test's thread
            jax_side["error"] = e

    oracle = threading.Thread(target=run_jax)
    oracle.start()
    inputs = {"wire": _wire_inputs(), "tree": _tree(),
              "batches": _batches()}
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, 2, str(tmp / "store"), inputs, str(tmp)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(WORLD_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    oracle.join()
    assert not alive, f"world 2 did not finish in {WORLD_TIMEOUT_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    if "error" in jax_side:
        raise jax_side["error"]
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return {"ranks": ranks, "jax": jax_side["out"]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_once(tmp_path_factory, "onebit-world2", _world)


@pytest.mark.parametrize("n", WIRE_N)
@pytest.mark.parametrize("wire", ["sign", "int8"])
def test_compressed_allreduce_matches_jax_on_each_rank(world, wire, n):
    j = world["jax"]
    for r, got in enumerate(world["ranks"]):
        for it in range(2):
            key = f"wire:{n}:{wire}:{it}"
            for k in ("out", "we", "se"):
                a, b = got[f"{key}:{k}"], j[f"{key}:{k}"][r]
                if wire == "int8":
                    assert np.array_equal(a, b), (r, it, k)
                elif k == "out":
                    np.testing.assert_allclose(a, b, rtol=2e-6, atol=0)
                else:
                    np.testing.assert_allclose(a, b, rtol=0, atol=5e-7)
    if wire == "int8":
        # the owners' rows gathered: the same result on both ranks (the
        # sign wire's differs where the ranks' server errors differ)
        ranks = world["ranks"]
        for it in range(2):
            key = f"wire:{n}:{wire}:{it}:out"
            assert np.array_equal(ranks[0][key], ranks[1][key])


@pytest.mark.parametrize("n", WIRE_N)
@pytest.mark.parametrize("wire", ["sign", "int8"])
def test_the_numpy_wire_model_matches_jax(world, wire, n):
    """chip_smoke's `onebit_wire_model` (the onebit-exact gate's oracle)
    on the two ranks' inputs gives JAX's outputs and errors."""
    model = _chip_smoke().onebit_wire_model
    inp, j = _wire_inputs(), world["jax"]
    xs, wes, ses = ([inp[f"{n}:{k}"][r] for r in range(2)]
                    for k in ("x", "we", "se"))
    for it in range(2):
        got = model(xs, wes, ses, wire)
        for r in range(2):
            for (k, a) in zip(("out", "we", "se"), got[r]):
                b = j[f"wire:{n}:{wire}:{it}:{k}"][r]
                if wire == "int8":
                    assert np.array_equal(a, b), (r, it, k)
                elif k == "out":
                    np.testing.assert_allclose(a, b, rtol=2e-6, atol=0)
                else:
                    np.testing.assert_allclose(a, b, rtol=0, atol=5e-7)
        wes = [g[1] for g in got]
        ses = [g[2] for g in got]


@pytest.mark.parametrize("broken", [False, True])
def test_the_wire_check_holds_the_selected_calls(monkeypatch, broken):
    """OnebitWireCheck at world 1 (no process group): `select` picks the
    calls held to the model by their index in the context, every call is
    counted in `seen`, and a wrong output is counted as mismatches."""
    from deepspeed_tpu_torch.runtime.fp16.onebit import adam as ob

    if broken:
        real = ob.int8_compressed_allreduce

        def off_by_one_code(x, we, se, axis):
            out, we, se = real(x, we, se, axis)
            return out.clone().index_add_(0, torch.tensor([0]),
                                          torch.ones(1)), we, se

        monkeypatch.setattr(ob, "int8_compressed_allreduce", off_by_one_code)
    rs = np.random.RandomState(0)
    x, we, se = (torch.from_numpy(rs.randn(3000).astype(np.float32))
                 for _ in range(3))
    with _chip_smoke().OnebitWireCheck(select=lambda k: k % 3 == 1) as check:
        for _ in range(7):
            out, we, se = ob.int8_compressed_allreduce(x, we, se, None)
            out, we, se = ob.compressed_allreduce(x, we, se, None)
    # calls 1, 4, 7, 10 and 13 of 14: int8 at 4 and 10, sign at the rest
    assert (check.seen, check.calls, check.elements) == (14, 5, 5 * 3 * 3000)
    assert check.mismatches == (2 if broken else 0)


@pytest.mark.parametrize("name", list(OPTS))
def test_every_compressed_call_of_the_engines_is_the_numpy_model(world,
                                                                 name):
    for got in world["ranks"]:
        calls, elements, mismatches = got[f"{name}:check"]
        # the frozen steps 3 and 4: Adam one flat buffer, LAMB per leaf
        per_step = 1 if name.startswith("adam") else int(got[f"{name}:leaves"])
        assert calls == (STEPS - 2) * per_step
        assert elements > 0 and mismatches == 0
    a, b = world["ranks"]
    for k in a:
        if k.startswith(f"{name}:param:"):
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("name", ["adam-int8", "lamb-int8"])
def test_int8_engine_steps_and_each_ranks_errors_match_jax(world, name):
    j = world["jax"]
    for r, got in enumerate(world["ranks"]):
        for what in ("param", "worker_error", "server_error"):
            keys = [k for k in j if k.startswith(f"{name}:{what}:")]
            # JAX keeps the errors stacked (dp, ...); rank r's is row r
            want_of = ((lambda k: j[k]) if what == "param"
                       else (lambda k, r=r: j[k][r]))
            _assert_tracks(got, j, name, keys, want_of,
                           PARAMS_OUTLIER if what == "param"
                           else ERRORS_OUTLIER)


# the int8 engines' outliers (module docstring): a parameter moves at
# most lr · max_coeff a step further; an error by one quantization step
# of its group, at most twice the largest error of its leaf
PARAMS_OUTLIER = ("lr", 3e-3 * 10 * STEPS)
ERRORS_OUTLIER = ("errors", 2.0)


def _assert_tracks(got, want, name, keys, want_of, outlier=None,
                   atol=1e-4):
    """Losses atol 1e-4 at every step; every element of the leaves `keys`
    within `atol`, except, with an `outlier` bound, at most 1% of all the
    elements and 5% of each leaf's, each within that bound (the module
    docstring)."""
    np.testing.assert_allclose(got[f"{name}:losses"], want[f"{name}:losses"],
                               atol=1e-4, rtol=0)
    assert keys
    off = total = 0
    for k in keys:
        ref = want_of(k)
        diff = np.abs(got[k] - ref)
        bad = diff > atol
        off, total = off + int(bad.sum()), total + diff.size
        if outlier is None:
            assert not bad.any(), (name, k, float(diff.max()))
            continue
        assert bad.mean() <= 0.05, (name, k, float(bad.mean()))
        kind, bound = outlier
        limit = (bound if kind == "lr"
                 else bound * float(np.abs(ref).max()) + 1e-4)
        assert float(diff.max()) <= limit, (name, k, float(diff.max()),
                                            limit)
    assert off <= 0.01 * total, (name, off, total)


@pytest.mark.parametrize("name", list(Z1_OPTS))
def test_whole_leaf_optimizers_at_zero1_are_world1(world, name):
    """LAMB's trust ratios read whole leaves: over two ranks at ZeRO
    stage 1, 2 and 3 (and a client FusedLamb at stage 1) the update gets
    this rank's slices and sums their squared norms over the data ranks,
    and computes world 1's function."""
    inputs = {"tree": _tree(), "batches": _batches()}
    opt, stage = Z1_OPTS[name]
    want = _z1_run(name, opt, stage, inputs)
    keys = [k for k in want if k.startswith(f"{name}:param:")]
    for got in world["ranks"]:
        _assert_tracks(got, want, name, keys, lambda k: want[k], atol=1e-6)


@pytest.mark.parametrize("opt", ["OneBitAdam", "OneBitLamb"])
def test_onebit_over_parameter_slices_is_refused(world, opt):
    """1-bit's compressed statistics read the whole tree: at ZeRO stage 1
    over two ranks the engine refuses it, naming the ROADMAP item."""
    for got in world["ranks"]:
        msg = str(got[f"refused:{opt}"])
        assert "ZeRO stage 1 over 2 ranks" in msg
        assert "ROADMAP queue 1" in msg


@pytest.mark.parametrize("opt", ["adam", "lamb"])
def test_sign_engines_warm_up_as_the_int8_runs(world, opt):
    """The first three losses come before any compressed update: the sign
    and int8 runs are bitwise there."""
    for got in world["ranks"]:
        assert np.array_equal(got[f"{opt}-sign:losses"][:3],
                              got[f"{opt}-int8:losses"][:3])

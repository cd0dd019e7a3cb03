"""Port parity: expert-parallel MoE over the explicit all-to-all wire —
moe/dispatch.py (`A2APlan`, `build_a2a_plan`, `_hop_a2a`,
`wire_all_to_all`, `wire_engagement`), moe/layer.py `_sorted_wire`, the
engine's expert-sharded leaves (runtime/engine.py, step_builder.py,
zero/partition.py) and their checkpoints.

The port's worlds are spawned gloo processes on the CPU (`file://`
stores under pytest's temp root), once a session and world
(tests/test_torch_qgz.py `run_once`).  JAX's
`_sorted_wire` runs in a subprocess with as many XLA host devices as the
port has ranks (the harness's 8-device mesh cannot hold a 2- or 4-wide
data axis), with `counters=False` (its counter callback does not lower
inside the wire's shard_map on this JAX; the counters are held to
`A2APlan`, plain Python).  Tolerances, with their reasons:

* the plan, the engagement decisions, the counters: exact;
* `_hop_a2a` int8 / int4: bitwise against JAX's per-chunk composition
  `quantize_blockwise_ref` -> `pack_wire` -> `unpack_wire` ->
  `dequantize_blockwise_ref` of the chunk each source rank sent;
* the layer against JAX's wire at the same ep (y, aux, every gradient):
  fp32 1e-5 relative to each tensor's largest magnitude (fp32 products
  of two libraries); bf16 2e-2, int8 5e-2, int4 0.5 (JAX's own
  `test_wire_parity_flat_mesh` bounds: a value on a rounding boundary of
  the wire may round the other way when the two libraries' inputs differ
  in the last bit);
* the MoE GPT at world N against world 1 through the fp32 wire: losses
  1e-6 relative a step, masters 1e-5 (the same function, the expert
  products over another row count and the gradients summed in another
  order); through int8 against the fp32 wire: JAX's engine-level bound
  for that wire, losses within 5e-2, masters within 2 × steps × lr
  (Adam's normalized step); the bucketed reduction (the wire falls
  back to the local dispatch) and the implicit exchange: the fp32 bounds;
  dropless: masters 5e-5 (its overflow segments' expert products run
  over a rank's rows only, so the forward's fp32 sums reassociate too,
  and Adam's normalized step magnifies a near-zero gradient's change);
* the tag: the JAX engine's fp32 cross-engine bound 1e-5 a step
  (tests/test_torch_checkpoint.py), the port at world 1 1e-6 relative.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

WORLD_TIMEOUT_S = 300
STEPS = 3
LAYER = dict(d=8, f=16, E=8, k=2, B=8, S=12)
MOE_MODEL = dict(num_layers=2, num_experts=8, moe_top_k=2, vocab_size=64,
                 max_seq_len=16)
_LAYER_TOL = {"fp32": 1e-5, "bf16": 2e-2, "int8": 5e-2, "int4": 0.5}
_CASES = {2: ["fp32-auto", "bf16-auto", "int8-auto", "int4-auto"],
          4: ["fp32-data", "fp32-inner", "fp32/int8-data", "int4-inner"]}


def _wire_kwargs(wire, placement):
    """A case's comm.moe selection: one wire, or inner/outer wires."""
    kw = {"dispatch": "sorted", "quant_block_size": 16,
          "placement": placement}
    if "/" in wire:
        kw["a2a_wire_dtype_inner"], kw["a2a_wire_dtype_outer"] = \
            wire.split("/")
    else:
        kw["a2a_wire_dtype"] = wire
    return kw


def _layer_inputs():
    rs = np.random.RandomState(0)
    d, f, E, B, S = (LAYER[k] for k in ("d", "f", "E", "B", "S"))
    return {"gate": (rs.randn(d, E) * 0.5).astype(np.float32),
            "w1": (rs.randn(E, d, f) * d ** -0.5).astype(np.float32),
            "b1": (rs.randn(E, f) * 0.1).astype(np.float32),
            "w2": (rs.randn(E, f, d) * f ** -0.5).astype(np.float32),
            "b2": (rs.randn(E, d) * 0.1).astype(np.float32),
            "x": rs.randn(B, S, d).astype(np.float32),
            "gy": rs.randn(B, S, d).astype(np.float32)}


def _no_noise():
    """Gate noise off in the port's GPT (its MoE config built with
    noisy_gate_std 0), for comparisons with the JAX engine."""
    from deepspeed_tpu_torch.models import gpt as tgpt
    from deepspeed_tpu_torch.moe import layer as tlayer

    tgpt.GPTConfig.moe_config = lambda self: tlayer.MoEConfig(
        d_model=self.d_model, d_ff=self.d_ff, num_experts=self.num_experts,
        top_k=self.moe_top_k, capacity_factor=self.moe_capacity_factor,
        noisy_gate_std=0.0)


# -- the spawned jobs ---------------------------------------------------------


def _layer_job(job):
    """This rank's rows through the layer under each case's wire: y, aux
    and the gradients of sum(y · gy) + aux / world (the ranks' sum is
    JAX's global objective)."""
    from deepspeed_tpu_torch.comm import dist
    from deepspeed_tpu_torch.moe import dispatch as tdsp
    from deepspeed_tpu_torch.moe import layer as tlayer
    from deepspeed_tpu_torch.monitor.counters import COUNTERS

    inp = job["inputs"]
    world, rank = dist.get_world_size(), dist.get_rank()
    B = inp["x"].shape[0]
    Bl = B // world
    cfg = tlayer.MoEConfig(d_model=LAYER["d"], d_ff=LAYER["f"],
                           num_experts=LAYER["E"], top_k=LAYER["k"],
                           capacity_factor=2.0, min_capacity=1,
                           noisy_gate_std=0.0)
    out = {}
    for case in job["cases"]:
        params = tlayer.MoEParams(*(torch.tensor(inp[n]) for n in
                                    ("gate", "w1", "b1", "w2", "b2")))
        x = torch.tensor(inp["x"][rank * Bl:(rank + 1) * Bl],
                         requires_grad=True)
        gy = torch.tensor(inp["gy"][rank * Bl:(rank + 1) * Bl])
        snap = COUNTERS.snapshot()
        with tdsp.moe_wire(**_wire_kwargs(*case.split("-"))):
            y, aux = tlayer.MoE(cfg)(params, x, train=True,
                                     row_offset=rank * Bl, batch_rows=B)
            ((y * gy).sum() + aux / world).backward()
        d = COUNTERS.delta_since(snap)
        out[case] = {"y": y.detach().numpy(), "aux": float(aux),
                     "gx": x.grad.numpy(),
                     "grads": {n: p.grad.numpy() for n, p in
                               params.named_parameters()},
                     "a2a": {k: v for k, v in d.items()
                             if k.startswith("moe.a2a")}}
    return out


def _hop_job(job):
    """`_hop_a2a` on this rank's buffers: int8 / int4, fp32 / bf16, a
    chunk that blocks divide and one they do not."""
    from deepspeed_tpu_torch.comm import dist
    from deepspeed_tpu_torch.moe import dispatch as tdsp

    rank = dist.get_rank()
    out = {}
    for key, buf in job["bufs"][rank].items():
        wire, dtype = key.split("-")[:2]
        t = torch.tensor(buf).to(getattr(torch, dtype))
        plan = tdsp.A2APlan(hops=(tdsp.A2AHop("data", 0, 2, wire, False),),
                            ep=2, local_elems=t.numel(), quant_block=16)
        got = tdsp._hop_a2a(t, plan.hops[0], plan, record=False)
        out[key] = got.float().numpy()
    return out


def _engine_job(job):
    """A MoE GPT nano engine run -> losses, masters, counters, the
    fallback messages logged and the expert shapes a rank holds."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import GPT, gpt2_config
    from deepspeed_tpu_torch.moe import dispatch as tdsp
    from deepspeed_tpu_torch.monitor.counters import COUNTERS

    if job.get("no_noise"):
        _no_noise()
    logged = []
    real = tdsp.logger

    class _Log:
        def __getattr__(self, name):
            fn = getattr(real, name)

            def log(msg, *a, **kw):
                logged.append(str(msg))
                return fn(msg, *a, **kw)
            return log

    tdsp.logger = _Log()
    tdsp._warned.clear()
    try:
        model = GPT(gpt2_config("nano", **MOE_MODEL), device="cpu",
                    generator=torch.Generator().manual_seed(0))
        eng, *_ = dt.initialize(model=model, config_params=job["cfg"],
                                model_parameters=job.get("tree"),
                                device="cpu")
        if job.get("load"):
            eng.load_checkpoint(*job["load"])
        snap = COUNTERS.snapshot()
        losses = []
        for i, b in enumerate(job["batches"]):
            if job.get("save") and i == job["save_at"]:
                eng.save_checkpoint(*job["save"])
            losses.append(float(eng.forward(b)))
            eng.backward()
            eng.step()
        d = COUNTERS.delta_since(snap)
        held = {n: tuple(p.shape) for n, p in eng.params.items()
                if ".experts." in n}
        return {"losses": losses, "masters": eng.module_state_dict(),
                "a2a": {k: v for k, v in d.items()
                        if k.startswith("moe.a2a")},
                "logged": logged, "held": held,
                "moment_shapes": {n: tuple(t.shape) for n, t in
                                  zip(eng._param_names,
                                      eng._opt_state["exp_avg"])
                                  if ".experts." in n}}
    finally:
        tdsp.logger = real
        tdsp.set_wire_config(tdsp.MoEWireConfig())


_JOBS = {"layer": _layer_job, "hop": _hop_job, "engine": _engine_job}


def _worker(rank, world, store, jobs, out_dir, outer):
    torch.set_num_threads(1)
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.comm import dist
    from deepspeed_tpu_torch.comm.mesh import make_mesh

    dt.init_distributed(init_method=f"file://{store}", world_size=world,
                        rank=rank, device="cpu", verbose=False)
    try:
        res = {}
        for name, job in jobs.items():
            if job["run"] != "engine":
                make_mesh(data=-1, data_outer=outer)
            res[name] = _JOBS[job["run"]](job)
    finally:
        dist.barrier()
        dist.destroy()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn_world(world, jobs, tmp_path, outer=1, timeout=WORLD_TIMEOUT_S):
    """Run `jobs` in a spawned gloo world -> [{name: result} per rank]."""
    import multiprocessing as mp

    out = tmp_path / f"world{world}"
    out.mkdir(exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, world, str(out / "store"), jobs, str(out),
                               outer)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"world {world} did not finish in {timeout} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


_JAX_ORACLE = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from deepspeed_tpu.comm.mesh import make_mesh
from deepspeed_tpu.moe import dispatch as dsp
from deepspeed_tpu.moe.layer import MoE, MoEConfig

inp = dict(np.load(sys.argv[1]))
make_mesh(data=jax.device_count(), data_outer=int(inp["outer"]))
moe = MoE(MoEConfig(d_model=int(inp["d"]), d_ff=int(inp["f"]),
                    num_experts=int(inp["E"]), top_k=int(inp["k"]),
                    capacity_factor=2.0, min_capacity=1, noisy_gate_std=0.0))
params = {"gate": {"w": jnp.asarray(inp["gate"])},
          "experts": {n: jnp.asarray(inp[n]) for n in ("w1", "b1", "w2",
                                                       "b2")}}
gy = jnp.asarray(inp["gy"])
out = {}
for case in [str(c) for c in inp["cases"]]:
    wire, placement = case.split("-")
    kw = (dict(a2a_wire_dtype=wire) if "/" not in wire else
          dict(a2a_wire_dtype_inner=wire.split("/")[0],
               a2a_wire_dtype_outer=wire.split("/")[1]))
    with dsp.moe_wire(dispatch="sorted", quant_block_size=16,
                      counters=False, placement=placement, **kw):
        def f(p, x):
            y, aux = moe(p, x, train=True)
            return jnp.sum(y * gy) + aux, (y, aux)
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(inp["x"]))
    out[case + ":y"], out[case + ":aux"] = np.asarray(y), np.asarray(aux)
    out[case + ":gx"] = np.asarray(gx)
    out[case + ":gate.w"] = np.asarray(gp["gate"]["w"])
    for n in ("w1", "b1", "w2", "b2"):
        out[case + ":experts." + n] = np.asarray(gp["experts"][n])
np.savez(sys.argv[2], **out)
"""


def _jax_wire(world, outer, cases, tmp_path):
    """JAX's layer through `_sorted_wire` over `world` XLA host devices,
    in a subprocess -> {case: {y, aux, gx, <param>: grad}}."""
    inp = dict(_layer_inputs(), outer=outer, cases=np.array(cases),
               **{k: LAYER[k] for k in ("d", "f", "E", "k")})
    src, dst = tmp_path / f"jin{world}.npz", tmp_path / f"jout{world}.npz"
    np.savez(src, **inp)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={world}",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_ORACLE, str(src),
                             str(dst)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return proc, dst


def _read_jax(proc, dst):
    out, _ = proc.communicate(timeout=WORLD_TIMEOUT_S)
    assert proc.returncode == 0, out.decode()[-3000:]
    got = {}
    with np.load(dst) as z:
        for key in z.files:
            case, what = key.split(":")
            got.setdefault(case, {})[what] = z[key]
    return got


def _hop_inputs():
    """Each rank's buffers [2, ...]: a chunk of 48 elements (block 16
    divides it) and of 45 (it does not), wide spreads and a zero row."""
    rs = np.random.RandomState(7)
    bufs = []
    for _ in range(2):
        mine = {}
        for wire in ("int8", "int4"):
            for dtype in ("float32", "bfloat16"):
                for shape in ((2, 3, 16), (2, 5, 9)):
                    a = rs.randn(*shape) * 10.0 ** rs.uniform(-3, 3, shape)
                    a[0, 0] = 0.0
                    mine[f"{wire}-{dtype}-{shape[1] * shape[2]}"] = \
                        a.astype(np.float32)
        bufs.append(mine)
    return bufs


def _batches(n, B, S=16, V=64, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rs.randint(0, V, (B, S + 1))
        out.append((t[:, :-1], t[:, 1:]))
    return out


def _cfg(world, moe, stage=1, red="implicit", hierarchy="none", micro=None,
         lr=3e-3):
    micro = micro or 8 // world
    return {"train_batch_size": micro * world,
            "train_micro_batch_size_per_gpu": micro,
            "optimizer": {"type": "Adam", "params": {"lr": lr}},
            "zero_optimization": {"stage": stage}, "steps_per_print": 0,
            "gradient_clipping": 1.0,
            "comm": {"gradient_reduction": red, "hierarchy": hierarchy,
                     "reduce_bucket_size": 5000, "moe": moe}}


_FP32_WIRE = {"dispatch": "sorted", "a2a_wire_dtype": "fp32"}
_W2_ENGINES = {
    "fp32-z1": _cfg(2, _FP32_WIRE, stage=1),
    "fp32-z0": _cfg(2, _FP32_WIRE, stage=0),
    "int8-z2": _cfg(2, dict(_FP32_WIRE, a2a_wire_dtype="int8",
                            quant_block_size=16), stage=2),
    "bucketed": _cfg(2, _FP32_WIRE, stage=2, red="bucketed"),
    "implicit-exchange": _cfg(2, {"dispatch": "sorted"}, stage=1),
    "dropless": _cfg(2, {"dispatch": "sorted", "dropless": True}, stage=2),
}
_W4_ENGINES = {
    "data-z2": _cfg(4, dict(_FP32_WIRE, placement="data"), stage=2,
                    hierarchy=2),
    "inner-z1": _cfg(4, dict(_FP32_WIRE, placement="inner"), stage=1,
                     hierarchy=2),
}


def _jax_gpt_tree():
    import jax

    from deepspeed_tpu.models import GPT as JaxGPT
    from deepspeed_tpu.models import gpt2_config as jax_gpt2_config

    jmodel = JaxGPT(jax_gpt2_config("nano", shard_activations=False,
                                    **MOE_MODEL))
    return jmodel, jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0)))


def _world2(tmp):
    """World 2 (flat): the layer's cases, the hop, the engines and the
    tag's save; JAX's wire at 2 devices in a subprocess meanwhile."""
    from deepspeed_tpu_torch.models.convert import flatten_tree

    jax_run = _jax_wire(2, 1, _CASES[2], tmp)
    batches = _batches(STEPS, 8)
    jobs = {"layer": {"run": "layer", "inputs": _layer_inputs(),
                      "cases": _CASES[2]},
            "hop": {"run": "hop", "bufs": _hop_inputs()}}
    for name, cfg in _W2_ENGINES.items():
        jobs[name] = {"run": "engine", "cfg": cfg, "batches": batches}
    _, tree = _jax_gpt_tree()
    tree = {k: np.array(v) for k, v in flatten_tree(tree).items()}
    ck_batches = _batches(4, 8, seed=3)
    jobs["save"] = {"run": "engine", "cfg": _cfg(2, _FP32_WIRE, stage=1),
                    "batches": ck_batches, "tree": tree, "no_noise": True,
                    "save_at": 2, "save": (str(tmp / "ckpt"), "ep2")}
    ranks = spawn_world(2, jobs, tmp)
    return {"jobs": jobs, "ranks": ranks, "jax": _read_jax(*jax_run),
            "tree": tree, "ck_batches": ck_batches, "ckpt": tmp / "ckpt"}


def _world4(tmp):
    jax_run = _jax_wire(4, 2, _CASES[4], tmp)
    batches = _batches(STEPS, 8)
    jobs = {"layer": {"run": "layer", "inputs": _layer_inputs(),
                      "cases": _CASES[4]}}
    for name, cfg in _W4_ENGINES.items():
        jobs[name] = {"run": "engine", "cfg": cfg, "batches": batches}
    ranks = spawn_world(4, jobs, tmp, outer=2)
    return {"jobs": jobs, "ranks": ranks, "jax": _read_jax(*jax_run)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    from test_torch_qgz import run_once

    return run_once(tmp_path_factory, "moe-wire-world2", _world2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    from test_torch_qgz import run_once

    return run_once(tmp_path_factory, "moe-wire-world4", _world4)


def _world1(cfg, batches, tree=None, no_noise=False, load=None):
    """The engine job at world 1 in this process (no process group),
    from the tag `load` (dir, tag) if given."""
    from deepspeed_tpu_torch.comm import dist
    from deepspeed_tpu_torch.models import gpt as tgpt

    assert not dist.is_initialized()
    c = dict(cfg, train_micro_batch_size_per_gpu=cfg["train_batch_size"],
             comm=dict(cfg["comm"], hierarchy="none"))
    keep = tgpt.GPTConfig.moe_config
    try:
        return _engine_job({"cfg": c, "batches": batches, "tree": tree,
                            "no_noise": no_noise, "load": load})
    finally:
        tgpt.GPTConfig.moe_config = keep


# -- the plan -----------------------------------------------------------------


def _port_mesh(dp, outer=1, rank=0):
    from deepspeed_tpu_torch.comm import mesh as tmesh

    return tmesh.MeshInfo(axis_sizes={"pipe": 1, "data": dp, "seq": 1,
                                      "model": 1},
                          data_hierarchy=(outer, dp // outer)
                          if outer > 1 else None, rank=rank)


@pytest.mark.parametrize("dp,outer", [(2, 1), (4, 1), (8, 1), (4, 2)])
@pytest.mark.parametrize("placement", ["auto", "data", "inner"])
def test_a2a_plan_matches_jax(dp, outer, placement):
    """`build_a2a_plan`'s hops (axis, dim, world, wire, slow), ep, buffer
    elements and exact bytes, `resolve_placement` and `expert_axes` equal
    JAX's for every wire and mixed inner/outer wires."""
    import jax

    from deepspeed_tpu.comm.mesh import make_mesh
    from deepspeed_tpu.moe import dispatch as jdsp
    from deepspeed_tpu_torch.moe import dispatch as tdsp

    jmesh = make_mesh(data=dp, data_outer=outer, devices=jax.devices()[:dp],
                      set_current=False)
    tmesh = _port_mesh(dp, outer)
    wires = [dict(a2a_wire_dtype=w) for w in ("fp32", "bf16", "int8",
                                              "int4")]
    wires += [dict(a2a_wire_dtype_inner="fp32", a2a_wire_dtype_outer="int8"),
              dict(a2a_wire_dtype_outer="int4")]
    for kw in wires:
        args = dict(dispatch="sorted", placement=placement,
                    quant_block_size=16, **kw)
        jw, tw = jdsp.MoEWireConfig(**args), tdsp.MoEWireConfig(**args)
        assert tw.describe() == jw.describe()
        assert tdsp.resolve_placement(tw, tmesh) == \
            jdsp.resolve_placement(jw, jmesh)
        assert tdsp.expert_axes(tw, tmesh) == jdsp.expert_axes(jw, jmesh)
        for shape in ((8, 1, 5, 8), (16, 2, 3, 12)):
            jp = jdsp.build_a2a_plan(jw, jmesh, *shape)
            tp = tdsp.build_a2a_plan(tw, tmesh, *shape)
            assert [tuple(vars(h).values()) for h in tp.hops] == \
                [tuple(vars(h).values()) for h in jp.hops]
            for attr in ("ep", "local_elems", "quant_block",
                         "bytes_per_traversal", "inter_bytes_per_traversal",
                         "hops_per_traversal"):
                assert getattr(tp, attr) == getattr(jp, attr), attr
            assert tp.describe() == jp.describe()


def test_wire_config_parses_as_jax():
    """`comm.moe` with the wire: the same MoEWireConfig as JAX's parse,
    `overlap` accepted (the wire runs serially)."""
    from deepspeed_tpu.moe import dispatch as jdsp
    from deepspeed_tpu_torch.moe import dispatch as tdsp

    for d in ({"a2a_wire_dtype": "int8"},
              {"a2a_wire_dtype_outer": "int4", "placement": "data"},
              {"dispatch": "sorted", "a2a_wire_dtype": "bf16",
               "overlap": "on", "quant_block_size": 64},
              {"dispatch": "sorted", "overlap": True}):
        assert vars(tdsp.parse_moe_config(d)) == \
            vars(jdsp.parse_moe_config(d))


# -- engagement ---------------------------------------------------------------


def test_every_wire_engagement_fallback_is_logged_once(monkeypatch):
    """Each reason JAX gives for running the local dispatch (no mesh, a
    model axis, dp 1, ep 1 over inner groups of 1, E % ep, B % dp, the
    bucketed local-grads region) is logged once however often it is
    hit, as are inner placement on a flat mesh and the overlap request."""
    from deepspeed_tpu_torch.comm import mesh as tmesh
    from deepspeed_tpu_torch.moe import dispatch as tdsp

    logged = []
    monkeypatch.setattr(tdsp.logger, "warning", logged.append)
    monkeypatch.setattr(tdsp.logger, "info", logged.append)
    monkeypatch.setattr(tdsp, "_warned", set())
    wire = tdsp.MoEWireConfig(dispatch="sorted", a2a_wire_dtype="fp32")

    def engage(mesh, cfg=wire, E=8, B=8, times=2):
        tmesh.set_current_mesh(mesh)
        try:
            return [tdsp.wire_engagement(cfg, E, B) for _ in range(times)]
        finally:
            tmesh.set_current_mesh(None)

    model = tmesh.MeshInfo(axis_sizes={"data": 2, "model": 2})
    cases = [(None, {}, "no mesh"), (model, {}, "pure data-parallel"),
             (_port_mesh(1), {}, "data-parallel width is 1"),
             (tmesh.MeshInfo(axis_sizes={"data": 4},
                             data_hierarchy=(4, 1)), {}, "width over"),
             (_port_mesh(4), {"E": 6}, "not divisible by the expert"),
             (_port_mesh(4), {"B": 6}, "not divisible by the data")]
    for mesh, kw, want in cases:
        before = len(logged)
        assert engage(mesh, **kw) == [None, None]
        assert len(logged) == before + 1 and want in logged[-1], logged[-1]
    with tdsp.local_grads_region():
        assert engage(_port_mesh(2)) == [None, None]
    assert "local-gradients region" in logged[-1]
    n = len(logged)
    inner = tdsp.MoEWireConfig(dispatch="sorted", a2a_wire_dtype="fp32",
                               placement="inner", overlap="on")
    got = engage(_port_mesh(2), cfg=inner)
    assert got[0] is not None and got[0][1] == ("data",)
    assert len(logged) == n + 2
    assert "flat mesh" in logged[n] and "serial wire" in logged[n + 1]
    # a factored mesh: "auto" keeps the experts in an inner group, "data"
    # spreads them over both axes
    assert engage(_port_mesh(4, 2))[0][1] == ("data_inner",)
    data = tdsp.MoEWireConfig(dispatch="sorted", a2a_wire_dtype="fp32",
                              placement="data")
    assert engage(_port_mesh(4, 2), cfg=data)[0][1] == ("data_outer",
                                                        "data_inner")
    assert len(logged) == n + 2


# -- the hop and the layer ----------------------------------------------------


def test_hop_a2a_bitwise_with_jax_codec(world2):
    """Every chunk a rank receives through an int8 / int4 hop is JAX's
    codec composition of the chunk its source rank sent, rounded once to
    the buffer's dtype, bit for bit (a chunk blocks divide and one they
    do not, fp32 and bf16 buffers)."""
    import jax.numpy as jnp

    from deepspeed_tpu.runtime.comm import quant as jq

    bufs = world2["jobs"]["hop"]["bufs"]
    for me, res in enumerate(world2["ranks"]):
        for key, got in res["hop"].items():
            wire, dtype, n = key.split("-")
            n = int(n)
            for src in range(2):
                chunk = torch.tensor(bufs[src][key][me]).to(
                    getattr(torch, dtype)).float().numpy().reshape(-1)
                p, s = jq.unpack_wire(jq.pack_wire(*jq.quantize_blockwise_ref(
                    jnp.asarray(chunk), 16, wire)), wire, 16, n)
                want = torch.from_numpy(np.array(jq.dequantize_blockwise_ref(
                    p, s, wire, n))).to(getattr(torch, dtype)).float()
                assert np.array_equal(got[src].reshape(-1), want.numpy()), \
                    (key, me, src)


def _check_layer(world, res_ranks, jax_out, cases):
    B = LAYER["B"]
    Bl = B // world
    for case in cases:
        tol = _LAYER_TOL[case.split("-")[0].split("/")[-1]]
        want = jax_out[case]

        def close(a, b, what):
            scale = max(float(np.abs(b).max()), 1e-6)
            err = float(np.abs(np.asarray(a) - b).max()) / scale
            assert err <= tol, (case, what, err)

        y = np.concatenate([r["layer"][case]["y"] for r in res_ranks])
        close(y, want["y"], "y")
        gx = np.concatenate([r["layer"][case]["gx"] for r in res_ranks])
        close(gx, want["gx"], "gx")
        aux = np.mean([r["layer"][case]["aux"] for r in res_ranks])
        assert abs(aux - float(want["aux"])) <= 1e-6, (case, aux)
        for name in ("gate.w", "experts.w1", "experts.b1", "experts.w2",
                     "experts.b2"):
            g = sum(r["layer"][case]["grads"][name] for r in res_ranks)
            close(g, want[name], name)
        assert [r["layer"][case]["y"].shape[0] for r in res_ranks] == \
            [Bl] * world


def test_layer_at_world2_matches_jax_wire(world2):
    """The flat wire (ep 2) in fp32, bf16, int8 and int4: the ranks' rows
    of y, their mean aux, the sums of their gradients and dL/dx equal
    JAX's `_sorted_wire` at ep 2; `moe.a2a_bytes` is the plan's 4
    traversals (forward dispatch and combine, their mirrored backward)."""
    from deepspeed_tpu_torch.moe import dispatch as tdsp
    from deepspeed_tpu_torch.moe import layer as tlayer

    _check_layer(2, world2["ranks"], world2["jax"], _CASES[2])
    cap = tlayer.MoE(tlayer.MoEConfig(
        d_model=LAYER["d"], d_ff=LAYER["f"], num_experts=LAYER["E"],
        top_k=LAYER["k"], capacity_factor=2.0,
        min_capacity=1)).capacity(LAYER["S"], True)
    for case in _CASES[2]:
        plan = tdsp.build_a2a_plan(
            tdsp.MoEWireConfig(**_wire_kwargs(*case.split("-"))),
            _port_mesh(2), LAYER["E"], LAYER["B"] // 2, cap, LAYER["d"])
        for res in world2["ranks"]:
            a2a = res["layer"][case]["a2a"]
            assert a2a["moe.a2a_bytes"] == {
                "calls": 4, "bytes": 4 * plan.bytes_per_traversal}, case
            assert "moe.a2a_inter" not in a2a


def test_layer_at_world4_factored_matches_jax_wire(world4):
    """Outer 2 × inner 2: two hops under placement "data" (fp32, and
    int8 on the slow hop only), one over `data_inner` under "inner"
    (fp32, int4), against JAX's wire on a 4-device factored mesh; the
    slow hop's bytes in `moe.a2a_inter`."""
    _check_layer(4, world4["ranks"], world4["jax"], _CASES[4])
    for res in world4["ranks"]:
        assert "moe.a2a_inter" not in res["layer"]["fp32-inner"]["a2a"]
        two = res["layer"]["fp32/int8-data"]["a2a"]
        assert two["moe.a2a_bytes"]["calls"] == 8
        assert 0 < two["moe.a2a_inter"]["bytes"] < \
            two["moe.a2a_bytes"]["bytes"] / 2


# -- the engine ---------------------------------------------------------------


def _close(a, b, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _masters_close(m1, m2, atol):
    assert set(m1) == set(m2)
    worst = max(float(np.abs(m1[n] - m2[n]).max()) for n in m1)
    assert worst <= atol, worst


@pytest.mark.parametrize("name", ["fp32-z1", "fp32-z0"])
def test_world2_fp32_wire_matches_world1(world2, name):
    """The MoE GPT at world 2 through the fp32 wire: each rank holds 4 of
    the 8 experts and their moments, losses and (whole) masters equal
    world 1's, the a2a counters the plan's bytes × 4 traversals × 1 MoE
    layer × steps."""
    from deepspeed_tpu_torch.moe import dispatch as tdsp
    from deepspeed_tpu_torch.moe import layer as tlayer

    job = world2["jobs"][name]
    want = _world1(job["cfg"], job["batches"])
    cap = tlayer.MoE(tlayer.MoEConfig(d_model=48, d_ff=192, num_experts=8,
                                      top_k=2)).capacity(16, True)
    plan = tdsp.build_a2a_plan(tdsp.MoEWireConfig(**_FP32_WIRE),
                               _port_mesh(2), 8, 4, cap, 48)
    for res in world2["ranks"]:
        got = res[name]
        _close(got["losses"], want["losses"], rtol=1e-6)
        _masters_close(got["masters"], want["masters"], 1e-5)
        assert all(s[0] == 4 for s in got["held"].values())
        assert all(s[0] == 4 for s in got["moment_shapes"].values())
        assert got["a2a"]["moe.a2a_bytes"]["bytes"] == \
            plan.bytes_per_traversal * 4 * STEPS
        assert not any("local dispatch" in m for m in got["logged"])


def test_world2_int8_wire_tracks_the_fp32_wire(world2):
    """The int8 wire (block 16) at ZeRO-2 against the fp32 wire: the
    losses within JAX's engine-level bound for this wire, 5e-2 a step
    (test_moe_dispatch.py `test_engine_dryrun_wire_pins_counters_and_loss`),
    and the masters within 2 × steps × lr (each run moves an element
    about lr a step at most, Adam's normalized step, whatever the
    quantization does to its gradient); the a2a bytes are int8's."""
    lr = world2["jobs"]["int8-z2"]["cfg"]["optimizer"]["params"]["lr"]
    for res in world2["ranks"]:
        ref, got = res["fp32-z1"], res["int8-z2"]
        _close(got["losses"], ref["losses"], atol=5e-2)
        _masters_close(got["masters"], ref["masters"], 2 * STEPS * lr)
        assert 0 < got["a2a"]["moe.a2a_bytes"]["bytes"] < \
            ref["a2a"]["moe.a2a_bytes"]["bytes"] / 3


@pytest.mark.parametrize("name", ["bucketed", "implicit-exchange",
                                  "dropless"])
def test_world2_local_dispatch_paths_match_world1(world2, name):
    """Without the wire each rank keeps all 8 experts: the bucketed
    reduction (the wire falls back inside its local-grads region, logged
    once), the implicit exchange and dropless at world 2 equal world 1."""
    job = world2["jobs"][name]
    want = _world1(job["cfg"], job["batches"])
    for res in world2["ranks"]:
        got = res[name]
        _close(got["losses"], want["losses"], rtol=1e-6)
        _masters_close(got["masters"], want["masters"],
                       5e-5 if name == "dropless" else 1e-5)
        assert all(s[0] == 8 for s in got["held"].values())
        assert "moe.a2a_bytes" not in got["a2a"]
        fell = [m for m in got["logged"] if "local-gradients" in m]
        assert len(fell) == (1 if name == "bucketed" else 0)


@pytest.mark.parametrize("name", ["data-z2", "inner-z1"])
def test_world4_factored_placements_match_world1(world4, name):
    """Outer 2 × inner 2: placement "data" shards the experts over all
    four ranks (2 each, two hops), "inner" over an inner group (4 each,
    replicated across the outer groups, whose expert gradients are summed
    over `data_outer`); both equal world 1."""
    job = world4["jobs"][name]
    want = _world1(job["cfg"], job["batches"])
    for res in world4["ranks"]:
        got = res[name]
        _close(got["losses"], want["losses"], rtol=1e-6)
        _masters_close(got["masters"], want["masters"], 1e-5)
        per = 2 if name == "data-z2" else 4
        assert all(s[0] == per for s in got["held"].values())
        assert ("moe.a2a_inter" in got["a2a"]) == (name == "data-z2")


def test_world2_expert_tag_reads_in_jax_at_dp8_and_at_world1(world2,
                                                             monkeypatch):
    """A world-2 tag with the experts sharded: the module tree holds them
    whole, the moments as the two owners' pieces; the JAX engine reads it
    at dp 8 (params and moments exactly, then the same losses), and the
    port resumes it at world 1 on the same batches."""
    import jax

    import deepspeed_tpu
    from deepspeed_tpu.models import gpt as jgpt
    from deepspeed_tpu.moe import dispatch as jdsp
    from deepspeed_tpu.moe.layer import MoEConfig as JaxMoEConfig
    from deepspeed_tpu_torch.models.convert import flatten_tree
    from deepspeed_tpu_torch.moe import dispatch as tdsp
    from deepspeed_tpu_torch.runtime import checkpointing as ck

    ckpt, batches = str(world2["ckpt"]), world2["ck_batches"]
    stream = world2["ranks"][0]["save"]["losses"]
    assert world2["ranks"][1]["save"]["losses"] == stream
    _, model_state, optim = ck.load_checkpoint_state(ckpt, "ep2")
    mod = flatten_tree(model_state["module"])
    assert mod["blocks.1.moe.experts.w1"].shape[0] == 8
    monkeypatch.setattr(
        jgpt.GPTConfig, "moe_config",
        lambda self: JaxMoEConfig(
            d_model=self.d_model, d_ff=self.d_ff,
            num_experts=self.num_experts, top_k=self.moe_top_k,
            capacity_factor=self.moe_capacity_factor, noisy_gate_std=0.0))
    jmodel, tree = _jax_gpt_tree()
    cfg = _cfg(2, _FP32_WIRE, stage=1)
    jcfg = dict(cfg, train_micro_batch_size_per_gpu=1,
                comm={"moe": {"dispatch": "sorted"}})
    try:
        je, *_ = deepspeed_tpu.initialize(model=jmodel, model_parameters=tree,
                                          config_params=jcfg)
        je.load_checkpoint(ckpt, tag="ep2")
        jp = flatten_tree(jax.tree_util.tree_map(np.asarray, je.params))
        for n, v in mod.items():
            assert np.array_equal(np.asarray(v), jp[n]), n
        jo = flatten_tree(jax.tree_util.tree_map(
            np.asarray, je._opt_state["exp_avg"]))
        po = flatten_tree(optim["optimizer_state"]["exp_avg"])
        for n in po:
            assert np.array_equal(np.asarray(po[n]), jo[n]), n
        got_j = []
        for b in batches[2:]:
            got_j.append(float(je.forward(b)))
            je.backward()
            je.step()
    finally:
        jdsp.set_wire_config(jdsp.MoEWireConfig())
        tdsp.set_wire_config(tdsp.MoEWireConfig())
    np.testing.assert_allclose(got_j, stream[2:], atol=1e-5, rtol=0)
    w1 = _world1(cfg, batches[2:], tree=world2["tree"], no_noise=True,
                 load=(ckpt, "ep2"))
    np.testing.assert_allclose(w1["losses"], stream[2:], rtol=1e-6, atol=0)
    _masters_close(w1["masters"], world2["ranks"][0]["save"]["masters"],
                   1e-5)

"""Port parity: ZeRO stage 3 — parameters sharded over the data ranks and
gathered a block at a time on use (runtime/zero/stage3.py), the stage-3
plan and the qwZ int8/int4 weight gather (runtime/zero/partition.py
`QuantizedWeightGather`), the engine's stage-3 step, its fallbacks and
its tags (runtime/engine.py, step_builder.py).

The port's worlds are spawned gloo processes on the CPU (`file://`
stores under pytest's temp root), once a session and world
(tests/test_torch_qgz.py `run_once`); the JAX engine runs in this
process over the harness's 8 CPU devices.  Tolerances, with their
reasons:

* the plan's specs, qwZ's placements, bytes and counters: exact;
* stage 3 against stage 2 on the implicit wire at world 2 (fp32 and
  bf16, gas 1 and 2, remat, the MoE wire, the bucketed request that
  falls back, a resume across the stages): BITWISE — the same replica
  (every slice cast by its owner), the same backward, the same
  reduce-scatter of each leaf's fp32 gradient;
* stage 3 at worlds 2 and 4 against world 1 stage 0: losses 1e-6
  relative a step, masters 1e-5 (tests/test_torch_dp.py's fp32 bound:
  the gradient summed over the ranks' rows in another order);
* the qwZ replica at worlds 2 and 4: bitwise JAX's
  `QuantizedWeightGather.gather` over as many XLA host devices, in a
  subprocess, with XLA's algebraic simplifier off (`_jax_gather` says
  why): the same codec, per-leaf blocks;
* training through qwZ int8 / int4 against the unquantized stage 3:
  `_assert_tracks` (tests/test_comm_quant.py:326-345, copied in
  tests/test_torch_qgz.py);
* the port's stage-3 curve (2 ranks × micro 4) against the JAX engine's
  (dp 8 × micro 1), from JAX's initial weights, and a JAX stage-3 tag
  resumed in the port: 1e-5 a step (tests/test_torch_train.py's fp32
  engine-curve bound);
* tags across world sizes 2 -> 4 -> 1 and stages 3 <-> 2: the restored
  masters and Adam moments bitwise the saved ones.
"""

import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

STEPS = 3
VOCAB, SEQ = 64, 32


# -- the spawned jobs ---------------------------------------------------------


def _cfg(stage, prec="fp32", gas=1, micro=4, world=2, qw=None, lr=3e-3,
         **extra):
    fp = {"fp32": {}, "bf16": {"bf16": {"enabled": True}}}
    z = {"stage": stage}
    if qw:
        z["quantized_weights"] = qw
    c = {"train_batch_size": micro * gas * world,
         "train_micro_batch_size_per_gpu": micro,
         "gradient_accumulation_steps": gas,
         "optimizer": {"type": "Adam", "params": {"lr": lr}},
         "zero_optimization": z, "steps_per_print": 0,
         "gradient_clipping": 1.0,
         "comm": {"quant_block_size": 32}, **fp[prec]}
    for k, v in extra.items():
        c[k] = dict(c.get(k, {}), **v) if isinstance(v, dict) else v
    return c


def _batches(n, B, S=16, V=VOCAB, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rs.randint(0, V, (B, S + 1))
        out.append((t[:, :-1], t[:, 1:]))
    return out


MOE_MODEL = dict(num_layers=2, num_experts=8, moe_top_k=2, max_seq_len=16)


def _model(job):
    from deepspeed_tpu_torch.models import GPT, gpt2_config

    kw = dict(MOE_MODEL) if job.get("moe") else dict(max_seq_len=SEQ)
    return GPT(gpt2_config("nano", vocab_size=VOCAB, remat=job.get("remat",
                                                                  False),
                           **kw),
               device="cpu", generator=torch.Generator().manual_seed(0))


def _whole_moments(eng):
    """The Adam moments whole, every rank's slices gathered (a
    collective)."""
    from deepspeed_tpu_torch.comm import dist

    out = {}
    for key in ("exp_avg", "exp_avg_sq"):
        for n, t, lp in zip(eng._param_names, eng._opt_state[key],
                            eng.zero_plan.leaves):
            if lp.sharded and eng.dp_world_size > 1:
                t = dist.all_gather(t.contiguous(), "data",
                                    gather_axis=lp.dim)
            out[f"{key}:{n}"] = t.detach().numpy().copy()
    out["step"] = np.asarray(int(eng._opt_state["step"]))
    return out


def _state(eng):
    return {"masters": eng.module_state_dict(),
            "moments": _whole_moments(eng), "steps": eng.global_steps}


def _train(job):
    """An engine run -> losses, norms, masters, the qwZ counters, the
    stage-3 gather's replica bytes and the fallbacks logged; with `load`,
    the state right after the load; with `save`, a tag saved after
    `save_at` steps (and the state then)."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.monitor.counters import COUNTERS
    from deepspeed_tpu_torch.utils.logging import logger

    logged = []

    class _Grab(logging.Handler):
        def emit(self, record):
            logged.append(record.getMessage())

    grab = _Grab()
    logger.addHandler(grab)
    try:
        eng, *_ = dt.initialize(model=_model(job), config_params=job["cfg"],
                                model_parameters=job.get("tree"),
                                device="cpu")
    finally:
        logger.removeHandler(grab)
    out = {"logged": logged, "hier": eng.mesh_info.hierarchical,
           "qwz": eng._qwz_gather is not None,
           "partition_weights": eng.zero_optimization_partition_weights(),
           "persistence": eng.zero_param_persistence_threshold(),
           "master_dtypes": sorted({str(p.dtype) for p in eng._masters})}
    if job.get("load"):
        eng.load_checkpoint(*job["load"])
        out["loaded"] = _state(eng)
        if job.get("save_loaded"):
            eng.save_checkpoint(*job["save_loaded"])
    snap = COUNTERS.snapshot()
    losses, norms = [], []
    for i, b in enumerate(job["batches"]):
        if job.get("save") and i == job["save_at"]:
            eng.save_checkpoint(*job["save"])
            out["saved"] = _state(eng)
        losses.append(float(eng.forward(b)))
        eng.backward()
        eng.step()
        norms.append(eng.get_global_grad_norm())
    d = COUNTERS.delta_since(snap)
    out.update(losses=losses, norms=norms, masters=eng.module_state_dict(),
               qwz_gather=d.get("qwz.gather"), micro_steps=eng.micro_steps)
    s3 = eng._stage3
    if s3 is not None:
        out.update(peak=s3.peak_bytes, group_bytes=s3.group_bytes(),
                   gathers=s3.gathers, groups=len(s3.groups))
    if job["batches"]:
        # eval, `params` and a module state dict's round trip gather too
        out["eval"] = float(eng.eval_batch(job["batches"][0]))
        # at stage 3 `params` is the whole masters, gathered
        params = ({n: p.detach().numpy() for n, p in eng.params.items()}
                  if eng._stage3 is not None else out["masters"])
        eng.load_module_state_dict(out["masters"])
        out["params_and_roundtrip"] = all(
            np.array_equal(params[n], v) and np.array_equal(w, v)
            for (n, v), w in zip(out["masters"].items(),
                                 eng.module_state_dict().values()))
    g = eng._qwz_gather
    if g is not None:
        out.update(wire_bytes=g.wire_bytes_per_gather,
                   collectives=g.collectives_per_gather)
    return out


def _gather(job):
    """The port's qwZ replica of a whole tree (`tree`: {name: fp32}) from
    this rank's compute-dtype slices, as bits."""
    from deepspeed_tpu_torch.comm import dist
    from deepspeed_tpu_torch.comm.mesh import get_current_mesh
    from deepspeed_tpu_torch.runtime.zero import partition as tp

    names = list(job["tree"])
    whole = [torch.from_numpy(job["tree"][n]) for n in names]
    plan = tp.ZeroShardingPlan(3, get_current_mesh(),
                               [tuple(w.shape) for w in whole])
    idx = plan.gathered
    out = {}
    for wire in ("int8", "int4"):
        for dtype in (torch.float32, torch.bfloat16):
            qwz = tp.QuantizedWeightGather(plan, wire=wire, block=32)
            # every sharded leaf in one fused gather; the others whole
            got = [w.to(dtype) for w in whole]
            for i, full in zip(idx, qwz.gather_leaves(
                    idx, [plan.leaves[i].from_full(whole[i]).to(dtype)
                          for i in idx], dtype)):
                got[i] = full
            out[f"{wire}-{dtype}"] = {
                n: (t.view(torch.int16) if dtype == torch.bfloat16 else t)
                .numpy() for n, t in zip(names, got)}
    dist.barrier()
    return out


_JOBS = {"train": _train, "gather": _gather}


def _worker(rank, world, store, jobs, out_dir):
    torch.set_num_threads(1)
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.comm import dist
    from deepspeed_tpu_torch.comm.mesh import make_mesh

    dt.init_distributed(init_method=f"file://{store}", world_size=world,
                        rank=rank, device="cpu", verbose=False)
    try:
        res = {}
        for name, job in jobs.items():
            if job["run"] == "gather":
                make_mesh(data=-1)
            res[name] = _JOBS[job["run"]](job)
    finally:
        dist.barrier()
        dist.destroy()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn_world(world, jobs, tmp, timeout=300):
    """Run `jobs` in a spawned gloo world -> [{name: result} per rank]."""
    import multiprocessing as mp

    out = tmp / f"world{world}"
    out.mkdir(exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, world, str(out / "store"),
                                               jobs, str(out)))
             for r in range(world)]
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


# -- the JAX side --------------------------------------------------------------


def _jax_init(seed=5):
    """JAX GPT-2 nano and its initial weights as the JAX engine draws
    them from DSTPU_SEED (engine.py:211), flattened by port name."""
    import jax

    from deepspeed_tpu.models import GPT as JaxGPT
    from deepspeed_tpu.models import gpt2_config as jax_gpt2_config
    from deepspeed_tpu_torch.models.convert import flatten_tree

    cfg = jax_gpt2_config("nano", max_seq_len=SEQ, vocab_size=VOCAB,
                          shard_activations=False)
    _, init_key = jax.random.split(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, JaxGPT(cfg).init(init_key))
    return JaxGPT(cfg), tree, {k: np.array(v) for k, v in
                               flatten_tree(tree).items()}


def _jax_stage3_run(jmodel, tree, batches, ckpt, save_at):
    """The JAX engine at stage 3, dp 8 × micro 1: the losses, a tag saved
    before step `save_at`."""
    import deepspeed_tpu as ds

    jc = _cfg(3, micro=1, world=8)
    jc.pop("comm")
    je, *_ = ds.initialize(model=jmodel, model_parameters=tree,
                           config_params=jc)
    losses = []
    for i, b in enumerate(batches):
        if i == save_at:
            je.save_checkpoint(ckpt, tag="jz3")
        losses.append(float(je.forward(b)))
        je.backward()
        je.step()
    return losses


_PAIRS = {f"{prec}-g{gas}": dict(prec=prec, gas=gas)
          for prec in ("fp32", "bf16") for gas in (1, 2)}


def _world2(tmp):
    jmodel, jtree, tree = _jax_init()
    jax_gather = _jax_gather(tree, 2, tmp)
    curve = _batches(4, 8, S=SEQ, seed=77)
    jax_losses = _jax_stage3_run(jmodel, jtree, curve, str(tmp / "jax"), 2)
    batches = _batches(STEPS, 8)
    jobs = {}
    for name, c in _PAIRS.items():
        gas = c["gas"]
        b = _batches(STEPS * gas, 8 // gas, seed=1) if gas > 1 else batches
        for stage in (2, 3):
            jobs[f"z{stage}-{name}"] = {
                "run": "train", "batches": b,
                "cfg": _cfg(stage, c["prec"], c["gas"],
                            micro=4 // c["gas"])}
    jobs["z3-remat"] = {"run": "train", "batches": batches, "remat": True,
                        "cfg": _cfg(3)}
    jobs["z3-bucketed"] = {"run": "train", "batches": batches,
                           "cfg": _cfg(3, comm={"gradient_reduction":
                                                "bucketed"})}
    moe = {"comm": {"moe": {"dispatch": "sorted",
                            "a2a_wire_dtype": "fp32"}}}
    for stage in (2, 3):
        jobs[f"moe-z{stage}"] = {"run": "train", "batches": _batches(STEPS, 8),
                                 "moe": True, "cfg": _cfg(stage, **moe)}
    for wire in ("int8", "int4"):
        jobs[f"qwz-{wire}"] = {"run": "train", "batches": batches,
                               "cfg": _cfg(3, qw=wire)}
    jobs["qwz-int8-g2"] = {"run": "train", "batches": jobs["z3-fp32-g2"]
                           ["batches"], "cfg": _cfg(3, gas=2, micro=2,
                                                    qw="int8")}
    jobs["qwz-below-3"] = {"run": "train", "batches": batches,
                           "cfg": _cfg(2, qw="int8")}
    jobs["gather"] = {"run": "gather", "tree": tree}
    # the curve and a JAX tag from JAX's initial weights
    jobs["curve"] = {"run": "train", "batches": curve, "tree": tree,
                     "cfg": _cfg(3)}
    jobs["load-jax"] = {"run": "train", "batches": curve[2:], "tree": tree,
                        "cfg": _cfg(3), "load": (str(tmp / "jax"), "jz3")}
    # tags: stage 3 -> stage 2 / 3, stage 2 -> stage 3, all at world 2
    ck = str(tmp / "port")
    four = _batches(4, 8, seed=3)
    jobs["save-z3"] = {"run": "train", "batches": four, "cfg": _cfg(3),
                       "save": (ck, "z3w2"), "save_at": 2}
    jobs["save-z2"] = {"run": "train", "batches": four, "cfg": _cfg(2),
                       "save": (ck, "z2w2"), "save_at": 2}
    for stage, tag in ((2, "z3w2"), (3, "z3w2"), (3, "z2w2")):
        jobs[f"load-{tag}-z{stage}"] = {"run": "train", "batches": four[2:],
                                        "cfg": _cfg(stage),
                                        "load": (ck, tag)}
    ranks = spawn_world(2, jobs, tmp)
    return {"ranks": ranks, "jax_losses": jax_losses, "ckpt": ck,
            "batches": batches, "jax_gather": _read_jax_gather(*jax_gather)}


def _world4(tmp, ck):
    batches = _batches(STEPS, 8)
    _, _, tree = _jax_init()
    jax_gather = _jax_gather(tree, 4, tmp)
    jobs = {"z3": {"run": "train", "batches": batches,
                   "cfg": _cfg(3, micro=2, world=4)},
            "z3-hier": {"run": "train", "batches": batches,
                        "cfg": _cfg(3, micro=2, world=4,
                                    comm={"hierarchy": 2})},
            "gather": {"run": "gather", "tree": tree},
            "load-z3w2": {"run": "train", "batches": [],
                          "cfg": _cfg(3, micro=2, world=4),
                          "load": (ck, "z3w2"),
                          "save_loaded": (ck, "z3w4")}}
    return {"ranks": spawn_world(4, jobs, tmp),
            "jax_gather": _read_jax_gather(*jax_gather)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    from test_torch_qgz import run_once

    return run_once(tmp_path_factory, "zero3-world2", _world2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory, world2):
    from test_torch_qgz import run_once

    return run_once(tmp_path_factory, "zero3-world4",
                    lambda d: _world4(d, world2["ckpt"]))


def _world1(job):
    """`job` in this process with no process group: one rank of the whole
    global batch."""
    from deepspeed_tpu_torch.comm import dist

    assert not dist.is_initialized()
    c = dict(job["cfg"])
    c["train_micro_batch_size_per_gpu"] = c["train_batch_size"] // \
        c["gradient_accumulation_steps"]
    return _train(dict(job, cfg=c))


def _bitwise(a, b):
    assert a["losses"] == b["losses"]
    assert a["eval"] == b["eval"]
    assert a["params_and_roundtrip"] and b["params_and_roundtrip"]
    assert a["norms"] == b["norms"]
    assert set(a["masters"]) == set(b["masters"])
    for n in a["masters"]:
        assert np.array_equal(a["masters"][n], b["masters"][n]), n


def _same_state(a, b):
    for part in ("masters", "moments"):
        assert set(a[part]) == set(b[part]), part
        for n in a[part]:
            assert np.array_equal(a[part][n], b[part][n]), (part, n)
    assert a["steps"] == b["steps"]


# -- the plan and qwZ's accounting (no world) ----------------------------------


def _port_mesh(dp, rank=0, outer=1):
    from deepspeed_tpu_torch.comm import mesh as tmesh

    return tmesh.MeshInfo(axis_sizes={"pipe": 1, "data": dp, "seq": 1,
                                      "model": 1},
                          data_hierarchy=(outer, dp // outer)
                          if outer > 1 else None, rank=rank)


def _jax_plan(dp):
    import jax

    from deepspeed_tpu.comm.mesh import make_mesh
    from deepspeed_tpu.runtime.zero.partition import ZeroShardingPlan
    from test_torch_zero import _jax_tree

    tree = _jax_tree()
    mesh = make_mesh(data=dp, devices=jax.devices()[:dp], set_current=False)
    return ZeroShardingPlan(3, mesh, tree), tree, mesh


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_stage3_plan_matches_jax(dp):
    """Per leaf the port's stage-3 parameter, gradient and optimizer specs
    are JAX's `ZeroShardingPlan(3, ...)` (with_full_dp: the largest
    dimension divisible by dp, leaves under 1024 elements whole); a
    sharded leaf is stored as the slice (`gathered`), every rank's slices
    tile it once; a hierarchical mesh is refused at stage 3, where the
    engine keeps the data axis flat."""
    import jax

    from deepspeed_tpu_torch.runtime.zero import partition as tp
    from test_torch_zero import _port_leaves

    jplan, _, _ = _jax_plan(dp)
    leaves, _ = _port_leaves()
    shapes = [tuple(p.shape) for p in leaves]
    plans = [tp.ZeroShardingPlan(3, _port_mesh(dp, r), shapes)
             for r in range(dp)]
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    for attr in ("param_spec", "grad_spec", "opt_spec"):
        want = [tuple(s) + (None,) * (len(shape) - len(tuple(s)))
                for s, shape in zip(jax.tree_util.tree_leaves(
                    getattr(jplan, attr), is_leaf=is_spec), shapes)]
        assert getattr(plans[0], attr) == want, attr
    assert plans[0].describe() == jplan.describe()
    assert plans[0].partition_layout() == jplan.partition_layout()
    gathered = plans[0].gathered
    assert gathered and all(plans[0].leaves[i].held_sliced for i in gathered)
    for i in gathered:
        cover = np.zeros(shapes[i], np.int32)
        for plan in plans:
            lp = plan.leaves[i]
            assert lp.owned(torch.zeros(lp.owned_shape)).shape == \
                lp.owned_shape
            cover[tuple(slice(a, b) for a, b in
                        lp.piece_index(lp.index))] += 1
        assert (cover == 1).all(), i
    if dp >= 4:
        with pytest.raises(ValueError, match="flat data axis"):
            tp.ZeroShardingPlan(3, _port_mesh(dp, 0, outer=2), shapes)


@pytest.mark.parametrize("wire", ["int8", "int4"])
@pytest.mark.parametrize("dp,block", [(2, 32), (4, 256), (8, 32)])
def test_qwz_placements_and_bytes_match_jax(dp, block, wire):
    """The port's `QuantizedWeightGather` places and prices every leaf as
    JAX's does (per-leaf padded blocks: `wire_bytes_per_gather`,
    `n_quantized_leaves`); the port fuses a model's gather units into one
    collective each (`collectives_per_gather`: the groups), and its
    describe line is JAX's with that count."""
    import jax.numpy as jnp

    import jax
    from deepspeed_tpu.runtime.zero.partition import QuantizedWeightGather
    from deepspeed_tpu_torch.models import GPT, gpt2_config
    from deepspeed_tpu_torch.models.convert import jax_leaf_order
    from deepspeed_tpu_torch.runtime.zero import partition as tp
    from deepspeed_tpu_torch.runtime.zero.stage3 import unit_groups

    jplan, tree, _ = _jax_plan(dp)
    jq = QuantizedWeightGather(jplan, jax.tree_util.tree_map(jnp.asarray,
                                                             tree),
                               wire=wire, block=block)
    model = GPT(gpt2_config("nano", vocab_size=64, max_seq_len=32),
                device="cpu")
    names = [n for n, _ in model.named_parameters()]
    shapes = [tuple(p.shape) for _, p in model.named_parameters()]
    plan = tp.ZeroShardingPlan(3, _port_mesh(dp), shapes)
    groups = unit_groups(model, names)
    q = tp.QuantizedWeightGather(plan, wire=wire, block=block, groups=groups)
    order = jax_leaf_order(names)
    assert [q._placements[i] for i in order] == [
        (d, tuple(a), tuple(s)) for d, a, s in jq._placements]
    assert q.wire_bytes_per_gather == jq.wire_bytes_per_gather
    assert q.n_quantized_leaves == jq.n_quantized_leaves
    assert q.collectives_per_gather == len(groups) == 4
    assert q.describe() == jq.describe().replace(
        f"/ {jq.collectives_per_gather} collective(s)", "/ 4 collective(s)")


# -- world 2 ------------------------------------------------------------------


@pytest.mark.parametrize("pair", list(_PAIRS))
def test_stage3_is_bitwise_stage2_at_world2(world2, pair):
    """Losses, clipping norms and masters of stage 3 equal stage 2's on
    the implicit wire bit for bit, on every rank; the masters a rank
    keeps are fp32 slices, and the live gathered replicas never exceed
    the root group's plus the largest block's."""
    for res in world2["ranks"]:
        z2, z3 = res[f"z2-{pair}"], res[f"z3-{pair}"]
        _bitwise(z2, z3)
        assert z3["master_dtypes"] == ["torch.float32"]
        assert z3["partition_weights"] and z3["persistence"] == 100000
        gb = z3["group_bytes"]
        assert 0 < z3["peak"] <= gb[0] + max(gb[1:])
        # two gathers of every group a micro step: forward and backward
        assert z3["gathers"] == 2 * z3["groups"] * z3["micro_steps"]


def test_stage3_remat_moe_and_bucketed_request_are_bitwise(world2):
    """Under remat the recomputation re-gathers (still two gathers a group
    a step); the explicit MoE wire's local experts compose with stage 3;
    a bucketed request at stage 3 falls back to the implicit reduction,
    logged in the JAX engine's words — all bitwise their stage-2 or
    stage-3 counterparts."""
    for res in world2["ranks"]:
        _bitwise(res["z3-remat"], res["z2-fp32-g1"])
        assert res["z3-remat"]["gathers"] == \
            2 * res["z3-remat"]["groups"] * STEPS
        _bitwise(res["moe-z3"], res["moe-z2"])
        _bitwise(res["z3-bucketed"], res["z3-fp32-g1"])
    assert any("bucketed gradient wire requested but unavailable — falling "
               "back to implicit XLA reduction: ZeRO-3" in m
               for m in world2["ranks"][0]["z3-bucketed"]["logged"])


def test_stage3_world2_matches_world1_stage0(world2):
    want = _world1({"batches": world2["batches"], "cfg": _cfg(0)})
    for res in world2["ranks"]:
        got = res["z3-fp32-g1"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6,
                                   atol=0)
        worst = max(float(np.abs(got["masters"][n] - want["masters"][n])
                          .max()) for n in want["masters"])
        assert worst <= 1e-5, worst


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_qwz_tracks_unquantized_and_counts_its_bytes(world2, wire):
    """Stage 3 through the int8 / int4 weight gather tracks the
    unquantized stage 3 (`_assert_tracks`), the masters stay fp32, and
    `qwz.gather` carries the plan's bytes twice a micro step."""
    from test_torch_qgz import _assert_tracks

    for res in world2["ranks"]:
        got = res[f"qwz-{wire}"]
        assert got["qwz"] and got["master_dtypes"] == ["torch.float32"]
        _assert_tracks(res["z3-fp32-g1"], got, wire)
        passes = 2 * got["micro_steps"]
        assert got["qwz_gather"] == {"calls": got["collectives"] * passes,
                                     "bytes": got["wire_bytes"] * passes}
        assert got["collectives"] == got["groups"]
    got = world2["ranks"][0]["qwz-int8-g2"]
    assert got["micro_steps"] == 2 * STEPS
    assert got["qwz_gather"]["bytes"] == got["wire_bytes"] * 4 * STEPS
    _assert_tracks(world2["ranks"][0]["z3-fp32-g2"], got, "int8")


def test_qwz_below_stage3_and_at_dp1_gathers_at_full_width(world2):
    """qwZ at stage 2 (world 2) and at dp 1 logs JAX's fallback and runs
    at full width: stage 2 trains bitwise as without it."""
    res = world2["ranks"][0]
    got = res["qwz-below-3"]
    assert not got["qwz"] and got["qwz_gather"] is None
    _bitwise(got, res["z2-fp32-g1"])
    assert any("zero_optimization.quantized_weights requested but "
               "unavailable — parameters gather at full width: ZeRO stage "
               "< 3 (parameters are replicated — there is no gather to "
               "quantize)" in m for m in got["logged"])
    one = _world1({"batches": world2["batches"][:1],
                   "cfg": _cfg(3, qw="int4")})
    assert not one["qwz"] and one["qwz_gather"] is None
    assert any("dp==1 (nothing to gather)" in m for m in one["logged"])


_JAX_GATHER = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
jax.config.update("jax_platforms", "cpu")
from deepspeed_tpu import _compat  # noqa: F401
from deepspeed_tpu.comm.mesh import make_mesh
from deepspeed_tpu.runtime.zero.partition import (QuantizedWeightGather,
                                                  ZeroShardingPlan)
from deepspeed_tpu_torch.models.convert import flatten_tree, unflatten_tree

tree = unflatten_tree(dict(np.load(sys.argv[1])))
mesh = make_mesh(data=jax.device_count(), set_current=False)
plan = ZeroShardingPlan(3, mesh, tree)
out = {}
for wire in ("int8", "int4"):
    for dtype, name in ((jnp.float32, "torch.float32"),
                        (jnp.bfloat16, "torch.bfloat16")):
        params = jax.tree_util.tree_map(
            lambda a, s: jax.device_put(jnp.asarray(a, dtype),
                                        NamedSharding(mesh.mesh, s)),
            tree, plan.param_spec)
        g = QuantizedWeightGather(plan, params, wire=wire, block=32)
        full = flatten_tree(jax.tree_util.tree_map(
            np.asarray, jax.jit(g.gather)(params)))
        for n, v in full.items():
            out[f"{wire}-{name}:{n}"] = (v if v.dtype == np.float32
                                         else v.view(np.int16))
np.savez(sys.argv[2], **out)
"""


def _jax_gather(tree, dp, tmp):
    """JAX's `QuantizedWeightGather.gather` of `tree` over `dp` XLA host
    devices in a subprocess (int8 / int4, fp32 / bf16, block 32) ->
    (process, output path).  XLA's algebraic simplifier is off there: it
    rewrites the codec's `amax / qmax` into `amax * (1 / qmax)`, which
    moves a block's fp16 scale by one ulp now and then (1 block of 288
    in fc2.w at dp 2, int4), so the compiled program departs from JAX's
    codec as written (`quantize_blockwise_ref`, eager), which the port
    holds bit for bit (tests/test_torch_qgz.py)."""
    import subprocess
    import sys

    src, dst = tmp / f"gin{dp}.npz", tmp / f"gout{dp}.npz"
    np.savez(src, **tree)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={dp} "
                         "--xla_disable_hlo_passes=algsimp",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_GATHER, str(src),
                             str(dst)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return proc, dst


def _read_jax_gather(proc, dst):
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out.decode()[-3000:]
    got = {}
    with np.load(dst) as z:
        for key in z.files:
            case, n = key.split(":")
            got.setdefault(case, {})[n] = z[key]
    return got


def _check_gather(ranks, want):
    from test_torch_zero import _bits_equal

    for res in ranks:
        assert set(res["gather"]) == set(want)
        for case, leaves in res["gather"].items():
            assert set(leaves) == set(want[case])
            for n, v in leaves.items():
                assert _bits_equal(v, want[case][n]), (case, n)


def test_qwz_replica_is_bitwise_jax_at_world2(world2):
    _check_gather(world2["ranks"], world2["jax_gather"])


def test_stage3_curve_matches_the_jax_engine(world2):
    for res in world2["ranks"]:
        np.testing.assert_allclose(res["curve"]["losses"],
                                   world2["jax_losses"], rtol=0, atol=1e-5)


def test_jax_stage3_tag_loads_into_the_port(world2):
    """The JAX engine's stage-3 tag at dp 8 (its parameters as `model:`
    pieces) loads into the port at world 2: the masters are JAX's, and
    the port goes on along JAX's curve."""
    import deepspeed_tpu.runtime.checkpointing as jck
    from deepspeed_tpu_torch.models.convert import flatten_tree

    _, ms, _ = jck.load_checkpoint_state(
        os.path.join(os.path.dirname(world2["ckpt"]), "jax"), "jz3")
    want = flatten_tree(ms["module"])
    for res in world2["ranks"]:
        got = res["load-jax"]
        for n, v in got["loaded"]["masters"].items():
            assert np.array_equal(v, np.asarray(want[n])), n
        np.testing.assert_allclose(got["losses"], world2["jax_losses"][2:],
                                   rtol=0, atol=1e-5)


def test_port_stage3_tag_is_read_by_jax(world2):
    """The port's world-2 stage-3 tag: JAX's `load_checkpoint_state` and
    JAX's `zero_to_fp32` put its `model:` pieces back into exactly the
    saved masters, and the moments into the saved moments."""
    import glob

    import deepspeed_tpu.runtime.checkpointing as jck
    from deepspeed_tpu.utils.zero_to_fp32 import \
        get_fp32_state_dict_from_zero_checkpoint
    from deepspeed_tpu_torch.models.convert import flatten_tree

    ck = world2["ckpt"]
    assert len(glob.glob(os.path.join(ck, "z3w2", "zero_pp_rank_*"))) == 2
    saved = world2["ranks"][0]["save-z3"]["saved"]
    _, ms, opt = jck.load_checkpoint_state(ck, "z3w2")
    module = flatten_tree(ms["module"])
    fp32 = flatten_tree(get_fp32_state_dict_from_zero_checkpoint(ck, "z3w2"))
    for n, v in saved["masters"].items():
        assert np.array_equal(np.asarray(module[n]), v), n
        assert np.array_equal(np.asarray(fp32[n]), v), n
    for key in ("exp_avg", "exp_avg_sq"):
        flat = flatten_tree(opt["optimizer_state"][key])
        for n, v in flat.items():
            assert np.array_equal(np.asarray(v),
                                  saved["moments"][f"{key}:{n}"]), (key, n)


def test_tags_resume_bitwise_across_stages(world2):
    """A stage-3 tag resumes at stage 2 and at stage 3, a stage-2 tag at
    stage 3: the restored state is the saved one bit for bit, and the
    curve goes on as the saving run's did."""
    for res in world2["ranks"]:
        for tag, stage in (("z3w2", 2), ("z3w2", 3), ("z2w2", 3)):
            src = res["save-" + tag[:2]]
            got = res[f"load-{tag}-z{stage}"]
            _same_state(got["loaded"], src["saved"])
            assert got["losses"] == src["losses"][2:], (tag, stage)


# -- world 4 ------------------------------------------------------------------


def test_stage3_world4_matches_world1_and_flattens_a_hierarchy(world2,
                                                               world4):
    want = _world1({"batches": world2["batches"], "cfg": _cfg(0)})
    for res in world4["ranks"]:
        got = res["z3"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6,
                                   atol=0)
        worst = max(float(np.abs(got["masters"][n] - want["masters"][n])
                          .max()) for n in want["masters"])
        assert worst <= 1e-5, worst
        assert not res["z3-hier"]["hier"]
        _bitwise(res["z3-hier"], got)
    assert any("comm.hierarchy requested but unavailable — keeping the flat "
               "data axis: ZeRO-3 (param sharding keeps the flat axis)" in m
               for m in world4["ranks"][0]["z3-hier"]["logged"])


def test_qwz_replica_is_bitwise_jax_at_world4(world4):
    _check_gather(world4["ranks"], world4["jax_gather"])


def test_tags_resume_bitwise_across_world_sizes(world2, world4):
    """world 2 -> 4 -> 1: the stage-3 tag written at world 2 restores at
    world 4 to the saved state bit for bit, that rank set's re-save
    restores at world 1 (no process group) to it again."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import GPT, gpt2_config

    saved = world2["ranks"][0]["save-z3"]["saved"]
    for res in world4["ranks"]:
        _same_state(res["load-z3w2"]["loaded"], saved)
    eng, *_ = dt.initialize(
        model=GPT(gpt2_config("nano", vocab_size=VOCAB, max_seq_len=SEQ),
                  device="cpu"),
        config_params=_cfg(3, micro=8, world=1), device="cpu")
    eng.load_checkpoint(world2["ckpt"], "z3w4")
    _same_state(_state(eng), saved)

"""Port parity: data-parallel training over `torch.distributed` at ZeRO
stage 0, 1 and 2 (deepspeed_tpu_torch/comm/, runtime/zero/partition.py,
runtime/comm/bucketing.py, the engine's reduce stage in
runtime/step_builder.py).

Each world is spawned: gloo processes on the CPU with a `file://` store
under the test's tmp_path (no TCP port to collide under xdist), several
checks a world, each world joined under its own timeout.  A world trains
on the same global batches as the port's single-process engine (no
process group), which is the reference here; the JAX engine is the
reference of the curves at the end.  Tolerances, with their reasons:

* fp32 wire: losses within 1e-6 relative a step and masters within 1e-5
  after 3 steps — the same arithmetic, the gradient summed over two
  halves of the batch instead of one (fp32 reassociation; Adam turns a
  near-zero gradient's relative error into at most lr a step, which the
  bound leaves room for on no element here);
* bf16 wire: losses 1e-3 relative; split wire (fp16 mantissa): 1e-4;
  masters within steps × lr for both: the wire rounds each gradient to
  2^-8 (2^-11) of itself, and Adam's normalized step moves an element
  at most lr per step whatever its gradient's error;
* the clipping norm: 1e-6 relative of world 1's (fp32 sums in another
  order);
* dropout on: the same masks (each rank's rows of the global batch's),
  so the fp32 bound;
* the hierarchy (outer 2 × inner 2, world 4): the fp32 bounds;
* fp16 with an overflow on one rank only: every rank skips the step and
  halves the scale, as world 1 does (the flag is an all-reduce MAX);
* the port-vs-JAX curve (JAX dp 8 × micro 1, the port 2 ranks × micro
  4, from JAX's initial weights, ZeRO-2 both): 1e-5 a step,
  tests/test_torch_train.py's fp32 engine-curve bound;
* tests/convergence/gpt2_nano_loss.json at ZeRO-2, world 2:
  tests/test_convergence.py's rtol 0.05 / atol 0.02.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

WORLD_TIMEOUT_S = 240


# -- the spawned world ------------------------------------------------------


def _cfg(stage=0, red="implicit", wire="fp32", micro=4, world=2, gas=1,
         prec="fp32", clip=1.0, lr=3e-3, hierarchy="none", **extra):
    fp = {"fp32": {}, "bf16": {"bf16": {"enabled": True}},
          "fp16": {"fp16": {"enabled": True, "loss_scale": 0,
                            "initial_scale_power": 8, "hysteresis": 1}}}
    c = {"train_batch_size": micro * gas * world,
         "train_micro_batch_size_per_gpu": micro,
         "gradient_accumulation_steps": gas,
         "optimizer": {"type": "Adam", "params": {"lr": lr}},
         "zero_optimization": {"stage": stage}, "steps_per_print": 0,
         "gradient_clipping": clip,
         "comm": {"gradient_reduction": red, "wire_dtype": wire,
                  "reduce_bucket_size": 5000, "hierarchy": hierarchy},
         **fp[prec]}
    c.update(extra)
    return c


def _batches(n, B, S=16, V=64, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rs.randint(0, V, (B, S + 1))
        out.append((t[:, :-1], t[:, 1:]))
    return out


class _Poisoned(torch.nn.Module):
    """A one-matrix model whose loss turns inf on rows with scale inf —
    and only through W's columns 32-63, so at dp 2 the overflow lands in
    one rank's partition only."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w = torch.nn.Parameter(torch.randn(32, 64, generator=g) * 0.1)

    def forward(self, batch, generator=None, train=True, row_offset=0):
        x, scale = batch
        h = x.to(self.w.dtype) @ self.w
        return (h[:, :32].float().square().mean() +
                (h[:, 32:].float().square() *
                 scale.float()[:, None]).mean())


def _train(job):
    """One engine run -> its losses, grad norms, exact masters and the
    share of the optimizer state this rank holds."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import GPT, gpt2_config

    kind = job.get("model", "gpt")
    if kind == "poisoned":
        model = _Poisoned()
    else:
        model = GPT(gpt2_config("nano", vocab_size=64, max_seq_len=32,
                                dropout=job.get("dropout", 0.0)),
                    device="cpu", generator=torch.Generator().manual_seed(0))
    eng, *_ = dt.initialize(model=model, config_params=job["cfg"],
                            model_parameters=job.get("tree"), device="cpu")
    losses, norms, scales = [], [], []
    for b in job["batches"]:
        losses.append(float(eng.forward(b)))
        eng.backward()
        eng.step()
        norms.append(eng.get_global_grad_norm())
        scales.append(eng.loss_scale)
    held = sum(t.numel() for t in eng._opt_state["exp_avg"])
    total = sum(p.numel() for p in eng._masters)
    return {"losses": losses, "norms": norms, "scales": scales,
            "skipped": eng.skipped_steps, "held": held / total,
            "masters": eng.module_state_dict()}


def _worker(rank, world, store, jobs, out_dir):
    torch.set_num_threads(1)
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.comm import dist

    dt.init_distributed(init_method=f"file://{store}", world_size=world,
                        rank=rank, device="cpu", verbose=False)
    try:
        res = {name: _JOBS[job["run"]](job) for name, job in jobs.items()}
    finally:
        dist.barrier()
        dist.destroy()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _resume(job):
    """A GPT-2 nano engine on the engine-owned loader (`data`): load the
    tag `load` (dir, tag) if given, then `steps` train_batch() calls,
    saving the tag `save` (dir, tag) before step `save_at`; -> losses,
    exact masters."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import GPT, gpt2_config

    model = GPT(gpt2_config("nano", vocab_size=64, max_seq_len=32),
                device="cpu")
    eng, *_ = dt.initialize(model=model, config_params=job["cfg"],
                            model_parameters=job["tree"],
                            training_data=job["data"], device="cpu")
    if job.get("load"):
        eng.load_checkpoint(*job["load"])
    losses = []
    for i in range(job["steps"]):
        if job.get("save") and i == job["save_at"]:
            eng.save_checkpoint(*job["save"])
        losses.append(float(eng.train_batch()))
    eng.finalize_monitoring()
    return {"losses": losses, "masters": eng.module_state_dict()}


_JOBS = {"train": _train, "resume": _resume}


def spawn_world(world, jobs, tmp_path, timeout=WORLD_TIMEOUT_S):
    """Run `jobs` ({name: job}) in a spawned gloo world of `world` ranks;
    -> [{name: result} per rank].  A rank that fails or outlives the
    timeout fails the test."""
    import multiprocessing as mp

    out = tmp_path / f"world{world}"
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
    assert all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _world1(job):
    """The same job in this process, with no process group."""
    from deepspeed_tpu_torch.comm import dist

    assert not dist.is_initialized()
    job = dict(job, cfg=dict(job["cfg"]))
    c = job["cfg"]
    c["train_micro_batch_size_per_gpu"] *= c["train_batch_size"] // (
        c["train_micro_batch_size_per_gpu"] *
        c["gradient_accumulation_steps"])
    c["comm"] = dict(c["comm"], hierarchy="none")
    return _train(job)


def _close(a, b, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _masters_close(m1, m2, atol):
    assert set(m1) == set(m2)
    worst = max(float(np.abs(m1[n] - m2[n]).max()) for n in m1)
    assert worst <= atol, worst


# -- world 2: the stages, the reductions and the wires ----------------------

_W2 = {f"z{st}-{red}-{w}": dict(stage=st, red=red, wire=w)
       for st in (0, 1, 2) for red, wires in
       (("implicit", ("fp32",)), ("bucketed", ("fp32", "bf16", "split")))
       for w in wires}
_LOSS_RTOL = {"fp32": 1e-6, "bf16": 1e-3, "split": 1e-4}


def test_world2_stages_reductions_and_wires_match_world1(tmp_path):
    """ZeRO 0/1/2 × implicit / bucketed × the fp32 / bf16 / split wires at
    world 2 against the single-process engine on the same global batches;
    dropout on, gradient accumulation, and fp16 with an overflow on one
    rank only; every rank ends with the same masters, and a partitioned
    rank holds 1/2 of each sharded leaf's optimizer state."""
    batches = _batches(3, 8)
    jobs = {name: {"run": "train", "batches": batches,
                   "cfg": _cfg(j["stage"], j["red"], j["wire"])}
            for name, j in _W2.items()}
    jobs["dropout"] = {"run": "train", "batches": batches, "dropout": 0.1,
                       "cfg": _cfg(2, "bucketed")}
    jobs["gas2"] = {"run": "train", "batches": _batches(6, 4, seed=1),
                    "cfg": _cfg(2, "implicit", micro=2, gas=2)}
    x = np.random.RandomState(3).randn(8, 32).astype(np.float32)
    scale = np.ones(8, np.float32)
    poisoned = [(x, scale), (x, np.where(np.arange(8) >= 4, np.inf,
                                         1.0).astype(np.float32)), (x, scale)]
    jobs["fp16-overflow"] = {"run": "train", "model": "poisoned",
                             "batches": poisoned,
                             "cfg": _cfg(2, "bucketed", prec="fp16")}
    ranks = spawn_world(2, jobs, tmp_path)
    for name, job in jobs.items():
        want = _world1(job)
        wire = job["cfg"]["comm"]["wire_dtype"]
        for r, res in enumerate(ranks):
            got = res[name]
            if name == "fp16-overflow":
                assert got["skipped"] == want["skipped"] == 1
                assert got["scales"] == want["scales"]
                assert got["scales"][1] == got["scales"][0] / 2
                _masters_close(got["masters"], want["masters"], 1e-3)
                continue
            _close(got["losses"], want["losses"], rtol=_LOSS_RTOL[wire])
            lr = job["cfg"]["optimizer"]["params"]["lr"]
            bound = 1e-5 if wire == "fp32" else len(job["batches"]) * lr
            _masters_close(got["masters"], want["masters"], bound)
            if wire == "fp32":
                _close(got["norms"], want["norms"], rtol=1e-6)
            _masters_close(got["masters"], ranks[0][name]["masters"], 0.0)
            stage = job["cfg"]["zero_optimization"]["stage"]
            if stage == 0:
                assert got["held"] == 1.0
            else:
                assert 0.5 < got["held"] < 0.6   # 13 of 40 leaves whole


def test_world4_hierarchy_matches_world1(tmp_path):
    """The two-level wire (outer 2 × inner 2): reduce-scatter inside an
    inner group, the outer hop on the 1/2 shard, partitions over
    `data_inner` (hpZ: replicated across the outer groups)."""
    batches = _batches(3, 8)
    jobs = {
        "z2-bucketed": {"run": "train", "batches": batches,
                        "cfg": _cfg(2, "bucketed", micro=2, world=4,
                                    hierarchy=2)},
        "z1-bucketed": {"run": "train", "batches": batches,
                        "cfg": _cfg(1, "bucketed", micro=2, world=4,
                                    hierarchy={"outer": 2})},
        "z2-implicit": {"run": "train", "batches": batches,
                        "cfg": _cfg(2, "implicit", micro=2, world=4,
                                    hierarchy=2)},
    }
    ranks = spawn_world(4, jobs, tmp_path)
    for name, job in jobs.items():
        want = _world1(job)
        for res in ranks:
            got = res[name]
            _close(got["losses"], want["losses"], rtol=1e-6)
            _close(got["norms"], want["norms"], rtol=1e-6)
            _masters_close(got["masters"], want["masters"], 1e-5)
            assert 0.5 < got["held"] < 0.6    # inner 2: half of each leaf


# -- curves -------------------------------------------------------------------


def _jax_init(seed, vocab=64, seq=32):
    """JAX GPT-2 nano's initial weights, drawn as the JAX engine draws
    them from DSTPU_SEED (engine.py:211)."""
    import jax

    from deepspeed_tpu.models import GPT as JaxGPT
    from deepspeed_tpu.models import gpt2_config as jax_gpt2_config

    cfg = jax_gpt2_config("nano", max_seq_len=seq, vocab_size=vocab,
                          shard_activations=False)
    _, init_key = jax.random.split(jax.random.PRNGKey(seed))
    return JaxGPT(cfg), jax.tree_util.tree_map(np.asarray,
                                               JaxGPT(cfg).init(init_key))


def test_world2_curves_match_jax_and_the_pinned_convergence(tmp_path):
    """Two curves at world 2, ZeRO-2, from JAX's initial weights: the
    JAX engine's (dp 8 × micro 1 over the 8 CPU devices, the port 2 ranks
    × micro 4: the same global batch), and the pinned
    tests/convergence/gpt2_nano_loss.json (ZeRO-2 over the 8-device mesh;
    the port 2 ranks × micro 32)."""
    import jax

    import deepspeed_tpu as ds
    from convergence_common import BASELINE_PATH, CONFIG, synthetic_batches

    conv_batches = list(synthetic_batches(
        CONFIG["steps"], CONFIG["micro"] * 8, CONFIG["seq"], CONFIG["vocab"],
        CONFIG["seed"]))
    jmodel, conv_tree = _jax_init(CONFIG["seed"])
    curve_batches = list(synthetic_batches(6, 8, 32, 64, 77))
    _, curve_tree = _jax_init(5)
    jobs = {
        "convergence": {"run": "train", "batches": conv_batches,
                        "tree": conv_tree,
                        "cfg": _cfg(2, micro=CONFIG["micro"] * 4,
                                    lr=CONFIG["lr"], clip=0.0)},
        "jax-curve": {"run": "train", "batches": curve_batches,
                      "tree": curve_tree,
                      "cfg": _cfg(2, "bucketed", micro=4, lr=3e-3)},
    }
    ranks = spawn_world(2, jobs, tmp_path)
    with open(BASELINE_PATH) as f:
        ref = json.load(f)["losses"]
    got = ranks[0]["convergence"]["losses"]
    assert len(got) == len(ref)
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.02)
    assert got[-1] < 0.5 * got[0]

    assert jax.device_count() == 8
    jc = _cfg(2, micro=1, world=8, lr=3e-3)
    jc.pop("comm")
    je, *_ = ds.initialize(model=jmodel, model_parameters=curve_tree,
                           config_params=jc)
    want = []
    for b in curve_batches:
        want.append(float(je.forward(b)))
        je.backward()
        je.step()
    for res in ranks:
        np.testing.assert_allclose(res["jax-curve"]["losses"], want,
                                   rtol=0, atol=1e-5)

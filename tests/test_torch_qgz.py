"""Port parity: the blockwise-quantized gradient wire (qgZ) —
runtime/comm/quant.py `pack_wire` / `unpack_wire` / `quantized_all_gather`,
the int8/int4 branches of runtime/comm/bucketing.py `BucketPlan`, the
`comm` config around them, and the engine's training through them.

Each world is spawned once a test session (`run_once`: the first xdist
worker to need it runs it, the others wait for its result): gloo
processes on the CPU with a `file://` store under pytest's temp root,
several checks a world.
Tolerances, with their reasons:

* the codec and the wire buffers: bitwise against JAX's functions (NaN
  compared as NaN) — the same integer and fp16 arithmetic;
* the gathered contributions and the reduced bucket at world 2: bitwise
  against the numpy oracle built from JAX's `quantize_blockwise_ref` →
  `pack_wire` → `unpack_wire` → `dequantize_blockwise_ref` per rank, then
  the fp32 sum of the two rows and the division by 2 (a sum of two terms
  has one order; / 2 is exact);
* the accounting and the errors: equal to JAX's `BucketPlan` objects;
* training through int8/int4 against the fp32 wire in the same world:
  `_assert_tracks`, copied with its comment from tests/test_comm_quant.py
  (loss within 2% and each element inside the wire's envelope, a rare
  near-zero gradient flipped by the quantization allowed to drift by
  Adam's lr);
* the `bucket.*` counters: equal to the plan's `wire_nbytes` a reduction.
"""

import fcntl
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

WORLD_TIMEOUT_S = 240
STEPS = 4


# -- the spawned worlds -----------------------------------------------------


def _cfg(stage=0, wire="fp32", outer_wire=None, micro=4, world=2,
         hierarchy="none", prec="fp32", block=32, lr=3e-3):
    fp = {"fp32": {}, "fp16": {"fp16": {"enabled": True, "loss_scale": 0,
                                        "initial_scale_power": 8,
                                        "hysteresis": 1}}}
    comm = {"gradient_reduction": "bucketed", "wire_dtype": wire,
            "reduce_bucket_size": 5000, "hierarchy": hierarchy,
            "quant_block_size": block}
    if outer_wire is not None:
        comm["wire_dtype_outer"] = outer_wire
    return {"train_batch_size": micro * world,
            "train_micro_batch_size_per_gpu": micro,
            "optimizer": {"type": "Adam", "params": {"lr": lr}},
            "zero_optimization": {"stage": stage}, "steps_per_print": 0,
            "gradient_clipping": 1.0, "comm": comm, **fp[prec]}


def _batches(n, B, S=16, V=64, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rs.randint(0, V, (B, S + 1))
        out.append((t[:, :-1], t[:, 1:]))
    return out


class _Poisoned(torch.nn.Module):
    """A one-matrix model whose loss turns inf on rows with scale inf,
    so an overflow reaches one rank's gradient only."""

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
    """An engine run -> losses, masters, the wire counters and its plan."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import GPT, gpt2_config
    from deepspeed_tpu_torch.monitor.counters import COUNTERS

    if job.get("model") == "poisoned":
        model = _Poisoned()
    else:
        model = GPT(gpt2_config("nano", vocab_size=64, max_seq_len=32),
                    device="cpu", generator=torch.Generator().manual_seed(0))
    eng, *_ = dt.initialize(model=model, config_params=job["cfg"],
                            device="cpu")
    snap = COUNTERS.snapshot()
    losses, scales = [], []
    for b in job["batches"]:
        losses.append(float(eng.forward(b)))
        eng.backward()
        eng.step()
        scales.append(eng.loss_scale)
    d = COUNTERS.delta_since(snap)
    plan = eng.bucket_plan
    return {"losses": losses, "scales": scales,
            "skipped": eng.skipped_steps,
            "masters": eng.module_state_dict(),
            "counters": {k: v for k, v in d.items()
                         if k.startswith(("bucket.", "grad_wire."))},
            "plan": {"quantized": plan.quantized, "scatter": plan.scatter,
                     "exact_fp32": eng.allreduce_always_fp32(),
                     "bytes": plan.wire_bytes_per_reduction,
                     "inter": plan.wire_bytes_inter_per_reduction,
                     "describe": plan.describe()}}


def _gather(job):
    """`quantized_all_gather` of this rank's vector, and a flat plan's
    reduction of this rank's leaves."""
    from deepspeed_tpu_torch.comm import dist
    from deepspeed_tpu_torch.runtime.comm import bucketing as tb
    from deepspeed_tpu_torch.runtime.comm import quant as tq

    r = dist.get_rank()
    out = {}
    for wire in ("int8", "int4"):
        x = torch.from_numpy(job["x"][r])
        out[f"gather-{wire}"] = tq.quantized_all_gather(
            x, ("data",), job["block"], wire).numpy()
        leaves = [torch.from_numpy(a[r]) for a in job["leaves"]]
        plan = tb.BucketPlan(leaves, dp_size=2, bucket_elems=10 ** 6,
                             wire=wire, quant_block=job["block"])
        red = plan.unflatten(plan.reduce(plan.flatten(leaves)))
        out[f"reduce-{wire}"] = [t.numpy() for t in red]
    return out


_JOBS = {"train": _train, "gather": _gather}


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
            if job["run"] == "gather":
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


def run_once(tmp_path_factory, name, make):
    """`make(dir)`'s result, computed once a session: under pytest-xdist
    every worker that needs it takes a file lock in the workers' shared
    temp root, and the first to hold it computes and saves the result for
    the others."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    d = root / name
    d.mkdir(exist_ok=True)
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = d / "result.pt"
        if not done.exists():
            torch.save(make(d), d / "result.tmp")
            os.replace(d / "result.tmp", done)
    return torch.load(done, weights_only=False)


def _gather_inputs(block=16):
    """Two ranks' vectors (an odd length, specials, a wide spread) and
    three leaves each, one of them shorter than a block."""
    from test_torch_zero import _codec_values

    rs = np.random.RandomState(5)
    v = _codec_values()[:1001]
    x = np.stack([v, rs.permutation(v)]).astype(np.float32)
    leaves = [rs.randn(2, *s).astype(np.float32) * 10.0 ** rs.uniform(-3, 3)
              for s in ((7, 9), (5,), (33, 4))]
    return {"run": "gather", "x": x, "leaves": leaves, "block": block}


_W2 = {
    "z0-fp32": dict(stage=0), "z0-int8": dict(stage=0, wire="int8"),
    "z0-int4": dict(stage=0, wire="int4"),
    "z1-fp32": dict(stage=1), "z1-int8": dict(stage=1, wire="int8"),
    "z2-fp32": dict(stage=2), "z2-int8": dict(stage=2, wire="int8"),
}
_W4 = {
    "h2-fp32": dict(stage=2), "h2-int8": dict(stage=2, outer_wire="int8"),
    "h1-fp32": dict(stage=1), "h1-int4": dict(stage=1, outer_wire="int4"),
}


def _world2(tmp):
    batches = _batches(STEPS, 8)
    jobs = {n: {"run": "train", "batches": batches, "cfg": _cfg(**c)}
            for n, c in _W2.items()}
    x = np.random.RandomState(3).randn(8, 32).astype(np.float32)
    one = np.ones(8, np.float32)
    jobs["overflow-int8"] = {
        "run": "train", "model": "poisoned",
        "batches": [(x, one), (x, np.where(np.arange(8) >= 4, np.inf,
                                           1.0).astype(np.float32)),
                    (x, one)],
        "cfg": _cfg(2, "int8", prec="fp16")}
    jobs["gather"] = _gather_inputs()
    return jobs, spawn_world(2, jobs, tmp)


def _world4(tmp):
    batches = _batches(STEPS, 8)
    jobs = {n: {"run": "train", "batches": batches,
                "cfg": _cfg(micro=2, world=4, hierarchy=2, **c)}
            for n, c in _W4.items()}
    return jobs, spawn_world(4, jobs, tmp, outer=2)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_once(tmp_path_factory, "qgz-world2", _world2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_once(tmp_path_factory, "qgz-world4", _world4)


def _assert_tracks(ref, got, wire):
    la, pa = ref["losses"][-1], ref["masters"]
    lb, pb = got["losses"][-1], got["masters"]
    assert abs(la - lb) <= 0.02 * max(abs(la), 1.0), (la, lb)
    rtol = {"int8": 5e-2, "int4": 2.5e-1}[wire]
    max_abs = {"int8": 5e-2, "int4": 1.2e-1}[wire]
    # int4 has ~7% per-contribution granularity (scale/2 = amax/14), so
    # more near-zero gradients flip sign into ~lr-sized Adam drift
    bad_frac = {"int8": 0.05, "int4": 0.12}[wire]
    n_bad = n_total = 0
    for name in pa:
        x, y = pa[name], pb[name]
        diff = np.abs(x - y)
        # bulk within the wire's quantization envelope; a compressed
        # gradient can flip a near-zero element's sign, which Adam
        # turns into ~lr of drift — allow such violators to be RARE
        # (pooled over the whole tree: a tiny bias leaf must not turn
        # one drifted element into a >5% "fraction")
        n_bad += int((diff > 1e-3 + rtol * np.abs(x)).sum())
        n_total += diff.size
        assert float(diff.max()) < max_abs, (name, float(diff.max()))
    assert n_bad / n_total < bad_frac, \
        f"{100 * n_bad / n_total:.2f}% of elements off"


# -- the codec's wire buffer -------------------------------------------------


def _jax_wire(x, block, wire):
    """JAX's per-row composition: quantize_blockwise_ref -> pack_wire,
    vmapped over the leading rows."""
    import jax

    from deepspeed_tpu.runtime.comm import quant as jq

    def enc(r):
        return jq.pack_wire(*jq.quantize_blockwise_ref(r, block, wire))

    flat = x.reshape(-1, x.shape[-1])
    return np.asarray(jax.vmap(enc)(flat)).reshape(x.shape[:-1] + (-1,))


@pytest.mark.parametrize("wire", ["int8", "int4"])
@pytest.mark.parametrize("lead,n,block", [((), 1001, 16), ((3,), 37, 8),
                                          ((2, 2), 512, 256), ((), 6, 2)])
def test_pack_unpack_wire_bitwise_with_jax(wire, lead, n, block):
    """The fused buffer of each row (odd lengths, leading batch dims,
    subnormals, inf and NaN among the values) is JAX's byte for byte, and
    unpacking and dequantizing it gives JAX's payload, scales and values."""
    from deepspeed_tpu.runtime.comm import quant as jq
    from deepspeed_tpu_torch.runtime.comm import quant as tq
    from test_torch_zero import _bits_equal, _codec_values

    v = _codec_values()
    rows = int(np.prod(lead or (1,)))
    x = np.resize(v, rows * n).reshape(lead + (n,)).astype(np.float32)
    want = _jax_wire(x, block, wire)
    parts = [tq.quantize_blockwise_ref(torch.from_numpy(r), block, wire)
             for r in x.reshape(rows, n)]
    payload = torch.stack([p for p, _ in parts])
    scales = torch.stack([s for _, s in parts])
    got = tq.pack_wire(payload, scales).reshape(lead + (-1,))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tq.pack_wire(*parts[0]).numpy(),
                          want.reshape(rows, -1)[0])
    p, s = tq.unpack_wire(got, wire, block, n)
    jp, js = jq.unpack_wire(want, wire, block, n)
    assert _bits_equal(p.numpy(), jp) and _bits_equal(s.numpy(), js)
    assert _bits_equal(
        tq.dequantize_blockwise_ref(p, s, wire, n).numpy(),
        np.asarray(jq.dequantize_blockwise_ref(jp, js, wire, n)))


def test_quantized_gather_and_reduce_bitwise_at_world2(world2):
    """At world 2: every rank's `quantized_all_gather` rows are the JAX
    oracle's dequantized contributions, and a flat int8/int4 BucketPlan's
    reduced leaves are their fp32 sum / 2, bit for bit, on both ranks."""
    import jax.numpy as jnp

    from deepspeed_tpu.runtime.comm import quant as jq
    from test_torch_zero import _bits_equal

    jobs, ranks = world2
    job = jobs["gather"]
    block = job["block"]

    def oracle(a, wire):
        n = a.shape[-1]
        p, s = jq.unpack_wire(jq.pack_wire(*jq.quantize_blockwise_ref(
            jnp.asarray(a), block, wire)), wire, block, n)
        return np.asarray(jq.dequantize_blockwise_ref(p, s, wire, n))

    for wire in ("int8", "int4"):
        want = np.stack([oracle(job["x"][r], wire) for r in range(2)])
        # one bucket: each rank's leaves concatenated in order
        flat = np.stack([np.concatenate([a[r].reshape(-1)
                                         for a in job["leaves"]])
                         for r in range(2)])
        contrib = np.stack([oracle(flat[r], wire) for r in range(2)])
        total = (np.sum(contrib, axis=0, dtype=np.float32) /
                 np.float32(2)).astype(np.float32)
        for res in ranks:
            assert _bits_equal(res["gather"][f"gather-{wire}"], want)
            got = np.concatenate([t.reshape(-1) for t in
                                  res["gather"][f"reduce-{wire}"]])
            assert _bits_equal(got, total)


# -- the plan's accounting and errors against JAX's -------------------------


def _tree_pair():
    import jax
    import jax.numpy as jnp

    jtree = {"a": jax.ShapeDtypeStruct((100,), jnp.float32),
             "b": jax.ShapeDtypeStruct((60,), jnp.float32)}
    leaves = [torch.empty(100), torch.empty(60)]
    return jtree, leaves


_ATTRS = ("wire_bytes_per_reduction", "wire_bytes_logical_per_reduction",
          "collectives_per_reduction", "wire_bytes_intra_per_reduction",
          "wire_bytes_inter_per_reduction",
          "wire_bytes_intra_logical_per_reduction",
          "wire_bytes_inter_logical_per_reduction",
          "collectives_intra_per_reduction",
          "collectives_inter_per_reduction", "quantized", "exact_fp32",
          "scatter", "quant_block")


@pytest.mark.parametrize("case", [
    dict(wire="int8", quant_block=32), dict(wire="int4", quant_block=32),
    dict(wire="int8", scatter=True),
    dict(levels=("fp32", "int4"), quant_block=32),
    dict(levels=("bf16", "int8"), quant_block=64, scatter=True),
    dict(wire="int8", bucket_elems=40, quant_block=16)])
def test_plan_accounting_matches_jax(case):
    """Padded and logical bytes, collectives, `quantized`, `exact_fp32`,
    the flat quantized wire's fallback from scatter, and the describe line
    equal JAX's BucketPlan's (test_comm_quant.py:155-212)."""
    from deepspeed_tpu.runtime.comm import bucketing as jb
    from deepspeed_tpu_torch.runtime.comm import bucketing as tb

    case = dict(case)
    jtree, leaves = _tree_pair()
    kw = {"dp_size": 8, "bucket_elems": case.pop("bucket_elems", 128),
          **case}
    jkw, tkw = dict(kw), dict(kw)
    if "levels" in case:
        inner, outer = case["levels"]
        jkw["levels"] = (jb.WireLevel("data_inner", 4, inner),
                         jb.WireLevel("data_outer", 2, outer))
        tkw["levels"] = (tb.WireLevel("data_inner", 4, inner),
                         tb.WireLevel("data_outer", 2, outer))
    jplan = jb.BucketPlan(jtree, **jkw)
    plan = tb.BucketPlan(leaves, **tkw)
    for attr in _ATTRS:
        assert getattr(plan, attr) == getattr(jplan, attr), attr
    assert [(b.n_elems, b.padded) for b in plan.buckets] == \
        [(b.n_elems, b.padded) for b in jplan.buckets]
    assert plan.describe() == jplan.describe()
    for n in (0, 1, 31, 1000, 123457):
        for w in ("int8", "int4"):
            for padded in (True, False):
                assert tb.wire_nbytes(n, w, 32, padded=padded) == \
                    jb.wire_nbytes(n, w, 32, padded=padded)


def test_plan_errors_match_jax():
    """A quantized inner level is refused naming the wire
    (test_comm_quant.py:192), and a typo names the whole valid set
    (:201)."""
    from deepspeed_tpu_torch.runtime.comm import bucketing as tb

    _, leaves = _tree_pair()
    for wire in ("int8", "int4"):
        levels = (tb.WireLevel("data_inner", 4, wire),
                  tb.WireLevel("data_outer", 2, "fp32"))
        with pytest.raises(ValueError,
                           match=f"{wire} wire is gather-structured"):
            tb.BucketPlan(leaves, dp_size=8, bucket_elems=128, levels=levels)
    with pytest.raises(ValueError, match=r"int8.*int4"):
        tb.BucketPlan(leaves, dp_size=8, bucket_elems=128, wire="in8")
    levels = (tb.WireLevel("data_inner", 4, "fp32"),
              tb.WireLevel("data_outer", 2, "int2"))
    with pytest.raises(ValueError, match=r"outer-level.*int2"):
        tb.BucketPlan(leaves, dp_size=8, bucket_elems=128, levels=levels)


def test_comm_config_quantized_wires():
    """JAX's config rules (test_comm_quant.py:225-281): a typo names the
    key and every wire; an explicit quantized inner wire is refused, an
    inherited one lowers to fp32; quant_block_size is validated;
    fp32_allreduce overrides a quantized wire."""
    from deepspeed_tpu_torch.runtime.comm.bucketing import WIRE_MODES
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    def comm(world=8, **c):
        return DeepSpeedConfig({"train_batch_size": world, "comm": {
            "gradient_reduction": "bucketed", **c}},
            world_size=world).comm_config

    for key in ("wire_dtype", "wire_dtype_outer", "wire_dtype_inner"):
        with pytest.raises(ValueError) as e:
            comm(**{key: "int7"})
        assert key in str(e.value) and "int7" in str(e.value)
        assert all(w in str(e.value) for w in WIRE_MODES)
    for wire in ("int8", "int4"):
        with pytest.raises(ValueError,
                           match="wire_dtype_inner.*gather-structured"):
            comm(hierarchy=2, wire_dtype_inner=wire)
    c = comm(hierarchy=2, wire_dtype="int8")
    assert (c.wire_dtype_inner, c.wire_dtype_outer) == ("fp32", "int8")
    for bad in (0, 33):
        with pytest.raises(ValueError, match="quant_block_size"):
            comm(quant_block_size=bad)
    assert comm(wire_dtype="int4", quant_block_size=64).quant_block_size \
        == 64
    c = DeepSpeedConfig({"train_batch_size": 8, "fp32_allreduce": True,
                         "comm": {"wire_dtype": "int8",
                                  "wire_dtype_outer": "int4"}},
                        world_size=8).comm_config
    assert (c.wire_dtype, c.wire_dtype_outer) == ("fp32", "fp32")


# -- training through the wire -----------------------------------------------


@pytest.mark.parametrize("name,wire", [("z0-int8", "int8"),
                                       ("z0-int4", "int4"),
                                       ("z1-int8", "int8"),
                                       ("z2-int8", "int8")])
def test_world2_quantized_wire_tracks_fp32(world2, name, wire):
    """ZeRO 0/1/2 through the flat int8 wire and ZeRO 0 through int4 at
    world 2 track the fp32 wire from the same weights and batches; every
    rank ends with the same masters; `bucket.all_gather` and
    `grad_wire.reduce` equal the plan's bytes a step."""
    jobs, ranks = world2
    ref_name = name.split("-")[0] + "-fp32"
    for res in ranks:
        got, ref = res[name], res[ref_name]
        assert got["plan"]["quantized"] and not got["plan"]["exact_fp32"]
        assert not got["plan"]["scatter"]   # a gather wire: no scatter
        assert f"quant block=32" in got["plan"]["describe"]
        _assert_tracks(ref, got, wire)
        c = got["counters"]
        assert c["bucket.all_gather"]["bytes"] == \
            got["plan"]["bytes"] * STEPS
        assert c["grad_wire.reduce"]["bytes"] == \
            got["plan"]["bytes"] * STEPS
        assert ref["plan"]["exact_fp32"]
    for n in ranks[0][name]["masters"]:
        assert np.array_equal(ranks[0][name]["masters"][n],
                              ranks[1][name]["masters"][n])


def test_world2_nonfinite_gradient_skips_through_the_quantized_wire(world2):
    """An inf in one rank's gradient crosses the int8 wire as its marker
    code and comes back non-finite on every rank: both skip the step and
    halve the loss scale (after test_comm_quant.py:542)."""
    _, ranks = world2
    for res in ranks:
        got = res["overflow-int8"]
        assert got["skipped"] == 1
        assert got["scales"][1] == got["scales"][0] / 2
        assert all(np.isfinite(v).all() for v in got["masters"].values())


@pytest.mark.parametrize("name,wire", [("h2-int8", "int8"),
                                       ("h1-int4", "int4")])
def test_world4_hierarchy_quantized_outer_hop_tracks_fp32(world4, name,
                                                          wire):
    """Outer 2 × inner 2: the fp32 reduce-scatter inside a node, the
    int8 / int4 gather on the slow hop only (`bucket.inter.all_gather`
    equal to the plan's inter bytes a step), at ZeRO 2 and 1, track the
    all-fp32 hierarchy."""
    _, ranks = world4
    ref_name = name.split("-")[0] + "-fp32"
    for res in ranks:
        got = res[name]
        assert got["plan"]["quantized"]
        _assert_tracks(res[ref_name], got, wire)
        c = got["counters"]
        assert c["bucket.inter.all_gather"]["bytes"] == \
            got["plan"]["inter"] * STEPS
        assert "bucket.inter.psum" not in c

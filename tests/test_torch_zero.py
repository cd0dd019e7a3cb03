"""Port parity: the ZeRO partition plan (runtime/zero/partition.py), the
bucketed gradient wire's layout (runtime/comm/bucketing.py), the 24-bit
frexp codec (runtime/comm/compressed_ar.py), the `comm` config section
and the process-group mesh (comm/) against the JAX package.

Everything here is layout or integer/bit arithmetic, so the comparisons
are exact: the per-leaf partition specs equal JAX's `ZeroShardingPlan`
(over the 8 CPU devices of the test harness) leaf for leaf; the buckets,
offsets, padding and wire byte counts equal JAX's `BucketPlan`; the
codec's outputs equal JAX's bit for bit, NaN payloads aside (a NaN is
compared as a NaN).  The collectives themselves run in spawned gloo
worlds (tests/test_torch_dp.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepspeed_tpu_torch.comm import dist as tdist  # noqa: E402
from deepspeed_tpu_torch.comm import mesh as tmesh  # noqa: E402
from deepspeed_tpu_torch.models import GPT, gpt2_config  # noqa: E402
from deepspeed_tpu_torch.models.convert import jax_leaf_order  # noqa: E402
from deepspeed_tpu_torch.runtime.comm import bucketing as tb  # noqa: E402
from deepspeed_tpu_torch.runtime.comm import compressed_ar as tca  # noqa
from deepspeed_tpu_torch.runtime.zero import partition as tp  # noqa: E402

torch.set_num_threads(1)


def _port_leaves():
    """The port's GPT-2 nano masters in the JAX tree's leaf order."""
    model = GPT(gpt2_config("nano", vocab_size=64, max_seq_len=32),
                device="cpu")
    names, params = zip(*model.named_parameters())
    order = jax_leaf_order(names)
    return [params[i] for i in order], [names[i] for i in order]


def _jax_tree():
    import jax

    from deepspeed_tpu.models import GPT as JaxGPT
    from deepspeed_tpu.models import gpt2_config as jax_gpt2_config

    cfg = jax_gpt2_config("nano", vocab_size=64, max_seq_len=32,
                          shard_activations=False)
    return JaxGPT(cfg).init(jax.random.PRNGKey(0))


def _port_mesh(dp, outer=1, rank=0):
    return tmesh.MeshInfo(axis_sizes={"pipe": 1, "data": dp, "seq": 1,
                                      "model": 1},
                          data_hierarchy=(outer, dp // outer)
                          if outer > 1 else None, rank=rank)


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("dp,outer", [(2, 1), (4, 1), (8, 1), (4, 2)])
def test_partition_plan_matches_jax(dp, outer, stage):
    """Per leaf, the port's optimizer-state and gradient specs are JAX's
    `ZeroShardingPlan` choice (add_data_axis: the largest divisible dim,
    whole below 1024 elements; hpZ: `data_inner` only), and so are the
    partition layout and the describe line.  Every rank's slices tile
    each sharded leaf exactly once."""
    import jax

    from deepspeed_tpu.comm.mesh import make_mesh
    from deepspeed_tpu.runtime.zero.partition import ZeroShardingPlan

    tree = _jax_tree()
    jmesh = make_mesh(data=dp, data_outer=outer, devices=jax.devices()[:dp],
                      set_current=False)
    jplan = ZeroShardingPlan(stage, jmesh, tree)
    leaves, _ = _port_leaves()
    shapes = [tuple(p.shape) for p in leaves]
    plans = [tp.ZeroShardingPlan(stage, _port_mesh(dp, outer, r), shapes)
             for r in range(dp)]
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    for attr in ("opt_spec", "grad_spec", "param_spec"):
        want = [tuple(s) + (None,) * (len(shape) - len(tuple(s)))
                for s, shape in zip(jax.tree_util.tree_leaves(
                    getattr(jplan, attr), is_leaf=is_spec), shapes)]
        assert getattr(plans[0], attr) == want, attr
    assert plans[0].partition_layout() == jplan.partition_layout()
    assert plans[0].describe() == jplan.describe()
    assert plans[0].partitioned
    for i, shape in enumerate(shapes):
        lp = plans[0].leaves[i]
        if not lp.sharded:
            continue
        cover = np.zeros(shape, np.int32)
        for plan in plans:
            idx = plan.leaves[i].piece_index(plan.leaves[i].index)
            cover[tuple(slice(a, b) for a, b in idx)] += 1
        # flat: each slice once; hpZ: once per outer group
        assert (cover == outer).all(), i


_FLAT = [("fp32", 0, 1, 500_000_000), ("fp32", 2, 1, 5_000),
         ("bf16", 2, 1, 5_000), ("split", 2, 1, 5_000), ("bf16", 1, 1, 3_000)]
_HIER = [("fp32", 2, 2, 5_000), ("fp32", 1, 2, 7_000), ("bf16", 2, 2, 5_000)]


@pytest.mark.parametrize("dp,wire,stage,outer,cap",
                         [(dp,) + c for dp in (2, 4, 8) for c in _FLAT] +
                         [(dp,) + c for dp in (4, 8) for c in _HIER])
def test_bucket_plan_matches_jax(dp, wire, stage, outer, cap):
    """The BucketPlan of the GPT-2 nano gradient tree: buckets (dtype,
    slots, payload and padded lengths), the scatter lowering and every
    wire byte and collective count equal JAX's."""
    import jax

    from deepspeed_tpu.runtime.comm.bucketing import (BucketPlan, WireLevel,
                                                      wire_nbytes)

    tree = jax.tree_util.tree_map(lambda a: a.astype("float32"), _jax_tree())
    scatter = stage >= 2
    jlevels = tlevels = None
    if outer > 1:
        jlevels = (WireLevel("data_inner", dp // outer, wire),
                   WireLevel("data_outer", outer, wire))
        tlevels = tuple(tb.WireLevel(*lv) for lv in jlevels)
    jplan = BucketPlan(tree, dp_size=dp, bucket_elems=cap, wire=wire,
                       scatter=scatter, levels=jlevels)
    leaves, _ = _port_leaves()
    plan = tb.BucketPlan(leaves, dp_size=dp, bucket_elems=cap, wire=wire,
                         scatter=scatter, levels=tlevels)
    assert plan.scatter == jplan.scatter
    assert len(plan.buckets) == len(jplan.buckets)
    for b, jb in zip(plan.buckets, jplan.buckets):
        assert (b.n_elems, b.padded) == (jb.n_elems, jb.padded)
        assert str(b.dtype).split(".")[-1] == np.dtype(jb.dtype).name
        assert [tuple(s) for s in b.slots] == [tuple(s) for s in jb.slots]
    for attr in ("wire_bytes_per_reduction",
                 "wire_bytes_logical_per_reduction",
                 "collectives_per_reduction",
                 "wire_bytes_intra_per_reduction",
                 "wire_bytes_inter_per_reduction",
                 "collectives_intra_per_reduction",
                 "collectives_inter_per_reduction"):
        assert getattr(plan, attr) == getattr(jplan, attr), attr
    for n in (0, 1, 1000, 123457):
        assert tb.wire_nbytes(n, wire, 256) == wire_nbytes(n, wire, 256)
    # flatten / unflatten round trip, in the plan's layout
    grads = [torch.randn(p.shape) for p in leaves]
    flat = plan.flatten(grads)
    assert [f.numel() for f in flat] == [b.padded for b in plan.buckets]
    back = plan.unflatten(flat)
    assert all(torch.equal(a, b) for a, b in zip(grads, back))


def _codec_values():
    """Subnormals, ±2^127 and above, inf and nan, zeros, and a spread of
    normal values over the whole exponent range."""
    special = np.array([0.0, -0.0, 1.0, -1.5, 2.0 ** -126, 2.0 ** -127,
                        1e-45, -3e-40, 2.0 ** -149, 2.0 ** 127, -2.0 ** 127,
                        3.4e38, -3.4028235e38, 1.5 * 2.0 ** 126, np.inf,
                        -np.inf, np.nan, 65504.0, 1e5, 1e-5, 0.3],
                       np.float32)
    rs = np.random.RandomState(0)
    spread = (rs.randn(4000) * np.exp(rs.uniform(-95, 86, 4000)))
    return np.concatenate([special, spread.astype(np.float32)])


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype.kind == "f":
        nan = np.isnan(a)
        assert np.array_equal(nan, np.isnan(b))
        a, b = a[~nan], b[~nan]
    return np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("fn", ["decompose", "decompose_int8_safe",
                                "reconstruct", "reconstruct_wrapped"])
def test_compressed_ar_is_bitwise_with_jax(fn):
    import jax.numpy as jnp

    from deepspeed_tpu.runtime.comm import compressed_ar as jca

    vals = _codec_values()
    jv, tv = jnp.asarray(vals), torch.from_numpy(vals)
    if fn in ("decompose", "decompose_int8_safe"):
        jm, je = getattr(jca, fn)(jv)
        tm, te = getattr(tca, fn)(tv)
        assert _bits_equal(tm.numpy(), np.asarray(jm))
        assert np.array_equal(te.numpy().astype(np.int32),
                              np.asarray(je).astype(np.int32))
        assert str(te.dtype).split(".")[-1] == np.asarray(je).dtype.name
        return
    dec = "decompose" if fn == "reconstruct_wrapped" else \
        "decompose_int8_safe"
    jm, je = getattr(jca, dec)(jv)
    tm, te = getattr(tca, dec)(tv)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jca.reconstruct(jm, je, jdt)).astype(np.float32)
        got = tca.reconstruct(tm, te, tdt).float().numpy()
        assert _bits_equal(got, want)
    # ldexp over the whole exponent range, and past it both ways
    m = np.random.RandomState(1).randn(6000).astype(np.float32) * 4
    e = np.random.RandomState(2).randint(-300, 300, 6000).astype(np.int32)
    assert _bits_equal(tca._ldexp(torch.from_numpy(m),
                                  torch.from_numpy(e)).numpy(),
                       np.asarray(jnp.ldexp(jnp.asarray(m),
                                            jnp.asarray(e))))


def test_one_rank_collectives_are_the_identity():
    """Without a process group the mesh is one rank, has no groups, and
    every collective returns its input (counted in `dist.*`)."""
    from deepspeed_tpu_torch.monitor.counters import COUNTERS

    assert not tdist.is_initialized()
    mi = tmesh.make_mesh(set_current=False)
    assert mi.axis_size("data") == 1 and mi.group("data") is None
    x = torch.arange(6.0).reshape(2, 3)
    snap = COUNTERS.snapshot()
    assert torch.equal(tdist.all_reduce(x.clone()), x)
    assert torch.equal(tdist.all_gather(x, gather_axis=1), x)
    assert torch.equal(tdist.reduce_scatter(x), x)
    assert torch.equal(tdist.broadcast(x), x)
    assert torch.equal(tdist.all_gather(x, tiled=False), x[None])
    d = COUNTERS.delta_since(snap)
    assert d["dist.all_reduce"]["bytes"] == 24
    assert d["dist.all_gather"]["calls"] == 2
    assert tca.compressed_all_reduce(x) is x
    assert tdist.backend_for("cpu") == "gloo"
    assert tdist.backend_for("cuda") == "nccl"
    assert tdist.backend_for("cuda", "gloo") == "gloo"
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tdist.backend_for("cpu", "nccl")
    assert tmesh.largest_divisible_axis((48, 144), 2) == 1
    assert tmesh.largest_divisible_axis((3, 5), 2) is None


@pytest.mark.parametrize("comm,err,match", [
    ({"gradient_reduction": "fused"}, ValueError,
     "gradient_reduction must be one of"),
    ({"wire_dtype": "fp8"}, ValueError, "wire_dtype must be one of"),
    ({"hierarchy": "two"}, ValueError, "comm.hierarchy must be"),
    ({"hierarchy": {"outer": 2, "inner": 2}}, ValueError, "unknown key"),
    ({"hierarchy": 3}, ValueError, "does not divide"),
    ({"wire_dtype_inner": "int8"}, ValueError, "gather-structured"),
    ({"quant_block_size": 3}, ValueError, "quant_block_size"),
    ({"overlap": "sometimes"}, ValueError, "overlap must be one of"),
    ({"overlap_timeout_ms": 0}, ValueError, "must be >= 1"),
    ({"wire_dtype": "int8"}, NotImplementedError, "quantized wires"),
    ({"wire_dtype_outer": "int4", "hierarchy": 2}, NotImplementedError,
     "quantized wires"),
    ({"overlap": True}, NotImplementedError, "quantized wires"),
])
def test_comm_section_is_validated_at_config_time(comm, err, match):
    """JAX's keys and errors (config.py:116-250); a valid selection the
    port does not run raises NotImplementedError naming its ROADMAP
    item."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    with pytest.raises(err, match=match):
        DeepSpeedConfig({"train_batch_size": 4, "comm": comm}, world_size=4)


def test_comm_section_defaults_and_fp32_allreduce():
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    c = DeepSpeedConfig({"train_batch_size": 4,
                         "zero_optimization": {"stage": 2,
                                               "reduce_bucket_size": 77}},
                        world_size=2).comm_config
    assert (c.gradient_reduction, c.wire_dtype, c.hierarchy,
            c.reduce_bucket_size, c.overlap) == \
        ("implicit", "fp32", "none", 77, "none")
    c = DeepSpeedConfig({"train_batch_size": 4, "fp32_allreduce": True,
                         "comm": {"wire_dtype": "bf16", "hierarchy": "auto",
                                  "wire_dtype_outer": "split"}},
                        world_size=4).comm_config
    assert (c.wire_dtype, c.wire_dtype_inner, c.wire_dtype_outer,
            c.hierarchy) == ("fp32", "fp32", "fp32", "auto")
    c = DeepSpeedConfig({"train_batch_size": 4,
                         "comm": {"wire_dtype": "split", "hierarchy": 2}},
                        world_size=4).comm_config
    # the inner level cannot carry the gather-structured split wire
    assert (c.wire_dtype_inner, c.wire_dtype_outer) == ("fp32", "split")

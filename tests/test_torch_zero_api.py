"""Port parity: ZeRO-3's API surface — `zero.Init`, `zero.GatheredParameters`
(runtime/zero/partition_parameters.py), `zero.TiledLinear`
(runtime/zero/tiling.py) and `utils/zero_to_fp32.py` — against the JAX
package's own cases (tests/test_zero_init.py).

The collectives run in one spawned gloo world of 2 ranks on the CPU,
once a session (tests/test_torch_qgz.py `run_once`); the tags come from
tests/test_torch_zero3.py's world (the same `run_once` result).
Tolerances, with their reasons:

* `Init`'s slices, `GatheredParameters`' whole values and re-shards,
  `zero_to_fp32`'s leaves: exact (copies and collectives of fp32 bits);
* a model built under `Init` and one the engine slices, trained at
  stage 3, and `TiledLinear` at stage 3 against stage 2: bitwise (the
  same slices, the same gathers);
* `TiledLinear` against JAX's on the same tile parameters: fp32, 1e-6
  relative to each tensor's largest magnitude (two libraries' fp32
  products, summed over the same tiles in the same order).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_zero3 import world2  # noqa: E402,F401  (the shared tags)

torch.set_num_threads(1)


def _port_mesh(dp, rank):
    from deepspeed_tpu_torch.comm import mesh as tmesh

    return tmesh.MeshInfo(axis_sizes={"pipe": 1, "data": dp, "seq": 1,
                                      "model": 1}, rank=rank)


def _nano(seed=0):
    from deepspeed_tpu_torch.models import GPT, gpt2_config

    return GPT(gpt2_config("nano", vocab_size=64, max_seq_len=32),
               device="cpu", generator=torch.Generator().manual_seed(seed))


# -- Init (no world: the plan needs only the rank's index) ----------------------


def test_zero_init_materializes_slices_and_moves_only_them():
    """Under `Init` each sharded leaf reaches the device as this rank's
    slice only (no whole sharded leaf is ever moved there), tagged with
    its whole shape; the ranks' slices are the plain build's values, and
    the leaves the plan keeps whole go to the device whole."""
    from deepspeed_tpu_torch import zero

    plain = dict(_nano().named_parameters())
    whole = {n: p.numel() for n, p in plain.items()}
    slices = []
    real_to = torch.Tensor.to
    for r in range(2):
        moved = []

        def spy(t, *a, **kw):
            out = real_to(t, *a, **kw)
            if out.device.type == "meta":
                moved.append(t.numel())
            return out

        torch.Tensor.to = spy
        try:
            with zero.Init(mesh_info=_port_mesh(2, r),
                           device="meta") as zinit:
                model = zinit.materialize(_nano)
        finally:
            torch.Tensor.to = real_to
        sharded = {n for n, p in model.named_parameters()
                   if hasattr(p, "ds_shape")}
        assert sharded and len(zinit.plan.gathered) == len(sharded)
        # what reached the device is exactly the slices and the whole
        # unsharded leaves, each once
        assert sum(moved) == sum(p.numel() for p in model.parameters())
        for n, p in model.named_parameters():
            assert p.device.type == "meta"
            if n in sharded:
                assert tuple(p.ds_shape) == tuple(plain[n].shape)
                assert p.numel() * 2 == whole[n]
                assert p.ds_partition.index == r
            else:
                assert p.shape == plain[n].shape
        # the same slices on the host, for their values
        host = zero.Init(mesh_info=_port_mesh(2, r), remote_device="cpu",
                         device="meta").materialize(_nano)
        slices.append({n: p for n, p in host.named_parameters()
                       if hasattr(p, "ds_shape")})
        assert all(p.device.type == "cpu" for p in slices[-1].values())
    for n, a in slices[0].items():
        lp = a.ds_partition
        full = torch.cat([a.data, slices[1][n].data], dim=lp.dim)
        assert torch.equal(full, plain[n].data), n
    off = zero.Init(enabled=False).materialize(_nano)
    assert not any(hasattr(p, "ds_shape") for p in off.parameters())


# -- TiledLinear against JAX's ---------------------------------------------------


def _tiled_pair(in_f, out_f, ins, outs, remat=False, init=None):
    import jax

    from deepspeed_tpu.runtime.zero.tiling import TiledLinear as JTiled
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.models.convert import load_jax_params

    jt = JTiled(in_f, out_f, in_splits=ins, out_splits=outs,
                remat_each_tile=remat, init_linear=init)
    params = jax.tree_util.tree_map(np.asarray,
                                    jt.init(jax.random.PRNGKey(0)))
    tt = zero.TiledLinear(in_f, out_f, in_splits=ins, out_splits=outs,
                          remat_each_tile=remat, device="cpu")
    load_jax_params(tt, params)
    return jt, params, tt


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() + 1e-30
    assert np.abs(got - want).max() <= tol * scale


@pytest.mark.parametrize("in_splits,out_splits", [(1, 1), (2, 2), (3, 4)])
def test_tiled_linear_matches_jax(in_splits, out_splits):
    """The tiles are parameters named as JAX's tree (`tiles.<o>.<i>.w`,
    `bias.<o>`) at partition_uniform's boundaries; on JAX's tile values
    the output and the gradients of every tile and bias are JAX's."""
    import jax
    import jax.numpy as jnp

    jt, params, tt = _tiled_pair(48, 40, in_splits, out_splits)
    assert tt.in_parts == jt.in_parts and tt.out_parts == jt.out_parts
    x = np.random.RandomState(1).randn(4, 48).astype(np.float32)
    want = jt(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    xt = torch.from_numpy(x)
    y = tt(xt)
    _close(y.detach().numpy(), want)
    jg = jax.grad(lambda p: jnp.sum(jt(p, jnp.asarray(x)) ** 2))(
        jax.tree_util.tree_map(jnp.asarray, params))
    (y ** 2).sum().backward()
    for o in range(out_splits):
        for i in range(in_splits):
            _close(tt.tiles[o][i].w.grad.numpy(),
                   jg["tiles"][o][i]["w"])
        _close(tt.bias[o].grad.numpy(), jg["bias"][o])
    _close(tt.full_weight().detach().numpy(), jt.full_weight(params))


def test_tiled_linear_from_existing_weight_and_remat_grads():
    """`init_linear` (JAX's {"w", "b"} dict, or an nn.Linear) is cut into
    the tiles exactly; `remat_each_tile` recomputes each output tile's
    row and gives the unrematerialised gradients."""
    from deepspeed_tpu_torch import zero

    w = np.random.RandomState(0).randn(20, 12).astype(np.float32)
    b = np.random.RandomState(1).randn(12).astype(np.float32)
    jt, params, tt = _tiled_pair(20, 12, 2, 3, init={"w": w, "b": b})
    assert np.array_equal(tt.full_weight().detach().numpy(), w)
    lin = torch.nn.Linear(20, 12)
    tl = zero.TiledLinear(20, 12, in_splits=2, out_splits=3,
                          init_linear=lin, device="cpu")
    assert torch.equal(tl.full_weight(), lin.weight.t())
    x = torch.from_numpy(np.random.RandomState(2).randn(5, 20)
                         .astype(np.float32))
    _close(tt(x).detach().numpy(), x.numpy() @ w + b)
    grads = []
    for remat in (False, True):
        m = zero.TiledLinear(16, 16, in_splits=2, out_splits=2,
                             remat_each_tile=remat, device="cpu")
        (m(x[:, :16]) ** 2).sum().backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    for a, b_ in zip(*grads):
        assert torch.equal(a, b_)


# -- the world: GatheredParameters, Init into the engine, TiledLinear at 3 -----


class _TiledModel(torch.nn.Module):
    """A two-layer MLP of TiledLinear layers, each tile a gather unit."""

    def __init__(self):
        super().__init__()
        from deepspeed_tpu_torch import zero

        g = torch.Generator().manual_seed(0)
        self.l1 = zero.TiledLinear(64, 128, in_splits=2, out_splits=2,
                                   device="cpu", generator=g)
        self.l2 = zero.TiledLinear(128, 32, in_splits=2, out_splits=1,
                                   device="cpu", generator=g)

    def forward(self, batch, generator=None, train=True, row_offset=0):
        x, y = batch
        h = torch.tanh(self.l1(x.float()))
        return (self.l2(h) - y.float()).square().mean()


class _RematModel(torch.nn.Module):
    """No gather unit, and a checkpointed region that reads the module's
    parameters: its recomputation in the backward reads the root
    group's backward replicas."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(1)
        self.w1 = torch.nn.Parameter(torch.randn(64, 64, generator=g) * 0.1)
        self.w2 = torch.nn.Parameter(torch.randn(64, 32, generator=g) * 0.1)

    def _body(self, x):
        return torch.tanh(x @ self.w1) @ self.w2

    def forward(self, batch, generator=None, train=True, row_offset=0):
        x, y = batch
        h = torch.utils.checkpoint.checkpoint(self._body, x.float(),
                                              use_reentrant=False)
        return (h - y.float()).square().mean()


def _cfg(stage, micro=4):
    return {"train_batch_size": micro * 2,
            "train_micro_batch_size_per_gpu": micro,
            "optimizer": {"type": "Adam", "params": {"lr": 3e-3}},
            "zero_optimization": {"stage": stage}, "steps_per_print": 0,
            "gradient_clipping": 1.0}


def _run(model, cfg, batches):
    import deepspeed_tpu_torch as dt

    eng, *_ = dt.initialize(model=model, config_params=cfg, device="cpu")
    losses = []
    for b in batches:
        losses.append(float(eng.forward(b)))
        eng.backward()
        eng.step()
    out = {"losses": losses, "masters": eng.module_state_dict()}
    if eng._stage3 is not None:
        out.update(peak=eng._stage3.peak_bytes,
                   group_bytes=eng._stage3.group_bytes())
    return out


def _worker(rank, store, out_dir):
    torch.set_num_threads(1)
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.comm import dist
    from deepspeed_tpu_torch.comm.mesh import make_mesh

    dt.init_distributed(init_method=f"file://{store}", world_size=2,
                        rank=rank, device="cpu", verbose=False)
    res = {}
    try:
        make_mesh(data=-1)
        rs = np.random.RandomState(0)
        toks = [rs.randint(0, 64, (8, 17)) for _ in range(3)]
        gpt_batches = [(t[:, :-1], t[:, 1:]) for t in toks]
        # GatheredParameters: whole values inside; rank 0's edits kept
        # with modifier_rank 0, every edit dropped without
        model = zero.Init(device="cpu").materialize(_nano)
        p = model.wte
        mine = p.data.clone()
        with zero.GatheredParameters(model.parameters()) as g:
            res["whole"] = p.data.clone().numpy()
            res["n_gathered"] = len(g.params)
            p.data.mul_(5.0)
        res["dropped"] = torch.equal(p.data, mine)
        with zero.GatheredParameters([p], modifier_rank=0):
            p.data.mul_(2.0 if rank == 0 else 3.0)
        res["kept"] = p.data.clone().numpy()
        res["mine"] = mine.numpy()
        # a model built under Init trains as one the engine slices
        res["init"] = _run(zero.Init(device="cpu").materialize(_nano),
                           _cfg(3), gpt_batches)
        res["sliced"] = _run(_nano(), _cfg(3), gpt_batches)
        rs = np.random.RandomState(1)
        mlp = [(rs.randn(8, 64).astype(np.float32),
                rs.randn(8, 32).astype(np.float32)) for _ in range(3)]
        res["tiled-z3"] = _run(_TiledModel(), _cfg(3), mlp)
        res["tiled-z2"] = _run(_TiledModel(), _cfg(2), mlp)
        res["remat-z3"] = _run(_RematModel(), _cfg(3), mlp)
        res["remat-z2"] = _run(_RematModel(), _cfg(2), mlp)
    finally:
        dist.barrier()
        dist.destroy()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _world(tmp):
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, str(tmp / "store"),
                                               str(tmp)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(240)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


@pytest.fixture(scope="module")
def api_world(tmp_path_factory):
    from test_torch_qgz import run_once

    return run_once(tmp_path_factory, "zero-api-world2", _world)


def test_gathered_parameters_modifier_rank_edits_survive(api_world):
    plain = _nano().wte.detach().numpy()
    for rank, res in enumerate(api_world):
        assert np.array_equal(res["whole"], plain)
        assert res["n_gathered"] >= 2
        assert res["dropped"]
        # rank 0's doubled values, this rank's slice of them
        want = np.split(plain * np.float32(2.0), 2, axis=0)[rank]
        assert np.array_equal(res["kept"], want), rank
        assert np.array_equal(res["mine"], np.split(plain, 2, axis=0)[rank])


def test_init_model_trains_as_the_engine_sliced_one(api_world):
    for res in api_world:
        a, b = res["init"], res["sliced"]
        assert a["losses"] == b["losses"]
        for n in a["masters"]:
            assert np.array_equal(a["masters"][n], b["masters"][n]), n


def test_tiled_linear_at_stage3_is_bitwise_stage2(api_world):
    """Each tile is gathered on its own (a gather unit): stage 3 trains
    as stage 2 bit for bit, and the live replicas never exceed one tile
    (the biases, under 1024 elements, stay whole)."""
    for res in api_world:
        a, b = res["tiled-z3"], res["tiled-z2"]
        assert a["losses"] == b["losses"]
        for n in a["masters"]:
            assert np.array_equal(a["masters"][n], b["masters"][n]), n
        gb = a["group_bytes"]
        assert len(gb) == 6 and 0 < a["peak"] <= max(gb)


def test_checkpointed_region_outside_units_recomputes_at_stage3(api_world):
    """A model with no gather unit whose checkpointed region reads its
    parameters: stage 3 (the whole model one root group, its backward
    gather installed for the recomputation) trains as stage 2 bit for
    bit."""
    for res in api_world:
        a, b = res["remat-z3"], res["remat-z2"]
        assert a["losses"] == b["losses"]
        for n in a["masters"]:
            assert np.array_equal(a["masters"][n], b["masters"][n]), n


# -- zero_to_fp32 -----------------------------------------------------------------


def test_zero_to_fp32_reads_a_port_stage3_tag(world2, tmp_path):  # noqa
    """The port's world-2 stage-3 tag: its `model:` pieces come back as
    the saved fp32 masters; the msgpack file holds the same tree, and
    JAX's flax reads it."""
    from flax import serialization

    from deepspeed_tpu_torch.models.convert import (flatten_tree,
                                                    load_jax_params)
    from deepspeed_tpu_torch.runtime import checkpointing as ck
    from deepspeed_tpu_torch.utils import zero_to_fp32 as z2f

    saved = world2["ranks"][0]["save-z3"]["saved"]["masters"]
    sd = flatten_tree(z2f.get_fp32_state_dict_from_zero_checkpoint(
        world2["ckpt"], "z3w2"))
    assert set(sd) == set(saved)
    for n, v in saved.items():
        assert sd[n].dtype == np.float32 and np.array_equal(sd[n], v), n
    out = tmp_path / "fp32.msgpack"
    assert z2f.main([world2["ckpt"], str(out), "-t", "z3w2"]) == 0
    blob = out.read_bytes()
    for tree in (ck.msgpack_restore(blob),
                 serialization.msgpack_restore(blob)):
        flat = flatten_tree(tree)
        for n, v in saved.items():
            assert np.array_equal(np.asarray(flat[n]), v), n
    model = _nano()
    load_jax_params(model, z2f.load_state_dict_from_zero_checkpoint(
        world2["ckpt"], "z3w2"))
    for n, p in model.named_parameters():
        assert np.array_equal(p.detach().numpy(), saved[n]), n
    assert z2f.main([str(tmp_path / "missing"), str(out)]) == 1


def test_zero_to_fp32_reads_a_jax_stage3_tag(world2):  # noqa: F811
    """The JAX engine's dp-8 stage-3 tag: the port's tool gives the
    module JAX's own loader reassembles, in fp32."""
    import deepspeed_tpu.runtime.checkpointing as jck
    from deepspeed_tpu_torch.models.convert import flatten_tree
    from deepspeed_tpu_torch.utils import zero_to_fp32 as z2f

    jdir = os.path.join(os.path.dirname(world2["ckpt"]), "jax")
    _, ms, _ = jck.load_checkpoint_state(jdir, "jz3")
    want = flatten_tree(ms["module"])
    got = flatten_tree(z2f.get_fp32_state_dict_from_zero_checkpoint(jdir,
                                                                     "jz3"))
    assert set(got) == set(want)
    for n in want:
        assert got[n].dtype == np.float32
        assert np.array_equal(got[n], np.asarray(want[n])), n

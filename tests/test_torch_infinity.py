"""ZeRO-Infinity in the port (models/gpt.py's streaming protocol,
runtime/zero/infinity.py, the engine's streamed path, stream-group tags)
against the JAX package's and against the port's own resident engine.

Tolerances, with their reasons:

* the stream stages against JAX's on the same converted groups, fp32:
  atol 1e-5 (test_torch_train.py's fp32 bound: the same arithmetic, sums
  in other orders);
* the streamed engine against the resident one, fp32: losses rtol 1e-4,
  masters rtol 5e-3 + atol 1e-5 (JAX's own, tests/test_infinity.py:
  66-92: the host Adam and FusedAdam round in another order);
* the port's Infinity against JAX's (fp32, mesh data 8 on the JAX side):
  losses atol 1e-5, masters atol 1e-4 (test_torch_train.py's curves);
* gradient accumulation against one big step: the summed gradients
  within 1e-5 of each leaf's largest |grad| (fp32 sums in other orders),
  the masters within the streamed-vs-resident bound above (JAX's test
  holds them to rtol 2e-5 + atol 2e-6, which a gradient near Adam's eps
  breaks on other data: its first update is sign-sized either way);
* NVMe paging against RAM and a resume against the run it resumes:
  bitwise, under deterministic algorithms.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu.models import GPT as JaxGPT  # noqa: E402
from deepspeed_tpu.models import gpt2_config as jax_gpt2_config  # noqa: E402
from deepspeed_tpu_torch.models import GPT, gpt2_config  # noqa: E402
from deepspeed_tpu_torch.models.convert import (groups_from_jax,  # noqa: E402
                                                jax_ordered_leaves)
from deepspeed_tpu_torch.runtime import checkpointing as ckpt_io  # noqa: E402

torch.set_num_threads(1)

NANO = dict(vocab_size=128, max_seq_len=32)


def _jax(seed=0, **over):
    jm = JaxGPT(jax_gpt2_config("nano", shard_activations=False, **NANO,
                                **over))
    return jm, jax.tree_util.tree_map(np.asarray,
                                      jm.init(jax.random.PRNGKey(seed)))


def _config(stage3=True, nvme=None, params_nvme=False, gas=1, micro=8,
            jax_side=False):
    cfg = {"train_batch_size": micro * gas,
           "train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "gradient_clipping": 1.0, "steps_per_print": 0}
    if jax_side:
        cfg["mesh"] = {"data": 8}
        cfg["train_micro_batch_size_per_gpu"] = micro // 8
    if stage3:
        dev = ({"device": "nvme", "nvme_path": nvme} if params_nvme
               else {"device": "cpu"})
        cfg["zero_optimization"] = {"stage": 3, "offload_param": dev}
        if nvme:
            cfg["zero_optimization"]["offload_optimizer"] = {
                "device": "nvme", "nvme_path": nvme}
    else:
        cfg["zero_optimization"] = {"stage": 0}
    return cfg


def _port(tree, cfg, **over):
    eng, *_ = dt.initialize(model=GPT(gpt2_config("nano", **NANO, **over),
                                      device="cpu"),
                            model_parameters=tree, config_params=cfg,
                            device="cpu")
    return eng


def _batch(i, B=8, S=16):
    tok = np.random.RandomState(100 + i).randint(0, 128, (B, S + 1))
    return tok[:, :-1], tok[:, 1:]


def _run(eng, batches):
    out = []
    for b in batches:
        out.append(float(eng.forward(b)))
        eng.backward()
        eng.step()
    return out


def _masters(eng):
    return {n: t.detach().float().numpy().copy()
            for n, t in eng.params.items()}


class _deterministic:
    def __enter__(self):
        self.prev = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(self.prev)


@pytest.mark.parametrize("tied", [True, False])
def test_stream_stages_match_jax_on_converted_groups(tied):
    jm, tree = _jax(tie_embeddings=tied)
    groups = dict(groups_from_jax(jm.stream_groups(tree)))
    model = GPT(gpt2_config("nano", **NANO, tie_embeddings=tied),
                device="meta")
    assert [n for n, _ in model.stream_groups(
        {**{k: v for k, v in tree.items()}})] == list(groups)
    tokens, labels = _batch(0)
    valid = labels >= 0
    jx = jm.stream_embed(jax.tree_util.tree_map(jnp.asarray,
                                                dict(jm.stream_groups(
                                                    tree))["embed"]),
                         jnp.asarray(tokens))
    tx = model.stream_embed(groups["embed"], torch.from_numpy(tokens))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    jgroups = dict(jm.stream_groups(tree))
    for i in range(3):
        jx = jm.stream_block(jax.tree_util.tree_map(
            jnp.asarray, jgroups[f"block:{i}"]), jx)
        tx = model.stream_block(groups[f"block:{i}"], tx)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    proj_j = jgroups["embed"]["wte"] if tied else jgroups["head"]["lm_head"]
    proj_t = groups["embed"]["wte"] if tied else groups["head"]["lm_head"]
    jl = jm.stream_head_loss({"ln_f": jax.tree_util.tree_map(
        jnp.asarray, jgroups["head"]["ln_f"])}, jnp.asarray(proj_j), jx,
        jnp.asarray(labels), jnp.asarray(valid))
    tl = model.stream_head_loss({"ln_f": groups["head"]["ln_f"]}, proj_t, tx,
                                torch.from_numpy(labels),
                                torch.from_numpy(valid))
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-5)
    back = model.assemble_groups(groups)
    assert set(back) == set(tree)


def test_stream_init_draws_the_resident_models_weights():
    cfg = gpt2_config("nano", **NANO)
    resident = GPT(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(5))
    streamed = GPT(cfg, device="meta")
    groups = dict(streamed.stream_init(torch.Generator().manual_seed(5)))
    tree = streamed.assemble_groups(groups)
    flat = dict(jax_ordered_leaves(tree))
    for n, p in resident.named_parameters():
        assert torch.equal(flat[n], p.detach()), n


def test_streamed_engine_holds_no_device_parameter_tree():
    _, tree = _jax()
    model = GPT(gpt2_config("nano", **NANO), device="cpu")
    eng, *_ = dt.initialize(model=model, config_params=_config(),
                            device="cpu")
    rt = eng._infinity
    assert rt is not None and eng._opt_state is None and eng._masters == ()
    # the module's own weights became the host masters; it holds none now
    assert all(p.device.type == "meta" for p in model.parameters())
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in eng.params.values())
    assert rt.n_elements == sum(t.numel() for t in eng.params.values())
    assert np.isfinite(float(eng.eval_batch(_batch(0))))
    with pytest.raises(NotImplementedError, match="Infinity"):
        eng.store_gradients = True
    sd = eng.module_state_dict()
    eng.load_module_state_dict({n: np.full_like(v, 0.5) for n, v in
                                sd.items()})
    assert all(bool((t == 0.5).all()) for t in eng.params.values())


def test_streamed_step_tracks_the_resident_engine():
    _, tree = _jax()
    batches = [_batch(i) for i in range(3)]
    streamed = _port(tree, _config())
    resident = _port(tree, _config(stage3=False))
    ls, lr_ = _run(streamed, batches), _run(resident, batches)
    np.testing.assert_allclose(ls, lr_, rtol=1e-4)
    ms, mr = _masters(streamed), _masters(resident)
    for n in mr:
        np.testing.assert_allclose(ms[n], mr[n], rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(float(streamed.eval_batch(_batch(9))),
                               float(resident.eval_batch(_batch(9))),
                               rtol=1e-4)


@pytest.mark.parametrize("tied", [True, False])
def test_port_infinity_tracks_jax_infinity(tied):
    jm, tree = _jax(tie_embeddings=tied)
    batches = [_batch(i) for i in range(3)]
    je, *_ = deepspeed_tpu.initialize(model=jm, model_parameters=tree,
                                      config_params=_config(jax_side=True))
    te = _port(tree, _config(), tie_embeddings=tied)
    assert je._infinity is not None and te._infinity is not None
    np.testing.assert_allclose(_run(te, batches), _run(je, batches),
                               atol=1e-5, rtol=0)
    mj = dict(jax_ordered_leaves(jax.tree_util.tree_map(np.asarray,
                                                        je.params)))
    mt = _masters(te)
    assert set(mj) == set(mt)
    for n in mj:
        np.testing.assert_allclose(mt[n], mj[n], atol=1e-4, rtol=0)
    # the same flat leaf keys: group base + index in JAX order
    assert te._infinity.adam.step_count == je._infinity.adam.step_count
    assert set(te._infinity.state_dict()["state"]) == \
        set(je._infinity.state_dict()["state"])


def test_gradient_accumulation_equals_one_big_step():
    """gas 4 over micro batches of 8 rows sums, in the host sink, the
    gradient gas 1 takes over their 32 rows: the sink over the micro-step
    count within 1e-5 of each leaf's largest |grad| (fp32 sums in other
    orders); the masters after two engine steps within the streamed-vs-
    resident bound (Adam's first steps turn a gradient near eps into
    sign-sized updates)."""
    _, tree = _jax()
    big = _port(tree, _config(micro=32))
    acc = _port(tree, _config(gas=4, micro=8))
    tok, lab = _batch(3, B=32)
    big._infinity.micro_step((tok, lab))
    for m in range(4):
        acc._infinity.micro_step((tok[8 * m:8 * m + 8], lab[8 * m:8 * m + 8]))
    sb, sa = big._infinity._acc_sink, acc._infinity._acc_sink
    assert set(sb) == set(sa) and acc._infinity._acc_count == 4
    for k in sb:
        scale = np.abs(sb[k]).max()
        np.testing.assert_allclose(sa[k] / 4, sb[k], rtol=0,
                                   atol=1e-5 * scale)
    big._infinity.apply_accumulated(lr=1e-3)
    acc._infinity.apply_accumulated(lr=1e-3)
    for _ in range(2):
        big.forward((tok, lab))
        big.backward()
        big.step()
        for m in range(4):
            acc.forward((tok[8 * m:8 * m + 8], lab[8 * m:8 * m + 8]))
            acc.backward()
            acc.step()
    assert acc.global_steps == big.global_steps == 2
    mb, ma = _masters(big), _masters(acc)
    for n in mb:
        np.testing.assert_allclose(ma[n], mb[n], rtol=5e-3, atol=1e-5)


def test_nvme_paging_trains_bitwise_as_ram_and_resumes(tmp_path):
    _, tree = _jax()
    batches = [_batch(i) for i in range(5)]
    nvme = str(tmp_path / "nvme")
    with _deterministic():
        ram = _port(tree, _config())
        paged = _port(tree, _config(nvme=nvme, params_nvme=True))
        rt = paged._infinity
        assert rt.pager is not None and rt.nvme is not None
        assert all(g.flat is None for g in rt.groups.values())
        assert _run(paged, batches[:3]) == _run(ram, batches[:3])
        mr, mp = _masters(ram), _masters(paged)
        assert all(np.array_equal(mr[n], mp[n]) for n in mr)
        assert rt.pager.bytes_read > 0 and rt.nvme.bytes_written > 0
        paged.save_checkpoint(str(tmp_path / "ck"), tag="p3")
        fresh = _port(_jax(seed=4)[1], _config(nvme=nvme, params_nvme=True))
        fresh.load_checkpoint(str(tmp_path / "ck"), tag="p3")
        assert fresh.global_steps == 3
        assert _run(fresh, batches[3:]) == _run(paged, batches[3:])
        mf, mp = _masters(fresh), _masters(paged)
        assert all(np.array_equal(mf[n], mp[n]) for n in mf)


def test_stream_group_tags_cross_between_the_engines(tmp_path):
    """A paged port save is stream-group files + markers; JAX's
    non-paged Infinity engine resolves them and steps on as the port
    does, and a paged JAX save loads in the port (paged or not)."""
    jm, tree = _jax()
    batches = [_batch(i) for i in range(4)]
    nvme = str(tmp_path / "nvme")
    te = _port(tree, _config(nvme=nvme, params_nvme=True))
    _run(te, batches[:2])
    te.save_checkpoint(str(tmp_path / "p"), tag="sg")
    d = tmp_path / "p" / "sg"
    files = sorted(f for f in os.listdir(d) if f.startswith("stream_group_"))
    assert len(files) == len(te._infinity.group_order) == 5
    assert os.path.getsize(ckpt_io.model_ckpt_name(str(d))) < 64 * 1024
    je, *_ = deepspeed_tpu.initialize(model=jm, model_parameters=_jax(7)[1],
                                      config_params=_config(jax_side=True))
    je.load_checkpoint(str(tmp_path / "p"), tag="sg")
    assert je.global_steps == 2 and je._infinity.adam.step_count == 2
    mj = dict(jax_ordered_leaves(jax.tree_util.tree_map(np.asarray,
                                                        je.params)))
    mt = _masters(te)
    assert all(np.array_equal(mj[n], mt[n]) for n in mt)
    np.testing.assert_allclose(_run(je, batches[2:3]), _run(te, batches[2:3]),
                               atol=1e-5, rtol=0)
    # JAX paged -> the port, paged and in RAM
    jp, *_ = deepspeed_tpu.initialize(
        model=jm, model_parameters=tree,
        config_params=_config(nvme=str(tmp_path / "jn"), params_nvme=True,
                              jax_side=True))
    _run(jp, batches[:2])
    jp.save_checkpoint(str(tmp_path / "j"), tag="jsg")
    want = dict(jax_ordered_leaves(jax.tree_util.tree_map(np.asarray,
                                                          jp.params)))
    sd = jp._infinity.state_dict()
    for cfg in (_config(), _config(nvme=str(tmp_path / "n2"),
                                   params_nvme=True)):
        back = _port(_jax(seed=3)[1], cfg)
        back.load_checkpoint(str(tmp_path / "j"), tag="jsg")
        got = _masters(back)
        assert all(np.array_equal(got[n], want[n]) for n in want)
        mine = back._infinity.state_dict()
        for k in sd["state"]:
            assert np.array_equal(mine["state"][k]["m"], sd["state"][k]["m"])


def test_mid_accumulation_save_carries_the_sink(tmp_path):
    jm, tree = _jax()
    tok, lab = _batch(5, B=16)
    micros = [(tok[:8], lab[:8]), (tok[8:], lab[8:])]
    nvme = str(tmp_path / "nvme")
    cfg = _config(nvme=nvme, params_nvme=True, gas=2)
    a = _port(tree, cfg)
    a.forward(micros[0])
    a.backward()
    a.step()
    assert a._infinity._acc_count == 1
    a.save_checkpoint(str(tmp_path / "ck"), tag="mid")
    b = _port(_jax(seed=2)[1], cfg)
    b.load_checkpoint(str(tmp_path / "ck"), tag="mid")
    assert b._infinity._acc_count == 1
    jcfg = _config(gas=2, jax_side=True)
    jb, *_ = deepspeed_tpu.initialize(model=jm, model_parameters=tree,
                                      config_params=jcfg)
    jb.load_checkpoint(str(tmp_path / "ck"), tag="mid")
    assert jb._infinity._acc_count == 1
    for e in (a, b, jb):
        e.forward(micros[1])
        e.backward()
        e.step()
    assert a.global_steps == b.global_steps == jb.global_steps == 1
    ma, mb = _masters(a), _masters(b)
    assert all(np.array_equal(ma[n], mb[n]) for n in ma)
    mj = dict(jax_ordered_leaves(jax.tree_util.tree_map(np.asarray,
                                                        jb.params)))
    for n in ma:
        np.testing.assert_allclose(mj[n], ma[n], atol=1e-4, rtol=0)


@pytest.mark.parametrize("over,match", [
    (dict(num_experts=4), "streamed MoE, pipeline and dropout models"),
    (dict(dropout=0.1), "streamed MoE, pipeline and dropout models"),
])
def test_infinity_refuses_what_stream_supported_forbids(over, match):
    with pytest.raises(NotImplementedError, match=match):
        dt.initialize(model=GPT(gpt2_config("nano", **NANO, **over),
                                device="cpu"),
                      config_params=_config(), device="cpu")


def test_comm_overlap_warns_under_infinity_and_raises_elsewhere():
    cfg = dict(_config(), comm={"overlap": "on"})
    eng, *_ = dt.initialize(model=GPT(gpt2_config("nano", **NANO),
                                      device="meta"),
                            config_params=cfg, device="cpu")
    assert eng._infinity is not None
    with pytest.raises(NotImplementedError, match="overlap"):
        dt.initialize(model=GPT(gpt2_config("nano", **NANO), device="cpu"),
                      config_params=dict(_config(stage3=False),
                                         comm={"overlap": "on"}),
                      device="cpu")

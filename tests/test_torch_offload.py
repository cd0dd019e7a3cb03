"""ZeRO-Offload in the port (runtime/zero/offload.py and the engine's
offload path) against the JAX package's and against the port's own
ZeRO-0 engine.

Tolerances, with their reasons:

* `CPUOffloadRuntime.step` bitwise JAX's: the same host arrays through
  the same C++ Adam, the same float32 `np.dot` norm summed in Python
  floats;
* the offload engine against the port's ZeRO-0 engine: fp32 losses
  rtol 1e-5 and masters atol 1e-5 (the host Adam and FusedAdam round the
  same update in another order, ulps a step); bf16 losses rtol 2e-2, JAX's
  own bound (tests/test_offload.py:66: bf16 weights rounded from masters
  that differ by those ulps);
* the port's offload engine against JAX's (fp32, mesh data 8 on the JAX
  side): losses atol 1e-5 and masters atol 1e-4, test_torch_train.py's
  engine-curve bounds (the same fp32 function, sums in other orders).
"""

import glob

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu.models import GPT as JaxGPT  # noqa: E402
from deepspeed_tpu.models import gpt2_config as jax_gpt2_config  # noqa: E402
from deepspeed_tpu.runtime.zero.offload import \
    CPUOffloadRuntime as JaxOffload  # noqa: E402
from deepspeed_tpu_torch.models import GPT, gpt2_config  # noqa: E402
from deepspeed_tpu_torch.models.convert import jax_ordered_leaves  # noqa: E402
from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,  # noqa: E402
                                                DeepSpeedConfigError)
from deepspeed_tpu_torch.runtime.zero.offload import \
    CPUOffloadRuntime  # noqa: E402

torch.set_num_threads(1)


def _leaves(seed=0):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(5, 7).astype(np.float32),
            "b": {"c": rng.randn(13).astype(np.float32),
                  "d": rng.randn(30, 20).astype(np.float32)}}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
@pytest.mark.parametrize("nvme", [False, True])
def test_offload_step_is_bitwise_jax(dtype, nvme, tmp_path):
    tree = _leaves()
    leaves = jax.tree_util.tree_leaves(tree)
    hp = {"lr": 1e-2, "weight_decay": 0.1}
    path = str(tmp_path) if nvme else None
    jr = JaxOffload(tree, hp, nvme_path=path, param_dtype=getattr(jnp, dtype))
    tr = CPUOffloadRuntime(leaves, hp, nvme_path=path,
                           param_dtype=getattr(torch, dtype))
    rng = np.random.RandomState(1)
    for step in range(5):
        grads = [rng.randn(*l.shape).astype(np.float32) * 300 for l in leaves]
        if step == 2:
            grads[1][4] = np.nan        # the whole step is skipped
        clip = 1.0 if step != 3 else 0.0
        jout, jov, jn = jr.step(grads, 256.0, 1e-2 / (step + 1), clip=clip)
        tout, tov, tn = tr.step(grads, 256.0, 1e-2 / (step + 1), clip=clip)
        assert (jov, jn) == (tov, tn)
        for a, b in zip(jr.masters, tr.masters):
            assert np.array_equal(a, b)
        if jov:
            assert tout is None
            continue
        for a, b in zip(jax.tree_util.tree_leaves(jout), tout):
            b = b.float().numpy() if torch.is_tensor(b) else b
            assert np.array_equal(np.asarray(a.astype(jnp.float32)), b)
    js, ts = jr.state_dict(), tr.state_dict()
    assert js["step"] == ts["step"] == 4
    assert set(js["state"]) == set(ts["state"])
    for k in js["state"]:
        for m in ("m", "v"):
            assert np.array_equal(js["state"][k][m], ts["state"][k][m])
    for a, b in zip(js["masters"], ts["masters"]):
        assert np.array_equal(a, b)
    if nvme:
        assert glob.glob(str(tmp_path / "dstpu_offload_*" / "*.bin"))
    # a fresh runtime restored from the state steps on identically
    fresh = CPUOffloadRuntime(leaves, hp, nvme_path=path,
                              param_dtype=getattr(torch, dtype))
    fresh.load_state_dict(ts)
    g = [rng.randn(*l.shape).astype(np.float32) for l in leaves]
    tr.step(g, 1.0, 1e-3)
    fresh.step(g, 1.0, 1e-3)
    for a, b in zip(tr.masters, fresh.masters):
        assert np.array_equal(a, b)


def _config(zero, precision="fp32", micro=8, jax_side=False, gas=1):
    cfg = {"train_batch_size": micro * gas,
           "train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "Adam",
                         "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_max_lr": 1e-3,
                                    "warmup_num_steps": 4}},
           "gradient_clipping": 1.0, "steps_per_print": 0,
           "zero_optimization": dict(zero)}
    if jax_side:
        cfg["mesh"] = {"data": 8}
        cfg["train_micro_batch_size_per_gpu"] = micro // 8
    if precision == "bf16":
        cfg["bf16"] = {"enabled": True}
    return cfg


def _batches(n, seed=7, B=8, S=32, vocab=256):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rng.randint(0, vocab, (B, S + 1))
        out.append((t[:, :-1], t[:, 1:]))
    return out


def _jax_tree(seed=0, **over):
    jm = JaxGPT(jax_gpt2_config("nano", shard_activations=False, **over))
    return jm, jax.tree_util.tree_map(np.asarray,
                                      jm.init(jax.random.PRNGKey(seed)))


def _port(zero, tree, precision="fp32", **over):
    eng, *_ = dt.initialize(model=GPT(gpt2_config("nano", **over),
                                      device="cpu"),
                            model_parameters=tree, device="cpu",
                            config_params=_config(zero, precision))
    return eng


def _run(eng, batches):
    out = []
    for b in batches:
        out.append(float(eng.forward(b)))
        eng.backward()
        eng.step()
    return out


def _masters(eng):
    """{name: fp32 numpy} of an engine's masters (the port's `params`)."""
    return {n: t.detach().float().numpy().copy()
            for n, t in eng.params.items()}


def _jax_masters(je):
    """{name: fp32 numpy} of a JAX offload engine's host masters."""
    tree = jax.tree_util.tree_map(np.asarray, je.params)
    names = [n for n, _ in jax_ordered_leaves(tree)]
    shapes = [np.shape(l) for _, l in jax_ordered_leaves(tree)]
    return {n: m.reshape(s) for n, m, s in
            zip(names, je._offload.masters, shapes)}


OFFLOAD = {"stage": 0, "offload_optimizer": {"device": "cpu"}}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_offload_engine_tracks_its_own_zero0(precision):
    _, tree = _jax_tree()
    batches = _batches(4)
    ref = _port({"stage": 0}, tree, precision)
    off = _port(OFFLOAD, tree, precision)
    assert off._offload is not None and off._opt_state is None
    # the device keeps the compute-dtype weights only
    want = torch.float32 if precision == "fp32" else torch.bfloat16
    assert all(p.dtype == want for p in off.module.parameters())
    lr_, lo = _run(ref, batches), _run(off, batches)
    if precision == "fp32":
        np.testing.assert_allclose(lo, lr_, rtol=1e-5)
        mr, mo = _masters(ref), _masters(off)
        for n in mr:
            np.testing.assert_allclose(mo[n], mr[n], atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(lo, lr_, rtol=2e-2)
    assert off.get_lr() == ref.get_lr() and off.global_steps == 4
    assert off.get_global_grad_norm() > 0


@pytest.mark.parametrize("legacy", [False, True])
def test_offload_engine_tracks_jax_offload_engine(legacy):
    jm, tree = _jax_tree()
    batches = _batches(4)
    zero = ({"stage": 2, "cpu_offload": True} if legacy else
            {"stage": 1, "offload_optimizer": {"device": "cpu"}})
    je, *_ = deepspeed_tpu.initialize(model=jm, model_parameters=tree,
                                      config_params=_config(zero,
                                                            jax_side=True))
    te = _port(zero, tree)
    assert je._offload is not None and te._offload is not None
    lj, lt = _run(je, batches), _run(te, batches)
    np.testing.assert_allclose(lt, lj, atol=1e-5, rtol=0)
    mj, mt = _jax_masters(je), _masters(te)
    assert set(mj) == set(mt)
    for n in mj:
        np.testing.assert_allclose(mt[n], mj[n], atol=1e-4, rtol=0)
    assert te._offload.adam.step_count == je._offload.adam.step_count == 4


def test_offload_tags_cross_between_the_engines(tmp_path):
    """A port offload tag resumes a JAX offload engine and the other way:
    masters, moments and step bitwise; the next steps as the source's."""
    jm, tree = _jax_tree()
    batches = _batches(5, seed=3)
    zero = {"stage": 0, "offload_optimizer": {"device": "cpu"}}
    te = _port(zero, tree)
    _run(te, batches[:2])
    te.save_checkpoint(str(tmp_path / "p"), tag="t2")
    je, *_ = deepspeed_tpu.initialize(model=jm, model_parameters=tree,
                                      config_params=_config(zero,
                                                            jax_side=True))
    je.load_checkpoint(str(tmp_path / "p"), tag="t2")
    assert je.global_steps == 2 and je._offload.adam.step_count == 2
    sd_t, sd_j = te._offload.state_dict(), je._offload.state_dict()
    for k in sd_t["state"]:
        for m in ("m", "v"):
            assert np.array_equal(sd_t["state"][k][m], sd_j["state"][k][m])
    for a, b in zip(sd_t["masters"], sd_j["masters"]):
        assert np.array_equal(a, b)
    np.testing.assert_allclose(_run(je, batches[2:4]), _run(te, batches[2:4]),
                               atol=1e-5, rtol=0)
    # JAX -> port
    je.save_checkpoint(str(tmp_path / "j"), tag="t4")
    back = _port(zero, _jax_tree(seed=9)[1])
    back.load_checkpoint(str(tmp_path / "j"), tag="t4")
    assert back.global_steps == 4 and back._offload.adam.step_count == 4
    for a, b in zip(back._offload.masters, je._offload.masters):
        assert np.array_equal(a, b)
    # the device weights are the masters rounded to the compute dtype
    for n, p in zip(back._param_names, back._masters):
        assert torch.equal(p.detach(),
                           torch.from_numpy(_masters(back)[n]).to(p.dtype))
    np.testing.assert_allclose(_run(back, batches[4:]), _run(je, batches[4:]),
                               atol=1e-5, rtol=0)
    # a device-optimizer engine takes the offload tag's masters; the Adam
    # moments restart, as in the JAX engine
    dev = _port({"stage": 0}, _jax_tree(seed=9)[1])
    dev.load_checkpoint(str(tmp_path / "p"), tag="t2")
    got, src = _masters(dev), dict(zip(
        [n for n, _ in jax_ordered_leaves(tree)], sd_t["masters"]))
    assert all(np.array_equal(got[n].ravel(), src[n]) for n in got)
    assert not any(bool(t.any()) for t in dev._opt_state["exp_avg"])
    # module weights in and out through the host masters
    sd = back.module_state_dict()
    back.load_module_state_dict({n: np.zeros_like(v) for n, v in sd.items()})
    assert not any(m.any() for m in back._offload.masters)
    assert not any(bool(p.detach().any()) for p in back.module.parameters())


def test_offload_resume_is_bitwise_and_nvme_equals_ram(tmp_path):
    _, tree = _jax_tree()
    batches = _batches(4, seed=5)
    ram = _port(OFFLOAD, tree)
    nv = _port({"stage": 0, "offload_optimizer": {
        "device": "nvme", "nvme_path": str(tmp_path / "nvme")}}, tree)
    assert nv._offload.nvme is not None
    with _deterministic():
        lr_, ln = _run(ram, batches[:2]), _run(nv, batches[:2])
        assert lr_ == ln
        for a, b in zip(ram._offload.masters, nv._offload.masters):
            assert np.array_equal(a, b)
        assert glob.glob(str(tmp_path / "nvme" / "dstpu_offload_*" / "*.bin"))
        nv.save_checkpoint(str(tmp_path / "ck"), tag="n2")
        fresh = _port({"stage": 0, "offload_optimizer": {
            "device": "nvme", "nvme_path": str(tmp_path / "nvme")}},
            _jax_tree(seed=4)[1])
        fresh.load_checkpoint(str(tmp_path / "ck"), tag="n2")
        assert _run(fresh, batches[2:]) == _run(nv, batches[2:])
        for a, b in zip(fresh._offload.masters, nv._offload.masters):
            assert np.array_equal(a, b)


class _deterministic:
    """Deterministic algorithms (the embedding backward's row sums in a
    fixed order) for the bitwise comparisons."""

    def __enter__(self):
        self.prev = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(self.prev)


def test_offload_overflow_skips_the_step_and_stashes_pre_clip_grads():
    _, tree = _jax_tree()
    cfg = _config(OFFLOAD)
    cfg["fp16"] = {"enabled": True, "initial_scale_power": 32, "hysteresis": 1}
    eng, *_ = dt.initialize(model=GPT(gpt2_config("nano"), device="cpu"),
                            model_parameters=tree, device="cpu",
                            config_params=cfg)
    eng.store_gradients = True
    before = [m.copy() for m in eng._offload.masters]
    scale = eng.loss_scale
    b = _batches(1)[0]
    eng.forward(b)
    eng.backward()
    eng.step()      # 2^32 overflows fp16: skipped, scale halved
    assert eng.skipped_steps == 1 and eng.loss_scale == scale / 2
    assert all(np.array_equal(a, m) for a, m in zip(before,
                                                    eng._offload.masters))
    assert all(not v.any() for v in eng.stored_gradients.values())
    assert eng._offload.adam.step_count == 0
    cfg["fp16"]["initial_scale_power"] = 8
    eng, *_ = dt.initialize(model=GPT(gpt2_config("nano"), device="cpu"),
                            model_parameters=tree, device="cpu",
                            config_params=cfg)
    eng.store_gradients = True
    eng.forward(b)
    grads = [g.clone() for g in eng._grad_acc]
    eng.backward()
    eng.step()
    assert eng.skipped_steps == 0 and eng._offload.adam.step_count == 1
    for n, g in zip(eng._param_names, grads):
        # unscaled, before the clip (JAX's documented divergence)
        np.testing.assert_array_equal(eng.stored_gradients[n],
                                      (g / 256.0).numpy())
    norm = np.sqrt(sum(float((g.double() / 256.0).square().sum())
                       for g in grads))
    np.testing.assert_allclose(eng.get_global_grad_norm(), norm, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="offload path"):
        _port({"stage": 0}, tree).store_gradients = True


@pytest.mark.parametrize("zero,world,match", [
    (OFFLOAD, 2, "Offload at 2 ranks.*Offload and Infinity across ranks"),
    ({"stage": 3, "offload_param": {"device": "cpu"}}, 2,
     "Infinity at 2 ranks"),
    ({"stage": 3, "offload_optimizer": {"device": "cpu"}}, 1,
     "without offload_param.*stage-3 slices"),
])
def test_offload_refusals_name_their_roadmap_items(zero, world, match):
    with pytest.raises(DeepSpeedConfigError, match=match):
        DeepSpeedConfig(_config(zero, micro=8 * world), world_size=world)

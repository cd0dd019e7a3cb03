"""Port parity: the GPT training loss and the single-process engine
(deepspeed_tpu_torch/models/gpt.py, deepspeed_tpu_torch/runtime/) against
the JAX package on shared weights and batches.

Weights: the JAX `GPT.init` tree, as numpy, loaded into the port with
`load_jax_params` (or passed to both engines as `model_parameters`).
Tolerances, with their reasons:

* fp32 loss: atol 1e-5 — the same fp32 arithmetic, sums in other orders
  (loss ~5, a few ulps);
* fp32 gradients: 1e-4 of each leaf's largest |grad| — fp32 reductions
  in other orders through a few layers of backward;
* bf16 loss: atol 1e-3 and gradients 5e-2 of the leaf's largest |grad| —
  activations are rounded to bf16 (2^-8 relative) at places that differ
  between XLA and PyTorch, and the backward compounds those over the
  layers;
* engine curves: fp32 per-step loss atol 1e-5 and final weights 1e-4
  (Adam's normalised steps carry the fp32 gradient differences into the
  weights at lr scale); bf16 and fp16 per-step loss atol 5e-3 (the bf16
  and fp16 roundings above, over six to twelve steps of training).
"""

import sys
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
from deepspeed_tpu.runtime import lr_schedules as jax_lr  # noqa: E402
from deepspeed_tpu.runtime.fp16 import loss_scaler as jax_ls  # noqa: E402
from deepspeed_tpu.ops.adam.fused_adam import \
    FusedAdam as JaxFusedAdam  # noqa: E402
from deepspeed_tpu_torch.models import (GPT, gpt2_config,  # noqa: E402
                                        load_jax_params)
from deepspeed_tpu_torch.models.convert import flatten_tree  # noqa: E402
from deepspeed_tpu_torch.ops.adam import FusedAdam  # noqa: E402
from deepspeed_tpu_torch.runtime import lr_schedules  # noqa: E402
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError  # noqa: E402
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from convergence_common import synthetic_batches  # noqa: E402

torch.set_num_threads(1)

# name: (size, port/JAX config overrides, JAX-only overrides, seq, batch)
MODELS = {
    "nano": ("nano", {}, {}, 32, 2),
    "nano-chunked": ("nano", dict(loss_chunks=4), {}, 32, 2),
    "nano-untied": ("nano", dict(tie_embeddings=False), {}, 32, 2),
    "small-width-pallas": ("small", dict(num_layers=2, vocab_size=512,
                                         max_seq_len=256),
                           dict(attn_impl="pallas"), 256, 1),
}


def _models(name, seed=0):
    size, over, jover, _, _ = MODELS[name]
    jmodel = JaxGPT(jax_gpt2_config(size, shard_activations=False, **over,
                                    **jover))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(seed)))
    port_over = dict(over, **({"attn_impl": "pallas"} if jover else {}))
    model = GPT(gpt2_config(size, **port_over), device="cpu")
    load_jax_params(model, tree)
    return jmodel, tree, model


def _batch(name, masked):
    _, _, _, S, B = MODELS[name]
    vocab = 256 if name.startswith("nano") else 512
    toks = np.random.RandomState(0).randint(0, vocab, (B, S + 1))
    x, y = toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
    if masked:
        y[0, :5] = -100
    return x, y


def _loss_and_grads(name, dtype, masked):
    jmodel, tree, model = _models(name)
    x, y = _batch(name, masked)
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    cparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt),
                                     tree)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, (jnp.asarray(x), jnp.asarray(y)),
                              train=True))(cparams)
    masters = {n: p.detach().clone().requires_grad_()
               for n, p in model.named_parameters()}
    loss = torch.func.functional_call(
        model, {n: p.to(tdt) for n, p in masters.items()}, ((x, y),),
        {"train": True})
    loss.backward()
    jg = flatten_tree(jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(np.float32), jgrads))
    return float(jloss), loss.item(), jg, {n: p.grad.numpy()
                                           for n, p in masters.items()}


@pytest.mark.parametrize("name,dtype,masked",
                         [("nano", "fp32", False), ("nano", "bf16", False),
                          ("nano-chunked", "fp32", True),
                          ("nano-untied", "fp32", False),
                          ("small-width-pallas", "fp32", False)])
def test_gpt_loss_and_grads_match_jax(name, dtype, masked):
    jl, tl, jg, tg = _loss_and_grads(name, dtype, masked)
    loss_tol, grad_tol = (1e-5, 1e-4) if dtype == "fp32" else (1e-3, 5e-2)
    assert abs(jl - tl) <= loss_tol, (jl, tl)
    assert set(jg) == set(tg)
    for n in jg:
        scale = np.abs(jg[n]).max() + 1e-12
        err = np.abs(jg[n] - tg[n]).max() / scale
        assert err <= grad_tol, (n, err)


def test_gpt_apply_matches_jax_and_labels_default_to_shifted_tokens():
    jmodel, tree, model = _models("nano")
    x, _ = _batch("nano", False)
    want = np.asarray(jmodel.apply(jax.tree_util.tree_map(jnp.asarray, tree),
                                   jnp.asarray(x)))
    got = model.apply(x).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    toks = np.concatenate([x, x[:, :1]], axis=1)
    with torch.no_grad():
        a = model.loss({"input_ids": toks})
        b = model.loss((toks[:, :-1], toks[:, 1:]))
    assert float(a) == float(b)


def test_remat_and_dropout_seeds_recompute_the_same_masks():
    """remat=True (torch.utils.checkpoint per block) recomputes each block
    with the seeds drawn before it, so loss and gradients equal the
    unrematerialised run under dropout."""
    out = []
    for remat in (False, True):
        cfg = gpt2_config("nano", dropout=0.1, attn_dropout=0.2,
                          embed_dropout=0.1, remat=remat)
        model = GPT(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
        x, y = _batch("nano", False)
        loss = model.loss((x, y), generator=torch.Generator().manual_seed(5))
        loss.backward()
        out.append((loss.item(), [p.grad.clone()
                                  for p in model.parameters()]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    # eval: no dropout, no generator needed
    with torch.no_grad():
        assert float(model.loss((x, y), train=False)) != out[0][0]


def test_loss_impl_pallas_raises_not_quietly_plain():
    """loss_impl="pallas" runs the fused CE (kernels #4-#6; their plain
    versions on CPU tensors), not quietly the chunked plain CE: the three
    fused ops are dispatched, once each, and the loss matches the auto
    path's within fp32 order (atol 1e-5)."""
    from deepspeed_tpu_torch.monitor.counters import COUNTERS

    # N = 8 x 32 rows: a multiple of the 128/256 row blocks
    toks = np.random.RandomState(4).randint(0, 256, (8, 33))
    x, y = toks[:, :-1], toks[:, 1:]
    losses = {}
    for impl in ("pallas", "auto"):
        model = GPT(gpt2_config("nano", loss_impl=impl), device="cpu",
                    generator=torch.Generator().manual_seed(0))
        snap = COUNTERS.snapshot()
        loss = model.loss((x, y))
        loss.backward()
        d = COUNTERS.delta_since(snap)
        losses[impl] = float(loss)
        assert d.get("kernel.fallbacks", {"calls": 0})["calls"] == \
            (3 if impl == "pallas" else 0), d
    assert abs(losses["pallas"] - losses["auto"]) < 1e-5


# -- the engine ---------------------------------------------------------------


def _engine_config(prec, gas, micro=64):
    """The convergence recipe (tests/convergence_common.py) at ZeRO stage
    0: the JAX engine takes micro 8 on each of the 8 test devices, the
    port's single process the same global micro batch of 64."""
    fp = {"fp32": {}, "bf16": {"bf16": {"enabled": True}},
          "fp16": {"fp16": {"enabled": True, "loss_scale": 0,
                            "initial_scale_power": 32, "hysteresis": 1}}}
    return {"train_batch_size": 64 * gas,
            "train_micro_batch_size_per_gpu": micro,
            "optimizer": {"type": "Adam", "params": {"lr": 3e-3}},
            "zero_optimization": {"stage": 0},
            "steps_per_print": 0, "gradient_clipping": 1.0,
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_max_lr": 3e-3,
                                     "warmup_num_steps": 5}},
            **fp[prec]}


def _engines(prec, gas=2):
    cfg = jax_gpt2_config("nano", max_seq_len=32, vocab_size=64,
                          shard_activations=False)
    jmodel = JaxGPT(cfg)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(1234)))
    je, *_ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=tree,
        config_params=_engine_config(prec, gas, micro=64 // jax.device_count()))
    te, topt, _, tsched = dt.initialize(
        model=GPT(gpt2_config("nano", max_seq_len=32, vocab_size=64),
                  device="cpu"),
        model_parameters=tree, config_params=_engine_config(prec, gas),
        device="cpu")
    return je, te, tree, tsched


def _run(engines, steps, gas):
    losses = []
    for x, y in synthetic_batches(steps * gas, 64, 32, 64, 1234):
        pair = []
        for eng in engines:
            pair.append(float(eng.forward((x, y))))
            eng.backward()
            eng.step()
        losses.append(pair)
    return np.asarray(losses)


@pytest.mark.parametrize("prec,gas,tol", [("fp32", 2, 1e-5),
                                          ("fp32", 1, 1e-5),
                                          ("bf16", 2, 5e-3)])
def test_engine_curve_matches_jax(prec, gas, tol):
    je, te, tree, _ = _engines(prec, gas)
    # an fp32 master tree loads exactly
    flat = flatten_tree(tree)
    assert all(np.array_equal(v, flat[n])
               for n, v in te.module_state_dict().items())
    losses = _run((je, te), steps=6, gas=gas)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], atol=tol, rtol=0)
    assert losses[-1, 1] < losses[0, 1]       # the curve falls
    assert te.global_steps == je.global_steps == 6
    if prec == "fp32":
        want = flatten_tree(jax.tree_util.tree_map(np.asarray, je.params))
        got = te.module_state_dict()
        for n in want:
            np.testing.assert_allclose(got[n], want[n], atol=1e-4, rtol=0,
                                       err_msg=n)


def test_engine_fp16_overflow_skips_halves_and_holds_the_scheduler():
    """fp16 at loss scale 2^32: the scaled backward overflows fp16, so the
    first steps are skipped with the scale halved each time and the
    scheduler held back, until the scale fits — on both engines alike
    (tests/test_engine.py:110-136)."""
    je, te, _, sched = _engines("fp16", gas=1)
    assert te.loss_scale == je.loss_scale == 2.0 ** 32
    w0 = {n: v.copy() for n, v in te.module_state_dict().items()}
    losses = _run((je, te), steps=1, gas=1)
    assert te.skipped_steps == je.skipped_steps == 1
    assert te.loss_scale == je.loss_scale == 2.0 ** 31
    assert sched.last_batch_iteration == -1       # rolled back
    for n, v in te.module_state_dict().items():   # the step was skipped
        assert np.array_equal(v, w0[n]), n
    losses = np.concatenate([losses, _run((je, te), steps=11, gas=1)])
    assert te.skipped_steps == je.skipped_steps > 1
    assert te.loss_scale == je.loss_scale < 2.0 ** 31
    assert sched.last_batch_iteration == 11 - te.skipped_steps
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], atol=5e-3, rtol=0)


def test_engine_train_batch_eval_batch_and_accessors():
    _, te, _, _ = _engines("fp32", gas=2)
    assert te.get_batch_info() == (128, 64, 2)
    assert te.gradient_clipping() == 1.0 and te.optimizer_name() == "adam"
    assert te.scheduler_name() == "WarmupLR" and te.get_mom() == [0.9]
    assert te.zero_optimization() is False and te.precision() == "float32"
    assert te.dynamic_loss_scale() is True and te.postscale_gradients()
    assert te.train() is te and te.eval().training is False
    it = synthetic_batches(4, 64, 32, 64, 7)
    loss = te.train_batch(it)
    assert te.global_steps == 1 and te.micro_steps == 2
    assert loss.shape == () and np.isfinite(float(loss))
    x, y = next(it)
    ev = te.eval_batch((x, y))
    assert te.global_steps == 1 and np.isfinite(float(ev))
    sd = te.module_state_dict()
    te.load_module_state_dict({n: np.zeros_like(v) for n, v in sd.items()})
    assert all(float(p.detach().abs().sum()) == 0
               for p in te.params.values())
    with pytest.raises(ValueError, match="do not match"):
        te.load_module_state_dict({"bogus": np.zeros(3)})
    with pytest.raises(RuntimeError, match="before forward"):
        te.backward()


@pytest.mark.parametrize("extra,match", [
    # ZeRO-Offload and Infinity are ported; what stays refused names its
    # ROADMAP item
    ({"zero_optimization": {"stage": 3, "offload_optimizer":
                            {"device": "cpu"}}},
     "without offload_param.*offload_optimizer with stage-3 slices"),
    ({"zero_optimization": {"stage": 3, "cpu_offload": True}},
     "without offload_param"),
    # the wall-clock timers, the fault plan, the watchdog and tracing are
    # ported (tests/test_torch_monitor.py, test_torch_train_faults.py);
    # their cases became sections that stay refused
    ({"autotune": {"enabled": True}}, "autotune.*the production runtime"),
    ({"pipeline": {"stages": 2}}, "pipeline"),
    ({"mesh": {"model": 2}}, "mesh.*tensor and sequence parallelism"),
    ({"amp": {"enabled": True}}, "AMP.*the production runtime"),
    ({"mesh": {"seq": 2}}, "'seq'.*tensor and sequence parallelism"),
    ({"mesh": {"pipe": 2}}, "'pipe'.*queue 1: pipeline"),
    ({"mesh": {"data": 2}}, "mesh.data=2 but the data-parallel world"),
    ({"train_batch_size": 24, "gradient_accumulation_steps": 2},
     "batch related"),
    ({"bf16": {"enabled": True}, "fp16": {"enabled": True}}, "both"),
    ({"fp16": {"enabled": True, "type": "fp8"}}, "fp16.type"),
])
def test_config_errors_and_unported_sections_raise(extra, match):
    cfg = dict(_engine_config("fp32", 2), **extra)
    with pytest.raises(DeepSpeedConfigError, match=match):
        dt.initialize(model=GPT(gpt2_config("nano"), device="cpu"),
                      config_params=cfg, device="cpu")


def test_unported_optimizers_pipeline_and_data_loader_raise(tmp_path):
    model = GPT(gpt2_config("nano"), device="cpu")
    # LAMB is ported; the host step under offload stays the native Adam
    cfg = dict(_engine_config("fp32", 1), optimizer={"type": "Lamb"},
               zero_optimization={"stage": 1, "offload_optimizer":
                                  {"device": "cpu"}})
    with pytest.raises(NotImplementedError, match="lamb"):
        dt.initialize(model=model, config_params=cfg, device="cpu")
    # the engine-owned data loader is ported: training_data builds it
    data = [(x[i], y[i]) for x, y in synthetic_batches(2, 64, 32, 64, 3)
            for i in range(64)]
    eng, _, loader, _ = dt.initialize(
        model=model, config_params=_engine_config("fp32", 1),
        training_data=data, device="cpu")
    assert loader is eng.training_dataloader and len(loader) == 2
    assert loader.batch_size == 64 and loader.shuffle
    with pytest.raises(NotImplementedError, match="pipeline"):
        dt.PipelineModule(layers=[])
    with pytest.raises(ValueError, match="config"):
        dt.initialize(model=model, device="cpu")
    # the preemption handler is ported; a directory that is not a path
    # string still raises, with the JAX message
    with pytest.raises(ValueError, match="preempt_save_dir must be a "
                       "directory path string"):
        dt.initialize(model=model, device="cpu", config_params=dict(
            _engine_config("fp32", 1),
            checkpoint={"preempt_save_dir": 7}))
    # a pipeline tag (per-layer files) is refused, naming its ROADMAP item
    eng.save_checkpoint(str(tmp_path), tag="pipe")
    open(tmp_path / "pipe" / "layer_00-model_00-model_states.msgpack",
         "wb").close()
    with pytest.raises(NotImplementedError, match="queue 1: pipeline"):
        eng.load_checkpoint(str(tmp_path), tag="pipe")


# -- the optimizer, the scaler and the schedules --------------------------------


@pytest.mark.parametrize("adam_w,wd", [(True, 0.0), (True, 0.1),
                                       (False, 0.1)])
def test_fused_adam_matches_jax(adam_w, wd):
    rng = np.random.RandomState(0)
    params = [rng.randn(5, 3).astype(np.float32),
              rng.randn(7).astype(np.float32)]
    jopt = JaxFusedAdam(lr=1e-2, weight_decay=wd, adam_w_mode=adam_w)
    topt = FusedAdam(lr=1e-2, weight_decay=wd, adam_w_mode=adam_w)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p) for p in params]
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        grads = [rng.randn(*p.shape).astype(np.float32) for p in params]
        lr = 1e-2 * (step + 1) / 5
        jp, js = jopt.update([jnp.asarray(g) for g in grads], js, jp, lr=lr)
        tp, ts = topt.update([torch.from_numpy(g) for g in grads], ts, tp,
                             lr=lr)
    assert int(ts["step"]) == int(js["step"]) == 5
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_loss_scaler_update_matches_jax():
    rng = np.random.RandomState(0)
    flags = rng.rand(60) < 0.2
    kw = dict(scale_factor=2.0, scale_window=4, min_scale=1.0,
              delayed_shift=2)
    js = jax_ls.make_scaler_state(2.0 ** 16)
    ts = loss_scaler.make_scaler_state(2.0 ** 16)
    js["cur_hysteresis"] = jnp.asarray(2, jnp.int32)
    ts["cur_hysteresis"].fill_(2)
    host = loss_scaler.DynamicLossScaler(init_scale=2.0 ** 16,
                                         scale_window=4, delayed_shift=2)
    for f in flags:
        js = jax_ls.update_scale_jit(js, jnp.asarray(f), **kw)
        ts = loss_scaler.update_scale_jit(ts, torch.tensor(bool(f)), **kw)
        host.update_scale(bool(f))
        for k in js:
            assert float(ts[k]) == float(js[k]), k
        assert float(ts["cur_scale"]) == host.cur_scale


@pytest.mark.parametrize("name,params", [
    ("WarmupLR", {"warmup_max_lr": 1e-2, "warmup_num_steps": 7}),
    ("WarmupDecayLR", {"warmup_max_lr": 1e-2, "warmup_num_steps": 5,
                       "total_num_steps": 20}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                  "cycle_first_step_size": 6}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 3}),
])
def test_lr_schedules_match_jax(name, params):
    jopt, topt = JaxFusedAdam(lr=1e-3), FusedAdam(lr=1e-3)
    js = jax_lr.SCHEDULERS[name](jopt, **params)
    ts = lr_schedules.SCHEDULERS[name](topt, **params)
    for _ in range(25):
        js.step()
        ts.step()
        assert topt.param_groups[0]["lr"] == jopt.param_groups[0]["lr"]

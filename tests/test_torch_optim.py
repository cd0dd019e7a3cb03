"""Port parity: the optimizer family (ops/lamb, runtime/fp16/onebit,
runtime/client_optimizer.py) and progressive layer drop
(runtime/progressive_layer_drop.py, models/gpt.py `_trunk`, the
engine's theta) against the JAX package, at world 1.

Tolerances, with their reasons:

* FusedLamb, 5 steps: 2e-6 relative on the parameters and moments — the
  per-leaf norms of the trust ratio reduce in another order than XLA's
  (an ulp of the ratio a step);
* 1-bit Adam / LAMB through warm-up and the frozen phase, 6 steps:
  parameters and moments int8 wire 2e-6 relative, the sign wire 1e-5
  relative — the sign wire's scales mean(|c|) are summed in fp64 by the
  port and in fp32 by XLA (the mean of n equal values, too, rounds in
  fp32), an ulp of each scale, which every compressed element carries;
  LAMB adds the trust-ratio norms above and XLA may contract the moment
  updates into FMAs, an ulp of the momentum.  The worker and server
  errors are differences of nearly equal numbers (c and its compressed
  value), so an ulp of c (|c| < 2 here) shows in them at 2.4e-7
  absolute: atol 5e-7 on the errors;
* `optax:adamw` through the engines (torch.optim.AdamW against
  optax.adamw, the same update rule): per-step loss atol 1e-5 and the
  final weights atol 1e-4 — AdamW's bias corrections and decoupled decay
  are applied in another order of operations, and Adam's normalised
  steps carry the fp32 gradient differences (JAX reduces over 8 devices)
  into the weights at lr scale, the bound tests/test_torch_train.py
  holds the two engines' Adam to;
* progressive layer drop: the theta schedule bitwise (the same numpy
  expression); theta 1 bitwise the dense engine; under an injected mask
  the trunk's hidden states atol 1e-5 (fp32, as the GPT forward tests).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu.models import GPT as JaxGPT  # noqa: E402
from deepspeed_tpu.models import gpt2_config as jax_gpt2_config  # noqa: E402
from deepspeed_tpu.ops.lamb.fused_lamb import \
    FusedLamb as JaxFusedLamb  # noqa: E402
from deepspeed_tpu.runtime.fp16.onebit import OnebitAdam as JaxOnebitAdam  # noqa: E402,E501
from deepspeed_tpu.runtime.fp16.onebit import OnebitLamb as JaxOnebitLamb  # noqa: E402,E501
from deepspeed_tpu.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop as JaxPLD  # noqa: E402
from deepspeed_tpu_torch.models import GPT, gpt2_config  # noqa: E402
from deepspeed_tpu_torch.models import load_jax_params  # noqa: E402
from deepspeed_tpu_torch.models.convert import flatten_tree  # noqa: E402
from deepspeed_tpu_torch.ops.lamb import FusedLamb  # noqa: E402
from deepspeed_tpu_torch.runtime.fp16.onebit import (OnebitAdam,  # noqa: E402
                                                     OnebitLamb)
from deepspeed_tpu_torch.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def deterministic():
    """Deterministic algorithms (the embedding backward's row sums in a
    fixed order) for the bitwise engine comparisons."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _leaves(rs):
    """Parameter-like leaves: matrices, a bias, an all-zero leaf (the
    trust ratio's 1 where ||p|| = 0) and a tiny one."""
    return [rs.randn(6, 5).astype(np.float32),
            (0.1 * rs.randn(7)).astype(np.float32),
            np.zeros((3, 4), np.float32),
            rs.randn(2).astype(np.float32)]


def _run_pair(jopt, topt, steps, lr_of=lambda s: 1e-2):
    rs = np.random.RandomState(0)
    params = _leaves(rs)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(steps):
        grads = [rs.randn(*p.shape).astype(np.float32) for p in params]
        lr = lr_of(step)
        jp, js = jopt.update([jnp.asarray(g) for g in grads], js, jp, lr=lr)
        tp, ts = topt.update([torch.from_numpy(g) for g in grads], ts, tp,
                             lr=lr)
    return jp, js, tp, ts


def _close(j, t, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(t.numpy() if torch.is_tensor(t)
                               else np.asarray(t), np.asarray(j),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("kw", [
    dict(weight_decay=0.01),
    dict(weight_decay=0.0, eps_inside_sqrt=True, max_coeff=0.5,
         min_coeff=0.1),
    dict(weight_decay=0.1, bias_correction=False)])
def test_fused_lamb_tracks_jax(kw):
    jp, js, tp, ts = _run_pair(JaxFusedLamb(lr=1e-2, **kw),
                               FusedLamb(lr=1e-2, **kw), steps=5,
                               lr_of=lambda s: 1e-2 * (s + 1) / 5)
    assert int(ts["step"]) == int(js["step"]) == 5
    for i in range(len(jp)):
        _close(jp[i], tp[i], 2e-6, what=f"param {i}")
        _close(js["exp_avg"][i], ts["exp_avg"][i], 2e-6)
        _close(js["exp_avg_sq"][i], ts["exp_avg_sq"][i], 2e-6)
    # the all-zero leaf takes the trust ratio 1 (it moves by lr * update)
    assert float(tp[2].abs().max()) > 0


ERR_ATOL = 5e-7


@pytest.mark.parametrize("wire,rtol", [("sign", 1e-5), ("int8", 2e-6)])
def test_onebit_adam_tracks_jax_through_warmup_and_freeze(wire, rtol):
    kw = dict(lr=1e-2, freeze_step=2, wire=wire, weight_decay=0.01)
    jp, js, tp, ts = _run_pair(JaxOnebitAdam(**kw), OnebitAdam(**kw), 6)
    assert int(ts["step"]) == 6
    for i in range(len(jp)):
        _close(jp[i], tp[i], rtol, 0.0, f"param {i}")
        for k in ("exp_avg", "exp_avg_sq"):
            _close(js[k][i], ts[k][i], rtol, 0.0, f"{k} {i}")
        for k in ("worker_error", "server_error"):
            _close(js[k][i], ts[k][i], 0.0, ERR_ATOL, f"{k} {i}")
    # the errors are live after the freeze
    assert float(ts["worker_error"][0].abs().max()) > 0


@pytest.mark.parametrize("wire,rtol", [("sign", 1e-5), ("int8", 2e-6)])
def test_onebit_lamb_tracks_jax_through_warmup_and_freeze(wire, rtol):
    kw = dict(lr=1e-2, freeze_step=2, wire=wire, weight_decay=0.01)
    jp, js, tp, ts = _run_pair(JaxOnebitLamb(**kw), OnebitLamb(**kw), 6)
    for i in range(len(jp)):
        _close(jp[i], tp[i], rtol, 0.0, f"param {i}")
        for k in ("exp_avg", "exp_avg_sq", "exp_avg_sq_fresh",
                  "lamb_coeff_freeze", "last_factor"):
            _close(js[k][i], ts[k][i], rtol, 0.0, f"{k} {i}")
        for k in ("worker_error", "server_error"):
            _close(js[k][i], ts[k][i], 0.0, ERR_ATOL, f"{k} {i}")


# -- through the engines ------------------------------------------------------


def _nano(seed=1234):
    cfg = jax_gpt2_config("nano", max_seq_len=32, vocab_size=64,
                          shard_activations=False)
    jmodel = JaxGPT(cfg)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(seed)))
    return jmodel, tree


def _cfg(opt, **extra):
    return {"train_batch_size": 64, "train_micro_batch_size_per_gpu": 64,
            "optimizer": opt, "steps_per_print": 0, **extra}


def _batches(n, seed=5):
    rs = np.random.RandomState(seed)
    t = rs.randint(0, 64, (n, 64, 33)).astype(np.int32)
    return [(b[:, :-1], b[:, 1:]) for b in t]


def _port_engine(tree, opt, **extra):
    eng, *_ = dt.initialize(
        model=GPT(gpt2_config("nano", max_seq_len=32, vocab_size=64),
                  device="cpu"),
        model_parameters=tree, config_params=_cfg(opt, **extra),
        device="cpu")
    return eng


def _steps(eng, batches):
    out = []
    for b in batches:
        out.append(float(eng.forward(b)))
        eng.backward()
        eng.step()
    return out


def test_optax_adamw_through_the_engine_tracks_jax():
    opt = {"type": "optax:adamw", "params": {"lr": 3e-3,
                                             "weight_decay": 0.05}}
    jmodel, tree = _nano()
    jcfg = dict(_cfg(opt), train_micro_batch_size_per_gpu=64 //
                jax.device_count())
    je, *_ = deepspeed_tpu.initialize(model=jmodel, model_parameters=tree,
                                      config_params=jcfg)
    te = _port_engine(tree, opt)
    assert type(te.optimizer.optimizer) is torch.optim.AdamW
    assert te.optimizer.param_groups[0]["weight_decay"] == 0.05
    batches = _batches(5)
    jl, tl = _steps(je, batches), _steps(te, batches)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, je.params))
    got = te.module_state_dict()
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=1e-4, rtol=0,
                                   err_msg=n)


def test_client_torch_optimizer_and_optax_names(deterministic):
    """A client torch.optim.Optimizer over the module's parameters is
    wrapped (its param_groups are the scheduler's), "optax:adam" /
    "optax:sgd" take their torch.optim classes, another name raises
    naming the list, and ZeRO gates them as JAX does."""
    _, tree = _nano()
    model = GPT(gpt2_config("nano", max_seq_len=32, vocab_size=64),
                device="cpu")
    load_jax_params(model, tree)
    client = torch.optim.AdamW(model.parameters(), lr=3e-3,
                               weight_decay=0.05)
    ec, *_ = dt.initialize(model=model, optimizer=client,
                           config_params=_cfg({"type": "Adam"}),
                           device="cpu")
    assert ec.optimizer.optimizer is client
    assert ec.optimizer.param_groups is client.param_groups
    eo = _port_engine(tree, {"type": "optax:adamw",
                             "params": {"lr": 3e-3, "weight_decay": 0.05}})
    batches = _batches(3)
    # the same torch.optim.AdamW, client-built or by name: bitwise
    assert _steps(ec, batches) == _steps(eo, batches)
    for n, v in eo.module_state_dict().items():
        assert np.array_equal(ec.module_state_dict()[n], v), n
    for name, cls in (("optax:adam", torch.optim.Adam),
                      ("optax:sgd", torch.optim.SGD)):
        e = _port_engine(tree, {"type": name, "params": {"lr": 1e-2}})
        assert type(e.optimizer.optimizer) is cls
        assert np.isfinite(_steps(e, batches[:1])).all()
    with pytest.raises(ValueError, match="optax:adamw"):
        _port_engine(tree, {"type": "optax:adagrad"})
    with pytest.raises(ValueError, match="untested with ZeRO"):
        _port_engine(tree, {"type": "optax:adam"},
                     zero_optimization={"stage": 1})
    e = _port_engine(tree, {"type": "optax:adam"},
                     zero_optimization={"stage": 1},
                     zero_allow_untested_optimizer=True)
    assert np.isfinite(_steps(e, batches[:1])).all()


def test_refusals_are_lifted_and_what_stays_refused_names_its_item():
    _, tree = _nano()
    b = _batches(1)
    for opt in ({"type": "Lamb"}, {"type": "OneBitAdam"},
                {"type": "OneBitLamb", "params": {"wire": "int8"}}):
        assert np.isfinite(_steps(_port_engine(tree, opt), b)).all()
    e = _port_engine(tree, {"type": "Adam"},
                     progressive_layer_drop={"enabled": True, "theta": 0.5})
    assert e.pld_enabled() and np.isfinite(_steps(e, b)).all()
    # the host-store transport of the compressed wire: ROADMAP item 6
    with pytest.raises(NotImplementedError, match="item 6"):
        _port_engine(tree, {"type": "OneBitAdam",
                            "params": {"comm_backend_name": "mpi"}})
    # the host step is the native Adam: another optimizer is refused there
    with pytest.raises(NotImplementedError, match="native Adam"):
        _port_engine(tree, {"type": "Lamb"}, zero_optimization={
            "stage": 1, "offload_optimizer": {"device": "cpu"}})


# -- progressive layer drop --------------------------------------------------


def test_pld_theta_schedule_is_jax_bitwise_and_threads_through_the_engine():
    jp, tp = JaxPLD(theta=0.5, gamma=0.1), ProgressiveLayerDrop(0.5, 0.1)
    for step in range(1, 30):
        jp.update_state(step)
        tp.update_state(step)
        assert tp.get_theta() == jp.get_theta()
    _, tree = _nano()
    e = _port_engine(tree, {"type": "Adam"},
                     progressive_layer_drop={"enabled": True, "theta": 0.5,
                                             "gamma": 0.1})
    want = JaxPLD(theta=0.5, gamma=0.1)
    seen = []
    forward = e.module.forward

    def spy(*a, **kw):
        seen.append(kw["pld_theta"])
        return forward(*a, **kw)

    e.module.forward = spy
    _steps(e, _batches(4))
    thetas = [1.0]
    for step in range(1, 4):
        want.update_state(step)
        thetas.append(want.get_theta())
    assert seen == thetas
    want.update_state(4)
    assert e.get_pld_theta() == want.get_theta()


def test_pld_theta_one_is_the_dense_engine_bitwise(deterministic):
    _, tree = _nano()
    batches = _batches(3)
    dense = _port_engine(tree, {"type": "Adam"})
    pld = _port_engine(tree, {"type": "Adam"}, progressive_layer_drop={
        "enabled": True, "theta": 1.0, "gamma": 0.5})
    assert _steps(dense, batches) == _steps(pld, batches)
    assert pld.module.last_pld_mask == [True] * 3
    for n, v in dense.module_state_dict().items():
        assert np.array_equal(pld.module_state_dict()[n], v), n


def test_pld_theta_zero_drops_every_block():
    _, tree = _nano()
    model = GPT(gpt2_config("nano", max_seq_len=32, vocab_size=64),
                device="cpu")
    load_jax_params(model, tree)
    x, y = _batches(1)[0]
    masters = dict(model.named_parameters())
    loss = model.loss((x, y), generator=torch.Generator().manual_seed(0),
                      progressive_layer_drop=True, pld_theta=0.0)
    assert model.last_pld_mask == [False] * 3
    grads = torch.autograd.grad(loss, list(masters.values()),
                                allow_unused=True)
    for (n, _), g in zip(masters.items(), grads):
        if n.startswith("blocks."):
            assert g is None, n          # no block ran
    # the trunk is then the embedding through ln_f
    with torch.no_grad():
        h, _ = model._trunk(torch.from_numpy(x).long(), pld_mask=[False] * 3)
        from deepspeed_tpu_torch.models.gpt import layer_norm
        emb = model.wte[torch.from_numpy(x).long()] + model.wpe[:32][None]
        want = layer_norm(emb, model.ln_f, model.config.layer_norm_eps)
    assert torch.equal(h, want)


@pytest.mark.parametrize("mask", [[True, False, True], [False, True, False]])
def test_pld_trunk_matches_jax_under_an_injected_mask(mask):
    jmodel, tree = _nano()
    model = GPT(gpt2_config("nano", max_seq_len=32, vocab_size=64),
                device="cpu")
    load_jax_params(model, tree)
    x, _ = _batches(1)[0]
    jh, jaux, _ = jmodel._trunk(jax.tree_util.tree_map(jnp.asarray, tree),
                                jnp.asarray(x), train=True,
                                pld_mask=jnp.asarray(mask))
    with torch.no_grad():
        h, aux = model._trunk(torch.from_numpy(x).long(), train=True,
                              pld_mask=np.asarray(mask))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5, rtol=0)
    assert float(aux) == float(jaux) == 0.0


def test_compressed_backend_keeps_errors_per_name_as_jax():
    """`CompressedBackend` (the reference backend's surface) with no data
    ranks: each named tensor's worker / server errors persist between
    calls, the outputs those of JAX's backend (the sign wire's scale an
    ulp apart: 2e-6 relative)."""
    from deepspeed_tpu.runtime.comm.compressed import \
        CompressedBackend as JaxBackend
    from deepspeed_tpu_torch.runtime.comm.compressed import (
        CompressedBackend, compressed_allreduce)

    rs = np.random.RandomState(4)
    xs = {n: rs.randn(3, 17).astype(np.float32) for n in ("a", "b")}
    jb, tb = JaxBackend(), CompressedBackend()
    we = {n: torch.zeros(3, 17) for n in xs}
    se = {n: torch.zeros(3, 17) for n in xs}
    for _ in range(3):
        for n, x in xs.items():
            got = tb.compressed_allreduce(torch.from_numpy(x), name=n)
            want, we[n], se[n] = compressed_allreduce(
                torch.from_numpy(x), we[n], se[n], None)
            assert torch.equal(got, want)
            np.testing.assert_allclose(
                got.numpy(), np.asarray(jb.compressed_allreduce(
                    jnp.asarray(x), name=n)), rtol=2e-6, atol=0)
    assert set(tb._errors) == {"a", "b"}

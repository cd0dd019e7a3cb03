"""Port parity: MoE training through the sorted dispatch
(deepspeed_tpu_torch/moe/dispatch.py and layer.py, kernels #13 and #14,
models/gpt.py's MoE blocks, runtime's `comm.moe`) against the JAX package
on the same numpy inputs and weights.

The JAX side runs as its own tests run it on the CPU: the plain
expressions, and the Pallas kernels through
`registry.dispatch(..., impl="pallas")` under
`kernel_config(interpret=True)` (tests/test_kernels.py).  Tolerances,
with their reasons:

* routing: `eidx`, `pos` and `keep` equal; `gate` within 1e-7 (the same
  fp32 softmax, reductions in another order);
* `sorted_dispatch`: bitwise (a row copy into zeros);
* `sorted_combine`: atol 1e-6, JAX's own one-ulp contract
  (tests/test_kernels.py `test_moe_combine_parity_one_ulp`);
* the MoE layer: rtol 2e-6 / atol 2e-7, and aux equal between the dense
  and sorted engines (JAX's own bound, tests/test_moe_dispatch.py:104);
  aux within 1e-6 of JAX's (the load-balancing dot product sums in
  another order);
* MoE gradients: rtol 1e-4 / atol 1e-6 against `jax.grad`
  (tests/test_moe_dispatch.py:134);
* `GPT.loss` with MoE layers, fp32: 1e-5, gradients 1e-4 of each leaf's
  largest |grad| (tests/test_torch_train.py's);
* the engine's fp32 loss curve with `comm.moe.dispatch = "sorted"`: 1e-5
  a step of the JAX engine's, the gate noise set to 0 on both sides.

Where the gate noise is on, the port's router takes JAX's draw: the test
replaces `moe.layer.gate_noise` with the JAX package's normal draws, key
for key.  The kernels run only on a card: the `cuda`-marked tests at the
end hold them against their plain versions there (`python -m pytest
--noconftest -m cuda tests/test_torch_moe.py`)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu_torch.kernels import moe_kernels, registry  # noqa: E402
from deepspeed_tpu_torch.models import (GPT, gpt2_config,  # noqa: E402
                                        load_jax_params)
from deepspeed_tpu_torch.models.convert import flatten_tree  # noqa: E402
from deepspeed_tpu_torch.moe import dispatch as tdsp  # noqa: E402
from deepspeed_tpu_torch.moe import layer as tlayer  # noqa: E402
from deepspeed_tpu_torch.monitor.counters import COUNTERS  # noqa: E402

torch.set_num_threads(1)


def _probs(B, N, E, seed):
    rs = np.random.RandomState(seed)
    e = np.exp(rs.randn(B, N, E))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _jax_rows(fn, *arrays):
    """Apply a one-group JAX function to each batch row (the vmap its
    callers use) and stack the results as numpy."""
    import jax

    out = jax.vmap(fn)(*arrays)
    return jax.tree_util.tree_map(np.asarray, out)


def _routing(B=2, N=16, E=4, k=2, C=5, seed=0):
    """Port routing [B, k, N] of seeded probabilities (a tight capacity,
    so some assignments drop)."""
    probs = torch.from_numpy(_probs(B, N, E, seed))
    return tdsp.topk_routing(probs, k, C)


@pytest.mark.parametrize("k,C", [(1, 3), (2, 5), (2, 64)])
def test_topk_routing_matches_jax(k, C):
    import jax.numpy as jnp

    from deepspeed_tpu.moe.dispatch import topk_routing

    probs = _probs(3, 24, 6, seed=k + C)
    je, jg, jp, jk, ja = _jax_rows(lambda p: topk_routing(p, k, C),
                                   jnp.asarray(probs))
    te, tg, tp, tk, ta = tdsp.topk_routing(torch.from_numpy(probs), k, C)
    assert te.dtype == tp.dtype == torch.int32 and tk.dtype == torch.bool
    assert np.array_equal(te.numpy(), je)
    assert np.array_equal(tp.numpy(), jp)
    assert np.array_equal(tk.numpy(), jk)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=1e-7)
    np.testing.assert_allclose(ta.numpy(), ja, rtol=1e-6)
    if C < 24:
        assert not bool(tk.all())          # the capacity dropped something


@pytest.mark.parametrize("side", ["ref", "pallas"])
def test_sorted_dispatch_is_bitwise_with_jax(side):
    import jax.numpy as jnp

    from deepspeed_tpu.kernels import kernel_config
    from deepspeed_tpu.kernels import registry as jregistry
    from deepspeed_tpu.moe.dispatch import sorted_dispatch_ref

    eidx, gate, pos, keep, _ = _routing()
    x = np.random.RandomState(1).randn(2, 16, 128).astype(np.float32)
    got = tdsp.sorted_dispatch(torch.from_numpy(x), eidx, pos, keep, 4, 5)
    args = (jnp.asarray(x), jnp.asarray(eidx.numpy()),
            jnp.asarray(pos.numpy()), jnp.asarray(keep.numpy()))
    if side == "ref":
        want = _jax_rows(lambda *a: sorted_dispatch_ref(*a, 4, 5), *args)
    else:
        with kernel_config(interpret=True):
            want = _jax_rows(lambda *a: jregistry.dispatch(
                "moe_dispatch", *a, 4, 5, variant="dispatch",
                impl="pallas"), *args)
    assert got.shape == (2, 4, 5, 128)
    assert np.array_equal(got.detach().numpy(), want)


def _spread_slots(eidx, pos, keep, C, C2, seed):
    """Move each expert's kept positions [0, C) to C of its C2 slots, an
    injective map drawn per (group, expert): kept destinations stay
    unique but no longer fill a prefix of the expert's slots (as a
    dropless overflow bucket's may not).  Dropped assignments keep their
    positions."""
    B, _, _ = eidx.shape
    E = int(eidx.max()) + 1
    rs = np.random.RandomState(seed)
    perm = np.stack([[rs.permutation(C2)[:C] for _ in range(E)]
                     for _ in range(B)]).astype(np.int32)     # [B, E, C]
    perm = torch.from_numpy(perm).to(pos.device)
    b = torch.arange(B, device=pos.device)[:, None, None].expand_as(pos)
    new = perm[b, eidx.long(), pos.long().clamp(0, C - 1)]
    return torch.where(keep, new, pos)


@pytest.mark.parametrize("variant", ["ref", "pallas", "gated"])
def test_dispatch_on_non_prefix_slots_is_bitwise_with_jax(variant):
    """Kept positions that are a non-prefix subset of each expert's
    slots (C 5 spread over 12): the port's dispatch against JAX's
    dispatch (its plain version and its Pallas kernel) and, gated,
    against the transpose of JAX's combine (the combine's gradient),
    bitwise."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.kernels import kernel_config
    from deepspeed_tpu.kernels import registry as jregistry
    from deepspeed_tpu.moe.dispatch import (sorted_combine_ref,
                                            sorted_dispatch_ref)

    E, C, C2 = 4, 5, 12
    eidx, gate, pos, keep, _ = _routing(E=E, C=C)
    pos = _spread_slots(eidx, pos, keep, C, C2, seed=3)
    kept = pos[keep]
    assert int(kept.max()) >= C and not bool(keep.all())
    x = np.random.RandomState(1).randn(2, 16, 128).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(eidx.numpy()),
            jnp.asarray(pos.numpy()), jnp.asarray(keep.numpy()))
    if variant == "gated":
        got = registry.dispatch("moe_dispatch", torch.from_numpy(x), eidx,
                                pos, keep, E, C2, gate=gate)

        def grad_eo(g, e, gt, p, kp):
            eo = jnp.zeros((E, C2, g.shape[-1]), g.dtype)
            _, vjp = jax.vjp(lambda o: sorted_combine_ref(o, e, gt, p, kp),
                             eo)
            return vjp(g)[0]

        want = _jax_rows(grad_eo, args[0], args[1],
                         jnp.asarray(gate.numpy()), args[2], args[3])
    else:
        got = tdsp.sorted_dispatch(torch.from_numpy(x), eidx, pos, keep, E,
                                   C2)
        if variant == "ref":
            want = _jax_rows(lambda *a: sorted_dispatch_ref(*a, E, C2), *args)
        else:
            with kernel_config(interpret=True):
                want = _jax_rows(lambda *a: jregistry.dispatch(
                    "moe_dispatch", *a, E, C2, variant="dispatch",
                    impl="pallas"), *args)
    assert got.shape == (2, E, C2, 128)
    assert np.array_equal(got.detach().numpy(), want)
    # every empty slot, between and after the kept ones, is zero
    dest = torch.where(keep, eidx.long() * C2 + pos.long(), E * C2)
    filled = torch.zeros(2, E * C2 + 1, dtype=torch.bool).scatter_(
        1, dest.reshape(2, -1), True)[:, :E * C2]
    rows = got.reshape(2, E * C2, 128)
    assert not bool(rows[~filled].any()) and bool(filled.any())


@pytest.mark.parametrize("side", ["ref", "pallas"])
def test_sorted_combine_matches_jax_within_one_ulp(side):
    import jax.numpy as jnp

    from deepspeed_tpu.kernels import kernel_config
    from deepspeed_tpu.kernels import registry as jregistry
    from deepspeed_tpu.moe.dispatch import sorted_combine_ref

    eidx, gate, pos, keep, _ = _routing()
    out = np.random.RandomState(2).randn(2, 4, 5, 128).astype(np.float32)
    got = tdsp.sorted_combine(torch.from_numpy(out), eidx, gate, pos, keep)
    args = (jnp.asarray(out), jnp.asarray(eidx.numpy()),
            jnp.asarray(gate.numpy()), jnp.asarray(pos.numpy()),
            jnp.asarray(keep.numpy()))
    if side == "ref":
        want = _jax_rows(sorted_combine_ref, *args)
    else:
        with kernel_config(interpret=True):
            want = _jax_rows(lambda *a: jregistry.dispatch(
                "moe_dispatch", *a, variant="combine", impl="pallas"), *args)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    # the combine's bound holds the plain version against itself in bf16
    b = torch.from_numpy(out).to(torch.bfloat16)
    tol = tdsp.combine_tolerance(b, eidx, gate, pos, keep)
    assert tol.shape == (2, 16, 128) and bool((tol > 0).any())


# -- the MoE layer ------------------------------------------------------------


def _layer_pair(k, factor, min_cap, noise=1e-2, E=4, d=8, f=16):
    import jax

    from deepspeed_tpu.moe.layer import MoE as JaxMoE
    from deepspeed_tpu.moe.layer import MoEConfig as JaxMoEConfig

    kw = dict(d_model=d, d_ff=f, num_experts=E, top_k=k,
              capacity_factor=factor, min_capacity=min_cap,
              noisy_gate_std=noise)
    jm = JaxMoE(JaxMoEConfig(**kw))
    params = jm.init(jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                               params)
    tparams = tlayer.MoEParams(p["gate"]["w"], p["experts"]["w1"],
                               p["experts"]["b1"], p["experts"]["w2"],
                               p["experts"]["b2"])
    return jm, params, tlayer.MoE(tlayer.MoEConfig(**kw)), tparams


def _feed_jax_noise(monkeypatch, draws):
    """The port's router takes `draws` (JAX's normals, in call order)."""
    queue = list(draws)

    def gate_noise(shape, generator, device):
        z = queue.pop(0)
        assert tuple(z.shape) == tuple(shape)
        return z.to(device)

    monkeypatch.setattr(tlayer, "gate_noise", gate_noise)
    return queue


def _jax_layer_noise(rng, B, S, E):
    """The draw of MoE.__call__: one normal [S, E] per batch row, from
    `jax.random.split(rng, B)` (layer.py:168)."""
    import jax

    return torch.from_numpy(np.stack([
        np.asarray(jax.random.normal(key, (S, E)))
        for key in jax.random.split(rng, B)]))


@pytest.mark.parametrize("mode", ["dense", "sorted"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("factor,min_cap", [(0.5, 1), (4.0, 4)])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_layer_matches_jax(monkeypatch, k, factor, min_cap, train, mode):
    import jax

    from deepspeed_tpu.moe import dispatch as jdsp

    jm, params, tm, tparams = _layer_pair(k, factor, min_cap)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 12, 8))
    rng = jax.random.PRNGKey(2) if train else None
    if train:
        _feed_jax_noise(monkeypatch, [_jax_layer_noise(rng, 2, 12, 4)])
    with jdsp.moe_wire(dispatch=mode):
        yj, auxj = jm(params, x, rng=rng, train=train)
    with tdsp.moe_wire(dispatch=mode):
        yt, auxt = tm(tparams, torch.from_numpy(np.asarray(x)),
                      generator=torch.Generator() if train else None,
                      train=train)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               rtol=2e-6, atol=2e-7)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-6)


@pytest.mark.parametrize("k", [1, 2])
def test_dense_and_sorted_engines_route_alike(k):
    """The shared routing core: the port's two engines give the same aux
    exactly and outputs within the dense einsum's rounding; a tight
    capacity drops the same tokens."""
    _, _, tm, tparams = _layer_pair(k, 0.25, 1)
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 16, 8)
                         .astype(np.float32))
    out = {}
    for mode in ("dense", "sorted"):
        with tdsp.moe_wire(dispatch=mode):
            out[mode] = [t.detach() for t in tm(tparams, x, train=True)]
    assert float(out["dense"][1]) == float(out["sorted"][1])
    torch.testing.assert_close(out["sorted"][0], out["dense"][0],
                               rtol=2e-6, atol=2e-7)
    dropped = [(y.abs().sum(-1) == 0) for y, _ in out.values()]
    assert torch.equal(*dropped) and bool(dropped[0].any())


def test_moe_grads_match_jax(monkeypatch):
    """Gradients of sum(y * g) + aux through the sorted engine (the
    autograd Functions around kernels #13/#14's plain versions) against
    jax.grad: params, input."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.moe import dispatch as jdsp

    jm, params, tm, tparams = _layer_pair(2, 2.0, 1)
    x = np.random.RandomState(3).randn(2, 8, 8).astype(np.float32)
    g = np.random.RandomState(4).randn(2, 8, 8).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    _feed_jax_noise(monkeypatch, [_jax_layer_noise(rng, 2, 8, 4)])

    def jloss(p, xx):
        with jdsp.moe_wire(dispatch="sorted"):
            y, aux = jm(p, xx, rng=rng, train=True)
        return jnp.sum(y * jnp.asarray(g)) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    with tdsp.moe_wire(dispatch="sorted"):
        y, aux = tm(tparams, tx, generator=torch.Generator(), train=True)
    ((y * torch.from_numpy(g)).sum() + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               rtol=1e-4, atol=1e-6)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, jgp))
    for n, p in tparams.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n], rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def test_dispatch_and_combine_gradients_are_their_transposes():
    """The autograd Functions: dispatch's x-gradient is the unit-weight
    combine of the slot gradients, combine's expert-output gradient the
    weighted dispatch, and gate's the row dot product — against autograd
    through the plain expressions."""
    eidx, gate, pos, keep, _ = _routing(k=2)
    x = torch.randn(2, 16, 32, dtype=torch.float64, requires_grad=True)
    out = torch.randn(2, 4, 5, 32, dtype=torch.float64, requires_grad=True)
    gd = gate.double().requires_grad_()
    for fn, ref, args in (
            (tdsp.sorted_dispatch, tdsp.sorted_dispatch_ref,
             (x, eidx, pos, keep, 4, 5)),
            (tdsp.sorted_combine, tdsp.sorted_combine_ref,
             (out, eidx, gd, pos, keep))):
        leaves = [a for a in args if torch.is_tensor(a) and a.requires_grad]
        w = torch.randn(fn(*args).shape, dtype=torch.float64)
        got = torch.autograd.grad((fn(*args) * w).sum(), leaves)
        want = torch.autograd.grad((ref(*args) * w).sum(), leaves)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_sorted_engine_counts_dropped_tokens_and_capacity():
    _, _, tm, tparams = _layer_pair(1, 0.5, 1)
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 16, 8)
                         .astype(np.float32))
    tdsp.flush_dispatch_stats(wait=True)     # earlier calls' stats
    snap = COUNTERS.snapshot()
    with tdsp.moe_wire(dispatch="sorted"):
        tm(tparams, x, train=True)
    assert "moe.dropped_tokens" not in COUNTERS.delta_since(snap)
    tdsp.flush_dispatch_stats(wait=True)
    d = COUNTERS.delta_since(snap)
    cap = tm.capacity(16, True)
    # top-1 over 2 x 16 tokens at capacity 2 per expert: 8 slots a row
    assert d["moe.dropped_tokens"]["calls"] == 1
    assert d["moe.dropped_tokens"]["bytes"] >= 32 - 2 * 4 * cap
    assert d["moe.capacity_frac"]["bytes"] == round(
        1e6 * (32 - d["moe.dropped_tokens"]["bytes"]) / (2 * 4 * cap))


# -- the GPT model and the engine ----------------------------------------------


MOE_MODEL = dict(num_layers=2, num_experts=8, moe_top_k=2, vocab_size=64,
                 max_seq_len=16)


def _jax_block_noise(rng, cfg, B, S):
    """The gate-noise draws GPT.loss makes, MoE layer by MoE layer: the
    trunk splits one key per block after the embedding's, each block
    splits it in three and an MoE block splits the third once more
    (gpt.py:481-540, :246, :315)."""
    import jax

    draws = []
    rng, _ = jax.random.split(rng)
    for i in range(cfg.num_layers):
        rng, sub = jax.random.split(rng)
        _, _, r3 = jax.random.split(sub, 3)
        if cfg.is_moe_layer(i):
            r_moe, _ = jax.random.split(r3)
            draws.append(_jax_layer_noise(r_moe, B, S, cfg.num_experts))
    return draws


@pytest.mark.parametrize("mode", ["dense", "sorted"])
def test_gpt_loss_with_moe_matches_jax(monkeypatch, mode):
    """GPT.loss on shared weights (the MoE leaves carried across by
    load_jax_params), training with JAX's gate-noise draws fed in: loss,
    aux included, and every gradient."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.models import GPT as JaxGPT
    from deepspeed_tpu.models import gpt2_config as jax_gpt2_config
    from deepspeed_tpu.moe import dispatch as jdsp

    jcfg = jax_gpt2_config("nano", shard_activations=False, **MOE_MODEL)
    jmodel = JaxGPT(jcfg)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(0)))
    model = GPT(gpt2_config("nano", **MOE_MODEL), device="cpu")
    load_jax_params(model, tree)
    assert hasattr(model.blocks[1], "moe") and hasattr(model.blocks[0],
                                                       "mlp")
    toks = np.random.RandomState(2).randint(0, 64, (4, 17))
    x, y = toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
    rng = jax.random.PRNGKey(9)
    _feed_jax_noise(monkeypatch, _jax_block_noise(rng, jcfg, 4, 16))
    with jdsp.moe_wire(dispatch=mode):
        jloss, jgrads = jax.value_and_grad(
            lambda p: jmodel.loss(p, (jnp.asarray(x), jnp.asarray(y)),
                                  rng=rng, train=True))(
            jax.tree_util.tree_map(jnp.asarray, tree))
    with tdsp.moe_wire(dispatch=mode):
        loss = model.loss((x, y), generator=torch.Generator(), train=True)
        loss.backward()
    assert abs(float(jloss) - loss.item()) <= 1e-5
    jg = flatten_tree(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jgrads))
    for n, p in model.named_parameters():
        scale = np.abs(jg[n]).max() + 1e-12
        assert np.abs(jg[n] - p.grad.numpy()).max() / scale <= 1e-4, n
    # the eval loss is the pure CE (no aux, eval capacity, no noise)
    with jdsp.moe_wire(dispatch=mode), tdsp.moe_wire(dispatch=mode):
        je = float(jmodel.loss(tree, (jnp.asarray(x), jnp.asarray(y)),
                               train=False))
        te = float(model.loss((x, y), train=False))
    assert abs(je - te) <= 1e-5


def _no_noise(monkeypatch):
    """Gate noise 0 on both sides: each GPTConfig's MoE config built with
    noisy_gate_std 0 (patched at run time; no file changes)."""
    from deepspeed_tpu.models import gpt as jgpt
    from deepspeed_tpu.moe.layer import MoEConfig as JaxMoEConfig
    from deepspeed_tpu_torch.models import gpt as tgpt

    for mod, cls in ((jgpt, JaxMoEConfig), (tgpt, tlayer.MoEConfig)):
        monkeypatch.setattr(
            mod.GPTConfig, "moe_config",
            lambda self, cls=cls: cls(
                d_model=self.d_model, d_ff=self.d_ff,
                num_experts=self.num_experts, top_k=self.moe_top_k,
                capacity_factor=self.moe_capacity_factor,
                noisy_gate_std=0.0))


@pytest.fixture
def wire_defaults():
    """Both packages' process-global wire configs back to the default
    after the test (the engines install theirs)."""
    from deepspeed_tpu.moe import dispatch as jdsp

    yield
    jdsp.set_wire_config(jdsp.MoEWireConfig())
    tdsp.set_wire_config(tdsp.MoEWireConfig())


@pytest.fixture
def port_wire_default():
    """The port's wire config back to the default after the test."""
    yield
    tdsp.set_wire_config(tdsp.MoEWireConfig())


def test_engine_curve_with_sorted_dispatch_matches_jax(monkeypatch,
                                                       wire_defaults):
    import jax

    import deepspeed_tpu
    from deepspeed_tpu.models import GPT as JaxGPT
    from deepspeed_tpu.models import gpt2_config as jax_gpt2_config

    _no_noise(monkeypatch)
    jmodel = JaxGPT(jax_gpt2_config("nano", shard_activations=False,
                                    **MOE_MODEL))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(0)))
    conf = lambda micro: {
        "train_batch_size": 8, "train_micro_batch_size_per_gpu": micro,
        "steps_per_print": 0, "gradient_clipping": 1.0,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "comm": {"moe": {"dispatch": "sorted"}}}
    je, *_ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=tree,
        config_params=conf(8 // jax.device_count()))
    te, *_ = dt.initialize(model=GPT(gpt2_config("nano", **MOE_MODEL),
                                     device="cpu"),
                           model_parameters=tree, config_params=conf(8),
                           device="cpu")
    assert tdsp.get_wire_config().dispatch == "sorted"
    snap = COUNTERS.snapshot()
    tok = np.random.RandomState(0).randint(0, 64, (8, 17))
    batch = (tok[:, :-1], tok[:, 1:])
    losses = []
    for _ in range(3):
        pair = []
        for eng in (je, te):
            pair.append(float(eng.forward(batch)))
            eng.backward()
            eng.step()
        losses.append(pair)
    losses = np.asarray(losses)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=0, atol=1e-5)
    tdsp.flush_dispatch_stats(wait=True)
    d = COUNTERS.delta_since(snap)
    # one MoE layer, one record a step on the port's side
    assert d["moe.capacity_frac"]["calls"] >= 3


@pytest.mark.parametrize("moe,err,match", [
    ({"dispach": "sorted"}, ValueError, "unknown key"),
    ({"dispatch": "fast"}, ValueError, "dispatch must be one of"),
    ({"dropless": "yes"}, ValueError, "must be a bool"),
    # the explicit wire and the overlap request now parse, as in JAX
    # (the overlap is logged at engagement and the wire runs serially)
    ({"a2a_wire_dtype": "int8"}, None, "a2a_wire_dtype='int8'"),
    ({"dispatch": "sorted", "dropless": True, "overlap": "on"},
     None, "dropless=True.*overlap='on'"),
    ({"dispatch": "sorted", "dropless": True, "a2a_wire_dtype": "bf16"},
     ValueError, "cannot ride the explicit a2a wire"),
    ({"overlap": "on"}, None, "overlap='on'"),
])
def test_comm_moe_is_validated_at_config_time(moe, err, match):
    """JAX's errors for a bad `comm.moe`; a valid selection parses into
    the MoEWireConfig JAX's parse makes (err None: `match` is searched in
    its repr)."""
    import re

    from deepspeed_tpu.moe import dispatch as jdsp
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    if err is None:
        got = DeepSpeedConfig({"train_batch_size": 2,
                               "comm": {"moe": moe}}).comm_config.moe
        assert re.search(match, repr(got)), repr(got)
        assert vars(got) == vars(jdsp.parse_moe_config(moe))
        return
    with pytest.raises(err, match=match):
        DeepSpeedConfig({"train_batch_size": 2, "comm": {"moe": moe}})


def test_moe_configs_are_refused_where_the_jax_package_refuses_them():
    from deepspeed_tpu_torch.serving import ServeEngine

    model = GPT(gpt2_config("nano", **MOE_MODEL), device="cpu")
    with pytest.raises(NotImplementedError, match="no MoE layers"):
        ServeEngine(model, device="cpu")
    with pytest.raises(NotImplementedError, match="no MoE layers"):
        dt.models.generate(model, [[1, 2]], 2, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        gpt2_config("nano", num_experts=4, pipeline_stages=2)


# -- the kernels on the card --------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit "
                    "(on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_moe.py)")
    return torch.device("cuda")


CUDA_CASES = {
    # name: (B, S, E, k, capacity factor, D)
    "train-shape-k1": (4, 2048, 64, 1, 1.0, 768),
    "train-shape-k2": (4, 2048, 64, 2, 1.0, 768),
    "tight-k2-d100": (2, 256, 8, 2, 0.5, 100),
    "odd-d33": (2, 64, 4, 2, 2.0, 33),
    "k4": (2, 256, 8, 4, 1.0, 768),
    # capacity factor 0.25: whole tokens dropped
    "dropped-k2": (4, 2048, 64, 2, 0.25, 768),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_kernels_match_plain_versions(cuda_device, case, dtype):
    B, S, E, k, factor, D = CUDA_CASES[case]
    if dtype == torch.float32 and D == 33:
        D = 34          # fp32 rows move in vectors of 4 bytes or more
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    logits = torch.randn(B, S, E, generator=gen, device=cuda_device)
    C = max(int(np.ceil(factor * S * k / E - 1e-9)), 4)
    eidx, gate, pos, keep, _ = tdsp.topk_routing(
        torch.softmax(logits, -1), k, C)
    x = torch.randn(B, S, D, generator=gen, device=cuda_device).to(dtype)
    out = torch.randn(B, E, C, D, generator=gen,
                      device=cuda_device).to(dtype)
    n0 = dict(moe_kernels.LAUNCHES)
    args = (x, eidx, pos, keep, E, C)
    dk = registry.dispatch("moe_dispatch", *args, impl="cuda")
    dp = registry.dispatch("moe_dispatch", *args, impl="torch")
    assert torch.equal(dk, dp)
    for g in (gate, None):   # the gated combine, and the dispatch gradient
        ck = registry.dispatch("moe_combine", out, eidx, g, pos, keep,
                               impl="cuda")
        cp = registry.dispatch("moe_combine", out, eidx, g, pos, keep,
                               impl="torch")
        tol = tdsp.combine_tolerance(out, eidx, g, pos, keep)
        assert bool(((ck.float() - cp.float()).abs() <= tol).all())
        # a token whose every assignment was dropped comes back exact zeros
        dropped = ~keep.any(1)
        assert torch.equal(ck[dropped], torch.zeros_like(ck[dropped]))
    if case == "dropped-k2":
        assert bool(dropped.any())
    # the weighted dispatch (the combine's gradient)
    wk = registry.dispatch("moe_dispatch", *args, gate=gate, impl="cuda")
    wp = registry.dispatch("moe_dispatch", *args, gate=gate, impl="torch")
    assert torch.equal(wk, wp)
    torch.cuda.synchronize()
    assert moe_kernels.LAUNCHES == {"moe_dispatch": n0["moe_dispatch"] + 2,
                                    "moe_combine": n0["moe_combine"] + 2}


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
def test_cuda_combine_is_bitwise_repeatable(cuda_device, k):
    """#14 50 times on train-moe's shape (bf16): the same bits every time
    (its fp32 sums run over the rounds in order, in one thread)."""
    B, S, E, D = 4, 2048, 64, 768
    C = S * k // E
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    eidx, gate, pos, keep, _ = tdsp.topk_routing(torch.softmax(
        torch.randn(B, S, E, generator=gen, device=cuda_device), -1), k, C)
    out = torch.randn(B, E, C, D, generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    y0 = moe_kernels.sorted_combine_cuda(out, eidx, gate, pos, keep)
    for _ in range(50):
        y = moe_kernels.sorted_combine_cuda(out, eidx, gate, pos, keep)
        assert torch.equal(y.view(torch.int16), y0.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gated", [False, True])
def test_cuda_dispatch_on_non_prefix_slots_is_bitwise(cuda_device, gated,
                                                      dtype):
    """#13 on routing whose kept positions are a non-prefix subset of each
    expert's slots (train-k1's C 32 spread over 48): bitwise against its
    plain version, with and without `gate`, one launch a call."""
    B, S, E, C, C2, D = 4, 2048, 64, 32, 48, 768
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    logits = torch.randn(B, S, E, generator=gen, device=cuda_device)
    eidx, gate, pos, keep, _ = tdsp.topk_routing(torch.softmax(logits, -1),
                                                 1, C)
    pos = _spread_slots(eidx, pos, keep, C, C2, seed=4)
    assert int(pos[keep].max()) >= C
    x = torch.randn(B, S, D, generator=gen, device=cuda_device).to(dtype)
    g = gate if gated else None
    n0 = moe_kernels.LAUNCHES["moe_dispatch"]
    got = registry.dispatch("moe_dispatch", x, eidx, pos, keep, E, C2,
                            gate=g, impl="cuda")
    want = registry.dispatch("moe_dispatch", x, eidx, pos, keep, E, C2,
                             gate=g, impl="torch")
    torch.cuda.synchronize()
    assert moe_kernels.LAUNCHES["moe_dispatch"] == n0 + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_moe_training_step_goes_through_the_kernels(cuda_device,
                                                         port_wire_default,
                                                         monkeypatch):
    """An fp32 MoE GPT through the engine on the card: its MoE layer
    launches the dispatch and the combine once forward and once more each
    backward (the combine's gradient is a dispatch, the dispatch's a
    combine), and the loss equals the plain path's."""
    cfg = gpt2_config("nano", num_layers=2, num_experts=4, vocab_size=256,
                      max_seq_len=64)
    tok = np.random.RandomState(0).randint(0, 256, (2, 65))
    plain = registry.dispatch
    losses = []
    for impl in ("cuda", "torch"):
        if impl == "torch":
            monkeypatch.setattr(registry, "dispatch",
                                lambda name, *a, impl="auto", **kw: plain(
                                    name, *a, impl="torch", **kw))
        model = GPT(cfg, device=cuda_device,
                    generator=torch.Generator(device=cuda_device)
                    .manual_seed(0))
        eng, *_ = dt.initialize(model=model, config_params={
            "train_batch_size": 2, "steps_per_print": 0,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "comm": {"moe": {"dispatch": "sorted"}}}, device=cuda_device)
        n0 = dict(moe_kernels.LAUNCHES)
        losses.append(float(eng.forward((tok[:, :-1], tok[:, 1:]),
                                        generator=torch.Generator()
                                        .manual_seed(1))))
        eng.backward()
        eng.step()
        torch.cuda.synchronize()
        n = {key: moe_kernels.LAUNCHES[key] - n0[key] for key in n0}
        assert n == ({"moe_dispatch": 2, "moe_combine": 2} if impl == "cuda"
                     else {"moe_dispatch": 0, "moe_combine": 0}), n
    assert abs(losses[0] - losses[1]) <= 1e-5


_OUT_OF_RANGE = """
import sys
import torch
from deepspeed_tpu_torch.kernels import moe_kernels
from deepspeed_tpu_torch.moe import dispatch as tdsp

gen = torch.Generator(device="cuda").manual_seed(0)
B, S, E, k, C, D = 2, 256, 8, 2, 256, 64
eidx, gate, pos, keep, _ = tdsp.topk_routing(
    torch.softmax(torch.randn(B, S, E, generator=gen, device="cuda"), -1),
    k, C)
x = torch.randn(B, S, D, generator=gen, device="cuda", dtype=torch.bfloat16)
small = int(pos[keep].max())     # the routing's last slot lies past it
moe_kernels.sorted_dispatch_cuda(x, eidx, pos, keep, E, C)
torch.cuda.synchronize()
print("in range: ok", flush=True)
try:
    if sys.argv[1] == "dispatch":
        moe_kernels.sorted_dispatch_cuda(x, eidx, pos, keep, E, small)
    else:
        eo = torch.zeros(B, E, small, D, device="cuda", dtype=x.dtype)
        moe_kernels.sorted_combine_cuda(eo, eidx, gate, pos, keep)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e, flush=True)
    sys.exit(3)
print("no error", flush=True)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dispatch", "combine"])
def test_cuda_kernels_stop_on_routing_past_the_capacity(cuda_device, kernel):
    """Routing made for a larger capacity than the kernel is given: the
    kernel stops with a launch failure (the context is lost, so each case
    runs in a process of its own) instead of writing or reading outside
    the [E, C] buckets."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", _OUT_OF_RANGE, kernel],
                         cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert "in range: ok" in run.stdout, run.stdout + run.stderr
    assert run.returncode == 3 and "raised:" in run.stdout, \
        run.stdout + run.stderr

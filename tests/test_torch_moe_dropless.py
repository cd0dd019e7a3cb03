"""Port parity: MoE dropless (`comm.moe.dropless`, the overflow bucket of
deepspeed_tpu_torch/moe/dispatch.py and the dropless branch of
moe/layer.py `_sorted_local`) against the JAX package on the same numpy
inputs and weights.

JAX runs its plain expressions on the CPU, as its own tests run them
(tests/test_moe_dispatch.py).  The port sends the overflow bucket
through the same registry ops as the primary one (kernels #13 / #14 on a
card, their plain versions here), in expert-grouped slot order.
Tolerances, with their reasons:

* the kept set (JAX's rank rule) and the bucket rows: bitwise — integer
  routing, and a row copy into zeros;
* the layer's output: rtol 1e-5 / atol 1e-6 (JAX's own dropless bound,
  tests/test_moe_dispatch.py:176): JAX selects each overflow row's
  weights by a one-hot contraction, which adds exact zeros, and sums the
  d-reduction in another order than the per-expert GEMMs;
* aux: rtol 1e-6 (the load-balancing dot product sums in another order);
* `moe.dropped_tokens`: equal;
* gradients: rtol 1e-4 (JAX's own bound for MoE gradients,
  tests/test_moe_dispatch.py:134) and atol 1e-5 of the leaf's largest
  |grad|: an expert weight's gradient sums its primary and its overflow
  rows' contributions, each in another order than JAX's, and an element
  whose terms cancel keeps an absolute error at the scale of its terms;
* `GPT.loss` with dropless MoE layers: 1e-5, gradients 1e-4 of each
  leaf's largest |grad| (tests/test_torch_moe.py's bounds).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepspeed_tpu_torch.models import (GPT, gpt2_config,  # noqa: E402
                                        load_jax_params)
from deepspeed_tpu_torch.models.convert import flatten_tree  # noqa: E402
from deepspeed_tpu_torch.moe import dispatch as tdsp  # noqa: E402
from deepspeed_tpu_torch.moe import layer as tlayer  # noqa: E402
from deepspeed_tpu_torch.monitor.counters import COUNTERS  # noqa: E402

torch.set_num_threads(1)


def _probs(B, N, E, seed):
    rs = np.random.RandomState(seed)
    e = np.exp(rs.randn(B, N, E) * 2)
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _layer_pair(k, factor, min_cap, E=4, d=8, f=16):
    """The JAX MoE layer with its init, and the port's on the same
    weights (gate noise off: the dropless rule is the subject here)."""
    import jax

    from deepspeed_tpu.moe.layer import MoE as JaxMoE
    from deepspeed_tpu.moe.layer import MoEConfig as JaxMoEConfig

    kw = dict(d_model=d, d_ff=f, num_experts=E, top_k=k,
              capacity_factor=factor, min_capacity=min_cap,
              noisy_gate_std=0.0)
    jm = JaxMoE(JaxMoEConfig(**kw))
    params = jm.init(jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                               params)
    tparams = tlayer.MoEParams(p["gate"]["w"], p["experts"]["w1"],
                               p["experts"]["b1"], p["experts"]["w2"],
                               p["experts"]["b2"])
    return jm, params, tlayer.MoE(tlayer.MoEConfig(**kw)), tparams


def _jax_dropped(fn):
    """Run `fn` and return the JAX package's `moe.dropped_tokens` delta
    (its counters land through async callbacks)."""
    import jax

    from deepspeed_tpu.monitor.counters import COUNTERS as JC

    snap = JC.snapshot()
    out = fn()
    jax.block_until_ready(out)
    jax.effects_barrier()
    return out, JC.delta_since(snap).get("moe.dropped_tokens",
                                         {"bytes": 0})["bytes"]


def _port_dropped(fn):
    tdsp.flush_dispatch_stats(wait=True)
    snap = COUNTERS.snapshot()
    out = fn()
    tdsp.flush_dispatch_stats(wait=True)
    return out, COUNTERS.delta_since(snap).get("moe.dropped_tokens",
                                               {"bytes": 0})["bytes"]


@pytest.mark.parametrize("factor", [1.0, 0.25])
@pytest.mark.parametrize("k", [1, 2])
def test_overflow_kept_set_and_bucket_rows_match_jax(k, factor):
    """JAX's rank rule keeps the same assignments bitwise, and the port's
    expert-grouped bucket row of each kept assignment is JAX's
    rank-ordered row, bitwise; each expert's rows form one contiguous
    segment, in (row, rank) order."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.moe.dispatch import overflow_dispatch

    B, N, E, C, D = 3, 24, 4, 3, 16
    eidx, gate, pos, keep, _ = tdsp.topk_routing(
        torch.from_numpy(_probs(B, N, E, 7 + k)), k, C)
    ov_cap = tdsp.overflow_capacity(k, N, factor)
    assert ov_cap == max(1, int(np.ceil(factor * k * N - 1e-9)))
    x = np.random.RandomState(1).randn(B, N, D).astype(np.float32)
    jbuf, je, jkeep, jdest = jax.tree_util.tree_map(np.asarray, jax.vmap(
        lambda xr, er, pr, kr: overflow_dispatch(xr, er, pr, kr, ov_cap))(
        jnp.asarray(x), jnp.asarray(eidx.numpy()), jnp.asarray(pos.numpy()),
        jnp.asarray(keep.numpy())))
    ov_rank, ov_keep = tdsp.overflow_keep(keep, ov_cap)
    assert np.array_equal(ov_keep.reshape(B, -1).numpy(), jkeep)
    kept = ov_keep.reshape(B, -1).numpy()
    assert np.array_equal(ov_rank.reshape(B, -1).numpy()[kept], jdest[kept])
    if factor < 1.0:   # the small bucket overflows too
        assert (~keep).sum() > ov_keep.sum() > 0
    slot, counts = tdsp.overflow_slots(eidx, ov_keep, E)
    bucket = tdsp.overflow_dispatch(torch.from_numpy(x), slot, ov_keep,
                                    B * ov_cap).numpy()
    sl = slot.reshape(B, -1).numpy()
    e = eidx.reshape(B, -1).numpy()
    for b in range(B):
        for a in np.nonzero(kept[b])[0]:
            assert np.array_equal(bucket[sl[b, a]], jbuf[b, jdest[b, a]])
            assert je[b, jdest[b, a]] == e[b, a]
    # segments: expert-major, (row, rank)-ordered, then empty zero rows
    order = np.lexsort((np.where(kept, jdest, 0)[kept],
                        np.nonzero(kept)[0], e[kept]))
    assert np.array_equal(np.sort(sl[kept]), np.arange(kept.sum()))
    assert np.array_equal(sl[kept][order], np.arange(kept.sum()))
    assert counts.tolist() == [int((e[kept] == i).sum()) for i in range(E)]
    assert not bucket[int(kept.sum()):].any()


@pytest.mark.parametrize("factor", [1.0, 0.25])
@pytest.mark.parametrize("k", [1, 2])
def test_dropless_layer_matches_jax(k, factor):
    """The dropless layer (primary + overflow bucket): output, aux and
    the dropped count equal JAX's at a tight capacity."""
    import jax

    from deepspeed_tpu.moe import dispatch as jdsp

    jm, params, tm, tparams = _layer_pair(k, 0.5, 1)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 16, 8)) * 2
    with jdsp.moe_wire(dispatch="sorted", dropless=True,
                       overflow_factor=factor):
        (yj, auxj), jd = _jax_dropped(lambda: jm(params, x, train=True))
    with tdsp.moe_wire(dispatch="sorted", dropless=True,
                       overflow_factor=factor):
        (yt, auxt), td = _port_dropped(lambda: tm(
            tparams, torch.from_numpy(np.array(x)), train=True))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(auxt.item(), float(auxj), rtol=1e-6)
    assert td == jd
    assert (td == 0) == (factor == 1.0)


@pytest.mark.parametrize("factor", [1.0, 0.25])
@pytest.mark.parametrize("k", [1, 2])
def test_dropless_grads_match_jax(k, factor):
    """Gradients of sum(y * g) + aux through both buckets and into the
    gate: every parameter and the input, against jax.grad."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.moe import dispatch as jdsp

    jm, params, tm, tparams = _layer_pair(k, 0.5, 1)
    x = (np.random.RandomState(3).randn(2, 16, 8) * 2).astype(np.float32)
    g = np.random.RandomState(4).randn(2, 16, 8).astype(np.float32)

    def jloss(p, xx):
        with jdsp.moe_wire(dispatch="sorted", dropless=True,
                           overflow_factor=factor):
            y, aux = jm(p, xx, train=True)
        return jnp.sum(y * jnp.asarray(g)) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    jax.effects_barrier()
    tx = torch.from_numpy(x).requires_grad_()
    with tdsp.moe_wire(dispatch="sorted", dropless=True,
                       overflow_factor=factor):
        y, aux = tm(tparams, tx, train=True)
    ((y * torch.from_numpy(g)).sum() + aux).backward()
    tdsp.flush_dispatch_stats(wait=True)
    jgx = np.asarray(jgx)
    np.testing.assert_allclose(tx.grad.numpy(), jgx, rtol=1e-4,
                               atol=1e-5 * np.abs(jgx).max())
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, jgp))
    for n, p in tparams.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n], rtol=1e-4,
                                   atol=1e-5 * np.abs(want[n]).max(),
                                   err_msg=n)
    assert float(tparams.gate.w.grad.abs().sum()) > 0


def test_dropless_serves_overflow_exactly_once():
    """tests/test_moe_dispatch.py:156-191, engineered: every token prefers
    expert 0 at capacity 2.  Overflow factor 1.0 serves the other 14 and
    equals the loose-capacity oracle, dropping nothing; a bucket of 4
    slots drops 16 - 2 - 4 and counts them."""
    import jax
    import jax.numpy as jnp

    jm, params, tm, tparams = _layer_pair(1, 0.125, 2, E=2)
    x = jnp.concatenate([jnp.ones((1, 16, 4)), jnp.zeros((1, 16, 4))], -1)
    x = x + 0.01 * jax.random.normal(jax.random.PRNGKey(1), x.shape)
    xt = torch.from_numpy(np.array(x))
    oracle = tlayer.MoE(tlayer.MoEConfig(d_model=8, d_ff=16, num_experts=2,
                                         top_k=1, capacity_factor=16.0,
                                         min_capacity=16, noisy_gate_std=0.0))
    with tdsp.moe_wire(dispatch="sorted"):
        y_oracle, _ = oracle(tparams, xt, train=True)
    with tdsp.moe_wire(dispatch="sorted", dropless=True, overflow_factor=1.0):
        (y, _), dropped = _port_dropped(lambda: tm(tparams, xt, train=True))
    np.testing.assert_allclose(y.detach().numpy(), y_oracle.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    assert dropped == 0
    with tdsp.moe_wire(dispatch="sorted", dropless=True,
                       overflow_factor=0.25):
        (y4, _), dropped = _port_dropped(lambda: tm(tparams, xt, train=True))
    assert dropped == 16 - 2 - 4
    served = y4.detach().abs().sum(-1)[0] > 0
    assert int(served.sum()) == 2 + 4


MOE_MODEL = dict(num_layers=2, num_experts=8, moe_top_k=2, vocab_size=64,
                 max_seq_len=16, moe_capacity_factor=0.5)


def test_gpt_loss_with_dropless_matches_jax(monkeypatch):
    """GPT.loss with dropless MoE layers on shared weights, gate noise
    off on both sides: the loss, aux included, and every gradient."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.models import GPT as JaxGPT
    from deepspeed_tpu.models import gpt as jgpt
    from deepspeed_tpu.models import gpt2_config as jax_gpt2_config
    from deepspeed_tpu.moe import dispatch as jdsp
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
    jcfg = jax_gpt2_config("nano", shard_activations=False, **MOE_MODEL)
    jmodel = JaxGPT(jcfg)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(0)))
    model = GPT(gpt2_config("nano", **MOE_MODEL), device="cpu")
    load_jax_params(model, tree)
    toks = np.random.RandomState(2).randint(0, 64, (4, 17))
    x, y = toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
    with jdsp.moe_wire(dispatch="sorted", dropless=True,
                       overflow_factor=1.0):
        (jloss, jgrads), jd = _jax_dropped(lambda: jax.value_and_grad(
            lambda p: jmodel.loss(p, (jnp.asarray(x), jnp.asarray(y)),
                                  rng=jax.random.PRNGKey(9), train=True))(
            jax.tree_util.tree_map(jnp.asarray, tree)))
    with tdsp.moe_wire(dispatch="sorted", dropless=True,
                       overflow_factor=1.0):
        loss, td = _port_dropped(lambda: model.loss(
            (x, y), generator=torch.Generator(), train=True))
        loss.backward()
    assert abs(float(jloss) - loss.item()) <= 1e-5
    assert td == jd == 0
    jg = flatten_tree(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jgrads))
    for n, p in model.named_parameters():
        scale = np.abs(jg[n]).max() + 1e-12
        assert np.abs(jg[n] - p.grad.numpy()).max() / scale <= 1e-4, n

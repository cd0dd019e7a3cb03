"""Port parity: the fused LM-head cross-entropy
(deepspeed_tpu_torch/ops/transformer/fused_xent.py, kernels #4-#6)
against the JAX package's `fused_softmax_xent_sum`, whose Pallas kernels
JAX runs in interpret mode on the CPU (as tests/test_fused_xent.py does),
and `GPT.loss(loss_impl="pallas")` against the JAX model's.

The same numpy inputs go to both packages.  Tolerances:

* fp32 value: rtol 1e-6 — the same blocked fp32 arithmetic (exact
  products, the online logsumexp over the same vocab blocks), sums in
  another order;
* fp32 gradients: atol 1e-7 and rtol 1e-5 of each element — the same
  fp32 dl = (p - onehot) coef, streamed over the same blocks;
* bf16 inputs: the value as fp32 (both sides widen to fp32 first); the
  gradients are rounded to bf16 on both sides from fp32 sums in another
  order: one bf16 ulp (rtol 2^-7) plus atol 1e-7;
* GPT.loss: fp32 loss atol 1e-5 and gradients 1e-4 of each leaf's largest
  |grad|, the tolerances of tests/test_torch_train.py;
* the CUDA kernels against their plain versions on the card: the
  per-element bounds of `kernels/fused_xent.py` `kernel_tolerances`.

The kernels themselves run only on a card: the `cuda`-marked tests at the
end skip here.  JAX is imported inside the tests that use it, so on a GPU
machine without JAX they run alone:
`python -m pytest --noconftest -m cuda tests/test_torch_fused_xent.py`."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepspeed_tpu_torch.kernels import fused_xent, registry  # noqa: E402
from deepspeed_tpu_torch.models import GPT, gpt2_config  # noqa: E402
from deepspeed_tpu_torch.monitor.counters import COUNTERS  # noqa: E402
from deepspeed_tpu_torch.ops.transformer.fused_xent import \
    fused_softmax_xent_sum  # noqa: E402

torch.set_num_threads(1)

N, D, V = 512, 64, 1024
BR, BV = 256, 512


def _inputs(seed=0, n=N, d=D, v=V):
    """tests/test_fused_xent.py's shapes and scales, drawn with numpy:
    x [n, d], w [d, v], labels, every fifth row masked."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(n, d) * 0.5).astype(np.float32)
    w = (rs.randn(d, v) * 0.1).astype(np.float32)
    labels = rs.randint(0, v, (n,)).astype(np.int64)
    valid = np.arange(n) % 5 != 0
    return x, w, labels, valid


def _jax_fused(x, w, labels, valid, dtype, br=BR, bv=BV):
    """(value, dx, dw) of the JAX fused CE of `sum / 37` (interpret)."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.ops.transformer.fused_xent import \
        fused_softmax_xent_sum as jax_fused

    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    f = lambda a, b: jax_fused(a, b, jnp.asarray(labels, jnp.int32),
                               jnp.asarray(valid), br, bv) / 37.0
    val, (gx, gw) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt))
    return (float(val), np.asarray(gx.astype(jnp.float32)),
            np.asarray(gw.astype(jnp.float32)))


def _port_fused(x, w, labels, valid, dtype, br=BR, bv=BV):
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    tw = torch.from_numpy(w).to(dtype).requires_grad_()
    val = fused_softmax_xent_sum(tx, tw, torch.from_numpy(labels),
                                 torch.from_numpy(valid), br, bv) / 37.0
    val.backward()
    return (float(val.detach()), tx.grad.float().numpy(),
            tw.grad.float().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_xent_value_and_grads_match_jax(dtype):
    x, w, labels, valid = _inputs(1)
    jv, jgx, jgw = _jax_fused(x, w, labels, valid, dtype)
    tv, tgx, tgw = _port_fused(x, w, labels, valid, dtype)
    assert abs(jv - tv) <= 1e-6 * abs(jv), (jv, tv)
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for got, want in ((tgx, jgx), (tgw, jgw)):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7)


def test_fused_xent_matches_the_dense_ce():
    """The fused CE computes the masked sum of logsumexp - label logit
    (fp32, rtol 1e-5 against one dense fp32 projection)."""
    x, w, labels, valid = _inputs(2)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    logits = tx @ tw
    want = torch.where(torch.from_numpy(valid),
                       torch.logsumexp(logits, -1) -
                       logits[torch.arange(N), torch.from_numpy(labels)],
                       0.0).sum()
    got = fused_softmax_xent_sum(tx, tw, torch.from_numpy(labels),
                                 torch.from_numpy(valid), BR, BV)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_fused_xent_checks_block_divisibility():
    x, w, labels, valid = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match="divisible"):
        fused_softmax_xent_sum(x, w, labels, valid, 300, BV)


def _jax_and_port_models(seed=0, **kw):
    import jax

    from deepspeed_tpu.models import GPT as JaxGPT
    from deepspeed_tpu.models import gpt2_config as jax_gpt2_config
    from deepspeed_tpu_torch.models import load_jax_params

    over = dict(vocab_size=1024, max_seq_len=64, num_layers=2, num_heads=2,
                d_model=64, loss_impl="pallas")
    over.update(kw)
    jmodel = JaxGPT(jax_gpt2_config("nano", shard_activations=False, **over))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(seed)))
    model = GPT(gpt2_config("nano", **over), device="cpu")
    load_jax_params(model, tree)
    return jmodel, tree, model


@pytest.mark.parametrize("width", ["d64", "nano-d48"])
def test_gpt_loss_pallas_matches_jax(width):
    """GPT.loss with loss_impl="pallas" on shared weights (vocab 1024,
    N = 4 x 64 rows, masked labels): loss and every gradient, at D = 64 and
    at gpt2_config("nano")'s D = 48 (3 heads), a width that is no multiple
    of the kernels' 64-column tile."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu_torch.models.convert import flatten_tree

    kw = {} if width == "d64" else dict(d_model=48, num_heads=3)
    jmodel, tree, model = _jax_and_port_models(**kw)
    toks = np.random.RandomState(2).randint(0, 1024, (4, 65))
    x, y = toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
    y[1, :7] = -100
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, (jnp.asarray(x), jnp.asarray(y))))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    snap = COUNTERS.snapshot()
    loss = model.loss((x, y))
    loss.backward()
    d = COUNTERS.delta_since(snap)
    # the three fused ops ran (their plain versions, on CPU tensors)
    assert d["kernel.fallbacks"]["calls"] == 3, d
    assert abs(float(jloss) - loss.item()) <= 1e-5
    jg = flatten_tree(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jgrads))
    for n, p in model.named_parameters():
        scale = np.abs(jg[n]).max() + 1e-12
        assert np.abs(jg[n] - p.grad.numpy()).max() / scale <= 1e-4, n


def test_dispatch_engages_for_gpt2_real_vocab(monkeypatch):
    """Vocab 50304 reaches the fused CE with the JAX package's blocks
    (256, 384): the same divisor rule, so the same shapes."""
    from deepspeed_tpu_torch.models import gpt as gpt_mod
    from deepspeed_tpu_torch.ops.transformer import fused_xent as fx

    calls = []

    def fake(x, w, labels, valid, br, bv):
        calls.append((int(x.shape[0]), int(w.shape[1]), br, bv))
        return torch.zeros(())

    monkeypatch.setattr(fx, "fused_softmax_xent_sum", fake)
    x = torch.zeros(512, 32)
    w = torch.zeros(32, 50304)
    labels = torch.zeros(512, dtype=torch.long)
    valid = torch.ones(512, dtype=torch.bool)
    gpt_mod._softmax_xent_from_hidden(x, w, labels, valid, impl="pallas")
    assert calls == [(512, 50304, 256, 384)], calls


def test_dispatch_without_divisors_or_with_a_bias_takes_the_plain_path(
        monkeypatch):
    """No block divisor of N (or a decoder bias): a warning and the
    chunked plain CE, as in the JAX package — the same value."""
    from deepspeed_tpu_torch.models import gpt as gpt_mod
    from deepspeed_tpu_torch.ops.transformer import fused_xent as fx

    monkeypatch.setattr(fx, "fused_softmax_xent_sum",
                        lambda *a: pytest.fail("fused CE reached"))
    x, w, labels, valid = (torch.from_numpy(a) for a in _inputs(3, n=100))
    want = gpt_mod._softmax_xent_from_hidden(x, w, labels, valid)
    got = gpt_mod._softmax_xent_from_hidden(x, w, labels, valid,
                                            impl="pallas")
    assert float(got) == float(want)
    x, w, labels, valid = (torch.from_numpy(a) for a in _inputs(3))
    got = gpt_mod._softmax_xent_from_hidden(x, w, labels, valid,
                                            impl="pallas",
                                            bias=torch.zeros(V))
    assert float(got) == float(gpt_mod._softmax_xent_from_hidden(
        x, w, labels, valid, bias=torch.zeros(V)))


def test_kernel_wrappers_refuse_cpu_tensors_and_odd_strides():
    x, w, labels, valid = (torch.from_numpy(a) for a in _inputs())
    opts = dict(block_rows=BR, block_v=BV)
    with pytest.raises(ValueError, match="not a CUDA device"):
        fused_xent.fused_xent_fwd_cuda(x, w, labels, **opts)
    with pytest.raises(ValueError, match="not a CUDA device"):
        fused_xent.fused_xent_dx_cuda(x, w, labels, torch.zeros(N), valid,
                                      torch.ones(()), **opts)
    with pytest.raises(RuntimeError, match="impl='cuda'"):
        registry.dispatch("fused_xent_dw", x, w, labels, torch.zeros(N),
                          valid, torch.ones(()), impl="cuda", **opts)
    # the tied head (a transposed view) and a contiguous head are read
    # where they lie; any other layout is refused
    assert fused_xent._w_strides(w, D, V) == (1, V)
    assert fused_xent._w_strides(w.t().contiguous().t(), D, V) == (D, 1)
    with pytest.raises(ValueError, match="strides"):
        fused_xent._w_strides(torch.zeros(D, 2 * V)[:, ::2], D, V)


def _emulated_kernel(x, w, labels, valid, g, lse):
    """The kernels' arithmetic on the CPU: exact products summed in fp32,
    dl' = valid (p - onehot) rounded once to the input dtype, the scalar
    g applied at the end, outputs rounded to the input dtype."""
    x32, w32 = x.float(), w.float()
    p = torch.exp(x32 @ w32 - lse[:, None])
    onehot = torch.nn.functional.one_hot(labels, w.shape[1]).float()
    dl = ((p - onehot) * valid.float()[:, None]).to(x.dtype).float()
    return ((g * (dl @ w32.t())).to(x.dtype),
            (g * (x32.t() @ dl)).to(x.dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_tolerances_hold_the_emulation_and_catch_a_fault(dtype):
    """The per-element bound of kernel vs plain version, checked on the
    CPU with the kernels' arithmetic emulated: the emulation stays inside
    it, and a result scaled by 1 + 2^-5 (a fault of a few ulps) does not."""
    x, w, labels, valid = _inputs(4, n=256, d=64, v=512)
    x = torch.from_numpy(x).to(dtype)
    w = torch.from_numpy(w).to(dtype)
    labels, valid = torch.from_numpy(labels), torch.from_numpy(valid)
    g = torch.tensor(1.0 / 37.0)
    opts = dict(block_rows=256, block_v=512)
    lse, ll = registry.dispatch("fused_xent_fwd", x, w, labels, **opts)
    ref = {"lse": lse, "ll": ll,
           "dx": registry.dispatch("fused_xent_dx", x, w, labels, lse, valid,
                                   g, **opts),
           "dw": registry.dispatch("fused_xent_dw", x, w, labels, lse, valid,
                                   g, **opts)}
    tols = fused_xent.kernel_tolerances(x, w, labels, valid, g, ref)
    emu = dict(zip(("dx", "dw"), _emulated_kernel(x, w, labels, valid, g,
                                                  lse)))
    for name in ("dx", "dw"):
        diff = (emu[name].float() - ref[name].float()).abs()
        assert bool((diff <= tols[name]).all()), name
        faulty = (emu[name].float() * (1 + 2 ** -5)).to(dtype)
        assert not bool(((faulty.float() - ref[name].float()).abs()
                         <= tols[name]).all()), name
    assert bool(((lse * (1 + 1e-4) - lse).abs() > tols["lse"]).any())


# -- the kernels on the card --------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit "
                    "(on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_fused_xent.py)")
    return torch.device("cuda")


CUDA_CASES = {
    # name: (N, D, V, tied head)
    "gpt2-width-tied": (512, 768, 2048, True),
    "ragged-untied": (200, 768, 1000, False),
    "d64-tied": (256, 64, 512, True),
    "xl-width": (256, 1600, 1024, True),
    # widths off the 64-column tile and past 1600 (the streamed backward)
    "nano-d48-tied": (256, 48, 512, True),
    "odd-d37-untied": (130, 37, 300, False),
    "d2048-tied": (256, 2048, 1024, True),
    "d2560-tied": (256, 2560, 1024, True),
    "d2560-untied": (200, 2560, 1000, False),
    # dW's wgmma route (bf16/fp16, tied, D 768): train-pallas's N and V,
    # then a ragged N and GPT-2's real vocab; the untied head of the same
    # width keeps fx_bwd_kernel ("ragged-untied" above, and this one)
    "wgmma-n8192-v50304": (8192, 768, 50304, True),
    "wgmma-n1000-v50257": (1000, 768, 50257, True),
    "d512-tied": (300, 512, 1000, True),
    "n1000-v50257-untied": (1000, 768, 50257, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_kernels_match_plain_versions(cuda_device, case, dtype):
    n, d, v, tied = CUDA_CASES[case]
    x, w, labels, valid = _inputs(5, n=n, d=d, v=v)
    x = torch.from_numpy(x).to(cuda_device, dtype)
    w = torch.from_numpy(w).to(cuda_device, dtype)
    if tied:
        w = w.t().contiguous().t()           # the view wte.t() hands over
    labels = torch.from_numpy(labels).to(cuda_device)
    valid = torch.from_numpy(valid).to(cuda_device)
    g = torch.tensor(1.0 / 37.0, device=cuda_device)
    opts = dict(block_rows=n, block_v=v)
    res = {}
    for impl in ("cuda", "torch"):
        lse, ll = registry.dispatch("fused_xent_fwd", x, w, labels,
                                    impl=impl, **opts)
        res[impl] = {"lse": lse, "ll": ll}
    lse = res["torch"]["lse"]          # each comparison holds one kernel
    for impl in ("cuda", "torch"):
        for name in ("dx", "dw"):
            res[impl][name] = registry.dispatch(
                f"fused_xent_{name}", x, w, labels, lse, valid, g,
                impl=impl, **opts)
    torch.cuda.synchronize()
    wgmma = tied and dtype != torch.float32 and d in (256, 512, 768)
    assert (fused_xent.dw_route(x, w, labels, lse, valid) == "wgmma") == wgmma
    tols = fused_xent.kernel_tolerances(x, w, labels, valid, g, res["torch"])
    for name, tol in tols.items():
        assert res["cuda"][name].shape == res["torch"][name].shape
        diff = (res["cuda"][name].float() - res["torch"][name].float()).abs()
        assert bool((diff <= tol).all()), (name, float((diff / tol).max()))


@pytest.mark.cuda
def test_cuda_autograd_launches_each_kernel_once(cuda_device):
    x, w, labels, valid = _inputs(6, n=256, d=768, v=1024)
    tx = torch.from_numpy(x).to(cuda_device, torch.bfloat16).requires_grad_()
    emb = torch.from_numpy(w.T.copy()).to(cuda_device,
                                          torch.bfloat16).requires_grad_()
    before = dict(fused_xent.LAUNCHES)
    loss = fused_softmax_xent_sum(tx, emb.t(),
                                  torch.from_numpy(labels).to(cuda_device),
                                  torch.from_numpy(valid).to(cuda_device),
                                  256, 512)
    loss.backward()
    torch.cuda.synchronize()
    assert {k: fused_xent.LAUNCHES[k] - before[k] for k in before} == \
        {k: 1 for k in before}
    assert emb.grad.shape == emb.shape and tx.grad.shape == tx.shape


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_wgmma_dw_is_bitwise_repeatable(cuda_device, dtype):
    """The wgmma dW (tied head, D 768, a ragged N and vocab) 50 times after
    other kernels: bitwise equal — a fixed summation order, no atomics."""
    x, w, labels, valid = _inputs(7, n=1000, d=768, v=3001)
    x = torch.from_numpy(x).to(cuda_device, dtype)
    w = torch.from_numpy(w).to(cuda_device, dtype).t().contiguous().t()
    labels = torch.from_numpy(labels).to(cuda_device)
    valid = torch.from_numpy(valid).to(cuda_device)
    g = torch.tensor(1.0 / 37.0, device=cuda_device)
    opts = dict(block_rows=1000, block_v=3001)
    lse, _ = registry.dispatch("fused_xent_fwd", x, w, labels, impl="torch",
                               **opts)
    assert fused_xent.dw_route(x, w, labels, lse, valid) == "wgmma"
    call = lambda: registry.dispatch("fused_xent_dw", x, w, labels, lse,
                                     valid, g, impl="cuda", **opts)
    first = call()
    for _ in range(50):
        torch.randn(1 << 20, device=cuda_device).sum()   # other kernels
        assert torch.equal(call(), first)

"""Port parity: the dropout hash, flash attention and the attention
dispatch (deepspeed_tpu_torch/ops/transformer/) against the JAX package.

The same numpy inputs go to both packages; JAX runs its Pallas kernels in
interpret mode on the CPU, as tests/test_flash_attention.py does.  The
dropout seed is drawn on the JAX side (`derive_seed`, threefry) and handed
to the port as an int.  Tolerances:

* hash masks: bitwise (pure uint32 arithmetic on both sides);
* fp32 forward: atol/rtol 2e-5, as tests/test_flash_attention.py:31 —
  the same blocked fp32 arithmetic, sums in another order;
* fp32 gradients: atol/rtol 1e-3, as tests/test_flash_attention.py:48;
* bf16: both sides round p to bf16 before P·V, ds to bf16 before dS·K and
  every output to bf16; inputs are O(1), so outputs are within a few bf16
  ulps: atol 2^-5 (4 ulps at magnitude 1) and rtol 2^-6 (two ulps);
* the CUDA kernels against their plain versions on the card: the
  per-element bounds of `kernels/flash.py` `kernel_tolerances`.

The kernels themselves run only on a card: the `cuda`-marked tests at the
end skip here.  JAX is imported inside the tests that use it, so on a GPU
machine without JAX they run alone:
`python -m pytest --noconftest -m cuda tests/test_torch_flash.py`."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepspeed_tpu_torch.kernels import flash, registry  # noqa: E402
from deepspeed_tpu_torch.ops.transformer import attention  # noqa: E402
from deepspeed_tpu_torch.ops.transformer import dropout as tdrop  # noqa: E402
from deepspeed_tpu_torch.ops.transformer.flash_attention import \
    flash_attention as port_flash  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jx():
    """(jax, jnp, the JAX flash_attention module, its dropout module,
    its attention module)."""
    import importlib

    jax = pytest.importorskip("jax")
    fa = importlib.import_module(
        "deepspeed_tpu.ops.transformer.flash_attention")
    dr = importlib.import_module("deepspeed_tpu.ops.transformer.dropout")
    at = importlib.import_module("deepspeed_tpu.ops.transformer.attention")
    return jax, jax.numpy, fa, dr, at


def _jax_seed(jx, rate, key=0):
    jax, _, fa, _, _ = jx
    return int(fa.derive_seed(rate, jax.random.PRNGKey(key))[0][0])


# -- the hash ----------------------------------------------------------------


def test_fmix32_bitwise(jx):
    _, jnp, fa, _, _ = jx
    h = np.random.RandomState(0).randint(0, 2 ** 32, 4096, dtype=np.uint64)
    h[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    want = np.asarray(fa.fmix32(jnp.asarray(h.astype(np.uint32))))
    got = tdrop.fmix32(torch.from_numpy(h.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed,bh,q0,k0,rate",
                         [(0, 0, 0, 0, 0.1), (12345, 7, 128, 256, 0.5),
                          (2 ** 31 - 2, 65535, 3968, 128, 0.9)])
def test_keep_mask_bitwise(jx, seed, bh, q0, k0, rate):
    _, jnp, fa, _, _ = jx
    i32 = jnp.int32
    want = np.asarray(fa._keep_mask(i32(seed), i32(bh), i32(q0), i32(k0),
                                    16, 128, rate))
    got = tdrop._keep_mask(seed, bh, q0, k0, 16, 128, rate).numpy()
    np.testing.assert_array_equal(got, want)
    assert tdrop.keep_threshold(rate) == int(fa.keep_threshold(rate))


@pytest.mark.parametrize("shape,rate", [((37,), 0.1), ((4, 33, 8), 0.3)])
def test_hash_dropout_bitwise(jx, shape, rate):
    jax, jnp, _, dr, _ = jx
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(dr.hash_dropout(jnp.asarray(x), rate, key))
    got = tdrop.hash_dropout(torch.from_numpy(x), rate,
                             _jax_seed(jx, rate, 3)).numpy()
    np.testing.assert_array_equal(got, want)
    # no seed / eval / rate 0: the identity
    t = torch.from_numpy(x)
    assert tdrop.hash_dropout(t, rate, None) is t
    assert tdrop.hash_dropout(t, rate, 5, train=False) is t
    with pytest.raises(ValueError, match="in \\[0, 1\\)"):
        tdrop.hash_dropout(t, 1.0, 5)


def test_derive_seed_draws_from_the_generator():
    g = torch.Generator().manual_seed(0)
    s1, r1 = tdrop.derive_seed(0.1, g)
    s2, _ = tdrop.derive_seed(0.1, g)
    assert r1 == 0.1 and 0 <= s1 < 2 ** 31 - 1 and s1 != s2
    assert tdrop.derive_seed(0.0, g) == (0, 0.0)
    assert tdrop.derive_seed(0.1, None) == (0, 0.0)


# -- flash attention against JAX's Pallas kernels (interpret) ---------------


def _qkv(B=2, S=256, H=2, D=64, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(4)]


def _key_bias(B, S, seed=0):
    rng = np.random.RandomState(seed + 100)
    neg = np.finfo(np.float32).min     # the padding-mask convention
    kb = np.where(rng.rand(B, S) < 0.25, neg, 0.0).astype(np.float32)
    kb[-1, :] = neg             # a batch whose keys are all masked
    return kb


CASES = {
    "causal": dict(causal=True),
    "full": dict(causal=False),
    "causal-bias": dict(causal=True, bias=True),
    "full-bias": dict(causal=False, bias=True),
    "dropout-offset": dict(causal=True, rate=0.1, bh_offset=5),
    "full-bias-dropout": dict(causal=False, bias=True, rate=0.2),
}


def _both(jx, case, dtype=np.float32, B=2, S=256, H=2, D=64):
    """Loss sum(out * g) through JAX's flash_attention and the port's:
    (jax out, jax grads, port out, port grads) as fp32 numpy."""
    jax, jnp, fa, _, _ = jx
    c = CASES[case]
    rate = c.get("rate", 0.0)
    q, k, v, g = _qkv(B, S, H, D)
    kb = _key_bias(B, S) if c.get("bias") else None
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32

    def jloss(q, k, v):
        out = fa.flash_attention(
            q, k, v, causal=c["causal"], dropout_rate=rate,
            dropout_rng=jax.random.PRNGKey(0) if rate else None,
            key_bias=None if kb is None else jnp.asarray(kb),
            bh_offset=c.get("bh_offset", 0))
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    tout = port_flash(tq, tk, tv, causal=c["causal"], dropout_rate=rate,
                      dropout_seed=_jax_seed(jx, rate) if rate else None,
                      key_bias=None if kb is None else torch.from_numpy(kb),
                      bh_offset=c.get("bh_offset", 0))
    (tout.float() * torch.from_numpy(g)).sum().backward()
    f32 = lambda a: np.asarray(a).astype(np.float32)
    return (f32(jout), [f32(x) for x in jgrads], tout.detach().float().numpy(),
            [t.grad.float().numpy() for t in (tq, tk, tv)])


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_matches_jax_fp32(jx, case):
    jout, jgrads, tout, tgrads = _both(jx, case)
    np.testing.assert_allclose(tout, jout, atol=2e-5, rtol=2e-5)
    for a, b, n in zip(tgrads, jgrads, "qkv"):
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=1e-3,
                                   err_msg=f"d{n}")


@pytest.mark.parametrize("case", ["causal", "dropout-offset"])
def test_flash_matches_jax_bf16(jx, case):
    jout, jgrads, tout, tgrads = _both(jx, case, dtype="bf16", B=1)
    np.testing.assert_allclose(tout, jout, atol=2 ** -5, rtol=2 ** -6)
    for a, b, n in zip(tgrads, jgrads, "qkv"):
        np.testing.assert_allclose(a, b, atol=2 ** -5, rtol=2 ** -6,
                                   err_msg=f"d{n}")


def test_flash_fully_masked_rows_are_zero():
    q, k, v, _ = _qkv(B=2, S=128)
    kb = _key_bias(2, 128)
    out = port_flash(*(torch.from_numpy(a) for a in (q, k, v)),
                     key_bias=torch.from_numpy(kb))
    assert torch.all(out[-1] == 0)


def test_flash_checks_shapes_and_rate():
    q = torch.zeros(1, 200, 2, 64)
    with pytest.raises(ValueError, match="not divisible"):
        port_flash(q, q, q)
    q = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError, match="dropout_rate"):
        port_flash(q, q, q, dropout_rate=1.0, dropout_seed=1)


def test_flash_on_cpu_runs_the_plain_versions():
    from deepspeed_tpu_torch.monitor.counters import COUNTERS

    q, k, v, _ = _qkv(B=1, S=128)
    before = dict(flash.LAUNCHES)
    snap = COUNTERS.snapshot()
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    port_flash(*t).sum().backward()
    assert flash.LAUNCHES == before
    d = COUNTERS.delta_since(snap)
    assert d["kernel.fallbacks"]["calls"] == 3 and "kernel.dispatches" not in d
    with pytest.raises(RuntimeError, match="impl='cuda'"):
        registry.dispatch("flash_attention_fwd", t[0], t[1], t[2], None,
                          impl="cuda", causal=True, scale=0.125,
                          block_q=128, block_k=128, rate=0.0, seed=0,
                          bh_offset=0, n_heads=1)


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(2, 128, 64)
    lse = torch.zeros(2, 128)
    opts = dict(causal=True, scale=0.125, block_q=128, block_k=128,
                rate=0.0, seed=0, bh_offset=0, n_heads=1)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash.flash_fwd_cuda(q, q, q, None, **opts)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash.flash_dq_cuda(q, q, q, q, lse, lse, None, **opts)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash.flash_dkv_cuda(q, q, q, q, lse, lse, None, **opts)
    for route in (flash.dq_route, flash.dkv_route):
        with pytest.raises(ValueError, match="not a CUDA device"):
            route(q.to(torch.bfloat16))


def test_kernel_tolerances_hold_the_plain_version_and_catch_a_fault():
    """The bound of `kernel_tolerances` holds an emulation that differs
    from the bf16 plain version as a kernel may: the same bf16 inputs, lse
    and delta, but fp32 throughout (no rounding of p or ds) and one
    rounding of each output to bf16.  It rejects outputs off by 2^-5."""
    q, k, v, g = _qkv(B=1, S=128, H=2)
    a = [torch.from_numpy(x).permute(0, 2, 1, 3).reshape(2, 128, 64)
         .contiguous().to(torch.bfloat16) for x in (q, k, v, g)]
    opts = dict(causal=True, scale=0.125, block_q=64, block_k=64, rate=0.1,
                seed=9, bh_offset=3, n_heads=2)
    res = {}
    for name, inp in (("bf16", a), ("emulated", [t.float() for t in a])):
        out, lse = registry.dispatch("flash_attention_fwd", *inp[:3], None,
                                     **opts)
        res[name] = {"out": out, "lse": lse}
    bf = res["bf16"]
    delta = (a[3].float() * bf["out"].float()).sum(-1)
    for name, inp in (("bf16", a), ("emulated", [t.float() for t in a])):
        res[name]["dq"] = registry.dispatch(
            "flash_attention_dq", *inp, bf["lse"], delta, None, **opts)
        res[name]["dk"], res[name]["dv"] = registry.dispatch(
            "flash_attention_dkv", *inp, bf["lse"], delta, None, **opts)
    tols = flash.kernel_tolerances(*a, None, bf, **opts)
    for name, t in tols.items():
        emulated = res["emulated"][name].to(torch.bfloat16).float()
        ref = bf[name].float()
        assert bool(((emulated - ref).abs() <= t).all()), name
        faulty = ref * (1 + 2 ** -5) + 2 ** -5
        assert not bool(((faulty - ref).abs() <= t).all()), name


def _wgmma_emulation(kernel, a, kb, lse, delta, opts):
    """What the wgmma dQ ("dq") or dK/dV ("dkv") computes, in fp32 on the
    CPU: p = exp(scale (q.k) - lse) after the causal select and the key
    bias (zeroed where the score is <= NEG_INF / 2), dp times the keep
    mask; dQ rounds ds to K's dtype and sums ds.K over key tiles of 64 in
    order, scale applied once; dK/dV feed pd and ds as three bf16 terms
    (hi, mid, lo: each the rounding of what the terms before it left) and
    sum over q tiles of 64 in order.  Outputs rounded once to the input
    dtype."""
    from deepspeed_tpu_torch.ops.transformer.dropout import _keep_mask
    from deepspeed_tpu_torch.ops.transformer.flash_attention import NEG_INF

    q, k, v, do = (t.float() for t in a)
    BH, S, _ = q.shape
    Sk, H, scale = k.shape[1], opts["n_heads"], opts["scale"]
    s = scale * (q @ k.transpose(-1, -2))
    if opts["causal"]:
        s = torch.where(torch.arange(S)[:, None] >= torch.arange(Sk)[None],
                        s, NEG_INF)
    if kb is not None:
        s = s + kb[torch.arange(BH) // H][:, None, :]
    p = torch.exp(s - lse[..., None])
    if kb is not None:
        p = torch.where(s <= NEG_INF * 0.5, 0.0, p)
    mask = torch.ones_like(p)
    if opts["rate"] > 0.0:
        mask = _keep_mask(opts["seed"], torch.arange(BH) + opts["bh_offset"],
                          0, 0, S, Sk, opts["rate"])
    ds = p * ((do @ v.transpose(-1, -2)) * mask - delta[..., None])
    dt = a[0].dtype
    if kernel == "dq":
        ds = ds.to(dt).float()
        acc = sum(ds[..., k0:k0 + 64] @ k[:, k0:k0 + 64]
                  for k0 in range(0, Sk, 64))
        return {"dq": (scale * acc).to(dt)}

    def terms(x):
        out = []
        for _ in range(3):
            out.append(x.to(torch.bfloat16).float())
            x = x - out[-1]
        return out

    pd = p * mask
    dk = dv = 0.0
    for q0 in range(0, S, 64):
        rows = slice(q0, q0 + 64)
        for tp, tq in zip(terms(pd[:, rows]), terms(ds[:, rows])):
            dv = dv + tp.transpose(-1, -2) @ do[:, rows]
            dk = dk + tq.transpose(-1, -2) @ q[:, rows]
    return {"dk": (scale * dk).to(dt), "dv": dv.to(dt)}


@pytest.mark.parametrize("kernel,dtype", [("dq", torch.bfloat16),
                                          ("dq", torch.float16),
                                          ("dkv", torch.bfloat16)])
def test_kernel_tolerances_hold_the_wgmma_emulation(kernel, dtype):
    """The wgmma dQ's and dK/dV's arithmetic (`_wgmma_emulation`) on a
    ragged causal case with a key bias (one batch all masked), dropout and
    a bh_offset stays inside `kernel_tolerances` of the plain version,
    gives exact zeros for the masked batch, and the bound rejects outputs
    off by 2^-5."""
    B, S, H, D = 2, 96, 2, 64
    q, k, v, g = _qkv(B=B, S=S, H=H, D=D)
    a = [torch.from_numpy(x).permute(0, 2, 1, 3).reshape(B * H, S, D)
         .contiguous().to(dtype) for x in (q, k, v, g)]
    kb = torch.from_numpy(np.maximum(_key_bias(B, S), -1e30))
    opts = dict(causal=True, scale=D ** -0.5, block_q=32, block_k=32,
                rate=0.2, seed=1234, bh_offset=7, n_heads=H)
    out, lse = registry.dispatch("flash_attention_fwd", *a[:3], kb, **opts)
    delta = (a[3].float() * out.float()).sum(-1)
    ref = {"out": out}
    ref["dq"] = registry.dispatch("flash_attention_dq", *a, lse, delta, kb,
                                  **opts)
    ref["dk"], ref["dv"] = registry.dispatch("flash_attention_dkv", *a, lse,
                                             delta, kb, **opts)
    tols = flash.kernel_tolerances(*a, kb, ref, **opts)
    for name, got in _wgmma_emulation(kernel, a, kb, lse, delta,
                                      opts).items():
        r = ref[name].float()
        assert bool(((got.float() - r).abs() <= tols[name]).all()), name
        assert bool((got[-H:] == 0).all()), name
        faulty = r * (1 + 2 ** -5) + 2 ** -5
        assert not bool(((faulty - r).abs() <= tols[name]).all()), name


def test_kernel_tolerances_cover_the_error_of_dp_where_ds_cancels():
    """dq's bound carries the fp32 error of dp = dO·Vᵀ, which the
    magnitude M = scale·|dS||K| does not see where ds = p (dp - delta)
    cancels (a causal row's first key: p = 1, dp = delta).  An emulation
    of the kernel that forms dp in another order — here the plain dp
    moved by up to the model's 1e-5 of its absolute-value sum E — and
    otherwise the plain arithmetic (ds rounded to fp16, fp32 sums)
    exceeds the bound without the term and stays inside it with it."""
    from deepspeed_tpu_torch.ops.transformer.dropout import _keep_mask
    from deepspeed_tpu_torch.ops.transformer.flash_attention import NEG_INF

    B, S, H, D = 1, 128, 2, 128
    q, k, v, g = _qkv(B=B, S=S, H=H, D=D)
    a = [torch.from_numpy(x).permute(0, 2, 1, 3).reshape(B * H, S, D)
         .contiguous().to(torch.float16) for x in (q, k, v, g)]
    scale = D ** -0.5
    opts = dict(causal=True, scale=scale, block_q=64, block_k=64, rate=0.2,
                seed=1234, bh_offset=0, n_heads=H)
    out, lse = registry.dispatch("flash_attention_fwd", *a[:3], None, **opts)
    delta = (a[3].float() * out.float()).sum(-1)
    ref = {"out": out}
    ref["dq"] = registry.dispatch("flash_attention_dq", *a, lse, delta, None,
                                  **opts)
    ref["dk"], ref["dv"] = registry.dispatch("flash_attention_dkv", *a, lse,
                                             delta, None, **opts)
    tol = flash.kernel_tolerances(*a, None, ref, **opts)["dq"]

    q32, k32, v32, do32 = (t.float() for t in a)
    s = (q32 * scale) @ k32.transpose(-1, -2)
    causal = torch.arange(S)[:, None] >= torch.arange(S)[None, :]
    p = torch.exp(torch.where(causal, s, NEG_INF) - lse[..., None])
    mask = _keep_mask(1234, torch.arange(B * H), 0, 0, S, S, 0.2, "cpu")
    e = do32.abs() @ v32.abs().transpose(-1, -2)
    move = torch.rand(e.shape, generator=torch.Generator().manual_seed(0))
    dp = (do32 @ v32.transpose(-1, -2) + 1e-5 * e * (2 * move - 1)) * mask
    ds = (p * (dp - delta[..., None])).to(torch.float16).float()
    emulated = (scale * (ds @ k32)).to(torch.float16).float()
    err = (emulated - ref["dq"].float()).abs()
    term = (1 + 2 * 2.0 ** -11) * scale * ((1e-5 * p * mask * e) @ k32.abs())
    assert not bool((err <= tol - term).all())     # the term is needed
    assert bool((err <= tol).all())                # and enough


# -- the dispatch (attention.py) ---------------------------------------------


def test_dispatch_takes_the_dense_path_on_cpu_and_for_short_seqs(monkeypatch):
    calls = []
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **kw: calls.append(1))
    q = torch.zeros(1, 256, 2, 64)
    out = attention.multihead_attention(q, q, q, impl="auto")
    assert out.shape == q.shape and not calls      # CPU tensor
    use = lambda S, D=64, bias_ok=True: attention._use_flash(
        "auto", on_card=True, S=S, Sk=S, D=D, bias_ok=bias_ok)
    assert use(256) and use(1024, D=128)
    assert not use(128)                 # S < 256
    assert not use(320)                 # not a multiple of 128
    assert not use(256, D=80)           # head_dim
    assert not use(256, bias_ok=False)  # a full bias
    attention.multihead_attention(q, q, q, impl="pallas")
    assert calls == [1]


@pytest.mark.parametrize("causal", [True, False])
def test_dense_attention_matches_jax(jx, causal):
    _, jnp, _, _, at = jx
    q, k, v, _ = _qkv(B=2, S=64, H=3, D=16)
    bias = np.random.RandomState(4).randn(2, 3, 64, 64).astype(np.float32)
    want = at.xla_attention(*(jnp.asarray(a) for a in (q, k, v)),
                            causal=causal, bias=jnp.asarray(bias))
    got = attention.xla_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=causal, bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=2e-6)


def test_dense_attention_dropout_matches_jax(jx):
    jax, jnp, _, _, at = jx
    q, k, v, _ = _qkv(B=1, S=64, H=2, D=16)
    want = at.xla_attention(*(jnp.asarray(a) for a in (q, k, v)),
                            dropout_rate=0.2,
                            dropout_rng=jax.random.PRNGKey(7), train=True)
    got = attention.xla_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  dropout_rate=0.2,
                                  dropout_seed=_jax_seed(jx, 0.2, 7),
                                  train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=2e-6)


def test_flash_path_matches_dense_path():
    q, k, v, _ = _qkv(B=1, S=256, H=2, D=64)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    a = attention.multihead_attention(*t, impl="pallas")
    b = attention.multihead_attention(*t, impl="xla")
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-5)


def test_bh_offset_with_dropout_on_the_dense_path_raises():
    q = torch.zeros(1, 64, 2, 16)
    with pytest.raises(ValueError, match="bh_offset"):
        attention.multihead_attention(q, q, q, impl="xla", dropout_rate=0.1,
                                      dropout_seed=3, train=True,
                                      bh_offset=4)


def test_untileable_explicit_blocks_take_the_dense_path(monkeypatch):
    calls = []
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **kw: calls.append(1))
    q = torch.from_numpy(_qkv(B=1, S=192, H=1, D=64)[0])
    out = attention.multihead_attention(q, q, q, impl="pallas", block_q=128)
    assert out.shape == q.shape and not calls


# -- the kernels on the card --------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit "
                    "(on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_flash.py)")
    return torch.device("cuda")


KERNEL_CASES = {
    # name: (B, S, H, D, causal, bias, rate, bh_offset, block)
    "causal": (2, 256, 3, 64, True, False, 0.0, 0, 128),
    "full-bias": (2, 256, 2, 64, False, True, 0.0, 0, 128),
    "dropout-offset": (2, 256, 2, 64, True, False, 0.1, 7, 128),
    "dh128-bias-dropout": (2, 256, 2, 128, True, True, 0.2, 0, 128),
    "ragged-tiles": (1, 96, 2, 64, True, True, 0.1, 0, 32),
    "dh256-bias-dropout": (2, 256, 2, 256, True, True, 0.2, 3, 128),
    "dh256-ragged-tiles": (1, 96, 2, 256, False, True, 0.1, 0, 32),
}


def _routes(dtype, D):
    """(dQ's, dK/dV's) route as the launcher picks it from dtype and D."""
    dq = ("cuda-cores" if dtype == torch.float32 else
          "wgmma" if D in (64, 128) else "mma.sync")
    dkv = "wgmma" if dtype == torch.bfloat16 and D in (64, 128) else \
        "cuda-cores"
    return dq, dkv


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_cuda_kernels_match_plain_versions(cuda_device, case, dtype):
    B, S, H, D, causal, bias, rate, off, blk = KERNEL_CASES[case]
    q, k, v, g = _qkv(B, S, H, D)
    bhsd = lambda a: torch.from_numpy(a).permute(0, 2, 1, 3).reshape(
        B * H, S, D).contiguous().to(cuda_device, dtype)
    a = [bhsd(x) for x in (q, k, v, g)]
    kb = (torch.from_numpy(_key_bias(B, S)).to(cuda_device) if bias
          else None)
    opts = dict(causal=causal, scale=D ** -0.5, block_q=blk, block_k=blk,
                rate=rate, seed=1234, bh_offset=off, n_heads=H)
    res = {}
    for impl in ("cuda", "torch"):
        out, lse = registry.dispatch("flash_attention_fwd", *a[:3], kb,
                                     impl=impl, **opts)
        res[impl] = {"out": out, "lse": lse}
    # the backward kernels get the plain forward's lse and delta, so each
    # comparison holds one kernel
    lse = res["torch"]["lse"]
    delta = (a[3].float() * res["torch"]["out"].float()).sum(-1)
    for impl in ("cuda", "torch"):
        res[impl]["dq"] = registry.dispatch(
            "flash_attention_dq", *a, lse, delta, kb, impl=impl, **opts)
        res[impl]["dk"], res[impl]["dv"] = registry.dispatch(
            "flash_attention_dkv", *a, lse, delta, kb, impl=impl, **opts)
    torch.cuda.synchronize()
    assert (flash.dq_route(a[0]), flash.dkv_route(a[0])) == \
        _routes(dtype, D)
    tols = flash.kernel_tolerances(*a, kb, res["torch"], **opts)
    for name, tol in tols.items():
        diff = (res["cuda"][name].float() - res["torch"][name].float()).abs()
        assert bool((diff <= tol).all()), (name, float((diff / tol).max()))
    lse_diff = (res["cuda"]["lse"] - lse).abs()
    assert bool((lse_diff <= 1e-5 * (1 + lse.abs())).all()), \
        float(lse_diff.max())



@pytest.mark.cuda
def test_cuda_dq_is_a_function_of_its_inputs(cuda_device):
    """The fp16 Dh 128 key-bias + dropout case, dQ 20 times, each after
    another kernel (the forward, dK/dV) left its own data in shared
    memory: every result equals the first bit for bit, as it must unless
    the kernel races or reads shared memory it did not write."""
    B, S, H, D, causal, bias, rate, off, blk = \
        KERNEL_CASES["dh128-bias-dropout"]
    a = [torch.from_numpy(x).permute(0, 2, 1, 3).reshape(B * H, S, D)
         .contiguous().to(cuda_device, torch.float16)
         for x in _qkv(B, S, H, D)]
    kb = torch.from_numpy(_key_bias(B, S)).to(cuda_device)
    opts = dict(causal=causal, scale=D ** -0.5, block_q=blk, block_k=blk,
                rate=rate, seed=1234, bh_offset=off, n_heads=H)
    out, lse = registry.dispatch("flash_attention_fwd", *a[:3], kb,
                                 impl="torch", **opts)
    delta = (a[3].float() * out.float()).sum(-1)
    args = (*a, lse, delta, kb)
    first = registry.dispatch("flash_attention_dq", *args, impl="cuda",
                              **opts)
    for i in range(20):
        if i % 2:
            registry.dispatch("flash_attention_fwd", *a[:3], kb,
                              impl="cuda", **opts)
        else:
            registry.dispatch("flash_attention_dkv", *args, impl="cuda",
                              **opts)
        got = registry.dispatch("flash_attention_dq", *args, impl="cuda",
                                **opts)
        assert torch.equal(got.view(torch.int16), first.view(torch.int16)), i

@pytest.mark.cuda
def test_cuda_autograd_launches_each_kernel_once(cuda_device):
    q, k, v, _ = _qkv(B=1, S=256, H=2, D=64)
    t = [torch.from_numpy(a).to(cuda_device, torch.bfloat16).requires_grad_()
         for a in (q, k, v)]
    before = dict(flash.LAUNCHES)
    attention.multihead_attention(*t, impl="auto").float().sum().backward()
    torch.cuda.synchronize()
    assert {n: flash.LAUNCHES[n] - before[n] for n in before} == \
        {n: 1 for n in before}



# name: (B, S, Sk, H, D, causal, key bias, dropout, bh_offset, block_q,
# block_k) of the wgmma dQ and dK/dV: both head dims, causal and full, a key
# bias whose last batch has every key masked, dropout 0.2 with bh_offset 7,
# ragged S (96, 200; tiles of 64 rows), Sk != S (under the causal mask the
# keys past S see no row: dK/dV's items there walk no q tile), and the
# training shape (the plain versions' blocks divide S and Sk)
WGMMA_CASES = {
    "dh64-causal": (2, 256, 256, 3, 64, True, False, 0.0, 0, 128, 128),
    "dh64-full-bias": (2, 256, 256, 2, 64, False, True, 0.0, 0, 128, 128),
    "dh64-causal-dropout-offset": (2, 256, 256, 2, 64, True, False, 0.2, 7,
                                   128, 128),
    "dh128-causal-bias-dropout-offset": (2, 256, 256, 2, 128, True, True,
                                         0.2, 7, 128, 128),
    "dh128-full": (2, 256, 256, 2, 128, False, False, 0.0, 0, 128, 128),
    "s96-causal-bias-dropout-offset": (2, 96, 96, 2, 64, True, True, 0.2, 7,
                                       32, 32),
    "s200-dh128-causal": (1, 200, 200, 2, 128, True, False, 0.0, 0, 8, 8),
    "s200-sk72-full-bias": (2, 200, 72, 2, 64, False, True, 0.0, 0, 8, 8),
    "s96-sk200-dh128-full-dropout-offset": (1, 96, 200, 2, 128, False, False,
                                            0.2, 7, 32, 8),
    "s96-sk200-causal-dropout-offset": (2, 96, 200, 2, 64, True, False, 0.2,
                                        7, 32, 8),
    "train": (8, 1024, 1024, 12, 64, True, False, 0.0, 0, 128, 128),
}


def _wgmma_inputs(device, case, dtype, seed=0):
    """q, k, v, dO [B*H, S or Sk, D] in dtype, the key bias (clamped to
    NEG_INF, as the entry point passes it), the plain forward's out, lse
    and delta, and the options."""
    B, S, Sk, H, D, causal, bias, rate, off, bq, bk = WGMMA_CASES[case]
    g = torch.Generator(device=device).manual_seed(seed)
    a = [torch.randn(B * H, n, D, device=device, generator=g).to(dtype)
         for n in (S, Sk, Sk, S)]
    kb = (torch.from_numpy(np.maximum(_key_bias(B, Sk), -1e30)).to(device)
          if bias else None)
    opts = dict(causal=causal, scale=D ** -0.5, block_q=bq, block_k=bk,
                rate=rate, seed=1234, bh_offset=off, n_heads=H)
    out, lse = registry.dispatch("flash_attention_fwd", *a[:3], kb,
                                 impl="torch", **opts)
    delta = (a[3].float() * out.float()).sum(-1)
    return a, kb, out, lse, delta, opts


def _within_bound(kernel, case, dtype, device):
    """The wgmma kernel `kernel` ("dq" | "dkv") against its plain version
    within `kernel_tolerances`, one launch a call; a batch whose keys are
    all masked gets exact zeros."""
    a, kb, out, lse, delta, opts = _wgmma_inputs(device, case, dtype)
    route = flash.dq_route if kernel == "dq" else flash.dkv_route
    assert route(a[0]) == "wgmma"
    args = (*a, lse, delta, kb)
    ref = {"out": out}
    ref["dq"] = registry.dispatch("flash_attention_dq", *args, impl="torch",
                                  **opts)
    ref["dk"], ref["dv"] = registry.dispatch("flash_attention_dkv", *args,
                                             impl="torch", **opts)
    name = f"flash_attention_{kernel}"
    n0 = flash.LAUNCHES[name]
    got = registry.dispatch(name, *args, impl="cuda", **opts)
    torch.cuda.synchronize()
    assert flash.LAUNCHES[name] == n0 + 1
    got = dict(zip(("dq",) if kernel == "dq" else ("dk", "dv"),
                   (got,) if kernel == "dq" else got))
    tols = flash.kernel_tolerances(*a, kb, ref, **opts)
    H = opts["n_heads"]
    for out_name, x in got.items():
        diff = (x.float() - ref[out_name].float()).abs()
        assert bool((diff <= tols[out_name]).all()), \
            (out_name, float((diff / tols[out_name]).max()))
        if kb is not None:
            assert bool((x[-H:] == 0).all()), out_name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(WGMMA_CASES))
def test_cuda_wgmma_dq_within_its_bound(cuda_device, case, dtype):
    _within_bound("dq", case, dtype, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WGMMA_CASES))
def test_cuda_wgmma_dkv_within_its_bound(cuda_device, case):
    _within_bound("dkv", case, torch.bfloat16, cuda_device)


def _repeats(kernel, case, dtype, device, n=50):
    """The persistent grids hand items out in a fixed order and every
    output element is summed by one warp: n calls, each after other
    kernels ran, equal the first bit for bit."""
    a, kb, _, lse, delta, opts = _wgmma_inputs(device, case, dtype, seed=3)
    args = (*a, lse, delta, kb)
    name = f"flash_attention_{kernel}"
    first = registry.dispatch(name, *args, impl="cuda", **opts)
    first = first if isinstance(first, tuple) else (first,)
    other = "flash_attention_dkv" if kernel == "dq" else \
        "flash_attention_dq"
    for _ in range(n):
        registry.dispatch("flash_attention_fwd", *a[:3], kb, impl="cuda",
                          **opts)
        registry.dispatch(other, *args, impl="cuda", **opts)
        again = registry.dispatch(name, *args, impl="cuda", **opts)
        again = again if isinstance(again, tuple) else (again,)
        for x, y in zip(first, again):
            assert torch.equal(x.view(torch.int16), y.view(torch.int16))


@pytest.mark.cuda
def test_cuda_wgmma_dq_is_bitwise_repeatable(cuda_device):
    _repeats("dq", "dh128-causal-bias-dropout-offset", torch.float16,
             cuda_device)


@pytest.mark.cuda
def test_cuda_wgmma_dkv_is_bitwise_repeatable(cuda_device):
    _repeats("dkv", "dh64-causal-dropout-offset", torch.bfloat16,
             cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_cuda_wgmma_backward_launches_from_a_fresh_thread(cuda_device,
                                                          kernel):
    """The backward kernels' tensor maps encoded on a thread that has made
    no CUDA call yet: the launch binds a context first, and the result
    equals the main thread's."""
    import threading

    a, kb, _, lse, delta, opts = _wgmma_inputs(
        cuda_device, "dh64-causal-dropout-offset", torch.bfloat16)
    call = lambda: registry.dispatch(f"flash_attention_{kernel}", *a, lse,
                                     delta, kb, impl="cuda", **opts)
    got = {}

    def run():
        try:
            got["out"] = call()
        except Exception as e:   # re-raised on the test's thread
            got["error"] = e

    th = threading.Thread(target=run)
    th.start()
    th.join()
    if "error" in got:
        raise got["error"]
    torch.cuda.synchronize()
    mine = call()
    for x, y in zip(*((t,) if kernel == "dq" else t
                      for t in (got["out"], mine))):
        assert torch.equal(x, y)

"""Port parity over the kernels' whole domain: head_dim 256 for the dense
and block-sparse flash kernels, sparse layout blocks above 128, paged
attention at head dims other than 64 and 128 (GPT-2 nano's 16, 256, and
every head_dim, odd ones and those above 1024 included),
GPT-2 nano serving, and the `auto` selections at those shapes — the
port's plain versions against the JAX package on the same numpy inputs
(JAX's Pallas kernels in interpret mode on the CPU, as its own tests run
them), then `cuda`-marked cases that launch each new shape on the card.

Tolerances, with the reasons of the files these cases extend
(tests/test_torch_flash.py, test_torch_sparse_attention.py,
test_torch_paged.py):

* dense fp32 forward and lse: atol/rtol 2e-5 — the same blocked fp32
  arithmetic, sums in another order; gradients atol/rtol 1e-3
  (tests/test_flash_attention.py:48);
* sparse fp32 forward: atol 2e-5, rtol 2e-4; gradients atol 5e-5, rtol
  5e-4 (tests/test_flash_sparse.py:58, :75); a dropout mask that
  differed in one element would move an output by O(0.1);
* hash masks at the new tile sizes: bitwise;
* paged over fp32, int8 and int4 caches: atol 1e-5 (fp32 sums in another
  order; a code times its fp16 scale is exact in fp32);
* greedy tokens: equal;
* on the card, kernel against plain version: the per-element bounds of
  `kernels/flash.py` / `kernels/flash_sparse.py` `kernel_tolerances`,
  `kernels/paged.py` `bf16_tolerance` for a bf16 cache, atol 1e-5 for
  fp32 and quantized caches.

JAX is imported inside the tests that use it, so on a GPU machine
without JAX the card tests run alone:
`python -m pytest --noconftest -m cuda tests/test_torch_kernel_domain.py`."""

import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepspeed_tpu_torch.kernels import flash_sparse as fsk  # noqa: E402
from deepspeed_tpu_torch.kernels import paged, registry  # noqa: E402
from deepspeed_tpu_torch.ops.sparse_attention import \
    flash_sparse as tfs  # noqa: E402
from deepspeed_tpu_torch.ops.sparse_attention import \
    sparse_attention as tsp  # noqa: E402
from deepspeed_tpu_torch.ops.transformer import attention  # noqa: E402
from deepspeed_tpu_torch.ops.transformer import dropout as tdrop  # noqa: E402
from deepspeed_tpu_torch.serving.kv_cache import \
    rows_for_tables  # noqa: E402

# the module (the package re-exports its function under the same name)
tfa = importlib.import_module(
    "deepspeed_tpu_torch.ops.transformer.flash_attention")

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    mod = lambda name: importlib.import_module(f"deepspeed_tpu.{name}")
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, fa=mod("ops.transformer.flash_attention"),
        at=mod("ops.transformer.attention"),
        fs=mod("ops.sparse_attention.flash_sparse"),
        reg=mod("kernels.registry"), paged=mod("kernels.paged"),
        quant=mod("runtime.comm.quant"))


def _seed(jx, rate, key=0):
    return int(jx.fa.derive_seed(rate, jx.jax.random.PRNGKey(key))[0][0])


def _arrays(shape, n=4, seed=0, scale=1.0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*shape) * scale).astype(np.float32) for _ in range(n)]


# -- dense flash attention at head_dim 256 ------------------------------------

DENSE_CASES = {
    # name: (causal, key bias, dropout rate, bh_offset)
    "causal": (True, False, 0.0, 0),
    "causal-bias": (True, True, 0.0, 0),
    "dropout-offset": (True, False, 0.1, 5),
    "full-bias-dropout": (False, True, 0.2, 0),
}


def _key_bias(B, S, seed):
    rs = np.random.RandomState(seed + 100)
    neg = np.finfo(np.float32).min     # the padding-mask convention
    kb = np.where(rs.rand(B, S) < 0.25, neg, 0.0).astype(np.float32)
    kb[-1, S // 2:] = neg
    return kb


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_d256_matches_jax_fp32(jx, case):
    """Output, lse and the three gradients of flash attention at D 256
    (B 1, S 256, H 2): the port's plain versions against JAX's Pallas
    kernels."""
    jax, jnp, fa = jx.jax, jx.jnp, jx.fa
    causal, bias, rate, off = DENSE_CASES[case]
    B, S, H, D = 1, 256, 2, 256
    q, k, v, g = _arrays((B, S, H, D), seed=sorted(DENSE_CASES).index(case))
    kb = _key_bias(B, S, 0) if bias else None
    key = jax.random.PRNGKey(0) if rate else None

    def jloss(q, k, v):
        out = fa.flash_attention(q, k, v, causal=causal, dropout_rate=rate,
                                 dropout_rng=key,
                                 key_bias=None if kb is None else
                                 jnp.asarray(kb), bh_offset=off)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    seed = _seed(jx, rate) if rate else None
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tout = tfa.flash_attention(*t, causal=causal, dropout_rate=rate,
                               dropout_seed=seed,
                               key_bias=None if kb is None else
                               torch.from_numpy(kb), bh_offset=off)
    (tout * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=2e-5)
    for a, b, n in zip(t, jgrads, "qkv"):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=1e-3,
                                   rtol=1e-3, err_msg=f"d{n}")

    # the forward's lse ([BH, S]; JAX keeps it lane-broadcast)
    bhsd = lambda a: a.transpose(0, 2, 1, 3).reshape(B * H, S, D)
    jseed, jrate = fa.derive_seed(rate, key)
    jseed = jnp.concatenate([jseed, jnp.asarray([off], jnp.int32)])
    jkb = None if kb is None else jnp.maximum(jnp.asarray(kb), fa.NEG_INF)
    _, jlse = fa._fwd(*(jnp.asarray(bhsd(a)) for a in (q, k, v)), jseed, jkb,
                      causal, D ** -0.5, 128, 128, jrate, H)
    tkb = None if kb is None else torch.clamp_min(torch.from_numpy(kb),
                                                  tfa.NEG_INF)
    _, tlse = tfa._fwd_plain(*(torch.from_numpy(bhsd(a)) for a in (q, k, v)),
                             tkb, causal=causal, scale=D ** -0.5,
                             block_q=128, block_k=128, rate=rate,
                             seed=seed or 0, bh_offset=off, n_heads=H)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[..., 0],
                               atol=2e-5, rtol=2e-5)


# -- block-sparse flash attention: blocks above 128, head_dim 256 -------------

SPARSE_CASES = {
    # name: (B, S, H, D, block, causal, dropout rate)
    "block256-dropout": (1, 512, 2, 64, 256, False, 0.2),
    "block256-causal": (1, 512, 2, 64, 256, True, 0.0),
    "block192-causal-dropout": (1, 384, 2, 64, 192, True, 0.2),
    "d256-block128-dropout": (1, 256, 2, 256, 128, False, 0.2),
}


def _sparse_layout(H, nb):
    """Per head: a diagonal plus the first block column (a global
    column), and for head 1 block (0, nb-1) too (the last block column
    from the first row)."""
    layout = np.zeros((H, nb, nb), np.int64)
    for i in range(nb):
        layout[:, i, i] = 1
        layout[:, i, 0] = 1
    layout[1:, 0, nb - 1] = 1
    return layout


@pytest.mark.parametrize("name", sorted(SPARSE_CASES))
def test_sparse_plain_versions_match_jax(jx, name):
    jax, jnp = jx.jax, jx.jnp
    B, S, H, D, blk, causal, rate = SPARSE_CASES[name]
    layout = _sparse_layout(H, S // blk)
    q, k, v, g = _arrays((B, S, H, D), seed=sorted(SPARSE_CASES).index(name),
                         scale=0.5)
    key = jax.random.PRNGKey(50)

    def jloss(q, k, v):
        o = jx.fs.flash_sparse_attention(q, k, v, layout, blk, causal=causal,
                                         dropout_rate=rate,
                                         dropout_rng=key if rate else None)
        return jnp.sum(o * g), o

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                          has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tout = tfs.flash_sparse_attention(
        *t, layout, blk, causal=causal, dropout_rate=rate,
        dropout_seed=_seed(jx, rate, 50) if rate else None)
    (tout * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=2e-4)
    for a, b, n in zip(t, jgrads, "qkv"):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=5e-5,
                                   rtol=5e-4, err_msg=f"d{n}")


@pytest.mark.parametrize("blk", [192, 256])
def test_keep_mask_at_large_tiles_equals_jax_bitwise(jx, blk):
    jnp = jx.jnp
    seed, rate = _seed(jx, 0.3, 3), 0.3
    for bh, qi, kj in ((0, 0, 0), (3, 2, 1), (7, 1, 3)):
        want = np.asarray(jx.fa._keep_mask(
            jnp.asarray(seed), jnp.asarray(bh), jnp.asarray(qi * blk),
            jnp.asarray(kj * blk), blk, blk, rate))
        ar = torch.arange(blk)
        got = tdrop.keep_mask_at(seed, torch.tensor(bh),
                                 (qi * blk + ar)[:, None],
                                 (kj * blk + ar)[None, :], rate)
        np.testing.assert_array_equal(got.numpy(), want)


def test_sparse_kernel_tables_at_block_256_are_jax_tables(jx):
    layout = _sparse_layout(2, 4)
    for a, b in zip(jx.fs.layout_tables(layout), tfs.layout_tables(layout)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# -- the `auto` selections at the new shapes ----------------------------------


@pytest.mark.parametrize("D", [64, 128, 256])
def test_dense_auto_selects_as_jax_on_the_card(jx, monkeypatch, D):
    """JAX's `auto` on its accelerator and the port's on the card pick
    the flash kernels for the same shapes (JAX's `_on_tpu` forced true,
    its flash_attention replaced by a recorder)."""
    calls = []
    monkeypatch.setattr(jx.at, "_on_tpu", lambda: True)
    monkeypatch.setattr(jx.fa, "flash_attention",
                        lambda q, *a, **kw: calls.append(1) or q)
    for S in (128, 256, 384, 1024):
        x = jx.jnp.zeros((1, S, 2, D), jx.jnp.float32)
        calls.clear()
        jx.at.multihead_attention(x, x, x, impl="auto")
        got = attention._use_flash("auto", on_card=True, S=S, Sk=S, D=D,
                                   bias_ok=True)
        assert got == bool(calls), (S, D)
        assert not attention._use_flash("auto", on_card=False, S=S, Sk=S,
                                        D=D, bias_ok=True)


@pytest.mark.parametrize("block", [128, 256])
def test_sparse_auto_selects_as_jax(jx, block):
    op = jx.reg.get_kernel("sparse_attention")
    for D in (64, 128, 256):
        info = {"plain": True, "block": block, "head_dim": D}
        want = op.auto_supports("default", info)[0]
        assert want and tsp.auto_supports(True, block, D)[0] == want
        # the kernels take every head_dim `auto` sends them
        assert D in fsk.HEAD_DIMS


# -- paged attention at head dims other than 64 and 128 -----------------------


def _paged_inputs(T, Dh, R=3, H=2, bs=4, W=4, seed=0):
    rs = np.random.RandomState(seed)
    nblocks = R * W + 1
    ck = rs.randn(nblocks * bs, H, Dh).astype(np.float32)
    cv = rs.randn(nblocks * bs, H, Dh).astype(np.float32)
    tables = rs.randint(1, nblocks, (R, W)).astype(np.int32)
    tables[0, W - 1] = 0                # the trash block
    q = rs.randn(R, T, H, Dh).astype(np.float32)
    q_pos = (rs.randint(0, W * bs - T, (R, 1)) +
             np.arange(T)[None, :]).astype(np.int32)
    return q, ck, cv, tables, q_pos, bs


# (Dh, kv mode): the head dims a multiple of 8 in every cache mode, then
# head dims off that grid (an int4 cache needs an even one)
PAGED_DOMAIN = ([(Dh, kv) for Dh in (8, 16, 24, 256)
                 for kv in ("dense", "int8", "int4")] +
                [(Dh, kv) for Dh in (12, 20, 33) for kv in ("dense", "int8")] +
                [(100, "dense"), (100, "int8"), (100, "int4")] +
                # above 1024 columns the kernel streams q.k over pieces
                [(Dh, kv) for Dh in (1032, 2048) for kv in ("dense", "int8")])


@pytest.mark.parametrize("Dh,kv", PAGED_DOMAIN)
def test_paged_reference_matches_jax_at_other_head_dims(jx, Dh, kv):
    from deepspeed_tpu_torch.runtime.comm.quant import quantize_rows

    jnp = jx.jnp
    T = 5
    q, ck, cv, tables, q_pos, bs = _paged_inputs(T, Dh, seed=Dh)
    rows = rows_for_tables(torch.from_numpy(tables).long(), bs)
    if kv == "dense":
        tk, tv = torch.from_numpy(ck), torch.from_numpy(cv)
        jk, jv = jnp.asarray(ck), jnp.asarray(cv)
    else:
        tk, tv = (quantize_rows(torch.from_numpy(c), kv) for c in (ck, cv))
        jk, jv = (jx.quant.quantize_rows(jnp.asarray(c), kv)
                  for c in (ck, cv))
    got = registry.dispatch("paged_attention", torch.from_numpy(q), tk, tv,
                            rows, torch.from_numpy(q_pos).long(),
                            kv_mode=kv, block_size=bs).numpy()
    jrows = jnp.asarray(rows.numpy())
    want = jx.paged.paged_attention_reference(
        jnp.asarray(q), jk, jv, jrows, jnp.asarray(q_pos), kv_mode=kv,
        block_size=bs)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    if (kv == "dense" and Dh in (16, 1032)) or Dh % 8:
        # the TPU kernel itself (Pallas interpreter) at nano's head_dim, at
        # every head_dim off the multiples of 8 and past 1024
        want = jx.paged.paged_attention_pallas(
            jnp.asarray(q), jk, jv, jrows, jnp.asarray(q_pos), kv_mode=kv,
            block_size=bs)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5,
                                   rtol=0)


def test_paged_int4_refuses_an_odd_head_dim_in_both_codecs(jx):
    """An int4 cache packs two codes a byte: both packages' row codecs
    refuse an odd trailing axis, so no int4 cache of an odd head_dim
    reaches either kernel."""
    from deepspeed_tpu_torch.runtime.comm.quant import quantize_rows

    x = np.random.RandomState(0).randn(4, 2, 33).astype(np.float32)
    with pytest.raises(ValueError, match="even trailing axis"):
        quantize_rows(torch.from_numpy(x), "int4")
    with pytest.raises(ValueError):
        jx.quant.quantize_rows(jx.jnp.asarray(x), "int4")


@pytest.mark.parametrize("Dh,ok", [(16, True), (200, True), (256, True),
                                   (20, True), (264, True), (1, True),
                                   (33, True), (1024, True), (1032, True)])
def test_paged_kernel_wrapper_head_dim_domain(Dh, ok):
    """Every head_dim, 1032 (past the old 1024 cap) included, passes the
    wrapper's head_dim check; a CPU tensor is then refused, as any is."""
    assert ok
    q, ck, cv, tables, q_pos, bs = _paged_inputs(1, Dh)
    rows = rows_for_tables(torch.from_numpy(tables).long(), bs)
    with pytest.raises(ValueError, match="not a CUDA device"):
        paged.paged_attention_cuda(
            torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
            rows, torch.from_numpy(q_pos), block_size=bs)


def test_paged_kernel_wrapper_states_its_head_dim_limit():
    """Only the grid bounds the head_dim: 65535 blocks of 256 output
    columns.  One past that raises, naming the limit (q is a broadcast
    view, so nothing of that width is allocated)."""
    Dh = paged.MAX_HEAD_DIM + 1
    q = torch.zeros(1, 1, 1, 1).expand(1, 1, 1, Dh)
    ck = torch.zeros(4, 1, 1)
    rows = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match=f"above {paged.MAX_HEAD_DIM}.*65535"):
        paged.paged_attention_cuda(q, ck, ck, rows, torch.zeros(1, 1),
                                   block_size=4)
    assert paged.MAX_HEAD_DIM == 65535 * 256


# -- GPT-2 nano serving (head_dim 16) ------------------------------------------

NANO_SERVE = dict(block_size=8, num_blocks=40, max_batch=4, prefill_chunk=16,
                  max_seq_len=64)


def _nano_pair():
    import jax

    from deepspeed_tpu.models.gpt import GPT as JaxGPT
    from deepspeed_tpu.models.gpt import gpt2_config as jax_gpt2_config
    from deepspeed_tpu_torch.models import GPT, gpt2_config, load_jax_params

    jmodel = JaxGPT(jax_gpt2_config("nano"))
    jparams = jmodel.init(jax.random.PRNGKey(3))
    model = GPT(gpt2_config("nano"), device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, jparams))
    assert model.config.head_dim == 16
    return jmodel, jparams, model


def test_nano_greedy_serving_matches_jax_engine(jx):
    from deepspeed_tpu import serving as jserving
    from deepspeed_tpu_torch.serving import ServeConfig, ServeEngine

    jmodel, jparams, model = _nano_pair()
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 256, (n,)).tolist() for n in (5, 19, 9, 12)]
    want = jserving.ServeEngine(jmodel, jparams, jserving.ServeConfig(
        **NANO_SERVE)).generate(prompts, 8)
    got = ServeEngine(model, ServeConfig(**NANO_SERVE),
                      device="cpu").generate(prompts, 8)
    assert got == want


# -- the new shapes on the card -------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit "
                    "(on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_kernel_domain.py)")
    return torch.device("cuda")


# (T, Dh, kv mode) on the card: decode, verify and prefill tiles at the
# head dims a multiple of 8, then off that grid and up to the cap (int4
# only at an even head_dim)
PAGED_CARD = ([(T, Dh, kv) for T, Dh in ((1, 16), (16, 16), (5, 24),
                                         (1, 256), (16, 256))
               for kv in ("dense", "int8", "int4")] +
              [(T, Dh, kv) for T, Dh in ((1, 20), (16, 20), (1, 100),
                                         (5, 100), (1, 12), (5, 512),
                                         (1, 1024), (1, 1032), (5, 2048))
               for kv in ("dense", "int8", "int4")] +
              [(T, Dh, kv) for T, Dh in ((1, 33), (16, 33), (5, 1), (1, 7))
               for kv in ("dense", "int8")])


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,Dh,kv", PAGED_CARD)
def test_cuda_paged_kernel_at_other_head_dims(cuda_device, T, Dh, kv,
                                              q_dtype):
    """The kernel launches at these head dims and agrees with its plain
    version: a dense cache in q's dtype (fp32: atol 1e-5, bf16:
    `bf16_tolerance`), an int8 / int4 cache (fp32 throughout: atol
    1e-5)."""
    from deepspeed_tpu_torch.runtime.comm.quant import quantize_rows

    q, ck, cv, tables, q_pos, bs = _paged_inputs(T, Dh, R=3, H=4, bs=16,
                                                 W=8, seed=Dh)
    dev = cuda_device
    if kv == "dense":
        caches = [torch.from_numpy(c).to(dev, q_dtype) for c in (ck, cv)]
    else:
        caches = [quantize_rows(torch.from_numpy(c).to(dev), kv)
                  for c in (ck, cv)]
    rows = rows_for_tables(torch.from_numpy(tables).long().to(dev), bs)
    args = (torch.from_numpy(q).to(dev, q_dtype), *caches, rows,
            torch.from_numpy(q_pos).long().to(dev))
    n = paged.LAUNCHES
    out = registry.dispatch("paged_attention", *args, kv_mode=kv,
                            block_size=bs)
    ref = registry.dispatch("paged_attention", *args, impl="torch",
                            kv_mode=kv, block_size=bs)
    torch.cuda.synchronize()
    assert paged.LAUNCHES == n + 1
    diff = (out.float() - ref.float()).abs()
    tol = (paged.bf16_tolerance(*args, ref)
           if kv == "dense" and q_dtype == torch.bfloat16
           else torch.full_like(diff, 1e-5))
    assert bool((diff <= tol).all()), float((diff / tol).max())


@pytest.mark.cuda
def test_cuda_nano_serving_matches_generate(cuda_device):
    """GPT-2 nano (Dh 16) served on the card through the paged kernel
    (fp32 weights and cache): greedy tokens equal the port's generate()
    on the card, and the kernel launched."""
    from deepspeed_tpu_torch.models import GPT, generate, gpt2_config
    from deepspeed_tpu_torch.serving import ServeConfig, ServeEngine

    torch.manual_seed(0)
    model = GPT(gpt2_config("nano"), device=cuda_device)
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 256, (n,)).tolist() for n in (5, 19, 9, 12)]
    n = paged.LAUNCHES
    got = ServeEngine(model, ServeConfig(**NANO_SERVE),
                      device=cuda_device).generate(prompts, 8)
    assert paged.LAUNCHES > n
    want = [generate(model, [p], 8, cache_len=64,
                     device=cuda_device)[0].tolist() for p in prompts]
    assert got == want

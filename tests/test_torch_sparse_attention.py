"""Port parity: block-sparse attention (deepspeed_tpu_torch/ops/
sparse_attention/, kernels #7-#9's plain versions) against the JAX package.

The same numpy inputs go to both packages; JAX runs its Pallas kernels in
interpret mode on the CPU, as tests/test_flash_sparse.py does.  Shapes are
JAX's own test scale (B 2, S 128, H 2, block 16/32).  The dropout seed is
drawn on the JAX side (`derive_seed`, threefry) and handed to the port as
an int.  Tolerances:

* layouts, tables, gather indices and hash masks: bitwise (numpy and
  uint32 arithmetic on both sides; random layouts from the same
  `random.seed`);
* fp32 forward: atol 2e-5, rtol 2e-4, as tests/test_flash_sparse.py:58 —
  the same fp32 arithmetic, sums in another order; a mask that differed
  in one element would move an output by O(0.1);
* fp32 gradients: atol 5e-5, rtol 5e-4, as tests/test_flash_sparse.py:75;
* bf16: both sides round p to bf16 before P·V, ds to bf16 before dS·K and
  every output to bf16; inputs O(1): atol 2^-5, rtol 2^-6 (a few bf16
  ulps), as tests/test_torch_flash.py;
* the CUDA kernels against their plain versions on the card: the
  per-element bounds of `kernels/flash_sparse.py` `kernel_tolerances`.

The kernels run only on a card: the `cuda`-marked tests at the end skip
here; on a GPU machine without JAX:
`python -m pytest --noconftest -m cuda tests/test_torch_sparse_attention.py`."""

import random
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepspeed_tpu_torch.kernels import flash_sparse as fsk  # noqa: E402
from deepspeed_tpu_torch.kernels import registry  # noqa: E402
from deepspeed_tpu_torch.monitor.counters import COUNTERS  # noqa: E402
from deepspeed_tpu_torch.ops import sparse_attention as tsa  # noqa: E402
from deepspeed_tpu_torch.ops.sparse_attention import \
    flash_sparse as tfs  # noqa: E402
from deepspeed_tpu_torch.ops.sparse_attention import \
    sparse_attention as tsp  # noqa: E402
from deepspeed_tpu_torch.ops.transformer import dropout as tdrop  # noqa: E402

torch.set_num_threads(1)

B, S, H, D = 2, 128, 2, 16
BLK = 16


@pytest.fixture(scope="module")
def jx():
    """(jax, jnp, the JAX sparse_attention package, its flash_sparse
    module, its sparse_attention module, the JAX flash_attention module)."""
    import importlib

    jax = pytest.importorskip("jax")
    pkg = importlib.import_module("deepspeed_tpu.ops.sparse_attention")
    fs = importlib.import_module(
        "deepspeed_tpu.ops.sparse_attention.flash_sparse")
    sp = importlib.import_module(
        "deepspeed_tpu.ops.sparse_attention.sparse_attention")
    fa = importlib.import_module(
        "deepspeed_tpu.ops.transformer.flash_attention")
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, pkg=pkg, fs=fs,
                                 sp=sp, fa=fa)


def _seed(jx, rate, key):
    return int(jx.fa.derive_seed(rate, jx.jax.random.PRNGKey(key))[0][0])


def _qkv(seed=0, shape=(B, S, H, D), scale=0.5):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*shape) * scale).astype(np.float32) for _ in range(4)]


# -- layouts ------------------------------------------------------------------

CONFIGS = {
    "dense": ("DenseSparsityConfig", dict(num_heads=4, block=16)),
    "fixed": ("FixedSparsityConfig", dict(num_heads=4, block=16,
                                          num_local_blocks=4,
                                          num_global_blocks=1)),
    "fixed-uni": ("FixedSparsityConfig", dict(
        num_heads=4, block=16, num_local_blocks=4, num_global_blocks=2,
        attention="unidirectional")),
    "fixed-patterns": ("FixedSparsityConfig", dict(
        num_heads=4, block=16, different_layout_per_head=True,
        num_local_blocks=4, num_global_blocks=1,
        num_different_global_patterns=4, horizontal_global_attention=True)),
    "variable": ("VariableSparsityConfig", dict(
        num_heads=4, block=16, different_layout_per_head=True,
        num_random_blocks=2, local_window_blocks=[2, 3],
        global_block_indices=[0, 5], horizontal_global_attention=True)),
    "variable-ends": ("VariableSparsityConfig", dict(
        num_heads=2, block=16, num_random_blocks=1,
        global_block_indices=[1], global_block_end_indices=[3],
        attention="unidirectional")),
    "bigbird": ("BigBirdSparsityConfig", dict(
        num_heads=4, block=16, different_layout_per_head=True,
        num_random_blocks=2, num_sliding_window_blocks=3,
        num_global_blocks=1)),
    "bigbird-uni": ("BigBirdSparsityConfig", dict(
        num_heads=2, block=16, num_random_blocks=2,
        attention="unidirectional")),
    "bslongformer": ("BSLongformerSparsityConfig", dict(
        num_heads=2, block=16, num_sliding_window_blocks=3,
        global_block_indices=[0, 4], global_block_end_indices=[2, 6])),
    "sliding": ("LocalSlidingWindowSparsityConfig", dict(
        num_heads=2, block=16, num_sliding_window_blocks=5)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layouts_equal_jax_under_the_same_random_seed(jx, name):
    cls, kw = CONFIGS[name]
    out = []
    for pkg in (jx.pkg, tsa):
        random.seed(1234)
        out.append(getattr(pkg, cls)(**kw).make_layout(208))
    assert out[0].dtype == out[1].dtype and np.array_equal(out[0], out[1])
    # the random configs draw from the global `random`: a second draw moves
    random.seed(1234)
    again = getattr(tsa, cls)(**kw).make_layout(208)
    assert np.array_equal(again, out[1])


def test_layout_config_errors_match_jax(jx):
    for pkg in (jx.pkg, tsa):
        with pytest.raises(ValueError, match="divisible"):
            pkg.FixedSparsityConfig(num_heads=2, block=16).make_layout(100)
        with pytest.raises(ValueError, match="divisible"):
            pkg.FixedSparsityConfig(num_heads=2, num_local_blocks=4,
                                    num_global_blocks=3)
        with pytest.raises(NotImplementedError):
            pkg.FixedSparsityConfig(num_heads=2, attention="sideways")


def _fixed(kind="fixed", blk=BLK, seq=S, heads=H):
    if kind == "fixed":
        cfg = tsa.FixedSparsityConfig(num_heads=heads, block=blk,
                                      num_local_blocks=2, num_global_blocks=1)
    elif kind == "bigbird":
        random.seed(7)
        cfg = tsa.BigBirdSparsityConfig(num_heads=heads, block=blk,
                                        different_layout_per_head=True,
                                        num_random_blocks=1,
                                        num_sliding_window_blocks=3,
                                        num_global_blocks=1)
    else:   # a hand-made layout: a diagonal with row 3 empty
        nb = seq // blk
        layout = np.zeros((heads, nb, nb), np.int64)
        for i in range(nb):
            layout[:, i, i] = 1
        layout[:, 5, 0] = 1
        layout[:, 3, :] = 0
        return layout
    return np.asarray(cfg.make_layout(seq))


@pytest.mark.parametrize("kind", ["fixed", "bigbird", "empty-row"])
def test_layout_tables_and_gather_equal_jax(jx, kind):
    layout = _fixed(kind)
    for a, b in zip(jx.fs.layout_tables(layout), tfs.layout_tables(layout)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(jx.sp.layout_to_gather(layout),
                    tsp.layout_to_gather(layout)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    fwd, rev = tfs.layout_tables(layout)
    assert (fwd[:, 3] == -1).all() if kind == "empty-row" else True
    # ascending, -1 padded at the end: the kernels stop at the first -1
    for t in (fwd, rev):
        for row in t.reshape(-1, t.shape[-1]):
            n = int((row >= 0).sum())
            assert (row[n:] == -1).all() and (np.diff(row[:n]) > 0).all()


def test_tile_keep_mask_equals_jax_bitwise(jx):
    """The plain versions' mask at a layout tile's token coordinates is
    JAX's `_keep_mask` for that tile, bit for bit."""
    jnp = jx.jnp
    seed, rate, blk = _seed(jx, 0.3, 3), 0.3, 16
    for bh, qi, kj in ((0, 0, 0), (3, 5, 2), (7, 1, 6)):
        want = np.asarray(jx.fa._keep_mask(
            jnp.asarray(seed), jnp.asarray(bh), jnp.asarray(qi * blk),
            jnp.asarray(kj * blk), blk, blk, rate))
        ar = torch.arange(blk)
        got = tdrop.keep_mask_at(seed, torch.tensor(bh),
                                 (qi * blk + ar)[:, None],
                                 (kj * blk + ar)[None, :], rate)
        np.testing.assert_array_equal(got.numpy(), want)


# -- the plain versions of #7-#9 against JAX's flash_sparse_attention ---------

# name: (layout kind, causal, dropout rate, dtype)
FLASH_CASES = {
    "fixed": ("fixed", False, 0.0, np.float32),
    "fixed-causal": ("fixed", True, 0.0, np.float32),
    "fixed-dropout": ("fixed", False, 0.3, np.float32),
    "fixed-causal-dropout": ("fixed", True, 0.3, np.float32),
    "bigbird": ("bigbird", False, 0.0, np.float32),
    "bigbird-causal-dropout": ("bigbird", True, 0.3, np.float32),
    "empty-row": ("empty-row", False, 0.0, np.float32),
    "empty-row-causal-dropout": ("empty-row", True, 0.3, np.float32),
    "fixed-dropout-bf16": ("fixed", False, 0.3, "bfloat16"),
}


def _flash_both(jx, name):
    kind, causal, rate, dtype = FLASH_CASES[name]
    jax, jnp = jx.jax, jx.jnp
    layout = _fixed(kind)
    q, k, v, g = _qkv(seed=sorted(FLASH_CASES).index(name))
    key = jax.random.PRNGKey(50)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def jloss(q, k, v):
        o = jx.fs.flash_sparse_attention(
            q, k, v, layout, BLK, causal=causal, dropout_rate=rate,
            dropout_rng=key if rate else None)
        return jnp.sum(o.astype(jnp.float32) * g), o

    jargs = [jnp.asarray(t).astype(jdt) for t in (q, k, v)]
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                          has_aux=True)(*jargs)
    targs = [torch.from_numpy(t).to(tdt).requires_grad_() for t in (q, k, v)]
    tout = tfs.flash_sparse_attention(
        *targs, layout, BLK, causal=causal, dropout_rate=rate,
        dropout_seed=_seed(jx, rate, 50) if rate else None)
    (tout.float() * torch.from_numpy(g)).sum().backward()
    f32 = lambda a: np.asarray(a).astype(np.float32)
    return ((f32(jout), tout.detach().float().numpy()),
            [(f32(a), b.grad.float().numpy()) for a, b in zip(jgrads, targs)],
            dtype)


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_plain_versions_match_jax_flash_sparse(jx, name):
    (jo, to), grads, dtype = _flash_both(jx, name)
    if dtype == "bfloat16":
        fwd_tol = grad_tol = dict(atol=2.0 ** -5, rtol=2.0 ** -6)
    else:
        fwd_tol, grad_tol = (dict(atol=2e-5, rtol=2e-4),
                             dict(atol=5e-5, rtol=5e-4))
    np.testing.assert_allclose(to, jo, **fwd_tol)
    for (a, b), n in zip(grads, "qkv"):
        np.testing.assert_allclose(b, a, err_msg=f"d{n}", **grad_tol)
    if name.startswith("empty-row"):
        # a row with no active block: zero output, no gradient into it
        rows = slice(3 * BLK, 4 * BLK)
        assert (to[:, rows] == 0).all() and (grads[0][1][:, rows] == 0).all()


def _dkv_items(order, n_batch, n_heads, nk, block):
    """The work items (bh, 64-key tile) in the order the wgmma dK/dV's
    persistent grid hands them out (csrc/flash_sparse.cu
    `sparse_dkv_wgmma_kernel`): item w is the (head, k-block) pair
    order[w // (n_batch tpb)], batch (w % (n_batch tpb)) // tpb and the
    pair's key tile w % tpb (tpb = block // 64)."""
    tpb = block // 64
    w = np.arange(n_batch * n_heads * nk * tpb)
    per = n_batch * tpb
    hk = np.asarray(order, np.int64)[w // per]
    r = w % per
    return np.stack([(r // tpb) * n_heads + hk // nk,
                     (hk % nk) * tpb + r % tpb], axis=1)


@pytest.mark.parametrize("kind,blk", [("fixed", 128), ("bigbird", 64),
                                       ("empty-column", 128)])
def test_dkv_work_order_is_every_item_heaviest_walk_first(kind, blk):
    """The wgmma dK/dV's schedule: the items (bh, 64-key tile) its
    persistent grid takes, in order, are every item once, by the length
    of their reverse-table walk (active q-blocks), heaviest first; the
    order is what `device_tables` keeps beside the tables."""
    seq, heads, n_batch = 8 * blk, 4, 3
    layout = _fixed("empty-row" if kind == "empty-column" else kind,
                    blk=blk, seq=seq, heads=heads)
    nk = seq // blk
    if kind == "empty-column":
        assert not layout[:, :, 3].any()      # k-block 3: nobody reads it
    _, rev = tfs.layout_tables(layout)
    order = tfs.dkv_work_order(rev)
    ft, rt, dev_order = tfs.device_tables(layout, "cpu")
    assert dev_order.dtype == torch.int32
    assert np.array_equal(dev_order.numpy(), order)
    items = _dkv_items(order, n_batch, heads, nk, blk)
    tpb = blk // 64
    want = {(bh, t) for bh in range(n_batch * heads) for t in range(nk * tpb)}
    got = [tuple(map(int, it)) for it in items]
    assert len(got) == len(want) and set(got) == want
    walk = (rev >= 0).sum(-1)                         # [H, nk]
    lengths = [int(walk[bh % heads, t // tpb]) for bh, t in got]
    assert lengths == sorted(lengths, reverse=True)
    assert lengths[0] == int(walk.max()) and lengths[-1] == int(walk.min())
    if kind == "empty-column":
        assert lengths[-1] == 0
    if kind == "fixed":
        # the global column walks every q-block, the others their window
        assert lengths[0] == nk and lengths[-1] < nk


def test_plain_lse_of_an_empty_row_is_neg_inf():
    layout = _fixed("empty-row")
    ft, _, _ = tfs.device_tables(layout, "cpu")
    q = torch.randn(B * H, S, 64)
    out, lse = tfs._fwd_plain(q, q, q, ft, causal=False, scale=0.125,
                              block=BLK, rate=0.0, seed=0, n_heads=H)
    assert (lse[:, 3 * BLK:4 * BLK] == tfs.NEG_INF).all()
    assert (out[:, 3 * BLK:4 * BLK] == 0).all()
    assert torch.isfinite(lse[:, :3 * BLK]).all()


def test_flash_sparse_checks_its_arguments():
    q = torch.zeros(1, 64, 2, 16)
    layout = np.ones((2, 4, 4), np.int64)
    with pytest.raises(ValueError, match="divisible"):
        tfs.flash_sparse_attention(q[:, :60], q[:, :60], q[:, :60], layout,
                                   16)
    with pytest.raises(ValueError, match="layout shape"):
        tfs.flash_sparse_attention(q, q, q, layout[:1], 16)
    with pytest.raises(ValueError, match="dropout_rate"):
        tfs.flash_sparse_attention(q, q, q, layout, 16, dropout_rate=1.0,
                                   dropout_seed=1)


def test_kernel_wrappers_refuse_cpu_tensors_and_forced_cuda_raises():
    q = torch.zeros(4, 64, 64)
    tbl = torch.zeros(2, 4, 1, dtype=torch.int32)
    opts = dict(causal=False, scale=0.125, block=16, rate=0.0, seed=0,
                n_heads=2)
    with pytest.raises(ValueError, match="not a CUDA device"):
        fsk.flash_sparse_fwd_cuda(q, q, q, tbl, **opts)
    with pytest.raises(RuntimeError, match="impl='cuda'"):
        registry.dispatch("flash_sparse_fwd", q, q, q, tbl, impl="cuda",
                          **opts)


def _emulated_wgmma_dq(q, k, v, dout, lse, delta, fwd_tbl, *, causal, scale,
                       block, rate, seed, n_heads):
    """The wgmma dQ's arithmetic on the CPU: per 64-row q tile the
    forward-table row in table order, 64 keys at a time; s = scale (q.k)
    and dp = dO.V^T in fp32, the causal select, p = exp(s - lse), dp times
    the keep mask, ds = p (dp - delta) rounded once to K's dtype, dQ +=
    ds.K in fp32, the scale once at the end, rounded to q's dtype."""
    from deepspeed_tpu_torch.ops.transformer.flash_attention import NEG_INF

    BH, S, D = q.shape
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, dout))
    dq = torch.zeros(BH, S, D)
    for bh in range(BH):
        for q0 in range(0, S, 64):
            rows = torch.arange(q0, q0 + 64)
            acc = torch.zeros(64, D)
            for kj in fwd_tbl[bh % n_heads, q0 // block].tolist():
                if kj < 0:
                    break
                for k0 in range(kj * block, (kj + 1) * block, 64):
                    keys = torch.arange(k0, k0 + 64)
                    s = scale * (q32[bh, rows] @ k32[bh, keys].t())
                    if causal:
                        s = torch.where(rows[:, None] >= keys[None, :], s,
                                        NEG_INF)
                    p = torch.exp(s - lse[bh, rows, None])
                    dp = do32[bh, rows] @ v32[bh, keys].t()
                    if rate > 0.0:
                        dp = dp * tdrop.keep_mask_at(
                            seed, torch.tensor(bh), rows[:, None],
                            keys[None, :], rate)
                    ds = (p * (dp - delta[bh, rows, None])).to(k.dtype)
                    acc = acc + ds.float() @ k32[bh, keys]
            dq[bh, rows] = scale * acc
    return dq.to(q.dtype)


@pytest.mark.parametrize("case", ["plain", "wgmma-dq"])
def test_kernel_tolerances_hold_the_plain_version_and_catch_a_fault(case):
    """The bound holds the plain version against itself recomputed in
    another order (fp32 scores from bf16 inputs) and is not so loose
    that a one-ulp-per-element fault in bf16 passes everywhere.  Case
    "wgmma-dq" (block 128): the wgmma dQ's order emulated — ds rounded to
    bf16, dQ summed 64 keys at a time in table order — stays inside the
    dq bound, and the same fault on it is caught."""
    blk, seq = (16, 128) if case == "plain" else (128, 1024)
    layout = _fixed("bigbird", blk=blk, seq=seq, heads=2)
    ft, rt, order = tfs.device_tables(layout, "cpu")
    g = torch.Generator().manual_seed(0)
    a = [torch.randn(4, seq, 64, generator=g).to(torch.bfloat16)
         for _ in range(4)]
    opts = dict(causal=True, scale=0.125, block=blk, rate=0.2, seed=9,
                n_heads=2)
    out, lse = tfs._fwd_plain(*a[:3], ft, **opts)
    delta = (a[3].float() * out.float()).sum(-1)
    dq = tfs._dq_plain(*a, lse, delta, ft, **opts)
    dk, dv = tfs._dkv_plain(*a, lse, delta, rt, order=order, **opts)
    ref = dict(out=out, dq=dq, dk=dk, dv=dv)
    tols = fsk.kernel_tolerances(*a, layout, ref, **opts)
    for name, t in tols.items():
        assert t.shape == ref[name].shape and (t > 0).all()
    got = dict(ref)
    if case == "wgmma-dq":
        got = {"dq": _emulated_wgmma_dq(*a, lse, delta, ft, **opts)}
        diff = (got["dq"].float() - dq.float()).abs()
        assert (diff > 0).any() and (diff <= tols["dq"]).all()
    # a fault of four ulps on every element is caught in each output
    for name, r in got.items():
        bad = r.float() * (1 + 4 * 2.0 ** -7) + 1e-3
        assert ((bad - ref[name].float()).abs() > tols[name]).any(), name


# -- the gather path: block_sparse_attention ---------------------------------

GATHER_CASES = ["plain", "causal", "key-padding", "rpe-attn-mask",
                "dropout", "causal-key-padding-dropout"]


def _gather_both(jx, case, grad=False):
    jnp = jx.jnp
    layout = _fixed("bigbird" if "causal" in case else "fixed")
    q, k, v, g = _qkv(seed=GATHER_CASES.index(case) + 20)
    rs = np.random.RandomState(5)
    kw_j, kw_t = {}, {}
    if "causal" in case:
        kw_j["causal_token_mask"] = kw_t["causal_token_mask"] = True
    if "key-padding" in case:
        kpb = np.where(rs.rand(B, S) < 0.2, -1e30, 0.0).astype(np.float32)
        kpb[-1, 40:] = -1e30
        kw_j["key_padding_bias"] = jnp.asarray(kpb)
        kw_t["key_padding_bias"] = torch.from_numpy(kpb)
    if "rpe" in case:
        ab = (rs.randn(H, S, S) * 0.5).astype(np.float32)
        kw_j["attn_bias"] = jnp.asarray(ab)
        kw_t["attn_bias"] = torch.from_numpy(ab)
    if "dropout" in case:
        key = jx.jax.random.PRNGKey(61)
        kw_j.update(dropout_rate=0.3, dropout_rng=key)
        kw_t.update(dropout_rate=0.3, dropout_seed=_seed(jx, 0.3, 61))

    def jf(q, k, v):
        o = jx.sp.block_sparse_attention(q, k, v, layout, BLK, **kw_j)
        return jnp.sum(o * g), o

    targs = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    tout = tsp.block_sparse_attention(*targs, layout, BLK, **kw_t)
    if not grad:
        return np.asarray(jf(*map(jnp.asarray, (q, k, v)))[1]), \
            tout.detach().numpy(), None
    (_, jout), jg = jx.jax.value_and_grad(jf, argnums=(0, 1, 2),
                                          has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    (tout * torch.from_numpy(g)).sum().backward()
    return np.asarray(jout), tout.detach().numpy(), [
        (np.asarray(a), b.grad.numpy()) for a, b in zip(jg, targs)]


@pytest.mark.parametrize("case", GATHER_CASES)
def test_block_sparse_attention_matches_jax(jx, case):
    jo, to, _ = _gather_both(jx, case)
    np.testing.assert_allclose(to, jo, atol=2e-5, rtol=2e-4)
    if "key-padding" in case:
        assert np.isfinite(to).all()


@pytest.mark.parametrize("case", ["rpe-attn-mask",
                                  "causal-key-padding-dropout"])
def test_block_sparse_attention_gradients_match_jax(jx, case):
    _, _, grads = _gather_both(jx, case, grad=True)
    for (a, b), n in zip(grads, "qkv"):
        np.testing.assert_allclose(b, a, atol=5e-5, rtol=5e-4,
                                   err_msg=f"d{n}")


def test_gather_path_matches_kernel_walk_at_dropout_0():
    """The two functions agree where they compute the same function: no
    bias, no dropout (fp32 order only)."""
    q, k, v, _ = (torch.from_numpy(t) for t in _qkv(seed=8))
    for kind, causal in (("fixed", False), ("bigbird", True),
                         ("empty-row", False)):
        layout = _fixed(kind)
        a = tsp.block_sparse_attention(q, k, v, layout, BLK,
                                       causal_token_mask=causal)
        b = tfs.flash_sparse_attention(q, k, v, layout, BLK, causal=causal)
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-4)


# -- SparseSelfAttention routing -----------------------------------------------


def _module_inputs(seed=9):
    return [torch.from_numpy(t) for t in _qkv(seed=seed)[:3]]


def _calls(snap, name):
    return COUNTERS.delta_since(snap).get(name, {"calls": 0})["calls"]


def test_routing_on_cpu_auto_gathers_pallas_walks():
    """With dropout on, the two paths compute different functions, so the
    output shows which one ran: "auto" on a CPU tensor takes the gather
    path (one kernel.fallbacks), "pallas" the kernel walk (the forward's
    plain version, one more fallback from the registry), bitwise equal to
    the direct calls."""
    cfg = tsa.FixedSparsityConfig(num_heads=H, block=BLK, num_local_blocks=2)
    layout = cfg.make_layout(S)
    q, k, v = _module_inputs()
    kw = dict(dropout_rate=0.4, dropout_seed=77)
    gather = tsp.block_sparse_attention(q, k, v, layout, BLK, **kw)
    walk = tfs.flash_sparse_attention(q, k, v, layout, BLK, **kw)
    assert not torch.allclose(gather, walk)
    for impl, want in (("auto", gather), ("xla", gather), ("jnp", gather),
                       ("pallas", walk)):
        snap = COUNTERS.snapshot()
        got = tsa.SparseSelfAttention(cfg, impl=impl)(q, k, v, **kw)
        assert torch.equal(got, want), impl
        assert _calls(snap, "kernel.fallbacks") == 1, impl
        assert _calls(snap, "kernel.dispatches") == 0, impl


def test_routing_biased_calls_take_the_gather_path_even_forced():
    cfg = tsa.FixedSparsityConfig(num_heads=H, block=BLK, num_local_blocks=2)
    layout = cfg.make_layout(S)
    q, k, v = _module_inputs()
    keep = torch.ones(B, S)
    keep[:, -16:] = 0
    want = tsp.block_sparse_attention(q, k, v, layout, BLK,
                                      key_padding_bias=(1 - keep) * -1e30)
    for impl in ("pallas", "auto"):
        mod = tsa.SparseSelfAttention(cfg, key_padding_mask_mode="mul",
                                      impl=impl)
        assert torch.equal(mod(q, k, v, key_padding_mask=keep), want)
    rpe = torch.randn(H, S, S)
    want = tsp.block_sparse_attention(q, k, v, layout, BLK, attn_bias=rpe)
    got = tsa.SparseSelfAttention(cfg, impl="pallas")(q, k, v, rpe=rpe)
    assert torch.equal(got, want)


def test_kernel_config_override_forces_an_auto_module():
    cfg = tsa.FixedSparsityConfig(num_heads=H, block=BLK, num_local_blocks=2)
    layout = cfg.make_layout(S)
    q, k, v = _module_inputs()
    kw = dict(dropout_rate=0.4, dropout_seed=5)
    walk = tfs.flash_sparse_attention(q, k, v, layout, BLK, **kw)
    gather = tsp.block_sparse_attention(q, k, v, layout, BLK, **kw)
    mod = tsa.SparseSelfAttention(cfg)
    with registry.kernel_config(ops={"sparse_attention": "pallas"}):
        assert registry.op_impl("sparse_attention") == "pallas"
        assert torch.equal(mod(q, k, v, **kw), walk)
        # an explicit module impl wins over the scope, as in JAX
        assert torch.equal(tsa.SparseSelfAttention(cfg, impl="xla")(
            q, k, v, **kw), gather)
        with registry.kernel_config(ops={"sparse_attention": "jnp"}):
            assert torch.equal(mod(q, k, v, **kw), gather)
        assert torch.equal(mod(q, k, v, **kw), walk)
    assert registry.op_impl("sparse_attention") == "auto"
    assert torch.equal(mod(q, k, v, **kw), gather)
    with pytest.raises(ValueError, match="impl must be"):
        with registry.kernel_config(ops={"sparse_attention": "cuda"}):
            pass
    with pytest.raises(ValueError, match="no module-level selection"):
        with registry.kernel_config(ops={"flash_attention": "pallas"}):
            pass
    with pytest.raises(ValueError, match="impl must be"):
        tsa.SparseSelfAttention(cfg, impl="triton")


def test_auto_supports_is_jax_rule(jx):
    import importlib

    jreg = importlib.import_module("deepspeed_tpu.kernels.registry")
    op = jreg.get_kernel("sparse_attention")
    for plain in (True, False):
        for block in (16, 64, 128, 256):
            for hd in (16, 64, 128, 256):
                info = {"plain": plain, "block": block, "head_dim": hd}
                assert tsp.auto_supports(plain, block, hd)[0] == \
                    op.auto_supports("default", info)[0], info


def test_random_layout_is_drawn_once_and_tables_upload_once():
    """A BigBird module draws its layout on its first call at a length and
    keeps it (and its device tables) whatever `random` does later."""
    cfg = tsa.BigBirdSparsityConfig(num_heads=H, block=BLK,
                                    num_random_blocks=2)
    mod = tsa.SparseSelfAttention(cfg, impl="pallas")
    q, k, v = _module_inputs()
    random.seed(1)
    first = mod(q, k, v)
    layout = mod.get_layout(S)
    tables = mod.get_tables(S, "cpu")
    random.seed(2)
    assert torch.equal(mod(q, k, v), first)
    assert mod.get_layout(S) is layout and mod.get_tables(S, "cpu") is tables
    random.seed(2)
    assert not np.array_equal(cfg.make_layout(S), layout)


def test_pallas_walk_counts_three_plain_ops_through_backward():
    cfg = tsa.FixedSparsityConfig(num_heads=H, block=BLK, num_local_blocks=2)
    q, k, v = (t.requires_grad_() for t in _module_inputs())
    snap = COUNTERS.snapshot()
    tsa.SparseSelfAttention(cfg, impl="pallas")(q, k, v).sum().backward()
    assert _calls(snap, "kernel.fallbacks") == 3
    assert q.grad is not None and k.grad is not None and v.grad is not None


# -- BertSparseSelfAttention and the utilities -----------------------------------


def test_bert_sparse_self_attention_matches_jax(jx):
    jax, jnp = jx.jax, jx.jnp
    hidden, heads = 64, 2
    cfg_kw = dict(num_heads=heads, block=BLK, num_local_blocks=2)
    jmod = jx.pkg.BertSparseSelfAttention(
        heads, hidden, jx.pkg.FixedSparsityConfig(**cfg_kw))
    params = jax.tree_util.tree_map(np.asarray,
                                    jmod.init(jax.random.PRNGKey(0)))
    tmod = tsa.BertSparseSelfAttention(
        heads, hidden, tsa.FixedSparsityConfig(**cfg_kw), device="cpu")
    from deepspeed_tpu_torch.models import load_jax_params

    load_jax_params(tmod, params)
    x = np.random.RandomState(3).randn(B, S, hidden).astype(np.float32)
    keep = np.ones((B, S), np.float32)
    keep[1, 100:] = 0
    for mask in (None, keep):
        want = np.asarray(jmod(jax.tree_util.tree_map(jnp.asarray, params),
                               jnp.asarray(x),
                               None if mask is None else jnp.asarray(mask)))
        got = tmod(torch.from_numpy(x),
                   None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5,
                                   rtol=2e-4)
    with pytest.raises(ValueError, match="multiple of heads"):
        tsa.BertSparseSelfAttention(3, 64, device="cpu")


def test_sparse_attention_utils_match_jax(jx):
    jnp = jx.jnp
    JU, TU = jx.pkg.SparseAttentionUtils, tsa.SparseAttentionUtils
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 50, (2, 37))
    mask = np.ones((2, 37), np.int64)
    emb = rs.randn(2, 37, 8).astype(np.float32)
    table = rs.randn(50, 8).astype(np.float32)
    for model_embeddings in (None, table):
        jout = JU.pad_to_block_size(
            16, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(ids),
            None, jnp.asarray(emb), pad_token_id=3,
            model_embeddings=model_embeddings)
        tout = TU.pad_to_block_size(
            16, torch.from_numpy(ids), torch.from_numpy(mask),
            torch.from_numpy(ids), None, torch.from_numpy(emb),
            pad_token_id=3, model_embeddings=model_embeddings)
        assert jout[0] == tout[0] == 11
        for a, b in zip(jout[1:], tout[1:]):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        seq = torch.from_numpy(emb)
        padded = tout[5]
        assert torch.equal(TU.unpad_sequence_output(tout[0], padded), seq)
    none_pad = TU.pad_to_block_size(16, torch.zeros(2, 32, dtype=torch.long))
    assert none_pad[0] == 0 and none_pad[1].shape == (2, 32)
    pe = rs.randn(20, 8).astype(np.float32)
    for n in (12, 20, 47):
        np.testing.assert_array_equal(
            TU.extend_position_embedding(torch.from_numpy(pe), n).numpy(),
            np.asarray(JU.extend_position_embedding(jnp.asarray(pe), n)))
    tok = types.SimpleNamespace(model_max_length=512, init_kwargs={})
    assert TU.update_tokenizer_model_max_length(tok, 4096) is tok
    assert tok.model_max_length == 4096
    assert tok.init_kwargs["model_max_length"] == 4096
    conf = types.SimpleNamespace(sparsity_config=None)
    sc = tsa.FixedSparsityConfig(num_heads=2)
    assert TU.replace_model_self_attention_with_sparse_self_attention(
        conf, sc).sparsity_config is sc


# -- the kernels on the card ------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the sparse flash kernels "
                    "run only on the card; on the card: python -m pytest "
                    "--noconftest -m cuda "
                    "tests/test_torch_sparse_attention.py)")
    return torch.device("cuda")


# name: (B, S, H, D, block, layout kind, causal, rate)
KERNEL_CASES = {
    "fixed128-bidirectional": (2, 512, 2, 64, 128, "fixed", False, 0.0),
    "bigbird64-dropout": (2, 512, 2, 64, 64, "bigbird", False, 0.2),
    "fixed16-causal-d128-dropout": (2, 256, 2, 128, 16, "fixed", True, 0.2),
    "empty-row-32": (1, 256, 2, 64, 32, "empty-row", False, 0.0),
    "fixed256-dropout": (1, 1024, 2, 64, 256, "fixed", False, 0.1),
    "fixed192-causal": (1, 768, 2, 64, 192, "fixed", True, 0.0),
    "fixed160-dropout": (1, 640, 2, 64, 160, "fixed", False, 0.2),
    "fixed128-d256-causal-dropout": (1, 512, 2, 256, 128, "fixed", True, 0.1),
}


def _kernel_layout(kind, blk, seq, heads):
    if kind == "fixed":
        return np.asarray(tsa.FixedSparsityConfig(
            num_heads=heads, block=blk, num_local_blocks=4).make_layout(seq))
    if kind == "bigbird":
        random.seed(0)
        return np.asarray(tsa.BigBirdSparsityConfig(
            num_heads=heads, block=blk, different_layout_per_head=True,
            num_random_blocks=1).make_layout(seq))
    return _fixed("empty-row", blk=blk, seq=seq, heads=heads)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_cuda_kernels_match_plain_versions(cuda_device, case, dtype):
    Bc, Sc, Hc, Dc, blk, kind, causal, rate = KERNEL_CASES[case]
    layout = _kernel_layout(kind, blk, Sc, Hc)
    ft, rt, order = tfs.device_tables(layout, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a = [torch.randn(Bc * Hc, Sc, Dc, device=cuda_device, generator=g)
         .to(dtype) for _ in range(4)]
    opts = dict(causal=causal, scale=Dc ** -0.5, block=blk, rate=rate,
                seed=1234, n_heads=Hc)
    res = {}
    for impl in ("torch", "cuda"):
        out, lse = registry.dispatch("flash_sparse_fwd", *a[:3], ft,
                                     impl=impl, **opts)
        if impl == "torch":
            ref_lse = lse
            delta = (a[3].float() * out.float()).sum(-1)
        dq = registry.dispatch("flash_sparse_dq", *a, ref_lse, delta, ft,
                               impl=impl, **opts)
        dk, dv = registry.dispatch("flash_sparse_dkv", *a, ref_lse, delta,
                                   rt, order=order, impl=impl, **opts)
        res[impl] = dict(out=out, dq=dq, dk=dk, dv=dv, lse=lse)
    torch.cuda.synchronize()
    wgmma = dtype != torch.float32 and Dc in (64, 128) and blk % 64 == 0
    for route in (fsk.fwd_route, fsk.dq_route):
        assert route(a[0], blk) == (
            "wgmma" if wgmma else
            "cuda-cores" if dtype == torch.float32 else "mma.sync")
    tols = fsk.kernel_tolerances(*a, layout, res["torch"], **opts)
    for name, tol in tols.items():
        diff = (res["cuda"][name].float() - res["torch"][name].float()).abs()
        assert (diff <= tol).all(), (name, (diff / tol).max().item())
    lse_err = (res["cuda"]["lse"] - res["torch"]["lse"]).abs()
    assert (lse_err <= 1e-5 * (1 + res["torch"]["lse"].abs())).all()


@pytest.mark.cuda
def test_cuda_sparse_dq_and_dkv_are_bitwise_repeatable(cuda_device):
    layout = _kernel_layout("fixed", 16, 256, 2)
    ft, rt, order = tfs.device_tables(layout, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    a = [torch.randn(4, 256, 128, device=cuda_device, generator=g)
         .half() for _ in range(4)]
    opts = dict(causal=True, scale=128 ** -0.5, block=16, rate=0.2,
                seed=99, n_heads=2)
    out, lse = registry.dispatch("flash_sparse_fwd", *a[:3], ft,
                                 impl="cuda", **opts)
    delta = (a[3].float() * out.float()).sum(-1)
    first = [registry.dispatch("flash_sparse_dq", *a, lse, delta, ft,
                               impl="cuda", **opts),
             *registry.dispatch("flash_sparse_dkv", *a, lse, delta, rt,
                                order=order, impl="cuda", **opts)]
    for _ in range(5):
        registry.dispatch("flash_sparse_fwd", *a[:3], ft, impl="cuda", **opts)
        again = [registry.dispatch("flash_sparse_dq", *a, lse, delta, ft,
                                   impl="cuda", **opts),
                 *registry.dispatch("flash_sparse_dkv", *a, lse, delta, rt,
                                    order=order, impl="cuda", **opts)]
        for x, y in zip(first, again):
            assert torch.equal(x, y)


def _wgmma_inputs(device, blk, D=64, dtype=torch.bfloat16, causal=False,
                  S=2048, Hc=4, Bc=2, rate=0.1, seed=0):
    """Inputs under the fixed layout (a global column) at block `blk`: the
    wgmma dQ's and dK/dV's case (dK/dV: bf16, Dh 64)."""
    layout = _kernel_layout("fixed", blk, S, Hc)
    tables = tfs.device_tables(layout, device)
    g = torch.Generator(device=device).manual_seed(seed)
    a = [torch.randn(Bc * Hc, S, D, device=device, generator=g).to(dtype)
         for _ in range(4)]
    opts = dict(causal=causal, scale=D ** -0.5, block=blk, rate=rate,
                seed=77, n_heads=Hc)
    out, lse = registry.dispatch("flash_sparse_fwd", *a[:3], tables[0],
                                 impl="torch", **opts)
    delta = (a[3].float() * out.float()).sum(-1)
    return layout, tables, a, out, lse, delta, opts


# name: (kernel, block, head_dim, dtype, causal), all with dropout 0.1
WGMMA_CASES = {
    "dkv-block128": ("dkv", 128, 64, torch.bfloat16, False),
    "dkv-block256": ("dkv", 256, 64, torch.bfloat16, False),
    "dq-block128": ("dq", 128, 64, torch.bfloat16, False),
    "dq-block256-causal": ("dq", 256, 64, torch.bfloat16, True),
    "dq-block128-float16": ("dq", 128, 64, torch.float16, False),
    "dq-block128-dh128-float16-causal": ("dq", 128, 128, torch.float16,
                                         True),
    "dq-block256-dh128": ("dq", 256, 128, torch.bfloat16, False),
}


def _wgmma_call(kernel, a, lse, delta, tables, opts, impl):
    ft, rt, order = tables
    if kernel == "dq":
        return [registry.dispatch("flash_sparse_dq", *a, lse, delta, ft,
                                  impl=impl, **opts)]
    return list(registry.dispatch("flash_sparse_dkv", *a, lse, delta, rt,
                                  order=order, impl=impl, **opts))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WGMMA_CASES))
def test_cuda_wgmma_dkv_with_dropout_within_its_bound(cuda_device, case):
    """#8's and #9's wgmma kernels (dropout 0.1; dQ in bf16 and fp16, Dh 64
    and 128, causal or not; dK/dV bf16 Dh 64) at block 128 and 256 against
    their plain versions within `kernel_tolerances`, one launch a call;
    with a work order of the wrong length the dK/dV wrapper refuses."""
    kernel, blk, D, dtype, causal = WGMMA_CASES[case]
    layout, tables, a, out, lse, delta, opts = _wgmma_inputs(
        cuda_device, blk, D, dtype, causal)
    if kernel == "dq":
        assert fsk.dq_route(a[0], blk) == "wgmma"
    ref = _wgmma_call(kernel, a, lse, delta, tables, opts, "torch")
    name = f"flash_sparse_{kernel}"
    n0 = fsk.LAUNCHES[name]
    got = _wgmma_call(kernel, a, lse, delta, tables, opts, "cuda")
    torch.cuda.synchronize()
    assert fsk.LAUNCHES[name] == n0 + 1
    if kernel == "dkv":
        ft, rt, order = tables
        with pytest.raises(ValueError, match="work order"):
            registry.dispatch("flash_sparse_dkv", *a, lse, delta, rt,
                              order=order[1:], impl="cuda", **opts)
    outs = ("dq",) if kernel == "dq" else ("dk", "dv")
    refs = dict(out=out, dq=ref[0], dk=ref[0], dv=ref[-1])
    tols = fsk.kernel_tolerances(*a, layout, refs, **opts)
    for name, x, r in zip(outs, got, ref):
        diff = (x.float() - r.float()).abs()
        assert (diff <= tols[name]).all(), (name,
                                            (diff / tols[name]).max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_cuda_wgmma_dkv_is_bitwise_repeatable(cuda_device, kernel):
    """The persistent grids hand items out in a fixed order and every
    output element is summed by one warp: dQ and dK/dV equal bit for bit
    over repeats, with other kernels run in between."""
    _, tables, a, _, lse, delta, opts = _wgmma_inputs(
        cuda_device, 128, causal=kernel == "dq", seed=3)
    first = _wgmma_call(kernel, a, lse, delta, tables, opts, "cuda")
    for _ in range(5):
        registry.dispatch("flash_sparse_fwd", *a[:3], tables[0], impl="cuda",
                          **opts)
        for x, y in zip(first, _wgmma_call(kernel, a, lse, delta, tables,
                                           opts, "cuda")):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_module_walk_launches_each_kernel_once(cuda_device):
    cfg = tsa.FixedSparsityConfig(num_heads=2, block=128, num_local_blocks=2)
    t = [torch.randn(2, 512, 2, 64, device=cuda_device).to(torch.bfloat16)
         .requires_grad_() for _ in range(3)]
    n0 = dict(fsk.LAUNCHES)
    tsa.SparseSelfAttention(cfg)(*t).float().sum().backward()
    torch.cuda.synchronize()
    assert {k: fsk.LAUNCHES[k] - n0[k] for k in n0} == \
        {"flash_sparse_fwd": 1, "flash_sparse_dq": 1, "flash_sparse_dkv": 1}


# name: (B, S, H, head_dim, block, layout kind, dtype, causal, dropout):
# the wgmma forward at both head dims, blocks 64 (one 64-row tile an
# item), 128 and 256 (two tiles sharing each key tile), causal with
# dropout, a layout with an empty row and an empty column, and
# train-bert-sparse's shape
WGMMA_FWD_CASES = {
    "block64-dh64-causal-dropout": (2, 1024, 4, 64, 64, "fixed",
                                    torch.bfloat16, True, 0.1),
    "block64-dh128-float16-causal-dropout": (2, 1024, 4, 128, 64, "fixed",
                                             torch.float16, True, 0.1),
    "block128-dh64-dropout": (2, 2048, 4, 64, 128, "fixed", torch.bfloat16,
                              False, 0.1),
    "block128-dh128-causal-dropout": (2, 1024, 4, 128, 128, "fixed",
                                      torch.bfloat16, True, 0.1),
    "block256-dh64-float16": (2, 2048, 4, 64, 256, "fixed", torch.float16,
                              False, 0.0),
    "block256-dh128-causal-dropout": (2, 2048, 4, 128, 256, "fixed",
                                      torch.bfloat16, True, 0.2),
    "empty-row-block64-causal-dropout": (2, 1024, 4, 64, 64, "empty",
                                         torch.bfloat16, True, 0.1),
    "empty-row-block128-dh128-dropout": (2, 1024, 4, 128, 128, "empty",
                                         torch.float16, False, 0.1),
    "train-dropout": (2, 4096, 16, 64, 128, "fixed", torch.bfloat16, False,
                      0.1),
}


def _fwd_inputs(device, case, seed=0):
    Bc, Sc, Hc, Dc, blk, kind, dtype, causal, rate = WGMMA_FWD_CASES[case]
    layout = _kernel_layout("fixed", blk, Sc, Hc).copy()
    if kind == "empty":
        layout[:, 5, :] = 0           # q-block 5 attends nothing
        layout[1, :, 3] = 0           # head 1: no q-block reads k-block 3
    ft = tfs.device_tables(layout, device)[0]
    g = torch.Generator(device=device).manual_seed(seed)
    a = [torch.randn(Bc * Hc, Sc, Dc, device=device, generator=g).to(dtype)
         for _ in range(4)]
    opts = dict(causal=causal, scale=Dc ** -0.5, block=blk, rate=rate,
                seed=1234, n_heads=Hc)
    return layout, ft, a, opts


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WGMMA_FWD_CASES))
def test_cuda_wgmma_fwd_within_its_bound(cuda_device, case):
    """#7's wgmma kernel against its plain version: out within
    `kernel_tolerances`, lse within 1e-5 (1 + |lse|), one launch a call;
    an empty table row gives zeros and lse NEG_INF on both sides."""
    layout, ft, a, opts = _fwd_inputs(cuda_device, case)
    assert fsk.fwd_route(a[0], opts["block"]) == "wgmma"
    out, lse = registry.dispatch("flash_sparse_fwd", *a[:3], ft,
                                 impl="torch", **opts)
    n0 = fsk.LAUNCHES["flash_sparse_fwd"]
    got, got_lse = registry.dispatch("flash_sparse_fwd", *a[:3], ft,
                                     impl="cuda", **opts)
    torch.cuda.synchronize()
    assert fsk.LAUNCHES["flash_sparse_fwd"] == n0 + 1
    tol = fsk.kernel_tolerances(*a, layout, {"out": out, "dq": out,
                                             "dk": out, "dv": out},
                                **opts)["out"]
    diff = (got.float() - out.float()).abs()
    assert bool((diff <= tol).all()), float((diff / tol).max())
    assert bool(((got_lse - lse).abs() <= 1e-5 * (1 + lse.abs())).all())
    if WGMMA_FWD_CASES[case][5] == "empty":
        rows = slice(5 * opts["block"], 6 * opts["block"])
        assert bool((got[:, rows] == 0).all())
        assert bool((got_lse[:, rows] == -1e30).all())


@pytest.mark.cuda
def test_cuda_wgmma_fwd_is_bitwise_repeatable(cuda_device):
    """The wgmma forward 50 times after other kernels (causal, dropout,
    block 128): out and lse equal bit for bit."""
    _, ft, a, opts = _fwd_inputs(cuda_device, "block128-dh128-causal-dropout",
                                 seed=3)
    first = registry.dispatch("flash_sparse_fwd", *a[:3], ft, impl="cuda",
                              **opts)
    for _ in range(50):
        torch.randn(1 << 20, device=cuda_device).sum()   # other kernels
        again = registry.dispatch("flash_sparse_fwd", *a[:3], ft,
                                  impl="cuda", **opts)
        for x, y in zip(first, again):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_wgmma_fwd_launches_from_a_fresh_thread(cuda_device):
    """The forward's tensor maps encoded on a thread that has made no CUDA
    call yet: the launch binds a context first, and the result equals the
    main thread's."""
    import threading

    _, ft, a, opts = _fwd_inputs(cuda_device, "block64-dh64-causal-dropout")
    call = lambda: registry.dispatch("flash_sparse_fwd", *a[:3], ft,
                                     impl="cuda", **opts)
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
    for x, y in zip(got["out"], call()):
        assert torch.equal(x, y)

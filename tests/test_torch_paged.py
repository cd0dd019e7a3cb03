"""Port parity: paged attention (deepspeed_tpu_torch/kernels/paged.py)
against the JAX package's plain version and its Pallas kernel.

The same numpy inputs go to both packages.  Tolerances:

* fp32 cache: atol 1e-5 — both sides compute fp32 scores, softmax and
  PV; they differ only in the order of fp32 sums (a few ulp of outputs
  of size ~1).
* bf16 cache: atol 2e-2 — both sides round probs to bf16 and return a
  bf16 output, so the bound is a few bf16 ulps (2^-8 relative) of
  outputs of size up to ~2.
* the CUDA kernel against the plain version, bf16: the per-element
  bound of `paged.bf16_tolerance` (the kernel keeps its probabilities in
  fp32, or as two bf16 terms on the tensor cores), itself checked on the
  CPU against emulations of both routes.

The CUDA kernel itself runs only on a card; its comparison against the
plain version is the `cuda`-marked test at the end (skipped here).  JAX
is imported inside the tests that compare with it, so that on a GPU
machine without JAX the `cuda` tests run alone:
`python -m pytest --noconftest -m cuda tests/test_torch_paged.py`."""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepspeed_tpu_torch.kernels import paged, registry  # noqa: E402
from deepspeed_tpu_torch.monitor.counters import COUNTERS  # noqa: E402
from deepspeed_tpu_torch.serving.kv_cache import \
    rows_for_tables  # noqa: E402

torch.set_num_threads(1)


def _inputs(T, Dh, R=2, H=2, bs=4, W=4, seed=0):
    """Random cache, scattered tables with repeats and the trash block,
    q positions anywhere in the table (numpy, shared by both sides)."""
    rng = np.random.RandomState(seed)
    nblocks = R * W + 1
    ck = rng.randn(nblocks * bs, H, Dh).astype(np.float32)
    cv = rng.randn(nblocks * bs, H, Dh).astype(np.float32)
    tables = rng.randint(0, nblocks, (R, W)).astype(np.int32)
    tables[0, 0] = 0                    # the trash block
    tables[0, 2] = tables[0, 1]         # a repeated block
    q = rng.randn(R, T, H, Dh).astype(np.float32)
    q_pos = rng.randint(0, W * bs, (R, T)).astype(np.int32)
    return q, ck, cv, tables, q_pos, bs


def _port(q, ck, cv, tables, q_pos, bs, dtype=torch.float32, impl="torch"):
    t = lambda a, dt=dtype: torch.from_numpy(a).to(dt)
    rows = rows_for_tables(torch.from_numpy(tables).long(), bs)
    out = registry.dispatch("paged_attention", t(q), t(ck), t(cv), rows,
                            torch.from_numpy(q_pos).long(), impl=impl,
                            block_size=bs)
    return out.float().numpy()


@pytest.fixture
def jax_side():
    """The JAX package's paged attention: (jnp, its registry, its plain
    version, its rows_for_tables)."""
    jnp = pytest.importorskip("jax.numpy")
    from deepspeed_tpu.kernels import registry as jax_registry
    from deepspeed_tpu.kernels.paged import paged_attention_reference
    from deepspeed_tpu.serving.kv_cache import rows_for_tables as jax_rows

    return jnp, jax_registry, paged_attention_reference, jax_rows


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("T", [1, 3, 16])
def test_paged_reference_matches_jax_fp32(jax_side, T, Dh):
    jnp, _, jax_reference, jax_rows = jax_side
    q, ck, cv, tables, q_pos, bs = _inputs(T, Dh)
    want = jax_reference(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                         jax_rows(jnp.asarray(tables), bs),
                         jnp.asarray(q_pos), block_size=bs)
    got = _port(q, ck, cv, tables, q_pos, bs)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("T", [1, 3, 16])
def test_paged_reference_matches_jax_pallas_kernel(jax_side, T, Dh):
    """The TPU kernel itself, run as the JAX package's tests run it on
    the CPU (the Pallas interpreter)."""
    jnp, jax_registry, _, jax_rows = jax_side
    q, ck, cv, tables, q_pos, bs = _inputs(T, Dh, seed=1)
    with jax_registry.kernel_config(interpret=True):
        want = jax_registry.dispatch(
            "paged_attention", jnp.asarray(q), jnp.asarray(ck),
            jnp.asarray(cv), jax_rows(jnp.asarray(tables), bs),
            jnp.asarray(q_pos), impl="pallas", kv_mode="dense",
            block_size=bs)
    got = _port(q, ck, cv, tables, q_pos, bs)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def test_paged_reference_matches_jax_bf16_cache(jax_side):
    jnp, _, jax_reference, jax_rows = jax_side
    q, ck, cv, tables, q_pos, bs = _inputs(3, 64, seed=2)
    b = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = jax_reference(b(q), b(ck), b(cv),
                         jax_rows(jnp.asarray(tables), bs),
                         jnp.asarray(q_pos), block_size=bs)
    assert want.dtype == jnp.bfloat16
    got = _port(q, ck, cv, tables, q_pos, bs, dtype=torch.bfloat16)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=2e-2, rtol=0)


def test_kernel_wrapper_rejects_ragged_rows():
    q, ck, cv, tables, q_pos, bs = _inputs(1, 64)
    rows = rows_for_tables(torch.from_numpy(tables).long(), bs)
    with pytest.raises(ValueError, match="whole cache blocks"):
        paged.paged_attention_cuda(
            torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
            rows[:, :-1], torch.from_numpy(q_pos), block_size=bs)


def test_forced_cuda_on_cpu_tensors_raises():
    q, ck, cv, tables, q_pos, bs = _inputs(1, 64)
    with pytest.raises(RuntimeError, match="impl='cuda'"):
        _port(q, ck, cv, tables, q_pos, bs, impl="cuda")


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches or raises: a CPU tensor that reaches it
    directly is refused, never computed some other way."""
    q, ck, cv, tables, q_pos, bs = _inputs(1, 64)
    rows = rows_for_tables(torch.from_numpy(tables).long(), bs)
    with pytest.raises(ValueError, match="not a CUDA device"):
        paged.paged_attention_cuda(
            torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
            rows, torch.from_numpy(q_pos), block_size=bs)


def test_auto_on_cpu_runs_plain_version_and_counts_fallback():
    q, ck, cv, tables, q_pos, bs = _inputs(1, 64)
    launches = paged.LAUNCHES
    snap = COUNTERS.snapshot()
    auto = _port(q, ck, cv, tables, q_pos, bs, impl="auto")
    plain = _port(q, ck, cv, tables, q_pos, bs, impl="torch")
    d = COUNTERS.delta_since(snap)
    np.testing.assert_array_equal(auto, plain)
    assert d == {"kernel.fallbacks": {"calls": 2, "bytes": 0}}
    assert paged.LAUNCHES == launches
    with pytest.raises(ValueError, match="impl must be one of"):
        _port(q, ck, cv, tables, q_pos, bs, impl="pallas")


def test_quantized_kv_not_ported_yet():
    """The quantized branches are ported: kv_read gathers (payload,
    scales) rows and dequantizes them exactly as the row codec does, and
    an unknown mode is refused."""
    from deepspeed_tpu_torch.runtime.comm.quant import (dequantize_rows,
                                                        quantize_rows)

    q, ck, cv, tables, q_pos, bs = _inputs(1, 64)
    rows = rows_for_tables(torch.from_numpy(tables).long(), bs)
    for wire in ("int8", "int4"):
        pair = quantize_rows(torch.from_numpy(ck), wire)
        got = paged.kv_read(pair, rows, wire)
        want = dequantize_rows(pair[0], pair[1], wire)[rows]
        assert got.dtype == torch.float32 and got.shape == rows.shape + (2, 64)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="int2"):
        paged.kv_read(torch.from_numpy(ck), rows, "int2")


# (B, H, T, L, bs, route): GPT-2 XL decode, verify and prefill at the
# serving table width, one slot over a long cache, batches that fill the
# card without splits, one just short of that, GPT-2 nano's table, a block
# that does not divide 128
SPLIT_SHAPES = [(8, 25, 1, 1024, 16, "split-keys"),
                (5, 25, 1, 1024, 16, "split-keys"),
                (1, 2, 128, 65536, 16, "tensor-cores"),
                (8, 25, 5, 1024, 16, "split-keys"),
                (1, 25, 128, 1024, 16, "split-keys"),
                (1, 25, 128, 1024, 16, "tensor-cores"),
                (1, 25, 1, 4096, 16, "split-keys"),
                (256, 25, 1, 1024, 16, "split-keys"),
                (32, 25, 1, 1024, 16, "split-keys"),
                (4, 3, 1, 64, 8, "split-keys"),
                (2, 4, 1, 1000, 40, "split-keys")]


@pytest.mark.parametrize("B,H,T,L,bs,way", SPLIT_SHAPES)
def test_split_plan_covers_the_table_once_and_fills_the_card(B, H, T, L, bs,
                                                             way):
    """The key splits, a pure function of the shapes: ranges of whole
    multiples of 128 keys and of the block that cover [0, L) exactly once,
    in order, and a grid that reaches CTAS_PER_SM blocks on each of the
    132 SMs unless every range is already one unit of keys, or the
    merge's shared memory (MERGE_FACTORS per tile row) caps the count;
    one range at decode where the groups alone cover the SMs."""
    rows = paged.tile_rows(T, way)
    n, keys = paged.split_plan(B, H, T, L, bs, rows=rows)
    assert keys % paged.SPLIT_UNIT == 0 and keys % bs == 0
    ranges = [(s * keys, min(L, (s + 1) * keys)) for s in range(n)]
    assert ranges[0][0] == 0 and ranges[-1][1] == L
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(n - 1))
    groups = B * H * -(-T // rows)
    unit = paged.SPLIT_UNIT * bs // int(np.gcd(paged.SPLIT_UNIT, bs))
    cap = paged.MERGE_FACTORS // rows
    assert n <= cap
    if T == 1 and groups >= paged.SMS:
        assert n == 1
    elif cap < min(-(-L // unit), -(-paged.SMS * paged.CTAS_PER_SM // groups)):
        assert 2 * n > cap                  # capped by the merge's memory
    else:
        assert groups * n >= paged.SMS * paged.CTAS_PER_SM or \
            n == -(-L // unit)
    assert paged.split_plan(B, H, T, L, bs, rows=rows) == (n, keys)


def test_split_plan_at_the_serving_shapes():
    """GPT-2 XL decode (B 8, H 25, table 64 x 16): one range, its 200
    (slot, head) blocks already cover the SMs; 16 heads (Dh 128, 128
    blocks): eight ranges of 128 keys; the tensor-core prefill chunk
    (T 128, 64-row tiles): eight as well; one slot over 4096 keys: 32."""
    assert paged.split_plan(8, 25, 1, 1024, 16) == (1, 1024)
    assert paged.split_plan(8, 16, 1, 1024, 16) == (8, 128)
    assert paged.split_plan(1, 25, 128, 1024, 16,
                            rows=paged.TC_ROWS) == (8, 128)
    assert paged.split_plan(1, 25, 1, 4096, 16) == (32, 128)


def test_call_kind_names_decode_verify_and_prefill():
    """The launches are counted by kind from T alone: decode at T = 1,
    verify below the tensor cores' shortest chunk, prefill from it on."""
    assert [paged.call_kind(T) for T in (1, 2, 5, 15, 16, 128)] == [
        "decode", "verify", "verify", "verify", "prefill", "prefill"]


def test_route_takes_the_tensor_cores_only_where_they_apply():
    """Tensor cores for a dense bf16/fp16 cache, q in its dtype, T >= 16,
    Dh 64 or 128; the split-keys route for everything else."""
    def way(T, Dh, qdt, cdt, kv="dense"):
        q = torch.zeros(2, T, 3, Dh, dtype=qdt)
        return paged.route(q, torch.zeros(8, 3, Dh, dtype=cdt), kv)

    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    assert way(16, 64, bf, bf) == "tensor-cores"
    assert way(128, 128, f16, f16) == "tensor-cores"
    assert way(15, 64, bf, bf) == "split-keys"
    assert way(128, 64, f32, bf) == "split-keys"
    assert way(128, 64, f32, f32) == "split-keys"
    assert way(128, 256, bf, bf) == "split-keys"
    assert way(128, 64, bf, bf, kv="int8") == "split-keys"
    assert way(1, 64, bf, bf) == "split-keys"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit "
                    "(on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_paged.py)")
    return torch.device("cuda")


def _adversarial_prefill(dev, dtype=torch.bfloat16):
    """A prefill chunk (B 1, T 16, H 1, Dh 64, 128 keys, every row seeing
    all of them) whose bf16 roundings of the probabilities are set against
    each other: key 0 holds the max (v 0); 30 keys of score S_A (v +1) whose
    p rounds down against the running max and up once normalised; 33 of
    S_B (v -1) the other way; 64 fillers (v 0) set the sum.  The output is
    near 0 and P |V| near 1, so a kernel that rounds p once lands about
    1.7 u away from the reference, outside `bf16_tolerance`."""
    S_A, S_B, S_F = -1.8916016, -1.9790039, -2.1939251
    scores = torch.tensor([0.0] + [S_A] * 30 + [S_B] * 33 + [S_F] * 64)
    # a score as (a + b) / 8 with a, b bf16: exact in the q.k product
    a = (8 * scores).to(torch.bfloat16).float()
    b = (8 * scores - a).to(torch.bfloat16).float()
    ck = torch.zeros(9 * 16, 1, 64)
    cv = torch.zeros(9 * 16, 1, 64)
    ck[16:, 0, 0], ck[16:, 0, 1] = a, b
    cv[17:47, 0] = 1.0
    cv[47:80, 0] = -1.0
    q = torch.zeros(1, 16, 1, 64)
    q[..., :2] = 1.0
    rows = rows_for_tables(torch.arange(1, 9)[None], 16)
    q_pos = torch.full((1, 16), 127, dtype=torch.long)
    t = lambda x: x.to(dev, dtype)
    return t(q), t(ck), t(cv), rows.to(dev), q_pos.to(dev), 16


def test_bf16_tolerance_holds_split_probabilities_on_adversarial_values():
    """The tensor-core route's arithmetic emulated on the CPU over the
    adversarial chunk: p against the max, carried into P.V as hi + lo bf16
    terms of p * 2^15, fp32 sums, one rounding of the output — inside
    `bf16_tolerance`; p rounded once to bf16 instead is outside it."""
    q, ck, cv, rows, q_pos, bs = _adversarial_prefill("cpu")
    ref = paged.paged_attention_reference(q, ck, cv, rows, q_pos)
    tol = paged.bf16_tolerance(q, ck, cv, rows, q_pos, ref)
    keys, vals = ck[rows].float(), cv[rows].float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), keys) * 64 ** -0.5
    e = torch.exp(s - s.amax(-1, keepdim=True))
    l = e.sum(-1, keepdim=True)

    def out(p):
        return (torch.einsum("bhqk,bkhd->bqhd", p, vals) /
                l.permute(0, 2, 1, 3)).to(torch.bfloat16).float()

    hi = (e * 2 ** 15).to(torch.bfloat16).float()
    lo = (e * 2 ** 15 - hi).to(torch.bfloat16).float()
    split = out((hi + lo) * 2 ** -15)
    once = out(e.to(torch.bfloat16).float())
    assert float(((split - ref.float()).abs() / tol).max()) <= 1.0
    assert float(((once - ref.float()).abs() / tol).max()) > 1.0


def test_bf16_tolerance_holds_fp32_probabilities_and_catches_a_fault():
    """The bf16 bound of kernel vs plain version, checked on the CPU with
    the kernel's arithmetic emulated (fp32 probabilities into PV, one
    rounding of the output): the emulation stays inside it, and an output
    scaled by 1 + 2^-5 (a bf16-only fault of a few ulps) does not."""
    q, ck, cv, tables, q_pos, bs = _inputs(16, 64, R=3, H=4, bs=16, W=8)
    b = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    rows = rows_for_tables(torch.from_numpy(tables).long(), bs)
    qp = torch.from_numpy(q_pos).long()
    q_, ck_, cv_ = b(q), b(ck), b(cv)
    ref = paged.paged_attention_reference(q_, ck_, cv_, rows, qp)
    keys, vals = ck_[rows].float(), cv_[rows].float()
    s = torch.einsum("bqhd,bkhd->bhqk", q_.float(), keys) * 64 ** -0.5
    mask = qp[:, :, None] >= torch.arange(rows.shape[1])[None, None, :]
    p = torch.softmax(torch.where(mask[:, None], s, paged.NEG_INF), dim=-1)
    emulated = torch.einsum("bhqk,bkhd->bqhd", p, vals).to(torch.bfloat16)
    tol = paged.bf16_tolerance(q_, ck_, cv_, rows, qp, ref)
    diff = (emulated.float() - ref.float()).abs()
    assert bool((diff <= tol).all())
    faulty = (emulated.float() * (1 + 2 ** -5)).to(torch.bfloat16)
    assert not bool(((faulty.float() - ref.float()).abs() <= tol).all())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit "
                    "(on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_paged.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("q_layout", ["contiguous", "qkv_view", "fp32_q"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,Dh", [(1, 64), (16, 64), (3, 128), (1, 16),
                                  (16, 256)])
def test_cuda_kernel_matches_plain_version(cuda_device, T, Dh, dtype,
                                           q_layout):
    """Kernel vs plain version on the card, with q contiguous, as the
    strided view of a fused QKV output (the serving layout), or in fp32
    over a narrower cache.  fp32: atol 1e-5 (fp32 sums in another
    order).  bf16: `paged.bf16_tolerance` — the kernel keeps the
    probabilities in fp32 while the plain version rounds them to bf16
    before PV, and each side rounds its output once."""
    q, ck, cv, tables, q_pos, bs = _inputs(T, Dh, R=3, H=4, bs=16, W=8)
    t = lambda a: torch.from_numpy(a).to(cuda_device, dtype)
    rows = rows_for_tables(torch.from_numpy(tables).long().to(cuda_device),
                           bs)
    qp = torch.from_numpy(q_pos).to(cuda_device)
    if q_layout == "qkv_view":
        R, _, H, _ = q.shape
        qkv = torch.cat([t(q).reshape(R, T, H * Dh)] * 3, dim=-1)
        qd = qkv[..., :H * Dh].view(R, T, H, Dh)
        assert not qd.is_contiguous()
    elif q_layout == "fp32_q":
        qd = torch.from_numpy(q).to(cuda_device)
    else:
        qd = t(q)
    args = (qd, t(ck), t(cv), rows, qp)
    n = paged.LAUNCHES
    out = registry.dispatch("paged_attention", *args, block_size=bs)
    ref = registry.dispatch("paged_attention", *args, impl="torch",
                            block_size=bs)
    torch.cuda.synchronize()
    assert paged.LAUNCHES == n + 1
    diff = (out.float() - ref.float()).abs()
    tol = (torch.full_like(diff, 1e-5) if dtype == torch.float32 else
           paged.bf16_tolerance(*args, ref))
    assert bool((diff <= tol).all()), float((diff / tol).max())


# route cases on the card: (B, T, H, Dh, W, dtype, q positions of each slot's
# first row, the route); bs 16
ROUTE_CASES = {
    # several splits of a 1024-key table; slot 1 sees 4 keys (its later
    # splits are empty), slot 2 none (q_pos -1: the kernel leaves it 0)
    "split-decode-empty": (4, 1, 4, 64, 64, torch.bfloat16,
                           [700, 3, -1, 130], "split-keys"),
    "split-decode-fp32": (4, 1, 4, 128, 64, torch.float32,
                          [1023, 0, 511, 512], "split-keys"),
    "long-cache-b1": (1, 1, 4, 64, 256, torch.bfloat16, [4000],
                      "split-keys"),
    "verify-t5": (3, 5, 4, 128, 64, torch.bfloat16, [300, 17, 900],
                  "split-keys"),
    "dh1032-decode": (2, 1, 2, 1032, 16, torch.bfloat16, [100, 250],
                      "split-keys"),
    "dh2048-verify": (2, 5, 2, 2048, 16, torch.float32, [100, 250],
                      "split-keys"),
    **{f"tc-prefill-t{T}-{str(dt)[6:]}-dh{Dh}": (
        2, T, 4, Dh, 64, dt, [37, 533], "tensor-cores")
       for T in (16, 128) for dt in (torch.bfloat16, torch.float16)
       for Dh in (64, 128)},
}


def _route_inputs(B, T, H, Dh, W, dtype, starts, dev, seed=0):
    """Cache in `dtype`, scattered distinct tables, q as a QKV view, rows
    starting at `starts` (mid-block) and running on one a row (-1 stays
    -1: a slot with no live key)."""
    gen = torch.Generator().manual_seed(seed)
    bs, nb = 16, B * W + 1
    ck = torch.randn(nb * bs, H, Dh, generator=gen).to(dev, dtype)
    cv = torch.randn(nb * bs, H, Dh, generator=gen).to(dev, dtype)
    tables = (torch.randperm(nb - 1, generator=gen)[:B * W] + 1).view(B, W)
    rows = rows_for_tables(tables.to(dev), bs)
    st = torch.tensor(starts)[:, None]
    q_pos = torch.where(st < 0, st, (st + torch.arange(T)[None, :]).clamp(
        max=W * bs - 1)).to(dev)
    qkv = torch.randn(B, T, 3 * H * Dh, generator=gen).to(dev, dtype)
    q = qkv[..., :H * Dh].view(B, T, H, Dh)
    return q, ck, cv, rows, q_pos, bs


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_cuda_kernel_routes_match_plain_version(cuda_device, case):
    """Each route against the plain version: fp32 atol 1e-5, bf16/fp16
    `bf16_tolerance`; a slot with no live key is 0, as JAX's kernel leaves
    it (the plain version, JAX's reference, averages V there)."""
    B, T, H, Dh, W, dtype, starts, way = ROUTE_CASES[case]
    q, ck, cv, rows, q_pos, bs = _route_inputs(B, T, H, Dh, W, dtype, starts,
                                               cuda_device)
    assert paged.route(q, ck) == way
    n = dict(paged.LAUNCHES_BY_ROUTE)
    out = registry.dispatch("paged_attention", q, ck, cv, rows, q_pos,
                            block_size=bs)
    ref = registry.dispatch("paged_attention", q, ck, cv, rows, q_pos,
                            impl="torch", block_size=bs)
    torch.cuda.synchronize()
    assert paged.LAUNCHES_BY_ROUTE[way] == n[way] + 1
    empty = (q_pos < 0)[:, :, None, None].expand_as(out)
    assert bool((out[empty] == 0).all())
    diff = (out.float() - ref.float()).abs()
    tol = (torch.full_like(diff, 1e-5) if dtype == torch.float32 else
           paged.bf16_tolerance(q, ck, cv, rows, q_pos, ref))
    ok = (diff <= tol) | empty
    assert bool(ok.all()), float((diff / tol)[~empty].max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_tensor_core_prefill_holds_its_bound_on_adversarial_values(
        cuda_device, dtype):
    """The tensor-core route on the adversarial chunk, whose probabilities'
    roundings a kernel that rounds p once would set against the
    reference's: inside `bf16_tolerance` (the worst ratio is printed)."""
    q, ck, cv, rows, q_pos, bs = _adversarial_prefill(cuda_device, dtype)
    assert paged.route(q, ck) == "tensor-cores"
    out = registry.dispatch("paged_attention", q, ck, cv, rows, q_pos,
                            block_size=bs)
    ref = registry.dispatch("paged_attention", q, ck, cv, rows, q_pos,
                            impl="torch", block_size=bs)
    tol = paged.bf16_tolerance(q, ck, cv, rows, q_pos, ref)
    worst = float(((out.float() - ref.float()).abs() / tol).max())
    print(f"adversarial tensor-core prefill {dtype}: worst "
          f"|kernel - plain| / bound = {worst}")
    assert worst <= 1.0, worst


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 128])
def test_cuda_split_kernel_is_bitwise_repeatable(cuda_device, T):
    """Split decode (B 4, GPT-2 XL heads: 100 (slot, head) blocks, so 8
    splits) and the tensor-core prefill chunk, 50 calls after other
    kernels: bitwise equal, as the split merge's fixed order makes them."""
    B = 4 if T == 1 else 1
    starts = [256 + 61 * b for b in range(B)]
    q, ck, cv, rows, q_pos, bs = _route_inputs(B, T, 25, 64, 64,
                                               torch.bfloat16, starts,
                                               cuda_device)
    first = registry.dispatch("paged_attention", q, ck, cv, rows, q_pos,
                              block_size=bs)
    for _ in range(50):
        torch.randn(1 << 20, device=cuda_device).sum()   # other kernels
        again = registry.dispatch("paged_attention", q, ck, cv, rows, q_pos,
                                  block_size=bs)
        assert torch.equal(again, first)


@pytest.mark.cuda
def test_cuda_split_decode_on_two_streams_at_once(cuda_device):
    """Two split decode calls (B 4 at GPT-2 XL's heads: 8 key ranges),
    each from its own thread on its own stream, 40 times each with
    nothing between: every result bitwise equal to the same call run
    alone, and the launches counted exactly (the split merge's scratch is
    per (device, stream), the counts are taken under a lock)."""
    import threading

    inputs = [_route_inputs(4, 1, 25, 64, 64, torch.bfloat16,
                            [300 + 70 * b for b in range(4)], cuda_device,
                            seed=seed) for seed in (1, 2)]
    assert paged._plan(4, 25, 1, 1024, 16, 64, "split-keys")[0] > 1
    alone = [registry.dispatch("paged_attention", *x[:5], block_size=x[5])
             for x in inputs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in inputs]
    outs = [[], []]
    start = threading.Barrier(2)
    n0 = paged.LAUNCHES

    def replica(i):
        with torch.cuda.stream(streams[i]):
            start.wait()
            for _ in range(40):
                outs[i].append(registry.dispatch(
                    "paged_attention", *inputs[i][:5],
                    block_size=inputs[i][5]))

    threads = [threading.Thread(target=replica, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert paged.LAUNCHES == n0 + 80
    for i in (0, 1):
        assert all(torch.equal(o, alone[i]) for o in outs[i])


@pytest.mark.cuda
def test_cuda_worker_binds_the_engine_card(cuda_device):
    """An engine built with device "cuda" while the caller's current card
    is the last one (card 1 or more where the host has several) holds that
    card's index, and its ServeWorker thread, whose current card starts at
    0, binds it and launches the paged kernel there: the worker's greedy
    tokens equal another engine's on the caller's thread, exactly (the
    same fp32 weights, the same kernels, the same batch)."""
    import time

    from deepspeed_tpu_torch import serving
    from deepspeed_tpu_torch.models import GPT, gpt2_config

    card = torch.cuda.device_count() - 1
    prev = torch.cuda.current_device()
    torch.cuda.set_device(card)
    try:
        cfg = gpt2_config("nano", param_dtype=torch.float32)
        model = GPT(cfg, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
        scfg = serving.ServeConfig(block_size=16, num_blocks=40, max_batch=4,
                                   prefill_chunk=32)
        prompts = [np.random.RandomState(s).randint(
            0, cfg.vocab_size, (n,)).tolist() for s, n in ((1, 9), (2, 30),
                                                          (3, 17))]
        want = serving.ServeEngine(model, scfg, device="cuda").generate(
            prompts, 8)
        eng = serving.ServeEngine(model, scfg, device="cuda")
        assert eng.device == torch.device("cuda", card)
        n0 = paged.LAUNCHES
        # all submitted before the worker's first step, as generate() does,
        # so that both engines step the same batches
        reqs = [eng.submit(p, 8) for p in prompts]
        serving.ServeWorker(eng).start()
        t0 = time.monotonic()
        while not all(r.done for r in reqs):
            assert time.monotonic() - t0 < 120
            time.sleep(0.005)
        eng.close()
        assert [r.state for r in reqs] == [serving.FINISHED] * 3
        assert [r.out for r in reqs] == want
        assert paged.LAUNCHES > n0
    finally:
        torch.cuda.set_device(prev)


# -- the build (kernels/build.py), exercised with stand-in compilers ---------


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body + "\n")
    path.chmod(0o755)
    return str(path)


def test_build_raises_when_nvcc_is_missing(monkeypatch):
    from deepspeed_tpu_torch.kernels import build

    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    from deepspeed_tpu_torch.kernels import build

    nvcc = _fake_nvcc(tmp_path, 'echo "error: no sm_90a here"; exit 2')
    monkeypatch.setattr(build, "find_nvcc", lambda: nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        build.build("paged_attention.cu")
    assert not any(p.suffix == ".so" for p in (tmp_path / "_build").iterdir())


def test_build_is_keyed_by_the_source_hash(monkeypatch, tmp_path):
    """A library is built once per source hash and reused; the nvcc
    command carries the sm_90a target."""
    from deepspeed_tpu_torch.kernels import build

    log = tmp_path / "calls"
    # the stand-in writes its output file (the argument after -o)
    nvcc = _fake_nvcc(tmp_path, f'echo "$@" >> {log}\n'
                      'while [ "$1" != "-o" ]; do shift; done; touch "$2"')
    monkeypatch.setattr(build, "find_nvcc", lambda: nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    path = build.build("paged_attention.cu")
    assert os.path.basename(path).startswith("paged_attention-")
    assert os.path.exists(path)
    assert build.build("paged_attention.cu") == path  # cached: no recompile
    calls = log.read_text().splitlines()
    assert len(calls) == 1
    assert "arch=compute_90a,code=sm_90a" in calls[0]
    assert path == build.library_path("paged_attention.cu")


def test_build_key_covers_the_shared_headers(monkeypatch, tmp_path):
    """An edit to a header in csrc/ (which every source includes)
    renames the library, so the next use rebuilds it."""
    from deepspeed_tpu_torch.kernels import build

    for name in ("paged_attention.cu", "common.cuh"):
        shutil.copy(os.path.join(build.CSRC, name), tmp_path / name)
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    before = build.library_path("paged_attention.cu")
    with open(tmp_path / "common.cuh", "a") as f:
        f.write("// edited\n")
    assert build.library_path("paged_attention.cu") != before

"""Port parity: quantized KV and speculative decoding
(deepspeed_tpu_torch/runtime/comm/quant.py row codec,
serving/kv_cache.py int8/int4 pools, serving/programs.py `verify`,
serving/engine.py drafter and accept/reject loop, kernel #10's quantized
branches) against the JAX package, and the contracts of
tests/test_spec_decode.py held by the port.

Weights are the JAX `GPT.init` tree carried across with
`load_jax_params`; prompts and rows come from numpy seeds.  Comparisons:

* the row codec: bitwise (payload bytes, fp16 scale bits, dequantized
  fp32 bits; NaN at the same places);
* token streams: exact — greedy serving at int8/int4 against JAX's
  `ServeEngine` at the same kv_dtype, and speculative against
  non-speculative serving (the n-gram drafter's candidates are checked
  against position-keyed samples of the target, so they change when
  tokens arrive, never which);
* paged attention over a quantized cache, plain version against JAX's
  reference: atol 1e-5 — both dequantize exactly (a code times an fp16
  scale is exact in fp32) and differ in the order of fp32 sums only; the
  CUDA kernel against the plain version on the card: the same 1e-5.

The kernel runs only on a card: the `cuda`-marked tests at the end skip
here (`python -m pytest --noconftest -m cuda
tests/test_torch_spec_decode.py` on the card)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepspeed_tpu_torch.kernels import paged, registry  # noqa: E402
from deepspeed_tpu_torch.models import GPT, gpt2_config  # noqa: E402
from deepspeed_tpu_torch.models import generate  # noqa: E402
from deepspeed_tpu_torch.monitor.counters import COUNTERS  # noqa: E402
from deepspeed_tpu_torch.runtime.comm.quant import (  # noqa: E402
    dequantize_rows, quantize_rows)
from deepspeed_tpu_torch.serving import (FINISHED, PagedKVCache,  # noqa: E402
                                         ServeConfig, ServeEngine,
                                         kv_block_bytes, resolve_kv_dtype,
                                         rows_for_tables)
from deepspeed_tpu_torch.serving.scheduler import (Request,  # noqa: E402
                                                   Scheduler)

torch.set_num_threads(1)

VOCAB = 64
MAX_SEQ = 64
BS = 4            # KV block size
WIDTH = MAX_SEQ // BS
MODEL = dict(num_layers=2, num_heads=4, d_model=32, vocab_size=VOCAB,
             max_seq_len=MAX_SEQ)     # head_dim 8: int4 packing is legal
_CACHE = {}


def _pair():
    """(jax model, jax params, port model) on one set of weights."""
    if "pair" not in _CACHE:
        import jax

        from deepspeed_tpu.models import GPT as JaxGPT
        from deepspeed_tpu.models import gpt2_config as jax_gpt2_config
        from deepspeed_tpu_torch.models import load_jax_params

        jmodel = JaxGPT(jax_gpt2_config("nano", **MODEL))
        jparams = jmodel.init(jax.random.PRNGKey(1))
        model = GPT(gpt2_config("nano", **MODEL), device="cpu")
        load_jax_params(model, jax.tree_util.tree_map(np.asarray, jparams))
        _CACHE["pair"] = (jmodel, jparams, model)
    return _CACHE["pair"]


def _cfg(**over):
    base = dict(block_size=BS, num_blocks=40, max_batch=3, prefill_chunk=8,
                max_seq_len=MAX_SEQ)
    base.update(over)
    return ServeConfig(**base)


def _engine(**over):
    return ServeEngine(_pair()[2], _cfg(**over), device="cpu")


def _prompts(seed=0):
    """Repetitive prompts (a pattern four times: the drafter's home turf)
    plus one random prompt."""
    rs = np.random.RandomState(seed)
    ps = [(rs.randint(0, VOCAB, (n,)).tolist() * 4) for n in (3, 4)]
    ps.append(rs.randint(0, VOCAB, (7,)).tolist())
    return ps


def _baseline(kv, prompts, n=10, **kw):
    """Non-speculative one-at-a-time outputs of the port at kv_dtype kv."""
    key = ("base", kv, tuple(map(tuple, prompts)), n,
           tuple(sorted((k, str(v)) for k, v in kw.items())))
    if key not in _CACHE:
        outs = []
        for i, p in enumerate(prompts):
            extra = dict(kw)
            if "seeds" in kw:
                extra["seeds"] = [kw["seeds"][i]]
            outs.append(_engine(kv_dtype=kv, draft_len=0).generate(
                [p], n, **extra)[0])
        _CACHE[key] = outs
    return _CACHE[key]


# -- the row codec ------------------------------------------------------------


def _codec_rows():
    """Random rows and the edge cases: exact .5 ties at the int8 and int4
    scales, subnormals beside a normal, +-inf and NaN, all-zero rows."""
    rs = np.random.RandomState(3)
    x = (rs.randn(40, 4, 16) * 3).astype(np.float32)
    x[0, 0] = [127, 63.5, -63.5, 0.5, -0.5, 1.5, 2.5, -2.5, 3.5, 126.5,
               -126.5, 0, 0, 0, 0, 0]
    x[0, 1] = [7, 3.5, -3.5, 0.5, -0.5, 1.5, 2.5, -2.5, 6.5, -6.5, 5.5, 4.5,
               0, 0, 0, 0]
    x[1, 0] = 1e-39                       # subnormals: flushed, row of zeros
    x[1, 1, :] = 1e-39
    x[1, 1, 0] = 1e-3                     # a normal beside subnormals
    x[2, 0, 3] = np.inf
    x[2, 1, 5] = -np.inf
    x[2, 2, 7] = np.nan
    x[3] = 0.0
    x[4, 0] = 1e6                         # an fp16-overflowing int4 scale
    return x


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_row_codec_bitwise_equal_to_jax(wire):
    import jax.numpy as jnp

    from deepspeed_tpu.runtime.comm import quant as jq

    x = _codec_rows()
    jp, js = jq.quantize_rows(jnp.asarray(x), wire)
    tp, ts = quantize_rows(torch.from_numpy(x), wire)
    assert tp.dtype == (torch.int8 if wire == "int8" else torch.uint8)
    assert np.array_equal(np.asarray(jp), tp.numpy())
    assert np.array_equal(np.asarray(js).view(np.uint16),
                          ts.numpy().view(np.uint16))
    jd = np.asarray(jq.dequantize_rows(jp, js, wire))
    td = dequantize_rows(tp, ts, wire).numpy()
    assert np.array_equal(np.isnan(jd), np.isnan(td))
    fin = ~np.isnan(jd)
    assert np.array_equal(jd[fin].view(np.uint32), td[fin].view(np.uint32))
    assert np.isnan(td).sum() >= 3        # the markers came back as NaN


def test_row_codec_rounds_half_to_even_and_rejects_odd_int4():
    codes, scales = quantize_rows(torch.tensor([[127.0, 0.5, 1.5, 2.5,
                                                 -0.5, -1.5]]), "int8")
    assert float(scales[0]) == 1.0
    assert codes[0].tolist() == [127, 0, 2, 2, 0, -2]
    with pytest.raises(ValueError, match="even"):
        quantize_rows(torch.zeros(2, 7), "int4")
    with pytest.raises(ValueError, match="int2"):
        quantize_rows(torch.zeros(2, 8), "int2")


# -- the quantized cache --------------------------------------------------------


def test_resolve_kv_dtype_aliases_and_typos():
    assert resolve_kv_dtype("bf16") == ("dense", torch.bfloat16)
    assert resolve_kv_dtype("int8") == ("int8", None)
    assert resolve_kv_dtype("INT4") == ("int4", None)
    assert resolve_kv_dtype(torch.float16) == ("dense", torch.float16)
    with pytest.raises(ValueError, match="kv_dtype"):
        resolve_kv_dtype("fp8")


@pytest.mark.parametrize("kv,per_row", [
    ("bf16", 4 * 8 * 2), ("fp32", 4 * 8 * 4),
    ("int8", 4 * (8 + 2)), ("int4", 4 * (8 // 2 + 2))])
def test_cache_bytes_match_block_accounting(kv, per_row):
    assert kv_block_bytes(2, 4, 8, BS, kv) == 2 * 2 * BS * per_row
    cache = PagedKVCache(num_layers=2, num_heads=4, head_dim=8,
                         num_blocks=10, block_size=BS, table_width=WIDTH,
                         dtype=kv, device="cpu")
    assert cache.nbytes() == 10 * cache.bytes_per_block()
    assert cache.bytes_per_block() == kv_block_bytes(2, 4, 8, BS, kv)


def test_quant_cache_layout_and_zero_init():
    cache = PagedKVCache(num_layers=1, num_heads=2, head_dim=8, num_blocks=3,
                         block_size=BS, table_width=WIDTH, dtype="int4",
                         device="cpu")
    (pk, sk), (pv, sv) = cache.caches[0]
    assert pk.shape == (3 * BS, 2, 4) and pk.dtype == torch.uint8
    assert sk.shape == (3 * BS, 2) and sk.dtype == torch.float16
    assert bool((dequantize_rows(pk, sk, "int4") == 0).all())
    with pytest.raises(ValueError, match="even"):
        PagedKVCache(num_layers=1, num_heads=2, head_dim=7, num_blocks=3,
                     block_size=BS, table_width=WIDTH, dtype="int4",
                     device="cpu")


def test_paged_kv_cache_defaults_to_the_card(monkeypatch):
    """A cache built without a device asks for CUDA, as every entry point
    does: with no GPU it raises, naming device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PagedKVCache(num_layers=1, num_heads=2, head_dim=8, num_blocks=3,
                     block_size=BS, table_width=WIDTH)
    assert PagedKVCache(num_layers=1, num_heads=2, head_dim=8, num_blocks=3,
                        block_size=BS, table_width=WIDTH,
                        device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_prefix_hashes_byte_equal_to_jax(kv):
    from deepspeed_tpu import serving as jserving

    jmodel, jparams, _ = _pair()
    tokens = np.random.RandomState(9).randint(0, VOCAB, (23,)).tolist()
    jeng = jserving.ServeEngine(jmodel, jparams, jserving.ServeConfig(
        block_size=BS, num_blocks=40, max_batch=3, prefill_chunk=8,
        max_seq_len=MAX_SEQ, kv_dtype=kv))
    got = _engine(kv_dtype=kv).kv.prefix_hashes(tokens)
    assert got == jeng.kv.prefix_hashes(tokens) and len(got) == 23 // BS
    assert got != _engine().kv.prefix_hashes(tokens)


@pytest.mark.parametrize("wire", ["int8", "int4"])
@pytest.mark.parametrize("T", [1, 5])
def test_paged_reference_over_quantized_cache_matches_jax(wire, T):
    """Decode (T = 1) and verify (T = 5) over a quantized cache: the
    port's plain version against JAX's reference and its Pallas kernel in
    interpret mode (atol 1e-5)."""
    import jax.numpy as jnp

    from deepspeed_tpu.kernels import paged as jpaged
    from deepspeed_tpu.runtime.comm import quant as jq

    rs = np.random.RandomState(5)
    R, H, Dh, bs, W = 3, 2, 64, 4, 4
    ck = rs.randn((R * W + 1) * bs, H, Dh).astype(np.float32)
    cv = rs.randn((R * W + 1) * bs, H, Dh).astype(np.float32)
    tables = rs.randint(1, R * W + 1, (R, W)).astype(np.int32)
    tables[0, 3] = 0
    q = rs.randn(R, T, H, Dh).astype(np.float32)
    q_pos = (rs.randint(0, W * bs - T, (R, 1)) +
             np.arange(T)[None, :]).astype(np.int32)
    rows = rows_for_tables(torch.from_numpy(tables).long(), bs)
    jk, jv = jq.quantize_rows(jnp.asarray(ck), wire), \
        jq.quantize_rows(jnp.asarray(cv), wire)
    tk, tv = quantize_rows(torch.from_numpy(ck), wire), \
        quantize_rows(torch.from_numpy(cv), wire)
    got = registry.dispatch("paged_attention", torch.from_numpy(q), tk, tv,
                            rows, torch.from_numpy(q_pos).long(),
                            kv_mode=wire, block_size=bs).numpy()
    assert got.dtype == np.float32
    jrows = jnp.asarray(rows.numpy())
    for fn in (jpaged.paged_attention_reference,
               jpaged.paged_attention_pallas):
        want = np.asarray(fn(jnp.asarray(q), jk, jv, jrows,
                             jnp.asarray(q_pos), kv_mode=wire,
                             block_size=bs))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# -- serving ------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_quantized_greedy_serving_matches_jax_engine(kv):
    from deepspeed_tpu import serving as jserving

    jmodel, jparams, _ = _pair()
    prompts = _prompts(seed=2)
    want = jserving.ServeEngine(jmodel, jparams, jserving.ServeConfig(
        block_size=BS, num_blocks=40, max_batch=3, prefill_chunk=8,
        max_seq_len=MAX_SEQ, kv_dtype=kv)).generate(prompts, 10)
    assert _engine(kv_dtype=kv).generate(prompts, 10) == want


@pytest.mark.parametrize("admission", ["continuous", "static"])
@pytest.mark.parametrize("draft", [2, 4])
@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
def test_spec_parity_matrix(kv, draft, admission):
    """Speculative batched serving == non-speculative one-at-a-time
    serving at the same kv_dtype, token for token, under both admission
    policies (tests/test_spec_decode.py's matrix)."""
    prompts = _prompts()
    eng = _engine(kv_dtype=kv, draft_len=draft, admission=admission)
    assert eng.generate(prompts, 10) == _baseline(kv, prompts)


def test_spec_bf16_matches_generate_cache_dtype():
    model = _pair()[2]
    prompts = _prompts(seed=7)
    got = _engine(kv_dtype="bf16", draft_len=4).generate(prompts, 10)
    want = [generate(model, [p], 10, cache_len=WIDTH * BS,
                     cache_dtype=torch.bfloat16, device="cpu")[0].tolist()
            for p in prompts]
    assert got == want


def test_spec_sampled_parity_exercises_rejection():
    """Seeded sampling: drafts get rejected, the correction path emits the
    target's own token, and output still matches the non-spec engine;
    the rewind leaks no block."""
    prompts = _prompts(seed=11)
    kw = dict(temperature=0.9, top_k=8, seeds=[5, 6, 7])
    oracle = _baseline("int8", prompts, **kw)
    eng = _engine(kv_dtype="int8", draft_len=4)
    snap = COUNTERS.snapshot()
    got = eng.generate(prompts, 10, **kw)
    d = COUNTERS.delta_since(snap)
    assert got == oracle
    assert d["serve.draft_tokens"]["calls"] > \
        d.get("serve.accepted_tokens", {"calls": 0})["calls"]
    assert eng.kv.blocks_in_use == 0 and eng.kv.evictions == 0


def test_acceptance_counters_pinned_on_repetitive_prompt():
    """Greedy decode of a repeated pattern: tokens after the first (from
    prefill) = decode steps + accepted drafts, more than 1.5 accepted a
    step, and every verify dispatch timed into kv.dequant_ms."""
    prompt = [7, 3, 9, 1] * 5
    n = 16
    eng = _engine(kv_dtype="int8", draft_len=4)
    snap = COUNTERS.snapshot()
    r = eng.submit(prompt, n)
    eng.run()
    d = COUNTERS.delta_since(snap)
    assert r.state == FINISHED and len(r.out) == n
    steps = d["serve.decode_steps"]["calls"]
    acc = d["serve.accepted_tokens"]["calls"]
    assert n - 1 == steps + acc, d
    assert acc / steps > 1.5, (acc, steps)
    assert d["serve.draft_tokens"]["calls"] >= acc
    assert d["kv.dequant_ms"]["calls"] == steps
    assert d["kv.dequant_ms"]["bytes"] > 0


def test_dense_cache_records_no_dequant():
    eng = _engine(kv_dtype="bf16", draft_len=2)
    snap = COUNTERS.snapshot()
    eng.generate([_prompts()[0]], 6)
    assert "kv.dequant_ms" not in COUNTERS.delta_since(snap)


def test_scheduler_reserves_speculative_tail():
    kv = PagedKVCache(num_layers=1, num_heads=2, head_dim=8, num_blocks=20,
                      block_size=BS, table_width=WIDTH, dtype="int8",
                      device="cpu")
    plain = Scheduler(kv, max_batch=2, draft_len=0)
    spec = Scheduler(kv, max_batch=2, draft_len=4)
    req = Request(prompt=[1] * 5, max_new_tokens=3)
    assert plain.blocks_reserved(req) == 2
    assert spec.blocks_reserved(req) == 3
    big = Request(prompt=[1] * 5, max_new_tokens=WIDTH * BS - 5)
    assert spec.blocks_reserved(big) == WIDTH


def test_spec_request_at_full_capacity_stays_exact():
    prompt = [5, 2] * 6
    n = MAX_SEQ - len(prompt)
    oracle = _baseline("int8", [prompt], n=n)
    eng = _engine(kv_dtype="int8", draft_len=4)
    r = eng.submit(prompt, n)
    eng.run()
    assert r.state == FINISHED and [r.out] == oracle
    assert eng.kv.blocks_in_use == 0


def test_spec_admission_budget_queues_not_corrupts():
    prompts = [[3, 8, 4] * 4] * 3
    oracle = _baseline("int8", prompts, n=8)
    eng = _engine(kv_dtype="int8", draft_len=4, num_blocks=14)
    reqs = [eng.submit(p, 8) for p in prompts]
    eng.run()
    assert all(r.state == FINISHED for r in reqs)
    assert [r.out for r in reqs] == oracle
    assert eng.peak_blocks_in_use <= eng.kv.capacity_blocks
    assert eng.kv.blocks_in_use == 0


# -- the kernel on the card ---------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit "
                    "(on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_spec_decode.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wire", ["int8", "int4"])
@pytest.mark.parametrize("T,Dh", [(1, 64), (5, 64), (5, 128), (16, 64)])
def test_cuda_quantized_kernel_matches_plain_version(cuda_device, T, Dh,
                                                     wire, q_dtype):
    """Kernel vs plain version over an int8/int4 cache, q as the strided
    view of a fused QKV output: atol 1e-5 (both dequantize exactly, fp32
    throughout); an fp32 output."""
    rs = np.random.RandomState(7)
    R, H, bs, W = 3, 4, 16, 8
    nrows = (R * W + 1) * bs
    ck = torch.from_numpy(rs.randn(nrows, H, Dh).astype(np.float32))
    cv = torch.from_numpy(rs.randn(nrows, H, Dh).astype(np.float32))
    tk = tuple(t.to(cuda_device) for t in quantize_rows(ck, wire))
    tv = tuple(t.to(cuda_device) for t in quantize_rows(cv, wire))
    tables = torch.from_numpy(rs.randint(1, R * W + 1, (R, W))).long()
    tables[0, W - 1] = 0                          # the trash block
    rows = rows_for_tables(tables.to(cuda_device), bs)
    q_pos = torch.from_numpy(rs.randint(0, W * bs - T, (R, 1)) +
                             np.arange(T)[None, :]).to(cuda_device)
    qkv = torch.from_numpy(rs.randn(R, T, 3 * H * Dh).astype(
        np.float32)).to(cuda_device, q_dtype)
    q = qkv[..., :H * Dh].view(R, T, H, Dh)
    n = paged.LAUNCHES
    out = registry.dispatch("paged_attention", q, tk, tv, rows, q_pos,
                            kv_mode=wire, block_size=bs)
    ref = registry.dispatch("paged_attention", q, tk, tv, rows, q_pos,
                            kv_mode=wire, block_size=bs, impl="torch")
    torch.cuda.synchronize()
    assert paged.LAUNCHES == n + 1
    assert out.dtype == torch.float32 and out.shape == ref.shape
    diff = (out - ref).abs()
    assert float(diff.max()) <= 1e-5, float(diff.max())


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_cuda_spec_serving_equals_non_spec(cuda_device, kv):
    model = GPT(gpt2_config("nano", **dict(MODEL, num_heads=1, d_model=64)),
                device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(0))
    prompts = _prompts()
    outs = []
    for draft in (0, 4):
        eng = ServeEngine(model, ServeConfig(
            block_size=16, num_blocks=20, max_batch=3, prefill_chunk=16,
            max_seq_len=MAX_SEQ, kv_dtype=kv, draft_len=draft),
            device="cuda")
        outs.append(eng.generate(prompts, 10))
    assert outs[0] == outs[1]

"""Port parity: the serving slice (deepspeed_tpu_torch/serving/) against
the JAX package's serving engine, on shared weights.

Two configurations: the JAX serving tests' own (2 layers, 4 heads, d32,
vocab 64, max_seq 64, KV block 4) and one at GPT-2 width (2 layers,
d768, 12 heads, head_dim 64, vocab 1024).  Weights are made by the JAX
init and carried across with `load_jax_params`; prompts come from numpy
seeds.  Greedy token streams are compared exactly; prefill logits at
atol 1e-5 (fp32 on both sides, sums in another order, logits of size
< 1).  The batching-invariance, prefix-cache and allocator contracts are
the JAX package's tests/test_serving.py pins, held by the port alone."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepspeed_tpu.models import GPT as JaxGPT  # noqa: E402
from deepspeed_tpu.models import gpt2_config as jax_gpt2_config  # noqa: E402
from deepspeed_tpu.models.generation import \
    generate as jax_generate  # noqa: E402
from deepspeed_tpu.monitor.counters import \
    COUNTERS as JAX_COUNTERS  # noqa: E402
from deepspeed_tpu import serving as jserving  # noqa: E402
from deepspeed_tpu_torch.models import (GPT, generate,  # noqa: E402
                                        gpt2_config, load_jax_params)
from deepspeed_tpu_torch.monitor.counters import COUNTERS  # noqa: E402
from deepspeed_tpu_torch.serving import (ERROR, FINISHED,  # noqa: E402
                                         TRASH_BLOCK, WAITING, ServeConfig,
                                         ServeEngine, ServeSchedule)
from deepspeed_tpu_torch.serving import programs  # noqa: E402

torch.set_num_threads(1)

# name -> (gpt2 size, model overrides, serve config, prompt lens, new tokens)
CONFIGS = {
    "tiny": ("nano", dict(num_layers=2, num_heads=4, d_model=32,
                          vocab_size=64, max_seq_len=64),
             dict(block_size=4, num_blocks=40, max_batch=4, prefill_chunk=8,
                  max_seq_len=64), (5, 9, 3, 12), 8),
    "gpt2-width": ("small", dict(num_layers=2, vocab_size=1024,
                                 max_seq_len=128),
                   dict(block_size=16, num_blocks=40, max_batch=4,
                        prefill_chunk=32, max_seq_len=128),
                   (20, 45, 7, 33), 6),
}
_CACHE = {}


def _pair(name, seed=1, **model_over):
    """(jax model, jax params, port model) on one set of weights."""
    key = (name, seed, tuple(sorted(model_over.items())))
    if key not in _CACHE:
        size, over = CONFIGS[name][:2]
        over = dict(over, **model_over)
        jmodel = JaxGPT(jax_gpt2_config(size, **over))
        jparams = jmodel.init(jax.random.PRNGKey(seed))
        model = GPT(gpt2_config(size, **over), device="cpu")
        load_jax_params(model, jax.tree_util.tree_map(np.asarray, jparams))
        _CACHE[key] = (jmodel, jparams, model)
    return _CACHE[key]


def _jax_programs(name):
    key = ("programs", name)
    if key not in _CACHE:
        jmodel = _pair(name)[0]
        s = CONFIGS[name][2]
        sched = jserving.ServeSchedule(
            max_batch=s["max_batch"], prefill_chunk=s["prefill_chunk"],
            block_size=s["block_size"], num_blocks=s["num_blocks"],
            table_width=s["max_seq_len"] // s["block_size"])
        _CACHE[key] = jserving.ServeProgramBuilder(jmodel, sched).build()
    return _CACHE[key]


def _serve_cfg(name, **over):
    return dict(CONFIGS[name][2], **over)


def _engine(name="tiny", **over):
    return ServeEngine(_pair(name)[2], ServeConfig(**_serve_cfg(name, **over)),
                       device="cpu")


def _jax_engine(name="tiny", **over):
    jmodel, jparams, _ = _pair(name)
    progs = None if over else _jax_programs(name)
    return jserving.ServeEngine(
        jmodel, jparams, jserving.ServeConfig(**_serve_cfg(name, **over)),
        programs=progs)


def _prompts(name="tiny", seed=0, lens=None):
    rs = np.random.RandomState(seed)
    vocab = CONFIGS[name][1]["vocab_size"]
    lens = lens or CONFIGS[name][3]
    return [rs.randint(0, vocab, (n,)).tolist() for n in lens]


def _alone(prompt, n, name="tiny", **kw):
    return _engine(name).generate([prompt], n, **kw)[0]


# -- cross-package parity ---------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_logits_match_jax(name):
    """Two prefill chunks through a scattered block table (the second
    attends over the first's cached rows): fp32 logits within 1e-5 and
    the same greedy first token."""
    jmodel, jparams, model = _pair(name)
    s = CONFIGS[name][2]
    bs, C = s["block_size"], s["prefill_chunk"]
    W = s["max_seq_len"] // bs
    cfg = model.config
    rs = np.random.RandomState(7)
    table = np.zeros((W,), np.int32)
    table[:2 * C // bs + 1] = rs.permutation(
        np.arange(1, s["num_blocks"]))[:2 * C // bs + 1]
    rows = s["num_blocks"] * bs
    shape = (rows, cfg.num_heads, cfg.head_dim)
    jcaches = [(jnp.zeros(shape), jnp.zeros(shape))
               for _ in range(cfg.num_layers)]
    tcaches = [(torch.zeros(shape), torch.zeros(shape))
               for _ in range(cfg.num_layers)]
    sched = ServeSchedule(max_batch=s["max_batch"], prefill_chunk=C,
                          block_size=bs, num_blocks=s["num_blocks"],
                          table_width=W)
    jprefill = _jax_programs(name)["prefill"]
    for pos, n_valid in ((0, C), (C, C - 3)):
        tokens = np.zeros((1, C), np.int32)
        tokens[0, :n_valid] = rs.randint(0, cfg.vocab_size, (n_valid,))
        jtok, jlogits, jcaches = jprefill(
            jparams, jcaches, jnp.asarray(tokens), np.int32(pos),
            np.int32(n_valid), jnp.asarray(table), np.float32(0.0),
            np.int32(0), np.uint32(0))
        tok, logits = programs.prefill(model, tcaches, sched, tokens, pos,
                                       n_valid, table, 0.0, 0, 0)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-5, rtol=0)
        assert tok == int(jtok)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_greedy_serving_matches_jax_engine_and_generate(name):
    jmodel, jparams, _ = _pair(name)
    n = CONFIGS[name][4]
    prompts = _prompts(name)
    got = _engine(name).generate(prompts, n)
    assert got == _jax_engine(name).generate(prompts, n)
    W = CONFIGS[name][2]["max_seq_len"]
    for p, g in zip(prompts, got):
        want = np.asarray(jax_generate(jmodel, jparams,
                                       np.asarray([p], np.int32), n,
                                       cache_len=W))[0].tolist()
        assert g == want


def test_prefix_hashes_byte_equal_to_jax():
    tokens = _prompts(lens=(23,))[0]
    for kv_dtype in (None, "bf16"):
        want = _jax_engine(kv_dtype=kv_dtype).kv.prefix_hashes(tokens)
        got = _engine(kv_dtype=kv_dtype).kv.prefix_hashes(tokens)
        assert len(got) == 23 // 4 and got == want


def test_serving_counters_match_jax_counts():
    """The same request mix (a prefix hit included) on both engines:
    every serve.* / kv.* count agrees (TTFT bytes are wall time)."""
    p1, p2 = _prompts(seed=23, lens=(9, 5))
    deltas = []
    for eng, counters in ((_engine(), COUNTERS),
                          (_jax_engine(), JAX_COUNTERS)):
        snap = counters.snapshot()
        eng.generate([p1], 3)
        eng.generate([p1 + p2, p2], 4)
        d = counters.delta_since(snap)
        d = {k: v for k, v in d.items() if k.startswith(("serve.", "kv."))}
        d["serve.ttft_ms"] = d["serve.ttft_ms"]["calls"]
        deltas.append(d)
    assert deltas[0] == deltas[1]
    assert deltas[0]["kv.prefix_hits"]["calls"] == 1


def test_prefill_final_chunk_past_wpe_table_stays_exact():
    """The final (padded) prefill chunk runs past the wpe table: the
    valid rows keep their exact positional embeddings (the clip rule)."""
    jmodel, jparams, model = _pair("tiny", seed=2, max_seq_len=30)
    eng = ServeEngine(model, ServeConfig(block_size=4, num_blocks=40,
                                         max_batch=2, prefill_chunk=8,
                                         max_seq_len=30), device="cpu")
    prompt = _prompts(seed=41, lens=(27,))[0]
    got = eng.generate([prompt], 3)[0]
    L = eng.kv.table_width * 4
    assert got == generate(model, [prompt], 3, cache_len=L,
                           device="cpu")[0].tolist()
    assert got == np.asarray(jax_generate(
        jmodel, jparams, np.asarray([prompt], np.int32), 3,
        cache_len=L))[0].tolist()


# -- the JAX package's serving contracts, held by the port -------------------


def test_greedy_matches_port_generate_at_bf16_kv():
    """A bf16 cache under fp32 params: serving equals generate() with
    the same cache dtype (K/V rounded on write, probs cast before PV)."""
    model = _pair("tiny")[2]
    prompt = _prompts()[1]
    got = _engine(kv_dtype="bf16").generate([prompt], 8)[0]
    want = generate(model, [prompt], 8, cache_len=64,
                    cache_dtype=torch.bfloat16, device="cpu")[0].tolist()
    assert got == want


def test_chunked_prefill_token_identical_to_one_shot():
    prompt = _prompts(seed=17, lens=(19,))[0]
    outs = {c: _engine(prefill_chunk=c).generate([prompt], 6)[0]
            for c in (4, 32)}
    assert outs[4] == outs[32]


def test_greedy_alone_static_and_midflight_are_token_identical():
    prompts = _prompts()
    oracle = [_alone(p, 8) for p in prompts]
    assert _engine().generate(prompts, 8) == oracle
    eng = _engine()
    r0 = eng.submit(prompts[0], 8)
    for _ in range(3):
        eng.step()
    r1 = eng.submit(prompts[1], 8)
    eng.step()
    r2 = eng.submit(prompts[2], 8)
    for _ in range(2):
        eng.step()
    r3 = eng.submit(prompts[3], 8)
    eng.run()
    assert [r.out for r in (r0, r1, r2, r3)] == oracle
    assert all(r.state == FINISHED for r in (r0, r1, r2, r3))


def test_sampled_identical_under_seed_across_join_leave():
    prompts = _prompts(seed=3)
    kw = dict(temperature=0.8, top_k=5)
    oracle = []
    for i, p in enumerate(prompts):
        eng = _engine()
        r = eng.submit(p, 8, seed=100 + i, **kw)
        eng.run()
        oracle.append(r.out)
    assert any(len(set(o)) > 1 for o in oracle)   # not a collapsed stream
    eng = _engine()
    r0 = eng.submit(prompts[0], 8, seed=100, **kw)
    for _ in range(2):
        eng.step()
    r1 = eng.submit(prompts[1], 8, seed=101, **kw)
    r2 = eng.submit(prompts[2], 8, seed=102, **kw)
    for _ in range(3):
        eng.step()
    r3 = eng.submit(prompts[3], 8, seed=103, **kw)
    eng.run()
    assert [r.out for r in (r0, r1, r2, r3)] == oracle


def test_prefix_cache_on_off_identical():
    base, tail, other = _prompts(seed=5, lens=(12, 5, 9))
    outs = {}
    for on in (True, False):
        eng = _engine(prefix_cache=on)
        snap = COUNTERS.snapshot()
        first = eng.generate([base], 6)[0]
        # shares base's three full blocks; whole-prompt hit (copy on write
        # of the live shared last block); a cold prompt beside them
        outs[on] = [first] + eng.generate([base + tail, base, other], 6)
        d = COUNTERS.delta_since(snap)
        assert ("kv.prefix_hits" in d) == on, d
        assert ("kv.cow_copies" in d) == on, d
    assert outs[True] == outs[False]


def test_kv_exhaustion_queues_instead_of_erroring():
    prompts = _prompts(seed=11, lens=(6, 6, 6, 6))
    eng = _engine(num_blocks=7)                 # 6 usable, 3 per request
    reqs = [eng.submit(p, 6) for p in prompts]
    eng.step()
    assert [r.state for r in reqs].count(WAITING) == 2
    eng.run()
    assert all(r.state == FINISHED for r in reqs)
    assert eng.peak_blocks_in_use <= eng.kv.capacity_blocks
    assert eng.kv.blocks_in_use == 0
    assert [r.out for r in reqs] == [_alone(p, 6) for p in prompts]


def test_eos_finishes_early_and_frees_blocks():
    prompt = _prompts(seed=13)[1]
    kw = dict(temperature=0.9, top_k=6)
    full = _alone(prompt, 8, seeds=[42], **kw)
    stop_at = next(i for i in range(1, 8) if full[i] not in full[:i])
    eng = _engine()
    r = eng.submit(prompt, 8, seed=42, eos_token=full[stop_at], **kw)
    eng.run()
    assert r.out == full[:stop_at + 1]
    assert r.state == FINISHED and eng.kv.blocks_in_use == 0


def test_block_free_realloc_reuses_blocks_token_identically():
    prompts = _prompts(seed=8)
    eng = _engine(num_blocks=9)
    r0 = eng.submit(prompts[0], 6)
    eng.step()
    blocks0 = set(eng.kv.blocks_of(r0.rid))
    assert blocks0 and TRASH_BLOCK not in blocks0
    eng.run()
    r1 = eng.submit(prompts[1], 6)
    r2 = eng.submit(prompts[0], 6)
    eng.step()
    used = set(eng.kv.blocks_of(r1.rid)) | set(eng.kv.blocks_of(r2.rid))
    assert used & blocks0
    eng.run()
    assert r2.out == r0.out
    assert r1.out == _alone(prompts[1], 6)


def test_session_pin_second_turn_prefills_only_new_tokens():
    eng = _engine()
    p1 = _prompts(seed=31, lens=(10,))[0]
    r1 = eng.submit(p1, 5, session_id="chat")
    eng.run()
    hist = p1 + r1.out
    assert eng.resident_sessions == 1
    p2 = hist + _prompts(seed=32, lens=(4,))[0]
    snap = COUNTERS.snapshot()
    r2 = eng.submit(p2, 5, session_id="chat")
    eng.run()
    d = COUNTERS.delta_since(snap)
    # the final emitted token's row was never written: re-prefill from it
    assert r2.prefix_cached_tokens == len(hist) - 1
    assert d["serve.prefill_chunks"] == {"calls": 1, "bytes": 5}, d
    assert r2.out == _engine(prefix_cache=False).generate([p2], 5)[0]
    assert eng.release_session("chat") and eng.kv.blocks_in_use == 0


def test_shed_requests_report_error_and_evictions():
    prompts = _prompts(seed=29)
    eng = _engine()
    snap = COUNTERS.snapshot()
    r0 = eng.submit(prompts[0], 8)
    r1 = eng.submit(prompts[1], 8)
    for _ in range(3):
        eng.step()
    held = eng.kv.blocks_in_use
    eng.request_shed("test wedge")
    r2 = eng.submit(prompts[2], 4)
    eng.run()
    d = COUNTERS.delta_since(snap)
    assert r0.state == ERROR and "test wedge" in r0.error
    assert r1.state == ERROR and r2.state == FINISHED
    assert r2.out == _alone(prompts[2], 4)
    assert d["serve.shed"]["calls"] == 2
    assert d["kv.evictions"]["calls"] == held
    assert eng.kv.blocks_in_use == 0


def test_config_validation_and_unported_options():
    with pytest.raises(ValueError, match="admission"):
        ServeConfig(admission="greedy")
    with pytest.raises(ValueError, match="num_blocks"):
        ServeConfig(num_blocks=1)
    with pytest.raises(ValueError, match="quantized_weights"):
        ServeConfig(quantized_weights="fp8")
    with pytest.raises(NotImplementedError, match="qwZ"):
        ServeConfig(quantized_weights="int8")
    # speculative decoding and quantized KV are ported: they build
    assert ServeConfig(draft_len=2).draft_len == 2
    for wire in ("int8", "int4"):
        assert _engine(kv_dtype=wire).kv.quant_wire == wire
    with pytest.raises(ValueError, match="draft_len"):
        ServeConfig(draft_len=-1)
    with pytest.raises(ValueError, match="spec_ngram"):
        ServeConfig(spec_ngram=0)
    with pytest.raises(ValueError, match="kv_dtype"):
        ServeConfig(kv_dtype="fp8")
    with pytest.raises(ValueError, match="max_seq_len"):
        _engine(max_seq_len=128)
    eng = _engine()
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(list(range(60)), 10)
    with pytest.raises(ValueError, match="non-empty"):
        eng.submit([], 4)
    with pytest.raises(ValueError, match="temperature"):
        eng.submit([1, 2], 4, temperature=-1.0)

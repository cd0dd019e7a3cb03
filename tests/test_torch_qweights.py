"""Port parity: serving from blockwise-quantized weights
(`ServeConfig(quantized_weights="int8" | "int4")`:
deepspeed_tpu_torch/serving/programs.py `QuantLeaf`, `quantize_params`,
`dequantize_params`, `QuantizedWeights`, `prepare_params`; kernels #11
and #12 on the card) against the JAX package's `ServeEngine` at the same
setting, on the JAX `GPT.init` weights (matrices scaled by 12, so that
greedy streams vary from token to token) carried across with
`load_jax_params`.

* greedy tokens: exactly JAX's, at quantized_weights int8 and int4 and
  kv_dtype None (the param dtype) and int8 — the quantized leaves are
  bitwise JAX's (tests/test_torch_quant_codec.py) and dequantize to the
  same fp32 values, so the two forwards differ only in the order of fp32
  sums;
* prefill logits, fp32: within 1e-5;
* the engine's quantized store: every matrix leaf (ndim >= 2) quantized
  at block 256, vectors exact, and `dequantize_params(quantize_params(w))`
  equal to JAX's, leaf for leaf.

The kernels themselves are held against their plain versions on the card
by tests/test_torch_quant_codec.py's cuda cases and chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepspeed_tpu_torch.models import GPT, gpt2_config  # noqa: E402
from deepspeed_tpu_torch.models import load_jax_params  # noqa: E402
from deepspeed_tpu_torch.serving import (ServeConfig,  # noqa: E402
                                         ServeEngine, programs)

torch.set_num_threads(1)

VOCAB = 64
MAX_SEQ = 64
BS = 4
MODEL = dict(num_layers=2, num_heads=4, d_model=32, vocab_size=VOCAB,
             max_seq_len=MAX_SEQ)
_CACHE = {}


def _pair():
    """(jax model, jax params, port model) on one set of weights."""
    if "pair" not in _CACHE:
        import jax

        from deepspeed_tpu.models import GPT as JaxGPT
        from deepspeed_tpu.models import gpt2_config as jax_gpt2_config

        jmodel = JaxGPT(jax_gpt2_config("nano", **MODEL))
        # matrices scaled up from the init's std 0.02, so that greedy
        # streams vary from token to token (at the init's scale each
        # stream repeats one token, and quantization would not show)
        jparams = jax.tree_util.tree_map(
            lambda a: a * 12.0 if a.ndim >= 2 else a,
            jmodel.init(jax.random.PRNGKey(4)))
        model = GPT(gpt2_config("nano", **MODEL), device="cpu")
        load_jax_params(model, jax.tree_util.tree_map(np.asarray, jparams))
        _CACHE["pair"] = (jmodel, jparams, model)
    return _CACHE["pair"]


def _cfg(**over):
    base = dict(block_size=BS, num_blocks=40, max_batch=3, prefill_chunk=8,
                max_seq_len=MAX_SEQ)
    base.update(over)
    return base


def _prompts(seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, VOCAB, (n,)).tolist() for n in (5, 11, 17)]


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_greedy_serving_from_quantized_weights_matches_jax(wire, kv):
    from deepspeed_tpu import serving as jserving

    jmodel, jparams, model = _pair()
    prompts = _prompts()
    want = jserving.ServeEngine(jmodel, jparams, jserving.ServeConfig(
        **_cfg(quantized_weights=wire, kv_dtype=kv))).generate(prompts, 10)
    eng = ServeEngine(model, ServeConfig(**_cfg(quantized_weights=wire,
                                                kv_dtype=kv)), device="cpu")
    assert isinstance(eng.model, programs.QuantizedWeights)
    assert eng.generate(prompts, 10) == want
    # the weights changed the tokens: the dense model serves others
    dense = ServeEngine(model, ServeConfig(**_cfg(kv_dtype=kv)),
                        device="cpu").generate(prompts, 10)
    assert dense != want


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_prefill_logits_from_quantized_weights_match_jax(wire):
    import jax.numpy as jnp

    from deepspeed_tpu import serving as jserving

    jmodel, jparams, model = _pair()
    jeng = jserving.ServeEngine(jmodel, jparams, jserving.ServeConfig(
        **_cfg(quantized_weights=wire)))
    eng = ServeEngine(model, ServeConfig(**_cfg(quantized_weights=wire)),
                      device="cpu")
    tokens = np.zeros((1, 8), np.int64)
    tokens[0, :6] = _prompts(1)[1][:6]
    table = np.arange(1, 1 + MAX_SEQ // BS)
    _, want, _ = jeng.programs["prefill"](
        jeng.params, jeng.kv.caches, jnp.asarray(tokens, jnp.int32),
        np.int32(0), np.int32(6), jnp.asarray(table, jnp.int32),
        np.float32(0.0), np.int32(0), np.uint32(0))
    _, got = programs.prefill(eng.model, eng.kv.caches, eng.schedule,
                              tokens, 0, 6, table, 0.0, 0, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_quantized_store_matches_jax_leaf_for_leaf(wire):
    import jax

    from deepspeed_tpu.serving.programs import \
        dequantize_params as jdequantize_params
    from deepspeed_tpu.serving.programs import \
        quantize_params as jquantize_params
    from deepspeed_tpu_torch.models.convert import flatten_tree

    _, jparams, model = _pair()
    q = programs.quantize_params(dict(model.named_parameters()), wire, 256)
    for name, node in q.items():
        p = dict(model.named_parameters())[name]
        assert isinstance(node, programs.QuantLeaf) == (p.dim() >= 2), name
    want = flatten_tree(jax.tree_util.tree_map(
        np.asarray, jdequantize_params(jquantize_params(jparams, wire, 256),
                                       wire, 256)))
    got = programs.dequantize_params(q, wire)
    for name, t in got.items():
        assert t.dtype == torch.float32 and t.shape == want[name].shape
        assert np.array_equal(t.numpy(), want[name]), name
    store = programs.QuantizedWeights(model, wire)
    dense = sum(p.numel() * 4 for p in model.parameters())
    assert store.nbytes() < dense / (3 if wire == "int8" else 5)
    # the programs' reads: one layer's weights, and those outside the blocks
    blk, outer = store.layer(1), store.outer()
    for name, t in got.items():
        part = blk if name.startswith("blocks.1.") else outer
        if name.startswith("blocks.") and part is outer:
            continue
        for attr in name.split(".")[2 if part is blk else 0:]:
            part = getattr(part, attr)
        assert torch.equal(part, t), name
    assert not hasattr(blk, "wte") and not hasattr(outer, "blocks")


@pytest.mark.parametrize("program", ["prefill", "decode"])
def test_each_forward_dequantizes_every_matrix_once(program, monkeypatch):
    """A forward asks the store for each layer once and for the weights
    outside the blocks once: every matrix leaf is dequantized exactly once
    a forward (4 a layer, wte and wpe; the head is tied)."""
    _, _, model = _pair()
    eng = ServeEngine(model, ServeConfig(**_cfg(quantized_weights="int8")),
                      device="cpu")
    real, seen = programs.dequantize_blockwise, []

    def counted(payload, scales, wire, n, **kw):
        seen.append(n)
        return real(payload, scales, wire, n, **kw)

    monkeypatch.setattr(programs, "dequantize_blockwise", counted)
    table = np.arange(1, 1 + MAX_SEQ // BS)
    if program == "prefill":
        tokens = np.zeros((1, 8), np.int64)
        programs.prefill(eng.model, eng.kv.caches, eng.schedule, tokens, 0,
                         6, table, 0.0, 0, 0)
    else:
        R = eng.schedule.max_batch
        programs.decode(eng.model, eng.kv.caches, eng.schedule,
                        np.zeros(R, np.int64), np.zeros(R, np.int64),
                        np.ones(R, bool), np.tile(table, (R, 1)),
                        np.zeros(R), np.zeros(R, np.int64),
                        np.zeros(R, np.int64))
    leaves = [p for p in model.parameters() if p.dim() >= 2]
    assert len(seen) == len(leaves) == 4 * MODEL["num_layers"] + 2
    assert sorted(seen) == sorted(p.numel() for p in leaves)


def test_quantized_weights_validation():
    with pytest.raises(ValueError, match="quantized_weights must be"):
        ServeConfig(quantized_weights="int2")
    _, _, model = _pair()
    sched = programs.ServeSchedule(max_batch=1, prefill_chunk=8,
                                   block_size=BS, num_blocks=4,
                                   table_width=16, quantized="fp8")
    with pytest.raises(ValueError, match="must be one of"):
        programs.prepare_params(model, sched)

"""Port parity: HuggingFace interop (deepspeed_tpu_torch/models/hf.py)
against the JAX package's `models/hf.py` and against `transformers`.

Tiny `GPT2LMHeadModel` / `BertForPreTraining` are built in code from
config objects with seeded random weights (no download).  Tolerances,
with their reasons:

* the imported trees: bitwise, leaf for leaf — both sides read the same
  fp32 values and transpose / concatenate them, no arithmetic;
* logits (fp32): atol 2e-5 against HF and against JAX — the same
  functions with sums in other orders through two layers (logits ~1);
* the cross-framework curve (`tests/model/test_torch_parity.py`'s
  oracle, HF GPT-2 with torch.optim.Adam, imported, not edited): that
  file's bounds — fp32 2e-3 relative over the first 50 steps, 2e-2 over
  all 200, the last loss below 0.6x the first; fp16 with dynamic loss
  scaling within 0.15 relative, as the JAX engine is held there.
"""

import importlib.util
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("USE_TF", "0")   # transformers without TensorFlow
transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu.models import hf as jhf  # noqa: E402
from deepspeed_tpu_torch.models import hf  # noqa: E402
from deepspeed_tpu_torch.models.convert import flatten_tree  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gpt2(tie=True, **over):
    cfg = transformers.GPT2Config(
        vocab_size=96, n_positions=64, n_embd=32, n_layer=2, n_head=2,
        attn_pdrop=0.0, embd_pdrop=0.0, resid_pdrop=0.0,
        tie_word_embeddings=tie, **over)
    torch.manual_seed(0)
    m = transformers.GPT2LMHeadModel(cfg).eval()
    if not tie:
        with torch.no_grad():   # an lm_head of its own values
            m.lm_head.weight.copy_(torch.randn_like(m.lm_head.weight) * 0.02)
    return m


def _bert(**over):
    kw = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=64,
              max_position_embeddings=64, hidden_act="gelu_new",
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    kw.update(over)
    torch.manual_seed(1)
    m = transformers.BertForPreTraining(transformers.BertConfig(**kw)).eval()
    with torch.no_grad():   # nonzero biases and LayerNorm affines
        for n, p in m.named_parameters():
            if n.endswith("bias") or "LayerNorm" in n:
                p.add_(torch.randn_like(p) * 0.05)
    return m


def _np_sd(m):
    return {k: v.detach().float().numpy() for k, v in m.state_dict().items()}


def _assert_trees_bitwise(jtree, ttree):
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, jtree))
    got = flatten_tree(ttree)
    assert set(want) == set(got)
    for n in want:
        assert got[n].dtype == torch.float32, n
        assert np.array_equal(got[n].detach().numpy(), want[n]), n


@pytest.mark.parametrize("tie", [True, False])
def test_gpt2_tree_is_jax_bitwise(tie):
    m = _gpt2(tie)
    jcfg = jhf.gpt2_config_from_hf(m.config)
    cfg = hf.gpt2_config_from_hf(m.config)
    assert cfg.tie_embeddings == jcfg.tie_embeddings == tie
    sd = _np_sd(m)
    jtree = jhf.hf_gpt2_state_dict_to_params(sd, jcfg)
    # tensors and numpy arrays alike
    _assert_trees_bitwise(jtree, hf.hf_gpt2_state_dict_to_params(sd, cfg))
    _assert_trees_bitwise(jtree, hf.hf_gpt2_state_dict_to_params(
        m.state_dict(), cfg))
    model, params = hf.load_hf_gpt2(m, device="cpu")
    _assert_trees_bitwise(jtree, params)
    _assert_trees_bitwise(jtree, dict(model.named_parameters()))


def test_gpt2_logits_match_hf_and_jax():
    m = _gpt2()
    model, _ = hf.load_hf_gpt2(m, device="cpu")
    jmodel, jparams = jhf.load_hf_gpt2(m)
    toks = np.random.RandomState(0).randint(0, 96, (2, 17))
    with torch.no_grad():
        want = m(torch.from_numpy(toks)).logits.numpy()
        got = model.apply(toks).numpy()
    jgot = np.asarray(jmodel.apply(jparams, jnp.asarray(toks)))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, jgot, atol=2e-5, rtol=0)


def test_bert_tree_is_jax_bitwise_and_logits_match():
    m = _bert()
    _, jparams = jhf.load_hf_bert(m, compute_dtype=jnp.float32)
    model, params = hf.load_hf_bert(m, device="cpu",
                                    compute_dtype=torch.float32)
    _assert_trees_bitwise(jparams, params)
    _assert_trees_bitwise(jparams, hf.hf_bert_state_dict_to_params(
        _np_sd(m), model.config))
    assert model.config.pre_layer_norm is False
    rs = np.random.RandomState(2)
    ids = rs.randint(0, 128, (2, 16))
    tt = (np.arange(16)[None] >= 8).astype(np.int64).repeat(2, 0)
    mask = np.ones((2, 16), np.int64)
    mask[1, 12:] = 0
    with torch.no_grad():
        out = m(input_ids=torch.from_numpy(ids),
                token_type_ids=torch.from_numpy(tt),
                attention_mask=torch.from_numpy(mask))
        mlm, nsp = model.apply({"input_ids": ids, "token_type_ids": tt,
                                "attention_mask": mask})
    np.testing.assert_allclose(mlm.numpy(), out.prediction_logits.numpy(),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(nsp.numpy(),
                               out.seq_relationship_logits.numpy(),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("over,match", [
    (dict(activation_function="relu"), "activation_function"),
    (dict(scale_attn_by_inverse_layer_idx=True),
     "scale_attn_by_inverse_layer_idx"),
    (dict(reorder_and_upcast_attn=True), "reorder_and_upcast_attn"),
])
def test_gpt2_refusals_raise_as_jax(over, match):
    cfg = transformers.GPT2Config(n_embd=32, n_layer=1, n_head=2, **over)
    for mod in (jhf, hf):
        with pytest.raises(ValueError, match=match):
            mod.gpt2_config_from_hf(cfg)


@pytest.mark.parametrize("over,match", [
    (dict(hidden_act="relu"), "hidden_act"),
    (dict(position_embedding_type="relative_key"), "absolute"),
])
def test_bert_config_refusals_raise_as_jax(over, match):
    cfg = transformers.BertConfig(hidden_size=32, num_attention_heads=2,
                                  **over)
    for mod in (jhf, hf):
        with pytest.raises(ValueError, match=match):
            mod.bert_config_from_hf(cfg)


def test_untied_bert_decoder_and_dropout_mismatch_as_jax(caplog):
    m = _bert(tie_word_embeddings=False)
    with pytest.raises(ValueError, match="untied MLM decoder"):
        jhf.load_hf_bert(m)
    with pytest.raises(ValueError, match="untied MLM decoder"):
        hf.load_hf_bert(m, device="cpu")
    cfg = transformers.GPT2Config(n_embd=32, n_layer=1, n_head=2,
                                  attn_pdrop=0.1, resid_pdrop=0.2)
    logging.getLogger("deepspeed_tpu_torch").propagate = True
    with caplog.at_level(logging.WARNING):
        got = hf.gpt2_config_from_hf(cfg)
    assert got.dropout == 0.2 == jhf.gpt2_config_from_hf(cfg).dropout
    assert "attn_pdrop=0.1 != resid_pdrop=0.2" in caplog.text


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_hf_test", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synthetic_state_dicts_have_hf_keys_and_shapes():
    """chip_smoke's seeded numpy state dicts (the card machine has no
    transformers) carry exactly the weights of the transformers models
    of the same configs (GPT-2's attn.bias / masked_bias buffers are not
    weights and are never read)."""
    cs = _load_chip_smoke()
    g = _gpt2()
    sd = cs.hf_gpt2_numpy_state_dict(g.config.to_dict(), seed=0)
    want = {k: tuple(v.shape) for k, v in g.state_dict().items()
            if not k.endswith((".attn.bias", ".attn.masked_bias"))}
    assert {k: v.shape for k, v in sd.items()} == want
    b = _bert()
    sd = cs.hf_bert_numpy_state_dict(b.config.to_dict(), seed=0)
    want = {k: tuple(v.shape) for k, v in b.state_dict().items()
            if not k.endswith("position_ids")}
    assert {k: v.shape for k, v in sd.items()} == want


def test_numpy_state_dict_path_needs_no_transformers():
    """In a fresh interpreter where transformers cannot be imported, a
    numpy state dict under HF's names and a config dict import into the
    port's GPT and BERT."""
    code = f"""
import sys
sys.modules["transformers"] = None
sys.path.insert(0, {REPO!r})
import numpy as np
from deepspeed_tpu_torch.models import load_hf_gpt2, load_hf_bert
import importlib.util
spec = importlib.util.spec_from_file_location("cs", {REPO!r} + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec); spec.loader.exec_module(cs)
g = dict(vocab_size=96, n_positions=64, n_embd=32, n_layer=2, n_head=2)
m, p = load_hf_gpt2(cs.hf_gpt2_numpy_state_dict(g, seed=0), config=g,
                    device="cpu")
b = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
         num_attention_heads=2, intermediate_size=64,
         max_position_embeddings=64, type_vocab_size=2,
         hidden_act="gelu_new")
bm, bp = load_hf_bert(cs.hf_bert_numpy_state_dict(b, seed=0), config=b,
                      device="cpu")
assert "transformers" not in [k for k, v in sys.modules.items() if v]
print(sum(x.numel() for x in m.parameters()),
      sum(x.numel() for x in bm.parameters()))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    n_gpt, n_bert = map(int, r.stdout.split())
    assert n_gpt == sum(p.numel() for p in _gpt2().parameters())
    assert n_bert > 0


# -- the cross-framework curve ------------------------------------------------


def _parity_module():
    spec = importlib.util.spec_from_file_location(
        "torch_parity_oracle",
        os.path.join(REPO, "tests", "model", "test_torch_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def parity():
    mod = _parity_module()
    return mod, mod.torch_curve()


def _port_curve(mod, precision):
    model, _ = hf.load_hf_gpt2(mod._hf_model(), device="cpu")
    config = {
        "train_batch_size": mod.BATCH,
        "optimizer": {"type": "Adam",
                      "params": {"lr": mod.LR, "betas": (0.9, 0.999),
                                 "eps": 1e-8, "weight_decay": 0.0}},
        "steps_per_print": 0,
    }
    if precision == "fp16":
        config["fp16"] = {"enabled": True, "initial_scale_power": 8,
                          "loss_scale_window": 100}
    eng, *_ = dt.initialize(model=model, config_params=config, device="cpu")
    losses = []
    for tok in mod._data():
        losses.append(float(eng.forward((tok[:, :-1], tok[:, 1:]))))
        eng.backward()
        eng.step()
    return np.asarray(losses)


def test_port_engine_follows_the_hf_torch_curve_fp32(parity):
    mod, oracle = parity
    ours = _port_curve(mod, "fp32")
    rel = np.abs(ours - oracle) / np.maximum(np.abs(oracle), 1e-6)
    assert rel[:50].max() < 2e-3, f"early divergence: {rel[:50].max():.2e}"
    assert rel.max() < 2e-2, f"diverged: max rel {rel.max():.2e}"
    assert ours[-1] < 0.6 * ours[0]


def test_port_engine_follows_the_hf_torch_curve_fp16(parity):
    mod, oracle = parity
    ours = _port_curve(mod, "fp16")
    rel = np.abs(ours - oracle) / np.maximum(np.abs(oracle), 1e-6)
    assert rel.max() < 0.15, f"fp16 diverged: max rel {rel.max():.2e}"
    assert ours[-1] < 0.6 * ours[0]

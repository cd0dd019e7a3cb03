"""Port parity: kernel injection over parameter trees
(deepspeed_tpu_torch/module_inject) against the JAX package's
`module_inject/replace_module.py`, and the injected layer against
`transformers`' BertLayer.

Tolerances, with their reasons:

* replace / revert: bitwise, leaf for leaf, in both layouts — both sides
  transpose, concatenate and split the same values, no arithmetic;
* the injected layer's forward against HF's BertLayer (fp32, post-LN,
  gelu_new, eval): atol 2e-5 — the same function with sums in other
  orders (activations ~1 after the LayerNorm).
"""

import importlib
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

# the package exports a function of the module's name
jri = importlib.import_module("deepspeed_tpu.module_inject.replace_module")
from deepspeed_tpu.ops.transformer.transformer import \
    DeepSpeedTransformerConfig as JaxLayerConfig  # noqa: E402
from deepspeed_tpu_torch.models.convert import (flatten_tree,  # noqa: E402
                                                unflatten_tree)
from deepspeed_tpu_torch.module_inject import (FUSED_KEYS,  # noqa: E402
                                               HFBertLayerPolicy,
                                               replace_transformer_layer,
                                               revert_transformer_layer)
from deepspeed_tpu_torch.ops.transformer.transformer import (  # noqa: E402
    DeepSpeedTransformerConfig, transformer_layer_forward)

torch.set_num_threads(1)

H, F, LAYERS = 32, 64, 2


def _layer(rs, torch_layout):
    """One BERT layer's subtree, [out, in] `weight`s (torch) or [in, out]
    `kernel`s with `scale`d LayerNorms (flax)."""
    def dense(i, o):
        w = rs.randn(i, o).astype(np.float32)
        b = rs.randn(o).astype(np.float32)
        return ({"weight": w.T.copy(), "bias": b} if torch_layout
                else {"kernel": w, "bias": b})

    def ln():
        w = (1 + 0.1 * rs.randn(H)).astype(np.float32)
        b = (0.1 * rs.randn(H)).astype(np.float32)
        return {"weight" if torch_layout else "scale": w, "bias": b}

    return {"attention": {"self": {"query": dense(H, H), "key": dense(H, H),
                                   "value": dense(H, H)},
                          "output": {"dense": dense(H, H),
                                     "LayerNorm": ln()}},
            "intermediate": {"dense": dense(H, F)},
            "output": {"dense": dense(F, H), "LayerNorm": ln()}}


def _tree(torch_layout):
    rs = np.random.RandomState(3)
    return {"bert": {"encoder": {"layer": [_layer(rs, torch_layout)
                                           for _ in range(LAYERS)]},
                     "pooler": {"dense": {"kernel": rs.randn(H, H).astype(
                         np.float32)}}},
            "step": np.asarray(7, np.int32)}


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _assert_bitwise(want_tree, got_tree):
    want, got = _flat_np(want_tree), flatten_tree(got_tree)
    assert set(want) == set(got)
    for k in want:
        g = got[k].numpy() if torch.is_tensor(got[k]) else np.asarray(got[k])
        assert g.shape == want[k].shape and np.array_equal(g, want[k]), k


@pytest.mark.parametrize("torch_layout", [False, True])
def test_replace_and_revert_are_jax_bitwise(torch_layout):
    tree = _tree(torch_layout)
    jnew, jcfg, jpaths = jri.replace_transformer_layer(
        jri.HFBertLayerPolicy(torch_layout=torch_layout), tree,
        JaxLayerConfig(hidden_size=H, heads=2))
    cfg = DeepSpeedTransformerConfig(hidden_size=H, heads=2)
    new, cfg, paths = replace_transformer_layer(
        HFBertLayerPolicy(torch_layout=torch_layout), tree, cfg)
    assert paths == jpaths == [("bert", "encoder", "layer", i)
                               for i in range(LAYERS)]
    assert cfg.pre_layer_norm is False and jcfg.pre_layer_norm is False
    assert set(new["bert"]["encoder"]["layer"][0]) == set(FUSED_KEYS)
    _assert_bitwise(jnew, new)
    # and back: the family layout, bitwise the input
    policy = HFBertLayerPolicy(torch_layout=torch_layout)
    back = revert_transformer_layer(policy, new)
    _assert_bitwise(jri.revert_transformer_layer(
        jri.HFBertLayerPolicy(torch_layout=torch_layout), jnew), back)
    _assert_bitwise(tree, back)


def test_strict_zero_match_raises_and_non_strict_logs(caplog):
    tree = {"blocks": [{"attn": {"w": np.zeros((2, 2), np.float32)}}]}
    policy = HFBertLayerPolicy()
    with pytest.raises(NotImplementedError, match="recognized NO"):
        replace_transformer_layer(policy, tree)
    with pytest.raises(NotImplementedError, match="recognized NO"):
        jri.replace_transformer_layer(jri.HFBertLayerPolicy(), tree)
    logging.getLogger("deepspeed_tpu_torch").propagate = True
    with caplog.at_level(logging.WARNING):
        new, cfg, paths = replace_transformer_layer(policy, tree,
                                                    strict=False)
    assert paths == [] and cfg is None
    assert "UNCHANGED" in caplog.text
    _assert_bitwise(tree, new)


def test_injected_layer_matches_the_hf_bert_layer():
    os.environ.setdefault("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    from transformers.models.bert.modeling_bert import BertLayer

    hcfg = transformers.BertConfig(
        hidden_size=H, num_attention_heads=2, intermediate_size=F,
        hidden_act="gelu_new", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, layer_norm_eps=1e-12)
    hcfg._attn_implementation = "eager"
    torch.manual_seed(0)
    layer = BertLayer(hcfg).eval()
    with torch.no_grad():
        for p in layer.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    tree = unflatten_tree({k: v.detach().clone()
                           for k, v in layer.state_dict().items()})
    cfg = DeepSpeedTransformerConfig(hidden_size=H, intermediate_size=F,
                                     heads=2, attn_dropout_ratio=0.0,
                                     hidden_dropout_ratio=0.0,
                                     dtype=torch.float32)
    fused, cfg, paths = replace_transformer_layer(
        HFBertLayerPolicy(torch_layout=True), tree, cfg)
    assert paths == [()]
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 16, H).astype(
        np.float32))
    keep = torch.ones(2, 16)
    keep[1, 10:] = 0
    bias = (1.0 - keep[:, None, None, :]) * torch.finfo(torch.float32).min
    with torch.no_grad():
        want = layer(x, attention_mask=bias)[0]
        got = transformer_layer_forward(fused, x, bias, config=cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)

"""Port parity: GPT parameters, the JAX weight import and layer_norm
(deepspeed_tpu_torch/models/)."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepspeed_tpu.models import GPT as JaxGPT  # noqa: E402
from deepspeed_tpu.models import gpt2_config as jax_gpt2_config  # noqa: E402
from deepspeed_tpu.models.gpt import layer_norm as jax_layer_norm  # noqa: E402
from deepspeed_tpu_torch.models import (GPT, gpt2_config,  # noqa: E402
                                        layer_norm, load_jax_params)
from deepspeed_tpu_torch.models.convert import flatten_tree  # noqa: E402

torch.set_num_threads(1)

# (size, overrides): nano as shipped, GPT-2 small width cut to 2 layers
# and a small vocabulary, and an untied head (the `lm_head` parameter)
CONFIGS = {
    "nano": ("nano", {}),
    "small-width": ("small", dict(num_layers=2, vocab_size=512,
                                  max_seq_len=64)),
    "nano-untied": ("nano", dict(tie_embeddings=False)),
}


def _pair(name, seed=0):
    size, over = CONFIGS[name]
    jmodel = JaxGPT(jax_gpt2_config(size, **over))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(seed)))
    model = GPT(gpt2_config(size, **over), device="cpu")
    return tree, model


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_load_jax_params_fills_every_parameter_exactly(name):
    tree, model = _pair(name)
    load_jax_params(model, tree)
    flat = flatten_tree(tree)
    params = dict(model.named_parameters())
    assert set(params) == set(flat)
    for k, p in params.items():
        np.testing.assert_array_equal(p.detach().numpy(), flat[k], err_msg=k)


def test_load_jax_params_rejects_missing_extra_and_misshaped_keys():
    tree, model = _pair("nano")
    missing = dict(tree)
    del missing["wpe"]
    with pytest.raises(KeyError, match="missing \\['wpe'\\]"):
        load_jax_params(model, missing)
    extra = dict(tree, lm_head=np.zeros((48, 256), np.float32))
    with pytest.raises(KeyError, match="extra \\['lm_head'\\]"):
        load_jax_params(model, extra)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["blocks"][1]["attn"]["qkv"]["w"] = np.zeros((48, 48), np.float32)
    before = model.wte.detach().clone()
    with pytest.raises(ValueError, match="blocks.1.attn.qkv.w"):
        load_jax_params(model, bad)
    # nothing was written before the check failed
    assert torch.equal(model.wte.detach(), before)


def test_load_jax_params_bf16_tree():
    size, over = CONFIGS["nano"]
    jmodel = JaxGPT(jax_gpt2_config(size, param_dtype=jnp.bfloat16))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(0)))
    model = GPT(gpt2_config(size, param_dtype=torch.bfloat16), device="cpu")
    load_jax_params(model, tree)
    np.testing.assert_array_equal(
        model.blocks[2].mlp.fc1.w.detach().float().numpy(),
        tree["blocks"][2]["mlp"]["fc1"]["w"].astype(np.float32))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_has_jax_tree_names_shapes_and_scales(name):
    tree, model = _pair(name)
    flat = flatten_tree(tree)
    assert {k: tuple(p.shape) for k, p in model.named_parameters()} == \
        {k: tuple(np.shape(v)) for k, v in flat.items()}
    cfg = model.config
    # equal in distribution: stds within 15% of the JAX init's
    # (the smallest drawn matrix has 48*144 entries)
    for k, p in model.named_parameters():
        want = float(np.std(flat[k]))
        got = float(p.detach().float().std())
        if want == 0.0:
            assert got == 0.0, k
        else:
            assert abs(got - want) < 0.15 * want, (k, got, want)
    assert abs(float(model.blocks[0].attn.proj.w.detach().std()) -
               0.02 / np.sqrt(2 * cfg.num_layers)) < 0.003


def test_init_is_seeded_by_the_generator():
    cfg = gpt2_config("nano")
    a = GPT(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    b = GPT(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    c = GPT(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    assert torch.equal(a.wte, b.wte)
    assert not torch.equal(a.wte, c.wte)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-6),
                                        ("bfloat16", 2e-2)])
def test_layer_norm_matches_jax(dtype, atol):
    """fp32: the same fp32 arithmetic, sums in another order (atol 1e-6
    on outputs of size ~3).  bf16: both compute in fp32 and round the
    output to bf16 — at most one bf16 ulp apart (2^-7 at size ~3)."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 7, 48).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(48)).astype(np.float32)
    bias = (0.1 * rng.randn(48)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_layer_norm(jnp.asarray(x, jd),
                          {"scale": jnp.asarray(scale, jd),
                           "bias": jnp.asarray(bias, jd)}, 1e-5)
    p = types.SimpleNamespace(scale=torch.from_numpy(scale).to(td),
                              bias=torch.from_numpy(bias).to(td))
    got = layer_norm(torch.from_numpy(x).to(td), p, 1e-5)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def test_unsupported_configs_raise():
    # MoE layers are ported: every other block holds `moe` for `mlp`
    moe = GPT(gpt2_config("nano", num_experts=4), device="cpu")
    assert [hasattr(b, "moe") for b in moe.blocks] == [False, True, False]
    with pytest.raises(NotImplementedError, match="pipeline"):
        GPT(gpt2_config("nano", pipeline_stages=2), device="cpu")
    with pytest.raises(NotImplementedError, match="sequence parallelism"):
        GPT(gpt2_config("nano", sequence_parallel=True), device="cpu")
    with pytest.raises(TypeError, match="torch dtype"):
        gpt2_config("nano", param_dtype=jnp.float32)

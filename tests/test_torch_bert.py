"""Port parity: the fused transformer layer and BERT pretraining
(deepspeed_tpu_torch/ops/transformer/transformer.py,
deepspeed_tpu_torch/models/bert.py) against the JAX package on shared
weights and batches, and the engine's loss curves against the JAX
engine's.

Weights: the JAX init trees, as numpy, loaded into the port with
`load_jax_params` (or adopted by the layer).  Sparse layers use a
FixedSparsityConfig (no random blocks) at block 16; the kernel walk is
forced on both sides with JAX's `kernel_config(ops={"sparse_attention":
"pallas"}, interpret=True)` and the port's `kernel_config`.  Dropout is off
wherever the two packages are compared (JAX draws its seeds with
threefry).  Tolerances, with their reasons:

* fp32 layer outputs: atol 2e-5, rtol 2e-4 — the same fp32 arithmetic,
  sums in another order (tests/test_transformer_layer.py:71);
* fp32 losses: atol 1e-5 (loss ~6, a few ulps); fp32 gradients: 1e-4 of
  each leaf's largest |grad| — reductions in another order through two
  layers of backward (tests/test_torch_train.py);
* bf16 loss: atol 1e-2 and gradients 5e-2 of the leaf's largest |grad| —
  activations rounded to bf16 (2^-8 relative) at places that differ
  between XLA and PyTorch, compounded over two layers and the MLM head;
* engine curves: fp32 per-step loss atol 1e-5, final weights 1e-4; bf16
  per-step loss atol 5e-3 (tests/test_torch_train.py);
* a module's own recomputation (remat, checkpoint flags): bitwise.
"""

import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu_torch.kernels import registry  # noqa: E402
from deepspeed_tpu_torch.models import (Bert, bert_config,  # noqa: E402
                                        load_jax_params)
from deepspeed_tpu_torch.models.convert import flatten_tree  # noqa: E402
from deepspeed_tpu_torch.monitor.counters import COUNTERS  # noqa: E402
from deepspeed_tpu_torch.ops import sparse_attention as tsa  # noqa: E402
from deepspeed_tpu_torch.ops.transformer import \
    transformer as ttr  # noqa: E402
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig  # noqa: E402

torch.set_num_threads(1)

HID, HEADS, SEQ, BLK = 128, 2, 64, 16


@pytest.fixture(scope="module")
def jx():
    import importlib

    jax = pytest.importorskip("jax")
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy,
        tr=importlib.import_module("deepspeed_tpu.ops.transformer.transformer"),
        sp=importlib.import_module("deepspeed_tpu.ops.sparse_attention"),
        models=importlib.import_module("deepspeed_tpu.models"),
        reg=importlib.import_module("deepspeed_tpu.kernels.registry"),
        ds=importlib.import_module("deepspeed_tpu"))


def _sparsity(pkg):
    return pkg.FixedSparsityConfig(num_heads=HEADS, block=BLK,
                                   num_local_blocks=2, num_global_blocks=1)


# -- the fused layer -----------------------------------------------------------


def _layer_cfgs(jx, sparse, **kw):
    base = dict(batch_size=2, hidden_size=HID, heads=HEADS,
                max_seq_length=SEQ, intermediate_size=4 * HID,
                attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0,
                num_hidden_layers=2, initializer_range=0.02)
    base.update(kw)
    j = jx.tr.DeepSpeedTransformerConfig(
        dtype=jx.jnp.float32, sparsity_config=_sparsity(jx.sp) if sparse
        else None, **base)
    t = ttr.DeepSpeedTransformerConfig(
        dtype=torch.float32, sparsity_config=_sparsity(tsa) if sparse
        else None, **base)
    return j, t


def _mask_bias(masked, B=2):
    """The BERT additive mask [B, 1, 1, S] (bert.py:199) or None."""
    if not masked:
        return None
    keep = np.ones((B, SEQ), np.float32)
    keep[1, -20:] = 0
    return ((1.0 - keep[:, None, None, :]) *
            np.finfo(np.float32).min).astype(np.float32)


def _layer_both(jx, jcfg, tcfg, masked, seed=0):
    jax, jnp = jx.jax, jx.jnp
    params = jax.tree_util.tree_map(np.asarray, jx.tr.init_transformer_params(
        jcfg, jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed + 1)
    x = rs.randn(2, SEQ, HID).astype(np.float32)
    g = rs.randn(2, SEQ, HID).astype(np.float32)
    bias = _mask_bias(masked)

    def jf(p, x):
        out = jx.tr.transformer_layer_forward(
            p, x, None if bias is None else jnp.asarray(bias), config=jcfg,
            train=True)
        return jnp.sum(out * g), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(jf, argnums=(0, 1),
                                               has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    tout = ttr.transformer_layer_forward(
        tp, tx, None if bias is None else torch.from_numpy(bias),
        config=tcfg, train=True)
    (tout * torch.from_numpy(g)).sum().backward()
    grads = {k: (np.asarray(jgp[k]), tp[k].grad.numpy()) for k in params}
    grads["x"] = (np.asarray(jgx), tx.grad.numpy())
    return np.asarray(jout), tout.detach().numpy(), grads


def _assert_grads(grads, tol):
    for name, (a, b) in grads.items():
        scale = np.abs(a).max() + 1e-12
        err = np.abs(a - b).max() / scale
        assert err <= tol, (name, err)


@pytest.mark.parametrize("pre_ln", [True, False])
@pytest.mark.parametrize("attn", ["dense", "sparse"])
@pytest.mark.parametrize("masked", [False, True])
def test_layer_matches_jax(jx, pre_ln, attn, masked):
    jcfg, tcfg = _layer_cfgs(jx, attn == "sparse", pre_layer_norm=pre_ln)
    jo, to, grads = _layer_both(jx, jcfg, tcfg, masked)
    np.testing.assert_allclose(to, jo, atol=2e-5, rtol=2e-4)
    _assert_grads(grads, 1e-4)


@pytest.mark.parametrize("attn", ["dense", "sparse"])
def test_layer_checkpoint_flags_match_jax(jx, attn):
    jcfg, tcfg = _layer_cfgs(jx, attn == "sparse", gelu_checkpoint=True,
                             attn_dropout_checkpoint=True,
                             normalize_invertible=True)
    jo, to, grads = _layer_both(jx, jcfg, tcfg, masked=True, seed=3)
    np.testing.assert_allclose(to, jo, atol=2e-5, rtol=2e-4)
    _assert_grads(grads, 1e-4)


@pytest.mark.parametrize("flags", [
    dict(gelu_checkpoint=True), dict(attn_dropout_checkpoint=True),
    dict(normalize_invertible=True)])
def test_layer_checkpoint_flags_recompute_the_same_masks(flags):
    """Under dropout, a recomputed half draws the seeds drawn before the
    layer: loss and gradients equal the unrecomputed layer's bitwise, on
    the sparse kernel walk (forced) as on the dense path."""
    for sparse in (False, True):
        out = []
        for fl in ({}, flags):
            cfg = ttr.DeepSpeedTransformerConfig(
                hidden_size=64, heads=2, attn_dropout_ratio=0.2,
                hidden_dropout_ratio=0.1, num_hidden_layers=2,
                dtype=torch.float32,
                sparsity_config=_sparsity(tsa) if sparse else None, **fl)
            layer = ttr.DeepSpeedTransformerLayer(
                cfg, device="cpu",
                generator=torch.Generator().manual_seed(0))
            x = torch.randn(2, SEQ, 64,
                            generator=torch.Generator().manual_seed(1))
            with registry.kernel_config(ops={"sparse_attention": "pallas"}):
                y = layer(x, generator=torch.Generator().manual_seed(5),
                          train=True)
            y.square().sum().backward()
            out.append((y.detach(), [p.grad for p in layer.parameters()]))
        assert torch.equal(out[0][0], out[1][0])
        for a, b in zip(out[0][1], out[1][1]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n", [6, 8])
def test_layer_adopts_initial_weights_as_jax(jx, n):
    jax = jx.jax
    jcfg, tcfg = _layer_cfgs(jx, False)
    base = jax.tree_util.tree_map(np.asarray, jx.tr.init_transformer_params(
        jcfg, jax.random.PRNGKey(4)))
    if n == 6:
        ws = [base[k] for k in ("attn_qkvw", "attn_ow", "attn_nw", "inter_w",
                                "output_w", "norm_w")]
        bs = [base[k] for k in ("attn_qkvb", "attn_ob", "attn_nb", "inter_b",
                                "output_b", "norm_b")]
    else:   # HF / torch nn.Linear layout: q, k, v split, [out, in]
        q, k, v = np.split(base["attn_qkvw"], 3, axis=-1)
        qb, kb, vb = np.split(base["attn_qkvb"], 3)
        ws = [q.T, k.T, v.T, base["attn_ow"].T, base["attn_nw"],
              base["inter_w"].T, base["output_w"].T, base["norm_w"]]
        bs = [qb, kb, vb, base["attn_ob"], base["attn_nb"], base["inter_b"],
              base["output_b"], base["norm_b"]]
    want = jx.tr.DeepSpeedTransformerLayer(jcfg, ws, bs).init(
        jax.random.PRNGKey(9))
    layer = ttr.DeepSpeedTransformerLayer(tcfg, [np.array(w) for w in ws],
                                          [np.array(b) for b in bs],
                                          device="cpu")
    for name, p in layer.params().items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(want[name]), err_msg=name)
    x = torch.randn(2, SEQ, HID)
    torch.testing.assert_close(
        layer(x, train=False),
        ttr.transformer_layer_forward(layer.params(), x, config=tcfg),
        atol=0, rtol=0)
    with pytest.raises(ValueError, match="want 6"):
        ttr.adopt_initial_params(ws[:5], bs[:5], device="cpu")


def test_layer_config_from_dict_and_json(tmp_path):
    d = dict(batch_size=8, hidden_size=128, heads=8, attn_dropout_ratio=0.1,
             hidden_dropout_ratio=0.1, num_hidden_layers=4,
             initializer_range=0.02, unknown_key_ignored=True)
    cfg = ttr.DeepSpeedTransformerConfig.from_dict(d)
    assert cfg.hidden_size == 128 and cfg.intermediate_size == 512
    assert cfg.dtype == torch.float32
    path = tmp_path / "layer.json"
    path.write_text(json.dumps(dict(d, fp16=True)))
    cfg = ttr.DeepSpeedTransformerConfig.from_json_file(str(path))
    assert cfg.dtype == torch.bfloat16 and cfg.heads == 8


def test_init_transformer_params_scales_like_jax(jx):
    """Equal in distribution (torch.Generator, not threefry): shapes,
    the adjusted output std 0.02/sqrt(2L), unit norms, zero biases."""
    jcfg, tcfg = _layer_cfgs(jx, False, num_hidden_layers=8)
    want = jx.tr.init_transformer_params(jcfg, jx.jax.random.PRNGKey(0))
    got = ttr.init_transformer_params(tcfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
    assert abs(got["attn_ow"].std().item() - 0.02 / 4) < 5e-4
    assert abs(got["inter_w"].std().item() - 0.02) < 1e-3
    assert (got["norm_w"] == 1).all() and (got["inter_b"] == 0).all()


# -- BERT ----------------------------------------------------------------------


def _bert_cfgs(jx, sparse, dtype="fp32", **kw):
    base = dict(num_layers=2, num_heads=HEADS, d_model=HID, vocab_size=512,
                max_seq_len=SEQ, attn_dropout=0.0, hidden_dropout=0.0)
    base.update(kw)
    jcfg = jx.models.bert_config(
        "bert-base", compute_dtype={"fp32": jx.jnp.float32,
                                   "bf16": jx.jnp.bfloat16}[dtype],
        sparsity_config=_sparsity(jx.sp) if sparse else None, **base)
    tcfg = bert_config(
        "bert-base", compute_dtype={"fp32": torch.float32,
                                   "bf16": torch.bfloat16}[dtype],
        sparsity_config=_sparsity(tsa) if sparse else None, **base)
    return jcfg, tcfg


def _bert_batch(masked, B=2, seed=0, vocab=512):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (B, SEQ)).astype(np.int32)
    labels = np.where(rs.rand(B, SEQ) < 0.15, ids, -100).astype(np.int32)
    batch = {"input_ids": ids,
             "token_type_ids": (np.arange(SEQ)[None] >= SEQ // 2)
             .astype(np.int32).repeat(B, 0),
             "mlm_labels": labels,
             "nsp_labels": rs.randint(0, 2, (B,)).astype(np.int32)}
    if masked:
        keep = np.ones((B, SEQ), np.int32)
        keep[-1, -24:] = 0
        batch["attention_mask"] = keep
    return batch


def _bert_models(jx, jcfg, tcfg, seed=0):
    jmodel = jx.models.Bert(jcfg)
    tree = jx.jax.tree_util.tree_map(
        np.asarray, jmodel.init(jx.jax.random.PRNGKey(seed)))
    model = Bert(tcfg, device="cpu")
    load_jax_params(model, tree)
    return jmodel, tree, model


def _bert_loss_and_grads(jx, sparse, masked, forced=False, dtype="fp32"):
    jax, jnp = jx.jax, jx.jnp
    jcfg, tcfg = _bert_cfgs(jx, sparse, dtype)
    jmodel, tree, model = _bert_models(jx, jcfg, tcfg)
    batch = _bert_batch(masked)
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    cparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt),
                                     tree)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def run_jax():
        return jax.value_and_grad(
            lambda p: jmodel.loss(p, jbatch, train=True))(cparams)

    masters = {n: p.detach().clone().requires_grad_()
               for n, p in model.named_parameters()}
    snap = COUNTERS.snapshot()
    if forced:
        if masked:
            # JAX's registry drops the mask when its kernel is forced by
            # kernel_config (SparseAttentionOp.pallas, registry.py:173-186;
            # ROADMAP queue 3's watch-list): its reference is the gather
            # path, which the port's forced module takes for biased calls
            jloss, jgrads = run_jax()
        else:
            with jx.reg.kernel_config(ops={"sparse_attention": "pallas"},
                                      interpret=True):
                jloss, jgrads = run_jax()
        with registry.kernel_config(ops={"sparse_attention": "pallas"}):
            loss = torch.func.functional_call(
                model, {n: p.to(tdt) for n, p in masters.items()}, (batch,),
                {"train": True})
    else:
        jloss, jgrads = run_jax()
        loss = torch.func.functional_call(
            model, {n: p.to(tdt) for n, p in masters.items()}, (batch,),
            {"train": True})
    loss.backward()
    calls = COUNTERS.delta_since(snap).get("kernel.fallbacks",
                                           {"calls": 0})["calls"]
    jg = flatten_tree(jax.tree_util.tree_map(
        lambda a: np.asarray(a).astype(np.float32), jgrads))
    tg = {n: p.grad.numpy() for n, p in masters.items()}
    return float(jloss), loss.item(), jg, tg, calls


@pytest.mark.parametrize("sparse,masked,forced", [
    (False, False, False), (False, True, False),
    (True, False, False), (True, True, False),
    (True, False, True), (True, True, True)])
def test_bert_loss_and_grads_match_jax(jx, sparse, masked, forced):
    jl, tl, jg, tg, fallbacks = _bert_loss_and_grads(jx, sparse, masked,
                                                     forced)
    assert abs(jl - tl) <= 1e-5, (jl, tl)
    assert set(jg) == set(tg)
    _assert_grads({n: (jg[n], tg[n]) for n in jg}, 1e-4)
    if sparse:
        # each of the 2 layers: the gather path (1 fallback a call), or
        # the forced kernel walk for a bias-free call (its 3 plain ops)
        walk = forced and not masked
        assert fallbacks == (6 if walk else 2), fallbacks


def test_bert_bf16_loss_and_grads_match_jax(jx):
    jl, tl, jg, tg, _ = _bert_loss_and_grads(jx, True, False, dtype="bf16")
    assert abs(jl - tl) <= 1e-2, (jl, tl)
    _assert_grads({n: (jg[n], tg[n]) for n in jg}, 5e-2)


def test_bert_apply_matches_jax(jx):
    jax, jnp = jx.jax, jx.jnp
    jcfg, tcfg = _bert_cfgs(jx, True)
    jmodel, tree, model = _bert_models(jx, jcfg, tcfg, seed=2)
    batch = _bert_batch(True, seed=3)
    jl, jn = jmodel.apply(jax.tree_util.tree_map(jnp.asarray, tree),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tl, tn = model.apply(batch)
    assert tl.shape == (2, SEQ, 512) and tn.shape == (2, 2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=2e-4)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=2e-5,
                               rtol=2e-4)


def test_bert_parameter_names_follow_the_jax_tree(jx):
    jcfg, tcfg = _bert_cfgs(jx, False)
    tree = jx.models.Bert(jcfg).init(jx.jax.random.PRNGKey(0))
    flat = flatten_tree(tree)
    model = Bert(tcfg, device="cpu")
    params = dict(model.named_parameters())
    assert set(flat) == set(params)
    for n, p in params.items():
        assert tuple(p.shape) == tuple(np.shape(flat[n])), n
    assert "layers.1.attn_qkvw" in params and "mlm_head.decoder_b" in params


def test_bert_remat_and_dropout_seeds_recompute_the_same_masks():
    """remat=True (torch.utils.checkpoint per layer) recomputes each
    layer with the seeds drawn before it: loss and gradients equal the
    unrematerialised run under dropout, through the forced kernel walk."""
    out = []
    for remat in (False, True):
        cfg = bert_config("bert-tiny", sparsity_config=_sparsity(tsa),
                          compute_dtype=torch.float32, attn_dropout=0.2,
                          hidden_dropout=0.1, remat=remat, max_seq_len=SEQ)
        model = Bert(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
        with registry.kernel_config(ops={"sparse_attention": "pallas"}):
            loss = model.loss(_bert_batch(False),
                              generator=torch.Generator().manual_seed(5))
        loss.backward()
        out.append((loss.item(), [p.grad.clone()
                                  for p in model.parameters()]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert float(model.loss(_bert_batch(False), train=False)) != \
            out[0][0]


def test_bert_config_checks():
    with pytest.raises(ValueError, match="multiple of num_heads"):
        bert_config("bert-base", num_heads=5)
    with pytest.raises(TypeError, match="torch dtype"):
        bert_config("bert-base", compute_dtype="bf16")
    cfg = bert_config("bert-large")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.d_ff,
            cfg.vocab_size) == (24, 1024, 16, 4096, 30528)
    assert cfg.layer_config().dtype == torch.bfloat16


# -- the engine -------------------------------------------------------------------


def _engine_config(prec, micro):
    """The JAX engine runs data-parallel over the test harness's 8 CPU
    devices (micro 1 each), the port's single process the same global
    batch of 8, as tests/test_torch_train.py does."""
    fp = {"fp32": {}, "bf16": {"bf16": {"enabled": True}}}
    return {"train_batch_size": 8,
            "train_micro_batch_size_per_gpu": micro,
            "optimizer": {"type": "Adam", "params": {"lr": 3e-3}},
            "zero_optimization": {"stage": 0},
            "steps_per_print": 0, "gradient_clipping": 1.0,
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_max_lr": 3e-3,
                                     "warmup_num_steps": 3}},
            "sparse_attention": {"mode": "fixed", "block": BLK,
                                 "num_local_blocks": 2},
            **fp[prec]}


@pytest.mark.parametrize("prec,tol", [("fp32", 1e-5), ("bf16", 5e-3)])
def test_engine_curve_matches_jax(jx, prec, tol):
    jcfg, tcfg = _bert_cfgs(jx, True, dtype=prec, d_model=64,
                            vocab_size=128)
    jmodel, tree, model = _bert_models(jx, jcfg, tcfg, seed=11)
    je, *_ = jx.ds.initialize(
        model=jmodel, model_parameters=tree,
        config_params=_engine_config(prec, 8 // jx.jax.device_count()))
    te, *_ = dt.initialize(model=Bert(tcfg, device="cpu"),
                           model_parameters=tree,
                           config_params=_engine_config(prec, 8),
                           device="cpu")
    assert te._config.sparse_attention == {"mode": "fixed", "block": BLK,
                                           "num_local_blocks": 2}
    losses = []
    for step in range(6):
        batch = _bert_batch(step % 2 == 1, B=8, seed=100 + step % 3,
                            vocab=128)
        pair = []
        for eng in (je, te):
            feed = ({k: jx.jnp.asarray(v) for k, v in batch.items()}
                    if eng is je else batch)
            pair.append(float(eng.forward(feed)))
            eng.backward()
            eng.step()
        losses.append(pair)
    losses = np.asarray(losses)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], atol=tol, rtol=0)
    assert losses[4, 1] < losses[0, 1]       # the same batch, trained on
    assert te.global_steps == je.global_steps == 6
    if prec == "fp32":
        want = flatten_tree(jx.jax.tree_util.tree_map(np.asarray, je.params))
        got = te.module_state_dict()
        for n in want:
            np.testing.assert_allclose(got[n], want[n], atol=1e-4, rtol=0,
                                       err_msg=n)


def test_config_stores_the_sparse_attention_section():
    base = {"train_batch_size": 2, "optimizer": {"type": "Adam"}}
    assert DeepSpeedConfig(base).sparse_attention is None
    section = {"mode": "bigbird", "block": 64, "num_random_blocks": 2}
    cfg = DeepSpeedConfig(dict(base, sparse_attention=section))
    assert cfg.sparse_attention == section


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the sparse flash kernels "
                    "run only on the card; on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_bert.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_sparse_bert_step_launches_each_kernel_once_a_layer(
        cuda_device):
    from deepspeed_tpu_torch.kernels import flash_sparse

    cfg = bert_config("bert-tiny", num_heads=2, d_model=128, max_seq_len=256,
                      sparsity_config=tsa.FixedSparsityConfig(
                          num_heads=2, block=128, num_local_blocks=2))
    model = Bert(cfg, device=cuda_device,
                 generator=torch.Generator(device=cuda_device).manual_seed(0))
    eng, *_ = dt.initialize(model=model, config_params={
        "train_batch_size": 2, "steps_per_print": 0, "bf16": {"enabled": True},
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}},
        device=cuda_device)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 512, (2, 256))
    batch = {"input_ids": ids,
             "mlm_labels": np.where(rs.rand(2, 256) < 0.15, ids, -100),
             "nsp_labels": np.array([0, 1])}
    n0 = dict(flash_sparse.LAUNCHES)
    loss = eng.forward(batch)
    eng.backward()
    eng.step()
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    assert {k: flash_sparse.LAUNCHES[k] - n0[k] for k in n0} == \
        {k: cfg.num_layers for k in n0}

"""HuggingFace interop — the port of deepspeed_tpu/models/hf.py.

The weights of a `transformers` GPT-2 or BERT become the parameter tree
the JAX package builds from them (hf.py:88, :166), as tensors, and
`models/convert.py` `load_jax_params` copies that tree into the port's
`GPT` / `Bert`; every engine feature then applies to the imported model.

Each loader takes a `transformers` model or a plain state dict of
tensors or numpy arrays under HF's key names, so a machine without
`transformers` imports a checkpoint too (the config then comes as a
`GPT2Config` / `BertConfig` object or a dict of its fields).  Values are
read as fp32 and cast to the config's `param_dtype`, as the JAX loaders
cast fp32 numpy.  Buffers that are not weights (`attn.bias`,
`attn.masked_bias` of older GPT-2 checkpoints) are never looked up.

Layouts: GPT-2's Conv1D stores `[in, out]`, this GPT's `x @ w`
convention, so it maps 1:1; BERT's `nn.Linear` stores `[out, in]` and is
transposed, its query / key / value concatenated in that order into the
fused layer's `attn_qkvw` (hf.py:187-205).  Stock BERT is post-LN
(`pre_layer_norm=False`).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..utils.logging import logger
from .convert import load_jax_params
from .gpt import GPT, GPTConfig


def _cfg_get(cfg, name, default=None):
    """A field of a transformers config object or of a plain dict."""
    if isinstance(cfg, dict):
        return cfg.get(name, default)
    return getattr(cfg, name, default)


def gpt2_config_from_hf(hf_config, **overrides) -> GPTConfig:
    """Map a transformers GPT2Config (or a dict of its fields) onto
    GPTConfig (hf.py:23).  Raises on HF options this architecture cannot
    represent: silently wrong logits are worse than a refusal."""
    act = _cfg_get(hf_config, "activation_function", "gelu_new")
    if act != "gelu_new":
        raise ValueError(
            f"activation_function={act!r} unsupported: gpt_block computes "
            f"gelu_new (tanh-approximate gelu) only")
    for flag in ("scale_attn_by_inverse_layer_idx",
                 "reorder_and_upcast_attn"):
        if _cfg_get(hf_config, flag, False):
            raise ValueError(f"GPT2Config.{flag} has no equivalent here")
    attn_p = _cfg_get(hf_config, "attn_pdrop", 0.0) or 0.0
    resid_p = _cfg_get(hf_config, "resid_pdrop", 0.0) or 0.0
    if attn_p != resid_p:
        logger.warning(
            f"GPT2Config attn_pdrop={attn_p} != resid_pdrop={resid_p}: "
            f"GPTConfig has one dropout knob (applied to attention probs "
            f"and residual paths); using resid_pdrop={resid_p}")
    n_embd = _cfg_get(hf_config, "n_embd")
    base = dict(
        vocab_size=_cfg_get(hf_config, "vocab_size"),
        max_seq_len=_cfg_get(hf_config, "n_positions"),
        num_layers=_cfg_get(hf_config, "n_layer"),
        num_heads=_cfg_get(hf_config, "n_head"),
        d_model=n_embd,
        d_ff=_cfg_get(hf_config, "n_inner", None) or 4 * n_embd,
        layer_norm_eps=_cfg_get(hf_config, "layer_norm_epsilon", 1e-5),
        dropout=resid_p,
        embed_dropout=_cfg_get(hf_config, "embd_pdrop", 0.0) or 0.0,
        tie_embeddings=_cfg_get(hf_config, "tie_word_embeddings", True),
    )
    base.update(overrides)
    return GPTConfig(**base)


def _fp32(v) -> torch.Tensor:
    """A state-dict value (tensor or numpy array) as an fp32 CPU tensor."""
    if torch.is_tensor(v):
        return v.detach().to(device="cpu", dtype=torch.float32)
    return torch.from_numpy(np.asarray(v, dtype=np.float32))


def _state_dict(hf_model_or_sd) -> Dict[str, Any]:
    """(state dict, the model's config or None) of a transformers model
    or a plain state dict."""
    if hasattr(hf_model_or_sd, "state_dict"):
        return hf_model_or_sd.state_dict(), hf_model_or_sd.config
    return dict(hf_model_or_sd), None


def load_hf_gpt2(hf_model, config=None, device="cuda", **config_overrides):
    """(GPT, params) from a transformers GPT2LMHeadModel, or from its
    state dict with `config` (a GPT2Config or a dict of its fields)
    (hf.py:71).  The GPT is built on `device` with the imported weights;
    `params` is the JAX-shaped tree they came from.

        hf = GPT2LMHeadModel(GPT2Config(...))      # no download
        model, params = load_hf_gpt2(hf, device="cpu")
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, ...)
    """
    sd, hf_cfg = _state_dict(hf_model)
    hf_cfg = config if config is not None else hf_cfg
    if hf_cfg is None:
        raise ValueError("load_hf_gpt2 of a state dict needs config=")
    cfg = gpt2_config_from_hf(hf_cfg, **config_overrides)
    params = hf_gpt2_state_dict_to_params(sd, cfg)
    model = GPT(cfg, device="meta")
    model = model.to_empty(device=device)
    load_jax_params(model, params)
    return model, params


def hf_gpt2_state_dict_to_params(sd: Dict[str, Any], cfg: GPTConfig):
    """Torch GPT-2 state dict (tensors or numpy) -> the GPT params tree
    of tensors in `cfg.param_dtype` (hf.py:88)."""
    g = lambda k: _fp32(sd[k]).to(cfg.param_dtype)  # noqa: E731

    def block(i):
        p = f"transformer.h.{i}."
        return {
            "ln1": {"scale": g(p + "ln_1.weight"),
                    "bias": g(p + "ln_1.bias")},
            "attn": {
                "qkv": {"w": g(p + "attn.c_attn.weight"),
                        "b": g(p + "attn.c_attn.bias")},
                "proj": {"w": g(p + "attn.c_proj.weight"),
                         "b": g(p + "attn.c_proj.bias")},
            },
            "ln2": {"scale": g(p + "ln_2.weight"),
                    "bias": g(p + "ln_2.bias")},
            "mlp": {
                "fc1": {"w": g(p + "mlp.c_fc.weight"),
                        "b": g(p + "mlp.c_fc.bias")},
                "fc2": {"w": g(p + "mlp.c_proj.weight"),
                        "b": g(p + "mlp.c_proj.bias")},
            },
        }

    params = {
        "wte": g("transformer.wte.weight"),
        "wpe": g("transformer.wpe.weight"),
        "blocks": [block(i) for i in range(cfg.num_layers)],
        "ln_f": {"scale": g("transformer.ln_f.weight"),
                 "bias": g("transformer.ln_f.bias")},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _fp32(sd["lm_head.weight"]).t().contiguous().to(
            cfg.param_dtype)
    return params


def bert_config_from_hf(hf_config, **overrides):
    """Map a transformers BertConfig (or a dict of its fields) onto
    BertConfig, post-LN (hf.py:126).  hidden_act "gelu" (erf) is taken
    with a warning: the encoder computes tanh-approximate gelu, the
    substitution the reference's kernel injection makes; "gelu_new"
    matches exactly; anything else is refused."""
    from .bert import BertConfig

    act = _cfg_get(hf_config, "hidden_act", "gelu")
    if act == "gelu":
        logger.warning(
            "HF hidden_act='gelu' (erf): encoder computes tanh-approx "
            "gelu — logits shift ~1e-3, the same substitution the "
            "reference kernel injection makes")
    elif act != "gelu_new":
        raise ValueError(f"hidden_act={act!r} unsupported (gelu/gelu_new)")
    if _cfg_get(hf_config, "position_embedding_type",
                "absolute") != "absolute":
        raise ValueError("only absolute position embeddings supported")
    base = dict(
        vocab_size=_cfg_get(hf_config, "vocab_size"),
        max_seq_len=_cfg_get(hf_config, "max_position_embeddings"),
        num_layers=_cfg_get(hf_config, "num_hidden_layers"),
        num_heads=_cfg_get(hf_config, "num_attention_heads"),
        d_model=_cfg_get(hf_config, "hidden_size"),
        d_ff=_cfg_get(hf_config, "intermediate_size"),
        type_vocab_size=_cfg_get(hf_config, "type_vocab_size", 2),
        layer_norm_eps=_cfg_get(hf_config, "layer_norm_eps", 1e-12),
        attn_dropout=_cfg_get(hf_config, "attention_probs_dropout_prob",
                              0.1),
        hidden_dropout=_cfg_get(hf_config, "hidden_dropout_prob", 0.1),
        pre_layer_norm=False,  # stock HF BERT is post-LN
    )
    base.update(overrides)
    return BertConfig(**base)


def hf_bert_state_dict_to_params(sd: Dict[str, Any], cfg):
    """Torch BertForPreTraining state dict -> the Bert params tree of
    tensors in `cfg.param_dtype` (the body of hf.py:166)."""
    g = lambda k: _fp32(sd[k]).to(cfg.param_dtype)  # noqa: E731
    # torch nn.Linear stores [out, in]
    gT = lambda k: _fp32(sd[k]).t().contiguous().to(  # noqa: E731
        cfg.param_dtype)

    def layer(i):
        p = f"bert.encoder.layer.{i}."
        qkv_w = torch.cat([_fp32(sd[p + f"attention.self.{m}.weight"]).t()
                           for m in ("query", "key", "value")], dim=1)
        qkv_b = torch.cat([_fp32(sd[p + f"attention.self.{m}.bias"])
                           for m in ("query", "key", "value")])
        return {
            "attn_qkvw": qkv_w.to(cfg.param_dtype),
            "attn_qkvb": qkv_b.to(cfg.param_dtype),
            "attn_ow": gT(p + "attention.output.dense.weight"),
            "attn_ob": g(p + "attention.output.dense.bias"),
            "attn_nw": g(p + "attention.output.LayerNorm.weight"),
            "attn_nb": g(p + "attention.output.LayerNorm.bias"),
            "inter_w": gT(p + "intermediate.dense.weight"),
            "inter_b": g(p + "intermediate.dense.bias"),
            "output_w": gT(p + "output.dense.weight"),
            "output_b": g(p + "output.dense.bias"),
            "norm_w": g(p + "output.LayerNorm.weight"),
            "norm_b": g(p + "output.LayerNorm.bias"),
        }

    D = cfg.d_model
    return {
        "embeddings": {
            "word": g("bert.embeddings.word_embeddings.weight"),
            "position": g("bert.embeddings.position_embeddings.weight"),
            "token_type": g("bert.embeddings.token_type_embeddings.weight"),
            "ln_w": g("bert.embeddings.LayerNorm.weight"),
            "ln_b": g("bert.embeddings.LayerNorm.bias"),
        },
        "layers": [layer(i) for i in range(cfg.num_layers)],
        # post-LN BERT has no final LN; identity values stay unused
        "final_ln_w": torch.ones((D,), dtype=cfg.param_dtype),
        "final_ln_b": torch.zeros((D,), dtype=cfg.param_dtype),
        "pooler": {"w": gT("bert.pooler.dense.weight"),
                   "b": g("bert.pooler.dense.bias")},
        "mlm_head": {
            "w": gT("cls.predictions.transform.dense.weight"),
            "b": g("cls.predictions.transform.dense.bias"),
            "ln_w": g("cls.predictions.transform.LayerNorm.weight"),
            "ln_b": g("cls.predictions.transform.LayerNorm.bias"),
            "decoder_b": g("cls.predictions.bias"),
        },
        "nsp_head": {"w": gT("cls.seq_relationship.weight"),
                     "b": g("cls.seq_relationship.bias")},
    }


def load_hf_bert(hf_model, config=None, device="cuda", **config_overrides):
    """(Bert, params) from a transformers BertForPreTraining, or from its
    state dict with `config` (a BertConfig or a dict of its fields)
    (hf.py:166): the encoder and the MLM / NSP heads, the decoder tied to
    the word embeddings (an untied decoder is refused)."""
    from .bert import Bert

    sd, hf_cfg = _state_dict(hf_model)
    hf_cfg = config if config is not None else hf_cfg
    if hf_cfg is None:
        raise ValueError("load_hf_bert of a state dict needs config=")
    if not _cfg_get(hf_cfg, "tie_word_embeddings", True):
        # Bert.apply computes MLM logits from embeddings.word.T — an
        # independent decoder matrix cannot be represented; refuse
        # rather than import silently wrong predictions
        raise ValueError(
            "untied MLM decoder (tie_word_embeddings=False) unsupported: "
            "the Bert family ties the decoder to the word embeddings")
    cfg = bert_config_from_hf(hf_cfg, **config_overrides)
    params = hf_bert_state_dict_to_params(sd, cfg)
    model = Bert(cfg, device="meta")
    model = model.to_empty(device=device)
    load_jax_params(model, params)
    return model, params

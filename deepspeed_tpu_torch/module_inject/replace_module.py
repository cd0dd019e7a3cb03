"""Kernel injection: swap a model's transformer layers for the fused
layer — the port of deepspeed_tpu/module_inject/replace_module.py.

As in the JAX package, injection is a pure transformation of a
parameter TREE (nested dicts and lists of tensors or numpy arrays): a
policy recognises one layer's subtree by its keys and converts it to the
fused layer's twelve tensors (`ops/transformer/transformer.py`, the
parameters of `DeepSpeedTransformerLayer` and of `Bert`'s layers), or
back.  The converted tree runs through `transformer_layer_forward`, the
flash kernels on the card.  No module is monkey-patched.

**Coverage contract (loud, never silent).**  One policy family is
implemented: `HFBertLayerPolicy` (HF / flax BERT encoder layers).  A walk
that recognises NOTHING is a caller error (a wrong tree layout, a model
family without a policy), so `replace_transformer_layer` raises
`NotImplementedError` when no layer matched; `strict=False` logs and
returns the tree unchanged.  Decoder / GPT-family checkpoints have no
injection policy: import them with `models/hf.py` (`load_hf_gpt2`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.transformer.transformer import DeepSpeedTransformerConfig
from ..utils.logging import logger

FUSED_KEYS = ("attn_qkvw", "attn_qkvb", "attn_ow", "attn_ob", "attn_nw",
              "attn_nb", "inter_w", "inter_b", "output_w", "output_b",
              "norm_w", "norm_b")


def _tensor(x) -> torch.Tensor:
    """A leaf as a tensor (numpy arrays are taken as they are)."""
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


class InjectionPolicy:
    """Recognise + convert one layer family.  Subclasses implement:

    matches(subtree) -> bool             does this dict hold one layer?
    convert(subtree) -> fused dict       -> transformer.py param names
    revert(fused) -> subtree             inverse mapping
    layer_config_overrides() -> dict     e.g. pre_layer_norm for the family
    """

    def matches(self, subtree: Dict[str, Any]) -> bool:
        raise NotImplementedError

    def convert(self, subtree: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    def revert(self, fused: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    def layer_config_overrides(self) -> Dict[str, Any]:
        return {}


def _dense(kernel, bias, transpose):
    k = _tensor(kernel)
    return (k.t() if transpose else k), _tensor(bias)


class HFBertLayerPolicy(InjectionPolicy):
    """HuggingFace BERT encoder layer (replace_module.py:70).

    Recognises the layout
      {attention: {self: {query,key,value}, output: {dense, LayerNorm}},
       intermediate: {dense}, output: {dense, LayerNorm}}
    with [in, out] kernels (torch_layout=True for the [out, in] weights of
    a torch state dict, `weight` / `bias` keys).  HF BERT is post-LN.
    """

    def __init__(self, torch_layout: bool = False):
        self.torch_layout = torch_layout

    @staticmethod
    def _get(d, *names):
        for n in names:
            if n in d:
                return d[n]
        raise KeyError(names)

    def matches(self, t) -> bool:
        try:
            return ("attention" in t and "intermediate" in t
                    and "output" in t and "self" in t["attention"])
        except TypeError:
            return False

    def _wb(self, d):
        w = self._get(d, "kernel", "weight")
        b = self._get(d, "bias")
        return _dense(w, b, self.torch_layout or "weight" in d)

    def _ln(self, d):
        return (_tensor(self._get(d, "scale", "weight", "gamma")),
                _tensor(self._get(d, "bias", "beta")))

    def convert(self, t):
        sa = t["attention"]["self"]
        qw, qb = self._wb(sa["query"])
        kw, kb = self._wb(sa["key"])
        vw, vb = self._wb(sa["value"])
        ow, ob = self._wb(t["attention"]["output"]["dense"])
        anw, anb = self._ln(t["attention"]["output"]["LayerNorm"])
        iw, ib = self._wb(t["intermediate"]["dense"])
        pw, pb = self._wb(t["output"]["dense"])
        nw, nb = self._ln(t["output"]["LayerNorm"])
        return {
            "attn_qkvw": torch.cat([qw, kw, vw], dim=-1),
            "attn_qkvb": torch.cat([qb, kb, vb], dim=-1),
            "attn_ow": ow, "attn_ob": ob,
            "attn_nw": anw, "attn_nb": anb,
            "inter_w": iw, "inter_b": ib,
            "output_w": pw, "output_b": pb,
            "norm_w": nw, "norm_b": nb,
        }

    def revert(self, fused):
        qw, kw, vw = _tensor(fused["attn_qkvw"]).chunk(3, dim=-1)
        qb, kb, vb = _tensor(fused["attn_qkvb"]).chunk(3, dim=-1)
        mk = (lambda w: w.t()) if self.torch_layout else (lambda w: w)
        kkey = "weight" if self.torch_layout else "kernel"
        skey = "weight" if self.torch_layout else "scale"
        dense = lambda w, b: {kkey: mk(_tensor(w)), "bias": _tensor(b)}  # noqa
        ln = lambda w, b: {skey: _tensor(w), "bias": _tensor(b)}  # noqa
        return {
            "attention": {
                "self": {"query": dense(qw, qb), "key": dense(kw, kb),
                         "value": dense(vw, vb)},
                "output": {"dense": dense(fused["attn_ow"], fused["attn_ob"]),
                           "LayerNorm": ln(fused["attn_nw"],
                                           fused["attn_nb"])},
            },
            "intermediate": {"dense": dense(fused["inter_w"],
                                            fused["inter_b"])},
            "output": {"dense": dense(fused["output_w"], fused["output_b"]),
                       "LayerNorm": ln(fused["norm_w"], fused["norm_b"])},
        }

    def layer_config_overrides(self):
        return {"pre_layer_norm": False}  # HF BERT is post-LN


def replace_module(params: Any, policy: InjectionPolicy,
                   _path: Tuple = ()) -> Tuple[Any, List[Tuple]]:
    """The generic walker (replace_module.py:153): descend the tree;
    whenever `policy.matches` a subtree, replace it with the converted
    fused dict.  Returns (new tree, the replaced paths)."""
    replaced = []
    if isinstance(params, dict):
        if policy.matches(params):
            return policy.convert(params), [_path]
        out = {}
        for key, sub in params.items():
            out[key], r = replace_module(sub, policy, _path + (key,))
            replaced.extend(r)
        return out, replaced
    if isinstance(params, (list, tuple)):
        out = []
        for i, sub in enumerate(params):
            new, r = replace_module(sub, policy, _path + (i,))
            out.append(new)
            replaced.extend(r)
        return type(params)(out), replaced
    return params, replaced


def replace_transformer_layer(policy: InjectionPolicy, params: Any,
                              config: Optional[DeepSpeedTransformerConfig]
                              = None, strict: bool = True):
    """replace_module.py:177.  Returns (new params, layer config, replaced
    paths): every recognised layer subtree converted to fused-layer
    parameters, and `config` with the family's overrides applied (post-LN
    for HF BERT).  No recognised layer raises (`strict=True`) or logs and
    passes the tree through unchanged (`strict=False`)."""
    new_params, replaced = replace_module(params, policy)
    if not replaced:
        msg = (f"kernel injection: {type(policy).__name__} recognized NO "
               f"layer subtree in the given params — either the tree "
               f"layout does not match the policy, or this model family "
               f"has no injection policy (only HF BERT encoder layers "
               f"are covered; for GPT-family checkpoints convert the "
               f"weights via deepspeed_tpu_torch.models.hf instead — the "
               f"supported path for the engine and for "
               f"deepspeed_tpu_torch.serving)")
        if strict:
            raise NotImplementedError(msg)
        logger.warning(msg + "; strict=False: returning the params "
                       "UNCHANGED (no layer runs the fused kernel)")
    if config is not None:
        for k, v in policy.layer_config_overrides().items():
            setattr(config, k, v)
    return new_params, config, replaced


def revert_transformer_layer(policy: InjectionPolicy, params: Any):
    """Inverse of replace_transformer_layer (replace_module.py:211): fused
    dicts -> the family's layout."""

    def walk(t):
        if isinstance(t, dict):
            if all(k in t for k in FUSED_KEYS):
                return policy.revert(t), 1
            out, n = {}, 0
            for key, sub in t.items():
                out[key], m = walk(sub)
                n += m
            return out, n
        if isinstance(t, (list, tuple)):
            outs, n = [], 0
            for sub in t:
                new, m = walk(sub)
                outs.append(new)
                n += m
            return type(t)(outs), n
        return t, 0

    reverted, _n = walk(params)
    return reverted

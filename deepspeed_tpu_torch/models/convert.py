"""Carry weights from the JAX package into the port.

`load_jax_params(model, tree)` takes the JAX GPT params pytree as nested
dicts and lists of numpy arrays (on the JAX side:
`jax.tree_util.tree_map(np.asarray, params)`) and copies every leaf into
the module parameter of the same dotted path.  The weight layout is the
same on both sides (`[in, out]`), so each copy is a plain one; dtypes
convert to the module's.  An MoE block's leaves (`blocks.i.moe.gate.w`,
`blocks.i.moe.experts.{w1,b1,w2,b2}`, stacked over the experts) come
across the same way.  A missing key, an extra key or a shape
mismatch raises before anything is written.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts/lists -> {"blocks.3.attn.qkv.w": leaf, ...}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _to_tensor(leaf) -> torch.Tensor:
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        # numpy has no native bfloat16 (JAX hands out ml_dtypes' type):
        # reinterpret the bits
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))   # a writable copy


def load_jax_params(model: nn.Module, tree) -> nn.Module:
    """Copy every leaf of the JAX params `tree` into `model` (in place);
    returns the model."""
    flat = flatten_tree(tree)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise KeyError(
            f"params tree does not match the module: missing {missing}, "
            f"extra {extra}")
    for name, p in params.items():
        shape = tuple(np.shape(flat[name]))
        if shape != tuple(p.shape):
            raise ValueError(
                f"{name}: tree leaf has shape {shape}, module parameter "
                f"{tuple(p.shape)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(_to_tensor(flat[name]))
    return model

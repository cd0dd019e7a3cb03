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

The other direction, for checkpoints the JAX engine reads:
`unflatten_tree` rebuilds the nested dicts and lists from dotted names
(a node whose keys are exactly 0..n-1 is a list, as `GPT.init` builds
`blocks` and `Bert.init` builds `layers`; gpt.py:446, bert.py:102), and
`opt_state_to_jax` / `opt_state_from_jax` carry the optimizer's
per-parameter lists (FusedAdam's `exp_avg` / `exp_avg_sq`,
fused_adam.py:43-49 on both sides) to and from trees of the same shape,
by name; every other entry (`step`) goes across as it is.

Expert parallelism: under the explicit MoE wire a rank holds only its
El = E / ep experts of each expert leaf (`is_expert_leaf`: a MoE
block's `experts.{w1,b1,w2,b2}`, stacked on dim 0).
`slice_expert_leaves` cuts a whole tree (a JAX params tree, a
checkpoint's module tree) to a rank's experts, rank `index` holding
experts [index·El, (index+1)·El), the JAX NamedSharding of the expert
dim.

ZeRO-Infinity: `groups_from_jax` takes JAX's stream groups (`stream_groups`
over a JAX params tree) to the port's, the nested dicts `GPT.stream_groups`
makes, and `jax_ordered_leaves` lists a group's leaves in JAX's order, the
order the streamed runtime keys its Adam state and checkpoint leaves by.
"""

from __future__ import annotations

import re
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


def unflatten_tree(flat: Dict[str, Any]) -> Any:
    """Inverse of `flatten_tree`: {"blocks.3.attn.qkv.w": leaf, ...} ->
    nested dicts, with lists where the keys are 0..n-1."""
    root: Dict[str, Any] = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and set(out) == {str(i) for i in range(len(out))}:
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)


def jax_leaf_order(names) -> list:
    """Indices into `names` in the order `jax.tree_util.tree_flatten`
    visits the tree `unflatten_tree` builds from them: dict keys sorted,
    list items in index order (the JAX gradient tree's leaf order, which
    the bucketed gradient wire fills its buckets in)."""
    tree = unflatten_tree({n: i for i, n in enumerate(names)})
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list):
            for v in node:
                walk(v)
        else:
            out.append(node)

    walk(tree)
    return out


def jax_ordered_leaves(tree) -> list:
    """[(dotted name, leaf)] of a nested tree in `jax.tree_util`'s leaf
    order (dict keys sorted, list items in index order)."""
    flat = flatten_tree(tree)
    names = list(flat)
    return [(names[i], flat[names[i]]) for i in jax_leaf_order(names)]


def groups_from_jax(groups) -> list:
    """JAX's stream groups (`GPT.stream_groups` of a JAX params tree, or
    `stream_init`'s) -> the port's: the same names and nesting, each leaf
    an fp32 CPU tensor (bf16 leaves are widened exactly)."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _to_tensor(node).float()

    return [(name, conv(tree)) for name, tree in groups]


def opt_state_to_jax(names, state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's optimizer state ({key: list over `names` | other}) ->
    the JAX tree ({key: params-shaped tree | other})."""
    return {k: unflatten_tree(dict(zip(names, v)))
            if isinstance(v, (list, tuple)) and len(v) == len(names) else v
            for k, v in state.items()}


def opt_state_from_jax(names, tree: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of `opt_state_to_jax`: a params-shaped entry becomes the
    list of its leaves in `names` order (a missing or extra leaf
    raises)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            flat = flatten_tree(v)
            if set(flat) != set(names):
                raise KeyError(
                    f"optimizer state {k!r} does not match the module: "
                    f"missing {sorted(set(names) - set(flat))}, extra "
                    f"{sorted(set(flat) - set(names))}")
            v = [flat[n] for n in names]
        out[k] = v
    return out


_EXPERT_LEAF = re.compile(r"(^|\.)experts\.(w1|b1|w2|b2)$")


def is_expert_leaf(name: str) -> bool:
    """A MoE block's stacked expert leaf (`...moe.experts.w1` etc.)."""
    return _EXPERT_LEAF.search(name) is not None


def slice_expert_leaves(tree, ep: int, index: int):
    """`tree` (nested dicts/lists) with each expert leaf cut to experts
    [index·El, (index+1)·El) of its leading dim, El = E / ep; the other
    leaves as they are."""
    flat = flatten_tree(tree)
    for name, leaf in flat.items():
        if is_expert_leaf(name):
            n = int(np.shape(leaf)[0])
            if n % ep:
                raise ValueError(f"{name}: {n} experts do not split {ep} "
                                 f"ways")
            el = n // ep
            flat[name] = leaf[index * el:(index + 1) * el]
    return unflatten_tree(flat)


def _to_tensor(leaf) -> torch.Tensor:
    if torch.is_tensor(leaf):
        return leaf
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

"""TiledLinear — the port of deepspeed_tpu/runtime/zero/tiling.py
(:24-126; the reference's zero/tiling.py:26-294).

A big linear split into in_splits × out_splits tiles, each tile a
parameter of its own (`tiles.<o>.<i>.w`, [in_i, out_o] in the JAX
layout; `bias.<o>`), so the stage-3 plan shards each tile on its own
and a tile is a gather unit (runtime/zero/stage3.py): it is gathered
for its own product and again for that product's backward, never the
whole matrix at once.  The forward is a sum over input tiles of
per-output-tile products, optionally recomputed per output tile
(`remat_each_tile`, `torch.utils.checkpoint`); the math is one [in, out]
product's, summed in tile order.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...utils.device import resolve_device
from ..utils import partition_uniform
from . import stage3 as zero3


class _Tile(nn.Module):
    """One [in_i, out_o] tile: a stage-3 gather unit."""

    zero3_gather_unit = True

    def __init__(self, w):
        super().__init__()
        self.w = nn.Parameter(w)


class TiledLinear(nn.Module):
    """`x @ W + b` over tiles of W.  `init_linear`: a {"w": [in, out],
    "b": [out]} dict (the JAX layout) or an `nn.Linear` whose weight and
    bias are cut into the tiles; otherwise each tile is drawn
    N(0, 1/in_features) from `generator` and the bias is zero (JAX's
    init, equal in distribution).  `linear_cls` and other keywords are
    accepted for API parity."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, in_splits: int = 1, out_splits: int = 1,
                 input_is_already_split: bool = False,
                 combine_out_splits: bool = True, linear_cls=None,
                 init_linear=None, remat_each_tile: bool = False,
                 device="cuda", dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        if in_splits < 1 or out_splits < 1:
            raise RuntimeError("in and out splits must be >= 1")
        self.in_features = in_features
        self.out_features = out_features
        self.use_bias = bias
        self.in_splits = in_splits
        self.out_splits = out_splits
        self.input_is_already_split = input_is_already_split
        self.combine_out_splits = combine_out_splits
        self.remat_each_tile = remat_each_tile
        # row/col boundaries (reference uses partition_uniform too, :80-92)
        self.in_parts = partition_uniform(in_features, in_splits)
        self.out_parts = partition_uniform(out_features, out_splits)
        dev = resolve_device(device)
        w = b = None
        if isinstance(init_linear, nn.Linear):
            w = init_linear.weight.detach().t()
            b = None if init_linear.bias is None else \
                init_linear.bias.detach()
        elif init_linear is not None:
            w = torch.as_tensor(init_linear["w"])
            b = init_linear.get("b")
            b = None if b is None else torch.as_tensor(b)
        if w is None:
            gen = generator or torch.Generator(device=dev).manual_seed(0)
            w = torch.randn((in_features, out_features), generator=gen,
                            device=dev) * (1.0 / in_features) ** 0.5
        # bias=True with no 'b' supplied: zero-init (silently dropping the
        # requested bias would change the model)
        if b is None:
            b = torch.zeros(out_features)
        self.tiles = nn.ModuleList(
            nn.ModuleList(
                _Tile(w[self.in_parts[i]:self.in_parts[i + 1],
                        self.out_parts[o]:self.out_parts[o + 1]]
                      .to(device=dev, dtype=dtype).clone())
                for i in range(in_splits))
            for o in range(out_splits))
        if bias:
            self.bias = nn.ParameterList(
                nn.Parameter(b[self.out_parts[o]:self.out_parts[o + 1]]
                             .to(device=dev, dtype=dtype).clone())
                for o in range(out_splits))

    def _split_input(self, x):
        return [x[..., self.in_parts[i]:self.in_parts[i + 1]]
                for i in range(self.in_splits)]

    def _tile_row(self, o, remat, *xs):
        acc = None
        for i, tile in enumerate(self.tiles[o]):
            with zero3.gathered(tile, remat=remat) as scope:
                y = scope.output(xs[i] @ tile.w.to(xs[i].dtype))
            acc = y if acc is None else acc + y
        return acc

    def forward(self, x):
        xs = x if self.input_is_already_split else self._split_input(x)
        if len(xs) != self.in_splits:
            raise RuntimeError(
                f"expected {self.in_splits} input tiles, got {len(xs)}")
        remat = self.remat_each_tile and torch.is_grad_enabled()
        outs = []
        for o in range(self.out_splits):
            if remat:
                y = checkpoint(self._tile_row, o, True, *xs,
                               use_reentrant=False)
            else:
                y = self._tile_row(o, False, *xs)
            if self.use_bias:
                y = y + self.bias[o].to(y.dtype)
            outs.append(y)
        if self.combine_out_splits:
            return torch.cat(outs, dim=-1)
        return outs

    def full_weight(self):
        """The dense [in, out] matrix from the tiles (whole tiles: under
        stage 3, inside `GatheredParameters`)."""
        return torch.cat([torch.cat([t.w for t in row], dim=0)
                          for row in self.tiles], dim=1)

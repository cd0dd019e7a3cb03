"""Overflow check and gradient norms — the port of
deepspeed_tpu/runtime/utils.py:101-142, over lists of tensors (the leaves
of the JAX pytree), as multi-tensor `_foreach` reductions that stay on
the device."""

from __future__ import annotations

import torch


def has_overflow(grads):
    """Bool tensor: any grad is inf/nan.  The per-tensor max |g| is NaN
    or inf exactly when the tensor holds a NaN or an inf."""
    amax = torch._foreach_norm(grads, float("inf"))
    return torch.logical_not(torch.isfinite(torch.stack(amax)).all())


def global_grad_norm_sq(grads):
    """Sum of squared grad entries (fp32)."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.stack(norms).square().sum()


def clip_grad_norm(grads, max_norm: float, norm_sq=None):
    """Global-norm clipping as one scale (reference clip_grad_norm_
    semantics), applied to `grads` in place.  Returns (grads, pre-clip
    norm)."""
    if norm_sq is None:
        norm_sq = global_grad_norm_sq(grads)
    norm = torch.sqrt(norm_sq)
    scale = torch.clamp_max(max_norm / (norm + 1e-6), 1.0)
    torch._foreach_mul_(grads, scale)
    return grads, norm

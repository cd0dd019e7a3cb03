"""FusedLamb — the port of deepspeed_tpu/ops/lamb/fused_lamb.py.

LAMB with the per-tensor trust ratio (reference: deepspeed/ops/lamb/
fused_lamb.py + csrc/lamb/fused_lamb_cuda_kernel.cu): the Adam step
u = (m / bc1) / (sqrt(v / bc2) + eps) (+ wd·p), then
p - lr·trust·u with trust = ||p|| / ||u|| clamped to [min_coeff,
max_coeff], and 1 where either norm is 0 (fused_lamb.py:69-79).

A pure update over lists of fp32 tensors, in the JAX package's order of
operations, as `_foreach` ops: the moments and the Adam step a few
multi-tensor launches for the whole list, the norms one
`_foreach_norm`, the trust ratios one vector over the leaves.  The step
count, the bias corrections and the learning rate stay 0-dim device
tensors, so an update needs no host sync.  The TPU package has no Pallas
kernel here (XLA fused the pytree update).  The norms reduce in another
order than XLA's, so the port tracks JAX within float rounding, not bit
for bit.

The trust ratio reads whole leaves (`reads_whole_leaves`).  Under ZeRO
(or the MoE wire's local experts) the engine hands the update this
rank's slices and sets `norm_axes`: for each leaf, the mesh axis whose
ranks hold its other slices (None: the rank holds it whole).  The
slices' squared norms are then summed over that axis, so the ratio is
the whole leaf's, as JAX's over the global arrays.
"""

from __future__ import annotations

import torch

from ...comm import dist


class FusedLamb:
    """    state = opt.init(params)            # params: list of tensors
        new_params, new_state = opt.update(grads, state, params, lr=lr)
    """

    name = "FusedLamb"
    reads_whole_leaves = True

    def __init__(self, params=None, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, eps_inside_sqrt=False,
                 weight_decay=0.0, max_grad_norm=0.0, max_coeff=10.0,
                 min_coeff=0.01, amsgrad=False):
        if amsgrad:
            raise RuntimeError("FusedLamb does not support the AMSGrad variant.")
        self.defaults = dict(lr=lr, betas=betas, eps=eps,
                             weight_decay=weight_decay,
                             bias_correction=bias_correction,
                             max_coeff=max_coeff, min_coeff=min_coeff)
        self.param_groups = [dict(self.defaults)]
        self.eps_inside_sqrt = eps_inside_sqrt
        self.norm_axes = None    # the engine sets them for slices

    @property
    def lr(self):
        return self.param_groups[0]["lr"]

    def init(self, params):
        dev = params[0].device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "exp_avg": [torch.zeros_like(p, dtype=torch.float32)
                            for p in params],
                "exp_avg_sq": [torch.zeros_like(p, dtype=torch.float32)
                               for p in params]}

    def update(self, grads, state, params, lr=None):
        g0 = self.param_groups[0]
        dev = params[0].device
        lr = torch.as_tensor(g0["lr"] if lr is None else lr,
                             dtype=torch.float32, device=dev)
        step = state["step"] + 1
        bc1, bc2 = bias_corrections(step, g0)
        new_p, m, v, _ = lamb_update(
            [g.float() for g in grads], state["exp_avg"],
            state["exp_avg_sq"], [p.float() for p in params], lr, bc1, bc2,
            g0, self.eps_inside_sqrt, self.norm_axes)
        new_p = [n.to(p.dtype) for n, p in zip(new_p, params)]
        return new_p, {"step": step, "exp_avg": m, "exp_avg_sq": v}

    def state_dict(self):
        return {"param_groups": self.param_groups}

    def load_state_dict(self, sd):
        self.param_groups = sd["param_groups"]


def bias_corrections(step, group):
    """(1 - beta1^step, 1 - beta2^step) as 0-dim tensors on the step's
    device, or ones without bias correction."""
    if not group["bias_correction"]:
        one = torch.ones((), dtype=torch.float32, device=step.device)
        return one, one
    beta1, beta2 = group["betas"]
    return (1.0 - torch.pow(beta1, step.float()),
            1.0 - torch.pow(beta2, step.float()))


def lamb_update(grads, exp_avg, exp_avg_sq, p32, lr, bc1, bc2, group,
                eps_inside_sqrt, norm_axes=None):
    """One LAMB update over lists of fp32 tensors -> (new fp32 params,
    m, v, the trust ratios as one vector); `group` holds betas, eps,
    weight_decay, min_coeff and max_coeff."""
    beta1, beta2 = group["betas"]
    m = torch._foreach_mul(exp_avg, beta1)
    torch._foreach_add_(m, torch._foreach_mul(grads, 1.0 - beta1))
    tmp = torch._foreach_mul(grads, 1.0 - beta2)
    torch._foreach_mul_(tmp, grads)
    v = torch._foreach_mul(exp_avg_sq, beta2)
    torch._foreach_add_(v, tmp)
    del tmp
    step = adam_direction(m, v, bc1, bc2, group["eps"], eps_inside_sqrt)
    if group["weight_decay"]:
        torch._foreach_add_(step, torch._foreach_mul(
            p32, group["weight_decay"]))
    trust = trust_ratios(p32, step, group["min_coeff"], group["max_coeff"],
                         norm_axes)
    scale = list((lr * trust).unbind())
    new_p = torch._foreach_sub(p32, torch._foreach_mul(step, scale))
    return new_p, m, v, trust


def adam_direction(m, v, bc1, bc2, eps, eps_inside_sqrt):
    """(m / bc1) / denom, denom = sqrt(v / bc2) + eps, or sqrt(v / bc2 +
    eps) with eps_inside_sqrt (fused_lamb.py:64-68)."""
    denom = torch._foreach_div(v, bc2)
    if eps_inside_sqrt:
        torch._foreach_add_(denom, eps)
        torch._foreach_sqrt_(denom)
    else:
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
    out = torch._foreach_div(m, bc1)
    torch._foreach_div_(out, denom)
    return out


def _norms(ts, axes):
    """The leaves' L2 norms as one vector; a leaf with an axis in `axes`
    is a slice, whose squared norm is summed over that axis's ranks."""
    norms = torch.stack(torch._foreach_norm(ts))
    if axes is None:
        return norms
    # one collective an axis, in the same order on every rank
    for axis in dict.fromkeys(a for a in axes if a is not None):
        idx = torch.tensor([i for i, a in enumerate(axes) if a == axis],
                           device=norms.device)
        sq = norms.index_select(0, idx).square()
        norms = norms.index_copy(0, idx, dist.all_reduce(sq, axis).sqrt())
    return norms


def trust_ratios(p32, update, lo, hi, axes=None):
    """The per-tensor LAMB coefficients as one fp32 vector over the
    leaves: ||p|| / ||u|| clamped to [lo, hi], 1 where either norm is 0
    (fused_lamb.py:73-77).  `axes`: see the module docstring."""
    p_norm = _norms(p32, axes)
    u_norm = _norms(update, axes)
    trust = torch.where(u_norm > 0.0,
                        p_norm / torch.clamp_min(u_norm, 1e-12),
                        torch.ones_like(u_norm))
    trust = torch.where(p_norm > 0.0, trust, torch.ones_like(trust))
    return torch.clamp(trust, lo, hi)

"""FusedAdam — the port of deepspeed_tpu/ops/adam/fused_adam.py.

A pure update over lists of fp32 tensors, in the JAX package's order
(fused_adam.py:66-77): bias corrections from the step count,
m = b1·m + (1-b1)·g, v = b2·v + (1-b2)·g·g, denom = sqrt(v / bc2) + eps,
p - lr·(m / bc1) / denom, and the decoupled decay `lr·wd·p` taken from the
OLD parameter (AdamW mode, the default for both "Adam" and "AdamW").
`torch.optim.AdamW` is another function: it decays before the update.

The update is elementwise and runs as PyTorch's multi-tensor `_foreach`
ops, a few launches for the whole parameter list; the step count, the
bias corrections and the learning rate stay 0-dim device tensors, so an
update needs no host sync.  The TPU package had no Pallas kernel here
either (XLA fused the pytree update).
"""

from __future__ import annotations

import torch


class FusedAdam:
    """Adam with decoupled (AdamW, default) or L2 weight decay.

        state = opt.init(params)            # params: list of tensors
        new_params, new_state = opt.update(grads, state, params, lr=lr)
    """

    name = "FusedAdam"

    def __init__(self, params=None, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, adam_w_mode=True,
                 weight_decay=0.0, amsgrad=False, set_grad_none=True):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad variant.")
        self.defaults = dict(lr=lr, betas=betas, eps=eps,
                             weight_decay=weight_decay,
                             bias_correction=bias_correction)
        # param_groups kept for the schedulers (reference torch optim API)
        self.param_groups = [dict(self.defaults)]
        self.adam_w_mode = adam_w_mode
        self.set_grad_none = set_grad_none

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
        """Pure update; returns (new params, new state).  lr: a float or
        a 0-dim tensor (the scheduler's value), else the group's."""
        g0 = self.param_groups[0]
        dev = params[0].device
        lr = torch.as_tensor(g0["lr"] if lr is None else lr,
                             dtype=torch.float32, device=dev)
        beta1, beta2 = g0["betas"]
        eps, wd = g0["eps"], g0["weight_decay"]
        step = state["step"] + 1
        if g0["bias_correction"]:
            bc1 = 1.0 - torch.pow(beta1, step.float())
            bc2 = 1.0 - torch.pow(beta2, step.float())
        else:
            bc1 = bc2 = torch.ones((), dtype=torch.float32, device=dev)

        grads = [g.float() for g in grads]
        p32 = [p.float() for p in params]
        if not self.adam_w_mode and wd:
            grads = torch._foreach_add(grads, torch._foreach_mul(p32, wd))
        # the JAX update's arithmetic, op for op; the in-place forms keep at
        # most two parameter-sized temporaries alive at a time
        m = torch._foreach_mul(state["exp_avg"], beta1)
        tmp = torch._foreach_mul(grads, 1.0 - beta1)
        torch._foreach_add_(m, tmp)
        tmp = torch._foreach_mul(grads, 1.0 - beta2)
        torch._foreach_mul_(tmp, grads)
        v = torch._foreach_mul(state["exp_avg_sq"], beta2)
        torch._foreach_add_(v, tmp)
        del tmp
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_mul_(upd, lr)
        torch._foreach_div_(upd, denom)
        del denom
        new_p = torch._foreach_sub(p32, upd)
        del upd
        if self.adam_w_mode and wd:
            new_p = torch._foreach_sub(new_p, torch._foreach_mul(p32, lr * wd))
        new_p = [n.to(p.dtype) for n, p in zip(new_p, params)]
        return new_p, {"step": step, "exp_avg": m, "exp_avg_sq": v}

    # checkpoint parity -------------------------------------------------
    def state_dict(self):
        return {"param_groups": self.param_groups,
                "adam_w_mode": self.adam_w_mode}

    def load_state_dict(self, sd):
        self.param_groups = sd["param_groups"]
        self.adam_w_mode = sd.get("adam_w_mode", self.adam_w_mode)

"""1-bit LAMB — the port of deepspeed_tpu/runtime/fp16/onebit/lamb.py
(reference: deepspeed/runtime/fp16/onebit/lamb.py, arXiv:2104.06069).

* warm-up (step <= freeze_step): LAMB on the averaged gradients, the
  per-tensor trust ratios tracked by an EMA (`coeff_beta`);
* compression stage: the second moment and the LAMB coefficient are
  frozen and only the momentum is communicated, compressed with worker
  and server error feedback (`runtime/comm/compressed.py`); the frozen
  coefficient is scaled by sqrt(mean v_fresh / mean v), where v_fresh is
  a second moment rebuilt from the decompressed momentum's deltas,
  clamped to [factor_min, factor_max] and to within factor_threshold of
  the last factor.

As in JAX the reduction is per leaf (trust ratios are per leaf anyway),
one collective a leaf in leaf order, the same on every rank.  The
optimizer owns its data-parallel reduction (`handles_dp_reduction`, see
onebit/adam.py); the phase is decided on the host from the step count.
"""

from __future__ import annotations

import torch

from ....ops.lamb.fused_lamb import bias_corrections, lamb_update
from ...comm.compressed import pmean
from .adam import check_comm_backend, host_step, reduce_fn


class OnebitLamb:
    name = "OnebitLamb"
    handles_dp_reduction = True
    # the compressed statistics read the whole tree (no `norm_axes`):
    # the engine refuses to hand this optimizer slices
    reads_whole_leaves = True

    def __init__(self, params=None, deepspeed=None, lr=1e-3,
                 freeze_step=100000, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, eps_inside_sqrt=False,
                 weight_decay=0.0, max_grad_norm=0.0, max_coeff=10.0,
                 min_coeff=0.01, amsgrad=False, cuda_aware=False,
                 comm_backend_name="nccl", coeff_beta=0.9, factor_max=4.0,
                 factor_min=0.5, factor_threshold=0.1, wire="sign"):
        if amsgrad:
            raise RuntimeError("1-bit Lamb does not support AMSGrad")
        if wire not in ("sign", "int8"):
            raise ValueError(f"wire must be 'sign' or 'int8', got {wire!r}")
        check_comm_backend(comm_backend_name)
        self.wire = wire
        self.defaults = dict(lr=lr, betas=betas, eps=eps,
                             weight_decay=weight_decay,
                             bias_correction=bias_correction,
                             max_coeff=max_coeff, min_coeff=min_coeff)
        self.param_groups = [dict(self.defaults)]
        self.freeze_step = int(freeze_step)
        self.eps_inside_sqrt = eps_inside_sqrt
        self.coeff_beta = coeff_beta
        self.factor_max = factor_max
        self.factor_min = factor_min
        self.factor_threshold = factor_threshold

    @property
    def lr(self):
        return self.param_groups[0]["lr"]

    def init(self, params):
        dev = params[0].device
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32)  # noqa
                         for p in params]
        scal = lambda v: [torch.full((), v, dtype=torch.float32,  # noqa
                                     device=dev) for _ in params]
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "exp_avg": zeros(), "exp_avg_sq": zeros(),
                "exp_avg_sq_fresh": zeros(), "worker_error": zeros(),
                "server_error": zeros(),
                "lamb_coeff_freeze": scal(0.0), "last_factor": scal(1.0)}

    def update(self, grads, state, params, lr=None, comm_axis=None):
        g0 = self.param_groups[0]
        dev = params[0].device
        lr = torch.as_tensor(g0["lr"] if lr is None else lr,
                             dtype=torch.float32, device=dev)
        beta1, beta2 = g0["betas"]
        eps, wd = g0["eps"], g0["weight_decay"]
        step = state["step"] + 1
        keys = ("exp_avg", "exp_avg_sq", "exp_avg_sq_fresh", "worker_error",
                "server_error", "lamb_coeff_freeze", "last_factor")
        if host_step(state) <= self.freeze_step:
            # warm-up: LAMB on the mean gradients, one collective a leaf
            bc1, bc2 = bias_corrections(step, g0)
            new_p, m, v, trust = lamb_update(
                [pmean(g.float(), comm_axis) for g in grads],
                state["exp_avg"], state["exp_avg_sq"],
                [p.float() for p in params], lr, bc1, bc2, g0,
                self.eps_inside_sqrt)
            coeff = [self.coeff_beta * c + (1.0 - self.coeff_beta) * t
                     for c, t in zip(state["lamb_coeff_freeze"],
                                     trust.unbind())]
            out = dict(zip(keys, (m, v, list(v), state["worker_error"],
                                  state["server_error"], coeff,
                                  state["last_factor"])))
            return ([n.to(p.dtype) for n, p in zip(new_p, params)],
                    {"step": step, **out})
        reduce = reduce_fn(self.wire)
        out = {k: [] for k in keys}
        new_params = []
        for i, (p, grad) in enumerate(zip(params, grads)):
            m, v, v_fresh, we, se, coeff, lf = (state[k][i] for k in keys)
            m_local = beta1 * m + (1.0 - beta1) * grad.float()
            m_n, we_n, se_n = reduce(m_local, we, se, comm_axis)
            # a fresh second moment from the decompressed momentum's
            # delta (the reference's exp_avg_sq_fresh)
            g_est = (m_n - beta1 * m) / (1.0 - beta1)
            vf_n = beta2 * v_fresh + (1.0 - beta2) * g_est * g_est
            ratio = torch.sqrt((vf_n.mean() + eps) / (v.mean() + eps))
            factor = torch.clamp(ratio, self.factor_min, self.factor_max)
            factor = torch.minimum(
                torch.maximum(factor, lf * (1.0 - self.factor_threshold)),
                lf * (1.0 + self.factor_threshold))
            # the frozen coefficient and the constant denominator after
            # freeze (no bias corrections)
            step_ = m_n / (torch.sqrt(v) + eps)
            p32 = p.float()
            if wd:
                step_ = step_ + wd * p32
            new_params.append((p32 - lr * (coeff * factor) * step_)
                              .to(p.dtype))
            for k, t in zip(keys, (m_n, v, vf_n, we_n, se_n, coeff, factor)):
                out[k].append(t)
        return new_params, {"step": step, **out}

    def state_dict(self):
        return {"param_groups": [dict(g) for g in self.param_groups],
                "freeze_step": self.freeze_step}

    def load_state_dict(self, sd):
        if "param_groups" in sd:
            self.param_groups = [dict(g) for g in sd["param_groups"]]
        self.freeze_step = int(sd.get("freeze_step", self.freeze_step))

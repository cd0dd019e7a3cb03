"""The training step's stages — the port of the serial path of
deepspeed_tpu/runtime/step_builder.py (`apply_core` :319-359,
`micro_step` / `full_step` :371-405).

  prep   fp32 masters -> the compute-dtype replica (:223-232)
  grad   replica + micro batch -> fp32 gradients of the scaled loss
  apply  unscale by loss_scale·gas (with prescale/predivide), overflow
         check, clip, optimizer update, branchless skip on overflow for
         params and optimizer state, loss-scale update

The replica is each master cast with `.to(compute_dtype)`, and the module
runs on it through `torch.func.functional_call`; autograd through the
casts returns fp32 gradients on the masters — what `cast(grads, fp32)`
(:267) does.  JAX composes these into jitted programs; PyTorch runs them
eagerly, so the stages are closures over the engine that read and write
its state (the masters are updated in place, which saves a copy of the
parameters).  There is one composition: the gas == 1 `full` step and the
`micro` + `apply` pair; the JAX package's scan, overlap and 1-bit
compositions belong to later slices.
"""

from __future__ import annotations

import torch

from .utils import clip_grad_norm, has_overflow


def _select(overflow, new, old):
    """`where(overflow, old, new)` over a nest of dicts, lists and
    tensors (the branchless skip of the optimizer state), written into
    `new`'s tensors, which the update has just made."""
    if isinstance(new, dict):
        return {k: _select(overflow, new[k], old[k]) for k in new}
    if isinstance(new, (list, tuple)):
        return type(new)(_select(overflow, n, o) for n, o in zip(new, old))
    if torch.is_tensor(new):
        return torch.where(overflow, old, new, out=new)
    return new


class StepBuilder:
    """Builds the engine's step functions from its config and state."""

    def __init__(self, engine):
        self.engine = engine

    def build(self) -> dict:
        eng = self.engine
        model = eng.module
        names, masters = eng._param_names, eng._masters
        compute_dtype = eng.compute_dtype
        opt = eng.optimizer
        gas = eng.gradient_accumulation_steps()
        clip = float(eng._config.gradient_clipping or 0.0)
        prescale = eng._config.prescale_gradients
        predivide = float(eng._config.gradient_predivide_factor or 1.0)
        scaler = eng.loss_scaler

        def prep_params():
            """Master params -> the compute-side replica the loss reads."""
            return {n: p.to(compute_dtype) for n, p in zip(names, masters)}

        def run_loss(cparams, batch, generator, loss_scale):
            out = torch.func.functional_call(
                model, cparams, (batch,),
                {"generator": generator, "train": True})
            loss = out[0] if isinstance(out, tuple) else out
            scale_factor = loss_scale / predivide if prescale else loss_scale
            return loss.float() * scale_factor, loss

        def compute_grads(batch, generator, loss_scale):
            scaled, loss = run_loss(prep_params(), batch, generator,
                                    loss_scale)
            grads = torch.autograd.grad(scaled, masters, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, masters)]
            return grads, loss.detach()

        @torch.no_grad()
        def apply_core(grads, lr, gas_div):
            """Unscale -> overflow -> clip -> optimizer -> branchless
            skip -> loss-scale update.  Writes the masters in place;
            returns (overflow, grad_norm, new optimizer state, new scaler
            state)."""
            opt_state, scaler_state = eng._opt_state, eng._scaler_state
            loss_scale = scaler_state["cur_scale"]
            overflow = has_overflow(grads)
            denom = loss_scale * gas_div
            if prescale:
                denom = denom / predivide
            # the gradients are this step's own: unscaled and clipped in
            # place
            torch._foreach_div_(grads, denom)
            grad_norm = torch.zeros((), dtype=torch.float32,
                                    device=loss_scale.device)
            if clip > 0.0:
                grads, grad_norm = clip_grad_norm(grads, clip)
            # an async checkpoint's copies of the masters land first
            eng._wait_snapshot()
            new_params, new_opt = opt.update(grads, opt_state, list(masters),
                                             lr=lr)
            del grads
            # branchless skip-step on overflow (reference: step skipped,
            # scale halved — fp16/loss_scaler + stage2.py:1385-1404)
            for old, new in zip(masters, new_params):
                torch.where(overflow, old, new, out=old)
            new_opt = _select(overflow, new_opt, opt_state)
            new_scaler = scaler.jit_update(scaler_state, overflow)
            return overflow, grad_norm, new_opt, new_scaler

        def micro_step(batch, generator):
            """Gradients of one micro batch, added to the accumulator."""
            grads, loss = compute_grads(batch, generator,
                                        eng._scaler_state["cur_scale"])
            if eng._grad_acc is None:
                eng._grad_acc = grads
            else:
                torch._foreach_add_(eng._grad_acc, grads)
            return loss

        def apply_step(lr):
            """The boundary update over the accumulated gradients."""
            out = apply_core(eng._grad_acc, lr, gas_div=gas)
            eng._grad_acc = None
            return out

        def full_step(batch, generator, lr):
            """gas == 1: gradients and update of one batch, the gradients
            never kept past the call."""
            grads, loss = compute_grads(batch, generator,
                                        eng._scaler_state["cur_scale"])
            return (loss, *apply_core(grads, lr, gas_div=1))

        return {"micro": micro_step, "apply": apply_step, "full": full_step}

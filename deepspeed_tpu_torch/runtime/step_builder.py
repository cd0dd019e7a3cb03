"""The training step's stages — the port of the serial path of
deepspeed_tpu/runtime/step_builder.py (`implicit_grads`, the BucketPlan
path :267-310, `apply_core` :319-359, `micro_step` / `full_step`
:371-405).

  prep    fp32 masters -> the compute-dtype replica (:223-232)
  grad    replica + this rank's rows of the micro batch -> local fp32
          gradients of the scaled loss
  reduce  the data-parallel mean of the local gradients, down to the
          part this rank's optimizer partition owns: per leaf
          ("implicit": an all-reduce, or at ZeRO stage 2 a
          reduce-scatter to the owner's slice) or over the BucketPlan's
          buckets ("bucketed", runtime/comm/bucketing.py)
  apply   unscale by loss_scale·gas (with prescale/predivide), the
          overflow flag agreed by every rank, the clipping norm over the
          whole gradient, the optimizer update on this rank's partition,
          branchless skip on overflow, loss-scale update, then ONE
          all-gather of the updated slices in the compute dtype

The replica is each master cast with `.to(compute_dtype)`, and the module
runs on it through `torch.func.functional_call`; autograd through the
casts returns fp32 gradients on the masters — what `cast(grads, fp32)`
(:267) does.  Under ZeRO-Offload (`engine._offload`) the module's
parameters are the compute-dtype weights themselves (the fp32 masters
live on the host): their gradients are cast to fp32, accumulated over
the micro steps, and the engine's host step (`runtime/zero/offload.py`)
replaces `apply`.  JAX composes these into jitted programs; PyTorch runs them
eagerly, so the stages are closures over the engine that read and write
its state (the masters are updated in place).

Data parallelism (`engine._dp`, a process group is present): every rank
keeps every master in fp32 (of an expert leaf under the explicit MoE
wire, only its own experts: the zero plan's `local` leaves, whose
gradients the all-to-all's backward has already summed over the ranks,
so the reduce stage only divides them by dp, after a sum over
`data_outer` under inner placement); at ZeRO stage >= 1 a rank updates only the
slices its partition owns (`runtime/zero/partition.py`) and its Adam
moments are those slices' moments; the other ranks' slices come back in
the compute dtype, so they equal the owners' masters rounded as the next
forward reads them.  The gradient is the mean over ranks of each rank's
own loss gradient (JAX's bucketed path); with equal label counts per
rank that is the gradient of the global batch's mean loss.  Without a
process group the reduce stage is skipped and the step is the
single-process one.

The 1-bit optimizers' compressed path (`engine._onebit_hot`, JAX's
`_build_onebit_step`, engine.py:1572-1650): the gradients stay each
rank's own, the overflow flag is agreed by every rank, the gradients are
unscaled and the optimizer reduces them itself (`comm_axis`); no
clipping norm.  The model's call gets progressive layer drop's theta
(`engine._pld_kwargs`) at every micro step.

ZeRO stage 3 (`engine._stage3`, runtime/zero/stage3.py): there is no
whole replica to prepare.  The model runs inside the gather's root
scope, each block's compute-dtype replica gathered for its forward and
again for its backward, and each stage-3 leaf's gradient reaches the
step already reduce-scattered to its owner (cast to fp32, summed over
the ranks, divided by dp: `reduce_implicit`'s stage-2 branch, run as
soon as the block's gradients are complete); the other leaves are
reduced here as at stage 2.  The update writes the owned slices, which
ARE the masters, so no post-step all-gather runs.  With qwZ the
`qwz.gather` counter gets each group's collective bytes where it is
issued, so `wire_bytes_per_gather` a gather pass, TWO passes a micro
step (forward and backward); JAX's `_account_qwz` (step_builder.py
:145-150) counts one a micro step, since XLA keeps the gathered
replica for the backward.
"""

from __future__ import annotations

import contextlib

import torch

from ..comm import dist
from ..comm.mesh import DATA_AXIS, DATA_INNER_AXIS, DATA_OUTER_AXIS
from ..moe.dispatch import local_grads_region
from .zero import stage3 as zero3
from ..utils.logging import logger
from .utils import clip_grad_norm, global_grad_norm_sq, has_overflow


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
        dp_on = eng._dp
        dp = eng.dp_world_size
        plan = eng.zero_plan
        leaves = plan.leaves
        stage = plan.stage
        owned_masters = [lp.owned(p) for lp, p in zip(leaves, masters)]
        wire = eng.bucket_plan
        exchange = eng._owner_exchange
        order = eng._jax_order
        hier = eng.mesh_info.hierarchical
        part_axis = plan.partition_axes[0]
        first_part = plan.partition_index == 0
        model_kwargs = eng._model_kwargs()
        expert_replica = plan.expert_replica_axis
        s3 = eng._stage3
        # the bucketed wire computes each rank's gradients with whole
        # experts: the explicit MoE wire falls back inside it (JAX's
        # local-grads region), in the forward and in any recompute
        region = (local_grads_region if wire is not None
                  else contextlib.nullcontext)
        # the 1-bit optimizer's compressed wire: local gradients, the
        # optimizer reduces (engine._use_onebit_comm)
        onebit = eng._onebit_hot
        if onebit and clip > 0.0:
            logger.warning("gradient clipping is not applied on the 1-bit "
                           "compressed path (local grads are never "
                           "globally reduced; reference parity)")

        def prep_params():
            """Master params -> the compute-side replica the loss reads."""
            return {n: p.to(compute_dtype) for n, p in zip(names, masters)}

        def call_model(batch, generator):
            """-> (loss, the stage-3 root scope or None)."""
            kwargs = {"generator": generator, "train": True, **model_kwargs,
                      **eng._pld_kwargs()}
            if s3 is None:
                out = torch.func.functional_call(model, prep_params(),
                                                 (batch,), kwargs)
                return (out[0] if isinstance(out, tuple) else out), None
            # stage 3: the root group gathered around the call, each
            # block inside its own scope; the mark on the loss gathers
            # the root group again when the backward starts
            with s3.root_scope() as root:
                out = model(batch, **kwargs)
                return root.output(out[0] if isinstance(out, tuple)
                                   else out), root

        def run_loss(batch, generator, loss_scale):
            loss, root = call_model(batch, generator)
            scale_factor = loss_scale / predivide if prescale else loss_scale
            return loss.float() * scale_factor, loss, root

        def reduce_implicit(grads):
            """One collective a leaf: the mean over the data ranks, cut
            to the owned slice (a reduce-scatter at stage 2)."""
            out = []
            for g, lp in zip(grads, leaves):
                if lp.gathered:
                    # a stage-3 leaf: reduce-scattered in the backward
                    out.append(g)
                elif lp.local:
                    # an owner's expert gradient: already the sum over
                    # every rank's loss, through the all-to-all's backward
                    if expert_replica is not None:
                        g = dist.all_reduce(g, expert_replica)
                    out.append(g.div_(dp))
                elif stage >= 2 and lp.sharded:
                    if hier:
                        g = dist.reduce_scatter(g, DATA_INNER_AXIS,
                                                scatter_axis=lp.dim)
                        g = dist.all_reduce(g, DATA_OUTER_AXIS)
                    else:
                        g = dist.reduce_scatter(g, DATA_AXIS,
                                                scatter_axis=lp.dim)
                    out.append(g.div_(dp))
                else:
                    out.append(lp.owned(dist.all_reduce(g, DATA_AXIS)
                                        .div_(dp)))
            return out

        def reduce_bucketed(grads):
            """The BucketPlan's buckets, in the JAX tree's leaf order."""
            buckets = wire.reduce(wire.flatten([grads[i] for i in order]))
            wire.account(1)
            # scattered chunks go to their owners; with one partition a
            # chunk is the whole bucket
            if exchange is not None:
                got = exchange.owned(buckets)
            else:
                got = wire.unflatten(buckets)
            out = [None] * len(grads)
            for j, i in enumerate(order):
                out[i] = got[j] if exchange is not None else \
                    leaves[i].owned(got[j])
            return out

        def compute_grads(batch, generator, loss_scale):
            # the stage-3 gather stays active through the backward, whose
            # recomputation under remat gathers again
            with region(), zero3.active(s3):
                scaled, loss, root = run_loss(batch, generator, loss_scale)
                with (s3.backward_scope(root) if s3 is not None
                      else contextlib.nullcontext()):
                    grads = torch.autograd.grad(scaled, masters,
                                                allow_unused=True)
            # fp32 gradients: already so through the casts of the fp32
            # masters; under offload the weights are the compute-dtype
            # tensors, whose gradients are cast here (JAX's
            # `cast(grads, fp32)`, step_builder.py:267)
            grads = [torch.zeros_like(p, dtype=torch.float32) if g is None
                     else g.float() for g, p in zip(grads, masters)]
            loss = loss.detach()
            if dp_on:
                if not onebit:
                    grads = (reduce_bucketed(grads) if wire is not None
                             else reduce_implicit(grads))
                # the reported loss is the global batch's mean
                loss = dist.all_reduce(loss.float().clone(), DATA_AXIS) / dp
            return grads, loss

        def agreed_overflow(grads):
            """The overflow flag of the owned gradients, the same on every
            rank (an all-reduce MAX)."""
            overflow = has_overflow(grads)
            if dp_on:
                flag = overflow.to(torch.int32)
                overflow = dist.all_reduce(flag, DATA_AXIS,
                                           dist.ReduceOp.MAX) > 0
            return overflow

        def sum_sq(gs, device):
            return (global_grad_norm_sq(gs) if gs else
                    torch.zeros((), dtype=torch.float32, device=device))

        def grad_norm_sq(grads):
            """Sum of squares of the whole gradient: at stage >= 1 each
            rank's owned slices (unsharded leaves counted by partition
            index 0 only), summed over the partition group; each local
            expert counted once, by a sum over the ranks holding distinct
            experts."""
            device = grads[0].device
            dense = [(g, lp) for g, lp in zip(grads, leaves) if not lp.local]
            if dp_on and stage >= 1 and plan.partitioned:
                mine = [g for g, lp in dense if lp.sharded or first_part]
                sq = dist.all_reduce(sum_sq(mine, device), part_axis)
            else:
                sq = sum_sq([g for g, _ in dense], device)
            if plan.expert_local:
                experts = [g for g, lp in zip(grads, leaves) if lp.local]
                sq = sq + dist.all_reduce(sum_sq(experts, device),
                                          plan.expert_group_axis)
            return sq

        @torch.no_grad()
        def apply_core(grads, lr, gas_div):
            """Unscale -> overflow -> clip -> optimizer -> branchless
            skip -> loss-scale update -> parameter gather.  Writes the
            masters in place; returns (overflow, grad_norm, new optimizer
            state, new scaler state)."""
            opt_state, scaler_state = eng._opt_state, eng._scaler_state
            loss_scale = scaler_state["cur_scale"]
            overflow = agreed_overflow(grads)
            denom = loss_scale * gas_div
            if prescale:
                denom = denom / predivide
            # the gradients are this step's own: unscaled and clipped in
            # place
            torch._foreach_div_(grads, denom)
            grad_norm = torch.zeros((), dtype=torch.float32,
                                    device=loss_scale.device)
            if clip > 0.0:
                grads, grad_norm = clip_grad_norm(grads, clip,
                                                  grad_norm_sq(grads))
            # an async checkpoint's copies of the masters land first
            eng._wait_snapshot()
            new_params, new_opt = opt.update(grads, opt_state,
                                             list(owned_masters), lr=lr)
            del grads
            # branchless skip-step on overflow (reference: step skipped,
            # scale halved — fp16/loss_scaler + stage2.py:1385-1404)
            for old, new in zip(owned_masters, new_params):
                torch.where(overflow, old, new, out=old)
            new_opt = _select(overflow, new_opt, opt_state)
            new_scaler = scaler.jit_update(scaler_state, overflow)
            if dp_on and 1 <= stage < 3:
                # every rank's updated slices, in the compute dtype (at
                # stage 3 the slices are all a rank keeps)
                plan.all_gather_slices(masters, owned_masters, compute_dtype)
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

        @torch.no_grad()
        def onebit_apply(grads, lr):
            """JAX's `_build_onebit_step` (engine.py:1572-1650) after the
            gradients: the overflow flag of the LOCAL gradients agreed by
            every rank, unscale, the optimizer's update with its own
            compressed reduction over the data axis (each rank's worker
            and server errors in its state), branchless skip, loss-scale
            update.  No clipping norm: the gradients are never reduced."""
            opt_state, scaler_state = eng._opt_state, eng._scaler_state
            loss_scale = scaler_state["cur_scale"]
            overflow = agreed_overflow(grads)
            torch._foreach_div_(grads, loss_scale)
            eng._wait_snapshot()
            new_params, new_opt = opt.update(grads, opt_state,
                                             list(owned_masters), lr=lr,
                                             comm_axis=DATA_AXIS)
            del grads
            for old, new in zip(owned_masters, new_params):
                torch.where(overflow, old, new, out=old)
            new_opt = _select(overflow, new_opt, opt_state)
            new_scaler = scaler.jit_update(scaler_state, overflow)
            grad_norm = torch.zeros((), dtype=torch.float32,
                                    device=loss_scale.device)
            return overflow, grad_norm, new_opt, new_scaler

        def onebit_step(batch, generator, lr):
            grads, loss = compute_grads(batch, generator,
                                        eng._scaler_state["cur_scale"])
            return (loss, *onebit_apply(grads, lr))

        if onebit:
            return {"full": self._traced(onebit_step, "full")}
        return {"micro": self._traced(micro_step, "micro"),
                "apply": self._traced(apply_step, "apply"),
                "full": self._traced(full_step, "full")}

    def _traced(self, fn, name):
        """`fn` landing as a `dispatch.<name>` span on the trace timeline
        when the in-flight step is sampled (step_builder.py:75-104): the
        host wall of the call (CUDA work is asynchronous, so on the card
        the span bounds the enqueue, not the execution)."""
        eng = self.engine

        def call(*args):
            tr = eng._dispatch_tracer()
            if tr is None:
                return fn(*args)
            with tr.span(f"dispatch.{name}", "train",
                         step=eng.global_steps + 1):
                return fn(*args)

        return call

"""DeepSpeedEngine — the single-process port of
deepspeed_tpu/runtime/engine.py.

`forward(batch)` computes the loss AND its gradients (engine.py:1720):
with gas == 1 it runs the whole step, gradients and update, and `step()`
only does the bookkeeping (the JAX package's fused path); with gas > 1 it
adds the micro batch's gradients to an accumulator and `step()` applies
them at the boundary (engine.py:2049-2131).  `backward()` advances the
micro-step counters.  The stages are `runtime/step_builder.py`'s.

State: the module's floating parameters are converted to fp32 in place
and ARE the master weights (`engine.params`, `engine.module`); the
optimizer state and the loss-scaler state are device tensors.  The
compute dtype comes from the config (fp32, bf16 or fp16).

`comm.moe` selects the MoE token movement (`moe/dispatch.py`): the engine
installs it at construction, and its routing counters are sent to the
host once a step without a wait (`flush_dispatch_stats`).

What the single-process slice refuses (config.py raises): ZeRO >= 1,
offload, pipelines, meshes over more than one device, progressive layer
drop, AMP, TensorBoard; LAMB, 1-bit and optax optimizers raise here, as
does the engine-owned data loader.  Entry points run on the card unless
`device="cpu"` is passed.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..models.convert import load_jax_params
from ..ops.adam.fused_adam import FusedAdam
from ..utils.device import check_same_device, resolve_device
from ..utils.logging import log_dist
from . import constants as const
from .config import DeepSpeedConfig
from .fp16.loss_scaler import create_loss_scaler
from .lr_schedules import SCHEDULERS
from .step_builder import StepBuilder

DTYPES = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16}


def _place(batch, device):
    """numpy arrays and tensors of a (nested) batch -> tensors on device."""
    if isinstance(batch, dict):
        return {k: _place(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_place(v, device) for v in batch)
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(batch).to(device, non_blocking=True)
    if torch.is_tensor(batch):
        return batch.to(device, non_blocking=True)
    return batch


class DeepSpeedEngine:
    def __init__(self, args=None, model=None, optimizer=None,
                 model_parameters=None, training_data=None,
                 lr_scheduler=None, mpu=None, dist_init_required=None,
                 collate_fn=None, config_params=None, device="cuda"):
        if model is None:
            raise ValueError("deepspeed_tpu_torch.initialize requires a model")
        if training_data is not None:
            raise NotImplementedError(
                "training_data: the engine's data loader is not ported yet "
                "(ROADMAP queue 1: data parallel and ZeRO-1/2); pass batches "
                "to forward() or an iterator to train_batch()")
        if mpu is not None:
            raise NotImplementedError(
                "mpu: model parallelism is not ported yet (ROADMAP queue 1: "
                "tensor and sequence parallelism)")
        config = config_params
        if config is None and args is not None:
            config = getattr(args, "deepspeed_config", None)
        if config is None:
            raise ValueError(
                "DeepSpeed requires --deepspeed_config or a config dict")
        self.device = resolve_device(device)
        self.module = model
        self.client_optimizer = optimizer
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self._skipped_steps = 0

        self._config = DeepSpeedConfig(config, world_size=1)
        # MoE token movement: install the validated comm.moe selection
        # process-globally (engine.py:177-185); the layer reads it
        from ..moe import dispatch as _moe_dispatch

        _moe_dispatch.set_wire_config(self._config.moe)
        if self._config.moe != _moe_dispatch.MoEWireConfig():
            log_dist(self._config.moe.describe(), ranks=[0])
        self.dp_world_size = 1
        self.mp_world_size = 1
        self.compute_dtype = DTYPES[self._config.precision]
        self.loss_scaler = create_loss_scaler(self._config)
        # dropout seeds come from a CPU generator: drawing one needs no
        # device sync (engine.py:211 seeds its PRNG key the same way)
        self._generator = torch.Generator().manual_seed(
            int(os.environ.get("DSTPU_SEED", 42)))

        check_same_device("model", next(model.parameters()).device,
                          self.device)
        model.float()  # the module's parameters become the fp32 masters
        if model_parameters is not None:
            # a JAX params tree (as numpy) becomes the masters unrounded
            load_jax_params(model, model_parameters)
        self._param_names, self._masters = zip(*model.named_parameters())

        self.optimizer = self._configure_optimizer()
        self._opt_state = self.optimizer.init(list(self._masters))
        self._scaler_state = self.loss_scaler.jit_state(self.device)
        self._grad_acc = None   # fp32 gradients accumulated over micro steps
        self._cached = None     # loss from forward awaiting backward
        self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler)
        self.training_dataloader = None
        self.training = True
        self._step_fns = StepBuilder(self).build()
        # The overflow flag of the last step is resolved LAZILY, as the
        # JAX package does: reading it right after the step would make the
        # host wait for the device to finish that step before it enqueues
        # the next one.  The update itself is already branchless on the
        # device (params, optimizer and scaler state); only the host-side
        # counters and the optimistic scheduler step are settled when the
        # flag is next needed (_resolve_pending_overflow).
        self._pending_overflow = None
        self._pending_full = None

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------

    def _configure_optimizer(self):
        """engine.py:652-699 optimizer selection."""
        if self.client_optimizer is not None:
            if not (hasattr(self.client_optimizer, "init") and
                    hasattr(self.client_optimizer, "update")):
                raise TypeError(
                    "a client optimizer needs the functional protocol "
                    "init(params) / update(grads, state, params, lr=) of "
                    "ops/adam/fused_adam.py")
            log_dist("using client optimizer", ranks=[0])
            return self.client_optimizer
        name = self._config.optimizer_name
        params = dict(self._config.optimizer_params or {})
        if name is None:
            log_dist("no optimizer configured; defaulting to FusedAdam",
                     ranks=[0])
            return FusedAdam()
        if name in (const.ADAM_OPTIMIZER, "adamw"):
            # both "Adam" and "AdamW" default to decoupled decay, matching
            # reference FusedAdam(adam_w_mode=True); "adam_w_mode": false
            # in params selects classic L2
            adam_w = params.pop(const.ADAM_W_MODE, const.ADAM_W_MODE_DEFAULT)
            return FusedAdam(adam_w_mode=adam_w, **params)
        if name in (const.LAMB_OPTIMIZER, const.ONEBIT_ADAM_OPTIMIZER,
                    const.ONEBIT_LAMB_OPTIMIZER) or name.startswith("optax:"):
            raise NotImplementedError(
                f"optimizer {name!r} is not ported to deepspeed_tpu_torch "
                f"yet (ROADMAP queue 1: the production runtime); use Adam")
        raise ValueError(f"unknown optimizer {name!r}; supported: "
                         f"{const.DEEPSPEED_OPTIMIZERS}")

    def _configure_lr_scheduler(self, client_scheduler):
        sched = client_scheduler
        if sched is None:
            name = self._config.scheduler_name
            if name is None:
                return None
            if name not in SCHEDULERS:
                raise ValueError(f"unknown scheduler {name!r}")
            sched = SCHEDULERS[name](self.optimizer,
                                     **(self._config.scheduler_params or {}))
            log_dist(f"using scheduler {name}", ranks=[0])
        return sched

    def _current_lr(self):
        """The lr of param_groups[0], or None (the optimizer's own)."""
        groups = getattr(self.optimizer, "param_groups", None)
        if groups and "lr" in groups[0]:
            return float(groups[0]["lr"])
        return None

    # ------------------------------------------------------------------
    # public training API (engine.py:1720, 1934, 2049)
    # ------------------------------------------------------------------

    def forward(self, batch, generator: Optional[torch.Generator] = None):
        """Compute the loss AND the gradients of a micro batch; returns
        the (unscaled) loss.  With gas == 1 the whole step runs here and
        step() does the bookkeeping; the previous step's deferred overflow
        is settled first, so the lr read below is the rolled-back one.
        `generator` draws the dropout seeds (default: the engine's)."""
        batch = _place(batch, self.device)
        gen = generator if generator is not None else self._generator
        if self.gradient_accumulation_steps() == 1:
            self._resolve_pending_overflow()
            (loss, overflow, grad_norm, self._opt_state,
             new_scaler) = self._step_fns["full"](batch, gen,
                                                  self._current_lr())
            # the new scale takes effect at step(): engine.loss_scale keeps
            # the pre-update value until the boundary
            self._pending_full = (new_scaler, overflow, grad_norm)
        else:
            loss = self._step_fns["micro"](batch, gen)
        self._cached = loss
        return loss

    def backward(self, loss=None, allreduce_gradients=True):
        """Gradients were produced in forward(); this advances the
        micro-step bookkeeping (API parity with reference backward)."""
        if self._cached is None:
            raise RuntimeError("backward() called before forward()")
        self.micro_steps += 1
        self.global_samples += self.train_micro_batch_size_per_gpu() * \
            self.dp_world_size
        self._cached = None
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return (self.micro_steps % self.gradient_accumulation_steps()) == 0

    def step(self):
        """Weight update at accumulation boundaries (reference :1201)."""
        if self.micro_steps == 0 or \
                not self.is_gradient_accumulation_boundary():
            return
        if self._pending_full is not None:
            self._fused_step_bookkeeping()
        else:
            self._boundary_step()

    def _boundary_step(self):
        """The micro/apply boundary: apply the accumulated gradients."""
        self._resolve_pending_overflow()
        (overflow, _grad_norm, self._opt_state,
         self._scaler_state) = self._step_fns["apply"](self._current_lr())
        self._finish_step(overflow)

    def _fused_step_bookkeeping(self):
        """Host-side tail of the gas == 1 step, whose update forward()
        already made."""
        new_scaler, overflow, _grad_norm = self._pending_full
        self._pending_full = None
        self._scaler_state = new_scaler
        self._finish_step(overflow)

    def _finish_step(self, overflow):
        # the step's MoE routing stats go to the host in one asynchronous
        # copy; the counters are credited once it lands (no wait here)
        from ..moe.dispatch import flush_dispatch_stats

        flush_dispatch_stats()
        self.global_steps += 1
        self._pending_overflow = overflow
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()  # optimistic; rolled back on overflow
        spp = self.steps_per_print()
        if spp and self.global_steps % spp == 0:
            # reads the scale, one device sync per print window
            lr = self._current_lr()
            log_dist(f"step={self.global_steps}, lr="
                     f"{'optimizer-default' if lr is None else f'{lr:.3e}'}, "
                     f"loss_scale={self.loss_scale}", ranks=[0])

    def _resolve_pending_overflow(self):
        """Apply the host-side bookkeeping for the PREVIOUS step's
        overflow flag (engine.py:2196).  The device already skipped the
        weights and halved the loss scale; here the counters are fixed
        and the optimistic scheduler step is rolled back."""
        pending = self._pending_overflow
        if pending is None:
            return
        self._pending_overflow = None
        if bool(pending):
            self._skipped_steps += 1
            if self.lr_scheduler is not None:
                it = getattr(self.lr_scheduler, "last_batch_iteration", None)
                if it is not None:  # step(-1) is valid (init state)
                    self.lr_scheduler.step(it - 1)  # undo optimistic step
            log_dist(f"overflow: skipped step, new loss scale "
                     f"{float(self._scaler_state['cur_scale'])}", ranks=[0])

    def train_batch(self, data_iter=None):
        """Run a full global batch (gas micro steps + update); returns the
        mean loss (engine.py:2360)."""
        if data_iter is None:
            raise ValueError(
                "train_batch needs data_iter (the engine's own data loader "
                "is not ported yet)")
        losses = []
        for _ in range(self.gradient_accumulation_steps()):
            losses.append(self.forward(next(data_iter)))
            self.backward()
        self.step()
        return torch.stack(losses).mean()

    @torch.no_grad()
    def eval_batch(self, batch, generator=None):
        """Loss without gradients or bookkeeping (engine.py:2509)."""
        cparams = {n: p.to(self.compute_dtype)
                   for n, p in zip(self._param_names, self._masters)}
        out = torch.func.functional_call(
            self.module, cparams, (_place(batch, self.device),),
            {"generator": generator, "train": False})
        return out[0] if isinstance(out, tuple) else out

    # ------------------------------------------------------------------
    # accessors (engine.py:2533-2897)
    # ------------------------------------------------------------------

    @property
    def params(self):
        """{name: fp32 master tensor} (the module's parameters)."""
        return dict(zip(self._param_names, self._masters))

    def get_batch_info(self):
        return (self._config.train_batch_size,
                self._config.train_micro_batch_size_per_gpu,
                self._config.gradient_accumulation_steps)

    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def steps_per_print(self):
        return self._config.steps_per_print

    def fp16_enabled(self):
        return self._config.fp16_enabled

    def precision(self):
        return self._config.precision

    def train(self, mode: bool = True):
        """Module-parity mode toggle; train/eval behaviour is selected per
        call (forward trains, eval_batch does not)."""
        self.training = bool(mode)
        return self

    def eval(self):
        return self.train(False)

    def zero_grad(self):
        """Drop the gradient accumulator (the apply step already does)."""
        self._grad_acc = None

    def allreduce_gradients(self, bucket_size=None, hierarchy=None):
        """One process, one device: there is nothing to reduce."""

    def get_mom(self):
        """First-moment decay (beta1) per param group."""
        return [g["betas"][0] if "betas" in g else g.get("momentum", 0.0)
                for g in getattr(self.optimizer, "param_groups", None) or []]

    def get_pld_theta(self):
        return None

    def pld_enabled(self):
        return False

    def get_summary_writer(self):
        return None

    def dynamic_loss_scale(self):
        return self._config.loss_scale == 0

    def initial_dynamic_scale(self):
        return 2 ** self._config.initial_scale_power

    def dynamic_loss_scale_args(self):
        return {"init_scale": 2 ** self._config.initial_scale_power,
                "scale_window": self._config.loss_scale_window,
                "delayed_shift": self._config.hysteresis,
                "min_scale": self._config.min_loss_scale}

    def amp_enabled(self):
        return False

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def gradient_predivide_factor(self):
        return self._config.gradient_predivide_factor

    def postscale_gradients(self):
        return not self._config.prescale_gradients

    def allreduce_always_fp32(self):
        return True

    def optimizer_name(self):
        return self._config.optimizer_name

    def optimizer_params(self):
        return self._config.optimizer_params

    def optimizer_legacy_fusion(self):
        return self._config.optimizer_legacy_fusion

    def scheduler_name(self):
        return self._config.scheduler_name

    def scheduler_params(self):
        return self._config.scheduler_params

    def sparse_gradients_enabled(self):
        return self._config.sparse_gradients_enabled

    def wall_clock_breakdown(self):
        return self._config.wall_clock_breakdown

    def tensorboard_enabled(self):
        return False

    def zero_optimization(self):
        return self._config.zero_enabled

    def zero_optimization_stage(self):
        return self._config.zero_optimization_stage

    def zero_optimization_partition_gradients(self):
        return self.zero_optimization_stage() >= 2

    def zero_optimization_partition_weights(self):
        return self.zero_optimization_stage() >= 3

    def zero_cpu_offload(self):
        return False

    def zero_allow_untested_optimizer(self):
        return self._config.zero_allow_untested_optimizer

    def module_state_dict(self):
        """{name: fp32 numpy copy} of the module weights."""
        return {n: p.detach().cpu().numpy().copy()
                for n, p in self.params.items()}

    def load_module_state_dict(self, state_dict, strict=True):
        """Replace the weights from {name: array}; strict: the same names."""
        if strict and set(state_dict) != set(self._param_names):
            raise ValueError(
                f"state_dict keys {sorted(state_dict)} do not match the "
                f"module's {sorted(self._param_names)}")
        with torch.no_grad():
            for n, p in self.params.items():
                if n in state_dict:
                    p.copy_(torch.as_tensor(np.asarray(state_dict[n])))

    @property
    def skipped_steps(self):
        """Resolves the deferred overflow flag first, so callers see
        settled counters."""
        self._resolve_pending_overflow()
        return self._skipped_steps

    @property
    def loss_scale(self):
        return float(self._scaler_state["cur_scale"])

    def get_lr(self):
        return [g["lr"] for g in getattr(self.optimizer, "param_groups",
                                         [{"lr": 0.0}])]

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

Input: `training_data` builds the engine-owned loader (`deepspeed_io`,
`runtime/dataloader.py`), and `train_batch()` with no iterator trains
from it through `RepeatingLoader(PrefetchLoader(...))` (the
`data_pipeline` section) and `_DeviceFeed`, which copies the next batch
to the card from pinned memory on a side stream while the current step
runs.  The loader's sample cursor is checkpointed.

Checkpoints (`save_checkpoint` / `load_checkpoint`, engine.py:3027-3311)
are the JAX engine's tags (`runtime/checkpointing.py`): the masters and
the Adam moments as the JAX trees, the scaler, scheduler and optimizer
hparams, the counters and the sample cursor; the port's dropout
generator state rides under a key of its own, and a JAX tag's `rng_key`
is carried through to the port's next save.  With `checkpoint.async_save`
the state is copied to pinned host memory on a side stream and written
in the background.

Data parallelism: with a `torch.distributed` process group (made by
`init_distributed`, which the engine calls unless `dist_init_required`
is False: a no-op without WORLD_SIZE / MASTER_ADDR / an init_method) the
data-parallel world is every rank (`comm/mesh.py`, with `comm.hierarchy`
its two-level factoring), `dp_world_size` and `train_batch_size = micro
× gas × dp` follow it, and the step reduces gradients over it
(`step_builder.py`) at ZeRO stage 0, 1 or 2 (`zero/partition.py`).
`forward(batch)` and a user's iterator take the GLOBAL micro batch, as
the JAX engine does, and each rank trains on its contiguous rows of it
(rank r: rows r·micro to (r+1)·micro); the engine-owned loader reads only
those rows.  The model is called with `row_offset`, the index of the
rank's first row, so dropout masks are those of its rows of the global
batch.  A ZeRO-1/2 tag holds the optimizer moments as pieces, one
`zero_pp_rank_<r>` file a rank, and a load re-partitions them for the
current world.

What the port refuses (config.py raises): ZeRO stage 3, offload,
pipelines, model / pipe / seq axes above 1, progressive layer drop, AMP,
TensorBoard, the preemption handler; LAMB, 1-bit and optax optimizers,
and MoE models over more than one rank, raise here.  Entry points run on
the card unless `device="cpu"` is passed.
"""

from __future__ import annotations

import inspect
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..comm import dist
from ..comm.mesh import (DATA_AXIS, DATA_INNER_AXIS, DATA_OUTER_AXIS,
                         derive_data_outer, make_mesh)
from ..models.convert import (jax_leaf_order, load_jax_params,
                              opt_state_from_jax, opt_state_to_jax,
                              unflatten_tree)
from ..ops.adam.fused_adam import FusedAdam
from ..utils.device import check_same_device, resolve_device
from ..utils.logging import log_dist, logger
from . import checkpointing as ckpt_io
from . import constants as const
from .config import DeepSpeedConfig
from .dataloader import (DeepSpeedDataLoader, PrefetchLoader,
                         RepeatingLoader, timed_next)
from .comm.bucketing import BucketPlan, OwnerExchange, WireLevel
from .fp16.loss_scaler import create_loss_scaler
from .lr_schedules import SCHEDULERS
from .step_builder import StepBuilder
from .zero.partition import ZeroShardingPlan, describe_reshard

DTYPES = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16}

# the model-states key of the port's dropout generator state (the JAX
# engine keeps its PRNG key under "rng_key")
TORCH_RNG_STATE = "torch_rng_state"


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


def _map_tensors(fn, tree):
    """`fn` over every tensor of a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return fn(tree) if torch.is_tensor(tree) else tree


def _as_like(value, like):
    """A restored array as a tensor of `like`'s shape, dtype and device."""
    t = value if torch.is_tensor(value) else torch.from_numpy(np.array(value))
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint state of shape {tuple(t.shape)} for a "
                         f"tensor of shape {tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype)


def _match_state(restored, like):
    """`restored` (a nest of dicts and lists of arrays) as tensors shaped,
    typed and placed like the nest `like`."""
    if isinstance(like, dict):
        if set(restored) != set(like):
            raise KeyError(f"checkpoint optimizer state has keys "
                           f"{sorted(restored)}, the optimizer "
                           f"{sorted(like)}")
        return {k: _match_state(restored[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_match_state(r, v) for r, v in zip(restored, like))
    return _as_like(restored, like) if torch.is_tensor(like) else restored


def _pin(batch):
    """Host arrays and CPU tensors of a batch -> pinned CPU tensors."""
    if isinstance(batch, dict):
        return {k: _pin(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_pin(v) for v in batch)
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    if torch.is_tensor(batch) and batch.device.type == "cpu":
        return batch.pin_memory()
    return batch


class _DeviceFeed:
    """Device-side double buffering of the input (the JAX engine's
    `_DeviceFeed`, engine.py:75-134).

    `next()` returns the current step's batch (fetched and placed on the
    spot only at the first call, or when lookahead is off); `schedule()`,
    called right after a step is enqueued, pulls the next host batch,
    pins it, and copies it to the card on a side stream, so the copy runs
    while the step computes.  `next()` then orders the compute stream
    after the copy's event and hands the tensors to the compute stream
    (`record_stream`), so the caching allocator does not reuse their
    memory while a kernel of the step still reads them.  On the CPU the
    batch is placed synchronously.  Lookahead engages only for the
    engine-owned iterator: prefetching from a user's iterator would take
    batches the caller may still expect to own."""

    _EMPTY = object()

    def __init__(self, source, fetch, device, lookahead: bool = True):
        self.source = source          # identity key (the host iterator)
        self._fetch = fetch
        self.device = device
        self._lookahead = lookahead
        self._stream = None
        self._pending = self._EMPTY
        self._exhausted = False

    def next(self):
        if self._pending is not self._EMPTY:
            batch, event = self._pending
            self._pending = self._EMPTY
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                _map_tensors(lambda t: t.record_stream(stream), batch)
            return batch
        if self._exhausted:
            raise StopIteration
        return _place(self._fetch(), self.device)

    def schedule(self) -> None:
        """Fetch the NEXT batch and start its copy to the device."""
        if not self._lookahead or self._exhausted or \
                self._pending is not self._EMPTY:
            return
        try:
            host = self._fetch()
        except StopIteration:
            self._exhausted = True
            return
        if self.device.type != "cuda":
            self._pending = (_place(host, self.device), None)
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        pinned = _pin(host)
        with torch.cuda.stream(self._stream):
            batch = _place(pinned, self.device)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._pending = (batch, event)


class DeepSpeedEngine:
    def __init__(self, args=None, model=None, optimizer=None,
                 model_parameters=None, training_data=None,
                 lr_scheduler=None, mpu=None, dist_init_required=None,
                 collate_fn=None, config_params=None, device="cuda"):
        if model is None:
            raise ValueError("deepspeed_tpu_torch.initialize requires a model")
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
        if dist_init_required is None or dist_init_required:
            dist.init_distributed(device=self.device)
        self.module = model
        self.client_optimizer = optimizer
        self.collate_fn = collate_fn
        self.loaded_checkpoint_tag = None
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self._skipped_steps = 0

        self._config = DeepSpeedConfig(config,
                                       world_size=dist.get_world_size())
        self.mesh_info = self._build_mesh()
        # data parallelism runs wherever there is a process group, one
        # rank included (its collectives are then real calls of one)
        self._dp = self.mesh_info.group(DATA_AXIS) is not None
        # MoE token movement: install the validated comm.moe selection
        # process-globally (engine.py:177-185); the layer reads it
        from ..moe import dispatch as _moe_dispatch

        _moe_dispatch.set_wire_config(self._config.moe)
        if self._config.moe != _moe_dispatch.MoEWireConfig():
            log_dist(self._config.moe.describe(), ranks=[0])
        self.dp_world_size = self.mesh_info.axis_size(DATA_AXIS)
        self.dp_rank = self.mesh_info.axis_index(DATA_AXIS)
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
        self._check_data_parallel_model()
        # ZeRO partitions; the bucketed wire fills its buckets in the JAX
        # tree's leaf order
        self.zero_plan = ZeroShardingPlan(
            self._config.zero_optimization_stage, self.mesh_info,
            [p.shape for p in self._masters])
        log_dist(self.zero_plan.describe(), ranks=[0])
        self._jax_order = jax_leaf_order(self._param_names)
        self.bucket_plan = self._build_bucket_plan()
        self._owner_exchange = (
            OwnerExchange(self.bucket_plan,
                          [self.zero_plan.leaves[i] for i in self._jax_order],
                          self.device)
            if self.bucket_plan is not None and self.bucket_plan.scatter
            and self.zero_plan.partitioned else None)

        self.optimizer = self._configure_optimizer()
        self._opt_state = self.optimizer.init(self._owned_masters())
        self._scaler_state = self.loss_scaler.jit_state(self.device)
        self._grad_acc = None   # fp32 gradients accumulated over micro steps
        self._cached = None     # loss from forward awaiting backward
        self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler)
        self.training_dataloader = (self.deepspeed_io(training_data)
                                    if training_data is not None else None)
        self._device_feed = None       # the owned iterator's double buffer
        self._user_device_feed = None  # the latest user iterator's
        # a JAX tag's PRNG key, carried through to this engine's saves
        self._rng_key = None
        # the async checkpoint snapshot's device-to-host copies: the next
        # in-place write of the masters waits for them (_wait_snapshot)
        self._snapshot_event = None
        self._ckpt_stream = None
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

    def _build_mesh(self):
        """The data axis over the process group, factored by
        `comm.hierarchy` (engine.py:527, 638: "auto" is one outer group
        per node)."""
        hier = self._config.comm_config.hierarchy
        outer = 1
        if hier == "auto":
            outer = derive_data_outer(dist.get_world_size())
        elif isinstance(hier, int):
            outer = hier
        return make_mesh(data=-1, data_outer=outer)

    def _check_data_parallel_model(self):
        """More than one rank needs a model that takes `row_offset` (its
        dropout masks follow the global batch's rows) and no MoE layer
        (an MoE layer's gate noise is drawn per local batch)."""
        if self.dp_world_size <= 1:
            return
        cfg = getattr(self.module, "config", None)
        if int(getattr(cfg, "num_experts", 1) or 1) > 1:
            raise NotImplementedError(
                "MoE training over more than one rank is not ported to "
                "deepspeed_tpu_torch yet (ROADMAP queue 1: the explicit MoE "
                "wire and the quantized wires)")
        if "row_offset" not in inspect.signature(
                self.module.forward).parameters:
            raise NotImplementedError(
                f"{type(self.module).__name__}: data parallelism needs a "
                f"model whose call takes row_offset (the index of the "
                f"rank's first row of the global batch, for its dropout "
                f"masks); models.GPT takes it")

    def _build_bucket_plan(self):
        """The bucketed gradient wire's static plan (engine.py:1080), or
        None for the implicit wire.  Unlike the JAX engine the plan is
        built at one rank too, wherever a process group is: the wire
        then runs as collectives of one."""
        cc = self._config.comm_config
        if cc.gradient_reduction != "bucketed":
            return None
        if not self._dp:
            log_dist("bucketed gradient wire requested but there is no "
                     "process group: nothing to reduce", ranks=[0])
            return None
        mi = self.mesh_info
        scatter = (self._config.zero_optimization_stage >= 2
                   and bool(self._config.zero_config.reduce_scatter))
        levels = None
        if mi.hierarchical:
            levels = (WireLevel(DATA_INNER_AXIS, mi.data_inner_size,
                                cc.wire_dtype_inner),
                      WireLevel(DATA_OUTER_AXIS, mi.data_outer_size,
                                cc.wire_dtype_outer))
        plan = BucketPlan([self._masters[i] for i in self._jax_order],
                          dp_size=self.dp_world_size,
                          bucket_elems=cc.reduce_bucket_size,
                          wire=cc.wire_dtype, scatter=scatter, levels=levels,
                          quant_block=cc.quant_block_size)
        log_dist(plan.describe(), ranks=[0])
        return plan

    def _owned_masters(self):
        """The slices of the masters this rank's optimizer updates."""
        return [lp.owned(p) for lp, p in zip(self.zero_plan.leaves,
                                             self._masters)]

    def _full_masters(self):
        """The fp32 masters, exact on every rank: where the other ranks'
        slices hold compute-dtype values (ZeRO >= 1 in bf16/fp16), copies
        with every slice from its owner by an fp32 all-gather (a
        collective: every rank calls it)."""
        plan = self.zero_plan
        if not (self._dp and plan.stage >= 1 and plan.partitioned) or \
                self.compute_dtype == torch.float32:
            return list(self._masters)
        full = [p.detach().clone() for p in self._masters]
        plan.all_gather_slices(full, self._owned_masters(), torch.float32)
        return full

    def _local_rows(self, batch):
        """This rank's contiguous rows of a global micro batch (every
        array's leading dim is micro × dp), as JAX's batch sharding gives
        its data index."""
        dp = self.dp_world_size
        if dp == 1:
            return batch
        micro = self.train_micro_batch_size_per_gpu()
        lo, hi = self.dp_rank * micro, (self.dp_rank + 1) * micro

        def cut(x):
            if isinstance(x, dict):
                return {k: cut(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(cut(v) for v in x)
            if isinstance(x, np.ndarray) or torch.is_tensor(x):
                if x.shape[0] != micro * dp:
                    raise ValueError(
                        f"a batch array of {x.shape[0]} rows: the engine "
                        f"takes the global micro batch, micro "
                        f"{micro} x dp {dp} = {micro * dp} rows")
                return x[lo:hi]
            return x

        return cut(batch)

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
        """Compute the loss AND the gradients of a (global) micro batch;
        returns the (unscaled) loss, the mean over the data ranks.  With
        gas == 1 the whole step runs here and step() does the
        bookkeeping; the previous step's deferred overflow is settled
        first, so the lr read below is the rolled-back one.  `generator`
        draws the dropout seeds (default: the engine's)."""
        return self._forward(self._local_rows(batch), generator)

    def _forward(self, batch, generator=None):
        """`forward` on this rank's rows."""
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
        (overflow, self._grad_norm, self._opt_state,
         self._scaler_state) = self._step_fns["apply"](self._current_lr())
        self._finish_step(overflow)

    def _fused_step_bookkeeping(self):
        """Host-side tail of the gas == 1 step, whose update forward()
        already made."""
        new_scaler, overflow, self._grad_norm = self._pending_full
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
        mean loss (engine.py:2360).  With no iterator it trains from the
        engine-owned loader through the input pipeline (config
        "data_pipeline", default on): background collate
        (PrefetchLoader) and the next batch's copy to the card under the
        current step (_DeviceFeed)."""
        if data_iter is None:
            if self.training_dataloader is None:
                raise ValueError(
                    "train_batch needs data_iter or training_data")
            if not hasattr(self, "_train_iter"):
                self._train_iter = iter(RepeatingLoader(
                    self._wrap_prefetch(self.training_dataloader)))
            data_iter = self._train_iter
        # the owned loader reads this rank's rows; a user's iterator gives
        # global batches
        if data_iter is getattr(self, "_train_iter", None):
            fetch = lambda: timed_next(data_iter)  # noqa: E731
        else:
            fetch = lambda: self._local_rows(timed_next(data_iter))  # noqa
        feed = self._data_feed(data_iter, fetch)
        losses = []
        for _ in range(self.gradient_accumulation_steps()):
            batch = feed.next() if feed is not None else fetch()
            losses.append(self._forward(batch))
            self.backward()
            if feed is not None:
                feed.schedule()   # the next batch's copy rides this step
        self.step()
        self._advance_sample_cursor(data_iter)
        return torch.stack(losses).mean()

    def _advance_sample_cursor(self, data_iter):
        """Advance the engine-owned loader's consumed-side cursor by the
        gas batches this train_batch trained on (engine.py:2400); a
        user's iterator and the prefetch lookahead never count."""
        if data_iter is not getattr(self, "_train_iter", None):
            return
        rec = getattr(self.training_dataloader, "record_consumed", None)
        if rec is not None:
            rec(self.gradient_accumulation_steps())

    def _wrap_prefetch(self, loader):
        """PrefetchLoader around the owned loader when the data_pipeline
        config asks for host-side background collate."""
        dp = self._config.data_pipeline_config
        if not dp.host_prefetch:
            return loader
        return PrefetchLoader(loader, prefetch_depth=dp.prefetch_depth,
                              num_workers=dp.num_workers)

    def _data_feed(self, data_iter, fetch) -> Optional[_DeviceFeed]:
        """The cached device double buffer bound to `data_iter`, or None
        when device prefetch is off.  Two slots: the owned iterator's
        feed (the only one with lookahead) and the latest user
        iterator's, so a train_batch(user_iter) call never evicts an
        owned feed whose pending batch the training stream already
        gave up."""
        if not self._config.data_pipeline_config.device_feed:
            return None
        owned = data_iter is getattr(self, "_train_iter", None)
        feed = self._device_feed if owned else self._user_device_feed
        if feed is not None and feed.source is data_iter:
            return feed
        feed = _DeviceFeed(data_iter, fetch, self.device, lookahead=owned)
        if owned:
            self._device_feed = feed
        else:
            self._user_device_feed = feed
        return feed

    def close_data_pipeline(self):
        """Stop the owned PrefetchLoader's threads and drop the device
        double buffers (engine.py:1054).  Idempotent."""
        self._device_feed = None
        self._user_device_feed = None
        it = getattr(self, "_train_iter", None)
        if it is not None:
            loader = getattr(it, "loader", None)
            if hasattr(loader, "close"):
                loader.close()
            del self._train_iter

    def finalize_monitoring(self):
        """Teardown (engine.py:1034): stops the input pipeline's threads
        and blocks on any async checkpoint write still in flight, so
        shutdown never abandons an uncommitted tag.  The port has no
        monitor to flush yet."""
        self.close_data_pipeline()
        ckpt_io.flush_pending()

    def deepspeed_io(self, dataset, batch_size=None, route=None,
                     data_sampler=None, collate_fn=None,
                     num_local_io_workers=None):
        """The engine's loader over `dataset` (engine.py:2899): global
        micro batches (micro × dp samples), shuffled with seed 0, of which
        this rank reads its contiguous rows."""
        micro = self.train_micro_batch_size_per_gpu()
        rows = None
        if self.dp_world_size > 1 and batch_size is None:
            rows = (self.dp_rank * micro, (self.dp_rank + 1) * micro)
        return DeepSpeedDataLoader(
            dataset, batch_size=(batch_size if batch_size is not None else
                                 micro * self.dp_world_size),
            shuffle=True, collate_fn=collate_fn or self.collate_fn,
            data_parallel_world_size=1, data_parallel_rank=0,
            row_slice=rows)

    @torch.no_grad()
    def eval_batch(self, batch, generator=None):
        """Loss without gradients or bookkeeping (engine.py:2509): the
        global micro batch's, the mean over the data ranks."""
        cparams = {n: p.to(self.compute_dtype)
                   for n, p in zip(self._param_names, self._masters)}
        out = torch.func.functional_call(
            self.module, cparams,
            (_place(self._local_rows(batch), self.device),),
            {"generator": generator, "train": False})
        loss = out[0] if isinstance(out, tuple) else out
        if self._dp:
            loss = dist.all_reduce(loss.float().clone(), DATA_AXIS) / \
                self.dp_world_size
        return loss

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
        """The reduction runs inside forward() (the step's reduce stage,
        runtime/step_builder.py); nothing is left to reduce here."""

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
        """{name: fp32 numpy copy} of the module weights (the exact
        masters: a collective under ZeRO >= 1 in bf16/fp16)."""
        return {n: p.detach().cpu().numpy().copy()
                for n, p in zip(self._param_names, self._full_masters())}

    def load_module_state_dict(self, state_dict, strict=True):
        """Replace the weights from {name: array}; strict: the same names."""
        if strict and set(state_dict) != set(self._param_names):
            raise ValueError(
                f"state_dict keys {sorted(state_dict)} do not match the "
                f"module's {sorted(self._param_names)}")
        self._wait_snapshot()
        with torch.no_grad():
            for n, p in self.params.items():
                if n in state_dict:
                    p.copy_(torch.as_tensor(np.asarray(state_dict[n])))

    # ------------------------------------------------------------------
    # checkpointing (engine.py:2965-3311)
    # ------------------------------------------------------------------

    def _client_state(self, client_state: Optional[Dict[str, Any]]):
        state = dict(client_state or {})
        state.update({
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "skipped_steps": self.skipped_steps,
            "micro_steps": self.micro_steps,
            "dp_world_size": self.dp_world_size,
            "mp_world_size": self.mp_world_size,
        })
        return state

    def _checkpoint_meta(self):
        """The saving run's layout, in the commit marker (engine.py:3000,
        with the ZeRO plan's `partition_layout` keys), and the loader's
        sample cursor."""
        meta = {
            "world_size": dist.get_world_size(),
            "mp_world_size": self.mp_world_size,
            **self.zero_plan.partition_layout(),
            "global_steps": self.global_steps,
        }
        cursor_fn = getattr(self.training_dataloader, "sample_cursor", None)
        if cursor_fn is not None:
            meta["sample_cursor"] = cursor_fn()
        return meta

    def _checkpoint_tag_validation(self, tag):
        """The tag must be printable (engine.py:3182): whitespace warns
        or, with tag_validation "fail", raises."""
        if self._config.checkpoint_tag_validation_enabled:
            if any(ch in str(tag) for ch in "\n\t "):
                msg = f"checkpoint tag {tag!r} contains whitespace"
                if self._config.checkpoint_tag_validation_fail:
                    raise ValueError(msg)
                logger.warning(msg)

    def _async_ckpt_snapshot(self, tree):
        """Host copies of every tensor of `tree` that no later step
        writes; returns (copies, ready).  On the card: one pinned host
        buffer, filled on a side stream ordered after the work enqueued
        so far (the step just taken), so the training thread does not
        wait; `ready` blocks until the copies have landed (the writer
        calls it), and the next in-place update of the masters waits
        for them on the device (`_wait_snapshot`).  The state is never
        cloned on the device: that would double its footprint.  On the
        CPU: clones."""
        if self.device.type != "cuda":
            return _map_tensors(lambda t: t.detach().clone(), tree), None
        leaves = []
        _map_tensors(leaves.append, tree)
        dev = [t for t in leaves if t.device.type == "cuda"]
        offsets, total = {}, 0
        for t in dev:
            offsets[id(t)] = total
            total += -(-t.numel() * t.element_size() // 256) * 256
        flat = torch.empty(max(total, 1), dtype=torch.uint8,
                           pin_memory=True)
        if self._ckpt_stream is None:
            self._ckpt_stream = torch.cuda.Stream(self.device)
        side = self._ckpt_stream
        side.wait_stream(torch.cuda.current_stream(self.device))

        def snap(t):
            if t.device.type != "cuda":
                return t.detach().clone()
            off = offsets[id(t)]
            n = t.numel() * t.element_size()
            buf = flat[off:off + n].view(t.dtype).view(t.shape)
            buf.copy_(t.detach(), non_blocking=True)
            t.record_stream(side)
            return buf

        with torch.cuda.stream(side):
            out = _map_tensors(snap, tree)
            done = torch.cuda.Event()
            done.record(side)
        self._snapshot_event = done
        return out, done.synchronize

    def _wait_snapshot(self):
        """Order the next in-place write of the masters after the async
        checkpoint snapshot's device-to-host copies."""
        event, self._snapshot_event = self._snapshot_event, None
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        """Write a tag in the JAX engine's layout (engine.py:3027).  The
        previous step's overflow flag is settled first, so the counters
        and the scheduler written are final."""
        self._resolve_pending_overflow()
        if tag is None:
            tag = f"global_step{self.global_steps}"
        self._checkpoint_tag_validation(tag)
        names = self._param_names
        model_state = {
            "module": unflatten_tree(dict(zip(names, self._full_masters()))),
            "lr_scheduler": (self.lr_scheduler.state_dict()
                             if self.lr_scheduler is not None else None),
            "loss_scaler": dict(self._scaler_state),
            "rng_key": self._rng_key,
            TORCH_RNG_STATE: self._generator.get_state(),
            **self._client_state(client_state),
        }
        opt_tree, pieces = self._opt_state_pieces()
        optim_state = {
            "optimizer_state": opt_tree,
            "offload": False,
            # json round trip: msgpack takes no tuples (betas)
            "optimizer_hparams": (json.loads(json.dumps(
                self.optimizer.state_dict()))
                if hasattr(self.optimizer, "state_dict") else None),
            "zero_stage": self.zero_optimization_stage(),
        }
        async_save = self._config.checkpoint_async_save
        ready = None
        if async_save:
            (model_state, optim_state, pieces), ready = \
                self._async_ckpt_snapshot((model_state, optim_state, pieces))
        ckpt_io.save_checkpoint_state(
            save_dir, tag, model_state, optim_state, save_latest=save_latest,
            async_save=async_save, meta=self._checkpoint_meta(), ready=ready,
            pieces=pieces, rank=dist.get_rank(),
            commit_timeout_ms=self._config.checkpoint_commit_timeout_ms)
        return True

    def _opt_state_pieces(self):
        """The optimizer state as the JAX tree, each partitioned moment a
        `shard_marker`, and this rank's pieces of them ({key: {"index",
        "piece"}}): written by the ranks of the first outer group only,
        one rank a distinct piece, as JAX writes the lowest device's
        replica (checkpointing.py:334)."""
        plan, names = self.zero_plan, self._param_names
        if not plan.partitioned:
            return opt_state_to_jax(names, self._opt_state), {}
        writes = (not self.mesh_info.hierarchical or
                  self.mesh_info.axis_index(DATA_OUTER_AXIS) == 0)
        pieces, state = {}, {}
        for k, v in self._opt_state.items():
            if not (isinstance(v, (list, tuple)) and len(v) == len(names)):
                state[k] = v
                continue
            out = []
            for name, t, lp in zip(names, v, plan.leaves):
                if not lp.sharded:
                    out.append(t)
                    continue
                path = ["optimizer_state", k] + [
                    int(c) if c.isdigit() else c for c in name.split(".")]
                key = ckpt_io.shard_key("optim:", path)
                out.append(ckpt_io.shard_marker(key, lp.shape, "float32",
                                                lp.parts))
                if writes:
                    pieces[key] = {"index": lp.piece_index(lp.index),
                                   "piece": t}
            state[k] = out
        return opt_state_to_jax(names, state), pieces

    def _partition_opt_state(self, restored):
        """Whole restored moments -> this rank's slices of them (a tag
        written at any world size re-partitions to this one)."""
        out = {}
        for k, v in restored.items():
            if isinstance(v, (list, tuple)) and len(v) == len(self._masters):
                v = [lp.owned(t if torch.is_tensor(t) else
                              torch.from_numpy(np.array(t))).clone(
                                  memory_format=torch.contiguous_format)
                     for lp, t in zip(self.zero_plan.leaves, v)]
            out[k] = v
        return out

    def _restore_sample_cursor(self, marker):
        """Apply the marker's sample cursor to the owned loader and drop
        the iterator, prefetch and device-feed state built on the old
        cursor (engine.py:3162)."""
        loader = self.training_dataloader
        restore = getattr(loader, "load_sample_cursor", None)
        cursor = ((marker or {}).get("meta") or {}).get("sample_cursor")
        if cursor is None or restore is None:
            return
        restore(cursor)
        self.close_data_pipeline()
        log_dist(f"sample cursor restored: epoch {loader._consumed_epoch}, "
                 f"batch {loader._consumed_position} of {len(loader)}",
                 ranks=[0])

    def _install_module_weights(self, tree):
        """The masters (the module's parameters) from a JAX-shaped tree;
        a missing, extra or misshapen leaf raises before any write."""
        self._wait_snapshot()
        load_jax_params(self.module, tree)

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True):
        """Restore a tag written by either engine (engine.py:3193);
        returns (tag dir, client state), or (None, {}) when there is
        nothing to resume from.  An uncommitted or incomplete tag raises
        CheckpointIntegrityError."""
        try:
            ckpt_dir, model_state, optim_state = \
                ckpt_io.load_checkpoint_state(load_dir, tag)
        except FileNotFoundError as e:
            logger.warning(f"load_checkpoint: {e}")
            return None, {}
        if optim_state is not None and optim_state.get("offload"):
            raise NotImplementedError(
                "an offload checkpoint: not ported to deepspeed_tpu_torch "
                "yet (ROADMAP queue 1: ZeRO-3, Offload and Infinity)")
        marker = ckpt_io.read_tag_meta(load_dir, os.path.basename(ckpt_dir))
        change = describe_reshard((marker or {}).get("meta"),
                                  self.zero_plan.partition_layout())
        if change:
            log_dist(change, ranks=[0])
        self._restore_sample_cursor(marker)
        # load_module_strict is accepted and, as in the JAX engine, the
        # module tree must match
        self._install_module_weights(model_state["module"])
        if load_optimizer_states and optim_state is not None:
            restored = self._partition_opt_state(opt_state_from_jax(
                self._param_names, optim_state["optimizer_state"]))
            self._opt_state = _match_state(restored, self._opt_state)
            hparams = optim_state.get("optimizer_hparams")
            if hparams is not None and hasattr(self.optimizer,
                                               "load_state_dict"):
                self.optimizer.load_state_dict(hparams)
        if model_state.get("loss_scaler") is not None:
            self._scaler_state = _match_state(model_state["loss_scaler"],
                                              self._scaler_state)
        if load_lr_scheduler_states and self.lr_scheduler is not None and \
                model_state.get("lr_scheduler") is not None:
            self.lr_scheduler.load_state_dict(model_state["lr_scheduler"])
            # the restored position back into param_groups, so the first
            # step after the resume takes its lr
            it = getattr(self.lr_scheduler, "last_batch_iteration", None)
            if it is not None and it >= 0:
                self.lr_scheduler.step(it)
        if model_state.get("rng_key") is not None:
            self._rng_key = model_state["rng_key"]
        if model_state.get(TORCH_RNG_STATE) is not None:
            self._generator.set_state(torch.from_numpy(
                np.array(model_state[TORCH_RNG_STATE])))
        self.global_steps = int(model_state.get("global_steps", 0))
        self.global_samples = int(model_state.get("global_samples", 0))
        self._skipped_steps = int(model_state.get("skipped_steps", 0))
        self.micro_steps = int(model_state.get("micro_steps", 0))
        self._grad_acc = None
        self._cached = None
        self._pending_overflow = None
        self._pending_full = None
        self.loaded_checkpoint_tag = os.path.basename(ckpt_dir)
        client_state = {k: v for k, v in model_state.items()
                        if k not in ("module", "lr_scheduler", "loss_scaler")}
        return ckpt_dir, client_state

    @property
    def skipped_steps(self):
        """Resolves the deferred overflow flag first, so callers see
        settled counters."""
        self._resolve_pending_overflow()
        return self._skipped_steps

    def get_global_grad_norm(self):
        """The last step's gradient norm before clipping, over the whole
        (data-parallel mean) gradient; 0.0 when clipping is off (the norm
        is then not computed) or before the first step."""
        norm = getattr(self, "_grad_norm", None)
        return 0.0 if norm is None else float(norm)

    @property
    def loss_scale(self):
        return float(self._scaler_state["cur_scale"])

    def get_lr(self):
        return [g["lr"] for g in getattr(self.optimizer, "param_groups",
                                         [{"lr": 0.0}])]

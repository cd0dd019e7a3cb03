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
(`step_builder.py`) at ZeRO stage 0, 1, 2 or 3 (`zero/partition.py`).
`forward(batch)` and a user's iterator take the GLOBAL micro batch, as
the JAX engine does, and each rank trains on its contiguous rows of it
(rank r: rows r·micro to (r+1)·micro); the engine-owned loader reads only
those rows.  The model is called with `row_offset`, the index of the
rank's first row, so dropout masks are those of its rows of the global
batch.  A ZeRO-1/2 tag holds the optimizer moments as pieces, one
`zero_pp_rank_<r>` file a rank, and a load re-partitions them for the
current world.

MoE under data parallelism: an MoE model's gate noise is drawn for the
global batch (`batch_rows`, moe/layer.py), so world N computes world 1's
function.  With `comm.moe.a2a_wire_dtype` and the implicit gradient
reduction, the explicit expert wire engages (`moe/dispatch.py`
`wire_engagement`): each rank keeps only its El = E / ep experts of every
expert leaf, cut from the same whole init (`_expert_parallel_axes`), and
the zero plan marks those leaves `local`.  Their gradients are not
reduced over the expert axes (the all-to-all's backward already summed
every rank's loss into the owner's gradient); under inner placement they
are summed over `data_outer`, where the experts are replicated; like
every leaf they are divided by dp.  The clipping norm counts each expert
once, the post-step gather skips them, and a tag holds them whole in the
module tree and as the owners' pieces in the optimizer's.  Under the
bucketed reduction the wire falls back to the local dispatch with the
experts whole on every rank, as JAX's local-grads region does; without a
wire the experts are whole and reduced like any leaf.

ZeRO stage 3: a rank keeps only its fp32 slice of each sharded leaf
(the module's parameter IS that slice, tagged `ds_shape` /
`ds_partition` as `zero.Init` tags it), with its Adam moments; the
model is run through `zero/stage3.py`'s gather on use — a block's
compute-dtype replica gathered for its forward and again for its
backward, its gradient reduce-scattered to the owners as soon as it is
complete — through the int8/int4 wire with
`zero_optimization.quantized_weights` (qwZ, `QuantizedWeightGather`).
The data axis stays flat, the bucketed wire falls back to the implicit
reduction, and qwZ below stage 3 or at dp 1 falls back to the
full-width gather, each logged in the JAX engine's words.  A stage-3
tag holds the module's sharded leaves as `model:` pieces, and
`params`, `module_state_dict` and a save gather them (collectives:
every rank calls them).

ZeRO-Offload (`zero_optimization.offload_optimizer`, or the legacy
`cpu_offload`, at stages 0-2; engine.py:701-717, 2238-2277): the fp32
masters and the Adam moments live on the host (`zero/offload.py`), the
module's parameters are the compute-dtype weights, their fp32 gradients
accumulate on the device, and step() runs the host step: the gradients
to pinned host buffers, the native Adam, the new weights back.  A tag
holds the host masters and the host Adam's state (`"offload": true`).
`store_gradients` stashes the unscaled gradients before the clip, as
JAX's offload path does.

ZeRO-Infinity (stage 3 with `offload_param`, a model with the streaming
protocol; engine.py:325-412, 1832-1851): the engine keeps no parameter
tree on the device (the module's parameters move to the "meta" device
once their values are on the host); `zero/infinity.py` streams each
micro step's blocks and runs the host update at the accumulation
boundary.  With NVMe-paged masters a tag is `stream_group_*.msgpack`
files under stream markers, which any engine resolves on load.  The
Adam moments cross only between engines that keep them on the host (a
host tag into a device engine, or the reverse, loads the masters and
restarts the moments, as in JAX).

The optimizer family (engine.py:652-699): FusedAdam, FusedLamb
(`ops/lamb`), 1-bit Adam / LAMB (`runtime/fp16/onebit`) and a client
optimizer — the functional protocol as it is, or a `torch.optim.Optimizer`
(and the config's "optax:adam|adamw|sgd") through
`client_optimizer.TorchOptimizer`, gated under ZeRO by
zero_allow_untested_optimizer.  A 1-bit optimizer owns its data-parallel
reduction on the compressed path (`_use_onebit_comm`: gas 1, stage 0, no
offload, dp > 1, a flat data axis; step_builder's onebit step, each rank
keeping its own worker and server errors, saved as `onebit_rank_errors`
pieces); elsewhere it logs and takes the dense reduction.  LAMB's trust
ratios read whole leaves: under ZeRO it sums its slices' squared norms
over the data ranks (`_slice_whole_leaf_optimizer`).  Progressive layer
drop (engine.py:262-267): theta is handed to the model each step and updated
after it, and resumes from the step count.

Monitoring and resilience (engine.py:275-304, 740-975, 2049-2240): the
`monitor` block builds a `RunMonitor` (monitor/monitor.py: a manifest and
one `events.rank*.jsonl` step event a step with `forward` / `step` spans,
counter deltas, tokens/s and the TFLOP/s of the flops profiler's count of
the first step; its `profiler` window and `tracing` recorder); the
`wall_clock_breakdown` timers, the TensorBoard scalars and the flops
profiler at `profile_step` follow the JAX engine.  The `faults` block
installs the fault plan and retry policy and arms a StepWatchdog beaten
at every step boundary; `checkpoint.preempt_save_dir` arms a SIGTERM
handler whose flag the next boundary turns into a committed
`preempt_step<N>` tag and `SystemExit(0)`.  All four step paths (the
device split step, the fused step, the host step of Offload / Infinity,
the 1-bit step) go through `step()`, where these hooks sit.  None of them
changes a value: a monitored run's losses and masters are bitwise an
unmonitored run's.

What the port refuses (config.py raises): offload and Infinity at more
than one rank, `offload_optimizer` at stage 3 without `offload_param`,
pipelines, model / pipe / seq axes above 1, `comm.overlap` (outside
Infinity, which warns), AMP and autotune; an
optimizer other than Adam under Offload / Infinity, a 1-bit optimizer
over parameter slices (ZeRO 1-3 over several ranks), layer drop under
Infinity, the host-store transport of the 1-bit wire (onebit/adam.py),
and Infinity for a MoE, pipeline or dropout model, raise here.  Entry points run on the card
unless `device="cpu"` is passed.
"""

from __future__ import annotations

import inspect
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..comm import dist
from ..comm.mesh import (DATA_AXIS, DATA_INNER_AXIS, DATA_OUTER_AXIS,
                         derive_data_outer, make_mesh)
from ..models.convert import (flatten_tree, is_expert_leaf,
                              jax_leaf_order, load_jax_params,
                              opt_state_from_jax, opt_state_to_jax,
                              slice_expert_leaves, unflatten_tree)
from ..monitor.counters import COUNTERS
from ..ops.adam.fused_adam import FusedAdam
from ..utils.device import check_same_device, resolve_device
from ..utils.logging import log_dist, logger
from . import checkpointing as ckpt_io
from . import constants as const
from . import resilience
from .config import DeepSpeedConfig
from .dataloader import (DeepSpeedDataLoader, PrefetchLoader,
                         RepeatingLoader, timed_next)
from .comm.bucketing import BucketPlan, OwnerExchange, WireLevel
from .fp16.loss_scaler import create_loss_scaler
from .lr_schedules import SCHEDULERS
from .step_builder import StepBuilder
from .utils import ThroughputTimer
from .zero import stage3
from .zero.partition import (QuantizedWeightGather, ZeroShardingPlan,
                             describe_reshard)

DTYPES = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16}

# the model-states key of the port's dropout generator state (the JAX
# engine keeps its PRNG key under "rng_key")
TORCH_RNG_STATE = "torch_rng_state"
# the optim-states key of every rank's 1-bit worker / server errors on the
# compressed path, [dp, *leaf] pieces (the JAX engine writes none there)
ONEBIT_RANK_ERRORS = "onebit_rank_errors"
ONEBIT_ERRORS = ("worker_error", "server_error")


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
        if self._config.sparse_gradients_enabled:
            # the JAX engine's documented divergence from the reference's
            # CSR allreduce of embedding grads (engine.py:198-207): the key
            # is accepted and the data-parallel reduction stays dense
            log_dist("sparse_gradients: accepted for API parity; the "
                     "data-parallel reduction stays dense", ranks=[0])
        # dropout seeds come from a CPU generator: drawing one needs no
        # device sync (engine.py:211 seeds its PRNG key the same way)
        self._generator = torch.Generator().manual_seed(
            int(os.environ.get("DSTPU_SEED", 42)))
        self._store_gradients = False
        self.stored_gradients = None
        self._offload = None
        # ZeRO-Infinity: stage 3 + offload_param streams the parameters
        # from the host; no parameter tree is ever resident on the device
        self._infinity = self._configure_infinity(model, model_parameters)
        if self._infinity is not None:
            self._finish_infinity_init(lr_scheduler, training_data)
            return

        check_same_device("model", next(model.parameters()).device,
                          self.device)
        model.float()  # the module's parameters become the fp32 masters
        # a model built under zero.Init holds only its slices already
        pre_sliced = any(hasattr(p, "ds_shape") for p in model.parameters())
        if model_parameters is not None and not pre_sliced:
            # a JAX params tree (as numpy) becomes the masters unrounded
            load_jax_params(model, model_parameters)
        self._check_data_parallel_model()
        names = [n for n, _ in model.named_parameters()]
        whole_shapes = [tuple(getattr(p, "ds_shape", p.shape))
                        for _, p in model.named_parameters()]
        expert_axes = self._expert_parallel_axes()
        expert = [bool(expert_axes) and is_expert_leaf(n) for n in names]
        # ZeRO partitions (and the expert leaves' shards); the bucketed
        # wire fills its buckets in the JAX tree's leaf order
        self.zero_plan = ZeroShardingPlan(
            self._config.zero_optimization_stage, self.mesh_info,
            whole_shapes, expert=expert, expert_axes=expert_axes)
        # the optimizer meets the plan before the model is cut to it
        self.optimizer = self._configure_optimizer()
        self._slice_whole_leaf_optimizer()
        self._keep_slices(model)
        self._param_names, self._masters = zip(*model.named_parameters())
        if model_parameters is not None and pre_sliced:
            self._install_module_weights(model_parameters)
        log_dist(self.zero_plan.describe(), ranks=[0])
        self._jax_order = jax_leaf_order(self._param_names)
        self.bucket_plan = self._build_bucket_plan()
        self._owner_exchange = (
            OwnerExchange(self.bucket_plan,
                          [self.zero_plan.leaves[i] for i in self._jax_order],
                          self.device)
            if self.bucket_plan is not None and self.bucket_plan.scatter
            and self.zero_plan.partitioned else None)

        self._qwz_gather = self._build_qwz_gather()
        self._stage3 = (stage3.Stage3Gather(model, self.zero_plan,
                                     self._param_names, self._masters,
                                     self.compute_dtype, self._qwz_gather)
                        if self.zero_plan.gathered else None)

        if hasattr(self.optimizer, "bind"):
            self.optimizer.bind(self._masters)
        if hasattr(self.optimizer, "flat_order"):
            # the flat 1-bit buffer in the JAX tree's leaf order
            self.optimizer.flat_order = list(self._jax_order)
        self.progressive_layer_drop = self._configure_pld()
        # ZeRO-Offload: the fp32 masters and the optimizer state move to
        # the host; the device keeps the compute-dtype weights only
        self._offload = self._configure_offload()
        self._opt_state = (None if self._offload is not None else
                           self.optimizer.init(self._owned_masters()))
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
        # the 1-bit optimizer's compressed data-parallel wire
        self._onebit_hot = self._use_onebit_comm()
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
        self._init_observability()

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------

    def _configure_optimizer(self):
        """engine.py:652-699 optimizer selection: FusedAdam, FusedLamb,
        1-bit Adam / LAMB, a client optimizer (the functional protocol
        as it is, a `torch.optim.Optimizer` through
        `client_optimizer.TorchOptimizer`) and "optax:<name>" (the
        torch.optim class with optax's update rule), the last two gated
        under ZeRO by zero_allow_untested_optimizer."""
        name = self._config.optimizer_name
        if self.client_optimizer is not None:
            opt = self.client_optimizer
            if isinstance(opt, torch.optim.Optimizer):
                from .client_optimizer import TorchOptimizer

                self._gate_untested(type(opt).__name__)
                opt = TorchOptimizer(opt)
            elif not (hasattr(opt, "init") and hasattr(opt, "update")):
                raise TypeError(
                    "a client optimizer is a torch.optim.Optimizer or has "
                    "the functional protocol init(params) / update(grads, "
                    "state, params, lr=) of ops/adam/fused_adam.py")
            log_dist("using client optimizer", ranks=[0])
            return self._refuse_under_offload(opt, "a client optimizer")
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
        if name == const.LAMB_OPTIMIZER:
            from ..ops.lamb import FusedLamb

            return self._refuse_under_offload(FusedLamb(**params), name)
        if name == const.ONEBIT_ADAM_OPTIMIZER:
            from .fp16.onebit import OnebitAdam

            return self._refuse_under_offload(OnebitAdam(**params), name)
        if name == const.ONEBIT_LAMB_OPTIMIZER:
            from .fp16.onebit import OnebitLamb

            return self._refuse_under_offload(OnebitLamb(**params), name)
        if name.startswith("optax:"):
            from .client_optimizer import from_optax_name

            self._gate_untested(name)
            return self._refuse_under_offload(
                from_optax_name(name, params), name)
        raise ValueError(f"unknown optimizer {name!r}; supported: "
                         f"{const.DEEPSPEED_OPTIMIZERS} or 'optax:<name>'")

    def _gate_untested(self, what):
        """engine.py:677-684: an optimizer DeepSpeed has not tested with
        ZeRO needs zero_allow_untested_optimizer."""
        if self._config.zero_enabled and \
                not self._config.zero_allow_untested_optimizer:
            raise ValueError(f"{what!r} is untested with ZeRO; set "
                             "zero_allow_untested_optimizer to proceed")

    def _refuse_under_offload(self, opt, what):
        """Offload and Infinity step with the host Adam: another optimizer
        there is refused, not substituted."""
        from .config import infinity_requested, offload_requested

        zc = self._config.zero_config
        if offload_requested(zc) or infinity_requested(zc):
            raise NotImplementedError(
                f"optimizer {what!r} under ZeRO-Offload / Infinity: the "
                f"host step is the native Adam (ops/adam/cpu_adam.py); "
                f"other optimizers there are not ported (ROADMAP queue 1: "
                f"the production runtime)")
        return opt

    def _slice_whole_leaf_optimizer(self):
        """An optimizer whose update reads whole leaves
        (`reads_whole_leaves`: LAMB's per-tensor trust ratio, 1-bit's
        compressed statistics over the tree) gets this rank's slices under
        ZeRO or the MoE wire.  LAMB sums its slices' squared norms over
        the ranks holding the leaf's other slices (`norm_axes`), so its
        ratios are JAX's over the global arrays; one that cannot is
        refused."""
        opt, plan = self.optimizer, self.zero_plan
        if not getattr(opt, "reads_whole_leaves", False) or not (
                plan.partitioned or plan.expert_local):
            return
        if not hasattr(opt, "norm_axes"):
            raise NotImplementedError(
                f"optimizer {getattr(opt, 'name', type(opt).__name__)!r} "
                f"over parameter slices (ZeRO stage "
                f"{plan.stage} over {self.dp_world_size} ranks, or the "
                f"MoE wire's local experts): its compressed statistics "
                f"read whole leaves, and the sliced update is not ported "
                f"to deepspeed_tpu_torch yet (ROADMAP queue 1: the "
                f"production runtime); use ZeRO stage 0")
        opt.norm_axes = [plan.expert_group_axis if lp.local
                         else plan.partition_axes[0] if lp.sharded else None
                         for lp in plan.leaves]

    def _use_onebit_comm(self) -> bool:
        """engine.py:1548-1570: True when the 1-bit optimizer's own
        compressed data-parallel reduction runs in the step — gas 1,
        ZeRO stage 0, no offload, dp > 1, a flat data axis; otherwise a
        1-bit optimizer logs and takes the dense reduction (and
        compresses locally, with no collective of its own)."""
        opt = self.optimizer
        if not getattr(opt, "handles_dp_reduction", False):
            return False
        ok = (self.gradient_accumulation_steps() == 1
              and self._offload is None
              and self._config.zero_optimization_stage == 0
              and self.dp_world_size > 1
              and not self.mesh_info.hierarchical)
        if not ok:
            log_dist(
                "1-bit optimizer falling back to dense DP reduction "
                "(compressed comm needs gas==1, ZeRO stage 0, no offload, "
                "dp>1, a FLAT data axis — reference onebit/adam.py has the "
                "same constraints; the compressed wire addresses one named "
                "axis)", ranks=[0])
        else:
            log_dist(f"1-bit optimizer {opt.name}: the compressed "
                     f"{opt.wire} wire reduces over {self.dp_world_size} "
                     "ranks", ranks=[0])
        return ok

    def _configure_pld(self):
        """Progressive layer drop (engine.py:262-267): the theta schedule,
        handed to a model whose call takes `progressive_layer_drop` and
        `pld_theta` (models.GPT)."""
        if not self._config.pld_enabled:
            return None
        from .progressive_layer_drop import ProgressiveLayerDrop

        takes = inspect.signature(self.module.forward).parameters
        if "pld_theta" not in takes:
            raise NotImplementedError(
                f"progressive_layer_drop: {type(self.module).__name__}'s "
                f"call takes no pld_theta (models.GPT does)")
        return ProgressiveLayerDrop(
            theta=self._config.pld_params[const.PLD_THETA],
            gamma=self._config.pld_params[const.PLD_GAMMA])

    def _pld_kwargs(self) -> dict:
        """The model call's layer-drop arguments at this step's theta
        (engine.py:1756-1758)."""
        pld = self.progressive_layer_drop
        if pld is None:
            return {}
        return {"progressive_layer_drop": True,
                "pld_theta": float(pld.get_theta())}

    def _optimizer_hparams(self):
        """(the Adam hyperparameters of the config, adam_w_mode) for the
        host Adam (engine.py:331-332)."""
        hparams = dict(self._config.optimizer_params or {})
        return hparams, bool(hparams.pop(const.ADAM_W_MODE, True))

    def _configure_offload(self):
        """ZeRO-Offload (engine.py:701-717): the host runtime over the
        masters in the JAX leaf order, the module's parameters cast to the
        compute dtype in place."""
        zc = self._config.zero_config
        from .config import offload_requested

        if not offload_requested(zc):
            return None
        from .zero.offload import CPUOffloadRuntime

        nvme = None
        if zc.offload_optimizer is not None and \
                zc.offload_optimizer.device == "nvme":
            nvme = zc.offload_optimizer.nvme_path
        hparams, adam_w = self._optimizer_hparams()
        rt = CPUOffloadRuntime(
            [self._masters[i].detach() for i in self._jax_order], hparams,
            adam_w_mode=adam_w, nvme_path=nvme,
            param_dtype=self.compute_dtype, device=self.device)
        with torch.no_grad():
            for p in self._masters:
                p.data = p.data.to(self.compute_dtype)
        return rt

    def _configure_infinity(self, model, model_parameters):
        """ZeRO-Infinity (engine.py:325-348) for a model with the
        streaming protocol: the host masters come from `model_parameters`
        (a JAX-shaped params tree), else from the module's parameters
        when they hold values (they are then moved to the "meta" device),
        else from `model.stream_init` drawn on the engine's device, one
        group at a time."""
        from .config import infinity_requested

        zc = self._config.zero_config
        if not infinity_requested(zc):
            return None
        if not hasattr(model, "stream_init"):
            log_dist("zero_optimization.offload_param requested but "
                     f"{type(model).__name__} has no streaming protocol "
                     "(stream_init): ZeRO-3 keeps its parameters on the "
                     "device", ranks=[0])
            return None
        if not model.stream_supported():
            raise NotImplementedError(
                "ZeRO-Infinity streams dense dropout-free models only (no "
                "MoE, pipeline or dropout, as in the JAX package): not "
                "ported to deepspeed_tpu_torch yet (ROADMAP queue 1: "
                "streamed MoE, pipeline and dropout models)")
        from ..models.convert import unflatten_tree as unflatten
        from .zero.infinity import InfinityRuntime

        on_nvme = zc.offload_param.device == "nvme"
        opt = zc.offload_optimizer
        opt_nvme = opt is not None and opt.device == "nvme"
        nvme = (zc.offload_param.nvme_path if on_nvme
                else opt.nvme_path if opt_nvme else None)
        resident = any(p.device.type != "meta" for p in model.parameters())
        if model_parameters is not None:
            groups = model.stream_groups(model_parameters)
        elif resident:
            groups = model.stream_groups(unflatten(
                {n: p.detach() for n, p in model.named_parameters()}))
        else:
            groups = model.stream_init(torch.Generator(
                device=self.device).manual_seed(
                    int(os.environ.get("DSTPU_SEED", 42))))
        hparams, adam_w = self._optimizer_hparams()
        rt = InfinityRuntime(model, groups, hparams, adam_w_mode=adam_w,
                             compute_dtype=self.compute_dtype,
                             device=self.device, nvme_path=nvme,
                             params_on_nvme=on_nvme)
        if resident:
            model.to(torch.device("meta"))
        return rt

    def _finish_infinity_init(self, lr_scheduler, training_data):
        """The engine state of the streamed path (engine.py:350-412): no
        device parameter tree, no zero plan, no step functions."""
        self.zero_plan = self.bucket_plan = self._owner_exchange = None
        self._qwz_gather = self._stage3 = None
        self._param_names, self._masters = (), ()
        self._jax_order = []
        mode = self._config.comm_config.overlap
        if mode != "none":
            msg = ("comm.overlap requested but ZeRO-Infinity streams "
                   "parameters and gradients host-side; the serial "
                   "streamed path stays in charge")
            if mode == "on":
                logger.warning(msg)
            else:
                log_dist(msg, ranks=[0])
        self.optimizer = self._configure_optimizer()   # the lr's holder
        if self._config.pld_enabled:
            raise NotImplementedError(
                "progressive_layer_drop under ZeRO-Infinity (the streamed "
                "blocks run unconditionally) is not ported to "
                "deepspeed_tpu_torch yet (ROADMAP queue 1, item 10: "
                "streamed MoE, pipeline and dropout models)")
        self.progressive_layer_drop = None
        self._onebit_hot = False
        self._opt_state = None
        self._scaler_state = self.loss_scaler.jit_state(self.device)
        self._grad_acc = None
        self._cached = None
        self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler)
        self.training_dataloader = (self.deepspeed_io(training_data)
                                    if training_data is not None else None)
        self._device_feed = None
        self._user_device_feed = None
        self._rng_key = None
        self._snapshot_event = None
        self._ckpt_stream = None
        self.training = True
        self._step_fns = {}
        self._pending_overflow = None
        self._pending_full = None
        self._init_observability()

    def _keep_slices(self, model):
        """Each rank keeps only its slice of a leaf it holds sliced (its
        experts of an expert leaf; its partition of a stage-3 leaf), cut
        from the same whole init, unless the model was built sliced
        (`zero.Init`); a stage-3 slice is tagged with its whole shape and
        partition."""
        with torch.no_grad():
            for (n, p), lp in zip(model.named_parameters(),
                                  self.zero_plan.leaves):
                if not lp.held_sliced:
                    if hasattr(p, "ds_shape"):
                        raise ValueError(
                            f"{n}: built sliced by zero.Init, but this "
                            f"engine's plan keeps it whole")
                    continue
                if hasattr(p, "ds_shape"):
                    if tuple(p.shape) != lp.owned_shape or \
                            getattr(p, "ds_partition", lp) != lp:
                        raise ValueError(
                            f"{n}: zero.Init sliced it as "
                            f"{tuple(p.shape)}, this engine's plan owns "
                            f"{lp.owned_shape} at partition {lp.index}")
                else:
                    p.data = lp.from_full(p.data).clone()
                if lp.gathered:
                    p.ds_shape = torch.Size(lp.shape)
                    p.ds_partition = lp

    def _build_mesh(self):
        """The data axis over the process group, factored by
        `comm.hierarchy` (engine.py:527, 638: "auto" is one outer group
        per node); flat at ZeRO stage 3 (engine.py:623)."""
        hier = self._config.comm_config.hierarchy
        outer = 1
        if hier != "none" and self._config.zero_optimization_stage >= 3:
            log_dist("comm.hierarchy requested but unavailable — keeping "
                     "the flat data axis: ZeRO-3 (param sharding keeps the "
                     "flat axis)", ranks=[0])
        elif hier == "auto":
            outer = derive_data_outer(dist.get_world_size())
        elif isinstance(hier, int):
            outer = hier
        return make_mesh(data=-1, data_outer=outer)

    def _num_experts(self) -> int:
        cfg = getattr(self.module, "config", None)
        return int(getattr(cfg, "num_experts", 1) or 1)

    def _check_data_parallel_model(self):
        """More than one rank needs a model that takes `row_offset` (its
        dropout masks follow the global batch's rows) and, with MoE
        layers, `batch_rows` (their gate noise is drawn for the global
        batch)."""
        if self.dp_world_size <= 1:
            return
        takes = inspect.signature(self.module.forward).parameters
        needed = [("row_offset", "the index of the rank's first row of the "
                   "global batch, for its dropout masks")]
        if self._num_experts() > 1:
            needed.append(("batch_rows", "the global batch's rows, for the "
                           "MoE gate noise"))
        for arg, why in needed:
            if arg not in takes:
                raise NotImplementedError(
                    f"{type(self.module).__name__}: data parallelism needs "
                    f"a model whose call takes {arg} ({why}); models.GPT "
                    f"takes it")

    def _model_kwargs(self) -> dict:
        """The data-parallel arguments of the model's call: this rank's
        first global row and, where the call takes it, the global batch's
        rows."""
        if self.dp_world_size <= 1:
            return {}
        micro = self.train_micro_batch_size_per_gpu()
        out = {"row_offset": self.dp_rank * micro}
        if "batch_rows" in inspect.signature(
                self.module.forward).parameters:
            out["batch_rows"] = micro * self.dp_world_size
        return out

    def _expert_parallel_axes(self):
        """The mesh axes the experts are sharded over, or () when each
        rank keeps them whole: the explicit wire engages only for an MoE
        model with `comm.moe.a2a_wire_dtype`, the implicit gradient
        reduction (the bucketed wire's local-grads region computes with
        whole experts, and the layer logs that fallback) and what
        `wire_engagement` allows, which logs why not."""
        from ..moe.dispatch import wire_engagement

        wcfg = self._config.moe
        E = self._num_experts()
        # the bucketed wire is a request only below stage 3 (it falls back
        # to the implicit reduction there)
        if E <= 1 or not wcfg.explicit or wcfg.dispatch != "sorted" or (
                self._config.comm_config.gradient_reduction == "bucketed"
                and self._config.zero_optimization_stage < 3):
            return ()
        engaged = wire_engagement(
            wcfg, E, self.train_micro_batch_size_per_gpu() *
            self.dp_world_size)
        return engaged[1] if engaged is not None else ()

    def _build_bucket_plan(self):
        """The bucketed gradient wire's static plan (engine.py:1080), or
        None for the implicit wire.  Unlike the JAX engine the plan is
        built at one rank too, wherever a process group is: the wire
        then runs as collectives of one."""
        cc = self._config.comm_config
        if cc.gradient_reduction != "bucketed":
            return None
        if self._config.zero_optimization_stage >= 3:
            log_dist("bucketed gradient wire requested but unavailable — "
                     "falling back to implicit XLA reduction: ZeRO-3 "
                     "(gathering the full param tree at the shard_map "
                     "boundary would defeat param sharding)", ranks=[0])
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

    def _build_qwz_gather(self):
        """qwZ (engine.py:1132-1170): the blockwise-quantized stage-3
        parameter gather (zero/partition.QuantizedWeightGather), or None
        when not requested or not applicable, which is logged."""
        qw = self._config.zero_config.quantized_weights
        if not qw:
            return None
        blockers = []
        if self._config.zero_optimization_stage < 3:
            blockers.append("ZeRO stage < 3 (parameters are replicated — "
                            "there is no gather to quantize)")
        if self.dp_world_size <= 1:
            blockers.append("dp==1 (nothing to gather)")
        if blockers:
            log_dist("zero_optimization.quantized_weights requested but "
                     "unavailable — parameters gather at full width: "
                     + "; ".join(blockers), ranks=[0])
            return None
        gather = QuantizedWeightGather(
            self.zero_plan, wire=qw,
            block=self._config.comm_config.quant_block_size,
            groups=stage3.unit_groups(self.module, self._param_names))
        if not gather.active:
            log_dist("zero_optimization.quantized_weights: no stage-3 "
                     "leaf is data-sharded (all below min_size_to_shard) "
                     "— parameters gather at full width", ranks=[0])
            return None
        log_dist(gather.describe(), ranks=[0])
        return gather

    def _owned_masters(self):
        """The slices of the masters this rank's optimizer updates."""
        return [lp.owned(p) for lp, p in zip(self.zero_plan.leaves,
                                             self._masters)]

    def _full_masters(self, gather_sliced: bool = True):
        """The whole fp32 masters, exact on every rank: where the other
        ranks' slices hold compute-dtype values (ZeRO 1/2 in bf16/fp16),
        copies with every slice from its owner by an fp32 all-gather,
        every local expert leaf gathered whole from its owners, and at
        stage 3 every sharded leaf gathered whole in fp32 (collectives:
        every rank calls this).  `gather_sliced` False leaves the stage-3
        leaves as this rank's slices."""
        if self._offload is not None:
            full = [None] * len(self._masters)
            for k, i in enumerate(self._jax_order):
                full[i] = torch.from_numpy(self._offload.masters[k]).view(
                    self._offload.shapes[k])
            return full
        plan = self.zero_plan
        full = list(self._masters)
        idx = plan.gathered
        if idx and gather_sliced:
            whole = plan.gather_whole(idx, [full[i] for i in idx],
                                      torch.float32)
            for i, t in zip(idx, whole):
                full[i] = t
        if self._dp and 1 <= plan.stage < 3 and plan.partitioned and \
                self.compute_dtype != torch.float32:
            full = [p.detach().clone() for p in self._masters]
            plan.all_gather_slices(full, self._owned_masters(),
                                   torch.float32)
        if plan.expert_local:
            full = [dist.all_gather(p.detach(), plan.expert_group_axis)
                    if lp.local else p for p, lp in zip(full, plan.leaves)]
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
    # run monitor and resilience (engine.py:275-304, 740-975)
    # ------------------------------------------------------------------

    def _init_observability(self):
        """The timers, the TensorBoard sink, the run monitor, the fault
        plan / retry policy / watchdog and the SIGTERM handler
        (engine.py:275-304), in the JAX engine's order."""
        from ..utils.timer import SynchronizedWallClockTimer

        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size(),
            steps_per_output=self.steps_per_print() or 50)
        self.timers = SynchronizedWallClockTimer()
        self._wall_clock_breakdown = bool(self._config.wall_clock_breakdown)
        self.monitor = None
        if self._config.tensorboard_enabled and dist.get_rank() == 0:
            from ..utils.tensorboard import TensorBoardMonitor

            self.monitor = TensorBoardMonitor(
                self._config.tensorboard_output_path,
                self._config.tensorboard_job_name)
        self._flops_profiled = False
        self._flops_stats = None
        self._last_loss = None
        self.run_monitor = self._init_run_monitor()
        self._watchdog = self._init_resilience()
        self._init_preemption()

    def _init_run_monitor(self):
        """Per-rank JSONL event stream + profiler capture window +
        multi-rank heartbeats (monitor/monitor.py).  The TensorBoard
        monitor (if configured) becomes one sink beside the stream."""
        mc = self._config.monitor_config
        self._tracer = None
        self._trace_on = False
        if not mc.enabled:
            return None
        from ..monitor import RunMonitor

        extra = {
            "train_batch_size": self.train_batch_size(),
            "micro_batch_size": self.train_micro_batch_size_per_gpu(),
            "gradient_accumulation_steps":
                self.gradient_accumulation_steps(),
            "precision": self._config.precision,
            "zero_stage": self._config.zero_optimization_stage,
            "model": type(self.module).__name__,
        }
        rm = RunMonitor(mc, tensorboard=self.monitor, manifest_extra=extra,
                        device=self.device)
        # span tracing (monitor/tracing.py): the recorder and a per-step
        # sampling gate, resampled at every optimizer boundary so a whole
        # global batch traces (or not) as a unit
        self._tracer = rm.tracer
        if rm.tracer is not None:
            self._trace_on = rm.tracer.sampled(self.global_steps + 1)
        return rm

    def _dispatch_tracer(self):
        """The gate every training trace site goes through: the recorder
        only when tracing is enabled AND the in-flight step is sampled.
        No site synchronises the device, so traced and untraced runs are
        bitwise identical."""
        tr = self._tracer
        return tr if (tr is not None and self._trace_on) else None

    def _timed_next(self, data_iter):
        return timed_next(data_iter, tracer=self._dispatch_tracer(),
                          step=self.global_steps + 1)

    def _init_resilience(self):
        """Install the `faults` block (runtime/resilience.py): the
        process-global fault plan (cleared when this engine has no rules,
        so a previous engine's injection never leaks into a new run), the
        transient retry policy, and — when enabled — the StepWatchdog
        armed beside the run monitor (its snapshots land in the monitor
        run dir)."""
        fc = self._config.faults_config
        plan = fc.plan if fc.enabled else None
        if plan is not None:
            plan.rank = dist.get_rank()
        resilience.install_fault_plan(plan)
        resilience.install_retry_policy(fc.retry_policy)
        if not fc.watchdog_enabled:
            return None
        run_dir = (self.run_monitor.run_dir
                   if self.run_monitor is not None else None)
        snap_dir = fc.watchdog_snapshot_dir or run_dir or \
            os.path.join(os.getcwd(), "dstpu_watchdog")
        wd = resilience.StepWatchdog(
            fc.watchdog_deadline_s, snap_dir,
            escalate_dir=run_dir or snap_dir,
            poll_s=fc.watchdog_poll_s, rank=dist.get_rank(),
            first_beat_mult=fc.watchdog_first_beat_mult)
        if self._tracer is not None:
            # flight recorder: a trip snapshot ships the last N trace
            # events, so a wedged step carries its own timeline
            wd.set_flight_recorder(self._tracer.last_events)
        return wd

    def _init_preemption(self):
        """SIGTERM = save-if-possible (engine.py:822-862): with
        `checkpoint.preempt_save_dir` set, a SIGTERM sets a flag the step
        boundary consumes — an emergency checkpoint into that directory,
        committed, then a clean exit, so a relaunch resumes from the
        preemption point instead of the last periodic save."""
        self._preempt_requested = False
        self._prev_sigterm = None
        self._preempt_save_dir = self._config.checkpoint_preempt_save_dir
        if not self._preempt_save_dir:
            return
        import signal

        def handler(signum, frame):
            # signal context: flag + log only — the save runs on the
            # training thread at the next step boundary, where the engine
            # state is consistent
            self._preempt_requested = True
            logger.warning(
                "SIGTERM received: emergency checkpoint will be saved "
                f"to {self._preempt_save_dir} at the next step boundary, "
                "then this process exits cleanly")

        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, handler)
            log_dist(
                "preemption safety armed: SIGTERM checkpoints to "
                f"{self._preempt_save_dir} at the next step boundary",
                ranks=[0])
        except ValueError:
            # signal handlers install only on the main thread
            self._prev_sigterm = None
            logger.warning(
                "checkpoint.preempt_save_dir is set but this engine was "
                "constructed off the main thread, where signal handlers "
                "cannot install — SIGTERM preemption checkpointing is "
                "DISABLED; call engine.request_preemption_checkpoint() "
                "from your own handler instead")

    def _uninstall_preemption_handler(self):
        if self._prev_sigterm is None:
            return
        import signal

        try:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
        except ValueError:
            pass
        self._prev_sigterm = None

    def request_preemption_checkpoint(self):
        """Programmatic twin of the SIGTERM handler: the next step
        boundary saves the emergency checkpoint and exits cleanly."""
        self._preempt_requested = True

    @property
    def preemption_requested(self) -> bool:
        return bool(self._preempt_requested)

    def _maybe_preempt_checkpoint(self):
        """Step-boundary tail of the SIGTERM contract: save, commit,
        exit.  Runs on the training thread with the engine at a clean
        post-step state — the saved tag resumes bitwise."""
        if not self._preempt_requested:
            return
        self._preempt_requested = False
        save_dir = self._preempt_save_dir
        if not save_dir:
            logger.warning(
                "preemption checkpoint requested but no "
                "checkpoint.preempt_save_dir is configured — continuing "
                "WITHOUT saving (the relaunch resumes from the last "
                "periodic checkpoint)")
            return
        tag = f"preempt_step{self.global_steps}"
        logger.warning(
            f"preemption: saving emergency checkpoint {tag!r} to "
            f"{save_dir} (step {self.global_steps})")
        self.save_checkpoint(save_dir, tag=tag)
        # an async save must COMMIT before the process may exit
        ckpt_io.flush_pending()
        logger.warning(
            f"preemption: checkpoint {tag!r} committed; exiting cleanly "
            "for the supervisor/scheduler to relaunch")
        self.finalize_monitoring()
        raise SystemExit(0)

    def _run_step_fn(self, fn, per_step_mult=1.0):
        """`fn()` (one device step function's call), counted by the flops
        profiler when the run monitor still lacks its flops a step or this
        is the profiler's `profile_step` (engine.py:931-950, 1900-1932).
        The JAX engine analyses its compiled program before the call; here
        the count is taken over this very call (FlopCounterMode plus the
        kernels' own products), which changes no value.  Returns (fn's
        result, the started FlopsProfiler or None)."""
        profiling = self._maybe_profile_flops()
        rm = self.run_monitor
        monitor_flops = (rm is not None and rm.flops_per_step is None
                         and rm.config.flops)
        if profiling is None and not monitor_flops:
            return fn(), None
        from ..profiling.flops_profiler.profiler import analyze_fn

        stats = analyze_fn(fn)
        out = stats.pop("result")
        if profiling is not None:
            self._flops_stats = stats
        if monitor_flops:
            self._maybe_monitor_flops(stats, per_step_mult)
        return out, profiling

    def _maybe_monitor_flops(self, stats, per_step_mult=1.0):
        """The run monitor's flops a step, resolved ONCE from a count of
        the first step (engine.py:931-950); the monitor then derives the
        achieved TFLOPs from it every step."""
        rm = self.run_monitor
        rm.flops_per_step = float(stats["flops"]) * per_step_mult
        rm.emit("flops", {"flops_per_step": rm.flops_per_step,
                          "per_step_mult": per_step_mult})

    def _maybe_profile_flops(self):
        """FLOPS profiler hook (reference engine.py:966-1019): at
        `profile_step`, count and time this step's call."""
        cfg = self._config.flops_profiler_config
        if not cfg.enabled or self._flops_profiled or \
                self.global_steps != cfg.profile_step:
            return None
        from ..profiling.flops_profiler.profiler import FlopsProfiler

        self._flops_profiled = True
        prof = FlopsProfiler()
        prof.start_profile()
        return prof

    def _finish_profile(self, profiling, loss):
        if profiling is None:
            return
        params = (self._masters if self._masters
                  else list(self.module.parameters()))
        profiling.stop_profile(params=params, sync=loss)
        profiling.stats.update(self._flops_stats)
        profiling.stats.pop("result", None)
        cfg = self._config.flops_profiler_config
        profiling.print_model_profile(
            profile_step=self.global_steps, top_modules=cfg.top_modules,
            detailed=cfg.detailed, dtype=self._config.precision)
        self._flops_stats = profiling.stats

    def _monitor_scalar(self, x):
        """Device scalar -> python float for a step event.  With
        sync_timing false the user opted out of per-step syncs, so a CUDA
        value whose stream still has work in flight is SKIPPED rather
        than waited for — the event omits it (engine.py:952-970)."""
        if x is None:
            return None
        if torch.is_tensor(x) and x.is_cuda and \
                not self.run_monitor.sync_timing and \
                not torch.cuda.current_stream(x.device).query():
            return None
        try:
            return float(x)
        except (TypeError, ValueError, RuntimeError):
            return None

    def _emit_run_event(self, grad_norm=None, overflow=None, **extra):
        """One schema-versioned step event on this rank (called from
        every step path once the counters are settled)."""
        rm = self.run_monitor
        if rm is None:
            return
        metrics = {
            "loss": self._monitor_scalar(self._last_loss),
            "lr": self._current_lr(),
            "loss_scale": self._monitor_scalar(
                self._scaler_state["cur_scale"]),
            "skipped_steps": self._skipped_steps,
            "samples_per_sec": round(
                self.tput_timer.avg_samples_per_sec(), 2),
        }
        ov = self._monitor_scalar(overflow)
        if ov is not None:
            metrics["overflow"] = bool(ov)
        gn = self._monitor_scalar(grad_norm)
        if gn is not None:
            metrics["grad_norm"] = gn
        metrics.update(extra)
        rm.step_end(self.global_steps, **metrics)

    def _log_timers(self):
        """Windowed wall-clock breakdown (reference engine.py:1239-1284):
        per-step means over the steps_per_print window."""
        window = self.steps_per_print() or 1
        if self.global_steps % window == 0:
            self.timers.log(["forward", "step"], normalizer=window,
                            memory_breakdown=self._config.memory_breakdown)

    def _emit_monitor_scalars(self):
        """TensorBoard scalars (reference engine.py:1223-1237)."""
        if self.monitor is None:
            return
        if self._last_loss is not None:
            self.monitor.add_scalar("Train/Samples/train_loss",
                                    float(self._last_loss),
                                    self.global_samples)
        cur = self._current_lr()
        if cur is not None:
            self.monitor.add_scalar("Train/Samples/lr", cur,
                                    self.global_samples)
        self.monitor.add_scalar("Train/Samples/loss_scale",
                                float(self._scaler_state["cur_scale"]),
                                self.global_samples)

    def _after_step(self, grad_norm, overflow):
        """The monitoring tail every step path runs (engine.py:2113-2123):
        with a monitor the deferred overflow is settled first (the
        monitor syncs anyway), then the TensorBoard scalars, the
        throughput timer and the step event."""
        if self.monitor is not None or (
                self.run_monitor is not None
                and self.run_monitor.sync_timing):
            self._resolve_pending_overflow()
        self._emit_monitor_scalars()
        self.tput_timer.stop(report_speed=False)
        self._emit_run_event(grad_norm=grad_norm, overflow=overflow)

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
        """`forward` on this rank's rows, under the run monitor's step
        start and `forward` span (engine.py:1720-1745)."""
        rm = self.run_monitor
        if rm is not None and self.is_gradient_accumulation_boundary():
            rm.step_start(self.global_steps)
        sp = rm.span("forward") if rm is not None else None
        if self._infinity is not None:
            loss = self._infinity_forward(batch)
        else:
            loss = self._device_forward(batch, generator)
        if sp is not None:
            sp.close(sync=loss if rm.sync_timing else None)
        return loss

    def _device_forward(self, batch, generator):
        batch = _place(batch, self.device)
        gen = generator if generator is not None else self._generator
        gas = self.gradient_accumulation_steps()
        fused = gas == 1 and self._offload is None
        if fused:
            self._resolve_pending_overflow()
        if self.is_gradient_accumulation_boundary():
            self.tput_timer.start()   # times one full global batch
        if self._wall_clock_breakdown:
            self.timers("forward").start()
        if fused:
            lr = self._current_lr()
            (loss, overflow, grad_norm, self._opt_state, new_scaler), prof = \
                self._run_step_fn(lambda: self._step_fns["full"](batch, gen,
                                                                 lr))
            # the new scale takes effect at step(): engine.loss_scale keeps
            # the pre-update value until the boundary
            self._pending_full = (new_scaler, overflow, grad_norm)
        else:
            # split path: flops a step ~= micro flops x gas
            loss, prof = self._run_step_fn(
                lambda: self._step_fns["micro"](batch, gen),
                per_step_mult=float(gas))
        if self._wall_clock_breakdown:
            # one fused program: this IS forward + backward (+ step)
            self.timers("forward").stop(sync=loss)
        self._finish_profile(prof, loss)
        self._cached = loss
        self._last_loss = loss
        return loss

    def _infinity_forward(self, batch):
        """A streamed micro step (engine.py:1832-1851); the host update
        runs at the accumulation boundary over the summed fp32 gradients,
        and step() does the bookkeeping through `_pending_full`."""
        gas = self.gradient_accumulation_steps()
        if self.micro_steps % gas == 0:
            self._resolve_pending_overflow()   # settle the previous step
            self.tput_timer.start()
        loss = self._infinity.micro_step(batch)
        if self.micro_steps % gas == gas - 1:
            overflow = self._infinity.apply_accumulated(
                lr=self._current_lr(),
                clip=float(self._config.gradient_clipping or 0.0))
            self._pending_full = (self._scaler_state, bool(overflow),
                                  torch.zeros((), device=self.device))
        self._cached = loss
        self._last_loss = loss
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
        # chaos runtime: every optimizer-step boundary (all four step
        # paths funnel through here) advances the fault plan's step
        # schedule, fires the `engine.step` site and beats the watchdog
        resilience.step_boundary(self.global_steps)
        if self._watchdog is not None:
            self._watchdog.beat(self.global_steps)
            tr = self._dispatch_tracer()
            if tr is not None:
                tr.instant("watchdog_beat", "watchdog",
                           step=self.global_steps)
        if self._offload is not None:
            self._offload_step()
        elif self._pending_full is not None:
            self._fused_step_bookkeeping()
        else:
            self._boundary_step()
        # boundary tail: the engine is at a clean post-step state, where
        # a SIGTERM'd run can checkpoint and exit
        self._maybe_preempt_checkpoint()
        if self._tracer is not None:
            # resample the trace gate for the next global batch
            self._trace_on = self._tracer.sampled(self.global_steps + 1)

    def _offload_step(self):
        """The host step (engine.py:2238-2277): gradients to the host,
        the native Adam on the fp32 masters, the new weights to the
        device; loss-scale bookkeeping as on the device path."""
        if self._wall_clock_breakdown:
            self.timers("step").start()
        denom = float(self._scaler_state["cur_scale"]) * \
            self.gradient_accumulation_steps()
        if self._config.prescale_gradients:
            denom /= float(self._config.gradient_predivide_factor or 1.0)
        order = self._jax_order
        grads = [self._grad_acc[i] for i in order]
        _, overflow, norm = self._offload.step(
            grads, denom, self._current_lr(),
            clip=float(self._config.gradient_clipping or 0.0),
            out=[self._masters[i] for i in order])
        if self._store_gradients:
            # the host path stashes the unscaled gradients BEFORE the clip
            # (the native step clips inside: JAX's documented divergence
            # from the device path's post-clip stash), zeros on overflow
            self.stored_gradients = {
                self._param_names[i]: (
                    np.zeros(tuple(g.shape), np.float32) if overflow else
                    (g.float() / denom).cpu().numpy())
                for i, g in zip(order, grads)}
        self._scaler_state = self.loss_scaler.jit_update(
            self._scaler_state, torch.tensor(overflow, device=self.device))
        self._grad_norm = norm
        self._grad_acc = None
        self.global_steps += 1
        self._update_pld()
        if overflow:
            self._skipped_steps += 1
            log_dist(f"offload step overflow: skipping, new loss scale "
                     f"{float(self._scaler_state['cur_scale'])}", ranks=[0])
        elif self.lr_scheduler is not None:
            self.lr_scheduler.step()
        if self._wall_clock_breakdown:
            self.timers("step").stop()   # host step: already synchronous
            self._log_timers()
        self._after_step(None, overflow)

    @property
    def store_gradients(self) -> bool:
        """When True, each optimizer step of the offload path stashes the
        unscaled gradients, before the clip, in `stored_gradients`
        ({name: host fp32 array}; zeros on a skipped step)."""
        return self._store_gradients

    @store_gradients.setter
    def store_gradients(self, value):
        value = bool(value)
        if value and self._infinity is not None:
            raise NotImplementedError(
                "gradient stashing is unavailable under ZeRO-Infinity "
                "streaming (per-block grads are consumed as they stream)")
        if value and self._offload is None:
            raise NotImplementedError(
                "gradient stashing on the device step paths is not ported "
                "to deepspeed_tpu_torch yet (ROADMAP queue 1: the "
                "production runtime); the offload path stashes")
        self._store_gradients = value
        if not value:
            self.stored_gradients = None

    def _boundary_step(self):
        """The micro/apply boundary: apply the accumulated gradients,
        under the `step` span and timer."""
        if self._wall_clock_breakdown:
            self.timers("step").start()
        rsp = (self.run_monitor.span("step")
               if self.run_monitor is not None else None)
        self._resolve_pending_overflow()
        (overflow, self._grad_norm, self._opt_state,
         self._scaler_state) = self._step_fns["apply"](self._current_lr())
        self._finish_step(overflow)
        if rsp is not None:
            rsp.close(sync=self._grad_norm if self.run_monitor.sync_timing
                      else None)
        if self._wall_clock_breakdown:
            self.timers("step").stop(sync=self._grad_norm)
            self._log_timers()
        self._after_step(self._grad_norm, overflow)

    def _fused_step_bookkeeping(self):
        """Host-side tail of the gas == 1 step, whose update forward()
        already made."""
        new_scaler, overflow, self._grad_norm = self._pending_full
        self._pending_full = None
        self._scaler_state = new_scaler
        self._finish_step(overflow)
        if self._wall_clock_breakdown:
            self._log_timers()
        self._after_step(self._grad_norm, overflow)

    def _finish_step(self, overflow):
        # the step's MoE routing stats go to the host in one asynchronous
        # copy; the counters are credited once it lands (no wait here)
        from ..moe.dispatch import flush_dispatch_stats

        flush_dispatch_stats()
        self.global_steps += 1
        self._update_pld()
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

    def _update_pld(self):
        """The next step's keep probability (engine.py:2111-2112)."""
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self.global_steps)

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
            fetch = lambda: self._timed_next(data_iter)  # noqa: E731
        else:
            fetch = lambda: self._local_rows(  # noqa: E731
                self._timed_next(data_iter))
        feed = self._data_feed(data_iter, fetch)
        losses = []
        for _ in range(self.gradient_accumulation_steps()):
            batch = feed.next() if feed is not None else fetch()
            losses.append(self._forward(batch))
            self.backward()
            if feed is not None:
                feed.schedule()   # the next batch's copy rides this step
        # the gas batches are consumed before the boundary, where a
        # preemption checkpoint may be taken: its cursor must count them
        # (the JAX engine advances after step(), so its preemption tag
        # taken inside train_batch would resume one batch early)
        self._advance_sample_cursor(data_iter)
        self.step()
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
        """Teardown (engine.py:1034): stops the input pipeline's threads,
        restores the previous SIGTERM handler, blocks on any async
        checkpoint write still in flight (shutdown never abandons an
        uncommitted tag), stops the watchdog, closes the run monitor
        (its summaries; with more than one rank a collective: call it on
        every rank) and flushes TensorBoard."""
        self.close_data_pipeline()
        self._uninstall_preemption_handler()
        ckpt_io.flush_pending()
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
        if self.run_monitor is not None:
            self.run_monitor.close()
        if self.monitor is not None:
            self.monitor.flush()

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
        if self._infinity is not None:
            return self._infinity.eval_loss(batch)
        args = (_place(self._local_rows(batch), self.device),)
        kwargs = {"generator": generator, "train": False,
                  **self._model_kwargs()}
        if self._stage3 is not None:
            # the stage-3 leaves gathered a unit at a time, as in training
            with stage3.active(self._stage3), self._stage3.root_scope():
                out = self.module(*args, **kwargs)
        else:
            cparams = {n: p.to(self.compute_dtype)
                       for n, p in zip(self._param_names, self._masters)}
            out = torch.func.functional_call(self.module, cparams, args,
                                             kwargs)
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
        """{name: fp32 master tensor} (the module's parameters); at ZeRO
        stage 3 whole fp32 copies of the sharded leaves, gathered (a
        collective: every rank reads it).  Under Offload and Infinity the
        host fp32 masters (views under Offload, copies under Infinity)."""
        if self._infinity is not None:
            return {n: torch.from_numpy(a) for n, a in
                    flatten_tree(self._infinity.masters_tree()).items()}
        if self._stage3 is not None or self._offload is not None:
            return dict(zip(self._param_names, self._full_masters()))
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
        if self.progressive_layer_drop is not None:
            return self.progressive_layer_drop.get_theta()
        return None

    def pld_enabled(self):
        return self._config.pld_enabled

    def pld_params(self):
        return self._config.pld_params

    def pld_theta(self):
        return (self._config.pld_params or {}).get(const.PLD_THETA, 1.0)

    def pld_gamma(self):
        return (self._config.pld_params or {}).get(const.PLD_GAMMA, 0.001)

    def get_summary_writer(self):
        return getattr(self.monitor, "writer", None)

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
        """Every hop of the gradient reduction accumulates in fp32 (the
        bucketed wire's plan says; the implicit reduction does)."""
        plan = self.bucket_plan
        return True if plan is None else plan.exact_fp32

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
        return self._config.tensorboard_enabled

    def zero_optimization(self):
        return self._config.zero_enabled

    def zero_optimization_stage(self):
        return self._config.zero_optimization_stage

    def zero_optimization_partition_gradients(self):
        return self.zero_optimization_stage() >= 2

    def zero_optimization_partition_weights(self):
        return self.zero_optimization_stage() >= 3

    def zero_param_persistence_threshold(self):
        return self._config.zero_config.param_persistence_threshold

    def zero_cpu_offload(self):
        return self._config.zero_config.cpu_offload

    def zero_allow_untested_optimizer(self):
        return self._config.zero_allow_untested_optimizer

    def module_state_dict(self):
        """{name: fp32 numpy copy} of the module weights (the exact
        masters: a collective under ZeRO >= 1 in bf16/fp16; the host
        masters under Offload and Infinity)."""
        if self._infinity is not None:
            return {n: t.numpy() for n, t in self.params.items()}
        return {n: p.detach().cpu().numpy().copy()
                for n, p in zip(self._param_names, self._full_masters())}

    def load_module_state_dict(self, state_dict, strict=True):
        """Replace the weights from {name: array}; strict: the same names.
        Under Offload and Infinity the host masters take the values."""
        host = self._infinity is not None or self._offload is not None
        names = set(self.params) if host else set(self._param_names)
        if strict and set(state_dict) != names:
            raise ValueError(
                f"state_dict keys {sorted(state_dict)} do not match the "
                f"module's {sorted(names)}")
        if host:
            full = {n: t.numpy() for n, t in self.params.items()}
            full.update(state_dict)
            self._install_module_weights(unflatten_tree(
                {n: np.array(v) for n, v in full.items()}))
            return
        self._wait_snapshot()
        with torch.no_grad():
            for n, p, lp in zip(self._param_names, self._masters,
                                self.zero_plan.leaves):
                if n in state_dict:
                    t = torch.as_tensor(np.asarray(state_dict[n]))
                    p.copy_(lp.from_full(t) if lp.held_sliced else t)

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
            **(self.zero_plan.partition_layout()
               if self.zero_plan is not None else {}),
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
        inf = self._infinity
        inf_sd = None
        if inf is not None:
            model_pieces = {}
            if inf.pager is not None:
                # NVMe-paged masters: group files written from the pages,
                # never the whole fp32 set in RAM (engine.py:3036-3041)
                module, inf_sd = inf.save_streamed(
                    os.path.join(save_dir, str(tag)))
            else:
                module = inf.masters_tree()
        else:
            module, model_pieces = self._module_pieces()
        model_state = {
            "module": module,
            "lr_scheduler": (self.lr_scheduler.state_dict()
                             if self.lr_scheduler is not None else None),
            "loss_scaler": dict(self._scaler_state),
            "rng_key": self._rng_key,
            TORCH_RNG_STATE: self._generator.get_state(),
            **self._client_state(client_state),
        }
        if self.progressive_layer_drop is not None:
            model_state.update({"progressive_layer_drop": True,
                                "pld_theta": float(self.get_pld_theta())})
        if inf is not None:
            opt_tree, pieces = inf_sd or inf.state_dict(), {}
        elif self._offload is not None:
            # the host masters and the host Adam's state (engine.py:3042)
            opt_tree, pieces = self._offload.state_dict(), {}
        else:
            opt_tree, pieces = self._opt_state_pieces()
        pieces.update(model_pieces)
        optim_state = {
            "optimizer_state": opt_tree,
            "offload": self._offload is not None or inf is not None,
            # json round trip: msgpack takes no tuples (betas)
            "optimizer_hparams": (json.loads(json.dumps(
                self.optimizer.state_dict()))
                if hasattr(self.optimizer, "state_dict") else None),
            "zero_stage": self.zero_optimization_stage(),
        }
        if self._onebit_hot:
            optim_state[ONEBIT_RANK_ERRORS] = self._onebit_error_pieces(
                pieces)
        async_save = self._config.checkpoint_async_save
        ready = None
        if async_save:
            (model_state, optim_state, pieces), ready = \
                self._async_ckpt_snapshot((model_state, optim_state, pieces))
        snap = COUNTERS.snapshot()
        t0_save = time.perf_counter()
        ckpt_io.save_checkpoint_state(
            save_dir, tag, model_state, optim_state, save_latest=save_latest,
            async_save=async_save, meta=self._checkpoint_meta(), ready=ready,
            pieces=pieces, rank=dist.get_rank(),
            commit_timeout_ms=self._config.checkpoint_commit_timeout_ms)
        tr = self._dispatch_tracer()
        if tr is not None:
            tr.add_complete(
                "ckpt_stall", "ckpt",
                dur_us=int((time.perf_counter() - t0_save) * 1e6),
                tag=str(tag), step=self.global_steps)
        if self.run_monitor is not None:
            delta = COUNTERS.delta_since(snap)
            self.run_monitor.emit("ckpt", {
                "tag": str(tag),
                "async": async_save,
                "stall_ms": round(delta.get("ckpt.stall_ms", {})
                                  .get("bytes", 0) / 1000.0, 3),
                "pending": ckpt_io.pending_count(),
                "step": self.global_steps,
            })
        return True

    def _module_pieces(self):
        """The module tree for a tag, and this rank's pieces of it: at
        ZeRO stage 3 each sharded leaf is a `shard_marker` under a
        `model:` key and every rank writes its slice (JAX's
        `_split_sharded(model_state, ..., "model:")`,
        checkpointing.py:719); every other leaf whole."""
        plan, names = self.zero_plan, self._param_names
        full = self._full_masters(gather_sliced=False)
        pieces = {}
        for i in plan.gathered:
            lp = plan.leaves[i]
            path = ["module"] + [int(c) if c.isdigit() else c
                                 for c in names[i].split(".")]
            key = ckpt_io.shard_key("model:", path)
            pieces[key] = {"index": lp.piece_index(lp.index),
                           "piece": full[i]}
            full[i] = ckpt_io.shard_marker(key, lp.shape, "float32",
                                           lp.parts)
        return unflatten_tree(dict(zip(names, full))), pieces

    def _opt_state_pieces(self):
        """The optimizer state as the JAX tree, each partitioned moment a
        `shard_marker`, and this rank's pieces of them ({key: {"index",
        "piece"}}): written by the ranks of the first outer group only,
        one rank a distinct piece, as JAX writes the lowest device's
        replica (checkpointing.py:334).  A local expert leaf's piece is
        its owner's experts, written by every owner where every rank
        holds distinct experts."""
        plan, names = self.zero_plan, self._param_names
        if hasattr(self.optimizer, "serialize_state"):
            # a client torch.optim optimizer: JAX's OptaxOptimizer layout
            if plan.partitioned or plan.expert_local:
                raise NotImplementedError(
                    "checkpointing a client optimizer's partitioned state "
                    "is not ported to deepspeed_tpu_torch yet (ROADMAP "
                    "queue 1: the production runtime)")
            return self.optimizer.serialize_state(self._opt_state,
                                                  self._jax_order), {}
        if not (plan.partitioned or plan.expert_local):
            return opt_state_to_jax(names, self._opt_state), {}
        writes = (not self.mesh_info.hierarchical or
                  self.mesh_info.axis_index(DATA_OUTER_AXIS) == 0)
        experts_distinct = plan.expert_replica_axis is None
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
                if writes or (lp.local and experts_distinct):
                    pieces[key] = {"index": lp.piece_index(lp.index),
                                   "piece": t}
            state[k] = out
        return opt_state_to_jax(names, state), pieces

    def _onebit_error_pieces(self, pieces):
        """Every rank's 1-bit errors on the compressed path: a marker of
        shape [dp, *leaf] a leaf in the tag, this rank's row a piece in
        its own rank file (added to `pieces`).  The optimizer state proper
        holds rank 0's, the layout of a one-rank JAX tag."""
        dp, r = self.dp_world_size, self.dp_rank
        out = {}
        for k in ONEBIT_ERRORS:
            leaves = []
            for name, t in zip(self._param_names, self._opt_state[k]):
                path = [ONEBIT_RANK_ERRORS, k] + [
                    int(c) if c.isdigit() else c for c in name.split(".")]
                key = ckpt_io.shard_key("optim:", path)
                shape = (dp,) + tuple(t.shape)
                leaves.append(ckpt_io.shard_marker(key, shape, "float32",
                                                   dp))
                pieces[key] = {"index": [[r, r + 1]] + [
                    [0, int(n)] for n in t.shape], "piece": t[None]}
            out[k] = unflatten_tree(dict(zip(self._param_names, leaves)))
        return out

    def _restore_opt_state(self, optim_state):
        """The device optimizer state from a tag's optim states."""
        tree = optim_state["optimizer_state"]
        if hasattr(self.optimizer, "deserialize_state"):
            self._opt_state = self.optimizer.deserialize_state(
                tree, self._opt_state, self._jax_order)
            return
        restored = self._partition_opt_state(opt_state_from_jax(
            self._param_names, tree))
        if getattr(self.optimizer, "handles_dp_reduction", False):
            rows = optim_state.get(ONEBIT_RANK_ERRORS)
            for k in ONEBIT_ERRORS:
                if self._onebit_hot and rows is not None and \
                        np.shape(flatten_tree(rows[k])[
                            self._param_names[0]])[0] == self.dp_world_size:
                    flat = flatten_tree(rows[k])
                    restored[k] = [np.asarray(flat[n])[self.dp_rank]
                                   for n in self._param_names]
                elif self._onebit_hot or k not in restored:
                    # a tag of another world (or JAX's compressed path,
                    # which drops them): the errors restart at zero, as in
                    # the JAX engine
                    restored[k] = [torch.zeros_like(t)
                                   for t in self._opt_state[k]]
                    log_dist(f"load_checkpoint: 1-bit {k} restart at zero "
                             "(none saved for this world)", ranks=[0])
        self._opt_state = _match_state(restored, self._opt_state)

    def _partition_opt_state(self, restored):
        """Whole restored moments -> this rank's slices of them (a tag
        written at any world size and expert-parallel width re-partitions
        to this one)."""
        out = {}
        for k, v in restored.items():
            if isinstance(v, (list, tuple)) and len(v) == len(self._masters):
                v = [lp.from_full(t if torch.is_tensor(t) else
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
        """The masters (the module's parameters) from a JAX-shaped tree
        of whole leaves (a rank keeps its experts of each expert leaf and
        its slice of each stage-3 leaf); a missing, extra or misshapen
        leaf raises before any write."""
        self._wait_snapshot()
        if self._infinity is not None:
            self._infinity.load_masters_tree(tree)
            return
        plan = self.zero_plan
        if plan.expert_local:
            lp = next(lp for lp in plan.leaves if lp.local)
            tree = slice_expert_leaves(tree, lp.parts, lp.index)
        if plan.gathered:
            # this rank's slices of the whole stage-3 leaves, whatever
            # stage and world size wrote them
            flat = flatten_tree(tree)
            for i in plan.gathered:
                name, lp = self._param_names[i], plan.leaves[i]
                v = flat.get(name)
                if v is not None and tuple(np.shape(v)) == lp.shape:
                    cut = [slice(None)] * len(lp.shape)
                    cut[lp.dim] = slice(lp.start, lp.start + lp.length)
                    flat[name] = (lp.from_full(v) if torch.is_tensor(v)
                                  else np.asarray(v)[tuple(cut)])
            tree = unflatten_tree(flat)
        load_jax_params(self.module, tree)
        if self._offload is not None:
            # the fp32 masters unrounded; the device weights were cast
            flat = flatten_tree(tree)
            self._offload.load_masters(
                [flat[self._param_names[i]] for i in self._jax_order])

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True):
        """Restore a tag written by either engine (engine.py:3193);
        returns (tag dir, client state), or (None, {}) when there is
        nothing to resume from.  An uncommitted or incomplete tag raises
        CheckpointIntegrityError."""
        inf = self._infinity
        # a paged Infinity engine walks the stream-group files one at a
        # time; every other engine gets the markers resolved
        paged = inf is not None and inf.pager is not None
        try:
            ckpt_dir, model_state, optim_state = \
                ckpt_io.load_checkpoint_state(load_dir, tag,
                                              resolve_streams=not paged)
        except FileNotFoundError as e:
            logger.warning(f"load_checkpoint: {e}")
            return None, {}
        marker = ckpt_io.read_tag_meta(load_dir, os.path.basename(ckpt_dir))
        if self.zero_plan is not None:
            change = describe_reshard((marker or {}).get("meta"),
                                      self.zero_plan.partition_layout())
            if change:
                log_dist(change, ranks=[0])
        self._restore_sample_cursor(marker)
        host_tag = optim_state is not None and bool(optim_state.get("offload"))
        load_opt = load_optimizer_states and optim_state is not None
        host_engine = inf is not None or self._offload is not None
        if load_opt and host_tag != host_engine:
            # as in the JAX engine, the moments cross only between engines
            # that keep them on the host
            log_dist("load_checkpoint: the tag's optimizer state "
                     f"({'host' if host_tag else 'device'}) does not match "
                     f"this engine's ({'host' if host_engine else 'device'}"
                     "); the masters load, the Adam moments restart",
                     ranks=[0])
            load_opt = False
        if paged and ckpt_io.has_stream_markers(model_state["module"]):
            inf.load_streamed(ckpt_dir, optim_state["optimizer_state"]
                              if load_opt else None)
        else:
            # load_module_strict is accepted and, as in the JAX engine,
            # the module tree must match
            self._install_module_weights(model_state["module"])
            if load_opt and inf is not None:
                inf.load_state_dict(optim_state["optimizer_state"])
            elif load_opt and self._offload is not None:
                self._offload.load_state_dict(optim_state["optimizer_state"])
            elif load_opt:
                self._restore_opt_state(optim_state)
        if load_opt:
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
        # theta is a function of the step count (JAX's tags carry none)
        self._update_pld()
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

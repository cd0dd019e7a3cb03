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

What the port refuses (config.py raises): offload, pipelines, model / pipe / seq axes above 1, `comm.overlap`, progressive
layer drop, AMP, TensorBoard, the preemption handler; LAMB, 1-bit and
optax optimizers raise here.  Entry points run on the card unless
`device="cpu"` is passed.
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
from ..models.convert import (flatten_tree, is_expert_leaf,
                              jax_leaf_order, load_jax_params,
                              opt_state_from_jax, opt_state_to_jax,
                              slice_expert_leaves, unflatten_tree)
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
from .zero import stage3
from .zero.partition import (QuantizedWeightGather, ZeroShardingPlan,
                             describe_reshard)

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
        collective: every rank reads it)."""
        if self._stage3 is not None:
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
        return False

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
        opt_tree, pieces = self._opt_state_pieces()
        pieces.update(model_pieces)
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

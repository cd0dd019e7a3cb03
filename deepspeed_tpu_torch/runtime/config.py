"""DeepSpeedConfig — the subset of deepspeed_tpu/runtime/config.py that the
single-process training slice honours, with JAX's defaults and errors.

Read: the batch-size triangle (train_batch_size = micro batch ×
gradient_accumulation_steps × data-parallel world size, here 1; the
solver of config.py:1088-1134), `fp16` (loss_scale, initial_scale_power,
loss_scale_window, hysteresis, min_loss_scale, and the fork's
"type": "bfloat16" spelling) and `bf16`, `optimizer`, `scheduler`,
`gradient_clipping`, `prescale_gradients`, `gradient_predivide_factor`,
`steps_per_print`, `wall_clock_breakdown`, `sparse_gradients`, the
`sparse_attention` section (stored as given, config.py:1079), and
`comm.moe` (the MoE token movement, `moe/dispatch.py` `parse_moe_config`,
with `comm.quant_block_size` as its default block; config.py:247-259),
`data_pipeline` (`DeepSpeedDataPipelineConfig`, config.py:263-315) and
`checkpoint` (`tag_validation`, `async_save`, `commit_timeout_ms`;
config.py:1047-1075): an unknown key or a bad value raises ValueError
here, at config time, as in the JAX package.

A section the port cannot honour yet raises `DeepSpeedConfigError` naming
its ROADMAP item, rather than training without it: ZeRO stage >= 1 and
offload, a pipeline section, a mesh with more than one device, progressive
layer drop, AMP, TensorBoard, the wall-clock breakdown and
`checkpoint.preempt_save_dir` (the preemption handler).  (1-bit and
LAMB optimizers are refused by the engine's optimizer selection.)
"""

from __future__ import annotations

import json

from . import constants as c
from .config_utils import (DeepSpeedConfigObject,
                           dict_raise_error_on_duplicate_keys,
                           get_scalar_param)

TORCH_DTYPES = {
    "fp16": "float16", "float16": "float16", "half": "float16",
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "fp32": "float32", "float32": "float32", "float": "float32",
}


class DeepSpeedConfigError(Exception):
    pass


def get_fp16_enabled(param_dict):
    return get_scalar_param(param_dict.get(c.FP16, {}), c.FP16_ENABLED,
                            c.FP16_ENABLED_DEFAULT)


def get_precision(param_dict):
    """The compute dtype name, from `{"bf16": {"enabled": true}}` or the
    EleutherAI fork's fp16 section with "type" (config.py:818)."""
    bf16 = param_dict.get("bf16", param_dict.get("bfloat16", {})) or {}
    if get_scalar_param(bf16, c.FP16_ENABLED, False):
        if get_fp16_enabled(param_dict):
            raise DeepSpeedConfigError(
                "bf16 and fp16 cannot both be enabled")
        return "bfloat16"
    if not get_fp16_enabled(param_dict):
        return "float32"
    raw = get_scalar_param(param_dict.get(c.FP16, {}), c.FP16_TYPE,
                           c.FP16_TYPE_DEFAULT)
    if raw not in TORCH_DTYPES:
        raise DeepSpeedConfigError(
            f"fp16.type must be one of {sorted(set(TORCH_DTYPES))}, got {raw!r}")
    return TORCH_DTYPES[raw]


def _zero_stage(pd) -> int:
    """The ZeRO stage (runtime/zero/config.py: a dict, or the legacy bool
    meaning stage 1)."""
    zero = pd.get(c.ZERO_OPTIMIZATION)
    if zero is None:
        return 0
    if isinstance(zero, bool):
        return 1 if zero else 0
    if not isinstance(zero, dict):
        raise DeepSpeedConfigError(
            f"ZeRO optimization must be a dict or bool, got {zero!r}")
    stage = int(get_scalar_param(zero, c.ZERO_OPTIMIZATION_STAGE, 0))
    if not 0 <= stage <= 3:
        raise DeepSpeedConfigError(f"invalid ZeRO stage {stage}")
    return stage


def _refuse_unported(pd, zero_stage):
    """Raise on a section the single-process slice cannot honour."""
    def refuse(what, item):
        raise DeepSpeedConfigError(
            f"{what} is not ported to deepspeed_tpu_torch yet (ROADMAP "
            f"queue 1: {item})")

    if zero_stage >= 1:
        refuse(f"ZeRO stage {zero_stage}", "data parallel and ZeRO-1/2, "
               "then ZeRO-3, Offload and Infinity")
    zero = pd.get(c.ZERO_OPTIMIZATION)
    if isinstance(zero, dict) and any(
            zero.get(k) for k in (c.ZERO_OPTIMIZATION_CPU_OFFLOAD,
                                  c.ZERO_OPTIMIZATION_CPU_OFFLOAD_PARAMS,
                                  c.ZERO_OPTIMIZATION_OFFLOAD_PARAM,
                                  c.ZERO_OPTIMIZATION_OFFLOAD_OPTIMIZER)):
        refuse("ZeRO offload", "ZeRO-3, Offload and Infinity")
    if pd.get(c.PIPELINE):
        refuse("the pipeline section", "pipeline")
    mesh = pd.get(c.MESH) or {}
    if any(int(mesh.get(ax, 1)) not in (1, -1)
           for ax in ("data", "model", "pipe", "seq")):
        refuse(f"mesh {mesh}", "data parallel and ZeRO-1/2; tensor and "
               "sequence parallelism")
    if get_scalar_param(pd, c.WALL_CLOCK_BREAKDOWN, False):
        refuse("wall_clock_breakdown", "the production runtime")
    preempt = get_scalar_param(pd.get(c.CHECKPOINT) or {},
                               c.CHECKPOINT_PREEMPT_SAVE_DIR,
                               c.CHECKPOINT_PREEMPT_SAVE_DIR_DEFAULT)
    if preempt is not None:
        refuse(f"checkpoint.{c.CHECKPOINT_PREEMPT_SAVE_DIR} (the "
               "preemption handler)", "the production runtime")
    for key, what, item in (
            (c.PROGRESSIVE_LAYER_DROP, "progressive layer drop",
             "the production runtime"),
            (c.AMP, "AMP", "the production runtime"),
            (c.TENSORBOARD, "TensorBoard", "the production runtime")):
        if get_scalar_param(pd.get(key) or {}, "enabled", False):
            refuse(what, item)


def _parse_comm_moe(comm):
    """The validated `comm.moe` selection (config.py:247-259); the other
    `comm` keys belong to multi-device wires and are not read here."""
    from ..moe.dispatch import parse_moe_config
    from .comm.quant import validate_block_size

    if not isinstance(comm, dict):
        raise ValueError(f"comm must be an object, got {type(comm).__name__}")
    try:
        block = validate_block_size(get_scalar_param(
            comm, c.COMM_QUANT_BLOCK_SIZE, c.COMM_QUANT_BLOCK_SIZE_DEFAULT))
    except ValueError as e:
        raise ValueError(f"comm.{c.COMM_QUANT_BLOCK_SIZE}: {e}")
    # ValueError on an unknown key or a bad value, as the JAX package
    # raises; NotImplementedError for a valid selection not ported yet
    return parse_moe_config(comm.get(c.COMM_MOE), default_block=block)


class DeepSpeedDataPipelineConfig(DeepSpeedConfigObject):
    """The async input pipeline (config.py:263-315):

    "data_pipeline": {
      "enabled": true,          # master switch (default ON)
      "prefetch_depth": 2,      # bounded host queue, in batches
      "num_workers": 1,         # parallel collate threads
      "device_prefetch": true   # copy batch N+1 to the card during step N
    }

    Batch order and content are the same with the pipeline on or off.
    `prefetch_depth: 0` turns the host prefetch off and keeps the device
    double buffer, and vice versa."""

    def __init__(self, param_dict):
        super().__init__()
        d = param_dict.get(c.DATA_PIPELINE) or {}
        known = {c.DATA_PIPELINE_ENABLED, c.DATA_PIPELINE_PREFETCH_DEPTH,
                 c.DATA_PIPELINE_NUM_WORKERS, c.DATA_PIPELINE_DEVICE_PREFETCH}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"data_pipeline: unknown key(s) {sorted(unknown)}; "
                f"expected a subset of {sorted(known)}")
        self.enabled = bool(get_scalar_param(
            d, c.DATA_PIPELINE_ENABLED, c.DATA_PIPELINE_ENABLED_DEFAULT))
        depth = get_scalar_param(d, c.DATA_PIPELINE_PREFETCH_DEPTH,
                                 c.DATA_PIPELINE_PREFETCH_DEPTH_DEFAULT)
        workers = get_scalar_param(d, c.DATA_PIPELINE_NUM_WORKERS,
                                   c.DATA_PIPELINE_NUM_WORKERS_DEFAULT)
        for name, val, lo in ((c.DATA_PIPELINE_PREFETCH_DEPTH, depth, 0),
                              (c.DATA_PIPELINE_NUM_WORKERS, workers, 1)):
            if isinstance(val, bool) or not isinstance(val, int) or val < lo:
                raise ValueError(
                    f"data_pipeline.{name} must be an int >= {lo}, "
                    f"got {val!r}")
        self.prefetch_depth = int(depth)
        self.num_workers = int(workers)
        self.device_prefetch = bool(get_scalar_param(
            d, c.DATA_PIPELINE_DEVICE_PREFETCH,
            c.DATA_PIPELINE_DEVICE_PREFETCH_DEFAULT))

    @property
    def host_prefetch(self) -> bool:
        """True when the background-thread host loop should engage."""
        return self.enabled and self.prefetch_depth > 0

    @property
    def device_feed(self) -> bool:
        """True when the engine double-buffers batches on the device."""
        return self.enabled and self.device_prefetch


class DeepSpeedConfig(DeepSpeedConfigObject):
    def __init__(self, json_file_or_dict, world_size: int = 1):
        super().__init__()
        if isinstance(json_file_or_dict, dict):
            self._param_dict = json_file_or_dict
        elif isinstance(json_file_or_dict, str):
            try:
                with open(json_file_or_dict) as f:
                    self._param_dict = json.load(
                        f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
            except FileNotFoundError:
                raise DeepSpeedConfigError(
                    f"DeepSpeed config file not found: {json_file_or_dict}")
        else:
            raise DeepSpeedConfigError(
                "config must be a dict or a path to a json file, got "
                f"{type(json_file_or_dict)}")
        self.world_size = int(world_size)
        pd = self._param_dict

        self.train_batch_size = get_scalar_param(pd, c.TRAIN_BATCH_SIZE,
                                                 c.TRAIN_BATCH_SIZE_DEFAULT)
        self.train_micro_batch_size_per_gpu = get_scalar_param(
            pd, c.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
            c.TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        self.gradient_accumulation_steps = get_scalar_param(
            pd, c.GRADIENT_ACCUMULATION_STEPS,
            c.GRADIENT_ACCUMULATION_STEPS_DEFAULT)
        self.steps_per_print = get_scalar_param(pd, c.STEPS_PER_PRINT,
                                                c.STEPS_PER_PRINT_DEFAULT)
        self.wall_clock_breakdown = get_scalar_param(
            pd, c.WALL_CLOCK_BREAKDOWN, c.WALL_CLOCK_BREAKDOWN_DEFAULT)

        self.gradient_clipping = get_scalar_param(pd, c.GRADIENT_CLIPPING,
                                                  c.GRADIENT_CLIPPING_DEFAULT)
        self.sparse_gradients_enabled = get_scalar_param(
            pd, c.SPARSE_GRADIENTS, c.SPARSE_GRADIENTS_DEFAULT)
        self.prescale_gradients = get_scalar_param(pd, c.PRESCALE_GRADIENTS,
                                                   c.PRESCALE_GRADIENTS_DEFAULT)
        self.gradient_predivide_factor = get_scalar_param(
            pd, c.GRADIENT_PREDIVIDE_FACTOR, c.GRADIENT_PREDIVIDE_FACTOR_DEFAULT)

        self.zero_optimization_stage = _zero_stage(pd)
        self.zero_enabled = self.zero_optimization_stage > 0
        _refuse_unported(pd, self.zero_optimization_stage)

        self.fp16_enabled = get_fp16_enabled(pd)
        self.precision = get_precision(pd)
        fp16 = pd.get(c.FP16, {})
        self.loss_scale = get_scalar_param(fp16, c.FP16_LOSS_SCALE,
                                           c.FP16_LOSS_SCALE_DEFAULT)
        self.initial_scale_power = get_scalar_param(
            fp16, c.FP16_INITIAL_SCALE_POWER,
            c.FP16_INITIAL_SCALE_POWER_DEFAULT)
        self.loss_scale_window = get_scalar_param(
            fp16, c.FP16_LOSS_SCALE_WINDOW, c.FP16_LOSS_SCALE_WINDOW_DEFAULT)
        self.hysteresis = get_scalar_param(fp16, c.FP16_HYSTERESIS,
                                           c.FP16_HYSTERESIS_DEFAULT)
        self.min_loss_scale = get_scalar_param(fp16, c.FP16_MIN_LOSS_SCALE,
                                               c.FP16_MIN_LOSS_SCALE_DEFAULT)

        opt = pd.get(c.OPTIMIZER)
        self.optimizer_name = (opt.get(c.TYPE).lower()
                               if opt and opt.get(c.TYPE) else None)
        self.optimizer_params = opt.get(c.OPTIMIZER_PARAMS, {}) if opt else None
        self.optimizer_legacy_fusion = (get_scalar_param(
            opt, c.LEGACY_FUSION, c.LEGACY_FUSION_DEFAULT)
            if opt else c.LEGACY_FUSION_DEFAULT)
        self.zero_allow_untested_optimizer = get_scalar_param(
            pd, c.ZERO_ALLOW_UNTESTED_OPTIMIZER,
            c.ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT)

        sched = pd.get(c.SCHEDULER)
        self.scheduler_name = sched.get(c.TYPE) if sched else None
        self.scheduler_params = (sched.get(c.SCHEDULER_PARAMS, {})
                                 if sched else None)

        self.moe = _parse_comm_moe(pd.get(c.COMM) or {})
        self.sparse_attention = pd.get(c.SPARSE_ATTENTION, None)
        self.data_pipeline_config = DeepSpeedDataPipelineConfig(pd)

        ckpt = pd.get(c.CHECKPOINT) or {}
        self.checkpoint_tag_validation_mode = str(get_scalar_param(
            ckpt, c.CHECKPOINT_TAG_VALIDATION,
            c.CHECKPOINT_TAG_VALIDATION_DEFAULT)).lower()
        self.checkpoint_tag_validation_enabled = \
            self.checkpoint_tag_validation_mode != "ignore"
        self.checkpoint_tag_validation_fail = \
            self.checkpoint_tag_validation_mode == "fail"
        self.checkpoint_async_save = bool(get_scalar_param(
            ckpt, c.CHECKPOINT_ASYNC_SAVE, c.CHECKPOINT_ASYNC_SAVE_DEFAULT))
        self.checkpoint_commit_timeout_ms = int(get_scalar_param(
            ckpt, c.CHECKPOINT_COMMIT_TIMEOUT_MS,
            c.CHECKPOINT_COMMIT_TIMEOUT_MS_DEFAULT))
        if self.checkpoint_commit_timeout_ms <= 0:
            raise ValueError(
                f"checkpoint.{c.CHECKPOINT_COMMIT_TIMEOUT_MS} must be a "
                f"positive millisecond count, got "
                f"{self.checkpoint_commit_timeout_ms}")

        self._set_batch_related_parameters()
        self._batch_assertion()

    # -- batch triple (config.py:1092-1134) -------------------------------

    def _set_batch_related_parameters(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        dp = self.world_size

        if all(x is not None for x in (train_batch, micro_batch, grad_acc)):
            pass
        elif train_batch is not None and micro_batch is not None:
            grad_acc = train_batch // micro_batch
            grad_acc //= dp
            self.gradient_accumulation_steps = grad_acc
        elif train_batch is not None and grad_acc is not None:
            micro_batch = train_batch // dp
            micro_batch //= grad_acc
            self.train_micro_batch_size_per_gpu = micro_batch
        elif micro_batch is not None and grad_acc is not None:
            self.train_batch_size = micro_batch * grad_acc * dp
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = train_batch // dp
        elif micro_batch is not None:
            self.train_batch_size = micro_batch * dp
            self.gradient_accumulation_steps = 1
        else:
            raise DeepSpeedConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu "
                "needs to be provided")

    def _batch_assertion(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        dp = self.world_size
        if not (train_batch > 0 and micro_batch > 0 and grad_acc > 0):
            raise DeepSpeedConfigError(
                f"batch sizes must be positive: train_batch_size={train_batch}, "
                f"micro_batch={micro_batch}, grad_acc={grad_acc}")
        if train_batch != micro_batch * grad_acc * dp:
            raise DeepSpeedConfigError(
                f"Check batch related parameters: train_batch_size={train_batch} "
                f"is not equal to micro_batch_per_gpu({micro_batch}) * "
                f"gradient_acc_steps({grad_acc}) * world_size({dp})")

"""DeepSpeedConfig — the subset of deepspeed_tpu/runtime/config.py that the
port honours, with JAX's defaults and errors.

Read: the batch-size triangle (train_batch_size = micro batch ×
gradient_accumulation_steps × data-parallel world size; the solver of
config.py:1088-1134), `fp16` (loss_scale, initial_scale_power,
loss_scale_window, hysteresis, min_loss_scale, and the fork's
"type": "bfloat16" spelling) and `bf16`, `optimizer`, `scheduler`,
`gradient_clipping`, `prescale_gradients`, `gradient_predivide_factor`,
`steps_per_print`, `wall_clock_breakdown`, `sparse_gradients`, the
`sparse_attention` section (stored as given, config.py:1079),
`zero_optimization` (`DeepSpeedZeroConfig`, runtime/zero/config.py),
the `comm` section (`DeepSpeedCommConfig`, config.py:116-250: the
gradient wire, its hierarchy and the MoE block `comm.moe`,
`moe/dispatch.py` `parse_moe_config`), `data_pipeline`
(`DeepSpeedDataPipelineConfig`, config.py:263-315) and `checkpoint`
(`tag_validation`, `async_save`, `commit_timeout_ms`;
config.py:1047-1075) and `serving` (`DeepSpeedServingConfig`,
config.py:625-780: `to_serve_kwargs()` for `ServeConfig`,
`to_fleet_kwargs()` for `build_fleet` / `FleetRouter`): an unknown key or
a bad value raises ValueError here, at config time, as in the JAX
package.

A section the port cannot honour yet raises `DeepSpeedConfigError` (or,
for a valid `comm` selection, NotImplementedError) naming its ROADMAP
item, rather than training without it: ZeRO-Offload or Infinity at
more than one rank, `offload_optimizer` at stage 3 without
`offload_param`, a pipeline section, a mesh with a model, pipe or seq
axis above 1, `comm.overlap` (outside ZeRO-Infinity, where the engine
warns, as JAX's does), progressive layer drop,
AMP, TensorBoard, the wall-clock breakdown,
`checkpoint.preempt_save_dir` (the preemption handler), a `faults` block
that injects (`rules`) or arms the step watchdog, and
`monitor.tracing.enabled` (the training engine installs none of them
yet; serving takes a plan, watchdog and tracer directly).  (1-bit and
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
    """Raise on a section the port cannot honour yet."""
    def refuse(what, item):
        raise DeepSpeedConfigError(
            f"{what} is not ported to deepspeed_tpu_torch yet (ROADMAP "
            f"queue 1: {item})")

    if pd.get(c.PIPELINE):
        refuse("the pipeline section", "pipeline")
    mesh = pd.get(c.MESH) or {}
    for ax, item in (("model", "tensor and sequence parallelism"),
                     ("seq", "tensor and sequence parallelism"),
                     ("pipe", "pipeline")):
        if int(mesh.get(ax, 1)) not in (1, -1):
            refuse(f"mesh {mesh} (axis {ax!r})", item)
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
    # the training engine installs no fault plan, watchdog or tracer yet:
    # refuse the blocks that would switch one on (rules inject unless the
    # block says enabled: false, as in the JAX package)
    faults = pd.get(c.FAULTS) or {}
    if faults.get(c.FAULTS_RULES) and \
            get_scalar_param(faults, c.FAULTS_ENABLED, True):
        refuse("faults.rules (fault injection)", "the production runtime")
    if get_scalar_param(faults.get(c.FAULTS_WATCHDOG) or {}, "enabled",
                        False):
        refuse("faults.watchdog (the step watchdog)",
               "the production runtime")
    tracing = (pd.get(c.MONITOR) or {}).get(c.MONITOR_TRACING) or {}
    if get_scalar_param(tracing, "enabled", False):
        refuse("monitor.tracing", "the production runtime")


def infinity_requested(zero_config) -> bool:
    """ZeRO-Infinity: stage 3 with `offload_param` (engine.py:325-330;
    the model must also carry the streaming protocol)."""
    return zero_config.stage >= 3 and zero_config.offload_param is not None


def offload_requested(zero_config) -> bool:
    """ZeRO-Offload: `offload_optimizer` or the legacy `cpu_offload`
    (engine.py:705)."""
    return bool(zero_config.cpu_offload or
                zero_config.offload_optimizer is not None)


def _refuse_unported_offload(zero_config, world_size: int):
    """The offload configurations the port cannot honour yet."""
    def refuse(what, item):
        raise DeepSpeedConfigError(
            f"{what} is not ported to deepspeed_tpu_torch yet (ROADMAP "
            f"queue 1: {item})")

    infinity = infinity_requested(zero_config)
    offload = offload_requested(zero_config)
    if (infinity or offload) and world_size > 1:
        refuse(f"ZeRO-{'Infinity' if infinity else 'Offload'} at "
               f"{world_size} ranks", "Offload and Infinity across ranks")
    if offload and zero_config.stage >= 3 and not infinity:
        refuse("offload_optimizer at ZeRO stage 3 without offload_param",
               "offload_optimizer with stage-3 slices")
    if zero_config.offload_param is not None and zero_config.stage < 3:
        from ..utils.logging import logger

        # the JAX engine engages offload_param at stage 3 only, and
        # ignores it below (engine.py:325-330)
        logger.warning(f"zero_optimization.offload_param at ZeRO stage "
                       f"{zero_config.stage} has no effect: parameters "
                       f"stream from the host only at stage 3")


def parse_comm_hierarchy(value):
    """The `comm.hierarchy` knob -> "none" | "auto" | int outer factor
    (config.py:47)."""
    if value is None:
        value = c.COMM_HIERARCHY_DEFAULT
    if isinstance(value, dict):
        unknown = set(value) - {"outer"}
        if unknown:
            raise ValueError(
                f"comm.hierarchy: unknown key(s) {sorted(unknown)}; "
                "expected {'outer': <int>}")
        value = value.get("outer", 1)
    if isinstance(value, str):
        mode = value.lower()
        if mode in ("none", "flat", "off"):
            return "none"
        if mode == "auto":
            return "auto"
        raise ValueError(
            "comm.hierarchy must be 'none', 'auto', an int outer factor, "
            f"or {{'outer': <int>}}, got {value!r}")
    if isinstance(value, bool) or not isinstance(value, int):
        raise ValueError(
            "comm.hierarchy must be 'none', 'auto', an int outer factor, "
            f"or {{'outer': <int>}}, got {value!r}")
    if value < 1:
        raise ValueError(
            f"comm.hierarchy outer factor must be >= 1, got {value}")
    return "none" if value == 1 else value


def check_hierarchy_divides(outer: int, dp_size: int) -> None:
    """An explicit outer factor must factor the dp size (config.py:82)."""
    if dp_size % outer != 0:
        raise ValueError(
            f"comm.hierarchy: data_outer={outer} does not divide the "
            f"data-parallel axis size {dp_size} (data_inner would be "
            f"{dp_size / outer:g}); pick an outer factor from the "
            f"divisors of {dp_size}")


def parse_comm_overlap(value):
    """The `comm.overlap` knob -> "none" | "auto" | "on" (config.py:93)."""
    if value is None:
        value = c.COMM_OVERLAP_DEFAULT
    if isinstance(value, bool):
        return "on" if value else "none"
    if isinstance(value, str):
        mode = value.lower()
        if mode in ("none", "off", "false"):
            return "none"
        if mode == "auto":
            return "auto"
        if mode in ("on", "true"):
            return "on"
    raise ValueError(
        f"comm.{c.COMM_OVERLAP} must be one of {c.COMM_OVERLAP_MODES} "
        f"(or a bool), got {value!r}")


class DeepSpeedCommConfig(DeepSpeedConfigObject):
    """The gradient-reduction wire (config.py:116-250):

    "comm": {
      "gradient_reduction": "implicit" | "bucketed",
      "wire_dtype": "fp32" | "bf16" | "split" | "int8" | "int4",
      "reduce_bucket_size": <elements>,  # default: zero_optimization's
      "hierarchy": "none" | "auto" | <outer> | {"outer": <outer>},
      "wire_dtype_inner": ..., "wire_dtype_outer": ...,
      "quant_block_size": <elements per fp16 scale>,
      "overlap": "none" | "auto" | "on" | bool, ...
    }

    `implicit` (the default) reduces each gradient leaf with its own
    collective; `bucketed` goes through the BucketPlan's fused buckets.
    `fp32_allreduce` (top level) forces every wire to fp32, the int8 and
    int4 wires included.  The inner level of a hierarchy is
    scatter-structured: an inherited "split", "int8" or "int4" lowers to
    fp32 there, an explicit int8/int4 inner wire raises.  The port does
    not run the overlap: a valid request for it raises
    NotImplementedError naming the ROADMAP item, after the checks JAX
    makes."""

    def __init__(self, param_dict, zero_config, world_size=None):
        from ..utils.logging import logger
        from .comm.bucketing import GATHER_WIRES, WIRE_MODES
        from .comm.quant import QUANT_WIRES, validate_block_size

        super().__init__()
        d = param_dict.get(c.COMM) or {}
        if not isinstance(d, dict):
            raise ValueError(
                f"comm must be an object, got {type(d).__name__}")
        self.gradient_reduction = str(get_scalar_param(
            d, c.COMM_GRADIENT_REDUCTION,
            c.COMM_GRADIENT_REDUCTION_DEFAULT)).lower()
        if self.gradient_reduction not in c.COMM_GRADIENT_REDUCTION_MODES:
            raise ValueError(
                f"comm.gradient_reduction must be one of "
                f"{c.COMM_GRADIENT_REDUCTION_MODES}, "
                f"got {self.gradient_reduction!r}")
        self.fp32_allreduce = bool(get_scalar_param(
            param_dict, c.FP32_ALLREDUCE, c.FP32_ALLREDUCE_DEFAULT))

        def wire_param(key, default):
            w = get_scalar_param(d, key, default)
            if w is None:
                return None
            w = str(w).lower()
            if w not in WIRE_MODES:
                raise ValueError(f"comm.{key} must be one of {WIRE_MODES}, "
                                 f"got {w!r}")
            return "fp32" if self.fp32_allreduce else w

        self.wire_dtype = wire_param(c.COMM_WIRE_DTYPE,
                                     c.COMM_WIRE_DTYPE_DEFAULT)
        self.hierarchy = parse_comm_hierarchy(
            get_scalar_param(d, c.COMM_HIERARCHY, c.COMM_HIERARCHY_DEFAULT))
        if isinstance(self.hierarchy, int) and world_size is not None:
            check_hierarchy_divides(self.hierarchy, int(world_size))
        inner_override = wire_param(c.COMM_WIRE_DTYPE_INNER, None)
        self.wire_dtype_inner = inner_override or self.wire_dtype
        self.wire_dtype_outer = wire_param(c.COMM_WIRE_DTYPE_OUTER, None) \
            or self.wire_dtype
        if inner_override in QUANT_WIRES:
            raise ValueError(
                f"comm.{c.COMM_WIRE_DTYPE_INNER} = {inner_override!r}: "
                "the int8/int4 wires are gather-structured (per-block "
                "scales cannot ride a reduce-scatter) and cannot run the "
                "intra-group scatter level; use fp32 or bf16 for "
                f"{c.COMM_WIRE_DTYPE_INNER} and put the quantized wire "
                f"on {c.COMM_WIRE_DTYPE_OUTER}")
        if self.wire_dtype_inner in GATHER_WIRES:
            if inner_override is not None:
                logger.warning(
                    "comm: the split wire is gather-structured and cannot "
                    "run the intra-group scatter level; wire_dtype_inner "
                    "lowers to fp32")
            self.wire_dtype_inner = "fp32"
        self.overlap = parse_comm_overlap(
            get_scalar_param(d, c.COMM_OVERLAP, c.COMM_OVERLAP_DEFAULT))

        def overlap_int(key, default, minimum=1):
            v = get_scalar_param(d, key, default)
            try:
                iv = int(v)
            except (TypeError, ValueError):
                raise ValueError(
                    f"comm.{key} must be an integer >= {minimum}, "
                    f"got {v!r}")
            if iv < minimum:
                raise ValueError(
                    f"comm.{key} must be >= {minimum}, got {iv}")
            return iv

        self.overlap_timeout_ms = overlap_int(
            c.COMM_OVERLAP_TIMEOUT_MS, c.COMM_OVERLAP_TIMEOUT_MS_DEFAULT)
        self.overlap_reconnect_attempts = overlap_int(
            c.COMM_OVERLAP_RECONNECT_ATTEMPTS,
            c.COMM_OVERLAP_RECONNECT_ATTEMPTS_DEFAULT, minimum=0)
        self.overlap_reconnect_window_ms = overlap_int(
            c.COMM_OVERLAP_RECONNECT_WINDOW_MS,
            c.COMM_OVERLAP_RECONNECT_WINDOW_MS_DEFAULT)
        self.overlap_keepalive_ms = overlap_int(
            c.COMM_OVERLAP_KEEPALIVE_MS, c.COMM_OVERLAP_KEEPALIVE_MS_DEFAULT)
        self.reduce_bucket_size = int(get_scalar_param(
            d, c.COMM_REDUCE_BUCKET_SIZE, zero_config.reduce_bucket_size))
        block = get_scalar_param(d, c.COMM_QUANT_BLOCK_SIZE,
                                 c.COMM_QUANT_BLOCK_SIZE_DEFAULT)
        try:
            self.quant_block_size = validate_block_size(block)
        except ValueError as e:
            raise ValueError(f"comm.{c.COMM_QUANT_BLOCK_SIZE}: {e}")
        from ..moe.dispatch import parse_moe_config

        # ValueError on an unknown key or a bad value, as the JAX package
        # raises; NotImplementedError for a valid selection not ported yet
        self.moe = parse_moe_config(d.get(c.COMM_MOE),
                                    default_block=self.quant_block_size)
        # under ZeRO-Infinity the engine warns instead (engine.py:363)
        if self.overlap != "none" and not infinity_requested(zero_config):
            raise NotImplementedError(
                f"comm.overlap={self.overlap!r}: the overlapped gradient "
                f"wire is not ported to deepspeed_tpu_torch yet (ROADMAP "
                f"queue 1: the overlapped host-exchange wire)")


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


# accepted serving.kv_dtype spellings; must stay a superset of what
# serving.kv_cache.resolve_kv_dtype() resolves (kept local so the
# training-side config never imports the serving package)
SERVING_KV_DTYPES = ("bf16", "bfloat16", "fp16", "float16", "fp32",
                     "float32", "int8", "int4")


class DeepSpeedServingConfig(DeepSpeedConfigObject):
    """Inference-side knobs (deepspeed_tpu_torch.serving), the JAX
    package's block with its keys, defaults and errors.

    "serving": {"kv_dtype": null,
                "speculative": {"enabled": false, "draft_len": 4,
                                "ngram": 3},
                "prefix_cache": {"enabled": true, "min_match_blocks": 1,
                                 "session_ttl_s": 120.0},
                "fleet": {"replicas": 1, "queue_limit": 64,
                          "session_affinity": true}}

    `kv_dtype` selects the paged KV cache's storage mode: null stores
    at the param dtype; "bf16"/"fp16"/"fp32" store dense at that dtype;
    "int8"/"int4" store per-(row, head) quantized payload + fp16 scale
    pairs (runtime/comm/quant.py row kernels).  `speculative.enabled`
    arms self-speculative n-gram decoding: `draft_len` candidate tokens
    drafted host-side per verify step by an `ngram`-suffix match over
    the request's own context (no extra model).  `prefix_cache` governs
    block-level KV sharing (serving/kv_cache.py chain hashes) and the
    pinned-session residency window; `fleet` sizes the multi-replica
    router (serving/router.py).  Every knob is validated HERE so a typo
    fails at config time, not mid-serve."""

    def __init__(self, param_dict):
        super().__init__()
        d = param_dict.get(c.SERVING) or {}
        known = {c.SERVING_KV_DTYPE, c.SERVING_SPECULATIVE,
                 c.SERVING_PREFIX_CACHE, c.SERVING_FLEET}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"serving: unknown key(s) {sorted(unknown)}; expected a "
                f"subset of {sorted(known)}")
        kv = get_scalar_param(d, c.SERVING_KV_DTYPE,
                              c.SERVING_KV_DTYPE_DEFAULT)
        if kv is not None:
            if not isinstance(kv, str) or \
                    kv.lower() not in SERVING_KV_DTYPES:
                raise ValueError(
                    f"serving.{c.SERVING_KV_DTYPE} must be null or one of "
                    f"{SERVING_KV_DTYPES}, got {kv!r}")
            kv = kv.lower()
        self.kv_dtype = kv

        s = d.get(c.SERVING_SPECULATIVE) or {}
        known_s = {c.SERVING_SPEC_ENABLED, c.SERVING_SPEC_DRAFT_LEN,
                   c.SERVING_SPEC_NGRAM}
        unknown = set(s) - known_s
        if unknown:
            raise ValueError(
                f"serving.{c.SERVING_SPECULATIVE}: unknown key(s) "
                f"{sorted(unknown)}; expected a subset of {sorted(known_s)}")
        self.spec_enabled = bool(get_scalar_param(
            s, c.SERVING_SPEC_ENABLED, c.SERVING_SPEC_ENABLED_DEFAULT))

        def spec_int(key, default, minimum=1):
            v = get_scalar_param(s, key, default)
            if isinstance(v, bool) or not isinstance(v, int) or v < minimum:
                raise ValueError(
                    f"serving.speculative.{key} must be an int >= "
                    f"{minimum}, got {v!r}")
            return int(v)

        self.spec_draft_len = spec_int(c.SERVING_SPEC_DRAFT_LEN,
                                       c.SERVING_SPEC_DRAFT_LEN_DEFAULT)
        self.spec_ngram = spec_int(c.SERVING_SPEC_NGRAM,
                                   c.SERVING_SPEC_NGRAM_DEFAULT)

        p = d.get(c.SERVING_PREFIX_CACHE) or {}
        known_p = {c.SERVING_PREFIX_ENABLED,
                   c.SERVING_PREFIX_MIN_MATCH_BLOCKS,
                   c.SERVING_PREFIX_SESSION_TTL_S}
        unknown = set(p) - known_p
        if unknown:
            raise ValueError(
                f"serving.{c.SERVING_PREFIX_CACHE}: unknown key(s) "
                f"{sorted(unknown)}; expected a subset of {sorted(known_p)}")
        self.prefix_enabled = bool(get_scalar_param(
            p, c.SERVING_PREFIX_ENABLED, c.SERVING_PREFIX_ENABLED_DEFAULT))
        mm = get_scalar_param(p, c.SERVING_PREFIX_MIN_MATCH_BLOCKS,
                              c.SERVING_PREFIX_MIN_MATCH_BLOCKS_DEFAULT)
        if isinstance(mm, bool) or not isinstance(mm, int) or mm < 1:
            raise ValueError(
                f"serving.prefix_cache.{c.SERVING_PREFIX_MIN_MATCH_BLOCKS} "
                f"must be an int >= 1, got {mm!r}")
        self.prefix_min_match_blocks = int(mm)
        ttl = get_scalar_param(p, c.SERVING_PREFIX_SESSION_TTL_S,
                               c.SERVING_PREFIX_SESSION_TTL_S_DEFAULT)
        try:
            ttl = float(ttl)
        except (TypeError, ValueError):
            ttl = -1.0
        if ttl <= 0:
            raise ValueError(
                f"serving.prefix_cache.{c.SERVING_PREFIX_SESSION_TTL_S} "
                f"must be a second count > 0, got "
                f"{p.get(c.SERVING_PREFIX_SESSION_TTL_S)!r}")
        self.session_ttl_s = ttl

        f = d.get(c.SERVING_FLEET) or {}
        known_f = {c.SERVING_FLEET_REPLICAS, c.SERVING_FLEET_QUEUE_LIMIT,
                   c.SERVING_FLEET_SESSION_AFFINITY}
        unknown = set(f) - known_f
        if unknown:
            raise ValueError(
                f"serving.{c.SERVING_FLEET}: unknown key(s) "
                f"{sorted(unknown)}; expected a subset of {sorted(known_f)}")

        def fleet_int(key, default):
            v = get_scalar_param(f, key, default)
            if isinstance(v, bool) or not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"serving.fleet.{key} must be an int >= 1, got {v!r}")
            return int(v)

        self.fleet_replicas = fleet_int(c.SERVING_FLEET_REPLICAS,
                                        c.SERVING_FLEET_REPLICAS_DEFAULT)
        self.fleet_queue_limit = fleet_int(
            c.SERVING_FLEET_QUEUE_LIMIT, c.SERVING_FLEET_QUEUE_LIMIT_DEFAULT)
        self.fleet_session_affinity = bool(get_scalar_param(
            f, c.SERVING_FLEET_SESSION_AFFINITY,
            c.SERVING_FLEET_SESSION_AFFINITY_DEFAULT))

    def to_serve_kwargs(self):
        """The ServeConfig fragment this block selects: feed as
        `ServeConfig(**cfg.serving_config.to_serve_kwargs(), ...)`.
        Disabled speculation maps to draft_len=0 (the engine's plain
        decode path), not a missing key."""
        return {
            "kv_dtype": self.kv_dtype,
            "draft_len": self.spec_draft_len if self.spec_enabled else 0,
            "spec_ngram": self.spec_ngram,
            "prefix_cache": self.prefix_enabled,
            "prefix_min_match_blocks": self.prefix_min_match_blocks,
            "session_ttl_s": self.session_ttl_s,
        }

    def to_fleet_kwargs(self):
        """The FleetRouter sizing this block selects: feed as
        `FleetRouter(build_fleet(..., replicas=k['replicas']),
        queue_limit=k['queue_limit'], ...)`."""
        return {
            "replicas": self.fleet_replicas,
            "queue_limit": self.fleet_queue_limit,
            "session_affinity": self.fleet_session_affinity,
        }


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
        from .zero.config import DeepSpeedZeroConfig

        self.zero_config = DeepSpeedZeroConfig(pd)
        _refuse_unported_offload(self.zero_config, self.world_size)
        mesh_data = int((pd.get(c.MESH) or {}).get("data", -1))
        if mesh_data not in (-1, self.world_size):
            raise DeepSpeedConfigError(
                f"mesh.data={mesh_data} but the data-parallel world has "
                f"{self.world_size} rank(s) (-1 takes them all)")

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

        self.comm_config = DeepSpeedCommConfig(pd, self.zero_config,
                                               world_size=self.world_size)
        self.moe = self.comm_config.moe
        self.sparse_attention = pd.get(c.SPARSE_ATTENTION, None)
        self.data_pipeline_config = DeepSpeedDataPipelineConfig(pd)
        # inference-side knobs: the serving engine's and the fleet's
        self.serving_config = DeepSpeedServingConfig(pd)

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

"""ZeRO config object — the port's copy of
deepspeed_tpu/runtime/zero/config.py (the reference's
zero/config.py:177): the same keys, defaults and errors.

Stages resolve to per-leaf partitions over the data ranks
(zero/partition.py): stage 1 partitions the optimizer state, stage 2
also reduce-scatters the gradients to their owners, stage 3 also stores
only a rank's slice of each parameter and gathers it on use
(zero/stage3.py), through the int8/int4 wire with `quantized_weights`
(qwZ).  The runtime config (runtime/config.py) refuses offload, which
is not ported.
"""

from ..config_utils import DeepSpeedConfigObject, get_scalar_param
from . import constants as zc


class DeepSpeedZeroOffloadParamConfig(DeepSpeedConfigObject):
    """reference zero/offload_config.py offload_param schema."""

    def __init__(self, param_dict=None):
        super().__init__()
        d = param_dict or {}
        self.device = get_scalar_param(d, zc.OFFLOAD_DEVICE, zc.OFFLOAD_CPU_DEVICE)
        self.nvme_path = get_scalar_param(d, zc.OFFLOAD_NVME_PATH, "/local_nvme")
        self.buffer_count = get_scalar_param(d, zc.OFFLOAD_BUFFER_COUNT, 5)
        self.buffer_size = get_scalar_param(d, zc.OFFLOAD_BUFFER_SIZE, int(1e8))
        self.max_in_cpu = get_scalar_param(d, zc.OFFLOAD_MAX_IN_CPU, int(1e9))
        self.pin_memory = get_scalar_param(d, zc.OFFLOAD_PIN_MEMORY, False)


class DeepSpeedZeroOffloadOptimizerConfig(DeepSpeedConfigObject):
    """reference zero/offload_config.py offload_optimizer schema."""

    def __init__(self, param_dict=None):
        super().__init__()
        d = param_dict or {}
        self.device = get_scalar_param(d, zc.OFFLOAD_DEVICE, zc.OFFLOAD_CPU_DEVICE)
        self.nvme_path = get_scalar_param(d, zc.OFFLOAD_NVME_PATH, "/local_nvme")
        self.buffer_count = get_scalar_param(d, zc.OFFLOAD_BUFFER_COUNT, 4)
        self.pin_memory = get_scalar_param(d, zc.OFFLOAD_PIN_MEMORY, False)
        self.pipeline_read = get_scalar_param(d, zc.OFFLOAD_PIPELINE_READ, False)
        self.pipeline_write = get_scalar_param(d, zc.OFFLOAD_PIPELINE_WRITE, False)
        self.fast_init = get_scalar_param(d, zc.OFFLOAD_FAST_INIT, False)
        self.pipeline = self.pipeline_read or self.pipeline_write


class DeepSpeedZeroConfig(DeepSpeedConfigObject):
    def __init__(self, param_dict):
        super().__init__()
        zero_dict = param_dict.get(zc.ZERO_OPTIMIZATION, None)
        if zero_dict is None:
            zero_dict = {}
        elif isinstance(zero_dict, bool):
            # legacy "zero_optimization": true => stage 1
            zero_dict = {zc.ZERO_OPTIMIZATION_STAGE: 1 if zero_dict else 0}
        elif not isinstance(zero_dict, dict):
            raise ValueError(
                f"ZeRO optimization must be a dict or bool, got {zero_dict!r}. "
                f"{zc.ZERO_FORMAT}")

        g = lambda key, default: get_scalar_param(zero_dict, key, default)

        self.stage = g(zc.ZERO_OPTIMIZATION_STAGE, zc.ZERO_OPTIMIZATION_STAGE_DEFAULT)
        if not (0 <= int(self.stage) <= zc.MAX_STAGE_ZERO_OPTIMIZATION):
            raise ValueError(f"invalid ZeRO stage {self.stage}")
        self.stage = int(self.stage)

        self.contiguous_gradients = g(
            zc.ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS,
            zc.ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS_DEFAULT or self.stage == 3)
        self.reduce_scatter = g(zc.ZERO_OPTIMIZATION_REDUCE_SCATTER,
                                zc.ZERO_OPTIMIZATION_REDUCE_SCATTER_DEFAULT)
        self.reduce_bucket_size = int(g(zc.ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE,
                                        zc.ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT))
        self.allgather_partitions = g(zc.ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS,
                                      zc.ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS_DEFAULT)
        self.allgather_bucket_size = int(
            g(zc.ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE,
              g(zc.ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEPRECATED,
                zc.ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT)))
        self.overlap_comm = g(zc.ZERO_OPTIMIZATION_OVERLAP_COMM,
                              self.stage == 3)
        self.load_from_fp32_weights = g(
            zc.ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS,
            zc.ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS_DEFAULT)
        self.elastic_checkpoint = g(zc.ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT,
                                    zc.ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT_DEFAULT)

        # offload: new-style dicts win over legacy cpu_offload booleans
        self.cpu_offload = g(zc.ZERO_OPTIMIZATION_CPU_OFFLOAD,
                             zc.ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT)
        self.cpu_offload_params = g(zc.ZERO_OPTIMIZATION_CPU_OFFLOAD_PARAMS,
                                    zc.ZERO_OPTIMIZATION_CPU_OFFLOAD_PARAMS_DEFAULT)
        self.cpu_offload_use_pin_memory = g(
            zc.ZERO_OPTIMIZATION_CPU_OFFLOAD_USE_PIN_MEMORY,
            zc.ZERO_OPTIMIZATION_CPU_OFFLOAD_USE_PIN_MEMORY_DEFAULT)

        offload_param_dict = zero_dict.get(zc.ZERO_OPTIMIZATION_OFFLOAD_PARAM)
        offload_opt_dict = zero_dict.get(zc.ZERO_OPTIMIZATION_OFFLOAD_OPTIMIZER)
        if self.cpu_offload_params and offload_param_dict is None:
            offload_param_dict = {zc.OFFLOAD_DEVICE: zc.OFFLOAD_CPU_DEVICE,
                                  zc.OFFLOAD_PIN_MEMORY: self.cpu_offload_use_pin_memory}
        if self.cpu_offload and offload_opt_dict is None:
            offload_opt_dict = {zc.OFFLOAD_DEVICE: zc.OFFLOAD_CPU_DEVICE,
                                zc.OFFLOAD_PIN_MEMORY: self.cpu_offload_use_pin_memory}
        self.offload_param = (DeepSpeedZeroOffloadParamConfig(offload_param_dict)
                              if offload_param_dict is not None else None)
        self.offload_optimizer = (
            DeepSpeedZeroOffloadOptimizerConfig(offload_opt_dict)
            if offload_opt_dict is not None else None)
        # normalize legacy flags from new-style dicts
        if self.offload_optimizer is not None and \
                self.offload_optimizer.device == zc.OFFLOAD_CPU_DEVICE:
            self.cpu_offload = True
        if self.offload_param is not None and \
                self.offload_param.device == zc.OFFLOAD_CPU_DEVICE:
            self.cpu_offload_params = True

        # stage-3 knobs
        self.sub_group_size = int(g(zc.ZERO_OPTIMIZATION_SUB_GROUP_SIZE,
                                    zc.ZERO_OPTIMIZATION_SUB_GROUP_SIZE_DEFAULT))
        self.max_live_parameters = int(g(
            zc.ZERO_OPTIMIZATION_MAX_LIVE_PARAMETERS,
            zc.ZERO_OPTIMIZATION_MAX_LIVE_PARAMETERS_DEFAULT))
        self.max_reuse_distance = int(g(
            zc.ZERO_OPTIMIZATION_MAX_REUSE_DISTANCE,
            zc.ZERO_OPTIMIZATION_MAX_REUSE_DISTANCE_DEFAULT))
        self.prefetch_bucket_size = int(g(
            zc.ZERO_OPTIMIZATION_PREFETCH_BUCKET_SIZE,
            zc.ZERO_OPTIMIZATION_PREFETCH_BUCKET_SIZE_DEFAULT))
        self.param_persistence_threshold = int(g(
            zc.ZERO_OPTIMIZATION_PARAM_PERSISTENCE_THRESHOLD,
            zc.ZERO_OPTIMIZATION_PARAM_PERSISTENCE_THRESHOLD_DEFAULT))
        self.gather_fp16_weights_on_model_save = g(
            zc.ZERO_OPTIMIZATION_GATHER_FP16_WEIGHTS_ON_MODEL_SAVE,
            zc.ZERO_OPTIMIZATION_GATHER_FP16_WEIGHTS_ON_MODEL_SAVE_DEFAULT)

        # qwZ: quantize the stage-3 parameter all-gather (ZeRO++).
        # Normalized to None | "int8" | "int4"; the master weights and
        # optimizer math stay full precision either way.
        qw = g(zc.ZERO_OPTIMIZATION_QUANTIZED_WEIGHTS,
               zc.ZERO_OPTIMIZATION_QUANTIZED_WEIGHTS_DEFAULT)
        if isinstance(qw, bool) or qw is None:
            self.quantized_weights = "int8" if qw else None
        else:
            qw = str(qw).lower()
            if qw in ("false", "none", "off"):
                self.quantized_weights = None
            elif qw in ("true", "int8", "int4"):
                self.quantized_weights = "int8" if qw == "true" else qw
            else:
                raise ValueError(
                    f"zero_optimization.{zc.ZERO_OPTIMIZATION_QUANTIZED_WEIGHTS} "
                    f"must be false, true, 'int8' or 'int4', got {qw!r}")

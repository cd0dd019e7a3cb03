"""ZeRO config keys — the port's copy of
deepspeed_tpu/runtime/zero/constants.py (same names, same values).

Stages keep their reference meaning: 0 = disabled, 1 = optimizer states
partitioned over the data ranks, 2 = + gradients reduce-scattered to
their owner, 3 = + parameters (not ported yet).
"""

ZERO_OPTIMIZATION = "zero_optimization"

ZERO_OPTIMIZATION_DISABLED = 0
ZERO_OPTIMIZATION_OPTIMIZER_STATES = 1
ZERO_OPTIMIZATION_GRADIENTS = 2
ZERO_OPTIMIZATION_WEIGHTS = 3
MAX_STAGE_ZERO_OPTIMIZATION = ZERO_OPTIMIZATION_WEIGHTS

ZERO_OPTIMIZATION_STAGE = "stage"
ZERO_OPTIMIZATION_STAGE_DEFAULT = ZERO_OPTIMIZATION_DISABLED

# Bucket/overlap knobs (reference zero/constants.py). overlap_comm /
# contiguous_gradients are accepted for parity; reduce_bucket_size and
# reduce_scatter are honoured: with "comm": {"gradient_reduction":
# "bucketed"} the BucketPlan (runtime/comm/bucketing.py) caps fused
# buckets at reduce_bucket_size elements, and reduce_scatter selects the
# ZeRO>=2 reduce-scatter lowering.
ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS = "allgather_partitions"
ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS_DEFAULT = True
ZERO_OPTIMIZATION_REDUCE_SCATTER = "reduce_scatter"
ZERO_OPTIMIZATION_REDUCE_SCATTER_DEFAULT = True
ZERO_OPTIMIZATION_OVERLAP_COMM = "overlap_comm"
ZERO_OPTIMIZATION_OVERLAP_COMM_DEFAULT = False
ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS = "contiguous_gradients"
ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS_DEFAULT = False
ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE = "reduce_bucket_size"
ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT = 500000000  # elements, not bytes
ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE = "allgather_bucket_size"
ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT = 500000000
ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEPRECATED = "allgather_size"
ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS = "load_from_fp32_weights"
ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS_DEFAULT = True
ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT = "elastic_checkpoint"
ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT_DEFAULT = True

# Offload
ZERO_OPTIMIZATION_CPU_OFFLOAD = "cpu_offload"
ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT = False
ZERO_OPTIMIZATION_CPU_OFFLOAD_PARAMS = "cpu_offload_params"
ZERO_OPTIMIZATION_CPU_OFFLOAD_PARAMS_DEFAULT = False
ZERO_OPTIMIZATION_CPU_OFFLOAD_USE_PIN_MEMORY = "cpu_offload_use_pin_memory"
ZERO_OPTIMIZATION_CPU_OFFLOAD_USE_PIN_MEMORY_DEFAULT = False
ZERO_OPTIMIZATION_OFFLOAD_PARAM = "offload_param"
ZERO_OPTIMIZATION_OFFLOAD_PARAM_DEFAULT = None
ZERO_OPTIMIZATION_OFFLOAD_OPTIMIZER = "offload_optimizer"
ZERO_OPTIMIZATION_OFFLOAD_OPTIMIZER_DEFAULT = None

# Stage-3 knobs
ZERO_OPTIMIZATION_SUB_GROUP_SIZE = "sub_group_size"
ZERO_OPTIMIZATION_SUB_GROUP_SIZE_DEFAULT = 1000000000000
ZERO_OPTIMIZATION_MAX_LIVE_PARAMETERS = "stage3_max_live_parameters"
ZERO_OPTIMIZATION_MAX_LIVE_PARAMETERS_DEFAULT = 1000000000
ZERO_OPTIMIZATION_MAX_REUSE_DISTANCE = "stage3_max_reuse_distance"
ZERO_OPTIMIZATION_MAX_REUSE_DISTANCE_DEFAULT = 1000000000
ZERO_OPTIMIZATION_PREFETCH_BUCKET_SIZE = "stage3_prefetch_bucket_size"
ZERO_OPTIMIZATION_PREFETCH_BUCKET_SIZE_DEFAULT = 50000000
ZERO_OPTIMIZATION_PARAM_PERSISTENCE_THRESHOLD = "stage3_param_persistence_threshold"
ZERO_OPTIMIZATION_PARAM_PERSISTENCE_THRESHOLD_DEFAULT = 100000
ZERO_OPTIMIZATION_GATHER_FP16_WEIGHTS_ON_MODEL_SAVE = \
    "stage3_gather_fp16_weights_on_model_save"
ZERO_OPTIMIZATION_GATHER_FP16_WEIGHTS_ON_MODEL_SAVE_DEFAULT = False
# qwZ (ZeRO++ arXiv:2306.10209): the stage-3 parameter all-gather moves
# blockwise-quantized blocks + fp16 scales instead of full-width
# weights; the master copy stays full precision.  false | true (int8) |
# "int8" | "int4".  Block size rides comm.quant_block_size.
ZERO_OPTIMIZATION_QUANTIZED_WEIGHTS = "quantized_weights"
ZERO_OPTIMIZATION_QUANTIZED_WEIGHTS_DEFAULT = False

ZERO_FORMAT = """
ZeRO optimization should be enabled as:
"zero_optimization": {
  "stage": [0|1|2|3],
  "offload_param": {...},
  "offload_optimizer": {...},
  ...
}
"""

# offload sub-dict keys (reference zero/offload_constants.py)
OFFLOAD_DEVICE = "device"
OFFLOAD_CPU_DEVICE = "cpu"
OFFLOAD_NVME_DEVICE = "nvme"
OFFLOAD_NONE_DEVICE = "none"
OFFLOAD_NVME_PATH = "nvme_path"
OFFLOAD_BUFFER_COUNT = "buffer_count"
OFFLOAD_BUFFER_SIZE = "buffer_size"
OFFLOAD_MAX_IN_CPU = "max_in_cpu"
OFFLOAD_PIN_MEMORY = "pin_memory"
OFFLOAD_PIPELINE = "pipeline"
OFFLOAD_PIPELINE_READ = "pipeline_read"
OFFLOAD_PIPELINE_WRITE = "pipeline_write"
OFFLOAD_FAST_INIT = "fast_init"

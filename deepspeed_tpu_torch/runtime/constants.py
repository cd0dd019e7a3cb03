"""Config keys and defaults — the subset of deepspeed_tpu/runtime/constants.py
that the single-process training slice reads (same names, same values)."""

# batch size
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

# optimizer / scheduler
OPTIMIZER = "optimizer"
OPTIMIZER_PARAMS = "params"
TYPE = "type"
LEGACY_FUSION = "legacy_fusion"
LEGACY_FUSION_DEFAULT = False
SCHEDULER = "scheduler"
SCHEDULER_PARAMS = "params"

ADAM_OPTIMIZER = "adam"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
DEEPSPEED_OPTIMIZERS = [ADAM_OPTIMIZER, LAMB_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER,
                        ONEBIT_LAMB_OPTIMIZER]
ADAM_W_MODE = "adam_w_mode"
ADAM_W_MODE_DEFAULT = True

ZERO_ALLOW_UNTESTED_OPTIMIZER = "zero_allow_untested_optimizer"
ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT = False

# logging
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False

# gradients
GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0
PRESCALE_GRADIENTS = "prescale_gradients"
PRESCALE_GRADIENTS_DEFAULT = False
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0
SPARSE_GRADIENTS = "sparse_gradients"
SPARSE_GRADIENTS_DEFAULT = False

# precision (EleutherAI fork: PRECISION, runtime/constants.py:127-161)
FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_ENABLED_DEFAULT = False
FP16_TYPE = "type"
FP16_TYPE_DEFAULT = "fp16"
FP16_LOSS_SCALE = "loss_scale"
FP16_LOSS_SCALE_DEFAULT = 0
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 32
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1

# AMP: refused when its "enabled" is set
AMP = "amp"
AMP_ENABLED = "enabled"
AMP_ENABLED_DEFAULT = False
# observability (constants.py:67-68, 253-259)
MEMORY_BREAKDOWN = "memory_breakdown"
MEMORY_BREAKDOWN_DEFAULT = False
TENSORBOARD = "tensorboard"
TENSORBOARD_ENABLED = "enabled"
TENSORBOARD_ENABLED_DEFAULT = False
TENSORBOARD_OUTPUT_PATH = "output_path"
TENSORBOARD_OUTPUT_PATH_DEFAULT = ""
TENSORBOARD_JOB_NAME = "job_name"
TENSORBOARD_JOB_NAME_DEFAULT = "DeepSpeedJobName"
# the self-tuning runtime: refused when its "enabled" is set
AUTOTUNE = "autotune"
AUTOTUNE_ENABLED = "enabled"
# progressive layer drop (constants.py:264-270)
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
PLD_ENABLED = "enabled"
PLD_ENABLED_DEFAULT = False
PLD_THETA = "theta"
PLD_THETA_DEFAULT = 1.0
PLD_GAMMA = "gamma"
PLD_GAMMA_DEFAULT = 0.001
# the chaos runtime (constants.py:196-222, runtime/resilience.py)
FAULTS = "faults"
FAULTS_ENABLED = "enabled"
FAULTS_SEED = "seed"
FAULTS_SEED_DEFAULT = 0
FAULTS_RULES = "rules"
FAULTS_RETRY = "retry"
FAULTS_RETRY_MAX_ATTEMPTS = "max_attempts"
FAULTS_RETRY_MAX_ATTEMPTS_DEFAULT = 4
FAULTS_RETRY_BASE_DELAY_MS = "base_delay_ms"
FAULTS_RETRY_BASE_DELAY_MS_DEFAULT = 50.0
FAULTS_RETRY_MAX_DELAY_MS = "max_delay_ms"
FAULTS_RETRY_MAX_DELAY_MS_DEFAULT = 2000.0
FAULTS_RETRY_JITTER = "jitter"
FAULTS_RETRY_JITTER_DEFAULT = 0.25
FAULTS_WATCHDOG = "watchdog"
FAULTS_WATCHDOG_ENABLED = "enabled"
FAULTS_WATCHDOG_ENABLED_DEFAULT = False
FAULTS_WATCHDOG_DEADLINE_S = "deadline_s"
FAULTS_WATCHDOG_DEADLINE_S_DEFAULT = 600.0
FAULTS_WATCHDOG_POLL_S = "poll_s"
FAULTS_WATCHDOG_POLL_S_DEFAULT = 1.0
FAULTS_WATCHDOG_SNAPSHOT_DIR = "snapshot_dir"
FAULTS_WATCHDOG_FIRST_BEAT_MULT = "first_beat_mult"
# grace multiplier on the deadline BEFORE the first step-boundary beat
# (the first step builds the kernels and warms the allocator)
FAULTS_WATCHDOG_FIRST_BEAT_MULT_DEFAULT = 4.0

# serving (config.py:625-780): the inference-side block, read by
# DeepSpeedServingConfig and handed to ServeConfig / FleetRouter
SERVING = "serving"
SERVING_KV_DTYPE = "kv_dtype"
SERVING_KV_DTYPE_DEFAULT = None
SERVING_SPECULATIVE = "speculative"
SERVING_SPEC_ENABLED = "enabled"
SERVING_SPEC_ENABLED_DEFAULT = False
SERVING_SPEC_DRAFT_LEN = "draft_len"
SERVING_SPEC_DRAFT_LEN_DEFAULT = 4
SERVING_SPEC_NGRAM = "ngram"
SERVING_SPEC_NGRAM_DEFAULT = 3
SERVING_PREFIX_CACHE = "prefix_cache"
SERVING_PREFIX_ENABLED = "enabled"
SERVING_PREFIX_ENABLED_DEFAULT = True
SERVING_PREFIX_MIN_MATCH_BLOCKS = "min_match_blocks"
SERVING_PREFIX_MIN_MATCH_BLOCKS_DEFAULT = 1
SERVING_PREFIX_SESSION_TTL_S = "session_ttl_s"
SERVING_PREFIX_SESSION_TTL_S_DEFAULT = 120.0
SERVING_FLEET = "fleet"
SERVING_FLEET_REPLICAS = "replicas"
SERVING_FLEET_REPLICAS_DEFAULT = 1
SERVING_FLEET_QUEUE_LIMIT = "queue_limit"
SERVING_FLEET_QUEUE_LIMIT_DEFAULT = 64
SERVING_FLEET_SESSION_AFFINITY = "session_affinity"
SERVING_FLEET_SESSION_AFFINITY_DEFAULT = True

# ZeRO (runtime/zero/constants.py)
ZERO_OPTIMIZATION = "zero_optimization"
ZERO_OPTIMIZATION_STAGE = "stage"
ZERO_OPTIMIZATION_CPU_OFFLOAD = "cpu_offload"
ZERO_OPTIMIZATION_CPU_OFFLOAD_PARAMS = "cpu_offload_params"
ZERO_OPTIMIZATION_OFFLOAD_PARAM = "offload_param"
ZERO_OPTIMIZATION_OFFLOAD_OPTIMIZER = "offload_optimizer"

PIPELINE = "pipeline"
MESH = "mesh"  # {"data": -1, "model": 1, "pipe": 1, "seq": 1}

# the `comm` section (config.py DeepSpeedCommConfig): the gradient wire
# (runtime/comm/bucketing.py), its two-level hierarchy, the overlap knobs
# (validated; only "none" runs) and the MoE block (moe/dispatch.py).
# FP32_ALLREDUCE is the reference key: true forces every wire to fp32.
COMM = "comm"
COMM_GRADIENT_REDUCTION = "gradient_reduction"
COMM_GRADIENT_REDUCTION_DEFAULT = "implicit"  # or "bucketed"
COMM_GRADIENT_REDUCTION_MODES = ("implicit", "bucketed")
COMM_WIRE_DTYPE = "wire_dtype"
COMM_WIRE_DTYPE_DEFAULT = "fp32"  # fp32 | bf16 | split | int8 | int4
COMM_REDUCE_BUCKET_SIZE = "reduce_bucket_size"  # elements; falls back to
                                                # zero_optimization's knob
COMM_HIERARCHY = "hierarchy"    # "none" | "auto" | <outer> | {"outer": n}
COMM_HIERARCHY_DEFAULT = "none"
COMM_WIRE_DTYPE_INNER = "wire_dtype_inner"
COMM_WIRE_DTYPE_OUTER = "wire_dtype_outer"
COMM_QUANT_BLOCK_SIZE = "quant_block_size"
COMM_QUANT_BLOCK_SIZE_DEFAULT = 256
COMM_OVERLAP = "overlap"
COMM_OVERLAP_DEFAULT = "none"
COMM_OVERLAP_MODES = ("none", "auto", "on")
COMM_OVERLAP_TIMEOUT_MS = "overlap_timeout_ms"
COMM_OVERLAP_TIMEOUT_MS_DEFAULT = 300_000
COMM_OVERLAP_RECONNECT_ATTEMPTS = "overlap_reconnect_attempts"
COMM_OVERLAP_RECONNECT_ATTEMPTS_DEFAULT = 8
COMM_OVERLAP_RECONNECT_WINDOW_MS = "overlap_reconnect_window_ms"
COMM_OVERLAP_RECONNECT_WINDOW_MS_DEFAULT = 60_000
COMM_OVERLAP_KEEPALIVE_MS = "overlap_keepalive_ms"
COMM_OVERLAP_KEEPALIVE_MS_DEFAULT = 5_000
COMM_MOE = "moe"
FP32_ALLREDUCE = "fp32_allreduce"
FP32_ALLREDUCE_DEFAULT = False

# block-sparse attention (config.py:1079): stored as given for the model
# code (BertConfig.sparsity_config / SparseAttentionUtils) to read
SPARSE_ATTENTION = "sparse_attention"

# the async input pipeline (config.py:263-315): PrefetchLoader under the
# engine-owned loader and the device double buffer (_DeviceFeed)
DATA_PIPELINE = "data_pipeline"
DATA_PIPELINE_ENABLED = "enabled"
DATA_PIPELINE_ENABLED_DEFAULT = True
DATA_PIPELINE_PREFETCH_DEPTH = "prefetch_depth"   # bounded-queue batches
DATA_PIPELINE_PREFETCH_DEPTH_DEFAULT = 2
DATA_PIPELINE_NUM_WORKERS = "num_workers"         # parallel collate threads
DATA_PIPELINE_NUM_WORKERS_DEFAULT = 1
DATA_PIPELINE_DEVICE_PREFETCH = "device_prefetch"  # double-buffer H2D
DATA_PIPELINE_DEVICE_PREFETCH_DEFAULT = True

# checkpointing (config.py:1047-1075)
CHECKPOINT = "checkpoint"
CHECKPOINT_TAG_VALIDATION = "tag_validation"
CHECKPOINT_TAG_VALIDATION_MODES = ("ignore", "warn", "fail")
CHECKPOINT_TAG_VALIDATION_DEFAULT = "warn"
CHECKPOINT_ASYNC_SAVE = "async_save"
CHECKPOINT_ASYNC_SAVE_DEFAULT = False
CHECKPOINT_COMMIT_TIMEOUT_MS = "commit_timeout_ms"
CHECKPOINT_COMMIT_TIMEOUT_MS_DEFAULT = 300_000
CHECKPOINT_PREEMPT_SAVE_DIR = "preempt_save_dir"
CHECKPOINT_PREEMPT_SAVE_DIR_DEFAULT = None

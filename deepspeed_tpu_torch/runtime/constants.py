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

# sections the slice refuses when their "enabled" is set
AMP = "amp"
TENSORBOARD = "tensorboard"
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"

# ZeRO (runtime/zero/constants.py)
ZERO_OPTIMIZATION = "zero_optimization"
ZERO_OPTIMIZATION_STAGE = "stage"
ZERO_OPTIMIZATION_CPU_OFFLOAD = "cpu_offload"
ZERO_OPTIMIZATION_CPU_OFFLOAD_PARAMS = "cpu_offload_params"
ZERO_OPTIMIZATION_OFFLOAD_PARAM = "offload_param"
ZERO_OPTIMIZATION_OFFLOAD_OPTIMIZER = "offload_optimizer"

PIPELINE = "pipeline"
MESH = "mesh"  # {"data": -1, "model": 1, "pipe": 1, "seq": 1}

# the `comm` section: the port reads its MoE block (moe/dispatch.py) and
# the quantization block size it defaults to
COMM = "comm"
COMM_QUANT_BLOCK_SIZE = "quant_block_size"
COMM_QUANT_BLOCK_SIZE_DEFAULT = 256
COMM_MOE = "moe"

# block-sparse attention (config.py:1079): stored as given for the model
# code (BertConfig.sparsity_config / SparseAttentionUtils) to read
SPARSE_ATTENTION = "sparse_attention"

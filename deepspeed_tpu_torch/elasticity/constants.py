"""Elasticity config keys — the port's copy of deepspeed_tpu/elasticity/constants.py
(reference: deepspeed/elasticity/constants.py)."""

ELASTICITY = "elasticity"
ENABLED = "enabled"
ENABLED_DEFAULT = False

MAX_ACCEPTABLE_BATCH_SIZE = "max_train_batch_size"
MAX_ACCEPTABLE_BATCH_SIZE_DEFAULT = 2000
MICRO_BATCHES = "micro_batch_sizes"
MICRO_BATCHES_DEFAULT = [2, 4, 6]
MIN_GPUS = "min_gpus"
MIN_GPUS_DEFAULT = 1
MAX_GPUS = "max_gpus"
MAX_GPUS_DEFAULT = 10000
MIN_TIME = "min_time"
MIN_TIME_DEFAULT = 0
VERSION = "version"
VERSION_DEFAULT = 0.1
LATEST_ELASTICITY_VERSION = 0.1
PREFER_LARGER_BATCH = "prefer_larger_batch"
PREFER_LARGER_BATCH_DEFAULT = True
IGNORE_NON_ELASTIC_BATCH_INFO = "ignore_non_elastic_batch_info"
IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT = False

DEEPSPEED_ELASTICITY_CONFIG = "DEEPSPEED_ELASTICITY_CONFIG"
MINIMUM_DEEPSPEED_VERSION = "0.1.0"

"""ZeRO stages 1-3 (the port of deepspeed_tpu/runtime/zero/), with the
stage-3 surface `Init`, `GatheredParameters` and `TiledLinear`."""

from .config import DeepSpeedZeroConfig  # noqa: F401
from .partition_parameters import GatheredParameters, Init  # noqa: F401
from .tiling import TiledLinear  # noqa: F401

"""1-bit Adam and 1-bit LAMB (deepspeed_tpu/runtime/fp16/onebit)."""

from .adam import OnebitAdam  # noqa: F401
from .lamb import OnebitLamb  # noqa: F401

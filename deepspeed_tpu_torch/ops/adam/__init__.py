from .fused_adam import FusedAdam  # noqa: F401

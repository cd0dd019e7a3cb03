from .cpu_adam import HostAdam  # noqa: F401
from .fused_adam import FusedAdam  # noqa: F401

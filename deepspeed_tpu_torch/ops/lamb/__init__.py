from .fused_lamb import FusedLamb  # noqa: F401

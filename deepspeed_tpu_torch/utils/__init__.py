"""Small shared helpers (logging, device selection)."""

from .device import check_same_device, resolve_device
from .logging import log_dist, logger

__all__ = ["logger", "log_dist", "resolve_device", "check_same_device"]

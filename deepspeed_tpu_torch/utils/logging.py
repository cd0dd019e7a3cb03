"""Rank-aware logging (the port's copy of deepspeed_tpu/utils/logging.py).

Same `logger` + `log_dist(message, ranks=...)` surface; the rank comes
from `torch.distributed` when a process group is up, else 0.
"""

import logging
import os
import sys

_FORMAT = "[%(asctime)s] [%(levelname)s] [deepspeed_tpu_torch] %(message)s"


def _create_logger(name="deepspeed_tpu_torch", level=logging.INFO):
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    if not lg.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(logging.Formatter(_FORMAT))
        lg.addHandler(handler)
    return lg


logger = _create_logger(
    level=getattr(logging, os.environ.get("DSTPU_LOG_LEVEL", "INFO").upper(), logging.INFO)
)


def _process_index():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message, ranks=None, level=logging.INFO):
    """Log `message` only on the listed process ranks (None/[-1] => all)."""
    my_rank = _process_index()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


def warning_once(message, _seen=set()):
    if message not in _seen:
        _seen.add(message)
        logger.warning(message)

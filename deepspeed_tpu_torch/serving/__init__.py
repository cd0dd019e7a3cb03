"""deepspeed_tpu_torch.serving — the continuous-batching inference engine.

A paged KV cache with block-level prefix caching (`kv_cache.py`),
in-flight admission with chunked prefill (`scheduler.py`), the prefill
and decode programs (`programs.py`), the engine with pinned sessions and
its worker thread (`engine.py`) and a multi-replica fleet router
(`router.py`), over a dense or int8/int4 KV cache, with speculative
decoding (`draft_len > 0`).  Paged attention runs as the Hopper kernel on
the card.
"""

from .engine import ServeConfig, ServeEngine, ServeWorker, SessionPin
from .kv_cache import (KV_QUANT_WIRES, TRASH_BLOCK, PagedKVCache,
                       kv_block_bytes, resolve_kv_dtype, rows_for_tables)
from .programs import KV_MODES, ServeSchedule, sample_token
from .router import FleetRouter, build_fleet
from .scheduler import (ADMISSION_POLICIES, ERROR, FINISHED, PREFILL,
                        RUNNING, WAITING, Request, Scheduler)

__all__ = [
    "ServeConfig", "ServeEngine", "ServeWorker", "SessionPin",
    "PagedKVCache",
    "TRASH_BLOCK", "KV_QUANT_WIRES", "KV_MODES", "kv_block_bytes",
    "resolve_kv_dtype",
    "rows_for_tables", "ServeSchedule", "sample_token", "Request",
    "Scheduler", "ADMISSION_POLICIES", "WAITING", "PREFILL", "RUNNING",
    "FINISHED", "ERROR", "FleetRouter", "build_fleet",
]

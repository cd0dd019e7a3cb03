"""Durable bench/run artifacts — the port's copy of
deepspeed_tpu/monitor/artifacts.py.

Round-5 post-mortem: the on-TPU artifacts that proved a 0.41x regression
were later deleted from the tree (commit 53f94f7), leaving docs pointing
at files that no longer exist.  This module gives bench.py (and any
other tool) ONE write path that always lands results in a committed,
manifest-indexed directory: `bench_artifacts/runs/<stamp>_<metric>.json`
plus an append-only `manifest.jsonl` — deleting a result now requires
editing the manifest too, which review catches."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from .monitor import SCHEMA_VERSION


def record_bench_result(result: Dict[str, Any],
                        root: Optional[str] = None,
                        name: Optional[str] = None) -> str:
    """Write `result` as a durable artifact; returns the path relative
    to `root`'s parent (repo-relative when root is the default).  Never
    raises into the caller's hot path beyond filesystem errors — bench
    wraps this in its own try/except."""
    if root is None:
        here = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        root = os.path.join(here, "bench_artifacts", "runs")
    os.makedirs(root, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
    metric = name or str(result.get("metric", "result"))
    fname = f"{stamp}_{metric}.json"
    path = os.path.join(root, fname)
    record = {"schema_version": SCHEMA_VERSION, "written_unix": time.time(),
              "result": result}
    with open(path, "w") as f:
        json.dump(record, f, indent=2, sort_keys=True, default=str)
    with open(os.path.join(root, "manifest.jsonl"), "a") as f:
        f.write(json.dumps({
            "file": fname, "metric": metric,
            "platform": result.get("platform"),
            "value": result.get("value"), "unit": result.get("unit"),
            "written_unix": record["written_unix"]}, default=str) + "\n")
    return os.path.join(os.path.basename(os.path.dirname(root)),
                        os.path.basename(root), fname)

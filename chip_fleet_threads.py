#!/usr/bin/env python3
"""What worker threads give a serving fleet on one GPU.

    python3 chip_fleet_threads.py [RECORDS.jsonl]

Run from the root of a checkout on a machine with an NVIDIA GPU and the
CUDA toolkit; it imports `chip_smoke.py` from beside it (nothing of JAX).
It builds the paged-attention kernel (#10), makes chip_smoke's GPT-2 XL
(bf16, random weights from seed 0) and sends serve-fleet's traffic
(phase 7's 8 prompts, 64 new tokens each, and 4 two-turn sessions)
through `chip_smoke.serve_fleet_run` four ways, in turns A B C D D C B A:

* workers: 2 replicas, a `ServeWorker` thread each on the default stream
  (`FleetRouter.start()`, what chip_smoke's serve-fleet runs);
* main: the same 2 replicas stepped in turn on the main thread
  (`FleetRouter.step_all`), the same device work with no second thread;
* stream_each: 2 replicas, a worker each stepping its engine on a CUDA
  stream of its own (after the default stream's work so far);
* workers, 1 replica.

Every run holds serve_fleet_run's checks (exact launch counts, sessions
on their replica, SLO percentiles, trace counts).  stdout gets the card's
name and power limit and a short line a run; each run's whole record goes
to RECORDS.jsonl where one is named.
"""

import gc
import json
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402

# chip_smoke phase 7's record, as far as serve_fleet_traffic reads it
SERVE = {"prompt_lens": [188, 63, 133, 208, 339, 267, 211, 375],
         "max_new_tokens": 64}
KEYS = ("tokens_per_s", "wall_s", "ttft_p50_ms", "ttft_p99_ms",
        "decode_step_span_mean_ms", "host_cpu_s", "decode_steps",
        "requests_by_replica", "peak_mem_bytes")


def stream_each(router):
    """A worker a replica, each stepping its engine on a CUDA stream of
    its own."""
    import torch

    from deepspeed_tpu_torch.serving import ServeWorker

    class StreamWorker(ServeWorker):
        def __init__(self, engine):
            super().__init__(engine)
            self.stream = torch.cuda.Stream(device=engine.device)

        def run(self):
            dev = self.engine.device
            torch.cuda.set_device(dev)
            # the caches and weights were written on the default stream
            self.stream.wait_stream(torch.cuda.default_stream(dev))
            with torch.cuda.stream(self.stream):
                super().run()

        def stop(self, timeout=10.0):
            try:
                super().stop(timeout)
            finally:
                self.stream.synchronize()

    for e in router.engines:
        w = StreamWorker(e)
        w.start()
        router._workers.append(w)


def main():
    import torch

    from deepspeed_tpu_torch.kernels import build
    from deepspeed_tpu_torch.models import GPT, gpt2_config

    if not torch.cuda.is_available():
        print("chip_fleet_threads: no CUDA device", file=sys.stderr)
        return 2
    print(cs.gpu_name_and_limit(), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(build.build, ("paged_attention.cu",
                                    "paged_attention_f16.cu",
                                    "paged_attention_int8.cu",
                                    "paged_attention_int4.cu")))
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    cfg = gpt2_config("xl", param_dtype=torch.bfloat16)
    model = GPT(cfg, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(0))
    traffic = cs.serve_fleet_traffic(SERVE)
    lanes = [("workers", 2), ("main", 2), (stream_each, 2), ("workers", 1)]
    records = []
    tmp = tempfile.mkdtemp(prefix="fleet-threads-")
    try:
        for turn, (drive, replicas) in enumerate(lanes + lanes[::-1]):
            rec, router, engines = cs.serve_fleet_run(
                model, traffic, replicas, os.path.join(tmp, f"t{turn}"),
                drive)
            router.close()
            records.append({"turn": turn, **rec})
            print(json.dumps({"turn": turn, "drive": rec["drive"],
                              "replicas": replicas,
                              "device_idle_share":
                                  rec["idle_window"]["device_idle_share"],
                              **{k: rec[k] for k in KEYS}}), flush=True)
            del router, engines
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if len(sys.argv) > 1:
        os.makedirs(os.path.dirname(os.path.abspath(sys.argv[1])),
                    exist_ok=True)
        with open(sys.argv[1], "w") as out:
            out.writelines(json.dumps(r) + "\n" for r in records)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""What the run monitor costs a training step, on one GPU: train-resume's
recipe (chip_smoke.py: GPT-2 small, seq 1024, micro 8, bf16, fused CE,
train_batch() from the engine's loader) in one process, as a fresh engine
a turn, with

* off: no monitoring (train-resume's config);
* monitor: `monitor` enabled (sync_timing, flops, tokens_per_sample 1024)
  with tracing at sample rate 1;
* monitor-nosync: the same with sync_timing false (no device wait in the
  spans, a CUDA value still in flight left out of the event);
* all: monitor + `wall_clock_breakdown`, TensorBoard (a recording writer)
  and the watchdog (train-monitor's one-step extras, the profiler window,
  the flops profiler, the faults and the preemption save, left out);

in turns off, monitor, monitor-nosync, all, all, monitor-nosync, monitor,
off.  Each turn trains 3 warm-up steps (the first counts the monitor's
flops) and then times 10, each ended by a synchronize on the host clock.
Prints one JSON line a turn and a summary line (the median step ms of
each variant over its two turns, and its difference from off's).

    python3 chip_monitor_ab.py [--device cpu --size nano]   # CPU rehearsal
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ORDER = ("off", "monitor", "monitor-nosync", "all",
         "all", "monitor-nosync", "monitor", "off")


def variant_config(name, run_dir, seq):
    from chip_smoke import train_config

    conf = train_config(8, 1e-4, "bf16")
    if name == "off":
        return conf
    conf["monitor"] = {"enabled": True, "output_path": run_dir,
                       "job_name": name, "sync_timing": name != "monitor-nosync",
                       "flops": True, "tokens_per_sample": seq,
                       "tracing": {"enabled": True, "sample_rate": 1.0}}
    if name == "all":
        conf["wall_clock_breakdown"] = True
        conf["faults"] = {"watchdog": {"enabled": True, "deadline_s": 120}}
    return conf


def turn(name, size, device, run_dir, warmup=3, steps=10):
    import torch

    import deepspeed_tpu_torch as dt
    from chip_smoke import resume_dataset
    from deepspeed_tpu_torch.models import GPT, gpt2_config
    from deepspeed_tpu_torch.utils.tensorboard import TensorBoardMonitor

    class Recording:
        def add_scalar(self, tag, value, step):
            pass

        def flush(self):
            pass

    seq = 1024
    cfg = gpt2_config(size, loss_impl="pallas", max_seq_len=seq)
    model = GPT(cfg, device=device,
                generator=torch.Generator(device=device).manual_seed(0))
    eng, *_ = dt.initialize(model=model,
                            config_params=variant_config(name, run_dir, seq),
                            training_data=resume_dataset(seq=seq),
                            device=device)
    if name == "all":
        eng.monitor = TensorBoardMonitor(writer=Recording())
        eng.run_monitor.tensorboard = eng.monitor
    on_card = device == "cuda"
    ms = []
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        eng.train_batch()
        if on_card:
            torch.cuda.synchronize()
        if i >= warmup:
            ms.append((time.perf_counter() - t0) * 1e3)
    eng.finalize_monitoring()
    del eng, model
    if on_card:
        torch.cuda.empty_cache()
    return ms


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default="small")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_monitor_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke

    card = (chip_smoke.gpu_name_and_limit() if args.device == "cuda"
            else "cpu rehearsal")
    if args.device == "cuda":
        from deepspeed_tpu_torch.kernels import build

        for src in ("flash_attention.cu", "fused_xent.cu"):
            build.build(src)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="monitor-ab-") as run_dir:
        for i, name in enumerate(ORDER):
            ms = turn(name, args.size, args.device,
                      os.path.join(run_dir, str(i)))
            runs.setdefault(name, []).extend(ms)
            print(json.dumps({"turn": i, "variant": name, "card": card,
                              "step_ms": ms,
                              "median_ms": float(np.median(ms))}),
                  flush=True)
    med = {k: float(np.median(v)) for k, v in runs.items()}
    q = {k: [float(x) for x in np.percentile(v, [25, 75])]
         for k, v in runs.items()}
    print(json.dumps({"summary": "monitor-ab", "card": card,
                      "config": f"gpt2 {args.size}, seq 1024, micro 8, "
                      "bf16, fused CE, train_batch() from 24 sequences; "
                      "3 warm-up + 10 timed steps a turn, two turns a "
                      "variant",
                      "median_ms": med, "quartiles_ms": q,
                      "over_off_ms": {k: v - med["off"]
                                      for k, v in med.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

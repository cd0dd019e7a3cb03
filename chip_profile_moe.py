#!/usr/bin/env python3
"""Where train-moe-dropless's step time goes, on one GPU.

    python3 chip_profile_moe.py

Run from the root of a checkout on a machine with an NVIDIA GPU and the
CUDA toolkit; it imports `chip_smoke.py` from beside it (nothing of JAX).
It builds the kernels, then trains `chip_smoke.py`'s train-moe recipe
(125M+MoE-64, seq 2048, micro 4, bf16, fused CE, sorted dispatch) for 2
warm-up and 4 timed steps and profiles 2 more (`phase_train_profile`:
device time by kernel class, the device's idle share), then the same
with `comm.moe.dropless` at overflow factor 1.0, and last, two more
dropless steps under torch.profiler with host activities: the host ops
by self CPU time, the host time of the GEMMs, autograd nodes and host
reads, and the device kernels a step.  Each result is a JSON line.
"""

import gc
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402

HOST_OPS = ("autograd::engine", "aten::item", "aten::_local_scalar",
            "cudaEventSynchronize", "cudaStreamSynchronize",
            "cudaMemcpyAsync", "aten::argsort", "aten::sort", "aten::mm",
            "aten::matmul", "aten::unbind", "aten::stack")


def host_profile(eng, data, steps=2):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.train_batch(data)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    top = sorted([(e.key, e.self_cpu_time_total / 1e3, e.count) for e in avg
                  if e.self_cpu_time_total > 0], key=lambda a: -a[1])[:30]
    tot = sorted([(e.key, e.cpu_time_total / 1e3, e.count) for e in avg
                  if e.key.startswith(HOST_OPS)], key=lambda a: -a[1])
    dev = [(e.self_device_time_total / 1e3, e.count) for e in avg
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    return {"phase": "train-moe-dropless-host-profile", "steps": steps,
            "device_kernels_per_step": sum(c for _, c in dev) / steps,
            "device_busy_ms_per_step": sum(m for m, _ in dev) / steps,
            "host_top": [{"op": k[:70], "self_cpu_ms_per_step": m / steps,
                          "calls_per_step": c / steps} for k, m, c in top],
            "host_total": [{"op": k[:70], "cpu_ms_per_step": m / steps,
                            "calls_per_step": c / steps}
                           for k, m, c in tot]}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_profile_moe: no CUDA device", file=sys.stderr)
        return 2
    print(cs.gpu_name_and_limit(), flush=True)
    cs.build_all()
    for dropless in (False, True):
        rec, eng, data = cs.phase_train_moe(warmup=2, steps=4,
                                            dropless=dropless)
        cs.emit(cs.phase_train_profile(eng, data, rec))
        if dropless:
            cs.emit(host_profile(eng, cs.vocab_batches(4, 4, 2048, 50304,
                                                       9)))
        del eng, data
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

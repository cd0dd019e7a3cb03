#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch/CUDA port on one GPU, in turns
A, B, B, A, each turn a fresh process run from the root of its checkout:

    python3 chip_ab.py OLD_DIR NEW_DIR

Each turn uses that checkout's own `chip_smoke.py` and package: it times
the paged-attention dispatch at the decode shape (GPT-2 XL heads, B=8,
bf16 cache, q as the serving block's view of the fused QKV output) — its
host time per call and its device time with the L2 cache flushed — then
runs the serve phase of that checkout's chip_smoke (GPT-2 XL bf16 serving
8 requests) and, where the checkout has one, its train phase (GPT-2 small
bf16 training through the flash kernels: tokens/s and step ms).  One JSON
line per turn, then the card's name and power limit.  Use it to hold a
change against its parent: unpack the parent with `git archive` into a
git-ignored directory and pass both.
"""

import json
import subprocess
import sys

TURN = r'''
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from deepspeed_tpu_torch.kernels import registry
from deepspeed_tpu_torch.serving.kv_cache import rows_for_tables

H, Dh, bs, W, B = 25, 64, 16, 64, 8
g = torch.Generator(device="cuda").manual_seed(0)
ck = torch.randn(513 * bs, H, Dh, device="cuda", generator=g).bfloat16()
cv = torch.randn(513 * bs, H, Dh, device="cuda", generator=g).bfloat16()
rows = rows_for_tables(torch.randint(1, 513, (B, W), device="cuda",
                                     generator=g), bs)
qkv = torch.randn(B, 1, 3 * H * Dh, device="cuda", generator=g).bfloat16()
q = qkv[..., :H * Dh].view(B, 1, H, Dh)
q_pos = torch.randint(256, 768, (B, 1), device="cuda", generator=g)


def call():
    return registry.dispatch("paged_attention", q, ck, cv, rows, q_pos,
                             block_size=bs)


call()
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(200):
    call()
host_us = (time.perf_counter() - t0) / 200 * 1e6
torch.cuda.synchronize()
flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
device_ms = cs.time_ms(call, 50, flush)
del flush
serve = cs.phase_serve()
serve = serve[0] if isinstance(serve, tuple) else serve  # older checkouts
serve = {k: serve[k] for k in ("tokens_per_s", "decode_step_mean_ms",
                               "ttft_p50_ms", "wall_s")}
torch.cuda.empty_cache()
train = {}
if hasattr(cs, "phase_train"):
    rec = cs.phase_train()[0]
    train = {"train_tokens_per_s": rec["tokens_per_s"],
             "train_step_ms_mean": rec["step_ms_mean"]}
print(json.dumps({"dispatch_host_us": host_us, "dispatch_device_ms": device_ms,
                  **serve, **train}))
'''


def main(argv):
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = argv[1], argv[2]
    for tag, tree in (("A", old), ("B", new), ("B", new), ("A", old)):
        proc = subprocess.run([sys.executable, "-c", TURN], cwd=tree,
                              stdout=subprocess.PIPE, text=True, check=True)
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": tag, "tree": tree, **rec}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

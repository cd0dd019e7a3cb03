#!/usr/bin/env python3
"""Compare two checkouts of the PyTorch/CUDA port on one GPU, in turns
A, B, B, A, each turn a fresh process run from the root of its checkout:

    python3 chip_ab.py OLD_DIR NEW_DIR [paged] [serve] [kernels] [moe] [xent]

Each turn uses that checkout's own `chip_smoke.py` and package, and runs
the turn scripts named (all but `paged`, which `serve` holds, when none
is):

* paged: times the paged-attention dispatch at the decode shape (GPT-2
  XL heads, B=8, bf16 cache, q as the serving block's view of the fused
  QKV output) — its host time per call (the median and the least of 25
  runs of 200 calls) and its device time with the L2 cache flushed — and
  the device time of decode at Dh 128 (16 heads) and of chip_smoke's
  prefill-bfloat16 shape (B 1, T 128 from position 448, GPT-2 XL heads);
* serve: the paged turn, then the serve phase of that checkout's
  chip_smoke (GPT-2 XL bf16 serving 8 requests);
* kernels: the MoE dispatch and combine (#13, #14) at train-moe's shape
  (chip_smoke `moe_case` train-k1-bfloat16) with the dispatch's device
  operations a call under torch.profiler, the block-sparse kernels
  (#7-#9) at train-bert-sparse's shape without and with dropout 0.1
  (`sparse_case` train-bfloat16, train-dropout-bfloat16), paged decode at
  Dh 64 and 128 (device time, L2 flushed), then the train-moe and
  train-bert-sparse phases for their step ms and tokens/s;
* moe: the MoE dispatch (#13) against its plain version and one
  index_select (device times, L2 flushed) at train-moe's shape (B 4,
  E 64, D 768, bf16, capacity factor 1) at top-1 and top-2, with groups
  of S 2048 and 4096;
* xent: the fused cross-entropy kernels (#4-#6) at train-pallas's shape
  (chip_smoke `xent_case` train-bfloat16: N 8192, D 768, V 50304, bf16,
  the tied head; device times, L2 flushed), then the train-pallas phase
  (GPT-2 small bf16 through the fused CE: step ms, tokens/s, peak
  memory).

One JSON line per turn, then the card's name and power limit.  Use it to
hold a change against its parent: unpack the parent with `git archive`
into a git-ignored directory and pass both.
"""

import json
import subprocess
import sys

PAGED = r'''
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
runs = []
for _ in range(25):
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    runs.append((time.perf_counter() - t0) / 200 * 1e6)
    torch.cuda.synchronize()
runs.sort()
flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
device_ms = cs.time_ms(call, 50, flush)
# decode at Dh 128 and the prefill chunk of chip_smoke's prefill-bfloat16
more = {}
for name, Bq, T, Hq, D, start in (("decode_dh128", 8, 1, 16, 128, None),
                                  ("prefill_bfloat16", 1, 128, 25, 64, 448)):
    ck2 = torch.randn(513 * bs, Hq, D, device="cuda", generator=g).bfloat16()
    cv2 = torch.randn(513 * bs, Hq, D, device="cuda", generator=g).bfloat16()
    rows2 = rows_for_tables(torch.randperm(512, device="cuda", generator=g)
                            [:Bq * W].view(Bq, W) + 1, bs)
    qkv2 = torch.randn(Bq, T, 3 * Hq * D, device="cuda",
                       generator=g).bfloat16()
    q2 = qkv2[..., :Hq * D].view(Bq, T, Hq, D)
    qp2 = (torch.randint(256, 768, (Bq, 1), device="cuda", generator=g)
           if start is None else
           start + torch.arange(T, device="cuda")[None, :])
    more[name + "_device_ms"] = cs.time_ms(
        lambda: registry.dispatch("paged_attention", q2, ck2, cv2, rows2,
                                  qp2, block_size=bs), 50, flush)
    del ck2, cv2
del flush
rec = {"dispatch_host_us": runs[len(runs) // 2],
       "dispatch_host_us_least": runs[0], "dispatch_device_ms": device_ms,
       **more}
'''

SERVE = r'''
serve = cs.phase_serve()
serve = serve[0] if isinstance(serve, tuple) else serve  # older checkouts
rec.update({k: serve[k] for k in ("tokens_per_s", "decode_step_mean_ms",
                                  "ttft_p50_ms", "wall_s")})
print(json.dumps(rec))
'''

KERNELS = r'''
import gc, json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from deepspeed_tpu_torch.kernels import registry
from deepspeed_tpu_torch.moe import dispatch as dsp
from deepspeed_tpu_torch.serving.kv_cache import rows_for_tables

gen = torch.Generator(device="cuda").manual_seed(0)
flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
rec = {}
m = cs.moe_case("train-k1-bfloat16", 4, 2048, 64, 1, 1.0, 768,
                torch.bfloat16, gen, flush, True)
for name in ("moe_dispatch", "moe_combine"):
    rec[name] = {f: m["kernels"][name].get(f) for f in
                 ("kernel_ms", "plain_ms", "bound_ms", "library_ms")}

# the dispatch's device operations a call, at the same shape
B, S, E, k, C, D = 4, 2048, 64, 1, 32, 768
eidx, gate, pos, keep, _ = dsp.topk_routing(torch.softmax(torch.randn(
    B, S, E, device="cuda", generator=gen), -1), k, C)
x = torch.randn(B, S, D, device="cuda", generator=gen).bfloat16()
call = lambda: registry.dispatch("moe_dispatch", x, eidx, pos, keep, E, C,
                                 impl="cuda")
call()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(20):
        call()
    torch.cuda.synchronize()
rec["moe_dispatch"]["profile"] = {
    e.key: {"per_call": e.count / 20,
            "us_per_call": e.self_device_time_total / 20}
    for e in prof.key_averages()
    if e.device_type == torch.autograd.DeviceType.CUDA}

train = cs.fixed_layout(16, 128, 4096)
for rate in (0.0, 0.1):
    c = cs.sparse_case(f"train-{rate}", 2, 4096, 16, 64, 128, train,
                       torch.bfloat16, False, rate, gen, flush, True)
    rec[f"sparse_dropout_{rate}"] = {
        n: c["kernels"][n]["kernel_ms"] for n in c["kernels"]}
    rec[f"sparse_dropout_{rate}"]["dkv_bound_ms"] = \
        c["kernels"]["flash_sparse_dkv"]["bound_ms"]

for Dh, H in ((64, 25), (128, 16)):
    bs, W, Bq = 16, 64, 8
    ck = torch.randn(513 * bs, H, Dh, device="cuda", generator=gen).bfloat16()
    cv = torch.randn(513 * bs, H, Dh, device="cuda", generator=gen).bfloat16()
    rows = rows_for_tables(torch.randint(1, 513, (Bq, W), device="cuda",
                                         generator=gen), bs)
    qkv = torch.randn(Bq, 1, 3 * H * Dh, device="cuda",
                      generator=gen).bfloat16()
    q = qkv[..., :H * Dh].view(Bq, 1, H, Dh)
    q_pos = torch.randint(256, 768, (Bq, 1), device="cuda", generator=gen)
    rec[f"paged_decode_dh{Dh}_ms"] = cs.time_ms(
        lambda: registry.dispatch("paged_attention", q, ck, cv, rows, q_pos,
                                  block_size=bs), 50, flush)
del flush
torch.cuda.empty_cache()

for phase in ("phase_train_moe", "phase_train_bert_sparse"):
    r, eng, data = getattr(cs, phase)()
    rec[phase[6:]] = {"step_ms_mean": r["step_ms_mean"],
                      "tokens_per_s": r["tokens_per_s"]}
    del r, eng, data
    gc.collect()
    torch.cuda.empty_cache()
print(json.dumps(rec))
'''

MOE = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs

gen = torch.Generator(device="cuda").manual_seed(0)
flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
rec = {}
for name, S, k in (("k1-s2048", 2048, 1), ("k2-s2048", 2048, 2),
                   ("k1-s4096", 4096, 1), ("k2-s4096", 4096, 2)):
    m = cs.moe_case(name, 4, S, 64, k, 1.0, 768, torch.bfloat16, gen, flush,
                    True)
    d = m["kernels"]["moe_dispatch"]
    rec[name] = {"capacity": m["capacity"],
                 **{f: d.get(f) for f in ("kernel_ms", "plain_ms", "bound_ms",
                                          "library_ms")}}
print(json.dumps(rec))
'''

XENT = r'''
import gc, json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs

gen = torch.Generator(device="cuda").manual_seed(0)
flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
c = cs.xent_case("train-bfloat16", 8192, 768, 50304, torch.bfloat16, gen,
                 flush, True)
rec = {n: {f: c["kernels"][n].get(f) for f in ("kernel_ms", "plain_ms",
                                               "bound_ms")}
       for n in c["kernels"]}
rec["dw_route"] = c.get("dw_route")
rec["max_err_over_tol"] = c["max_err_over_tol"]
del flush, c
gc.collect()
torch.cuda.empty_cache()
r, eng, data = cs.phase_train(loss_impl="pallas")
rec["train_pallas"] = {k: r.get(k) for k in ("step_ms_mean", "tokens_per_s",
                                             "peak_mem_bytes")}
print(json.dumps(rec))
'''

TURNS = {"paged": PAGED + "print(json.dumps(rec))\n", "serve": PAGED + SERVE,
         "kernels": KERNELS, "moe": MOE, "xent": XENT}


def main(argv):
    turns = argv[3:] or [t for t in TURNS if t != "paged"]
    if len(argv) < 3 or any(t not in TURNS for t in turns):
        print(__doc__, file=sys.stderr)
        return 2
    old, new = argv[1], argv[2]
    for tag, tree in (("A", old), ("B", new), ("B", new), ("A", old)):
        for turn in turns:
            proc = subprocess.run([sys.executable, "-c", TURNS[turn]],
                                  cwd=tree, stdout=subprocess.PIPE, text=True,
                                  check=True)
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"turn": tag, "script": turn, "tree": tree,
                              **rec}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

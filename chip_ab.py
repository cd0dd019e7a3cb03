#!/usr/bin/env python3
"""Compare checkouts of the PyTorch/CUDA port on one GPU, in turns A, B,
B, A (A, B, C, C, B, A for three, and so on), each turn a fresh process
run from the root of its checkout:

    python3 chip_ab.py OLD_DIR NEW_DIR [MORE_DIRS ...] [paged] [serve]
                       [kernels] [moe] [sparse] [xent] [flash]
                       [flash-kernels] [codec-leaves] [codec]

Each turn uses that checkout's own `chip_smoke.py` and package, and runs
the turn scripts named (when none is, all but `paged`, which `serve`
holds, `sparse`, which `kernels` holds, `flash-kernels`, which `flash`
holds, and `codec-leaves`, which `codec` holds).  Kernel-only device
times (`profiled_flushed_ms`) come from the `chip_smoke.py` beside this
script in every turn, so each checkout's kernels are read by the same
tool:

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
  (`sparse_case` train-bfloat16, train-dropout-bfloat16; with the
  forward's and dQ's routes where the checkout records them), paged
  decode at
  Dh 64 and 128 (device time, L2 flushed), then the train-moe and
  train-bert-sparse phases for their step ms and tokens/s;
* moe: the MoE dispatch (#13) and combine (#14) against their plain
  versions and one index_select / embedding_bag (device times on CUDA
  events, L2 flushed, and each kernel's own device time under
  torch.profiler) at train-moe's shape (B 4, E 64, D 768, bf16, capacity
  factor 1) at top-1 and top-2, with groups of S 2048 and 4096;
* codec-leaves: the blockwise codec kernels (#11 quantize int8, #12
  dequantize int8 and int4 to bf16) on one leaf of each GPT-2 XL matrix
  shape (chip_smoke `codec_per_shape`: device times on CUDA events, L2
  flushed, beside each kernel's own device time under torch.profiler and
  the quantize's route where the checkout has routes), then over every
  matrix leaf (`codec_tree_times`: the kernels' device time under
  torch.profiler, the plain versions', the spans) and the store's
  one-time quantize loop (`programs.QuantizedWeights`) as a span on CUDA
  events;
* codec: the codec-leaves turn, then GPT-2 XL bf16 served from int8
  weights (chip_smoke phase 7's schedule and prompt lengths, fresh
  tokens): the engine build's quantize loop as a span, tokens/s, the
  mean decode step;
* sparse, ~1 min a turn after the build: the block-sparse forward (#7)
  alone at train-bert-sparse's shape (`sparse_case` train-bfloat16
  without and with dropout 0.1; device times, L2 flushed, and its worst
  error over the bound);
* xent: the fused cross-entropy kernels (#4-#6) at train-pallas's shape
  (chip_smoke `xent_case` train-bfloat16: N 8192, D 768, V 50304, bf16,
  the tied head; device times, L2 flushed; the routes where the checkout
  records them; cuBLAS x @ W alone, the forward's bare product), then the
  train-pallas phase
  (GPT-2 small bf16 through the fused CE: step ms, tokens/s, peak
  memory);
* flash-kernels: the dense flash kernels (#1-#3) against their plain
  versions (chip_smoke `flash_case`, bf16, causal, no dropout; device
  times, L2 flushed) at train's shape (B 8, S 1024, H 12, Dh 64), at
  train-moe's S 2048 (B 4) and at Dh 128 (B 2, S 512, H 4), with each
  case's dQ and dK/dV routes where the checkout records them, SDPA's
  backward (dQ, dK and dV in one call) and the worst error over the bound;
* flash: the flash-kernels turn, then the train-pallas and train phases
  (GPT-2 small bf16 with the fused and the plain CE: step ms, tokens/s,
  peak memory).

One JSON line per turn, then the card's name and power limit.  Use it to
hold a change against its parent: unpack the parent with `git archive`
into a git-ignored directory and pass both.
"""

import json
import os
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
    rec[f"sparse_dropout_{rate}"]["dq_bound_ms"] = \
        c["kernels"]["flash_sparse_dq"]["bound_ms"]
    rec[f"sparse_dropout_{rate}"]["dq_route"] = c.get("dq_route")
    rec[f"sparse_dropout_{rate}"]["fwd_route"] = c.get("fwd_route")
    rec[f"sparse_dropout_{rate}"]["fwd_bound_ms"] = \
        c["kernels"]["flash_sparse_fwd"]["bound_ms"]

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

# the chip_smoke.py beside chip_ab.py, as `tool`: the same kernel-only
# timing in every checkout's turn
TOOL = r'''
import importlib.util
_spec = importlib.util.spec_from_file_location("chip_ab_tool",
                                               os.environ["CHIP_AB_TOOL"])
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)
'''

MOE = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from deepspeed_tpu_torch.kernels import registry
from deepspeed_tpu_torch.moe import dispatch as dsp
''' + TOOL + r'''
gen = torch.Generator(device="cuda").manual_seed(0)
flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
rec = {}
for name, S, k in (("k1-s2048", 2048, 1), ("k2-s2048", 2048, 2),
                   ("k1-s4096", 4096, 1), ("k2-s4096", 4096, 2)):
    m = cs.moe_case(name, 4, S, 64, k, 1.0, 768, torch.bfloat16, gen, flush,
                    True)
    rec[name] = {"capacity": m["capacity"]}
    for kname in ("moe_dispatch", "moe_combine"):
        d = m["kernels"][kname]
        rec[name][kname] = {f: d.get(f) for f in (
            "kernel_ms", "plain_ms", "bound_ms", "library_ms")}
    # each kernel's own device time, and its library call's, on a draw of
    # the same shape
    C = m["capacity"]
    eidx, gate, pos, keep, _ = dsp.topk_routing(torch.softmax(torch.randn(
        4, S, 64, device="cuda", generator=gen), -1), k, C)
    x = torch.randn(4, S, 768, device="cuda", generator=gen).bfloat16()
    out = torch.randn(4, 64, C, 768, device="cuda", generator=gen).bfloat16()
    rec[name]["moe_dispatch"]["kernel_device_ms"] = tool.profiled_flushed_ms(
        lambda: registry.dispatch("moe_dispatch", x, eidx, pos, keep, 64, C,
                                  impl="cuda"), flush)
    rec[name]["moe_combine"]["kernel_device_ms"] = tool.profiled_flushed_ms(
        lambda: registry.dispatch("moe_combine", out, eidx, gate, pos, keep,
                                  impl="cuda"), flush)
print(json.dumps(rec))
'''

CODEC = r'''
import gc, json, os, sys, time
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as cs
from deepspeed_tpu_torch.kernels import quant_codec, registry
from deepspeed_tpu_torch.models import GPT, gpt2_config
from deepspeed_tpu_torch.serving import programs
''' + TOOL + r'''
cfg = gpt2_config("xl", param_dtype=torch.bfloat16)
model = GPT(cfg, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(0))
flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
rec = {"per_shape": cs.codec_per_shape(model, flush), "device_ms": {}}
params = dict(model.named_parameters())
route = getattr(quant_codec, "quantize_route", None)
for name, shape, count in cs.xl_leaf_shapes(cfg):
    w = next(p for n, p in params.items() if n.endswith(name)).detach()
    n = w.numel()
    calls = {"quantize-int8": lambda: registry.dispatch(
        "quant_codec_quantize", w, 256, "int8", impl="cuda")}
    for wire in ("int8", "int4"):
        p, s = registry.dispatch("quant_codec_quantize", w, 256, wire,
                                 impl="cuda")
        calls[f"dequantize-{wire}"] = (
            lambda p=p, s=s, wire=wire: registry.dispatch(
                "quant_codec_dequantize", p, s, wire, n,
                out_dtype=torch.bfloat16, impl="cuda"))
    rec["device_ms"][name] = {
        key: tool.profiled_flushed_ms(fn, flush) for key, fn in calls.items()}
    rec["device_ms"][name]["quantize_route"] = (
        route(w, 256) if route else "generic (the only route)")
leaves = [p.detach() for p in model.parameters() if p.dim() >= 2]
store = []
rec["store_quantize_span_ms"] = cs.events_span_ms(
    lambda: store.append(programs.QuantizedWeights(model, "int8")))
rec["tree"] = cs.codec_tree_times(leaves, store[0])
del store, flush
gc.collect()
torch.cuda.empty_cache()
'''

SERVE_QW = r'''
from deepspeed_tpu_torch.serving import ServeConfig, ServeEngine

real_quantize_params, build_ms = programs.quantize_params, []


def timed_quantize_params(*a, **kw):
    out = []
    build_ms.append(cs.events_span_ms(
        lambda: out.append(real_quantize_params(*a, **kw))))
    return out[0]


programs.quantize_params = timed_quantize_params
try:
    eng = ServeEngine(model, ServeConfig(
        block_size=16, num_blocks=513, max_batch=8, prefill_chunk=128,
        quantized_weights="int8"), device="cuda")
finally:
    programs.quantize_params = real_quantize_params
eng.generate([list(range(50000, 50016))], 2)           # warm-up
lens = np.random.RandomState(0).randint(16, 513, size=8)
rs = np.random.RandomState(2)
prompts = [rs.randint(0, 50257, (int(n),)).tolist() for n in lens]
torch.cuda.synchronize()
t0 = time.perf_counter()
reqs, steps = cs.drive(eng, prompts, 64)
torch.cuda.synchronize()
wall = time.perf_counter() - t0
rec["serve_qw"] = {
    "build_quantize_ms": build_ms[0],
    "tokens_per_s": sum(len(r.out) for r in reqs) / wall,
    "decode_step_mean_ms": float(np.mean([ms for ms, pre in steps
                                          if not pre]))}
'''

SPARSE = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs

gen = torch.Generator(device="cuda").manual_seed(0)
flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
train = cs.fixed_layout(16, 128, 4096)
rec = {}
for rate in (0.0, 0.1):
    c = cs.sparse_case(f"train-{rate}", 2, 4096, 16, 64, 128, train,
                       torch.bfloat16, False, rate, gen, flush, True)
    rec[f"fwd_ms_{rate}"] = c["kernels"]["flash_sparse_fwd"]["kernel_ms"]
    rec[f"fwd_err_over_tol_{rate}"] = c["max_err_over_tol"]["out"]
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
rec["fwd_route"] = c.get("fwd_route")
rec["dx_route"] = c.get("dx_route")
rec["dw_route"] = c.get("dw_route")
rec["max_err_over_tol"] = c["max_err_over_tol"]
rec["matmul_ms"] = c.get("matmul_ms")   # cuBLAS x @ W, the bare product
del flush, c
gc.collect()
torch.cuda.empty_cache()
r, eng, data = cs.phase_train(loss_impl="pallas")
rec["train_pallas"] = {k: r.get(k) for k in ("step_ms_mean", "tokens_per_s",
                                             "peak_mem_bytes")}
print(json.dumps(rec))
'''

FLASH = r'''
import gc, json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs

gen = torch.Generator(device="cuda").manual_seed(0)
flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
rec = {}
for name, B, S, H, D in (("train_shape", 8, 1024, 12, 64),
                         ("train_moe_shape", 4, 2048, 12, 64),
                         ("dh128", 2, 512, 4, 128)):
    c = cs.flash_case(f"{name}-bfloat16", B, S, H, D, torch.bfloat16, True,
                      False, 0.0, 0, gen, flush, True)
    rec[name] = {n.split("_")[-1]: {f: c["kernels"][n].get(f) for f in
                                    ("kernel_ms", "plain_ms", "bound_ms")}
                 for n in c["kernels"]}
    rec[name].update(dq_route=c.get("dq_route"), dkv_route=c.get("dkv_route"),
                     sdpa_fwd_ms=c.get("sdpa_fwd_ms"),
                     sdpa_bwd_ms=c.get("sdpa_bwd_ms"),
                     max_err_over_tol=c["max_err_over_tol"])
del flush, c
gc.collect()
torch.cuda.empty_cache()
'''

FLASH_TRAIN = r'''
for loss_impl, key in (("pallas", "train_pallas"), ("auto", "train")):
    r, eng, data = cs.phase_train(loss_impl=loss_impl)
    rec[key] = {k: r.get(k) for k in ("step_ms_mean", "tokens_per_s",
                                      "peak_mem_bytes")}
    del r, eng, data
    gc.collect()
    torch.cuda.empty_cache()
'''

TURNS = {"paged": PAGED + "print(json.dumps(rec))\n", "serve": PAGED + SERVE,
         "kernels": KERNELS, "moe": MOE, "sparse": SPARSE, "xent": XENT,
         "flash-kernels": FLASH + "print(json.dumps(rec))\n",
         "flash": FLASH + FLASH_TRAIN + "print(json.dumps(rec))\n",
         "codec-leaves": CODEC + "print(json.dumps(rec))\n",
         "codec": CODEC + SERVE_QW + "print(json.dumps(rec))\n"}
HELD = ("paged", "sparse", "flash-kernels", "codec-leaves")


def main(argv):
    trees = [a for a in argv[1:] if os.path.isdir(a)]
    turns = [a for a in argv[1:] if a not in trees] or \
        [t for t in TURNS if t not in HELD]
    if len(trees) < 2 or any(t not in TURNS for t in turns):
        print(__doc__, file=sys.stderr)
        return 2
    env = dict(os.environ, CHIP_AB_TOOL=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py"))
    tagged = [(chr(ord("A") + i), tree) for i, tree in enumerate(trees)]
    for tag, tree in tagged + tagged[::-1]:
        for turn in turns:
            proc = subprocess.run([sys.executable, "-c", TURNS[turn]],
                                  cwd=tree, stdout=subprocess.PIPE, text=True,
                                  check=True, env=env)
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"turn": tag, "script": turn, "tree": tree,
                              **rec}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

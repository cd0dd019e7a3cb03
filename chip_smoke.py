#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`deepspeed_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 and
the CUDA toolkit.  It drives only the port — nothing of JAX or of
`deepspeed_tpu` is imported — in these phases, each printing JSON lines;
any failure raises and the script exits nonzero:

1. build: compile the three kernel libraries from the sources in the
   checkout, one nvcc each, started together; print ptxas's lines.
2. kernel: paged attention, the Hopper kernel against its plain PyTorch
   version on the same inputs on the card, at the serving shapes
   (GPT-2 XL heads H=25, Dh=64, block 16, table width 64; decode B=8
   T=1 and prefill B=1 T=128; fp32 and bf16 caches; one Dh=128 case;
   int8 and int4 caches at decode T=1, verify T=5 and prefill T=128 with
   bf16 q, verify and prefill with fp32 q, and verify at Dh=128), with
   device times of the kernel, the plain version, and
   `scaled_dot_product_attention` on pre-gathered (dequantized) K/V as a
   yardstick, and the host time of one call of each.
3. flash: the flash-attention forward, dQ and dK/dV kernels against
   their plain versions at the training shape (GPT-2 small: B=8,
   S=1024, H=12, Dh=64, causal) in bf16 and fp32, and on smaller cases:
   full attention with a key bias, dropout 0.1 with a nonzero bh_offset,
   Dh=128.  Errors against the per-element bounds of
   `kernels/flash.py` `kernel_tolerances`; device times beside the
   bound, the plain version, and SDPA forward and forward+backward as a
   yardstick the port never calls.
4. xent: the fused LM-head cross-entropy kernels (forward, dx, dW)
   against their plain versions at the training shape (N=8192 rows,
   D=768, V=50304, bf16, a fifth of the rows invalid, the tied head's
   transposed view), in fp32 at N=1024 (the train-exact shape), fp16 at
   N=2048 and at GPT-2 XL width D=1600 in bf16 and fp32; errors against
   the per-element bounds of `kernels/fused_xent.py` `kernel_tolerances`;
   device times beside the bound, the plain version and the forward's bf16 product
   alone (`torch.matmul`, a yardstick the port never calls).
5. exact: GPT-2 XL width, 4 layers, fp32 — greedy serving through the
   kernel path against the port's `generate()` (plain attention).
6. spec-exact: the same model, greedy speculative serving (draft_len 4)
   against non-speculative serving over int8 and int4 caches: identical
   streams.
7. serve: GPT-2 XL (48 layers) in bf16 serving 8 requests through
   `ServeEngine`, half submitted mid-flight; the kernel's launches are
   counted from zero over this run and must equal
   layers x (prefill chunks + decode steps).  Then its profile: the same
   traffic (same prompt lengths, fresh tokens, so no prefix-cache hit)
   again under `torch.profiler`: device time by kernel, and the device's
   idle share of the unprofiled run.
8. serve-spec: the same model over an int8 cache with draft_len 4, 8
   requests (half repetitive prompts, half random); the paged launches
   counted from zero equal layers x (prefill chunks + verify steps);
   tokens/s, decode step and accepted/drafted tokens; the same traffic
   replayed under `torch.profiler` (device time by kernel, idle share);
   the same traffic at draft_len 0; the host time of one layer's
   quantize-on-write against a dense scatter.
9. train-exact: GPT-2 small width (d768, 12 heads), 2 layers, seq 256,
   fp32, TF32 off: 5 engine steps through the flash kernels, then the
   same steps from the same weights on the dense plain attention path;
   per-step losses and final weights agree.  train-exact-pallas: the
   same with the fused CE kernels (`loss_impl="pallas"`) against the
   chunked plain CE.
10. train: GPT-2 small (12 layers, seq 1024, micro 8, bf16, Adam,
   WarmupLR, clipping 1.0) through `deepspeed_tpu_torch.initialize` on a
   learnable stride stream: warm-up steps, then timed steps with the
   launch counts reset just before (each flash kernel 12 x steps);
   tokens/s, step ms, peak memory; finite, falling losses; then 2 more
   steps under `torch.profiler`: device time by kernel class and the
   device's idle share of the timed steps.  train-pallas: the same with
   `loss_impl="pallas"` (each fused CE kernel once a step).
11. kernels: one line per kernel with its launches on its main path,
   its error against the plain version, and its times beside its bound.

The last line is `{"ok": true, "device": {...}}`.  Without a CUDA
device the script exits nonzero before printing any result.
"""

import gc
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,      # fp32 outside the tensor cores
              "bfloat16": 989e12, "float16": 989e12}
# kernel vs plain version: fp32 differs only in the order of fp32 sums;
# bf16 by the plain version's rounding of the probabilities before PV
# and each side's final rounding (kernels/paged.py `bf16_tolerance`)
# over an int8/int4 cache both dequantize exactly (a code times an fp16
# scale is exact in fp32) and stay fp32 throughout: fp32's bound
TOL = {"float32": "atol 1e-5",
       "bfloat16": "2^-6 |plain| + 1.01 * 2^-8 * (P |V|) + 1e-6",
       "int8": "atol 1e-5", "int4": "atol 1e-5"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def host_us(fn, iters=100):
    """Host time of one call of fn(), the device left to run behind:
    what a host-bound serving step pays per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return dt


def time_ms(fn, iters, flush):
    """Mean device time of fn() per call, with the L2 cache flushed
    before each call (the serving path reads each layer's cache cold).
    A spin kernel of about 1 ms keeps the device busy while the host
    enqueues fn()'s work, so the events time the device and not the
    host's Python between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


# -- phase 2: paged attention ---------------------------------------------------


def kernel_case(name, B, T, H, Dh, bs, W, dtype, q_start, gen, flush,
                kv="dense"):
    """The paged kernel against its plain version at one shape.  `dtype`
    is the dense cache's dtype, or q's (the model's) over an int8/int4
    cache (`kv`), whose rows are randn quantized by the row codec."""
    import torch

    from deepspeed_tpu_torch.kernels import paged, registry
    from deepspeed_tpu_torch.runtime.comm.quant import (dequantize_rows,
                                                        quantize_rows)
    from deepspeed_tpu_torch.serving.kv_cache import rows_for_tables

    num_blocks = 513
    dev = "cuda"

    def cache():
        c = torch.randn(num_blocks * bs, H, Dh, device=dev, generator=gen)
        return c.to(dtype) if kv == "dense" else quantize_rows(c, kv)

    ck, cv = cache(), cache()
    L = W * bs
    q_pos = (torch.as_tensor(q_start, device=dev)[:, None] +
             torch.arange(T, device=dev)[None, :]).clamp(max=L - 1)
    # scattered tables as the allocator hands them out: distinct blocks
    # per slot, the tail past the slot's live length padded with trash
    # block 0 (which the decode path passes in and must mask)
    tables = torch.zeros(B, W, dtype=torch.long, device=dev)
    for b in range(B):
        n_live = int(q_pos[b].max()) // bs + 1
        tables[b, :n_live] = torch.randperm(num_blocks - 1, device=dev,
                                            generator=gen)[:n_live] + 1
    rows = rows_for_tables(tables, bs)
    # q as the serving block hands it over: a view of the fused QKV
    # output in the model dtype (row stride 3 * H * Dh)
    qkv = torch.randn(B, T, 3 * H * Dh, device=dev, generator=gen).to(dtype)
    q = qkv[..., :H * Dh].view(B, T, H, Dh)

    def kernel():
        return registry.dispatch("paged_attention", q, ck, cv, rows, q_pos,
                                 impl="cuda", kv_mode=kv, block_size=bs)

    def plain():
        return registry.dispatch("paged_attention", q, ck, cv, rows, q_pos,
                                 impl="torch", kv_mode=kv, block_size=bs)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    dname = str(dtype).replace("torch.", "")
    tname = dname if kv == "dense" else kv
    if dtype == torch.float32 or kv != "dense":
        tol = torch.full_like(diff, 1e-5)
    else:
        tol = paged.bf16_tolerance(q, ck, cv, rows, q_pos, ref)
    err = diff.max().item()
    worst = (diff / tol).max().item()
    if not worst <= 1.0:
        raise AssertionError(f"{name}: kernel vs plain max abs err {err}, "
                             f"{worst} x the tolerance {TOL[tname]}")

    kernel_ms = time_ms(kernel, 50, flush)
    plain_ms = time_ms(plain, 20, flush)
    kernel_host_us = host_us(kernel)
    plain_host_us = host_us(plain, 20)
    # yardstick: one library call on K/V gathered (and dequantized)
    # beforehand, not timed, with the same absolute-position causal mask
    if kv == "dense":
        kd, vd = ck, cv
    else:
        kd, vd = (dequantize_rows(*c, kv).to(dtype) for c in (ck, cv))
    kg = kd[rows].permute(0, 2, 1, 3).contiguous()
    vg = vd[rows].permute(0, 2, 1, 3).contiguous()
    qh = q.permute(0, 2, 1, 3).contiguous()
    mask = (q_pos[:, :, None] >= torch.arange(L, device=dev))[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qh, kg, vg, attn_mask=mask), 50,
                         flush)
    del kd, vd, kg, vg

    live = (q_pos.max(dim=1).values + 1).clamp(max=L)        # keys per slot
    n_live = int(live.sum())
    # per live key and head: the K and V rows as stored (codes and an
    # fp16 scale when quantized)
    if kv == "dense":
        row_bytes = Dh * ck.element_size()
    else:
        row_bytes = (Dh if kv == "int8" else Dh // 2) + 2
    # q, positions, the row index of every live key, its K and V rows for
    # each head, and the output
    nbytes = (q.numel() * q.element_size() + q_pos.numel() * 8 +
              n_live * 8 + 2 * n_live * H * row_bytes +
              out.numel() * out.element_size())
    flops = 4 * H * Dh * int((q_pos + 1).clamp(max=L).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32" if kv != "dense" else dname] * 1e3
    rec = {"phase": "kernel", "case": name, "B": B, "T": T, "H": H,
           "Dh": Dh, "block_size": bs, "table_width": W, "dtype": dname,
           "kv": kv, "max_abs_err": err, "tol": TOL[tname],
           "max_err_over_tol": worst,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "kernel_host_us": kernel_host_us,
           "plain_host_us": plain_host_us,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "live_kv_bytes": 2 * n_live * H * row_bytes,
           "bytes": nbytes, "flops": flops}
    emit(rec)
    return rec


# -- phase 4: exact serving ----------------------------------------------------


def greedy_with_margins(model, prompt, n):
    """The port's generate() loop, step for step, also returning the
    top-2 logit margin of every step (the oracle's confidence)."""
    import torch

    from deepspeed_tpu_torch.models import generation as G

    L = model.config.max_seq_len
    caches = G._init_caches(model, 1, L, model.wte.dtype)
    toks = torch.as_tensor([prompt], device=model.device)
    logits = G._forward_cached(model, toks, caches, 0)
    out, margins = [], []
    for i in range(n):
        top2 = torch.topk(logits[0], 2).values
        margins.append(float(top2[0] - top2[1]))
        tok = torch.argmax(logits, dim=-1)
        out.append(int(tok))
        if i + 1 < n:
            logits = G._forward_cached(model, tok[:, None], caches,
                                       len(prompt) + i)
    return out, margins


def phase_exact():
    import torch

    from deepspeed_tpu_torch.models import GPT, generate, gpt2_config
    from deepspeed_tpu_torch.serving import ServeConfig, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt2_config("xl", num_layers=4, param_dtype=torch.float32)
    model = GPT(cfg, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(1))
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 50257, (n,)).tolist() for n in (37, 150, 7, 64)]
    n_new = 16
    eng = ServeEngine(model, ServeConfig(block_size=16, num_blocks=65,
                                         max_batch=4, prefill_chunk=128),
                      device="cuda")
    served = eng.generate(prompts, n_new)
    report = []
    with torch.no_grad():
        for p, got in zip(prompts, served):
            want = generate(model, [p], n_new, cache_len=cfg.max_seq_len,
                            device="cuda")[0].tolist()
            replay, margins = greedy_with_margins(model, p, n_new)
            if replay != want:
                raise AssertionError("generate() is not deterministic")
            div = next((i for i in range(n_new) if got[i] != want[i]), None)
            if div is not None and not margins[div] < 1e-4:
                raise AssertionError(
                    f"served stream diverges from generate() at step {div} "
                    f"where the oracle's top-2 margin is {margins[div]}")
            report.append({"prompt_len": len(p), "identical": div is None,
                           "first_divergence": div,
                           "margin_at_divergence": (None if div is None
                                                    else margins[div]),
                           "min_margin": min(margins)})
    emit({"phase": "exact", "config": "gpt2 xl width, 4 layers, fp32",
          "tokens_per_prompt": n_new, "prompts": report})
    del eng, model
    torch.cuda.empty_cache()


# -- phases 5-6: serving and its profile ------------------------------------


def drive(eng, prompts, n_new, late_at=6):
    """The phase-5 traffic: the first half of `prompts` submitted before
    the first step, the rest after `late_at` steps; steps until every
    request is done.  Returns the requests and, per step, its host time
    (ms, to the end of its device work) and whether it ran a prefill
    chunk."""
    import torch

    from deepspeed_tpu_torch.monitor.counters import COUNTERS

    def chunks():
        return COUNTERS.snapshot().get("serve.prefill_chunks", (0, 0))[0]

    half = len(prompts) // 2
    reqs = [eng.submit(p, n_new) for p in prompts[:half]]
    late = prompts[half:]
    steps = []
    while eng.has_work() or late:
        if late and len(steps) == late_at:
            reqs += [eng.submit(p, n_new) for p in late]
            late = []
        before = chunks()
        s0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        steps.append(((time.perf_counter() - s0) * 1e3, chunks() != before))
    return reqs, steps


def kernel_class(name):
    """Coarse class of a device activity, for the breakdown."""
    n = name.lower()
    if "paged_attention" in n:
        return "paged_attention"
    if any(k in n for k in ("gemm", "nvjet", "cutlass", "xmma")):
        return "gemm"
    if "memcpy" in n or "memset" in n:
        return "memcpy"
    for k in ("copy", "reduce", "elementwise", "index", "gather", "scatter"):
        if k in n:
            return k
    return "other"


def phase_serve():
    import torch

    from deepspeed_tpu_torch.kernels import paged
    from deepspeed_tpu_torch.models import GPT, gpt2_config
    from deepspeed_tpu_torch.monitor.counters import COUNTERS
    from deepspeed_tpu_torch.serving import (FINISHED, ServeConfig,
                                             ServeEngine)

    cfg = gpt2_config("xl", param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = GPT(cfg, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    scfg = ServeConfig(block_size=16, num_blocks=513, max_batch=8,
                       prefill_chunk=128)
    eng = ServeEngine(model, scfg, device="cuda")
    rs = np.random.RandomState(0)
    lens = rs.randint(16, 513, size=8)
    prompts = [rs.randint(0, 50257, (int(n),)).tolist() for n in lens]
    n_new = 64
    # warm-up request (allocator, cuBLAS handles), not measured; its
    # tokens share no block with the prompts, so it seeds no prefix hit
    eng.generate([list(range(50000, 50016))], 2)

    torch.cuda.reset_peak_memory_stats()
    paged.LAUNCHES = 0
    snap = COUNTERS.snapshot()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t_start = time.perf_counter()
    ev0.record()
    reqs, steps = drive(eng, prompts, n_new)
    ev1.record()
    ev1.synchronize()
    wall = time.perf_counter() - t_start
    span_ms = ev0.elapsed_time(ev1)       # the run on the device's clock
    launches = paged.LAUNCHES
    d = COUNTERS.delta_since(snap)

    if not all(r.state == FINISHED and len(r.out) == n_new for r in reqs):
        raise AssertionError(
            f"not every request finished: "
            f"{[(r.state, len(r.out)) for r in reqs]}")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.out):
        raise AssertionError("a served token is outside the vocabulary")
    chunks = d["serve.prefill_chunks"]["calls"]
    n_decode = d["serve.decode_steps"]["calls"]
    if launches != cfg.num_layers * (chunks + n_decode):
        raise AssertionError(
            f"paged kernel launched {launches} times, expected "
            f"{cfg.num_layers} x ({chunks} prefill chunks + {n_decode} "
            f"decode steps)")
    if d.get("kernel.fallbacks") or \
            d["kernel.dispatches"]["calls"] != launches:
        raise AssertionError(f"registry counts disagree with launches: {d}")
    if d.get("kv.prefix_hits"):
        raise AssertionError(f"the measured run hit the prefix cache: {d}")
    # batching invariance: request 0 served alone reproduces its tokens
    alone = eng.generate([prompts[0]], n_new)[0]
    if alone != reqs[0].out:
        raise AssertionError("request 0 served alone differs from its "
                             "tokens in the batch")
    decode_only = [ms for ms, pre in steps if not pre]
    with_prefill = [ms for ms, pre in steps if pre]
    ttft = sorted(r.ttft_s for r in reqs)
    n_tok = sum(len(r.out) for r in reqs)
    rec = {"phase": "serve", "config": "gpt2 xl, 48 layers, bf16 params "
           "and KV", "serve_config": {"block_size": 16, "num_blocks": 513,
                                      "max_batch": 8, "prefill_chunk": 128},
           "prompt_lens": [int(n) for n in lens], "max_new_tokens": n_new,
           "requests": len(reqs), "tokens": n_tok, "wall_s": wall,
           "device_span_ms": span_ms, "tokens_per_s": n_tok / wall,
           "ttft_p50_ms": float(np.median(ttft)) * 1e3,
           "ttft_max_ms": ttft[-1] * 1e3,
           "decode_step_mean_ms": float(np.mean(decode_only)),
           "decode_only_steps": len(decode_only),
           "prefill_step_mean_ms": float(np.mean(with_prefill)),
           "prefill_steps": len(with_prefill),
           "prefill_chunks": chunks, "decode_steps": n_decode,
           "paged_launches": launches,
           "kv_pool_bytes": eng.kv.nbytes(),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters()),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "model_init_s": init_s, "alone_equals_batched": True}
    emit(rec)
    return rec, eng


def profile_replay(eng, prompts, n_new, chunks, n_decode, span_ms, window):
    """A measured run's traffic again on `eng` under torch.profiler:
    `prompts` (the run's, or fresh ones of its lengths, so that no prefix
    is cached), `n_new` tokens each, submitted as `drive` submits them.
    The replay must run the measured schedule (`chunks` prefill chunks,
    `n_decode` decode or verify steps; asserted), so its device time by
    kernel is the measured run's; the idle share divides that busy time
    by the measured run's span on CUDA events (`span_ms`), which the
    profiler's host overhead does not stretch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.kernels import paged
    from deepspeed_tpu_torch.monitor.counters import COUNTERS

    launches0 = paged.LAUNCHES
    snap = COUNTERS.snapshot()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive(eng, prompts, n_new)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    d = COUNTERS.delta_since(snap)
    same = (d["serve.prefill_chunks"]["calls"] == chunks and
            d["serve.decode_steps"]["calls"] == n_decode and
            not d.get("kv.prefix_hits"))
    if not same:
        raise AssertionError(f"the profiled replay ran another schedule: "
                             f"{d}, measured {chunks} chunks and "
                             f"{n_decode} decode steps")
    acts = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(a[1] for a in acts)
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    by_class = {}
    for name, ms, n in acts:
        c = by_class.setdefault(kernel_class(name), [0.0, 0])
        c[0] += ms
        c[1] += n
    acts.sort(key=lambda a: -a[1])
    paged_ms, paged_calls = by_class.get("paged_attention", (0.0, 0))
    if paged_calls != paged.LAUNCHES - launches0:
        raise AssertionError(
            f"profiler saw {paged_calls} paged-attention kernels, the "
            f"wrapper launched {paged.LAUNCHES - launches0}")
    n_fwd = chunks + n_decode
    n_acts = sum(a[2] for a in acts)
    return {"phase": "profile", "window": window,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / span_ms,
            "measured_span_ms": span_ms,
            "profiled_wall_ms": wall_ms,
            "profiled_idle_share": 1.0 - busy_ms / wall_ms,
            "paged_attention_ms": paged_ms,
            "paged_attention_share_of_busy": paged_ms / busy_ms,
            "device_activities": n_acts,
            "forwards": n_fwd,
            "device_activities_per_forward": n_acts / n_fwd,
            "device_busy_ms_per_forward": busy_ms / n_fwd,
            "by_class": {k: {"ms": v[0], "calls": v[1],
                             "calls_per_forward": v[1] / n_fwd,
                             "share_of_busy": v[0] / busy_ms}
                         for k, v in sorted(by_class.items(),
                                            key=lambda kv: -kv[1][0])},
            "top_kernels": [{"name": a[0][:80], "ms": a[1], "calls": a[2]}
                            for a in acts[:10]]}


# -- speculative serving over a quantized cache ---------------------------------


def spec_prompts(rs, lens_rep, lens_rand, vocab=50257):
    """Half repetitive prompts (a random pattern of 5-24 tokens repeated to
    the length: the n-gram drafter's home turf), half random."""
    out = []
    for n in lens_rep:
        pat = rs.randint(0, vocab, (int(rs.randint(5, 25)),)).tolist()
        out.append((pat * (n // len(pat) + 1))[:n])
    out += [rs.randint(0, vocab, (int(n),)).tolist() for n in lens_rand]
    return out


def phase_spec_exact():
    """GPT-2 XL width, 4 layers, fp32, TF32 off: greedy speculative serving
    (draft_len 4) against non-speculative serving at int8 and at int4,
    token for token: every stream must be identical."""
    import torch

    from deepspeed_tpu_torch.models import GPT, gpt2_config
    from deepspeed_tpu_torch.monitor.counters import COUNTERS
    from deepspeed_tpu_torch.serving import ServeConfig, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt2_config("xl", num_layers=4, param_dtype=torch.float32)
    model = GPT(cfg, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(1))
    prompts = spec_prompts(np.random.RandomState(5), (60, 140), (37, 90))
    n_new = 24
    report = {}
    for kv in ("int8", "int4"):
        outs, counts = {}, {}
        for draft in (0, 4):
            scfg = ServeConfig(block_size=16, num_blocks=65, max_batch=4,
                               prefill_chunk=128, kv_dtype=kv,
                               draft_len=draft)
            snap = COUNTERS.snapshot()
            outs[draft] = ServeEngine(model, scfg, device="cuda").generate(
                prompts, n_new)
            d = COUNTERS.delta_since(snap)
            counts[draft] = {k: d.get(k, {"calls": 0})["calls"]
                             for k in ("serve.decode_steps",
                                       "serve.draft_tokens",
                                       "serve.accepted_tokens")}
        for p, want, got in zip(prompts, outs[0], outs[4]):
            if got != want:
                div = next(i for i in range(n_new) if got[i] != want[i])
                raise AssertionError(
                    f"spec-exact {kv}: the speculative stream of the "
                    f"{len(p)}-token prompt diverges from the "
                    f"non-speculative one at step {div}")
        if not counts[4]["serve.accepted_tokens"] > 0:
            raise AssertionError(f"spec-exact {kv}: no draft accepted")
        report[kv] = {"identical_streams": len(prompts),
                      "counts_non_spec": counts[0], "counts_spec": counts[4]}
    emit({"phase": "spec-exact", "config": "gpt2 xl width, 4 layers, fp32 "
          "params, TF32 off, draft_len 4, greedy", "prompt_lens":
          [len(p) for p in prompts], "tokens_per_prompt": n_new, **report})
    del model
    torch.cuda.empty_cache()


def phase_serve_spec(model):
    """GPT-2 XL (48 layers, bf16 weights, the phase-5 model) served over an
    int8 KV cache with draft_len 4: 8 requests, half repetitive, half
    random, half submitted mid-flight; the paged launches counted from
    zero over this run equal layers x (prefill chunks + verify steps).
    The same traffic is then replayed under torch.profiler on a fresh
    engine (so no prefix is cached), and served again at draft_len 0 for
    the non-speculative rate beside it.  Beside them, the host time of
    one layer's K or V write (quantize-on-write and scatter, at a verify
    step's 40 rows) against the dense bf16 cache's scatter."""
    import torch

    from deepspeed_tpu_torch.kernels import paged
    from deepspeed_tpu_torch.monitor.counters import COUNTERS
    from deepspeed_tpu_torch.serving import (FINISHED, ServeConfig,
                                             ServeEngine, programs)

    cfg = model.config
    rs = np.random.RandomState(6)
    prompts = spec_prompts(rs, rs.randint(64, 400, size=4),
                           rs.randint(16, 513, size=4))
    prompts = [prompts[i] for i in (0, 4, 1, 5, 2, 6, 3, 7)]  # mixed halves
    n_new = 64
    runs = {}
    profile = None

    def engine(draft):
        scfg = ServeConfig(block_size=16, num_blocks=513, max_batch=8,
                           prefill_chunk=128, kv_dtype="int8",
                           draft_len=draft)
        eng = ServeEngine(model, scfg, device="cuda")
        eng.generate([list(range(50000, 50016))], 2)       # warm-up
        torch.cuda.synchronize()
        return eng

    for draft in (4, 0):
        eng = engine(draft)
        paged.LAUNCHES = 0
        snap = COUNTERS.snapshot()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        reqs, steps = drive(eng, prompts, n_new)
        ev1.record()
        ev1.synchronize()
        wall = time.perf_counter() - t0
        launches = paged.LAUNCHES
        d = COUNTERS.delta_since(snap)
        if not all(r.state == FINISHED and len(r.out) == n_new
                   for r in reqs):
            raise AssertionError(
                f"serve-spec: not every request finished: "
                f"{[(r.state, len(r.out)) for r in reqs]}")
        chunks = d["serve.prefill_chunks"]["calls"]
        n_steps = d["serve.decode_steps"]["calls"]
        if launches != cfg.num_layers * (chunks + n_steps):
            raise AssertionError(
                f"serve-spec: paged kernel launched {launches} times, "
                f"expected {cfg.num_layers} x ({chunks} prefill chunks + "
                f"{n_steps} verify/decode steps)")
        if d.get("kernel.fallbacks") or \
                d["kernel.dispatches"]["calls"] != launches:
            raise AssertionError(f"serve-spec: registry counts disagree "
                                 f"with launches: {d}")
        decode_only = [ms for ms, pre in steps if not pre]
        n_tok = sum(len(r.out) for r in reqs)
        drafted = d.get("serve.draft_tokens", {"calls": 0})["calls"]
        accepted = d.get("serve.accepted_tokens", {"calls": 0})["calls"]
        deq = d.get("kv.dequant_ms", {"calls": 0, "bytes": 0})
        runs[draft] = {
            "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
            "device_span_ms": ev0.elapsed_time(ev1),
            "ttft_p50_ms": float(np.median([r.ttft_s for r in reqs])) * 1e3,
            "decode_step_mean_ms": float(np.mean(decode_only)),
            "decode_only_steps": len(decode_only),
            "prefill_chunks": chunks, "verify_or_decode_steps": n_steps,
            "draft_tokens": drafted, "accepted_tokens": accepted,
            "accepted_per_step": accepted / n_steps,
            "acceptance_rate": accepted / drafted if drafted else None,
            "dequant_dispatch_ms_mean": (deq["bytes"] / deq["calls"] / 1e3
                                         if deq["calls"] else None),
            "paged_launches": launches, "kv_pool_bytes": eng.kv.nbytes()}
        del eng
        torch.cuda.empty_cache()
        if draft == 4:
            eng = engine(4)
            profile = {**profile_replay(
                eng, prompts, n_new, chunks, n_steps,
                runs[4]["device_span_ms"], "serve-spec's traffic (int8 KV, "
                "draft_len 4) replayed on a fresh engine: lengths "
                f"{[len(p) for p in prompts]}, {n_new} new tokens each, "
                "gpt2 xl bf16"), "phase": "serve-spec-profile"}
            del eng
            torch.cuda.empty_cache()
    if not runs[4]["accepted_tokens"] > 0:
        raise AssertionError("serve-spec: no draft accepted")
    # one layer's K (or V) write at a verify step: 8 slots x 5 rows
    H, Dh, n_rows = cfg.num_heads, cfg.head_dim, 8 * 5
    val = torch.randn(n_rows, H, Dh, device="cuda").to(torch.bfloat16)
    idx = torch.arange(n_rows, device="cuda") * 3
    dense = torch.zeros(4 * n_rows, H, Dh, dtype=torch.bfloat16,
                        device="cuda")
    quant = (torch.zeros(4 * n_rows, H, Dh, dtype=torch.int8, device="cuda"),
             torch.zeros(4 * n_rows, H, dtype=torch.float16, device="cuda"))
    write_us = {"dense-bfloat16": host_us(
                    lambda: programs._kv_write(dense, idx, val)),
                "int8": host_us(
                    lambda: programs._kv_write(quant, idx, val, "int8"))}
    rec = {"phase": "serve-spec", "config": "gpt2 xl, 48 layers, bf16 "
           "params, int8 KV, draft_len 4", "serve_config": {
               "block_size": 16, "num_blocks": 513, "max_batch": 8,
               "prefill_chunk": 128, "kv_dtype": "int8"},
           "prompt_lens": [len(p) for p in prompts],
           "max_new_tokens": n_new, "spec": runs[4], "non_spec": runs[0],
           "kv_write_host_us_per_layer_and_tensor": write_us}
    emit(profile)
    emit(rec)
    return rec


# -- phase 3: flash attention kernels -------------------------------------------

FLASH_TOL = ("per element: 2u|plain| + (2u, forward and dQ only, + 1e-5) M "
             "+ 1e-6, u the dtype's unit roundoff (0 fp32, 2^-8 bf16), M "
             "the output's absolute-value product (kernels/flash.py "
             "kernel_tolerances)")


def flash_case(name, B, S, H, D, dtype, causal, bias, rate, bh_offset, gen,
               flush, timed):
    """The three flash kernels against their plain versions on one set of
    [B*H, S, D] inputs; device times where `timed`."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.kernels import flash, registry

    dev = "cuda"
    BH = B * H
    a = [torch.randn(BH, S, D, device=dev, generator=gen).to(dtype)
         for _ in range(4)]                      # q, k, v, dO
    kb = None
    if bias:
        keep = torch.rand(B, S, device=dev, generator=gen) > 0.25
        kb = torch.where(keep, 0.0, -1e30).float()
        kb[-1, S // 2:] = -1e30                  # a batch half masked
    opts = dict(causal=causal, scale=D ** -0.5, block_q=128, block_k=128,
                rate=rate, seed=1234, bh_offset=bh_offset, n_heads=H)

    def fwd(impl):
        return registry.dispatch("flash_attention_fwd", *a[:3], kb,
                                 impl=impl, **opts)

    ref = {}
    out, lse = fwd("torch")
    ref["out"] = out
    delta = (a[3].float() * out.float()).sum(-1)
    bwd_args = (*a, lse, delta, kb)

    def dq(impl):
        return registry.dispatch("flash_attention_dq", *bwd_args, impl=impl,
                                 **opts)

    def dkv(impl):
        return registry.dispatch("flash_attention_dkv", *bwd_args,
                                 impl=impl, **opts)

    ref["dq"] = dq("torch")
    ref["dk"], ref["dv"] = dkv("torch")
    got = {}
    got["out"], got_lse = fwd("cuda")
    got["dq"] = dq("cuda")
    got["dk"], got["dv"] = dkv("cuda")
    torch.cuda.synchronize()
    tols = flash.kernel_tolerances(*a, kb, ref, **opts)
    errs, worst = {}, {}
    for k, tol in tols.items():
        diff = (got[k].float() - ref[k].float()).abs()
        errs[k] = diff.max().item()
        worst[k] = (diff / tol).max().item()
        if not worst[k] <= 1.0:
            raise AssertionError(f"flash {name} {k}: kernel vs plain max abs "
                                 f"err {errs[k]}, {worst[k]} x the bound")
    lse_err = (got_lse - lse).abs().max().item()
    if not lse_err <= 1e-5 * (1 + lse.abs().max().item()):
        raise AssertionError(f"flash {name}: lse differs by {lse_err}")
    del tols, got

    dname = str(dtype).replace("torch.", "")
    isz = a[0].element_size()
    pairs = (S * (S + 1) // 2) if causal else S * S   # live (q, k) pairs
    io = BH * S * D * isz                              # one [BH, S, D]
    rows = BH * S * 4                                  # one fp32 [BH, S]
    kb_bytes = 0 if kb is None else kb.numel() * 4
    # bytes: each input read once, each output written once
    work = {"flash_attention_fwd": (4 * D * BH * pairs,
                                    4 * io + rows + kb_bytes),
            "flash_attention_dq": (6 * D * BH * pairs,
                                   5 * io + 2 * rows + kb_bytes),
            "flash_attention_dkv": (8 * D * BH * pairs,
                                    6 * io + 2 * rows + kb_bytes)}
    rec = {"phase": "flash", "case": name, "B": B, "S": S, "H": H, "Dh": D,
           "dtype": dname, "causal": causal, "key_bias": bias,
           "dropout": rate, "bh_offset": bh_offset, "tol": FLASH_TOL,
           "max_abs_err": errs, "max_err_over_tol": worst,
           "lse_max_abs_err": lse_err, "kernels": {}}
    fns = {"flash_attention_fwd": fwd, "flash_attention_dq": dq,
           "flash_attention_dkv": dkv}
    for kname, (flops, nbytes) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dname] * 1e3
        k = {"flops": flops, "bytes": nbytes,
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        if timed:
            fn = fns[kname]
            k["kernel_ms"] = time_ms(lambda: fn("cuda"), 10, flush)
            k["plain_ms"] = time_ms(lambda: fn("torch"), 3, flush)
        rec["kernels"][kname] = k
    if timed and rate == 0.0:
        # yardstick: SDPA on the same tensors viewed [B, H, S, D]
        q4, k4, v4, do4 = (t.view(B, H, S, D) for t in a)
        mask = None if kb is None else kb[:, None, None, :].to(dtype)
        causal_flag = causal and mask is None
        if causal and mask is not None:
            tri = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
            mask = mask.masked_fill(~tri, float("-inf"))

        def sdpa():
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                                  is_causal=causal_flag)

        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                               is_causal=causal_flag)
            o.backward(do4)

        rec["sdpa_fwd_ms"] = time_ms(sdpa, 10, flush)
        rec["sdpa_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd, 10, flush)
        rec["kernels"]["flash_attention_fwd"]["library_ms"] = \
            rec["sdpa_fwd_ms"]
    emit(rec)
    del a, ref, out, lse, delta
    torch.cuda.empty_cache()
    return rec


def phase_flash(gen, flush):
    import torch

    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [flash_case("train-bfloat16", 8, 1024, 12, 64, bf16, True, False,
                        0.0, 0, gen, flush, True),
             flash_case("train-float32", 8, 1024, 12, 64, fp32, True, False,
                        0.0, 0, gen, flush, True),
             flash_case("full-keybias-bfloat16", 2, 512, 4, 64, bf16, False,
                        True, 0.0, 0, gen, flush, False),
             flash_case("dropout-offset-bfloat16", 2, 512, 4, 64, bf16, True,
                        False, 0.1, 7, gen, flush, False),
             flash_case("dh128-bfloat16", 2, 512, 4, 128, bf16, True, False,
                        0.0, 0, gen, flush, False)]
    return cases


# -- fused LM-head cross-entropy kernels ----------------------------------------

XENT_TOL = ("per element (kernels/fused_xent.py kernel_tolerances): lse, ll "
            "1e-5 A (+2^-22 |lse|), A the logits' |x|.|w|; dx, dW 2u|plain| "
            "+ (u + 1e-4) M (+ 2^-25 |g| S + 2^-24 for fp16), u the dtype's unit "
            "roundoff (0 fp32, 2^-8 bf16, 2^-11 fp16), M the gradient "
            "product's absolute value |g| |dl'|.|B|")


def xent_case(name, N, D, V, dtype, gen, flush, timed):
    """The three fused-CE kernels against their plain versions on one set
    of inputs, the head the tied embedding's transposed view, a fifth of
    the rows invalid; device times where `timed`."""
    import torch

    from deepspeed_tpu_torch.kernels import fused_xent, registry

    dev = "cuda"
    x = torch.randn(N, D, device=dev, generator=gen).to(dtype)
    emb = (0.02 * torch.randn(V, D, device=dev, generator=gen)).to(dtype)
    w = emb.t()                                # [D, V], strides (1, D)
    labels = torch.randint(0, V, (N,), device=dev, generator=gen)
    valid = torch.rand(N, device=dev, generator=gen) >= 0.2
    g = torch.tensor(1.0 / float(valid.sum()), device=dev)
    opts = dict(block_rows=256 if N % 256 == 0 else 128,
                block_v=next(b for b in (512, 448, 384, 256, 128)
                             if V % b == 0))

    def fwd(impl):
        return registry.dispatch("fused_xent_fwd", x, w, labels, impl=impl,
                                 **opts)

    ref = dict(zip(("lse", "ll"), fwd("torch")))
    lse = ref["lse"]                   # each comparison holds one kernel

    def dx(impl):
        return registry.dispatch("fused_xent_dx", x, w, labels, lse, valid,
                                 g, impl=impl, **opts)

    def dw(impl):
        return registry.dispatch("fused_xent_dw", x, w, labels, lse, valid,
                                 g, impl=impl, **opts)

    ref["dx"], ref["dw"] = dx("torch"), dw("torch")
    got = dict(zip(("lse", "ll"), fwd("cuda")))
    got["dx"], got["dw"] = dx("cuda"), dw("cuda")
    torch.cuda.synchronize()
    tols = fused_xent.kernel_tolerances(x, w, labels, valid, g, ref)
    errs, worst = {}, {}
    for k, tol in tols.items():
        diff = (got[k].float() - ref[k].float()).abs()
        errs[k] = diff.max().item()
        worst[k] = (diff / tol).max().item()
        if not worst[k] <= 1.0:
            raise AssertionError(f"fused xent {name} {k}: kernel vs plain "
                                 f"max abs err {errs[k]}, {worst[k]} x the "
                                 f"bound")
    del tols, got, ref

    dname = str(dtype).replace("torch.", "")
    isz = x.element_size()
    prod = 2 * N * D * V                       # one product's operations
    xb, wb, nb = N * D * isz, V * D * isz, N * (8 + 4)  # labels, lse
    # bytes: each input read once, each output written once
    work = {"fused_xent_fwd": (prod, xb + wb + N * 8 + 2 * N * 4),
            "fused_xent_dx": (2 * prod, xb + wb + nb + N + xb),
            "fused_xent_dw": (2 * prod, xb + wb + nb + N + wb)}
    rec = {"phase": "xent", "case": name, "N": N, "D": D, "V": V,
           "dtype": dname, "head": "tied (wte.t() view)",
           "invalid_rows": int((~valid).sum()), "tol": XENT_TOL,
           "max_abs_err": errs, "max_err_over_tol": worst, "kernels": {}}
    fns = {"fused_xent_fwd": fwd, "fused_xent_dx": dx, "fused_xent_dw": dw}
    for kname, (flops, nbytes) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dname] * 1e3
        k = {"flops": flops, "bytes": nbytes,
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        if timed:
            fn = fns[kname]
            k["kernel_ms"] = time_ms(lambda: fn("cuda"), 5, flush)
            k["plain_ms"] = time_ms(lambda: fn("torch"), 2, flush)
        rec["kernels"][kname] = k
    if timed:
        # yardstick the port never calls: the forward's product alone
        rec["matmul_ms"] = time_ms(lambda: x @ w, 5, flush)
    emit(rec)
    del x, emb, w
    torch.cuda.empty_cache()
    return rec


def phase_xent(gen, flush):
    import torch

    return [xent_case("train-bfloat16", 8192, 768, 50304, torch.bfloat16,
                      gen, flush, True),
            xent_case("train-exact-float32", 1024, 768, 50304,
                      torch.float32, gen, flush, True),
            xent_case("float16", 2048, 768, 50304, torch.float16, gen, flush,
                      True),
            xent_case("xl-width-bfloat16", 1024, 1600, 50304,
                      torch.bfloat16, gen, flush, True),
            xent_case("xl-width-float32", 1024, 1600, 50304, torch.float32,
                      gen, flush, True)]


# -- phases 7-9: training ----------------------------------------------------------


def stride_batches(steps, micro, seq, vocab, seed):
    """The learnable stream of tests/convergence_common.py
    `synthetic_batches` (copied, this script imports no test code): next
    token = (prev + stride) % vocab, a stride in {1..4} per sequence."""
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        toks = np.zeros((micro, seq + 1), np.int64)
        toks[:, 0] = rng.randint(0, vocab, micro)
        stride = rng.randint(1, 5, micro)
        for t in range(1, seq + 1):
            toks[:, t] = (toks[:, t - 1] + stride) % vocab
        yield toks[:, :-1], toks[:, 1:]


def train_config(micro, lr, precision):
    cfg = {"train_batch_size": micro, "train_micro_batch_size_per_gpu": micro,
           "optimizer": {"type": "Adam", "params": {"lr": lr}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_max_lr": lr,
                                    "warmup_num_steps": 10}},
           "gradient_clipping": 1.0, "steps_per_print": 0}
    if precision == "bf16":
        cfg["bf16"] = {"enabled": True}
    return cfg


def train_exact(name, variants, counted):
    """fp32, TF32 off: 5 engine steps of GPT-2 small width (2 layers, seq
    256, micro 4) from the same weights for each of `variants` (config
    overrides; the first is the kernel path, the second its plain
    reference).  `counted`: the kernel launch counts (a LAUNCHES dict and
    its keys) that must be exactly `per_step` a step in the first run and
    0 in the second.  Bounds: the two differ in the order of fp32 sums
    only, so per-step losses within 1e-4; an Adam step moves a weight by
    at most about lr, so after 5 steps the weights differ by at most
    2 * lr * 5."""
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import GPT, gpt2_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr, steps, micro, seq = 1e-4, 5, 4, 256
    launches, keys, per_step = counted
    runs = []
    for over in variants:
        cfg = gpt2_config("small", num_layers=2, max_seq_len=seq, **over)
        model = GPT(cfg, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
        eng, *_ = dt.initialize(model=model,
                                config_params=train_config(micro, lr, "fp32"))
        n0 = {k: launches[k] for k in keys}
        losses = []
        for x, y in stride_batches(steps, micro, seq, 64, 5):
            losses.append(float(eng.forward((x, y))))
            eng.backward()
            eng.step()
        runs.append((losses, {n: p.detach().clone()
                              for n, p in eng.params.items()},
                     {k: launches[k] - n0[k] for k in keys}))
        del eng, model
    (lk, pk, nk), (lp, pp, npl) = runs
    if nk != {k: per_step * steps for k in keys} or any(npl.values()):
        raise AssertionError(f"{name}: kernels launched {nk} (kernel run) "
                             f"and {npl} (plain run) times")
    loss_err = max(abs(a - b) for a, b in zip(lk, lp))
    w_err = max((pk[n] - pp[n]).abs().max().item() for n in pk)
    if not (loss_err <= 1e-4 and w_err <= 2 * lr * steps):
        raise AssertionError(f"{name}: losses differ by {loss_err}, "
                             f"weights by {w_err}")
    emit({"phase": name, "config": "gpt2 small width, 2 layers, seq 256, "
          "micro 4, fp32, TF32 off", "kernel_run": variants[0],
          "plain_run": variants[1], "steps": steps,
          "launches_kernel_run": nk,
          "losses_kernel": lk, "losses_plain": lp,
          "max_loss_diff": loss_err, "loss_tol": 1e-4,
          "max_weight_diff": w_err, "weight_tol": 2 * lr * steps})
    torch.cuda.empty_cache()


def phase_train_exact():
    """The flash-kernel path against the dense plain attention path."""
    from deepspeed_tpu_torch.kernels import flash

    train_exact("train-exact", [{"attn_impl": "auto"}, {"attn_impl": "xla"}],
                (flash.LAUNCHES, ["flash_attention_fwd"], 2))


def phase_train_exact_pallas():
    """The fused-CE kernels (loss_impl "pallas") against the chunked plain
    CE ("auto"), both through the flash kernels."""
    from deepspeed_tpu_torch.kernels import fused_xent

    train_exact("train-exact-pallas",
                [{"loss_impl": "pallas"}, {"loss_impl": "auto"}],
                (fused_xent.LAUNCHES, list(fused_xent.LAUNCHES), 1))


def train_kernel_class(name):
    """Coarse class of a training-step device activity."""
    n = name.lower()
    if "flash_" in n:
        return "flash_attention"
    if "fx_fwd_kernel" in n or "fx_bwd_kernel" in n:
        return "fused_xent"
    if "foreach" in n or "multi_tensor" in n:
        return "optimizer"
    if any(k in n for k in ("gemm", "nvjet", "cutlass", "xmma", "sm90_")):
        return "gemm"
    if "memcpy" in n or "memset" in n or "copy" in n:
        return "copy"
    if "reduce" in n or "softmax" in n or "norm" in n:
        return "reduction"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    return "other"


def phase_train(warmup=3, steps=10, loss_impl="auto"):
    """`loss_impl` "auto": the chunked plain fp32 CE; "pallas": the fused
    CE kernels, one launch of each a step."""
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.kernels import flash, fused_xent
    from deepspeed_tpu_torch.models import GPT, gpt2_config
    from deepspeed_tpu_torch.monitor.counters import COUNTERS

    micro, seq = 8, 1024
    cfg = gpt2_config("small", loss_impl=loss_impl)
    fused = loss_impl == "pallas"
    model = GPT(cfg, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(0))
    eng, *_ = dt.initialize(model=model,
                            config_params=train_config(micro, 1e-4, "bf16"))
    # the convergence recipe's stream: tokens below 64 (CONFIG["vocab"]
    # of tests/convergence_common.py) in the full 50304-token model, so the
    # loss has a signal to fall on within a dozen steps at lr 1e-4
    data = stride_batches(warmup + steps + 2, micro, seq, 64, 0)
    losses = [float(eng.train_batch(data)) for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counts in (flash.LAUNCHES, fused_xent.LAUNCHES):
        for k in counts:
            counts[k] = 0
    snap = COUNTERS.snapshot()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    step_ms = []
    timed = []
    ev0.record()
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = eng.train_batch(data)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        timed.append(loss)
    ev1.record()
    ev1.synchronize()
    span_ms = ev0.elapsed_time(ev1)
    launches = dict(flash.LAUNCHES)
    xent_launches = dict(fused_xent.LAUNCHES)
    d = COUNTERS.delta_since(snap)
    losses += [float(x) for x in timed]
    if launches != {k: cfg.num_layers * steps for k in launches}:
        raise AssertionError(f"flash launches {launches}, expected "
                             f"{cfg.num_layers} x {steps} each")
    if xent_launches != {k: steps if fused else 0 for k in xent_launches}:
        raise AssertionError(f"fused CE launches {xent_launches} over "
                             f"{steps} steps with loss_impl={loss_impl!r}")
    n_kernel_calls = 3 * cfg.num_layers * steps + (3 * steps if fused else 0)
    if d.get("kernel.fallbacks") or \
            d["kernel.dispatches"]["calls"] != n_kernel_calls:
        raise AssertionError(f"a plain version ran on the training path: {d}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    tokens = micro * seq * steps
    rec = {"phase": "train-pallas" if fused else "train",
           "config": "gpt2 small (12 layers, d768, 12 "
           "heads, vocab 50304), seq 1024, micro 8, gas 1, bf16, Adam lr "
           "1e-4, WarmupLR 10 steps, clipping 1.0; stride stream over "
           f"tokens < 64; loss_impl {loss_impl}", "warmup_steps": warmup,
           "timed_steps": steps, "tokens_per_s": tokens / (sum(step_ms) / 1e3),
           "step_ms_mean": float(np.mean(step_ms)),
           "step_ms_min": float(np.min(step_ms)),
           "device_span_ms": span_ms,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "param_count": sum(p.numel() for p in eng.params.values()),
           "first_loss": losses[0], "last_loss": losses[-1],
           "losses": losses, "flash_launches": launches,
           "fused_xent_launches": xent_launches}
    emit(rec)
    return rec, eng, data


def phase_train_profile(eng, data, train, steps=2):
    """Two more steps under torch.profiler: device time by kernel class;
    the idle share divides the busy time per step by the timed steps'
    mean span on CUDA events, which the profiler does not stretch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.kernels import flash, fused_xent

    n0 = dict(flash.LAUNCHES)
    x0 = dict(fused_xent.LAUNCHES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.train_batch(data)
        torch.cuda.synchronize()
    acts = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(a[1] for a in acts)
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    by_class = {}
    for name, ms, n in acts:
        c = by_class.setdefault(train_kernel_class(name), [0.0, 0])
        c[0] += ms
        c[1] += n
    flash_calls = by_class.get("flash_attention", (0.0, 0))[1]
    want = sum(flash.LAUNCHES[k] - n0[k] for k in n0)
    if flash_calls != want:
        raise AssertionError(f"profiler saw {flash_calls} flash kernels, "
                             f"the wrappers launched {want}")
    xent_calls = by_class.get("fused_xent", (0.0, 0))[1]
    want = sum(fused_xent.LAUNCHES[k] - x0[k] for k in x0)
    if xent_calls != want:
        raise AssertionError(f"profiler saw {xent_calls} fused CE kernels, "
                             f"the wrappers launched {want}")
    acts.sort(key=lambda a: -a[1])
    per_step = busy_ms / steps
    span_per_step = train["device_span_ms"] / train["timed_steps"]
    return {"phase": train["phase"] + "-profile", "steps": steps,
            "device_busy_ms_per_step": per_step,
            "device_idle_share": 1.0 - per_step / span_per_step,
            "timed_span_ms_per_step": span_per_step,
            "by_class": {k: {"ms_per_step": v[0] / steps,
                             "calls_per_step": v[1] / steps,
                             "share_of_busy": v[0] / busy_ms}
                         for k, v in sorted(by_class.items(),
                                            key=lambda kv: -kv[1][0])},
            "top_kernels": [{"name": a[0][:80], "ms_per_step": a[1] / steps,
                             "calls_per_step": a[2] / steps}
                            for a in acts[:12]]}


def build_all():
    """Compile the kernel libraries, one nvcc per source, all started
    together; returns the build record."""
    from deepspeed_tpu_torch.kernels import build

    sources = ("paged_attention.cu", "flash_attention.cu", "fused_xent.cu")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.build, sources))
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "ptxas": {src: [ln.strip() for ln in
                            build.BUILD_LOGS.get(src, "").splitlines()
                            if "registers" in ln or "Compiling entry" in ln
                            or "spill" in ln]
                      for src in sources}}


def flash_entries(flash_cases, train):
    main = flash_cases[0]            # the training shape, bf16
    out = []
    for name in ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv"):
        k = main["kernels"][name]
        short = name.split("_")[-1]
        out.append({
            "name": name, "route": "cuda",
            "source": "deepspeed_tpu_torch/kernels/csrc/flash_attention.cu",
            "replaces": {"fwd": "deepspeed_tpu/ops/transformer/"
                                "flash_attention.py:113",
                         "dq": "deepspeed_tpu/ops/transformer/"
                               "flash_attention.py:227",
                         "dkv": "deepspeed_tpu/ops/transformer/"
                                "flash_attention.py:280"}[short],
            "launches": train["flash_launches"][name],
            "max_abs_err": main["max_abs_err"][
                {"fwd": "out", "dq": "dq", "dkv": "dk"}[short]],
            "ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k.get("library_ms"),
            "shape": "B=8 S=1024 H=12 Dh=64 bf16 causal",
            "cases": [{"case": c["case"],
                       "max_err_over_tol": c["max_err_over_tol"],
                       **({"kernel_ms": c["kernels"][name]["kernel_ms"],
                           "plain_ms": c["kernels"][name]["plain_ms"],
                           "bound_ms": c["kernels"][name]["bound_ms"]}
                          if "kernel_ms" in c["kernels"][name] else {})}
                      for c in flash_cases]})
    if "sdpa_fwd_bwd_ms" in main:
        out[0]["sdpa_fwd_bwd_ms"] = main["sdpa_fwd_bwd_ms"]
    return out


def xent_entries(xent_cases, train_pallas):
    main = xent_cases[0]             # the training shape, bf16
    out = []
    for name, line, err in (("fused_xent_fwd", 52, "lse"),
                            ("fused_xent_dx", 127, "dx"),
                            ("fused_xent_dw", 145, "dw")):
        k = main["kernels"][name]
        out.append({
            "name": name, "route": "cuda",
            "source": "deepspeed_tpu_torch/kernels/csrc/fused_xent.cu",
            "replaces": f"deepspeed_tpu/ops/transformer/fused_xent.py:{line}",
            "launches": train_pallas["fused_xent_launches"][name],
            "max_abs_err": main["max_abs_err"][err],
            "ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            # no one PyTorch call computes the fused CE; the forward's bf16
            # product alone is the yardstick beside it
            "library_ms": None, "matmul_ms": main["matmul_ms"],
            "shape": "N=8192 D=768 V=50304 bf16, tied head",
            "cases": [{"case": c["case"],
                       "max_err_over_tol": c["max_err_over_tol"],
                       "kernel_ms": c["kernels"][name]["kernel_ms"],
                       "plain_ms": c["kernels"][name]["plain_ms"],
                       "bound_ms": c["kernels"][name]["bound_ms"]}
                      for c in xent_cases]})
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import deepspeed_tpu_torch  # noqa: F401  (fails in a bare directory)

    t_start = time.perf_counter()
    seconds = {}

    def mark(name):
        seconds[name] = time.perf_counter() - t_start - sum(seconds.values())

    card = gpu_name_and_limit()
    emit({**build_all(), "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    mark("build")

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    rng = np.random.RandomState(0)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        cases.append(kernel_case(f"decode-{dn}", 8, 1, 25, 64, 16, 64, dtype,
                                 rng.randint(256, 768, size=8), gen, flush))
        cases.append(kernel_case(f"prefill-{dn}", 1, 128, 25, 64, 16, 64,
                                 dtype, [448], gen, flush))
    cases.append(kernel_case("decode-bfloat16-dh128", 8, 1, 16, 128, 16, 64,
                             torch.bfloat16, rng.randint(256, 768, size=8),
                             gen, flush))
    mark("paged")
    flash_cases = phase_flash(gen, flush)
    mark("flash")
    # the quantized branches at the speculative serving shapes: decode
    # (T = 1), verify (T = draft_len + 1 = 5) and a prefill chunk (T = 128)
    # with q in bf16 (serve-spec's model), verify and prefill with q in
    # fp32 (spec-exact's), verify at Dh 128 (after the flash phase, whose
    # inputs the generator's earlier draws set)
    for kv in ("int8", "int4"):
        for T in (1, 5):
            cases.append(kernel_case(
                f"{'decode' if T == 1 else 'verify'}-{kv}", 8, T, 25, 64, 16,
                64, torch.bfloat16, rng.randint(256, 768, size=8), gen,
                flush, kv=kv))
        cases.append(kernel_case(f"prefill-{kv}", 1, 128, 25, 64, 16, 64,
                                 torch.bfloat16, [448], gen, flush, kv=kv))
        cases.append(kernel_case(f"verify-{kv}-float32", 4, 5, 25, 64, 16,
                                 64, torch.float32,
                                 rng.randint(32, 256, size=4), gen, flush,
                                 kv=kv))
        cases.append(kernel_case(f"prefill-{kv}-float32", 1, 128, 25, 64, 16,
                                 64, torch.float32, [128], gen, flush, kv=kv))
        cases.append(kernel_case(f"verify-{kv}-dh128", 8, 5, 16, 128, 16, 64,
                                 torch.bfloat16,
                                 rng.randint(256, 768, size=8), gen, flush,
                                 kv=kv))
    mark("paged-quantized")
    xent_cases = phase_xent(gen, flush)
    mark("xent")
    del flush

    phase_exact()
    mark("exact")
    phase_spec_exact()
    mark("spec-exact")
    serve, eng = phase_serve()
    rs = np.random.RandomState(1)   # fresh tokens: no prefix-cache hit
    emit(profile_replay(
        eng, [rs.randint(0, 50257, (n,)).tolist() for n in
              serve["prompt_lens"]], serve["max_new_tokens"],
        serve["prefill_chunks"], serve["decode_steps"],
        serve["device_span_ms"], "phase 5's traffic replayed on fresh "
        f"prompts: lengths {serve['prompt_lens']}, "
        f"{serve['max_new_tokens']} new tokens each, gpt2 xl bf16"))
    mark("serve")
    serve_spec = phase_serve_spec(eng.model)
    mark("serve-spec")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    phase_train_exact()
    phase_train_exact_pallas()
    mark("train-exact")
    train, teng, data = phase_train()
    emit(phase_train_profile(teng, data, train))
    # free the first engine (its objects hold reference cycles) before the
    # second run's peak memory is taken
    del teng, data
    gc.collect()
    torch.cuda.empty_cache()
    mark("train")
    train_pallas, teng, data = phase_train(loss_impl="pallas")
    emit(phase_train_profile(teng, data, train_pallas))
    del teng, data
    mark("train-pallas")
    emit({"phase": "seconds", **seconds})

    main_case = next(c for c in cases if c["case"] == "decode-bfloat16")
    print(card, flush=True)
    emit({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "deepspeed_tpu_torch/kernels/csrc/paged_attention.cu",
        "replaces": "deepspeed_tpu/kernels/paged.py:127",
        "launches": serve["paged_launches"] +
        serve_spec["spec"]["paged_launches"],
        "launches_by_path": {"serve (dense bf16 KV)": serve["paged_launches"],
                             "serve-spec (int8 KV, draft 4)":
                             serve_spec["spec"]["paged_launches"]},
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": "decode B=8 T=1 H=25 Dh=64 bf16, table 64 x 16",
        "cases": [{k: c[k] for k in ("case", "kv", "max_abs_err", "tol",
                                     "max_err_over_tol", "kernel_ms",
                                     "plain_ms", "library_ms", "bound_ms",
                                     "bound_by", "kernel_host_us")}
                  for c in cases]}] + flash_entries(flash_cases, train) +
        xent_entries(xent_cases, train_pallas)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

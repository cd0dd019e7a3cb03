#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`deepspeed_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 and
the CUDA toolkit.  It drives only the port — nothing of JAX or of
`deepspeed_tpu` is imported — in these phases, each printing JSON lines;
any failure raises and the script exits nonzero:

1. build: compile both kernel libraries from the sources in the
   checkout, one nvcc each, started together; print ptxas's lines.
2. kernel: paged attention, the Hopper kernel against its plain PyTorch
   version on the same inputs on the card, at the serving shapes
   (GPT-2 XL heads H=25, Dh=64, block 16, table width 64; decode B=8
   T=1 and prefill B=1 T=128; fp32 and bf16 caches; one Dh=128 case),
   with device times of the kernel, the plain version, and
   `scaled_dot_product_attention` on pre-gathered K/V as a yardstick,
   and the host time of one call of each.
3. flash: the flash-attention forward, dQ and dK/dV kernels against
   their plain versions at the training shape (GPT-2 small: B=8,
   S=1024, H=12, Dh=64, causal) in bf16 and fp32, and on smaller cases:
   full attention with a key bias, dropout 0.1 with a nonzero bh_offset,
   Dh=128.  Errors against the per-element bounds of
   `kernels/flash.py` `kernel_tolerances`; device times beside the
   bound, the plain version, and SDPA forward and forward+backward as a
   yardstick the port never calls.
4. exact: GPT-2 XL width, 4 layers, fp32 — greedy serving through the
   kernel path against the port's `generate()` (plain attention).
5. serve: GPT-2 XL (48 layers) in bf16 serving 8 requests through
   `ServeEngine`, half submitted mid-flight; the kernel's launches are
   counted from zero over this run and must equal
   layers x (prefill chunks + decode steps).
6. profile: the same traffic (same prompt lengths, fresh tokens, so no
   prefix-cache hit) again under `torch.profiler`: device time by
   kernel, and the device's idle share of the unprofiled run.
7. train-exact: GPT-2 small width (d768, 12 heads), 2 layers, seq 256,
   fp32, TF32 off: 5 engine steps through the flash kernels, then the
   same steps from the same weights on the dense plain attention path;
   per-step losses and final weights agree.
8. train: GPT-2 small (12 layers, seq 1024, micro 8, bf16, Adam,
   WarmupLR, clipping 1.0) through `deepspeed_tpu_torch.initialize` on a
   learnable stride stream: warm-up steps, then timed steps with the
   flash launch counts reset just before (each must be 12 x steps);
   tokens/s, step ms, peak memory; finite, falling losses.
9. train profile: 2 more steps under `torch.profiler`: device time by
   kernel class and the device's idle share of the timed steps.
10. kernels: one line per kernel with its launches on its main path,
   its error against the plain version, and its times beside its bound.

The last line is `{"ok": true, "device": {...}}`.  Without a CUDA
device the script exits nonzero before printing any result.
"""

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
TOL = {"float32": "atol 1e-5",
       "bfloat16": "2^-6 |plain| + 1.01 * 2^-8 * (P |V|) + 1e-6"}


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


def kernel_case(name, B, T, H, Dh, bs, W, dtype, q_start, gen, flush):
    import torch

    from deepspeed_tpu_torch.kernels import paged, registry
    from deepspeed_tpu_torch.serving.kv_cache import rows_for_tables

    num_blocks = 513
    dev = "cuda"
    ck = torch.randn(num_blocks * bs, H, Dh, device=dev, generator=gen
                     ).to(dtype)
    cv = torch.randn(num_blocks * bs, H, Dh, device=dev, generator=gen
                     ).to(dtype)
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
    # output in the cache dtype (row stride 3 * H * Dh)
    qkv = torch.randn(B, T, 3 * H * Dh, device=dev, generator=gen).to(dtype)
    q = qkv[..., :H * Dh].view(B, T, H, Dh)

    def kernel():
        return registry.dispatch("paged_attention", q, ck, cv, rows, q_pos,
                                 impl="cuda", block_size=bs)

    def plain():
        return registry.dispatch("paged_attention", q, ck, cv, rows, q_pos,
                                 impl="torch", block_size=bs)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    dname = str(dtype).replace("torch.", "")
    if dtype == torch.float32:
        tol = torch.full_like(diff, 1e-5)
    else:
        tol = paged.bf16_tolerance(q, ck, cv, rows, q_pos, ref)
    err = diff.max().item()
    worst = (diff / tol).max().item()
    if not worst <= 1.0:
        raise AssertionError(f"{name}: kernel vs plain max abs err {err}, "
                             f"{worst} x the tolerance {TOL[dname]}")

    kernel_ms = time_ms(kernel, 50, flush)
    plain_ms = time_ms(plain, 20, flush)
    kernel_host_us = host_us(kernel)
    plain_host_us = host_us(plain, 20)
    # yardstick: one library call on K/V gathered beforehand (the gather
    # is not timed), with the same absolute-position causal mask
    kg = ck[rows].permute(0, 2, 1, 3).contiguous()
    vg = cv[rows].permute(0, 2, 1, 3).contiguous()
    qh = q.permute(0, 2, 1, 3).contiguous()
    mask = (q_pos[:, :, None] >= torch.arange(L, device=dev))[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qh, kg, vg, attn_mask=mask), 50,
                         flush)

    live = (q_pos.max(dim=1).values + 1).clamp(max=L)        # keys per slot
    isz = ck.element_size()
    # q, positions, the row index of every live key, its K and V rows
    # for each head, and the output
    nbytes = (q.numel() * q.element_size() + q_pos.numel() * 8 +
              int(live.sum()) * 8 + 2 * int(live.sum()) * H * Dh * isz +
              out.numel() * isz)
    flops = 4 * H * Dh * int((q_pos + 1).clamp(max=L).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    rec = {"phase": "kernel", "case": name, "B": B, "T": T, "H": H,
           "Dh": Dh, "block_size": bs, "table_width": W, "dtype": dname,
           "max_abs_err": err, "tol": TOL[dname], "max_err_over_tol": worst,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "kernel_host_us": kernel_host_us,
           "plain_host_us": plain_host_us,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "live_kv_bytes": 2 * int(live.sum()) * H * Dh * isz,
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


def profile_replay(eng, serve):
    """Phase 5's traffic (`serve`, its record) again on `eng` — the
    same prompt lengths, fresh tokens (no prefix-cache hit), the same
    submission order — under torch.profiler.  The replay runs the same
    schedule (asserted), so its device time by kernel is the measured
    run's; the idle share divides that busy time by the measured run's
    span on CUDA events, which the profiler's host overhead does not
    stretch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.kernels import paged
    from deepspeed_tpu_torch.monitor.counters import COUNTERS

    lens, n_new = serve["prompt_lens"], serve["max_new_tokens"]
    chunks, n_decode = serve["prefill_chunks"], serve["decode_steps"]
    span_ms = serve["device_span_ms"]
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, 50257, (int(n),)).tolist() for n in lens]
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
    return {"phase": "profile",
            "window": "phase 5's traffic replayed on fresh prompts: "
                      f"lengths {[int(n) for n in lens]}, {n_new} new "
                      "tokens each, gpt2 xl bf16",
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / span_ms,
            "measured_span_ms": span_ms,
            "profiled_wall_ms": wall_ms,
            "profiled_idle_share": 1.0 - busy_ms / wall_ms,
            "paged_attention_ms": paged_ms,
            "paged_attention_share_of_busy": paged_ms / busy_ms,
            "device_activities": sum(a[2] for a in acts),
            "by_class": {k: {"ms": v[0], "calls": v[1],
                             "share_of_busy": v[0] / busy_ms}
                         for k, v in sorted(by_class.items(),
                                            key=lambda kv: -kv[1][0])},
            "top_kernels": [{"name": a[0][:80], "ms": a[1], "calls": a[2]}
                            for a in acts[:10]]}


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


def phase_train_exact():
    """fp32, TF32 off: the flash-kernel path against the dense plain
    attention path (attn_impl "xla") from the same weights, 5 steps.
    Bounds: the two differ in the order of fp32 sums only, so per-step
    losses within 1e-4; an Adam step moves a weight by at most about lr,
    so after 5 steps the weights differ by at most 2 * lr * 5."""
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.kernels import flash
    from deepspeed_tpu_torch.models import GPT, gpt2_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr, steps, micro, seq = 1e-4, 5, 4, 256
    runs = {}
    for impl in ("auto", "xla"):
        cfg = gpt2_config("small", num_layers=2, max_seq_len=seq,
                          attn_impl=impl)
        model = GPT(cfg, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
        eng, *_ = dt.initialize(model=model,
                                config_params=train_config(micro, lr, "fp32"))
        n0 = flash.LAUNCHES["flash_attention_fwd"]
        losses = []
        for x, y in stride_batches(steps, micro, seq, 64, 5):
            losses.append(float(eng.forward((x, y))))
            eng.backward()
            eng.step()
        runs[impl] = (losses, {n: p.detach().clone()
                               for n, p in eng.params.items()},
                      flash.LAUNCHES["flash_attention_fwd"] - n0)
        del eng, model
    (lk, pk, nk), (lp, pp, npl) = runs["auto"], runs["xla"]
    if nk != 2 * steps or npl != 0:
        raise AssertionError(f"train-exact: flash forward launched {nk} "
                             f"(kernel run) and {npl} (plain run) times")
    loss_err = max(abs(a - b) for a, b in zip(lk, lp))
    w_err = max((pk[n] - pp[n]).abs().max().item() for n in pk)
    if not (loss_err <= 1e-4 and w_err <= 2 * lr * steps):
        raise AssertionError(f"train-exact: losses differ by {loss_err}, "
                             f"weights by {w_err}")
    emit({"phase": "train-exact", "config": "gpt2 small width, 2 layers, "
          "seq 256, micro 4, fp32, TF32 off", "steps": steps,
          "losses_kernel": lk, "losses_plain": lp,
          "max_loss_diff": loss_err, "loss_tol": 1e-4,
          "max_weight_diff": w_err, "weight_tol": 2 * lr * steps})
    torch.cuda.empty_cache()


def train_kernel_class(name):
    """Coarse class of a training-step device activity."""
    n = name.lower()
    if "flash_" in n:
        return "flash_attention"
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


def phase_train(warmup=3, steps=10):
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.kernels import flash
    from deepspeed_tpu_torch.models import GPT, gpt2_config
    from deepspeed_tpu_torch.monitor.counters import COUNTERS

    micro, seq = 8, 1024
    cfg = gpt2_config("small")
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
    for k in flash.LAUNCHES:
        flash.LAUNCHES[k] = 0
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
    d = COUNTERS.delta_since(snap)
    losses += [float(x) for x in timed]
    if launches != {k: cfg.num_layers * steps for k in launches}:
        raise AssertionError(f"flash launches {launches}, expected "
                             f"{cfg.num_layers} x {steps} each")
    if d.get("kernel.fallbacks") or \
            d["kernel.dispatches"]["calls"] != 3 * cfg.num_layers * steps:
        raise AssertionError(f"a plain version ran on the training path: {d}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    tokens = micro * seq * steps
    rec = {"phase": "train", "config": "gpt2 small (12 layers, d768, 12 "
           "heads, vocab 50304), seq 1024, micro 8, gas 1, bf16, Adam lr "
           "1e-4, WarmupLR 10 steps, clipping 1.0; stride stream over "
           "tokens < 64", "warmup_steps": warmup,
           "timed_steps": steps, "tokens_per_s": tokens / (sum(step_ms) / 1e3),
           "step_ms_mean": float(np.mean(step_ms)),
           "step_ms_min": float(np.min(step_ms)),
           "device_span_ms": span_ms,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "param_count": sum(p.numel() for p in eng.params.values()),
           "first_loss": losses[0], "last_loss": losses[-1],
           "losses": losses, "flash_launches": launches}
    emit(rec)
    return rec, eng, data


def phase_train_profile(eng, data, train, steps=2):
    """Two more steps under torch.profiler: device time by kernel class;
    the idle share divides the busy time per step by the timed steps'
    mean span on CUDA events, which the profiler does not stretch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.kernels import flash

    n0 = dict(flash.LAUNCHES)
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
    acts.sort(key=lambda a: -a[1])
    per_step = busy_ms / steps
    span_per_step = train["device_span_ms"] / train["timed_steps"]
    return {"phase": "train-profile", "steps": steps,
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

    sources = ("paged_attention.cu", "flash_attention.cu")
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import deepspeed_tpu_torch  # noqa: F401  (fails in a bare directory)

    card = gpu_name_and_limit()
    emit({**build_all(), "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})

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
    flash_cases = phase_flash(gen, flush)
    del flush

    phase_exact()
    serve, eng = phase_serve()
    emit(profile_replay(eng, serve))
    del eng
    torch.cuda.empty_cache()

    phase_train_exact()
    train, teng, data = phase_train()
    emit(phase_train_profile(teng, data, train))
    del teng

    main_case = next(c for c in cases if c["case"] == "decode-bfloat16")
    print(card, flush=True)
    emit({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "deepspeed_tpu_torch/kernels/csrc/paged_attention.cu",
        "replaces": "deepspeed_tpu/kernels/paged.py:127",
        "launches": serve["paged_launches"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": "decode B=8 T=1 H=25 Dh=64 bf16, table 64 x 16",
        "cases": [{k: c[k] for k in ("case", "max_abs_err", "tol",
                                     "max_err_over_tol", "kernel_ms",
                                     "plain_ms", "library_ms", "bound_ms",
                                     "bound_by", "kernel_host_us")}
                  for c in cases]}] + flash_entries(flash_cases, train)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`deepspeed_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 and
the CUDA toolkit.  It drives only the port — nothing of JAX or of
`deepspeed_tpu` is imported — in six phases, each printing one JSON
line; any failure raises and the script exits nonzero:

1. build: compile the kernel library from the sources in the checkout.
2. kernel: paged attention, the Hopper kernel against its plain PyTorch
   version on the same inputs on the card, at the serving shapes
   (GPT-2 XL heads H=25, Dh=64, block 16, table width 64; decode B=8
   T=1 and prefill B=1 T=128; fp32 and bf16 caches; one Dh=128 case),
   with device times of the kernel, the plain version, and
   `scaled_dot_product_attention` on pre-gathered K/V as a yardstick,
   and the host time of one call of each.
3. exact: GPT-2 XL width, 4 layers, fp32 — greedy serving through the
   kernel path against the port's `generate()` (plain attention).
4. serve: GPT-2 XL (48 layers) in bf16 serving 8 requests through
   `ServeEngine`, half submitted mid-flight; the kernel's launches are
   counted from zero over this run and must equal
   layers x (prefill chunks + decode steps).
5. profile: the same traffic (same prompt lengths, fresh tokens, so no
   prefix-cache hit) again under `torch.profiler`: device time by
   kernel, and the device's idle share of the unprofiled run.
6. kernels: one line per kernel with its launches on the main path,
   its error against the plain version, and its times beside its bound.

The last line is `{"ok": true, "device": {...}}`.  Without a CUDA
device the script exits nonzero before printing any result.
"""

import json
import os
import subprocess
import sys
import time

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


# -- phase 2 -----------------------------------------------------------------


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


# -- phase 3 -----------------------------------------------------------------


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


# -- phase 4 -----------------------------------------------------------------


def drive(eng, prompts, n_new, late_at=6):
    """The phase-4 traffic: the first half of `prompts` submitted before
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
    """Phase 4's traffic (`serve`, its record) again on `eng` — the
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
            "window": "phase 4's traffic replayed on fresh prompts: "
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deepspeed_tpu_torch.kernels import build

    card = gpu_name_and_limit()
    t0 = time.perf_counter()
    build.build("paged_attention.cu")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in
             build.BUILD_LOGS.get("paged_attention.cu", "").splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": build_s, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": ptxas})

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
    del flush

    phase_exact()
    serve, eng = phase_serve()
    emit(profile_replay(eng, serve))
    del eng

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
                  for c in cases]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

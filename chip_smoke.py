#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`deepspeed_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 and
the CUDA toolkit.  It drives only the port — nothing of JAX or of
`deepspeed_tpu` is imported — in these phases, each printing JSON lines;
any failure raises and the script exits nonzero:

1. build: compile the nine kernel libraries from the sources in the
   checkout (paged attention as one library per cache kind), one nvcc
   each, and the host ops (the CPU Adam and the aio engine, one g++
   each), all started together; print ptxas's lines, the host compiler
   and whether io_uring is allowed.
2. kernel: paged attention, the Hopper kernel against its plain PyTorch
   version on the same inputs on the card, at the serving shapes
   (GPT-2 XL heads H=25, Dh=64, block 16, table width 64; decode B=8
   T=1 and prefill B=1 T=128; fp32 and bf16 caches; one Dh=128 case;
   int8 and int4 caches at decode T=1, verify T=5 and prefill T=128 with
   bf16 q, verify and prefill with fp32 q, and verify at Dh=128; the
   head_dim-generic instantiations at Dh 16 (GPT-2 nano, H=3) and Dh 256
   (H=8), dense, int8 and int4, decode and prefill, q bf16 and fp32, and
   at Dh 20, 100 (every cache kind) and the odd Dh 33 (dense, int8), q
   bf16, decode and prefill; above 1024 columns at Dh 1032 (bf16 decode)
   and 2048 (fp32 verify), one slot over a 4096-key table, and the
   tensor-core prefill in fp16 at Dh 128 from a position mid-block), each
   with its route (split keys, or tensor cores for a dense bf16/fp16
   prefill chunk at Dh 64/128) and key splits, the decode main case's
   device operations a call under torch.profiler (the kernel alone), with
   device times of the kernel, the plain version, and
   `scaled_dot_product_attention` on pre-gathered (dequantized) K/V as a
   yardstick, and the host time of one call of each.
3. flash: the flash-attention forward, dQ and dK/dV kernels against
   their plain versions at the training shape (GPT-2 small: B=8,
   S=1024, H=12, Dh=64, causal) in bf16 and fp32, and on smaller cases:
   full attention with a key bias, dropout 0.1 with a nonzero bh_offset,
   Dh=128 (timed), train-moe's S=2048 shape (B=4, H=12, timed), Dh=256
   (B=2, S=1024, H=4 bf16 timed; fp16 with a key bias, dropout 0.2 and
   bh_offset 7; fp32).  Errors against the per-element bounds of
   `kernels/flash.py` `kernel_tolerances`, each case naming dQ's and
   dK/dV's routes (`flash.dq_route`, `dkv_route`); device times beside
   the bound, the plain version, and SDPA forward, forward+backward and
   backward alone (one autograd.grad: dQ, dK and dV together, the joint
   library time of #2 and #3) as a yardstick the port never calls.  Then
   the training shape on three more draws and fp16 cases (Dh 128 with a
   key bias and dropout, from fresh draws and from
   tests/test_torch_flash.py's inputs; the training shape, timed: fp16 dQ
   on wgmma, dK/dV on the CUDA cores), each with its worst dQ element:
   both sides' values, the plain version's fp32 value before rounding,
   the ulp, the bound with and without dp's error term; on the fp16
   repeat cases both sides against dQ's plain version in float64, over
   the bound.
3b. sparse: the block-sparse flash forward, dQ and dK/dV kernels (#7-#9)
   against their plain versions at the BERT training shape (B=2, S=4096,
   H=16, Dh=64, the sparse-attention tutorial's fixed layout at block 128:
   11 active blocks a row) in bf16 (timed), with dropout 0.1, in fp32 and
   fp16; a BigBird block-64 layout with dropout, a unidirectional fixed
   layout under the causal mask, block 16 at Dh 128 in fp16 with causal
   dropout, a layout with an empty row and an empty column (fp32, and bf16
   causal with dropout), the training shape at block 256 with dropout
   (timed beside block 128 with dropout), block 192 (fp32) and block 160
   (16-row tiles; bf16, causal, dropout), Dh 128 at block 128 (fp16,
   causal, dropout: the wgmma dQ at Dh 128), Dh 256 at block 128 (bf16
   with dropout, fp32), each record naming the forward's and dQ's routes
   (the wgmma kernels at Dh 64 / 128 and blocks a multiple of 64); errors
   against
   the per-element bounds of
   `kernels/flash_sparse.py` `kernel_tolerances`, the worst dQ element;
   device times beside the bound, the plain versions, SDPA with the layout
   as a boolean mask (its forward, and without dropout its backward: the
   joint library time of #8 and #9) and the dense flash kernels at the
   same shape.  The
   mask probe (one live key per output element) holds the dropout masks
   element by element in three dtypes, at block 16 and at block 256 (Dh
   256), at block 64 (Dh 64, the wgmma dK/dV's transposed hash
   coordinates and the one-consumer wgmma forward) and at block 128 (Dh
   128, the two-consumer wgmma forward); the wgmma dK/dV's empty row and
   column (block 64, causal, dropout); sparse-repeat computes the forward,
   dQ and dK/dV 50 times after other kernels, on the fp16 16-row-tile
   case, on the wgmma forward's, dQ's and dK/dV's (bf16, Dh 64, block 128)
   and on the wgmma forward and dQ at Dh 128 (fp16, causal), and requires
   bitwise equal results.
4. xent: the fused LM-head cross-entropy kernels (forward, dx, dW)
   against their plain versions at the training shape (N=8192 rows,
   D=768, V=50304, bf16, a fifth of the rows invalid, the tied head's
   transposed view), in fp32 at N=1024 (the train-exact shape), fp16 at
   N=2048, at GPT-2 XL width D=1600 in bf16 and fp32, at widths off
   the 64-column tile and past 1600 (nano's D=48, 2048, 2560), and at a
   ragged N=1000 with GPT-2's real vocab V=50257 in fp16 (the forward's,
   dx's and dW's wgmma routes, named in each record with their issued
   FLOPs by design; the forward's at every bf16/fp16 width here);
   errors against the per-element bounds of `kernels/fused_xent.py`
   `kernel_tolerances`; device times beside the bound, the plain version
   and the forward's bf16 product alone (cuBLAS `x @ W`, the bare
   product, a yardstick the port never calls).  xent-repeat computes the
   forward, dx and dW on their wgmma routes 50 times after other kernels,
   at the training shape and the ragged fp16 one, and requires bitwise
   equal results.
4b. codec: the blockwise quantize and dequantize kernels (#11, #12)
   bitwise against their plain versions on the codec's edge cases (fp32
   subnormals, +-inf, NaN, an all-zero block, fp16 scale overflow and
   underflow, ties, a ragged tail), int8 and int4, fp32 and bf16 input,
   blocks 256, 64 and 512 (the quantize's vector route) and 2 (its
   generic route).
4c. moe-kernels: the MoE dispatch and combine kernels (#13, #14) against
   their plain versions (dispatch bitwise, combine within
   `moe/dispatch.py` `combine_tolerance`) at the training shape (B 4,
   S 2048, E 64, C 32, D 768, bf16) at top-1 and top-2, two small cases,
   top-4, and capacity factor 0.25 (whole tokens dropped: exact zeros);
   device times (on events, and kernel-only under torch.profiler)
   beside the bound, the plain version and one
   PyTorch call the port never makes as a yardstick: `torch.index_select`
   for the dispatch, `F.embedding_bag` with per-sample weights for the
   combine (held to the combine's bound first); the dispatch's device
   operations a call under torch.profiler (one kernel, no memset); the
   device time of the combine's gate gradient (plain PyTorch).  The
   dropless overflow pass's shape (`moe_overflow_case`): train-moe's
   top-1 routing at capacity 32 skewed toward 4 experts, the overflow
   bucket at factor 1.0 as one group of 8192 tokens over one expert of
   8192 slots in expert-grouped order: #13 bitwise and #14 within its
   bound, kernel-only times beside the bound, the plain version and
   index_select.
5. exact: GPT-2 XL width, 4 layers, fp32 — greedy serving through the
   kernel path against the port's `generate()` (plain attention).
   serve-nano-exact: GPT-2 nano (Dh 16), fp32 weights, 4 requests of 16
   new tokens through the paged kernel: over a bf16 cache equal to
   `generate()` with a bf16 cache, over an int8 cache equal to the same
   engine with the paged attention forced to its plain version.
6. spec-exact: the same model, greedy speculative serving (draft_len 4)
   against non-speculative serving over int8 and int4 caches: identical
   streams.  serve-qw-exact: the same width, serving from int8 and int4
   blockwise weights against the port's `generate()` on
   dequantize(quantize(w)).
7. serve: GPT-2 XL (48 layers) in bf16 serving 8 requests through
   `ServeEngine`, half submitted mid-flight; the kernel's launches are
   counted from zero over this run and must equal
   layers x (prefill chunks + decode steps), and are recorded by step
   kind and by route.  Then its profile: the same
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
8b. serve-qw: the same model from int8 blockwise weights
   (`quantized_weights="int8"`): #11 and #12 bitwise against their plain
   versions on every matrix leaf (int8 and int4) and timed per leaf
   shape; phase 7's schedule and prompt lengths (fresh tokens); the
   build's quantize launches (one a leaf) and the run's dequantize
   launches (leaves x forwards) counted from zero; tokens/s, TTFT, decode
   step, resident weight bytes; the traffic replayed under
   `torch.profiler` (idle share, #12's device time a forward).
8c. the fleet and the chaos lane.  fleet-exact: phase 6's nano model
   (fp32, TF32 off), two replicas from build_fleet behind
   FleetRouter.start() (a ServeWorker thread each), its four prompts and
   two two-turn sessions submitted from the main thread; every greedy
   stream equals generate(), a session's second turn lands on its first
   turn's replica and prefills only its new tokens, the paged launches
   (all from the two worker threads) are layers x (chunks + decode
   steps); run with both workers on the default stream, then with a
   stream each.  serve-fleet: phase 7's GPT-2 XL, two replicas sharing
   the model (phase 7's ServeConfig each), phase 7's 8 prompts and 4
   two-turn sessions submitted while the workers run, a TraceRecorder
   and a ServingSLO on each replica: every request finishes in the
   vocabulary, launches exact over both replicas, sessions stay home,
   each SLO's nearest-rank TTFT p50 / p99 equal its requests', the
   traces' decode_step and first_token counts equal the counters';
   tokens/s, TTFT p50 / p99, the decode span, peak memory and the pools'
   bytes, the idle share of a short profiled burst; a burst at
   queue_limit 2 (spills and sheds); then the same with a CUDA stream a
   replica, with both replicas stepped in turn on the main thread, and
   through one replica.
   serve-chaos: one XL replica (max_batch 2) on a ServeWorker, a
   FaultPlan hanging the third decode call 1.5 s, a 0.5 s StepWatchdog
   whose on_trip sheds: one trip, the wedged batch shed with its blocks
   evicted, the waiting requests' tokens equal to each served alone, the
   trip file and snapshot (trace tail, the serving thread group).
9. train-exact: GPT-2 small width (d768, 12 heads), 2 layers, seq 256,
   fp32, TF32 off: 5 engine steps through the flash kernels, then the
   same steps from the same weights on the dense plain attention path;
   per-step losses and final weights agree.  train-exact-pallas: the
   same with the fused CE kernels (`loss_impl="pallas"`) against the
   chunked plain CE.  moe-exact: the same width with 64 experts on
   layer 1 of 2, `comm.moe.dispatch="sorted"`: the MoE kernels against
   their plain versions (loss within 1e-4 a step, weights within
   2 lr steps) and against the dense one-hot engine (loss within 1e-5).
   moe-dropless-exact: the dropless MoE layer at train-moe's width (d768,
   d_ff 3072, 64 experts), B 2, S 128, capacity factor 0.25, fp32, TF32
   off, top-1 and top-2: output and gradients (input, gate, experts)
   through #13/#14 on the card against its plain CPU version and against
   the loose-capacity oracle (1e-4 of the largest value); nothing dropped
   at overflow factor 1.0, and at 0.05 exactly B·k·S minus the two
   buckets' kept assignments; #13/#14 4 launches a call, 2 of them on
   the overflow bucket.
10. train: GPT-2 small (12 layers, seq 1024, micro 8, bf16, Adam,
   WarmupLR, clipping 1.0) through `deepspeed_tpu_torch.initialize` on a
   learnable stride stream: warm-up steps, then timed steps with the
   launch counts reset just before (each flash kernel 12 x steps);
   tokens/s, step ms, peak memory; finite, falling losses; then 2 more
   steps under `torch.profiler`: device time by kernel class and the
   device's idle share of the timed steps.  train-pallas: the same with
   `loss_impl="pallas"` (each fused CE kernel once a step).  train-moe:
   DeepSpeed-MoE's 125M+MoE-64 recipe (12 layers, d768, 64 experts on
   every other layer, top-1, capacity factor 1.0), seq 2048, micro 4,
   bf16, the fused CE, sorted dispatch: #13 and #14 launched twice a step
   per MoE layer (forward, and each other's gradient in the backward),
   tokens/s, step, peak memory, dropped share, then its profile.
   train-resume (between train-pallas and train-moe): train-pallas's
   model trained from `initialize(training_data=...)` (24 stride-stream
   sequences, 3 shuffled batches an epoch) by `train_batch()` with no
   iterator; a sync save after step 4, an async save after step 6, 2 more
   steps; a fresh engine loads the first tag (input pipeline off) and
   runs 4 steps, another loads `latest` and runs 2: losses, the batches'
   bytes and the fp32 masters bitwise equal to the run that never
   stopped, each run's flash and fused-CE launches counted from zero
   (12 and 1 a step); tag bytes, save stalls, load ms, the host's input
   wait and step ms with the pipeline on and off.
   dp-exact (after train-pallas): GPT-2 nano, fp32, TF32 off, 4 steps,
   data parallel at world 1 over NCCL (a `file://` store in a temp
   directory): ZeRO 0/1/2 x implicit / bucketed x the fp32 / split wires
   against the single-process engine from the same weights and batches
   (loss 1e-4 a step; masters 1e-6 on the fp32 wire, steps x lr on the
   split wire).  train-dp: train-pallas's model (seq 1024, micro 8, bf16,
   fused CE) on that process group at ZeRO-2 with the bucketed fp32 wire:
   step ms, tokens/s and peak memory beside train-pallas's, the
   `bucket.*` / `grad_wire.reduce` bytes equal to the plan's
   `wire_nbytes` a step, each flash kernel 12 and each fused-CE kernel 1
   a step; then two ranks on the one card over gloo: a probe of each
   collective the path calls on CUDA tensors (the record names the first
   that refuses), and where all run, world 2 (spawned, micro 4 each, the
   same global batches) held to world 1's losses (3e-3 relative) with
   each rank holding half of the optimizer state.  train-moe-dropless
   (after train-moe): the same recipe with `comm.moe.dropless` at
   overflow factor 1.0, 2 + 6 steps: nothing dropped at any step, #13
   and #14 launched 4 x 6 layers a step (half on the overflow bucket),
   step ms, tokens/s and peak memory beside train-moe's.
10a. The quantized and expert-parallel wires (two or four ranks on the
   one card run over gloo, which stages every collective through host
   memory: their times are gloo's, not a wire's).  qgz-exact (after
   train-dp): GPT-2 nano, fp32, the bucketed int8 and int4 wires (block
   256) at ZeRO 0 and 2: at world 1 over NCCL each reduced bucket bitwise
   the plain CPU codec's, at world 2 each rank's bitwise the numpy fp32
   sum of both ranks' dequantized contributions / 2; #11 and #12 once a
   bucket a reduction.  train-dp-qgz: train-dp with `wire_dtype` int8:
   step ms, tokens/s and peak memory beside train-dp's fp32 wire, the
   `bucket.all_gather` bytes equal to `wire_nbytes`, #11 / #12 once a
   step and timed at the bucket's shape; world 2 (gloo, micro 4 each)
   within 2% of train-dp's world-2 losses.  moe-wire-exact (after
   train-moe-dropless): a small MoE GPT (4 layers, d256, 8 experts,
   top-2), fp32, TF32 off, ZeRO-1, against world 1 (the local dispatch):
   world 2 through the fp32 (1e-5 relative on losses and clipping
   norms), bf16, int8 and int4 wires (2e-2 / 5e-2 / 0.5 on the losses),
   world 4 (outer 2 x inner 2) through fp32 under placement data and
   inner and int8 under data; the a2a counters equal to the plan's bytes,
   #11-#14 launches counted.  train-moe-ep: train-moe's model at full
   width, global batch 4, ZeRO-1, two ranks (32 experts each) through the
   int8 then the fp32 wire, each from the same init against world 1 on
   the same batches (2% and 1e-3 relative); step ms, tokens/s, peak
   memory a rank, #11-#14 a step, the a2a bytes, and #11 / #12 timed at
   one hop's shape.
10b. ZeRO stage 3 (two ranks on the one card over gloo).  z3-exact
   (after train-moe-ep): GPT-2 nano, seq 64, deterministic algorithms,
   TF32 off: stage 3 (each block gathered for its forward and again for
   its backward) bitwise stage 2 on the implicit wire in losses, norms
   and masters, fp32 and bf16; qwZ int8 and int4 (bf16, block 256):
   every gathered replica bitwise the plain CPU codec's round trip of
   both ranks' slices, the losses and masters inside
   tests/test_comm_quant.py's `_assert_tracks` envelope of the
   unquantized stage 3, `qwz.gather` the plan's bytes a pass and #11 /
   #12 once a gather group a pass, two passes a micro step.  train-z3:
   GPT-2 XL at full width, seq 1024, micro 1 a rank, bf16, the fused CE:
   stage 2 (1 + 1 steps), then stage 3 with qwZ int8 (1 + 2 steps):
   peak memory a rank (stage 3 below stage 2), step ms, `qwz.gather`
   bytes a step, #1-#6 and #11 / #12 launches, stage-3 losses within 2%
   of stage 2's; #11 / #12 timed at a block's fused slice shape.
10c. bert-sparse-exact: BERT-large width (d1024, 16 heads), 2 layers,
   seq 1024, fixed layout block 128, fp32, TF32 off: 5 engine steps with
   dropout 0.1 through #7-#9 against the same steps with their plain
   versions forced, and at dropout 0 the kernel walk against the gather
   path (`block_sparse_attention`); per-step loss within 1e-4, weights
   within 2 lr steps.  train-bert-sparse: BERT-large (24 layers) MLM + NSP
   pretraining at seq 4096, micro 2, bf16, Adam, WarmupLR, clipping 1.0,
   dropout 0.1, no attention mask, the fixed layout at block 128, the
   position table extended to 4096 rows; each of #7-#9 launched exactly
   24 x steps over the timed steps, tokens/s, step, peak memory, finite
   and falling losses, then its profile.
10d. ZeRO-Offload and ZeRO-Infinity (after train-z3).  offload-exact:
   GPT nano's depth (3 layers) at Dh 64, fp32, TF32 off, deterministic
   algorithms: the offload engine (host Adam) against the port's ZeRO-0
   engine (losses 1e-4 relative, masters 5e-3 relative + 1e-5), the
   NVMe-moments run bitwise the RAM run, and the card's host step
   (pinned, overlapped copies) bitwise the synchronous numpy step at one
   GPT-2 XL block's leaves (bf16 weights, clip 1.0, one step skipped for
   an inf).  infinity-exact: the streamed engine against the resident one
   on the same model (the same bounds, eval too), params_on_nvme with the
   moments on NVMe bitwise the RAM run, gas 2, and #1 2L, #2 / #3 L, #4-#6
   once a micro step exactly.  train-offload-infinity: GPT-2 XL at full
   width, seq 1024, micro 1, bf16, fused CE, 1 + 2 steps each at ZeRO-0,
   Offload (stage 0, offload_optimizer cpu) and Infinity (stage 3,
   offload_param cpu) from the same init: device peak (falling in that
   order), step ms split into device busy, D2H, host Adam and H2D, host
   memory held and pinned, #1-#6 launches, losses within 2% of ZeRO-0's.
   train-infinity-nvme: XL widths cut to 4 layers, masters and moments on
   NVMe in a temporary directory: bytes read and written a step and the
   aio engine that ran.
11. kernels: one line per kernel with its launches on its main path,
   its error against the plain version, its times beside its bound, and
   per family the head dims (blocks, dtypes) this run launched.

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
# Once a process has profiled a lot, torch.profiler drops the first kernel
# records of each new window, more the longer the process has profiled
# (none at first, tens late in this script's run), so a window's
# own first launches would go missing from its device time and its launch
# counts.  Every window therefore starts with this many throwaway launches
# of one small kernel for it to lose (`prime_profiler`), and grows the
# number to four times the largest loss it has seen.
PROFILE_PRIMER = [4096]
# kernel vs plain version: fp32 differs only in the order of fp32 sums;
# bf16 by the plain version's rounding of the probabilities before PV
# and each side's final rounding (kernels/paged.py `bf16_tolerance`)
# over an int8/int4 cache both dequantize exactly (a code times an fp16
# scale is exact in fp32) and stay fp32 throughout: fp32's bound
TOL = {"float32": "atol 1e-5",
       "bfloat16": "2^-6 |plain| + 1.01 * 2^-8 * (P |V|) + 1e-6",
       "float16": "2^-9 |plain| + 1.01 * 2^-11 * (P |V|) + 1e-6",
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


def profiled_flushed_ms(fn, flush, calls=20):
    """fn's own device time per call, kernel records only: `calls` times
    an L2 flush (`flush.bitwise_not_()`, a kernel fn never runs) then
    fn(), under torch.profiler after one call outside the window and the
    window's primer launches; the mean self device time of every kernel
    but the flush's per call.  At 10-20 us a call, the CUDA events of
    `time_ms` add their own cost; this does not."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        primed = prime_profiler()
        for _ in range(calls):
            flush.bitwise_not_()
            fn()
        torch.cuda.synchronize()
    acts = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    primer_lost(primed, acts)
    flushes = sum(n for name, _, n in acts if "bitwise_not" in name)
    own = [(ms, n) for name, ms, n in acts
           if not is_primer(name) and "bitwise_not" not in name]
    if flushes != calls or not own:
        raise AssertionError(f"profiled_flushed_ms: {flushes} flushes of "
                             f"{calls}, fn's kernels {own}")
    return sum(ms for ms, _ in own) / calls


# -- phase 2: paged attention ---------------------------------------------------


def kernel_case(name, B, T, H, Dh, bs, W, dtype, q_start, gen, flush,
                kv="dense", ops=False):
    """The paged kernel against its plain version at one shape.  `dtype`
    is the dense cache's dtype, or q's (the model's) over an int8/int4
    cache (`kv`), whose rows are randn quantized by the row codec.  The
    record names the kernel's route and key splits; with `ops`, the call's
    device operations under torch.profiler too, which must be the kernel
    alone."""
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

    way = paged.route(q, ck if kv == "dense" else ck[0], kv)
    tile = paged.tile_rows(T, way)
    n_splits, split_keys = paged.split_plan(
        B, H, T, W * bs, bs, rows=tile,
        col_blocks=1 if way == "tensor-cores" else -(-Dh // paged.COLS))
    n_route = paged.LAUNCHES_BY_ROUTE[way]
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    if paged.LAUNCHES_BY_ROUTE[way] != n_route + 1:
        raise AssertionError(f"{name}: the kernel did not take the {way} "
                             f"route")
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
           "bytes": nbytes, "flops": flops, "route": way,
           "tile_rows": tile, "n_splits": n_splits,
           "split_keys": split_keys}
    if ops:
        # one device operation a call: the kernel, no memset, no second pass
        rec["device_split"] = device_split(kernel)
        if rec["device_split"]["device_ops_per_call"] != 1:
            raise AssertionError(f"{name}: {rec['device_split']} device "
                                 f"operations a call, want the kernel alone")
    emit(rec)
    return rec


# -- phase 4: exact serving ----------------------------------------------------


def greedy_with_margins(model, prompt, n, cache_dtype=None):
    """The port's generate() loop, step for step, also returning the
    top-2 logit margin of every step (the oracle's confidence)."""
    import torch

    from deepspeed_tpu_torch.models import generation as G

    L = model.config.max_seq_len
    caches = G._init_caches(model, 1, L, cache_dtype or model.wte.dtype)
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
            div = first_divergence(got, want, margins,
                                   "served stream (against generate())")
            report.append({"prompt_len": len(p), "identical": div is None,
                           "first_divergence": div,
                           "margin_at_divergence": (None if div is None
                                                    else margins[div]),
                           "min_margin": min(margins)})
    emit({"phase": "exact", "config": "gpt2 xl width, 4 layers, fp32",
          "tokens_per_prompt": n_new, "prompts": report})
    del eng, model
    torch.cuda.empty_cache()


def first_divergence(got, want, margins, what):
    """Index of the first step where two greedy streams differ (None if
    they are equal); raises unless the oracle's top-2 margin there is
    below 1e-4, a tie that fp32 rounding may break either way."""
    div = next((i for i in range(len(want)) if got[i] != want[i]), None)
    if div is not None and not margins[div] < 1e-4:
        raise AssertionError(f"{what} diverges at step {div} where the "
                             f"oracle's top-2 margin is {margins[div]}")
    return div


def phase_serve_nano_exact():
    """GPT-2 nano (3 heads of Dh 16) served on the card through the paged
    kernel: fp32 weights, 4 requests of 16 new tokens.  Over a bf16 KV
    cache the greedy streams equal generate() with a bf16 cache; over an
    int8 KV cache they equal the same engine with the paged attention
    forced to its plain version (generate() keeps no int8 cache).  The
    kernel's launches are counted from zero over the kernel runs."""
    import torch

    from deepspeed_tpu_torch.kernels import paged, registry
    from deepspeed_tpu_torch.models import GPT, generate, gpt2_config
    from deepspeed_tpu_torch.serving import ServeConfig, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt2_config("nano", param_dtype=torch.float32)
    model = GPT(cfg, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(2))
    rs = np.random.RandomState(6)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)).tolist()
               for n in (9, 33, 5, 60)]
    n_new = 16

    def serve(kv):
        scfg = ServeConfig(block_size=16, num_blocks=40, max_batch=4,
                           prefill_chunk=32, kv_dtype=kv)
        return ServeEngine(model, scfg, device="cuda").generate(prompts,
                                                                n_new)

    paged.reset_launches()
    served = {kv: serve(kv) for kv in ("bf16", "int8")}
    launches = paged.LAUNCHES
    if not launches > 0:
        raise AssertionError("serve-nano-exact: the paged kernel never ran")
    dispatch = registry.dispatch

    def plain_paged(name, *a, **kw):
        if name == "paged_attention":
            kw["impl"] = "torch"
        return dispatch(name, *a, **kw)

    registry.dispatch = plain_paged
    try:
        plain_int8 = serve("int8")
    finally:
        registry.dispatch = dispatch
    report = {"bf16": [], "int8": []}
    with torch.no_grad():
        for i, p in enumerate(prompts):
            want = generate(model, [p], n_new, cache_len=cfg.max_seq_len,
                            cache_dtype=torch.bfloat16,
                            device="cuda")[0].tolist()
            _, margins = greedy_with_margins(model, p, n_new, torch.bfloat16)
            report["bf16"].append(first_divergence(
                served["bf16"][i], want, margins,
                f"serve-nano-exact bf16 stream {i}"))
            _, margins = greedy_with_margins(model, p, n_new)
            report["int8"].append(first_divergence(
                served["int8"][i], plain_int8[i], margins,
                f"serve-nano-exact int8 stream {i}"))
    rec = {"phase": "serve-nano-exact", "config": "gpt2 nano (d 48, 3 heads "
           "of Dh 16, 3 layers), fp32 params, TF32 off",
           "prompt_lens": [len(p) for p in prompts],
           "tokens_per_prompt": n_new, "paged_launches": launches,
           "first_divergence": report}
    emit(rec)
    del model
    torch.cuda.empty_cache()
    return rec


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


def prime_profiler():
    """The throwaway launches that open a profiler window (see
    PROFILE_PRIMER); returns how many were launched."""
    import torch

    n = PROFILE_PRIMER[0]
    for _ in range(n):
        torch.cuda._sleep(0)
    torch.cuda.synchronize()
    return n


def primer_lost(launched, acts):
    """How many of a window's primer launches the profiler dropped, from
    its (name, ms, count) activities; fails if it dropped all of them,
    when the window's own launches may be missing too."""
    seen = sum(n for name, _, n in acts if is_primer(name))
    lost = launched - seen
    if lost >= launched:
        raise AssertionError(f"the profiler dropped all {launched} primer "
                             f"launches of its window")
    PROFILE_PRIMER[0] = max(PROFILE_PRIMER[0], 4 * lost)
    return lost


def is_primer(name):
    return "spin_kernel" in name


def kernel_class(name):
    """Coarse class of a device activity, for the breakdown."""
    n = name.lower()
    if "paged_attention" in n or "paged_prefill" in n:   # both routes of #10
        return "paged_attention"
    # kernels #11 (quantize_kernel, quantize_vec_kernel,
    # quantize_vec_stream_kernel) and #12 (dequantize_kernel)
    if "quantize_kernel" in n or "quantize_vec" in n:
        return "quant_codec"
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
    paged.reset_launches()
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
    by_route = dict(paged.LAUNCHES_BY_ROUTE)
    by_kind = dict(paged.LAUNCHES_BY_KIND)
    d = COUNTERS.delta_since(snap)

    if not all(r.state == FINISHED and len(r.out) == n_new for r in reqs):
        raise AssertionError(
            f"not every request finished: "
            f"{[(r.state, len(r.out)) for r in reqs]}")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.out):
        raise AssertionError("a served token is outside the vocabulary")
    chunks = d["serve.prefill_chunks"]["calls"]
    n_decode = d["serve.decode_steps"]["calls"]
    if launches != cfg.num_layers * (chunks + n_decode) or by_kind != {
            "decode": cfg.num_layers * n_decode, "verify": 0,
            "prefill": cfg.num_layers * chunks}:
        raise AssertionError(
            f"paged kernel launched {launches} times ({by_kind}), expected "
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
           # the wrapper's launches by kind of call (checked above against
           # layers x the engine's step counts) and by route
           "paged_launches_by_kind": by_kind,
           "paged_launches_by_route": by_route,
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
    # device activity only: the readings are device times by kernel, and
    # the host-side operator events of a 48-layer serving run cost minutes
    # of the profiler's post-processing
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        primed = prime_profiler()
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
    lost = primer_lost(primed, acts)
    acts = [a for a in acts if not is_primer(a[0])]
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
            "profiler_primer_lost": lost,
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
        paged.reset_launches()
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
        by_route = dict(paged.LAUNCHES_BY_ROUTE)
        by_kind = dict(paged.LAUNCHES_BY_KIND)
        d = COUNTERS.delta_since(snap)
        if not all(r.state == FINISHED and len(r.out) == n_new
                   for r in reqs):
            raise AssertionError(
                f"serve-spec: not every request finished: "
                f"{[(r.state, len(r.out)) for r in reqs]}")
        chunks = d["serve.prefill_chunks"]["calls"]
        n_steps = d["serve.decode_steps"]["calls"]
        want_kind = {"decode": 0, "verify": 0,
                     "prefill": cfg.num_layers * chunks}
        want_kind["verify" if draft else "decode"] = cfg.num_layers * n_steps
        if launches != cfg.num_layers * (chunks + n_steps) or \
                by_kind != want_kind:
            raise AssertionError(
                f"serve-spec: paged kernel launched {launches} times "
                f"({by_kind}), expected {cfg.num_layers} x ({chunks} "
                f"prefill chunks + {n_steps} verify/decode steps)")
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
            "paged_launches": launches,
            "paged_launches_by_kind": by_kind,
            "paged_launches_by_route": by_route,
            "kv_pool_bytes": eng.kv.nbytes()}
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
             "+ (dQ, dK) 1e-5 scale (P_d E)|K| or |Q| + 1e-6, u the dtype's "
             "unit roundoff (0 fp32, 2^-8 bf16, 2^-11 fp16), M the output's "
             "absolute-value product, E = |dO|.|V|^T the absolute-value sum "
             "of dp (kernels/flash.py kernel_tolerances)")


def dq_worst(a, kb, delta, ref, got, tol, opts, allow=None):
    """The dQ element furthest into its bound, and what makes it: its
    index, both sides' outputs, the plain version's fp32 value before its
    final rounding (the plain arithmetic for that one row, dense over the
    keys), the dtype's ulp at that magnitude, the bound without and with
    dp's error term, and the row's heaviest keys (p, dp·mask, delta, ds).
    `allow(bh, row)`: the row's live keys (bool [Sk]) under a sparse
    layout; the others take no probability."""
    import torch

    from deepspeed_tpu_torch.ops.transformer.dropout import _keep_mask
    from deepspeed_tpu_torch.ops.transformer.flash_attention import NEG_INF

    ratio = (got.float() - ref.float()).abs() / tol
    bh, row, col = (int(i) for i in np.unravel_index(
        int(ratio.argmax()), ratio.shape))
    q, k, v, do = (t[bh].float() for t in a)
    scale, Sk = opts["scale"], k.shape[0]
    s = (q[row] * scale) @ k.t()
    if opts["causal"]:
        s = torch.where(torch.arange(Sk, device=s.device) <= row, s, NEG_INF)
    if kb is not None:
        s = s + kb[bh // opts["n_heads"]]
    live = None if allow is None else allow(bh, row)
    lse = torch.logsumexp(
        s if live is None else torch.where(live, s, float("-inf")), 0)
    p = torch.exp(s - lse)
    if kb is not None:
        p = torch.where(s <= NEG_INF * 0.5, 0.0, p)
    if live is not None:
        p = torch.where(live, p, 0.0)
    mask = torch.ones_like(p)
    if opts["rate"] > 0.0:
        bhs = torch.tensor([bh + opts.get("bh_offset", 0)], device=s.device)
        mask = _keep_mask(opts["seed"], bhs, row, 0, 1, Sk, opts["rate"],
                          s.device)[0, 0]
    dp = (do[row] @ v.t()) * mask
    ds = p * (dp - delta[bh, row])
    pre = float(scale * (ds.to(a[1].dtype).float() @ k[:, col]))
    e = do[row].abs() @ v.abs().t()
    u = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8,
         torch.float16: 2.0 ** -11}[a[0].dtype]
    term = float((1 + 2 * u) * scale * 1e-5 * ((p * mask * e) @
                                               k[:, col].abs()))
    r = float(ref[bh, row, col].float())
    ulp = float(torch.finfo(a[0].dtype).eps) * 2.0 ** np.floor(
        np.log2(max(abs(r), float(torch.finfo(a[0].dtype).tiny))))
    t = float(tol[bh, row, col])
    err = abs(float(got[bh, row, col].float()) - r)
    top = torch.argsort(p, descending=True)[:4].tolist()
    return {"index": [bh, row, col], "plain": r,
            "kernel": float(got[bh, row, col].float()),
            "plain_fp32_before_rounding": pre, "ulp_at_plain": ulp,
            "abs_err": err, "tol": t, "err_over_tol": err / t,
            "err_over_tol_without_dp_term": err / max(t - term, 1e-30),
            "dp_term": term, "live_keys": int((p > 0).sum()),
            "delta": float(delta[bh, row]),
            "heaviest_keys": [{"k": j, "p": float(p[j]), "dp": float(dp[j]),
                               "ds": float(ds[j])} for j in top]}


def flash_case(name, B, S, H, D, dtype, causal, bias, rate, bh_offset, gen,
               flush, timed, inputs=None):
    """The three flash kernels against their plain versions on one set of
    [B*H, S, D] inputs (drawn from `gen`, or `inputs` = (q, k, v, dO, key
    bias)); device times where `timed`."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.kernels import flash, registry

    dev = "cuda"
    BH = B * H
    if inputs is not None:
        a, kb = [t.to(dev, dtype) for t in inputs[:4]], inputs[4]
    else:
        a = [torch.randn(BH, S, D, device=dev, generator=gen).to(dtype)
             for _ in range(4)]                  # q, k, v, dO
        kb = None
        if bias:
            keep = torch.rand(B, S, device=dev, generator=gen) > 0.25
            kb = torch.where(keep, 0.0, -1e30).float()
            kb[-1, S // 2:] = -1e30              # a batch half masked
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
    dq_report = dq_worst(a, kb, delta, ref["dq"], got["dq"], tols["dq"],
                         opts)
    bad = {k: r for k, r in worst.items() if not r <= 1.0}
    if bad:
        emit({"phase": "flash-failure", "case": name, "over_tol": bad,
              "dq_worst": dq_report})
        raise AssertionError(f"flash {name}: kernel vs plain beyond the "
                             f"bound {bad}, max abs err {errs}")
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
           "dropout": rate, "bh_offset": bh_offset,
           "dq_route": flash.dq_route(a[0]),
           "dkv_route": flash.dkv_route(a[0]), "tol": FLASH_TOL,
           "max_abs_err": errs, "max_err_over_tol": worst,
           "dq_worst": dq_report, "lse_max_abs_err": lse_err, "kernels": {}}
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

        # SDPA's backward alone: one autograd.grad over a retained graph
        # computes dQ, dK and dV together, the library time of #2 and #3
        # jointly
        og = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                            is_causal=causal_flag)

        def sdpa_bwd():
            return torch.autograd.grad(og, (qg, kg, vg), do4,
                                       retain_graph=True)

        rec["sdpa_fwd_ms"] = time_ms(sdpa, 10, flush)
        rec["sdpa_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd, 10, flush)
        rec["sdpa_bwd_ms"] = time_ms(sdpa_bwd, 10, flush)
        rec["kernels"]["flash_attention_fwd"]["library_ms"] = \
            rec["sdpa_fwd_ms"]
        for kname in ("flash_attention_dq", "flash_attention_dkv"):
            rec["kernels"][kname]["library_ms"] = rec["sdpa_bwd_ms"]
            rec["kernels"][kname]["library_joint"] = \
                "SDPA backward: dQ, dK and dV in one call"
        del og
    emit(rec)
    del a, ref, out, lse, delta
    torch.cuda.empty_cache()
    return rec


def phase_flash(gen, flush):
    """The training shape (timed, with SDPA) in bf16 and fp32, a key bias,
    dropout with a bh_offset, Dh 128 (timed), train-moe's S 2048 shape
    (timed), and Dh 256: bf16 (timed), fp16 with a key bias and dropout,
    fp32."""
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
                        0.0, 0, gen, flush, True),
             flash_case("train-moe-shape-bfloat16", 4, 2048, 12, 64, bf16,
                        True, False, 0.0, 0, gen, flush, True),
             flash_case("dh256-bfloat16", 2, 1024, 4, 256, bf16, True, False,
                        0.0, 0, gen, flush, True),
             flash_case("dh256-bias-dropout-float16", 2, 512, 4, 256,
                        torch.float16, True, True, 0.2, 7, gen, flush, False),
             flash_case("dh256-float32", 1, 512, 2, 256, fp32, True, False,
                        0.0, 0, gen, flush, False)]
    return cases


def phase_flash_draws(seeds=(1, 2, 3)):
    """The flash kernels on other draws of their inputs: the training
    shape in bf16 from fresh generators, and the fp16 cases of dQ's
    cancelling rows (Dh 128 with a key bias and dropout, and the training
    shape, timed), each with its worst dQ element; the bound must hold
    whatever the draw."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    out = []
    for seed in seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        out.append(flash_case(f"train-bfloat16-draw{seed}", 8, 1024, 12, 64,
                              torch.bfloat16, True, False, 0.0, 0, gen,
                              flush, False))
    gen = torch.Generator(device="cuda").manual_seed(0)
    fp16 = torch.float16
    out.append(flash_case("dh128-bias-dropout-float16", 2, 256, 2, 128, fp16,
                          True, True, 0.2, 0, gen, flush, False))
    out.append(flash_case("test-dh128-bias-dropout-float16", *TEST_DH128,
                          fp16, True, True, 0.2, 0, None, flush, False,
                          inputs=dh128_test_inputs()))
    # timed: fp16 dQ on the wgmma route, fp16 dK/dV on the CUDA cores
    out.append(flash_case("train-float16", 8, 1024, 12, 64, fp16, True,
                          False, 0.0, 0, gen, flush, True))
    return out


TEST_DH128 = (2, 256, 2, 128)     # B, S, H, Dh


def dh128_test_inputs():
    """The inputs of tests/test_torch_flash.py's dh128-bias-dropout case
    (numpy seeds 0 and 100): q, k, v, dO [B*H, S, D] fp32 on the host and
    the key bias on the card."""
    import torch

    B, S, H, D = TEST_DH128
    rs = np.random.RandomState(0)
    qkvg = [torch.from_numpy(rs.randn(B, S, H, D).astype(np.float32))
            .permute(0, 2, 1, 3).reshape(B * H, S, D) for _ in range(4)]
    rs = np.random.RandomState(100)
    neg = np.finfo(np.float32).min
    kb = np.where(rs.rand(B, S) < 0.25, neg, 0.0).astype(np.float32)
    kb[-1, :] = neg
    return (*qkvg, torch.from_numpy(kb).cuda())


def dq_fp64(a, lse, delta, kb, opts):
    """dQ's plain version in float64: `_dq_plain`'s steps on the same
    inputs, lse and delta — q * scale, the causal select to NEG_INF, the
    key bias and its guard, p = exp(s - lse), dp * mask, ds = p (dp -
    delta) rounded to K's dtype, scale * ds.K — with every product, sum
    and exp in float64, dense over the keys, 128 query rows at a time."""
    import torch

    from deepspeed_tpu_torch.ops.transformer.dropout import _keep_mask
    from deepspeed_tpu_torch.ops.transformer.flash_attention import (
        NEG_INF, _bh, _bias_rows)

    q, k, v, do = (t.double() for t in a)
    BH, S, _ = q.shape
    Sk = k.shape[1]
    scale = opts["scale"]
    kbr = _bias_rows(kb, BH, opts["n_heads"])
    bh = _bh(BH, opts["bh_offset"], q.device)
    kidx = torch.arange(Sk, device=q.device)[None, :]
    dq = torch.empty_like(q)
    for r0 in range(0, S, 128):
        rows = slice(r0, r0 + 128)
        s = (q[:, rows] * scale) @ k.transpose(-1, -2)
        if opts["causal"]:
            qidx = r0 + torch.arange(128, device=q.device)[:, None]
            s = torch.where(qidx >= kidx, s, NEG_INF)
        if kbr is not None:
            s = s + kbr[:, None, :].double()
        p = torch.exp(s - lse[:, rows, None].double())
        if kbr is not None:
            p = torch.where(s <= NEG_INF * 0.5, 0.0, p)
        dp = do[:, rows] @ v.transpose(-1, -2)
        if opts["rate"] > 0.0:
            dp = dp * _keep_mask(opts["seed"], bh, r0, 0, 128, Sk,
                                 opts["rate"], q.device).double()
        ds = p * (dp - delta[:, rows, None].double())
        dq[:, rows] = scale * (ds.to(a[1].dtype).double() @ k)
    return dq


def phase_flash_repeat(n=50):
    """Is dQ a function of its inputs alone?  On the fp16 cases of the
    queue-3 fault — the Dh 128 key-bias + dropout test's inputs, and the
    training shape — the kernel's dQ is computed n times, each call after
    a different kernel left its own data in shared memory (the forward,
    dK/dV, or another dQ), and every result must equal the first bit for
    bit; the plain version's dQ three times, likewise.  A race or a read
    of uninitialised shared memory would show here as run-to-run
    differences.  Then which side carries the error: dQ's plain version
    in float64 (`dq_fp64`) beside both, |kernel - fp64| and |plain -
    fp64| over the kernel-vs-plain bound, at their worst elements and at
    the worst kernel-vs-plain element."""
    import torch

    from deepspeed_tpu_torch.kernels import flash, registry

    gen = torch.Generator(device="cuda").manual_seed(11)
    fp16 = torch.float16
    draws = {"test-dh128-bias-dropout-float16":
             (TEST_DH128, 0.2, True, dh128_test_inputs()),
             "train-float16": ((8, 1024, 12, 64), 0.0, False, None)}
    rec = {"phase": "flash-repeat", "runs": n, "cases": {}}
    for name, ((B, S, H, D), rate, bias, inputs) in draws.items():
        if inputs is None:
            a = [torch.randn(B * H, S, D, device="cuda", generator=gen)
                 .to(fp16) for _ in range(4)]
            kb = None
        else:
            a, kb = [t.to("cuda", fp16) for t in inputs[:4]], inputs[4]
        opts = dict(causal=True, scale=D ** -0.5, block_q=128, block_k=128,
                    rate=rate, seed=1234, bh_offset=0, n_heads=H)
        out, lse = registry.dispatch("flash_attention_fwd", *a[:3], kb,
                                     impl="torch", **opts)
        delta = (a[3].float() * out.float()).sum(-1)
        args = (*a, lse, delta, kb)
        others = [lambda: registry.dispatch("flash_attention_fwd", *a[:3],
                                            kb, impl="cuda", **opts),
                  lambda: registry.dispatch("flash_attention_dkv", *args,
                                            impl="cuda", **opts),
                  lambda: None]
        first = registry.dispatch("flash_attention_dq", *args, impl="cuda",
                                  **opts)
        differ = 0
        for i in range(n):
            others[i % 3]()
            got = registry.dispatch("flash_attention_dq", *args,
                                    impl="cuda", **opts)
            differ += mismatches(got, first) != 0
        plain = [registry.dispatch("flash_attention_dq", *args,
                                   impl="torch", **opts) for _ in range(3)]
        plain_differ = sum(mismatches(p, plain[0]) != 0 for p in plain[1:])
        # which side carries the error: both against the float64 plain
        dk, dv = registry.dispatch("flash_attention_dkv", *args,
                                   impl="torch", **opts)
        tol = flash.kernel_tolerances(*a, kb, {"out": out, "dq": plain[0],
                                               "dk": dk, "dv": dv},
                                      **opts)["dq"]
        ref64 = dq_fp64(a, lse, delta, kb, opts)
        torch.cuda.synchronize()
        e_kern = (first.double() - ref64).abs() / tol.double()
        e_plain = (plain[0].double() - ref64).abs() / tol.double()
        kp = (first.float() - plain[0].float()).abs() / tol
        at = int(kp.argmax())
        fp64 = {"kernel_vs_fp64_over_tol_max": float(e_kern.max()),
                "plain_vs_fp64_over_tol_max": float(e_plain.max()),
                "kernel_vs_plain_over_tol_max": float(kp.max()),
                "at_worst_kernel_vs_plain": {
                    "index": [int(i) for i in np.unravel_index(at, kp.shape)],
                    "kernel_vs_fp64_over_tol": float(e_kern.flatten()[at]),
                    "plain_vs_fp64_over_tol": float(e_plain.flatten()[at]),
                    "fp64": float(ref64.flatten()[at]),
                    "kernel": float(first.flatten()[at]),
                    "plain": float(plain[0].flatten()[at])}}
        rec["cases"][name] = {"dq_route": flash.dq_route(a[0]),
                              "kernel_runs_differing": differ,
                              "plain_runs_differing": plain_differ,
                              "dq_against_fp64": fp64}
        del a, args, first, plain, out, lse, delta, dk, dv, tol, ref64
        del e_kern, e_plain, kp
    emit(rec)
    bad = {k: c for k, c in rec["cases"].items()
           if c["kernel_runs_differing"] or c["plain_runs_differing"]}
    if bad:
        raise AssertionError(f"flash dQ differs from run to run: {bad}")
    return rec


# -- block-sparse flash attention kernels (#7-#9) ---------------------------------

SPARSE_TOL = ("per element (kernels/flash_sparse.py kernel_tolerances): the "
              "dense flash bound over the layout's active tiles, 2u|plain| + "
              "(2u, forward and dQ only, + 1e-5) M + (dQ, dK) 1e-5 scale "
              "(P_d E)|K| or |Q| + 1e-6")
# DeepSpeed's sparse-attention tutorial's "fixed" mode (local 4, global 1,
# bidirectional), at layout block 128 on the training path
BERT_SPARSITY = dict(num_local_blocks=4, num_global_blocks=1,
                     attention="bidirectional")


def fixed_layout(H, block, S, attention="bidirectional"):
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig

    return np.asarray(FixedSparsityConfig(
        num_heads=H, block=block, **dict(BERT_SPARSITY, attention=attention))
        .make_layout(S))


def live_pairs(layout, block, causal):
    """(q, k) token pairs the layout leaves live in one batch row, summed
    over the heads: an active block is block^2 pairs, or, under the causal
    mask, block(block+1)/2 on the diagonal and none above it."""
    lay = np.asarray(layout) != 0
    if not causal:
        return int(lay.sum()) * block * block
    i, j = np.indices(lay.shape[1:])
    per = np.where(j < i, block * block,
                   np.where(j == i, block * (block + 1) // 2, 0))
    return int((lay * per[None]).sum())


def sparse_case(name, B, S, H, D, block, layout, dtype, causal, rate, gen,
                flush, timed, inputs=None):
    """The three sparse flash kernels against their plain versions on one
    set of [B*H, S, D] inputs (drawn from `gen`, or `inputs` = (q, k, v,
    dO)) under `layout`; device times where `timed`, beside the bound, the
    plain versions, SDPA with the layout as a boolean mask and the dense
    flash kernels at the same shape."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.kernels import flash_sparse as fsk
    from deepspeed_tpu_torch.kernels import registry
    from deepspeed_tpu_torch.ops.sparse_attention.flash_sparse import \
        device_tables

    dev = "cuda"
    BH = B * H
    if inputs is None:
        a = [torch.randn(BH, S, D, device=dev, generator=gen).to(dtype)
             for _ in range(4)]                  # q, k, v, dO
    else:
        a = [t.to(dev, dtype).contiguous() for t in inputs]
    ft, rt, order = device_tables(layout, dev)
    opts = dict(causal=causal, scale=D ** -0.5, block=block, rate=rate,
                seed=1234, n_heads=H)

    def fwd(impl):
        return registry.dispatch("flash_sparse_fwd", *a[:3], ft, impl=impl,
                                 **opts)

    ref = {}
    out, lse = fwd("torch")
    ref["out"] = out
    delta = (a[3].float() * out.float()).sum(-1)

    def dq(impl):
        return registry.dispatch("flash_sparse_dq", *a, lse, delta, ft,
                                 impl=impl, **opts)

    def dkv(impl):
        return registry.dispatch("flash_sparse_dkv", *a, lse, delta, rt,
                                 order=order, impl=impl, **opts)

    ref["dq"] = dq("torch")
    ref["dk"], ref["dv"] = dkv("torch")
    got = {}
    got["out"], got_lse = fwd("cuda")
    got["dq"] = dq("cuda")
    got["dk"], got["dv"] = dkv("cuda")
    torch.cuda.synchronize()
    tols = fsk.kernel_tolerances(*a, layout, ref, **opts)
    errs, worst = {}, {}
    for k, tol in tols.items():
        diff = (got[k].float() - ref[k].float()).abs()
        errs[k] = diff.max().item()
        worst[k] = (diff / tol).max().item()
    lay_t = torch.as_tensor(np.asarray(layout) != 0, device=dev)
    keys = torch.arange(S, device=dev)

    def allow(bh, row):
        live = lay_t[bh % H, row // block].repeat_interleave(block)
        return live & (keys <= row) if causal else live

    dq_report = dq_worst(a, None, delta, ref["dq"], got["dq"], tols["dq"],
                         opts, allow=allow)
    bad = {k: r for k, r in worst.items() if not r <= 1.0}
    if bad:
        emit({"phase": "sparse-failure", "case": name, "over_tol": bad,
              "dq_worst": dq_report})
        raise AssertionError(f"sparse {name}: kernel vs plain beyond the "
                             f"bound {bad}, max abs err {errs}")
    lse_diff = (got_lse - lse).abs()
    if not bool((lse_diff <= 1e-5 * (1 + lse.abs())).all()):
        raise AssertionError(f"sparse {name}: lse differs by "
                             f"{lse_diff.max().item()}")
    empty_rows = int((lse == -1e30).sum())
    del tols, got

    dname = str(dtype).replace("torch.", "")
    isz = a[0].element_size()
    pairs = B * live_pairs(layout, block, causal)
    io = BH * S * D * isz                              # one [BH, S, D]
    rows = BH * S * 4                                  # one fp32 [BH, S]
    # bytes: each input read once (the tables too), each output written once
    work = {"flash_sparse_fwd": (4 * D * pairs, 4 * io + rows + ft.numel() * 4),
            "flash_sparse_dq": (6 * D * pairs,
                                5 * io + 2 * rows + ft.numel() * 4),
            "flash_sparse_dkv": (8 * D * pairs,
                                 6 * io + 2 * rows + rt.numel() * 4)}
    rec = {"phase": "sparse", "case": name, "B": B, "S": S, "H": H, "Dh": D,
           "block": block, "dtype": dname, "causal": causal,
           "dropout": rate, "W": int(ft.shape[-1]), "Wq": int(rt.shape[-1]),
           # derived from the dK/dV kernels' design, not measured: every
           # 64-row tile of every active block, causal or not, 8 products
           # (S^T, dP^T, three bf16 terms each of dV and dK) where the
           # bound counts 4
           "dkv_tensor_flops_by_design":
               B * int(np.asarray(layout).sum()) * (block // 64) ** 2
               * 64 * 64 * 2 * D * 8 if block % 64 == 0 else None,
           "live_pairs": pairs, "density": pairs / (BH * S * S),
           "empty_rows": empty_rows, "tol": SPARSE_TOL,
           "fwd_route": fsk.fwd_route(a[0], block),
           "dq_route": fsk.dq_route(a[0], block),
           "max_abs_err": errs, "max_err_over_tol": worst,
           "dq_worst": dq_report,
           "lse_max_abs_err_finite_rows":
               lse_diff[lse > -1e30].max().item() if empty_rows < lse.numel()
               else 0.0,
           "kernels": {}}
    fns = {"flash_sparse_fwd": fwd, "flash_sparse_dq": dq,
           "flash_sparse_dkv": dkv}
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
            k["library_ms"] = None
        rec["kernels"][kname] = k
    if timed:
        # yardstick: SDPA forward with the layout as a boolean [H, S, S]
        # mask (no dropout), on the same tensors viewed [B, H, S, D]
        q4, k4, v4 = (t.view(B, H, S, D) for t in a[:3])
        mask = lay_t.repeat_interleave(block, 1).repeat_interleave(block, 2)
        if causal:
            mask = mask & torch.ones(S, S, dtype=torch.bool,
                                     device=dev).tril()
        mask = mask[None]
        rec["kernels"]["flash_sparse_fwd"]["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   attn_mask=mask),
            10, flush)
        if rate == 0.0:
            # SDPA's backward under the same mask: one autograd.grad over a
            # retained graph computes dQ, dK and dV together, the library
            # time of #8 and #9 jointly
            qg, kg, vg = (t.detach().clone().requires_grad_()
                          for t in (q4, k4, v4))
            og = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
            do4 = a[3].view(B, H, S, D)
            rec["sdpa_bwd_ms"] = time_ms(
                lambda: torch.autograd.grad(og, (qg, kg, vg), do4,
                                            retain_graph=True), 10, flush)
            for kname in ("flash_sparse_dq", "flash_sparse_dkv"):
                rec["kernels"][kname]["library_ms"] = rec["sdpa_bwd_ms"]
                rec["kernels"][kname]["library_joint"] = \
                    "SDPA backward with the layout mask: dQ, dK and dV " \
                    "in one call"
            del qg, kg, vg, og
        del mask
        # the dense flash kernels at the same shape (all S x S pairs)
        fo = dict(causal=causal, scale=D ** -0.5, block_q=128, block_k=128,
                  rate=0.0, seed=0, bh_offset=0, n_heads=H)
        d_out, d_lse = registry.dispatch("flash_attention_fwd", *a[:3], None,
                                         impl="cuda", **fo)
        d_args = (*a, d_lse, (a[3].float() * d_out.float()).sum(-1), None)
        rec["dense_flash_ms"] = {
            "flash_attention_fwd": time_ms(lambda: registry.dispatch(
                "flash_attention_fwd", *a[:3], None, impl="cuda", **fo),
                10, flush),
            "flash_attention_dq": time_ms(lambda: registry.dispatch(
                "flash_attention_dq", *d_args, impl="cuda", **fo), 10, flush),
            "flash_attention_dkv": time_ms(lambda: registry.dispatch(
                "flash_attention_dkv", *d_args, impl="cuda", **fo), 10,
                flush)}
        del d_out, d_lse, d_args
    emit(rec)
    del a, ref, out, lse, delta
    torch.cuda.empty_cache()
    return rec


def sparse_mask_probe(blk=16, D=64, nb=16):
    """The dropout masks of #7 and #9, element by element: with q = 0
    every score is 0, a permutation layout gives each q-block one k-block
    (and each k-block one q-block), V and dO are one-hot over the block's
    `blk` positions (D >= blk columns), so out[q, d] and dv[k, d] are each
    one masked term — zero exactly where the mask drops it.  Kernel and
    plain version must drop the same elements (and agree within the
    bound), in each dtype."""
    import torch

    B, H = 1, 2
    S = nb * blk
    layout = np.zeros((H, nb, nb), np.int64)
    for h in range(H):
        for i in range(nb):
            layout[h, i, (3 * i + 1 + h) % nb] = 1
    pos = torch.arange(S)
    onehot = torch.zeros(S, D)
    onehot[pos, pos % blk] = 1.0
    k = torch.randn(B * H, S, D, generator=torch.Generator().manual_seed(1))
    inputs = (torch.zeros(B * H, S, D), k, onehot.expand(B * H, S, D),
              onehot.expand(B * H, S, D))
    out = {}
    for dtype in ("float32", "bfloat16", "float16"):
        dt_ = getattr(torch, dtype)
        rec = sparse_case(f"mask-probe-block{blk}-{dtype}", B, S, H, D,
                          blk, layout, dt_, False, 0.3, None, None, False,
                          inputs=inputs)
        # the zero patterns of out and dv are the masks
        from deepspeed_tpu_torch.kernels import registry
        from deepspeed_tpu_torch.ops.sparse_attention.flash_sparse import \
            device_tables

        a = [t.to("cuda", dt_).contiguous() for t in inputs]
        ft, rt, order = device_tables(layout, "cuda")
        opts = dict(causal=False, scale=D ** -0.5, block=blk, rate=0.3,
                    seed=1234, n_heads=H)
        diff = {}
        res = {}
        for impl in ("torch", "cuda"):
            o, lse = registry.dispatch("flash_sparse_fwd", *a[:3], ft,
                                       impl=impl, **opts)
            if impl == "torch":
                lse0, delta = lse, (a[3].float() * o.float()).sum(-1)
            _, dv = registry.dispatch("flash_sparse_dkv", *a, lse0, delta,
                                      rt, order=order, impl=impl, **opts)
            res[impl] = (o, dv)
        for i, name in enumerate(("out", "dv")):
            diff[name] = int(((res["cuda"][i] == 0) !=
                              (res["torch"][i] == 0)).sum())
        dropped = int((res["torch"][0][..., :blk] == 0).sum())
        if any(diff.values()) or dropped == 0:
            raise AssertionError(f"sparse mask probe {dtype}: zero patterns "
                                 f"differ {diff} (plain dropped {dropped})")
        out[dtype] = {"mask_mismatches": diff,
                      "dropped_of": [dropped, B * H * S * blk],
                      "max_err_over_tol": rec["max_err_over_tol"]}
    rec = {"phase": "sparse-mask-probe", "layout": f"permutation, block "
           f"{blk}, Dh {D}", "rate": 0.3, "cases": out}
    emit(rec)
    return rec


def phase_sparse(flush):
    """#7-#9 against their plain versions: the training shape (BERT-large
    heads, S 4096, block 128, the tutorial's fixed layout) in bf16 (timed),
    with dropout, in fp32 and fp16; a BigBird block-64 layout with dropout;
    a unidirectional fixed layout under the causal mask; block 16 at Dh
    128 in fp16 with causal dropout; a layout with an empty row and an
    empty column in fp32 and (causal, dropout) bf16; the training shape at
    block 256 with dropout (timed, beside block 128 with dropout); block
    192 (64-row tiles) in fp32 and block 160 (16-row tiles) in bf16 with
    causal dropout; Dh 256 at block 128, bf16 with dropout and fp32; the
    mask probe at block 16, at block 256 (Dh 256), at block 64 (Dh 64,
    the wgmma dK/dV's transposed hash coordinates and the one-consumer
    wgmma forward) and at block 128 (Dh 128, the two-consumer wgmma
    forward); the wgmma dK/dV's empty row and empty column at block 64
    (causal, dropout, bf16)."""
    import random

    import torch

    from deepspeed_tpu_torch.ops.sparse_attention import \
        BigBirdSparsityConfig

    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16, fp32, fp16 = torch.bfloat16, torch.float32, torch.float16
    train = fixed_layout(16, 128, 4096)
    cases = [sparse_case("train-bfloat16", 2, 4096, 16, 64, 128, train, bf16,
                         False, 0.0, gen, flush, True),
             sparse_case("train-dropout-bfloat16", 2, 4096, 16, 64, 128,
                         train, bf16, False, 0.1, gen, flush, True),
             sparse_case("train-float32", 2, 4096, 16, 64, 128, train, fp32,
                         False, 0.0, gen, flush, False),
             sparse_case("train-float16", 2, 4096, 16, 64, 128, train, fp16,
                         False, 0.0, gen, flush, False)]
    random.seed(0)
    bigbird = np.asarray(BigBirdSparsityConfig(
        num_heads=4, block=64, different_layout_per_head=True,
        num_random_blocks=2, num_sliding_window_blocks=3,
        num_global_blocks=1).make_layout(1024))
    cases.append(sparse_case("bigbird64-dropout-bfloat16", 2, 1024, 4, 64,
                             64, bigbird, bf16, False, 0.1, gen, flush,
                             False))
    cases.append(sparse_case(
        "unidirectional-causal-bfloat16", 2, 2048, 4, 64, 128,
        fixed_layout(4, 128, 2048, "unidirectional"), bf16, True, 0.1, gen,
        flush, False))
    cases.append(sparse_case(
        "block16-dh128-causal-dropout-float16", 2, 256, 2, 128, 16,
        fixed_layout(2, 16, 256), fp16, True, 0.2, gen, flush, False))
    empty = fixed_layout(4, 32, 512).copy()
    empty[:, 5, :] = 0                   # q-block 5 attends nothing
    empty[1, :, 3] = 0                   # head 1: no q-block reads k-block 3
    cases.append(sparse_case("empty-row-block32-float32", 2, 512, 4, 64, 32,
                             empty, fp32, False, 0.0, gen, flush, False))
    cases.append(sparse_case("empty-row-block32-causal-dropout-bfloat16", 2,
                             512, 4, 64, 32, empty, bf16, True, 0.1, gen,
                             flush, False))
    cases.append(sparse_case("train-block256-dropout-bfloat16", 2, 4096, 16,
                             64, 256, fixed_layout(16, 256, 4096), bf16,
                             False, 0.1, gen, flush, True))
    cases.append(sparse_case("block192-float32", 2, 1536, 4, 64, 192,
                             fixed_layout(4, 192, 1536), fp32, False, 0.0,
                             gen, flush, False))
    cases.append(sparse_case("block160-causal-dropout-bfloat16", 2, 1280, 4,
                             64, 160, fixed_layout(4, 160, 1280), bf16, True,
                             0.1, gen, flush, False))
    # the wgmma dQ at Dh 128 (fp16, causal, dropout)
    cases.append(sparse_case("dh128-block128-causal-dropout-float16", 2, 2048,
                             4, 128, 128, fixed_layout(4, 128, 2048), fp16,
                             True, 0.1, gen, flush, False))
    cases.append(sparse_case("dh256-block128-dropout-bfloat16", 2, 1024, 4,
                             256, 128, fixed_layout(4, 128, 1024), bf16,
                             False, 0.1, gen, flush, False))
    cases.append(sparse_case("dh256-block128-float32", 2, 1024, 4, 256, 128,
                             fixed_layout(4, 128, 1024), fp32, False, 0.0,
                             gen, flush, False))
    # the wgmma dK/dV's empty column (its walk is empty: zeros) and empty
    # row at block 64, causal, with dropout
    empty64 = fixed_layout(4, 64, 1024).copy()
    empty64[:, 5, :] = 0
    empty64[1, :, 3] = 0
    cases.append(sparse_case("empty-row-block64-causal-dropout-bfloat16", 2,
                             1024, 4, 64, 64, empty64, bf16, True, 0.1, gen,
                             flush, False))
    probes = [sparse_mask_probe(), sparse_mask_probe(blk=256, D=256, nb=4),
              sparse_mask_probe(blk=64, D=64, nb=8),
              # the wgmma forward's two-consumer route (block 128)
              sparse_mask_probe(blk=128, D=128, nb=4)]
    return cases, probes


SPARSE_REPEAT_CASES = (
    # B, S, H, D, block, dtype, causal, dropout: the fp16 16-row-tile
    # kernels, then the bf16 wgmma dQ and dK/dV (heaviest walk first), then
    # the wgmma dQ at Dh 128 in fp16 under the causal mask
    (2, 256, 2, 128, 16, "float16", True, 0.2),
    (2, 1024, 4, 64, 128, "bfloat16", False, 0.1),
    (2, 1024, 4, 128, 128, "float16", True, 0.1))


def phase_sparse_repeat(n=50):
    """The sparse forward, dQ and dK/dV as functions of their inputs
    alone, as phase_flash_repeat checks dense dQ: on the fp16 Dh 128 causal
    dropout case (block 16), on a bf16 Dh 64 fixed layout at block 128 with
    dropout (the wgmma forward, dQ and dK/dV, whose persistent grids hand
    out items in order) and on an fp16 Dh 128 causal one (the wgmma
    forward and dQ), each is computed n times, each call after a different
    kernel left its own data in shared memory (the dense flash forward, the
    dense flash dK/dV, or nothing), and every result must equal the first
    bit for bit; the plain versions three times, likewise."""
    import torch

    from deepspeed_tpu_torch.kernels import flash_sparse as fsk
    from deepspeed_tpu_torch.kernels import registry
    from deepspeed_tpu_torch.ops.sparse_attention.flash_sparse import \
        device_tables

    recs = []
    for B, S, H, D, blk, dname, causal, rate in SPARSE_REPEAT_CASES:
        gen = torch.Generator(device="cuda").manual_seed(13)
        layout = fixed_layout(H, blk, S)
        ft, rt, order = device_tables(layout, "cuda")
        a = [torch.randn(B * H, S, D, device="cuda", generator=gen).to(
            getattr(torch, dname)) for _ in range(4)]
        opts = dict(causal=causal, scale=D ** -0.5, block=blk, rate=rate,
                    seed=1234, n_heads=H)
        out, lse = registry.dispatch("flash_sparse_fwd", *a[:3], ft,
                                     impl="torch", **opts)
        delta = (a[3].float() * out.float()).sum(-1)
        args = (*a, lse, delta)
        fo = dict(causal=True, scale=D ** -0.5, block_q=128, block_k=128,
                  rate=0.2, seed=7, bh_offset=0, n_heads=H)

        def both(impl):
            return [*registry.dispatch("flash_sparse_fwd", *a[:3], ft,
                                       impl=impl, **opts),
                    registry.dispatch("flash_sparse_dq", *args, ft,
                                      impl=impl, **opts),
                    *registry.dispatch("flash_sparse_dkv", *args, rt,
                                       order=order, impl=impl, **opts)]

        others = [lambda: registry.dispatch("flash_attention_fwd", *a[:3],
                                            None, impl="cuda", **fo),
                  lambda: registry.dispatch("flash_attention_dkv", *args,
                                            None, impl="cuda", **fo),
                  lambda: None]
        first = both("cuda")
        differ = {"out": 0, "lse": 0, "dq": 0, "dk": 0, "dv": 0}
        for i in range(n):
            others[i % 3]()
            for name, x, y in zip(differ, both("cuda"), first):
                differ[name] += mismatches(x, y) != 0
        plain = [both("torch") for _ in range(3)]
        plain_differ = sum(mismatches(x, y) != 0 for p in plain[1:]
                           for x, y in zip(p, plain[0]))
        torch.cuda.synchronize()
        rec = {"phase": "sparse-repeat", "runs": n,
               "case": f"B {B}, S {S}, H {H}, Dh {D}, block {blk}, {dname}, "
               f"{'causal, ' if causal else ''}dropout {rate}",
               "fwd_route": fsk.fwd_route(a[0], blk),
               "dq_route": fsk.dq_route(a[0], blk),
               "kernel_runs_differing": differ,
               "plain_runs_differing": plain_differ}
        emit(rec)
        if any(differ.values()) or plain_differ:
            raise AssertionError(f"sparse forward / dQ / dK / dV differ from "
                                 f"run to run: {rec}")
        recs.append(rec)
        del a, args, out, lse, delta, first, plain
    return recs


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
    # the entry point's block divisors; a ragged N or V takes one block
    opts = dict(block_rows=next((b for b in (256, 128) if N % b == 0), N),
                block_v=next((b for b in (512, 448, 384, 256, 128)
                              if V % b == 0), V))

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
    fwd_route = fused_xent.fwd_route(x, w, labels)
    dx_route = fused_xent.dx_route(x, w, labels, lse, valid)
    dw_route = fused_xent.dw_route(x, w, labels, lse, valid)
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
           "max_abs_err": errs, "max_err_over_tol": worst, "kernels": {},
           "fwd_route": fwd_route, "dx_route": dx_route,
           "dw_route": dw_route}
    if fwd_route == "wgmma":
        # derived from the wgmma forward's tiling (128-token x 256-vocab
        # tiles over D in 64-column chunks), not measured: the one product
        # over N, V and D rounded up to them
        rec["fwd_tensor_flops_by_design"] = (2 * -(-N // 128) * 128 *
                                             -(-D // 64) * 64 *
                                             -(-V // 256) * 256)
    if dx_route == "wgmma":
        # derived from the wgmma kernel's tiling in its dx role (64-token
        # resident tiles, 16-row vocab tiles, the logits' D-sum split
        # between the warpgroups), not measured: both products once over
        # the padded N and V
        rec["dx_tensor_flops_by_design"] = (2 * 2 * -(-N // 64) * 64 * D *
                                            -(-V // 16) * 16)
    if dw_route == "wgmma":
        # derived from the wgmma kernel's tiling (16-token x tiles, 64-row
        # vocab tiles, the logits' D-sum split between the warpgroups),
        # not measured: both products once over the padded N and V
        rec["dw_tensor_flops_by_design"] = (2 * 2 * -(-N // 16) * 16 * D *
                                            -(-V // 64) * 64)
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
        # (cuBLAS x @ W, the bare product; it computes no lse)
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
                      gen, flush, True),
            # widths off the 64-column tile (nano's 48) and past 1600
            xent_case("nano-width-d48-bfloat16", 1024, 48, 50304,
                      torch.bfloat16, gen, flush, True),
            xent_case("d2048-bfloat16", 1024, 2048, 50304, torch.bfloat16,
                      gen, flush, True),
            xent_case("d2560-bfloat16", 1024, 2560, 50304, torch.bfloat16,
                      gen, flush, True),
            xent_case("d2560-float32", 1024, 2560, 50304, torch.float32,
                      gen, flush, True),
            # dW's wgmma route at a ragged N and GPT-2's real vocab, fp16
            xent_case("ragged-n1000-v50257-float16", 1000, 768, 50257,
                      torch.float16, gen, flush, False)]


XENT_REPEAT_CASES = (
    # N, D, V, dtype: train-pallas's shape, then a ragged N and GPT-2's
    # real vocab in fp16 (the wgmma forward, dx and dW all)
    (8192, 768, 50304, "bfloat16"),
    (1000, 768, 50257, "float16"))


def phase_xent_repeat(n=50):
    """The fused-CE forward, dx and dW as functions of their inputs alone,
    on their wgmma routes (the tied head): each is computed n times, each
    call after a different kernel left its data in shared memory (the
    fused-CE forward's plain version, a reduction, or nothing), and every
    result must equal the first bit for bit."""
    import torch

    from deepspeed_tpu_torch.kernels import fused_xent, registry

    recs = []
    for N, D, V, dname in XENT_REPEAT_CASES:
        dtype = getattr(torch, dname)
        gen = torch.Generator(device="cuda").manual_seed(17)
        x = torch.randn(N, D, device="cuda", generator=gen).to(dtype)
        w = (0.02 * torch.randn(V, D, device="cuda", generator=gen)).to(
            dtype).t()
        labels = torch.randint(0, V, (N,), device="cuda", generator=gen)
        valid = torch.rand(N, device="cuda", generator=gen) >= 0.2
        g = torch.tensor(1.0 / float(valid.sum()), device="cuda")
        opts = dict(block_rows=N, block_v=V)
        lse, _ = registry.dispatch("fused_xent_fwd", x, w, labels,
                                   impl="torch", **opts)
        routes = {"fwd": fused_xent.fwd_route(x, w, labels),
                  "dx": fused_xent.dx_route(x, w, labels, lse, valid),
                  "dw": fused_xent.dw_route(x, w, labels, lse, valid)}
        if set(routes.values()) != {"wgmma"}:
            raise AssertionError(f"xent repeat: routes {routes}, want wgmma")

        def both():
            return [*registry.dispatch("fused_xent_fwd", x, w, labels,
                                       impl="cuda", **opts),
                    *(registry.dispatch(f"fused_xent_{k}", x, w, labels, lse,
                                        valid, g, impl="cuda", **opts)
                      for k in ("dx", "dw"))]

        others = [lambda: registry.dispatch("fused_xent_fwd", x, w, labels,
                                            impl="torch", **opts),
                  lambda: torch.randn(1 << 20, device="cuda").sum(),
                  lambda: None]
        first = both()
        differ = {"lse": 0, "ll": 0, "dx": 0, "dw": 0}
        for i in range(n):
            others[i % 3]()
            for name, a, b in zip(differ, both(), first):
                differ[name] += mismatches(a, b) != 0
        torch.cuda.synchronize()
        rec = {"phase": "xent-repeat", "runs": n,
               "case": f"N {N}, D {D}, V {V}, {dname}, tied head",
               "routes": routes, "kernel_runs_differing": differ}
        emit(rec)
        if any(differ.values()):
            raise AssertionError(f"fused-CE forward / dx / dW differ from run "
                                 f"to run: {rec}")
        recs.append(rec)
        del x, w, first
    return recs


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


def vocab_batches(steps, micro, seq, vocab, seed, law="zipf"):
    """i.i.d. tokens over the whole vocabulary: "uniform", or "zipf" —
    rank r drawn with probability proportional to 1/r, the rank-frequency
    law of natural text, ranks given to ids by a seeded permutation.  The
    MoE router sees as many distinct tokens as real text gives it, and
    the unigram law is learnable (the loss falls)."""
    rng = np.random.RandomState(seed)
    ids = rng.permutation(vocab)
    p = 1.0 / np.arange(1, vocab + 1)
    p = None if law == "uniform" else p / p.sum()
    for _ in range(steps):
        toks = ids[rng.choice(vocab, size=(micro, seq + 1), p=p)]
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
    if any(k in n for k in ("sparse_fwd", "sparse_dq", "sparse_dkv")):
        return "flash_sparse"
    # #1-#3: flash_fwd_wgmma_kernel, flash_dq_wgmma_kernel,
    # flash_dkv_wgmma_kernel on the bf16 path; flash_dq_mma_kernel (Dh 256)
    # and the CUDA-core flash_{fwd,dq,dkv}_kernel elsewhere
    if any(k in n for k in ("flash_fwd_", "flash_dq_", "flash_dkv_")):
        return "flash_attention"
    if "dispatch_kernel" in n or "combine_kernel" in n:
        return "moe"
    if any(k in n for k in ("fx_fwd_kernel", "fx_fwd_wgmma_kernel",
                            "fx_bwd_kernel", "fx_bwd_stream_kernel",
                            "fx_wgmma_kernel")):
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


def resume_dataset(n=24, seq=1024, vocab=64, seed=11):
    """n sequences of the stride stream as (x, y) samples: with micro 8,
    three batches an epoch, so 8 steps of the engine-owned loader run
    through three epochs, each shuffled anew."""
    return [(x[i], y[i]) for x, y in stride_batches(n // 8, 8, seq, vocab,
                                                     seed)
            for i in range(8)]


def phase_train_resume(size="small", device="cuda"):
    """Resumable training on the full-width path: GPT-2 small, seq 1024,
    micro 8, bf16, fused CE, trained from `initialize(training_data=...)`
    with `train_batch()` and no iterator.  The uninterrupted run takes 4
    steps, a sync save (tag A), 2 steps, an async save (tag B) and 2 more
    steps; a fresh engine (input pipeline off) loads A and runs 4 steps,
    another (pipeline on) loads `latest` (B) and runs 2.  Their losses,
    batches (bytes the model received) and final fp32 masters must equal
    the uninterrupted run's steps 5-8 and 7-8 bitwise, and each run
    launches flash #1-#3 12 times a step and fused CE #4-#6 once a step,
    with no plain version on the path.  (`size` and `device` let a CPU
    rehearsal run the same control flow on GPT-2 nano, unchecked
    launches.)"""
    import hashlib
    import shutil
    import tempfile

    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.kernels import flash, fused_xent
    from deepspeed_tpu_torch.models import GPT, gpt2_config
    from deepspeed_tpu_torch.monitor.counters import COUNTERS
    from deepspeed_tpu_torch.runtime import checkpointing as ckpt_io

    micro, seq = 8, 1024
    cfg = gpt2_config(size, loss_impl="pallas", max_seq_len=seq)
    data = resume_dataset(seq=seq)
    on_card = device == "cuda"

    def digest(batch):
        return hashlib.sha256(b"".join(
            (t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t))
            .tobytes() for t in batch)).hexdigest()

    def engine(pipeline):
        model = GPT(cfg, device=device,
                    generator=torch.Generator(device=device).manual_seed(0))
        conf = train_config(micro, 1e-4, "bf16")
        if not pipeline:
            conf["data_pipeline"] = {"enabled": False}
        eng, *_ = dt.initialize(model=model, config_params=conf,
                                training_data=data, device=device)
        seen = []
        forward = eng.forward

        def recording(batch, generator=None):
            seen.append(digest(batch))
            return forward(batch, generator)

        eng.forward = recording   # train_batch calls self.forward
        return eng, seen

    def run(eng, steps, run_name, counted):
        """`steps` train_batch() calls, each timed to its synchronize;
        the launches of the steps, counted from 0, checked."""
        for counts in (flash.LAUNCHES, fused_xent.LAUNCHES):
            for k in counts:
                counts[k] = 0
        snap = COUNTERS.snapshot()
        losses, ms = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(eng.train_batch()))
            if on_card:
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        d = COUNTERS.delta_since(snap)
        launches = {**flash.LAUNCHES, **fused_xent.LAUNCHES}
        want = {**{k: cfg.num_layers * steps for k in flash.LAUNCHES},
                **{k: steps for k in fused_xent.LAUNCHES}}
        if on_card and (launches != want or d.get("kernel.fallbacks") or
                        d["kernel.dispatches"]["calls"] !=
                        3 * cfg.num_layers * steps + 3 * steps):
            raise AssertionError(f"{run_name}: launches {launches}, "
                                 f"expected {want}; counters {d}")
        for k, v in launches.items():
            counted[k] = counted.get(k, 0) + v
        # the host's wait on the input iterator, per step
        wait_ms = d.get("input.host_wait_ms", {"bytes": 0})["bytes"] / 1e3
        return losses, ms, wait_ms / steps

    def ckpt_delta(snap):
        d = COUNTERS.delta_since(snap)
        return {k: d.get(k, {}).get("bytes", 0)
                for k in ("ckpt.stall_ms", "ckpt.bytes")}

    tmp = tempfile.mkdtemp(prefix="train-resume-")
    counted = {}
    try:
        eng, seen = engine(pipeline=True)
        losses, ms_on, wait_on = run(eng, 4, "uninterrupted 1-4", counted)
        snap = COUNTERS.snapshot()
        t0 = time.perf_counter()
        eng.save_checkpoint(tmp, tag="A")
        sync_wall_ms = (time.perf_counter() - t0) * 1e3
        sync = ckpt_delta(snap)
        more, _, _ = run(eng, 2, "uninterrupted 5-6", counted)
        losses += more
        # the second save of the run is asynchronous: the snapshot goes
        # to pinned host memory on a side stream, the write runs on
        eng._config.checkpoint_async_save = True
        snap = COUNTERS.snapshot()
        eng.save_checkpoint(tmp, tag="B")
        async_stall_us = ckpt_delta(snap)["ckpt.stall_ms"]
        more, ms_async, _ = run(eng, 2, "uninterrupted 7-8", counted)
        losses += more
        t0 = time.perf_counter()
        ckpt_io.flush_pending()
        flush_ms = (time.perf_counter() - t0) * 1e3
        async_bytes = ckpt_delta(snap)["ckpt.bytes"]
        want_masters = [p.detach().clone() for p in eng.params.values()]
        n_params = sum(p.numel() for p in want_masters)
        ref_seen = list(seen)
        eng.finalize_monitoring()
        del eng
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        resumed = {}
        for name, tag, pipeline, steps in (("from-A", "A", False, 4),
                                           ("from-latest", None, True, 2)):
            eng, seen = engine(pipeline)
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.load_checkpoint(tmp, tag=tag)
            if on_card:
                torch.cuda.synchronize()
            load_ms = (time.perf_counter() - t0) * 1e3
            want_tag = tag or "B"
            if eng.loaded_checkpoint_tag != want_tag or \
                    eng.global_steps != 8 - steps:
                raise AssertionError(
                    f"{name}: loaded {eng.loaded_checkpoint_tag} at step "
                    f"{eng.global_steps}, expected {want_tag} at "
                    f"{8 - steps}")
            got, ms, wait = run(eng, steps, name, counted)
            if got != losses[8 - steps:]:
                raise AssertionError(f"{name}: losses {got} != "
                                     f"{losses[8 - steps:]}")
            if seen != ref_seen[8 - steps:]:
                raise AssertionError(f"{name}: the batches differ from "
                                     "the uninterrupted run's")
            bad = [n for n, a, b in zip(eng.params, eng.params.values(),
                                        want_masters)
                   if not torch.equal(a, b)]
            if bad:
                raise AssertionError(f"{name}: masters differ: {bad[:5]}")
            resumed[name] = {"tag": want_tag, "load_ms": load_ms,
                             "losses": got, "step_ms": ms,
                             "input_host_wait_ms_per_step": wait,
                             "data_pipeline": pipeline}
            eng.finalize_monitoring()
            del eng
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    off = resumed["from-A"]
    rec = {"phase": "train-resume",
           "card": gpu_name_and_limit() if on_card else "cpu rehearsal",
           "config": f"gpt2 {size} ({cfg.num_layers} layers, d"
           f"{cfg.d_model}, vocab {cfg.vocab_size}), seq {seq}, micro 8, "
           "bf16, Adam lr 1e-4, WarmupLR 10, clipping 1.0, loss_impl "
           "pallas; training_data: 24 stride-stream sequences (3 batches "
           "an epoch, reshuffled per epoch), train_batch() with no "
           "iterator",
           "param_count": n_params,
           "losses": losses, "bitwise": True,
           "tag_bytes": {"A_sync": sync["ckpt.bytes"], "B_async": async_bytes},
           "save_stall_ms": {"sync": sync["ckpt.stall_ms"] / 1e3,
                             "async": async_stall_us / 1e3},
           "sync_save_wall_ms": sync_wall_ms,
           "async_flush_wait_ms": flush_ms,
           "step_ms_during_async_write": ms_async,
           "load_ms": {k: v["load_ms"] for k, v in resumed.items()},
           # steps 2.. of a run (its first step pays the warm-up)
           "step_ms_pipeline_on": float(np.mean(ms_on[1:])),
           "step_ms_pipeline_off": float(np.mean(off["step_ms"][1:])),
           "input_host_wait_ms_per_step": {
               "pipeline_on": wait_on,
               "pipeline_off": off["input_host_wait_ms_per_step"]},
           "launches": counted, "resumed": resumed}
    emit(rec)
    return rec


def phase_train_profile(eng, data, train, steps=2):
    """Two more steps under torch.profiler: device time by kernel class;
    the idle share divides the busy time per step by the timed steps'
    mean span on CUDA events, which the profiler does not stretch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.kernels import (flash, flash_sparse, fused_xent,
                                             moe_kernels)

    n0 = dict(flash.LAUNCHES)
    s0 = dict(flash_sparse.LAUNCHES)
    x0 = dict(fused_xent.LAUNCHES)
    m0 = dict(moe_kernels.LAUNCHES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        primed = prime_profiler()
        for _ in range(steps):
            eng.train_batch(data)
        torch.cuda.synchronize()
    acts = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    lost = primer_lost(primed, acts)
    acts = [a for a in acts if not is_primer(a[0])]
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
    sparse_calls = by_class.get("flash_sparse", (0.0, 0))[1]
    want = sum(flash_sparse.LAUNCHES[k] - s0[k] for k in s0)
    if sparse_calls != want:
        raise AssertionError(f"profiler saw {sparse_calls} sparse flash "
                             f"kernels, the wrappers launched {want}")
    moe_calls = by_class.get("moe", (0.0, 0))[1]
    want = sum(moe_kernels.LAUNCHES[k] - m0[k] for k in m0)
    if moe_calls != want:
        raise AssertionError(f"profiler saw {moe_calls} MoE kernels, the "
                             f"wrappers launched {want}")
    acts.sort(key=lambda a: -a[1])
    per_step = busy_ms / steps
    span_per_step = train["device_span_ms"] / train["timed_steps"]
    # int64 elementwise kernels: the dropout hash's uint32 arithmetic,
    # which the port runs as plain int64 PyTorch ops
    int64_ms = sum(ms for name, ms, _ in acts if "<long" in name)
    return {"phase": train["phase"] + "-profile", "steps": steps,
            "profiler_primer_lost": lost,
            "device_busy_ms_per_step": per_step,
            "int64_elementwise_ms_per_step": int64_ms / steps,
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


# -- blockwise codec kernels (#11, #12) and serving from quantized weights ---

CODEC_TOL = ("bitwise: payload bytes, fp16 scale bits and dequantized "
             "values equal, NaN compared by position")


def codec_edge_cases(n=4096, seed=3):
    """fp32 [n]: scaled normals with the codec's edge cases — fp32
    subnormals, +-inf, NaN, an all-zero block, a block whose amax is above
    qmax * 65504 and one below qmax * 2^-24, .5 ties; n is no multiple of
    256, so the last block is ragged."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(n) * 10.0).astype(np.float32)
    x[0] = 127.0                       # block 0: scale 1, .5 codes are ties
    x[20:40] = np.arange(-10, 10) + 0.5
    x[5], x[77], x[400] = np.inf, -np.inf, np.nan
    x[6], x[7] = 1e-40, -3e-39         # fp32 subnormals
    x[512:768] = 0.0                   # an all-zero block
    x[768] = 127 * 65504 * 2.0         # the block's fp16 scale overflows
    x[256:512] *= 1e-9                 # the block's fp16 scale underflows
    return x[:n - 37]


def mismatches(a, b):
    """Elements whose bits differ (NaN compared by position)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return a.numel() or 1
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        view = {2: torch.int16, 4: torch.int32}[a.element_size()]
        same = (na & nb) | (~na & ~nb & (a.view(view) == b.view(view)))
        return int((~same).sum())
    return int((a != b).sum())


def max_abs_diff(a, b):
    """max |a - b| over the finite positions; inf where one side is NaN
    and the other is not (NaN compared by position)."""
    import torch

    a, b = a.float(), b.float()
    na, nb = torch.isnan(a), torch.isnan(b)
    if bool((na != nb).any()):
        return float("inf")
    d = (a - b).abs()[~na]
    return float(d.max()) if d.numel() else 0.0


def codec_check(x, wire, block=256, out_dtype=None):
    """Kernels #11 and #12 against their plain versions on x: the count
    of payload, scale and dequantized elements whose bits differ, and the
    largest differences — for #11 between the values its codes and the
    plain codes stand for (both decoded by the plain version, fp32), for
    #12 between the two dequantized outputs."""
    import torch

    from deepspeed_tpu_torch.kernels import registry

    out_dtype = out_dtype or x.dtype
    pk, sk = registry.dispatch("quant_codec_quantize", x, block, wire,
                               impl="cuda")
    pp, sp = registry.dispatch("quant_codec_quantize", x, block, wire,
                               impl="torch")
    n = x.numel()

    def deq(p, s, impl, dt):
        return registry.dispatch("quant_codec_dequantize", p, s, wire, n,
                                 out_dtype=dt, impl=impl)

    yk, yp = deq(pp, sp, "cuda", out_dtype), deq(pp, sp, "torch", out_dtype)
    q_err = max_abs_diff(deq(pk, sk, "torch", torch.float32),
                         deq(pp, sp, "torch", torch.float32))
    return {"mismatches": mismatches(pk, pp) + mismatches(sk, sp) +
            mismatches(yk, yp),
            "quantize_max_abs_err": q_err,
            "dequantize_max_abs_err": max_abs_diff(yk, yp)}


def phase_codec():
    """#11 and #12 on the edge cases, int8 and int4, fp32 and bf16 input,
    blocks 256, 64 and 512 (the quantize's vector route) and 2 (its
    generic route); every mismatch count must be 0."""
    import torch

    from deepspeed_tpu_torch.kernels import quant_codec

    cases = []
    x32 = torch.from_numpy(codec_edge_cases()).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        for wire in ("int8", "int4"):
            for block in (256, 64, 512, 2):
                x = x32.to(dtype)
                route = quant_codec.quantize_route(x, block)
                if route != ("generic" if block == 2 else "vector"):
                    raise AssertionError(f"codec edge case at block {block}"
                                         f" takes the {route} route")
                for out_dtype in dict.fromkeys((torch.float32, dtype)):
                    m = codec_check(x, wire, block, out_dtype)
                    cases.append({"case": f"edge-{wire}-block{block}-"
                                  f"{str(dtype)[6:]}-to-{str(out_dtype)[6:]}",
                                  "route": route, **m})
    torch.cuda.synchronize()
    bad = [c for c in cases if c["mismatches"]]
    if bad:
        raise AssertionError(f"codec kernels differ from the plain versions "
                             f"on the edge cases: {bad}")
    rec = {"phase": "codec", "tol": CODEC_TOL, "cases": cases}
    emit(rec)
    return rec


# XL's matrix leaves by shape: (name, shape, leaves a model holds)
def xl_leaf_shapes(cfg):
    D, F, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    return [("wte", (cfg.vocab_size, D), 1), ("wpe", (cfg.max_seq_len, D), 1),
            ("attn.qkv.w", (D, 3 * D), L), ("attn.proj.w", (D, D), L),
            ("mlp.fc1.w", (D, F), L), ("mlp.fc2.w", (F, D), L)]


def codec_per_shape(model, flush):
    """Device times of #11 (int8) and #12 (int8 and int4, to bf16) on one
    leaf of each of XL's matrix shapes, L2 flushed before each call:
    `kernel_ms` on CUDA events around each call, as earlier runs recorded
    it, and `kernel_device_ms` the kernel's own device time under
    torch.profiler (`profiled_flushed_ms`), beside their plain versions'
    and their bounds (bytes: each input read once, each output written
    once), and the quantize's route; `count` says how many leaves of the
    shape a forward reads.  The whole tree's times are measured as spans
    in phase_serve_qw, not summed from these."""
    import torch

    from deepspeed_tpu_torch.kernels import quant_codec, registry

    params = dict(model.named_parameters())
    shapes = []
    for name, shape, count in xl_leaf_shapes(model.config):
        w = next(p for n, p in params.items() if n.endswith(name)).detach()
        n = w.numel()
        nb = -(-n // 256)
        rec = {"leaf": name, "shape": list(shape), "count": count,
               "quantize_route": quant_codec.quantize_route(w, 256)}
        for key, wire in (("quantize-int8", "int8"),
                          ("dequantize-int8", "int8"),
                          ("dequantize-int4", "int4")):
            p, s = registry.dispatch("quant_codec_quantize", w, 256, wire,
                                     impl="cuda")
            if key.startswith("quantize"):
                fn = lambda impl: registry.dispatch(  # noqa: E731
                    "quant_codec_quantize", w, 256, wire, impl=impl)
                nbytes = n * 2 + p.numel() + nb * 2
            else:
                fn = lambda impl: registry.dispatch(  # noqa: E731
                    "quant_codec_dequantize", p, s, wire, n,
                    out_dtype=torch.bfloat16, impl=impl)
                nbytes = p.numel() + nb * 2 + n * 2
            rec[key] = {"kernel_ms": time_ms(lambda: fn("cuda"), 10, flush),
                        "kernel_device_ms": profiled_flushed_ms(
                            lambda: fn("cuda"), flush),
                        "plain_ms": time_ms(lambda: fn("torch"), 3, flush),
                        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        shapes.append(rec)
    return shapes


def events_span_ms(fn):
    """CUDA events around one call of fn: the device span it enqueues,
    idle gaps between its launches included."""
    import torch

    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1)


def profiled_device_ms(fn):
    """fn under torch.profiler: one warm-up call before the window, then
    the call that is read, after the primer launches (so the tracer is
    running before the first kernel of the read call launches).  No
    schedule: late in a run, the turn from a schedule's warm-up step to
    its active step dropped far more of the active step's first kernel
    records than a new window does, and more the more kernels the warm-up
    step ran.  Returns (device
    ms of every kernel that call ran, device ms and count of the codec
    kernels #11/#12 among them, primer launches the profiler dropped)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        primed = prime_profiler()
        fn()
        torch.cuda.synchronize()
    acts = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    lost = primer_lost(primed, acts)
    acts = [a for a in acts if not is_primer(a[0])]
    if not acts:
        raise AssertionError("the profiler recorded no device activity")
    codec = [(ms, n) for name, ms, n in acts
             if kernel_class(name) == "quant_codec"]
    return (sum(ms for _, ms, _ in acts), sum(ms for ms, _ in codec),
            sum(n for _, n in codec), lost)


def codec_tree_times(leaves, store):
    """The whole tree's codec work, kernel against plain: the one-time
    quantize of every matrix leaf (int8) and one forward's dequantize of
    every leaf to its dtype (int8: the engine's `store`; int4), each as
    the device time torch.profiler reads (for the kernel, its own
    launches; for the plain version, every kernel it runs) and as the
    span of the calls back to back on CUDA events (host gaps included);
    bounds from the tree's bytes."""
    import torch

    from deepspeed_tpu_torch.kernels import registry
    from deepspeed_tpu_torch.serving import programs

    def quantize_all(impl):
        for w in leaves:
            registry.dispatch("quant_codec_quantize", w, programs.QUANT_BLOCK,
                              "int8", impl=impl)

    def dequantize_all(nodes, wire, impl):
        for q in nodes:
            registry.dispatch("quant_codec_dequantize", q.payload, q.scales,
                              wire, int(np.prod(q.shape)),
                              out_dtype=q.dtype, impl=impl)

    def timed(fn, nbytes):
        _, k_ms, k_calls, lost = profiled_device_ms(lambda: fn("cuda"))
        if k_calls != len(leaves):
            raise AssertionError(f"profiler saw {k_calls} codec kernels "
                                 f"over {len(leaves)} leaves")
        return {"kernel_ms": k_ms, "kernel_calls": k_calls,
                "profiler_primer_lost": lost,
                "plain_ms": profiled_device_ms(lambda: fn("torch"))[0],
                "kernel_span_ms": events_span_ms(lambda: fn("cuda")),
                "plain_span_ms": events_span_ms(lambda: fn("torch")),
                "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}

    n = sum(w.numel() for w in leaves)
    nb = sum(-(-w.numel() // programs.QUANT_BLOCK) for w in leaves)
    int8 = [q for q in store.leaves.values()
            if isinstance(q, programs.QuantLeaf)]
    int4 = list(programs.quantize_params(
        {str(i): w for i, w in enumerate(leaves)}, "int4").values())
    out = {"elements": n, "leaves": len(leaves),
           "quantize-int8": timed(lambda impl="cuda": quantize_all(impl),
                                  n * 2 + n + nb * 2)}
    for wire, nodes, payload in (("int8", int8, n), ("int4", int4, n // 2)):
        out[f"dequantize-{wire}"] = timed(
            lambda impl="cuda", nodes=nodes, wire=wire: dequantize_all(
                nodes, wire, impl), payload + nb * 2 + n * 2)
    del int4
    torch.cuda.empty_cache()
    return out


def phase_serve_qw_exact():
    """GPT-2 XL width, 4 layers, fp32: serving with quantized_weights int8
    and int4 gives, greedy, the tokens of the port's generate() run on
    dequantize(quantize(w)) — the dense model of the same values."""
    import torch

    from deepspeed_tpu_torch.models import GPT, generate, gpt2_config
    from deepspeed_tpu_torch.serving import ServeConfig, ServeEngine, programs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt2_config("xl", num_layers=4, param_dtype=torch.float32)
    model = GPT(cfg, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(1))
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 50257, (n,)).tolist() for n in (37, 150, 7, 64)]
    n_new = 16
    report = {}
    for wire in ("int8", "int4"):
        eng = ServeEngine(model, ServeConfig(
            block_size=16, num_blocks=65, max_batch=4, prefill_chunk=128,
            quantized_weights=wire), device="cuda")
        served = eng.generate(prompts, n_new)
        dense = programs.dequantize_params(eng.model.leaves, wire)
        ref = GPT(cfg, device="cuda")
        with torch.no_grad():
            for name, p in ref.named_parameters():
                p.copy_(dense[name])
        del dense, eng
        rows = []
        with torch.no_grad():
            for p, got in zip(prompts, served):
                want = generate(ref, [p], n_new, cache_len=cfg.max_seq_len,
                                device="cuda")[0].tolist()
                _, margins = greedy_with_margins(ref, p, n_new)
                div = next((i for i in range(n_new) if got[i] != want[i]),
                           None)
                if div is not None and not margins[div] < 1e-4:
                    raise AssertionError(
                        f"serve-qw-exact {wire}: served stream diverges from "
                        f"generate() on dequantize(quantize(w)) at step {div}"
                        f" where the oracle's top-2 margin is {margins[div]}")
                rows.append({"prompt_len": len(p), "identical": div is None,
                             "first_divergence": div,
                             "min_margin": min(margins)})
        report[wire] = rows
        del ref
    emit({"phase": "serve-qw-exact", "config": "gpt2 xl width, 4 layers, "
          "fp32, TF32 off, quantized_weights int8 / int4 (block 256)",
          "tokens_per_prompt": n_new, **report})
    del model
    torch.cuda.empty_cache()


def phase_serve_qw(model, serve, flush):
    """GPT-2 XL (the phase-5 model, bf16) served from int8 blockwise
    weights on phase 5's schedule and traffic (its prompt lengths, fresh
    tokens, half mid-flight, 64 new each).  Before it, #11 and #12 against
    their plain versions on every matrix leaf (int8 and int4, bitwise) and
    their device times per leaf shape; the engine's build quantizes each
    leaf once (194 launches, timed as one span), and every forward
    dequantizes each (launches counted from zero over the run: leaves x
    forwards).  Then the traffic again under torch.profiler (the idle
    share and #12's device time a forward), and last the tree's codec
    spans, kernel against plain."""
    import torch

    from deepspeed_tpu_torch.kernels import paged, quant_codec
    from deepspeed_tpu_torch.monitor.counters import COUNTERS
    from deepspeed_tpu_torch.serving import (FINISHED, ServeConfig,
                                             ServeEngine, programs)

    cfg = model.config
    leaves = [p.detach() for p in model.parameters() if p.dim() >= 2]
    leaf_checks = {w: [codec_check(p, w, out_dtype=p.dtype) for p in leaves]
                   for w in ("int8", "int4")}
    torch.cuda.synchronize()
    leaf_mismatch = {w: sum(c["mismatches"] for c in cs)
                     for w, cs in leaf_checks.items()}
    leaf_err = {key: max(c[key] for cs in leaf_checks.values() for c in cs)
                for key in ("quantize_max_abs_err", "dequantize_max_abs_err")}
    if any(leaf_mismatch.values()):
        raise AssertionError(f"codec kernels differ from the plain versions "
                             f"on the XL leaves: {leaf_mismatch}")
    per_shape = codec_per_shape(model, flush)
    quant_codec.reset_launches()
    scfg = ServeConfig(block_size=16, num_blocks=513, max_batch=8,
                       prefill_chunk=128, quantized_weights="int8")
    # #11 as the build runs it: events around the engine's quantize loop
    # (its kernels' device time is read in codec_tree_times)
    real_quantize_params, build_ms = programs.quantize_params, []

    def timed_quantize_params(*a, **kw):
        out = []
        build_ms.append(events_span_ms(
            lambda: out.append(real_quantize_params(*a, **kw))))
        return out[0]

    programs.quantize_params = timed_quantize_params
    try:
        eng = ServeEngine(model, scfg, device="cuda")
    finally:
        programs.quantize_params = real_quantize_params
    build_launches = dict(quant_codec.LAUNCHES)
    build_routes = dict(quant_codec.LAUNCHES_BY_ROUTE)
    if build_launches["quant_codec_quantize"] != len(leaves) or \
            build_routes != {"vector": len(leaves), "generic": 0}:
        raise AssertionError(f"the engine's build quantized "
                             f"{build_launches} leaves by route "
                             f"{build_routes}, expected {len(leaves)} on "
                             f"the vector route")
    eng.generate([list(range(50000, 50016))], 2)           # warm-up
    rs = np.random.RandomState(2)
    lens = serve["prompt_lens"]
    prompts = [rs.randint(0, 50257, (n,)).tolist() for n in lens]
    n_new = serve["max_new_tokens"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paged.reset_launches()
    quant_codec.reset_launches()
    snap = COUNTERS.snapshot()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    reqs, steps = drive(eng, prompts, n_new)
    ev1.record()
    ev1.synchronize()
    wall = time.perf_counter() - t0
    span_ms = ev0.elapsed_time(ev1)
    d = COUNTERS.delta_since(snap)
    launches = dict(quant_codec.LAUNCHES)
    if not all(r.state == FINISHED and len(r.out) == n_new for r in reqs):
        raise AssertionError("serve-qw: not every request finished")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.out):
        raise AssertionError("serve-qw: a served token is outside the "
                             "vocabulary")
    chunks = d["serve.prefill_chunks"]["calls"]
    n_decode = d["serve.decode_steps"]["calls"]
    fwd = chunks + n_decode
    if launches != {"quant_codec_quantize": 0,
                    "quant_codec_dequantize": len(leaves) * fwd} or \
            paged.LAUNCHES != cfg.num_layers * fwd or \
            paged.LAUNCHES_BY_KIND != {"decode": cfg.num_layers * n_decode,
                                       "verify": 0,
                                       "prefill": cfg.num_layers * chunks}:
        raise AssertionError(f"serve-qw: codec launches {launches}, paged "
                             f"{paged.LAUNCHES} ({paged.LAUNCHES_BY_KIND}) "
                             f"over {fwd} forwards")
    if d.get("kernel.fallbacks"):
        raise AssertionError(f"serve-qw: a plain version ran: {d}")
    decode_only = [ms for ms, pre in steps if not pre]
    ttft = sorted(r.ttft_s for r in reqs)
    n_tok = sum(len(r.out) for r in reqs)
    dense_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    rec = {"phase": "serve-qw", "config": "gpt2 xl, 48 layers, bf16, "
           "quantized_weights int8 (block 256), bf16 KV",
           "serve_config": {"block_size": 16, "num_blocks": 513,
                            "max_batch": 8, "prefill_chunk": 128},
           "prompt_lens": lens, "max_new_tokens": n_new,
           "requests": len(reqs), "tokens": n_tok, "wall_s": wall,
           "device_span_ms": span_ms, "tokens_per_s": n_tok / wall,
           "ttft_p50_ms": float(np.median(ttft)) * 1e3,
           "decode_step_mean_ms": float(np.mean(decode_only)),
           "decode_only_steps": len(decode_only), "prefill_chunks": chunks,
           "decode_steps": n_decode, "forwards": fwd,
           "quantize_launches_at_build": build_launches[
               "quant_codec_quantize"],
           "quantize_launches_at_build_by_route": build_routes,
           "dequantize_launches": launches["quant_codec_dequantize"],
           "dequantize_launches_per_forward":
               launches["quant_codec_dequantize"] / fwd,
           "paged_launches": paged.LAUNCHES,
           "paged_launches_by_kind": dict(paged.LAUNCHES_BY_KIND),
           "paged_launches_by_route": dict(paged.LAUNCHES_BY_ROUTE),
           "resident_weight_bytes": eng.model.nbytes(),
           "dense_weight_bytes_bf16": dense_bytes,
           "leaf_mismatches": leaf_mismatch, "leaf_max_abs_err": leaf_err,
           "quantize_build_ms": build_ms[0],
           "codec_per_shape_l2_flushed": per_shape,
           "peak_mem_bytes_incl_dense_model_held_by_the_script":
               torch.cuda.max_memory_allocated()}
    emit(rec)
    rs = np.random.RandomState(4)   # fresh tokens: no prefix-cache hit
    n0 = quant_codec.LAUNCHES["quant_codec_dequantize"]
    prof = profile_replay(
        eng, [rs.randint(0, 50257, (n,)).tolist() for n in lens], n_new,
        chunks, n_decode, span_ms, "serve-qw's traffic replayed on fresh "
        f"prompts: lengths {lens}, {n_new} new tokens each, gpt2 xl bf16, "
        "int8 weights")
    replayed = quant_codec.LAUNCHES["quant_codec_dequantize"] - n0
    if replayed != len(leaves) * fwd:
        raise AssertionError(f"the replay dequantized {replayed} leaves, "
                             f"expected {len(leaves) * fwd}")
    # the profiler may drop a few of a long window's activity records: the
    # device time a forward is scaled by the records it kept
    qc = prof["by_class"].get("quant_codec", {"ms": 0.0, "calls": 0})
    if not 0.99 * replayed <= qc["calls"] <= replayed:
        raise AssertionError(f"profiler saw {qc['calls']} codec kernels, "
                             f"the wrapper launched {replayed}")
    prof["dequantize_launches"] = replayed
    prof["dequantize_records_seen"] = qc["calls"]
    prof["dequantize_ms_per_forward"] = qc["ms"] / qc["calls"] * len(leaves)
    prof["phase"] = "serve-qw-profile"
    emit(prof)
    rec["profile"] = prof
    # after the counted runs: the tree's spans, kernel against plain
    rec["codec_tree"] = codec_tree_times(leaves, eng.model)
    emit({"phase": "serve-qw-codec-tree", **rec["codec_tree"]})
    del eng
    torch.cuda.empty_cache()
    return rec


# -- phase 8c: the fleet (replicas behind the router, worker threads,
#    tracing and SLO windows) and the chaos lane ----------------------------


class LaunchThreads:
    """While open, counts the paged kernel's launches by the thread that
    made them (the registry looks `paged.paged_attention_cuda` up at each
    call, so the wrapper sees every launch of the serving path)."""

    def __enter__(self):
        import threading

        from deepspeed_tpu_torch.kernels import paged

        self._paged, self._real = paged, paged.paged_attention_cuda
        self.by_thread, lock, real = {}, threading.Lock(), self._real
        main = threading.main_thread().ident

        def counted(*a, **kw):
            out = real(*a, **kw)
            key = ("main" if threading.get_ident() == main
                   else threading.get_ident())
            with lock:
                self.by_thread[key] = self.by_thread.get(key, 0) + 1
            return out

        paged.paged_attention_cuda = counted
        return self

    def __exit__(self, *exc):
        self._paged.paged_attention_cuda = self._real
        return False

    def check(self, workers, what):
        """Every launch came from `workers` distinct non-main threads (0:
        from the main thread alone)."""
        want = (len(self.by_thread) == workers and "main" not in
                self.by_thread) if workers else set(self.by_thread) == {
                    "main"}
        if not want:
            raise AssertionError(f"{what}: paged launches by thread "
                                 f"{self.by_thread}, expected {workers} "
                                 f"worker threads (0: the main one alone)")
        return sorted(self.by_thread.values())


def wait_done(reqs, what, timeout=600.0):
    t0 = time.monotonic()
    while not all(r.done for r in reqs):
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"{what}: requests not done after "
                                 f"{timeout} s: {[r.state for r in reqs]}")
        time.sleep(0.001)


def fleet_traffic(router, prompts, n_new, sessions, n_turn, what,
                  wait=lambda: time.sleep(0.001)):
    """Submit `prompts` and each session's first turn at once from this
    thread, each session's second turn (its first turn's prompt and output
    and its fresh tokens) the moment the first finishes; `wait()` between
    polls (a sleep while workers step the replicas, or `router.step_all`
    to step them on this thread).  -> (requests, first turns, second
    turns)."""
    reqs = [router.submit(p, n_new) for p in prompts]
    firsts = [router.submit(p, n_turn, session_id=f"s{i}")
              for i, (p, _) in enumerate(sessions)]
    seconds = [None] * len(sessions)
    t0 = time.monotonic()
    while True:
        for i, f in enumerate(firsts):
            if seconds[i] is None and f.done:
                seconds[i] = router.submit(f.prompt + f.out + sessions[i][1],
                                           n_turn, session_id=f"s{i}")
        if all(r.done for r in reqs + firsts) and \
                all(s is not None and s.done for s in seconds):
            return reqs, firsts, seconds
        if time.monotonic() - t0 > 600:
            raise AssertionError(f"{what}: traffic not done after 600 s")
        wait()


def check_sessions(firsts, seconds, what):
    """Each second turn landed on its first turn's replica and prefilled
    only its new tokens (the pin holds every row but the first turn's last
    token's)."""
    for f, s in zip(firsts, seconds):
        if s.replica != f.replica or \
                s.prefix_cached_tokens != len(f.prompt) + len(f.out) - 1:
            raise AssertionError(
                f"{what}: session turn on replica {s.replica} (first turn "
                f"{f.replica}) reused {s.prefix_cached_tokens} tokens of "
                f"{len(f.prompt) + len(f.out)}")


def check_paged_launches(d, num_layers, what):
    """Paged launches = layers x (prefill chunks + decode steps) over
    every replica, by kind too; every dispatch the kernel."""
    from deepspeed_tpu_torch.kernels import paged

    chunks = d["serve.prefill_chunks"]["calls"]
    n_decode = d["serve.decode_steps"]["calls"]
    by_kind = dict(paged.LAUNCHES_BY_KIND)
    if paged.LAUNCHES != num_layers * (chunks + n_decode) or by_kind != {
            "decode": num_layers * n_decode, "verify": 0,
            "prefill": num_layers * chunks}:
        raise AssertionError(
            f"{what}: paged kernel launched {paged.LAUNCHES} times "
            f"({by_kind}), expected {num_layers} x ({chunks} prefill chunks "
            f"+ {n_decode} decode steps)")
    if d.get("kernel.fallbacks") or \
            d["kernel.dispatches"]["calls"] != paged.LAUNCHES:
        raise AssertionError(f"{what}: registry counts disagree with the "
                             f"launches: {d}")
    return {"prefill_chunks": chunks, "decode_steps": n_decode,
            "paged_launches": paged.LAUNCHES,
            "paged_launches_by_kind": by_kind,
            "paged_launches_by_route": dict(paged.LAUNCHES_BY_ROUTE)}


def phase_fleet_exact():
    """GPT-2 nano in fp32 (phase_serve_nano_exact's model, TF32 off), two
    replicas from build_fleet behind FleetRouter.start(): each replica
    driven by its own ServeWorker thread, the traffic (the nano phase's
    four prompts and two two-turn sessions) submitted from this thread.
    Every greedy stream equals generate() on its whole prompt; a
    session's second turn lands on its first turn's replica and prefills
    only its new tokens; the paged launches, all from the two worker
    threads, are layers x (chunks + decode steps)."""
    import torch

    from deepspeed_tpu_torch.kernels import paged
    from deepspeed_tpu_torch.models import GPT, generate, gpt2_config
    from deepspeed_tpu_torch.monitor.counters import COUNTERS
    from deepspeed_tpu_torch.serving import (FINISHED, FleetRouter,
                                             ServeConfig, build_fleet)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt2_config("nano", param_dtype=torch.float32)
    model = GPT(cfg, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(2))
    rs = np.random.RandomState(6)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)).tolist()
               for n in (9, 33, 5, 60)]
    rs = np.random.RandomState(8)
    sessions = [(rs.randint(0, cfg.vocab_size, (n,)).tolist(),
                 rs.randint(0, cfg.vocab_size, (8,)).tolist())
                for n in (20, 41)]
    n_new = 16
    scfg = ServeConfig(block_size=16, num_blocks=40, max_batch=4,
                       prefill_chunk=32)

    def oracle(p):
        with torch.no_grad():
            want = generate(model, [p], n_new, cache_len=cfg.max_seq_len,
                            device="cuda")[0].tolist()
        return want, greedy_with_margins(model, p, n_new)[1]

    wants = [oracle(p) for p in prompts]
    first_wants = [oracle(p) for p, _ in sessions]
    second_wants = [oracle(p + w + fresh) for (p, fresh), (w, _) in
                    zip(sessions, first_wants)]
    what = "fleet-exact"
    router = FleetRouter(build_fleet(model, scfg, replicas=2, device="cuda"))
    paged.reset_launches()
    snap = COUNTERS.snapshot()
    with LaunchThreads() as lt:
        router.start()
        try:
            reqs, firsts, seconds = fleet_traffic(
                router, prompts, n_new, sessions, n_new, what)
        finally:
            router.close()
    d = COUNTERS.delta_since(snap)
    every = reqs + firsts + seconds
    if not all(r.state == FINISHED for r in every):
        raise AssertionError(f"{what}: {[r.state for r in every]}")
    div = [first_divergence(r.out, w, m, f"{what} stream {i}")
           for i, (r, (w, m)) in enumerate(
               zip(every, wants + first_wants + second_wants))]
    check_sessions(firsts, seconds, what)
    counts = check_paged_launches(d, cfg.num_layers, what)
    rec = {"phase": "fleet-exact", "config": "gpt2 nano (d 48, 3 heads of "
           "Dh 16, 3 layers), fp32 params and KV, TF32 off; 2 replicas, "
           "ServeConfig(block_size=16, num_blocks=40, max_batch=4, "
           "prefill_chunk=32), the default stream",
           "prompt_lens": [len(p) for p in prompts],
           "session_prompt_lens": [len(p) for p, _ in sessions],
           "tokens_per_request": n_new, "first_divergence": div,
           "replicas": [r.replica for r in every],
           "session_prefix_hit_tokens": d["kv.prefix_hit_tokens"]["bytes"],
           "launches_by_worker_thread": lt.check(2, what), **counts}
    emit(rec)
    del model
    torch.cuda.empty_cache()
    return rec


def fleet_idle_window(router, prompts, n_new, what,
                      wait=lambda: time.sleep(0.001)):
    """A short burst through the running fleet under torch.profiler
    (device activity only): the device's busy time over the window's
    wall, from the first submit to the last token on the host.  The
    profiler's own host cost stretches that wall a little, so the share
    errs high."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        primed = prime_profiler()
        t0 = time.perf_counter()
        reqs = [router.submit(p, n_new) for p in prompts]
        while not all(r.done for r in reqs):
            wait()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    p0 = time.perf_counter()
    acts = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    post_s = time.perf_counter() - p0
    lost = primer_lost(primed, acts)
    busy_ms = sum(a[1] for a in acts if not is_primer(a[0]))
    if busy_ms <= 0:
        raise AssertionError(f"{what}: the profiler recorded no device time")
    return {"requests": len(prompts), "new_tokens": n_new,
            "prompt_lens": [len(p) for p in prompts],
            "device_busy_ms": busy_ms, "profiled_wall_ms": wall_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "profiler_primer_lost": lost, "profiler_post_s": post_s}


def serve_fleet_traffic(serve):
    """phase 7's 8 prompts (checked against its record) and new tokens,
    and 4 two-turn sessions whose second turn adds 32 fresh tokens to the
    first's prompt and output, 32 new tokens a turn.  -> (prompts, n_new,
    sessions, n_turn)."""
    rs = np.random.RandomState(0)                # phase 7's traffic
    lens = rs.randint(16, 513, size=8)
    prompts = [rs.randint(0, 50257, (int(n),)).tolist() for n in lens]
    if [int(n) for n in lens] != serve["prompt_lens"]:
        raise AssertionError("serve-fleet: not phase 7's prompts")
    rs = np.random.RandomState(9)
    sessions = [(rs.randint(0, 50257, (int(n),)).tolist(),
                 rs.randint(0, 50257, (32,)).tolist())
                for n in rs.randint(64, 257, size=4)]
    return prompts, serve["max_new_tokens"], sessions, 32


def serve_fleet_run(model, traffic, replicas, tdir, drive="workers"):
    """One serve-fleet run: `replicas` engines with phase 7's ServeConfig
    sharing `model`, a TraceRecorder (sample_rate 1.0) and a ServingSLO
    (600 s window) on each, `traffic` (serve_fleet_traffic's) submitted
    from this thread.  `drive`: "workers" runs FleetRouter.start()'s
    ServeWorker threads; "main" steps the replicas in turn on this
    thread; a callable starts the router's stepping threads itself (the
    variants of chip_fleet_threads.py), its __name__ the run's label.  Checks: every request finishes with
    in-vocabulary tokens; paged launches = layers x (chunks + decode
    steps) over every replica, from the worker threads alone (the main
    one alone under "main"), no fallback; session turns stay on their
    replica; each SLO's nearest-rank TTFT p50 / p99 equal those of its
    replica's requests (3 decimals of a ms); the traces hold a
    decode_step per decode step and a first_token per request.  Then the
    idle share of a short profiled burst.  -> (record, router, engines),
    the router still running."""
    import resource

    import torch

    from deepspeed_tpu_torch.kernels import paged
    from deepspeed_tpu_torch.monitor.counters import COUNTERS
    from deepspeed_tpu_torch.monitor.tracing import (ServingSLO,
                                                     TraceRecorder,
                                                     percentile_nearest_rank,
                                                     read_trace_file)
    from deepspeed_tpu_torch.serving import (FINISHED, FleetRouter,
                                             ServeConfig, build_fleet)

    def nearest(ms, q):
        return round(percentile_nearest_rank(sorted(ms), q), 3)

    cfg = model.config
    prompts, n_new, sessions, n_turn = traffic
    threaded = drive != "main"
    label = drive if isinstance(drive, str) else drive.__name__
    what = (f"serve-fleet ({replicas} replica{'s' * (replicas > 1)}, "
            f"{label})")
    scfg = ServeConfig(block_size=16, num_blocks=513, max_batch=8,
                       prefill_chunk=128)
    engines = build_fleet(model, scfg, replicas=replicas, device="cuda",
                          prepared=model)
    router = FleetRouter(engines)
    if drive == "workers":
        router.start()
    elif threaded:
        drive(router)
    wait = {} if threaded else {"wait": router.step_all}
    # warm-up in the stepping threads (cuBLAS handles), unmeasured; its
    # tokens share no block with the traffic
    warm = [e.submit(list(range(50000, 50016)), 2) for e in engines]
    if not threaded:
        router.run()
    wait_done(warm, what)
    tracers = [TraceRecorder(tdir, rank=i, sample_rate=1.0,
                             flush_interval_s=1.0)
               for i in range(replicas)]
    slos = [ServingSLO(window_s=600.0, emit_interval_s=600.0)
            for _ in engines]
    for e, tr, slo in zip(engines, tracers, slos):
        e.attach_tracing(tracer=tr, slo=slo)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paged.reset_launches()
    snap = COUNTERS.snapshot()
    with LaunchThreads() as lt:
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        reqs, firsts, seconds = fleet_traffic(
            router, prompts, n_new, sessions, n_turn, what, **wait)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
    d = COUNTERS.delta_since(snap)
    peak = torch.cuda.max_memory_allocated()
    counts = check_paged_launches(d, cfg.num_layers, what)
    by_thread = lt.check(replicas if threaded else 0, what)
    every = reqs + firsts + seconds
    if not all(r.state == FINISHED and
               len(r.out) == r.max_new_tokens for r in every):
        raise AssertionError(f"{what}: not every request finished: "
                             f"{[(r.state, len(r.out)) for r in every]}")
    if not all(0 <= t < cfg.vocab_size for r in every for t in r.out):
        raise AssertionError(f"{what}: a served token is outside the "
                             f"vocabulary")
    check_sessions(firsts, seconds, what)
    slo_snaps = []
    for i, slo in enumerate(slos):
        mine = [r.ttft_s * 1e3 for r in every if r.replica == i]
        s = slo.snapshot()
        want = {"p50": nearest(mine, 50), "p99": nearest(mine, 99),
                "n": len(mine)}
        if s["ttft_ms"] != want:
            raise AssertionError(f"{what}: replica {i}'s SLO TTFT "
                                 f"{s['ttft_ms']}, its requests {want}")
        slo_snaps.append(s)
    for e in engines:
        e.attach_tracing(tracer=None, slo=None)
    for tr in tracers:
        tr.close()
    events = [e for i in range(replicas) for e in read_trace_file(
        os.path.join(tdir, f"trace.rank{i:05d}.jsonl"))[0][0][1]]
    names = [e["name"] for e in events]
    if names.count("decode_step") != counts["decode_steps"] or \
            names.count("first_token") != len(every):
        raise AssertionError(
            f"{what}: the traces hold {names.count('decode_step')} "
            f"decode_step and {names.count('first_token')} first_token "
            f"events; the counters {counts['decode_steps']} decode steps "
            f"and {len(every)} requests")
    decode_ms = [e["dur"] / 1e3 for e in events
                 if e["name"] == "decode_step"]
    idle = fleet_idle_window(
        router, [np.random.RandomState(20 + k).randint(
            0, 50257, (64,)).tolist() for k in range(4)], 8,
        f"{what} profiled window", **wait)
    ttft = [r.ttft_s * 1e3 for r in every]
    n_tok = sum(len(r.out) for r in every)
    rec = {"replicas": replicas,
           "drive": label,
           "requests": len(every),
           "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
           "ttft_p50_ms": nearest(ttft, 50),
           "ttft_p99_ms": nearest(ttft, 99),
           "decode_step_span_mean_ms": float(np.mean(decode_ms)),
           "slo_ttft_ms_by_replica": [s["ttft_ms"] for s in slo_snaps],
           "slo_tok_per_s_by_replica": [s["tok_per_s"] for s in slo_snaps],
           "requests_by_replica": [sum(r.replica == i for r in every)
                                   for i in range(replicas)],
           "trace_events": len(events),
           # the process's host CPU time over the run, every thread:
           # divided by the wall, the cores the host kept busy
           "host_cpu_s": (ru1.ru_utime - ru0.ru_utime +
                          ru1.ru_stime - ru0.ru_stime),
           "launches_by_worker_thread": by_thread,
           "peak_mem_bytes": peak,
           "kv_pool_bytes": [e.kv.nbytes() for e in engines],
           "session_prefix_hit_tokens": d["kv.prefix_hit_tokens"]["bytes"],
           "idle_window": idle, **counts}
    return rec, router, engines


def phase_serve_fleet(model, serve, serve_idle_share):
    """GPT-2 XL bf16 at full width (phase 7's model), two replicas sharing
    the model, each with phase 7's ServeConfig and its own KV pool, behind
    FleetRouter.start() (a ServeWorker each, the default stream), driven
    by serve_fleet_run with phase 7's traffic and 4 two-turn sessions.
    Then a burst at queue_limit 2 (spills and sheds: each shed request in
    state error, never enqueued), and the same traffic, telemetry and
    checks through one replica.  (chip_fleet_threads.py compares these
    with the replicas stepped on one thread and on a stream each.)"""
    import shutil
    import tempfile

    import torch

    from deepspeed_tpu_torch.monitor.counters import COUNTERS
    from deepspeed_tpu_torch.serving import ERROR, FINISHED, FleetRouter

    traffic = serve_fleet_traffic(serve)
    tmp = tempfile.mkdtemp(prefix="serve-fleet-")
    try:
        fleet, router, engines = serve_fleet_run(
            model, traffic, 2, os.path.join(tmp, "r2"))
        router.close()
        # the burst: replica 1 holds live blocks, so replica 0 is the
        # least-loaded pick until its queue of 2 is full; then spills to
        # replica 1 until its queue is full too; then sheds
        burst = FleetRouter(engines, queue_limit=2)
        rs = np.random.RandomState(30)
        busy = engines[1].submit(rs.randint(0, 50257, (200,)).tolist(), 8)
        engines[1].step()
        snap = COUNTERS.snapshot()
        reqs = [burst.submit(rs.randint(0, 50257, (40,)).tolist(), 4)
                for _ in range(6)]
        d = COUNTERS.delta_since(snap)
        shed = [r for r in reqs if r.state == ERROR]
        queued = {id(r) for e in engines for r in e.scheduler.requests}
        if not (d.get("router.spills", {}).get("calls", 0) > 0 and
                d.get("router.shed", {}).get("calls", 0) == len(shed) > 0) \
                or any(getattr(r, "replica", None) is not None or
                       id(r) in queued for r in shed):
            raise AssertionError(f"serve-fleet burst: {d}, "
                                 f"{[r.state for r in reqs]}")
        burst.start()
        live = [busy] + [r for r in reqs if r.state != ERROR]
        wait_done(live, "serve-fleet burst")
        burst.close()
        if not all(r.state == FINISHED for r in live):
            raise AssertionError("serve-fleet burst: a queued request "
                                 "failed")
        fleet["burst"] = {"queue_limit": 2, "requests": len(reqs),
                          "replicas": [getattr(r, "replica", None)
                                       for r in reqs],
                          "spills": d["router.spills"]["calls"],
                          "shed": d["router.shed"]["calls"],
                          "dispatches": d["router.dispatches"]["calls"]}
        del router, engines, burst
        gc.collect()
        torch.cuda.empty_cache()
        one, router, engines = serve_fleet_run(model, traffic, 1,
                                               os.path.join(tmp, "r1"))
        router.close()
        del router, engines
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _, n_new, sessions, n_turn = traffic
    rec = {"phase": "serve-fleet", "config": "gpt2 xl, 48 layers, bf16 "
           "params and KV, 2 replicas sharing the model, the default stream",
           "serve_config": {"block_size": 16, "num_blocks": 513,
                            "max_batch": 8, "prefill_chunk": 128},
           "prompt_lens": serve["prompt_lens"], "max_new_tokens": n_new,
           "session_prompt_lens": [len(p) for p, _ in sessions],
           "session_new_tokens_a_turn": n_turn,
           "fleet": fleet, "one_replica": one,
           "serve_one_engine": {k: serve[k] for k in (
               "tokens_per_s", "ttft_p50_ms", "decode_step_mean_ms",
               "peak_mem_bytes", "kv_pool_bytes")},
           "serve_one_engine_idle_share": serve_idle_share,
           "paged_launches": fleet["paged_launches"],
           "paged_launches_by_kind": fleet["paged_launches_by_kind"],
           "paged_launches_by_route": fleet["paged_launches_by_route"]}
    emit(rec)
    return rec


def phase_serve_chaos(model):
    """The chaos lane (JAX tools/serve_bench.py `run_dry_chaos`) on the
    card at GPT-2 XL width: one replica (bf16, max_batch 2) driven by a
    ServeWorker, a FaultPlan that hangs the third decode call for 1.5 s,
    a StepWatchdog (0.5 s deadline) whose on_trip sheds.  Checks: exactly
    one trip; the wedged batch shed (serve.shed = its size, its blocks in
    kv.evictions); the requests that waited finish with the tokens they
    get served alone; the trip file and snapshot written, the snapshot
    carrying the tracer's tail and the serving thread group; the plan
    uninstalled after."""
    import json as _json
    import shutil
    import tempfile

    import torch

    from deepspeed_tpu_torch.kernels import paged
    from deepspeed_tpu_torch.monitor.counters import COUNTERS
    from deepspeed_tpu_torch.monitor.tracing import TraceRecorder
    from deepspeed_tpu_torch.runtime import resilience
    from deepspeed_tpu_torch.serving import (ERROR, ServeConfig,
                                             ServeEngine, ServeWorker)

    cfg = model.config
    scfg = ServeConfig(block_size=16, num_blocks=129, max_batch=2,
                       prefill_chunk=128)
    rs = np.random.RandomState(10)
    prompts = [rs.randint(0, 50257, (n,)).tolist() for n in (40, 70, 33, 90)]
    n_new = 6
    oracle = ServeEngine(model, scfg, device="cuda", prepared=model)
    want = [oracle.generate([p], n_new)[0] for p in prompts[2:]]
    del oracle
    tmp = tempfile.mkdtemp(prefix="serve-chaos-")
    eng = ServeEngine(model, scfg, device="cuda", prepared=model)
    rec_tr = TraceRecorder(tmp, flush_interval_s=1.0)
    eng.attach_tracing(tracer=rec_tr)
    held = []

    def on_trip(trip):
        held.append(eng.kv.blocks_in_use)
        eng.request_shed(trip["reason"])

    wd = resilience.StepWatchdog(deadline_s=0.5, snapshot_dir=tmp,
                                 poll_s=0.05, on_trip=on_trip)
    eng.attach_watchdog(wd)
    worker = ServeWorker(eng)
    worker.start()
    plan = resilience.FaultPlan([resilience.FaultRule(
        site="serve.decode", kind="hang", hang_s=1.5, calls=[2])], seed=0)
    try:
        wait_done([eng.submit(list(range(50000, 50016)), 2)],
                  "serve-chaos warm-up")
        paged.reset_launches()
        snap = COUNTERS.snapshot()
        resilience.install_fault_plan(plan)
        t0 = time.perf_counter()
        with LaunchThreads() as lt:
            try:
                r01 = [eng.submit(p, n_new) for p in prompts[:2]]
                wait_done(r01, "serve-chaos wedged batch")
                r23 = [eng.submit(p, n_new) for p in prompts[2:]]
                wait_done(r23, "serve-chaos survivors")
            finally:
                resilience.install_fault_plan(None)
        wall = time.perf_counter() - t0
        d = COUNTERS.delta_since(snap)
        eng.close()
        wd.stop()
        rec_tr.close()
        trip = resilience.read_watchdog_trip(tmp)
        snapshot = None
        if trip is not None and trip.get("snapshot"):
            with open(trip["snapshot"]) as f:
                snapshot = _json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    shed_calls = d.get("serve.shed", {}).get("calls", 0)
    evicted = d.get("kv.evictions", {}).get("calls", 0)
    problems = []
    if wd.trips != 1 or d.get("watchdog.trips", {}).get("calls") != 1:
        problems.append(f"{wd.trips} trips")
    if [r.state for r in r01] != [ERROR, ERROR] or shed_calls != 2:
        problems.append(f"wedged batch {[r.state for r in r01]}, "
                        f"serve.shed {shed_calls}")
    if len(held) != 1 or evicted != held[0] or not evicted:
        problems.append(f"kv.evictions {evicted}, blocks held at the trip "
                        f"{held}")
    if [r.out for r in r23] != want:
        problems.append("the survivors' tokens differ from alone")
    if plan.injection_log != [{"site": "serve.decode", "kind": "hang",
                               "rule": 0, "rank": 0, "step": 0,
                               "call": 2}] or \
            resilience.active_plan() is not None:
        problems.append(f"injections {plan.injection_log}")
    if trip is None or snapshot is None or not snapshot.get("trace_tail") \
            or [t["alive"] for t in
                snapshot["thread_groups"].get("serving", [])] != [True]:
        problems.append(f"trip file {trip}, snapshot keys "
                        f"{sorted(snapshot or {})}")
    if problems:
        raise AssertionError(f"serve-chaos: {problems}")
    counts = check_paged_launches(d, cfg.num_layers, "serve-chaos")
    rec = {"phase": "serve-chaos", "config": "gpt2 xl, 48 layers, bf16, one "
           "replica, ServeConfig(block_size=16, num_blocks=129, "
           "max_batch=2, prefill_chunk=128), a ServeWorker",
           "fault_rule": plan.rules[0].describe(), "hang_s": 1.5,
           "watchdog_deadline_s": 0.5, "trips": wd.trips,
           "trip_reason": trip["reason"], "stalled_s": trip["stalled_s"],
           "shed": shed_calls, "blocks_evicted": evicted,
           "survivors_equal_alone": True, "wall_s": wall,
           "trace_tail_events": len(snapshot["trace_tail"]),
           "launches_by_worker_thread": lt.check(1, "serve-chaos"),
           **counts}
    emit(rec)
    torch.cuda.empty_cache()
    return rec


# -- MoE dispatch and combine kernels (#13, #14) --------------------------------

MOE_TOL = ("dispatch: bitwise (a row copy); combine: per element "
           "(3u + 2^-22) sum_r |w_r e_r|, one ulp of the output per term "
           "(moe/dispatch.py combine_tolerance)")


def moe_case(name, B, S, E, k, factor, D, dtype, gen, flush, timed):
    """Kernels #13 and #14 against their plain versions on routing drawn
    from random gate logits; device times where `timed`, beside the bound
    (this draw's bytes: kept rows read, every slot or token row written)
    and, for the dispatch, one torch.index_select over x with a zero row
    appended (a yardstick the port never calls): `kernel_ms` /
    `library_ms` on CUDA events around each call, `kernel_device_ms` /
    `library_device_ms` their own device time under torch.profiler
    (`profiled_flushed_ms`); and the combine's gate gradient
    (`dsp.combine_gate_grad`) both ways."""
    import torch

    from deepspeed_tpu_torch.kernels import registry
    from deepspeed_tpu_torch.moe import dispatch as dsp

    dev = "cuda"
    C = max(int(np.ceil(factor * S * k / E - 1e-9)), 4)
    logits = torch.randn(B, S, E, device=dev, generator=gen)
    eidx, gate, pos, keep, _ = dsp.topk_routing(torch.softmax(logits, -1),
                                                k, C)
    x = torch.randn(B, S, D, device=dev, generator=gen).to(dtype)
    out = torch.randn(B, E, C, D, device=dev, generator=gen).to(dtype)

    def disp(impl):
        return registry.dispatch("moe_dispatch", x, eidx, pos, keep, E, C,
                                 impl=impl)

    def comb(impl):
        return registry.dispatch("moe_combine", out, eidx, gate, pos, keep,
                                 impl=impl)

    dk, dp = disp("cuda"), disp("torch")
    ck, cp = comb("cuda"), comb("torch")
    torch.cuda.synchronize()
    d_mis = mismatches(dk, dp)
    tol = dsp.combine_tolerance(out, eidx, gate, pos, keep)
    c_err = (ck.float() - cp.float()).abs()
    # a token whose every assignment dropped has bound 0 and must be 0
    c_ratio = float(torch.where(tol > 0, c_err / tol.clamp_min(1e-30),
                                torch.where(c_err > 0, np.inf, 0.0)).max())
    if d_mis or not c_ratio <= 1.0:
        raise AssertionError(f"moe {name}: dispatch mismatches {d_mis}, "
                             f"combine {c_ratio} x its bound")
    isz = x.element_size()
    kept = int(keep.sum())
    route = B * k * S * (4 + 4 + 1)
    work = {"moe_dispatch": kept * D * isz + route + B * E * C * D * isz,
            "moe_combine": kept * D * isz + route + B * k * S * 4 +
            B * S * D * isz}
    rec = {"phase": "moe-kernels", "case": name, "B": B, "S": S, "E": E,
           "k": k, "capacity": C, "D": D, "dtype": str(dtype)[6:],
           "kept_assignments": kept, "assignments": B * k * S,
           "tol": MOE_TOL, "dispatch_mismatches": d_mis,
           "max_abs_err": {"moe_dispatch": float((dk.float() - dp.float())
                                                 .abs().max()),
                           "moe_combine": float(c_err.max())},
           "combine_max_err_over_tol": c_ratio, "kernels": {}}
    for kname, nbytes in work.items():
        r = {"bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "bound_by": "bytes", "library_ms": None}
        if timed:
            fn = disp if kname == "moe_dispatch" else comb
            r["kernel_ms"] = time_ms(lambda: fn("cuda"), 20, flush)
            r["kernel_device_ms"] = profiled_flushed_ms(lambda: fn("cuda"),
                                                        flush)
            r["plain_ms"] = time_ms(lambda: fn("torch"), 5, flush)
        rec["kernels"][kname] = r
    if timed:
        # the yardstick: the same gather as one index_select
        dest = torch.where(keep, eidx.long() * C + pos.long(), E * C)
        tok = torch.arange(S, device=dev).repeat(k)[None].expand(B, -1)
        src = tok + torch.arange(B, device=dev)[:, None] * S
        flat = torch.full((B, E * C + 1), B * S, dtype=torch.long, device=dev)
        flat.scatter_(1, dest.reshape(B, -1), src)
        slot_tok = flat[:, :E * C].reshape(-1)
        xz = torch.cat([x.reshape(B * S, D), x.new_zeros(1, D)])
        lib = torch.index_select(xz, 0, slot_tok).reshape(B, E, C, D)
        if not torch.equal(lib, dk):
            raise AssertionError(f"moe {name}: the index_select yardstick "
                                 f"computes another gather")
        rec["kernels"]["moe_dispatch"]["library_ms"] = time_ms(
            lambda: torch.index_select(xz, 0, slot_tok), 20, flush)
        rec["kernels"]["moe_dispatch"]["library_device_ms"] = \
            profiled_flushed_ms(lambda: torch.index_select(xz, 0, slot_tok),
                                flush)
        # #13's device operations a call: one kernel, no memset
        split = device_split(lambda: disp("cuda"))
        rec["kernels"]["moe_dispatch"]["profile"] = split
        if split["device_ops_per_call"] != 1 or split["memsets_per_call"]:
            raise AssertionError(f"moe {name}: the dispatch made "
                                 f"{split['device_ops_per_call']} device "
                                 f"operations a call: {split['ops']}")
        # #14's yardstick: one embedding_bag over the buckets with a zero
        # row appended, the T-rounded gate * keep as per-sample weights,
        # held to the plain combine's bound before it is timed
        flat = torch.cat([out.reshape(B * E * C, D), out.new_zeros(1, D)])
        src = torch.where(keep, eidx.long() * C + pos.long()
                          + torch.arange(B, device=dev)[:, None, None] * E * C,
                          B * E * C).permute(0, 2, 1).reshape(-1)
        w = dsp._weights(gate, keep, dtype).permute(0, 2, 1).reshape(-1)
        offs = torch.arange(0, B * S * k, k, device=dev)

        def bag():
            return torch.nn.functional.embedding_bag(
                src, flat, offs, mode="sum", per_sample_weights=w)

        lb = bag().reshape(B, S, D)
        lb_err = (lb.float() - cp.float()).abs()
        lb_ratio = float(torch.where(tol > 0, lb_err / tol.clamp_min(1e-30),
                                     torch.where(lb_err > 0, np.inf,
                                                 0.0)).max())
        rec["kernels"]["moe_combine"]["library_max_err_over_tol"] = lb_ratio
        if not lb_ratio <= 1.0:
            raise AssertionError(f"moe {name}: the embedding_bag yardstick "
                                 f"is {lb_ratio} x the combine's bound")
        rec["kernels"]["moe_combine"]["library_ms"] = time_ms(bag, 20, flush)
        rec["kernels"]["moe_combine"]["library_device_ms"] = \
            profiled_flushed_ms(bag, flush)
        # the combine's gradient in the gate (plain PyTorch, no kernel of
        # its own) on an upstream gradient of y's shape, beside #14
        gy = torch.randn(B, S, D, device=dev, generator=gen).to(dtype)
        rec["gate_grad"] = {
            "ms": time_ms(lambda: dsp.combine_gate_grad(
                out, eidx, gate, pos, keep, gy), 20, flush),
            "device_ms": profiled_flushed_ms(lambda: dsp.combine_gate_grad(
                out, eidx, gate, pos, keep, gy), flush)}
    emit(rec)
    return rec


def device_split(fn, calls=20):
    """fn's device operations under torch.profiler over `calls` calls
    (after one call outside the window and the window's primer launches):
    per call, the count and device us of its kernels and of its memsets /
    copies, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        primed = prime_profiler()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    acts = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    lost = primer_lost(primed, acts)
    ops = {}
    for name, ms, n in acts:
        if is_primer(name):
            continue
        low = name.lower()
        kind = ("memset" if "memset" in low else
                "copy" if "memcpy" in low else "kernel")
        ops[name] = {"kind": kind, "per_call": n / calls,
                     "us_per_call": ms * 1e3 / calls}
    if not ops:
        raise AssertionError("the profiler recorded no device activity")
    return {"calls": calls, "profiler_primer_lost": lost,
            "device_ops_per_call": sum(o["per_call"] for o in ops.values()),
            "kernels_per_call": sum(o["per_call"] for o in ops.values()
                                    if o["kind"] == "kernel"),
            "memsets_per_call": sum(o["per_call"] for o in ops.values()
                                    if o["kind"] == "memset"),
            "device_us_per_call": sum(o["us_per_call"]
                                      for o in ops.values()),
            "ops": ops}


def phase_moe_kernels(gen, flush):
    import torch

    bf16 = torch.bfloat16
    return [moe_case("train-k1-bfloat16", 4, 2048, 64, 1, 1.0, 768, bf16,
                     gen, flush, True),
            moe_case("train-k2-bfloat16", 4, 2048, 64, 2, 1.0, 768, bf16,
                     gen, flush, True),
            moe_case("exact-float32", 4, 256, 64, 1, 1.0, 768,
                     torch.float32, gen, flush, False),
            moe_case("tight-k2-float16-d100", 2, 256, 8, 2, 0.5, 100,
                     torch.float16, gen, flush, False),
            # top-4, and capacity factor 0.25: whole tokens dropped, which
            # the combine must write as exact zeros (their bound is 0)
            moe_case("k4-bfloat16", 2, 256, 8, 4, 1.0, 768, bf16, gen, flush,
                     False),
            moe_case("dropped-k2-bfloat16", 4, 2048, 64, 2, 0.25, 768, bf16,
                     gen, flush, False)]


MOE_MODEL = dict(num_experts=64, moe_top_k=1, moe_layer_freq=2,
                 moe_capacity_factor=1.0, moe_aux_loss_weight=0.01)


def moe_train_config(micro, lr, precision, dispatch, dropless=False):
    cfg = train_config(micro, lr, precision)
    cfg["comm"] = {"moe": {"dispatch": dispatch}}
    if dropless:
        cfg["comm"]["moe"].update(dropless=True, overflow_factor=1.0)
    return cfg


def phase_moe_exact():
    """fp32, TF32 off, GPT-2 small width with 64 experts on layer 1 of 2
    (top-1, capacity factor 1.0), seq 256, micro 4, 5 engine steps from the
    same weights and gate noise: the sorted engine through kernels #13/#14
    against the same engine with their plain versions forced (per-step
    loss within 1e-4, weights within 2 lr steps), and against the dense
    one-hot engine (per-step loss within 1e-5, the JAX package's own
    contract, tests/test_moe_dispatch.py:468)."""
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.kernels import moe_kernels, registry
    from deepspeed_tpu_torch.models import GPT, gpt2_config
    from deepspeed_tpu_torch.moe import dispatch as dsp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr, steps, micro, seq = 1e-4, 5, 4, 256
    real_dispatch = registry.dispatch

    def plain_moe(name, *a, impl="auto", **kw):
        if name in ("moe_dispatch", "moe_combine"):
            impl = "torch"
        return real_dispatch(name, *a, impl=impl, **kw)

    runs = {}
    for run, dispatch, plain in (("kernel", "sorted", False),
                                 ("plain", "sorted", True),
                                 ("dense", "dense", False)):
        cfg = gpt2_config("small", num_layers=2, max_seq_len=seq, **MOE_MODEL)
        model = GPT(cfg, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
        eng, *_ = dt.initialize(model=model, config_params=moe_train_config(
            micro, lr, "fp32", dispatch))
        n0 = dict(moe_kernels.LAUNCHES)
        registry.dispatch = plain_moe if plain else real_dispatch
        try:
            losses = []
            for x, y in stride_batches(steps, micro, seq, 64, 5):
                losses.append(float(eng.forward((x, y))))
                eng.backward()
                eng.step()
        finally:
            registry.dispatch = real_dispatch
        runs[run] = (losses, {n: p.detach().clone()
                              for n, p in eng.params.items()},
                     {k: moe_kernels.LAUNCHES[k] - n0[k] for k in n0})
        del eng, model
        dsp.set_wire_config(dsp.MoEWireConfig())
        gc.collect()
        torch.cuda.empty_cache()
    (lk, pk, nk), (lp, pp, npl), (ld, _, nd) = (runs[r] for r in
                                               ("kernel", "plain", "dense"))
    # one MoE layer: a dispatch and a combine forward, one of each backward
    if nk != {"moe_dispatch": 2 * steps, "moe_combine": 2 * steps} or \
            any(npl.values()) or any(nd.values()):
        raise AssertionError(f"moe-exact: kernels launched {nk} (kernel "
                             f"run), {npl} (plain), {nd} (dense)")
    loss_err = max(abs(a - b) for a, b in zip(lk, lp))
    w_err = max((pk[n] - pp[n]).abs().max().item() for n in pk)
    dense_err = max(abs(a - b) for a, b in zip(lk, ld))
    if not (loss_err <= 1e-4 and w_err <= 2 * lr * steps and
            dense_err <= 1e-5):
        raise AssertionError(f"moe-exact: kernel vs plain losses differ by "
                             f"{loss_err}, weights by {w_err}; sorted vs "
                             f"dense losses by {dense_err}")
    emit({"phase": "moe-exact", "config": "gpt2 small width, 2 layers "
          "(layer 1: 64 experts, top-1, capacity factor 1.0), seq 256, "
          "micro 4, fp32, TF32 off", "steps": steps,
          "launches_kernel_run": nk, "losses_kernel": lk,
          "losses_plain": lp, "losses_dense": ld,
          "max_loss_diff_kernel_vs_plain": loss_err, "loss_tol": 1e-4,
          "max_weight_diff": w_err, "weight_tol": 2 * lr * steps,
          "max_loss_diff_sorted_vs_dense": dense_err, "dense_tol": 1e-5})


def phase_train_moe(warmup=3, steps=10, dropless=False):
    """DeepSpeed-MoE's 125M+MoE-64 GPT recipe
    (Megatron-DeepSpeed examples_deepspeed/MoE/ds_pretrain_gpt_125M_MoE64.sh):
    12 layers, d768, 12 heads, d_ff 3072, vocab 50304, 64 experts on every
    other layer (six MoE layers), top-1, capacity factor 1.0, min capacity
    4, aux weight 0.01; seq 2048, micro 4, bf16 with fp32 masters, Adam,
    the fused CE, comm.moe dispatch "sorted", on a Zipf token stream over
    the whole vocabulary (`vocab_batches`).  The gate noise is the JAX
    package's default (noisy_gate_std 1e-2), which the recipe does not
    use.  `dropless`: train-moe-dropless, the same with `comm.moe.dropless`
    and overflow factor 1.0 — the overflow bucket through #13/#14 as well
    (launched as often again, over one expert's bucket), nothing dropped
    at any step; its dropped-share-by-stream probe is left out."""
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.kernels import flash, fused_xent, moe_kernels
    from deepspeed_tpu_torch.models import GPT, gpt2_config
    from deepspeed_tpu_torch.moe import dispatch as dsp
    from deepspeed_tpu_torch.moe.layer import MoE
    from deepspeed_tpu_torch.monitor.counters import COUNTERS

    micro, seq = 4, 2048
    cfg = gpt2_config("small", max_seq_len=seq, loss_impl="pallas",
                      **MOE_MODEL)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    model = GPT(cfg, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(0))
    eng, *_ = dt.initialize(model=model, config_params=moe_train_config(
        micro, 1e-4, "bf16", "sorted", dropless))
    data = vocab_batches(warmup + steps + 2, micro, seq, cfg.vocab_size, 0)
    losses = [float(eng.train_batch(data)) for _ in range(warmup)]
    torch.cuda.synchronize()
    dsp.flush_dispatch_stats(wait=True)
    torch.cuda.reset_peak_memory_stats()
    for counts in (flash.LAUNCHES, fused_xent.LAUNCHES):
        for k in counts:
            counts[k] = 0
    moe_kernels.reset_launches()
    snap = COUNTERS.snapshot()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    step_ms, timed, dropped_by_step = [], [], []
    ev0.record()
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = eng.train_batch(data)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        timed.append(loss)
        if dropless:
            # each step's dropped count (a host read, after the timing)
            s0 = COUNTERS.snapshot()
            dsp.flush_dispatch_stats(wait=True)
            dropped_by_step.append(COUNTERS.delta_since(s0).get(
                "moe.dropped_tokens", {"bytes": 0})["bytes"])
    ev1.record()
    ev1.synchronize()
    span_ms = ev0.elapsed_time(ev1)
    dsp.flush_dispatch_stats(wait=True)
    d = COUNTERS.delta_since(snap)
    losses += [float(x) for x in timed]
    launches = {"flash": dict(flash.LAUNCHES),
                "fused_xent": dict(fused_xent.LAUNCHES),
                "moe": dict(moe_kernels.LAUNCHES),
                "moe_overflow": dict(moe_kernels.LAUNCHES_ONE_EXPERT)}
    # forward: one dispatch and one combine per MoE layer; backward: the
    # combine's gradient is a dispatch, the dispatch's a combine; dropless
    # runs the same again over the overflow bucket
    passes = 2 if dropless else 1
    want_moe = {k: 2 * passes * n_moe * steps for k in moe_kernels.LAUNCHES}
    want_ov = {k: 2 * n_moe * steps if dropless else 0
               for k in moe_kernels.LAUNCHES}
    if launches["moe"] != want_moe or launches["moe_overflow"] != want_ov or \
            launches["flash"] != {k: cfg.num_layers * steps
                                  for k in flash.LAUNCHES} or \
            launches["fused_xent"] != {k: steps for k in fused_xent.LAUNCHES}:
        raise AssertionError(f"train-moe launches {launches}, expected moe "
                             f"{want_moe}")
    if d.get("kernel.fallbacks"):
        raise AssertionError(f"train-moe: a plain version ran: {d}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train-moe losses not finite and falling: "
                             f"{losses}")
    assignments = micro * seq * cfg.moe_top_k * n_moe * steps
    dropped = d["moe.dropped_tokens"]["bytes"]
    tokens = micro * seq * steps
    if dropless and (dropped or any(dropped_by_step)):
        raise AssertionError(f"train-moe-dropless dropped {dropped_by_step} "
                             f"assignments by step")
    # does the data set the routing?  Two more steps on each stream —
    # this run's, uniform over the vocabulary, and the dense phases'
    # stride stream over 64 ids — with the dropped share, and at every
    # MoE layer the router input's shared part (|mean_t x_t|^2 over
    # mean_t |x_t|^2 within a group: 0 for independent tokens, 1 when all
    # are one vector) and the experts the noiseless top-1 picks a group
    real_call, seen = MoE.__call__, []

    def spy(self, params, x, *a, **kw):
        with torch.no_grad():
            xf = x.float()
            shared = (xf.mean(1).square().sum(-1) /
                      xf.square().sum(-1).mean(1))
            top = (xf @ params.gate.w.float()).argmax(-1)
            seen.append((float(shared.mean()),
                         float(np.mean([len(torch.unique(t)) for t in top]))))
        return real_call(self, params, x, *a, **kw)

    by_stream = {}
    MoE.__call__ = spy
    try:
        for name, stream in () if dropless else (
                ("zipf", vocab_batches(2, micro, seq, cfg.vocab_size, 7)),
                ("uniform", vocab_batches(2, micro, seq, cfg.vocab_size, 7,
                                          "uniform")),
                ("stride64", stride_batches(2, micro, seq, 64, 7))):
            snap2 = COUNTERS.snapshot()
            seen.clear()
            for _ in range(2):
                eng.train_batch(stream)
            dsp.flush_dispatch_stats(wait=True)
            d2 = COUNTERS.delta_since(snap2)
            by_stream[name] = {
                "dropped_share": d2["moe.dropped_tokens"]["bytes"] /
                (assignments / steps * 2),
                "capacity_frac_mean": d2["moe.capacity_frac"]["bytes"] /
                d2["moe.capacity_frac"]["calls"] / 1e6,
                "router_input_shared_part": float(np.mean(
                    [a for a, _ in seen])),
                "experts_picked_per_group": float(np.mean(
                    [b for _, b in seen])),
                "moe_layer_calls": len(seen)}
    finally:
        MoE.__call__ = real_call
    rec = {"phase": "train-moe-dropless" if dropless else "train-moe",
           "config": "gpt2 125M+MoE-64: 12 layers, "
           "d768, 12 heads, d_ff 3072, vocab 50304, 64 experts on layers "
           "1,3,..,11, top-1, capacity factor 1.0, min capacity 4, aux 0.01, "
           "gate noise 1e-2; seq 2048, micro 4, bf16, Adam lr 1e-4, WarmupLR "
           "10, clipping 1.0, fused CE, comm.moe sorted" +
           (", dropless, overflow factor 1.0" if dropless else "") +
           "; Zipf(1) token stream over the whole vocabulary",
           "warmup_steps": warmup,
           "timed_steps": steps,
           "tokens_per_s": tokens / (sum(step_ms) / 1e3),
           "step_ms_mean": float(np.mean(step_ms)),
           "step_ms_min": float(np.min(step_ms)),
           "device_span_ms": span_ms,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "param_count": sum(p.numel() for p in eng.params.values()),
           "moe_layers": n_moe,
           "capacity": MoE(cfg.moe_config()).capacity(seq, True),
           "dropped_assignments": dropped,
           "dropped_share": dropped / assignments,
           "dropped_share_by_stream_2_steps_after": by_stream,
           "capacity_frac_mean": d["moe.capacity_frac"]["bytes"] /
           d["moe.capacity_frac"]["calls"] / 1e6,
           "first_loss": losses[0], "last_loss": losses[-1],
           "losses": losses, "flash_launches": launches["flash"],
           "fused_xent_launches": launches["fused_xent"],
           "moe_launches": launches["moe"],
           "moe_launches_overflow": launches["moe_overflow"],
           "moe_launches_per_step": {k: v / steps for k, v in
                                     launches["moe"].items()}}
    if dropless:
        rec["dropped_by_step"] = dropped_by_step
        rec["overflow_capacity_per_row"] = dsp.overflow_capacity(
            cfg.moe_top_k, seq, 1.0)
    emit(rec)
    return rec, eng, data


def moe_overflow_case(gen, flush, B=4, S=2048, E=64, D=768, hot=4):
    """Kernels #13 and #14 at the dropless overflow pass's shape: the
    train-moe layer's top-1 routing at capacity 32 (factor 1.0), skewed
    toward `hot` experts as train-moe's Zipf stream skews it (83.5% of
    assignments past capacity, PERF.md §6), then the overflow bucket
    (factor 1.0: O = S a row) as one group of B·S tokens over one expert
    of B·O slots, in expert-grouped order (`moe/dispatch.py`
    `overflow_slots`).  Dispatch bitwise and combine within
    `combine_tolerance` of their plain versions; kernel-only device
    times beside the bound (kept rows read, every slot or token row
    written), the plain version and `torch.index_select` (the dispatch's
    yardstick)."""
    import torch

    from deepspeed_tpu_torch.kernels import registry
    from deepspeed_tpu_torch.moe import dispatch as dsp

    dev, dtype, k = "cuda", torch.bfloat16, 1
    C = int(np.ceil(S * k / E - 1e-9))
    bias = torch.zeros(E, device=dev)
    bias[:hot] = 3.0
    logits = torch.randn(B, S, E, device=dev, generator=gen) + bias
    eidx, gate, pos, keep, _ = dsp.topk_routing(torch.softmax(logits, -1),
                                                k, C)
    O = dsp.overflow_capacity(k, S, 1.0)
    _, ov_keep = dsp.overflow_keep(keep, O)
    slot, counts = dsp.overflow_slots(eidx, ov_keep, E)
    x = torch.randn(B, S, D, device=dev, generator=gen).to(dtype)
    one = [dsp._one_group(t) for t in (torch.zeros_like(slot), slot, ov_keep,
                                       gate)]
    e1, p1, k1, g1 = one
    x1 = x.reshape(1, B * S, D)
    out = torch.randn(1, 1, B * O, D, device=dev, generator=gen).to(dtype)

    def disp(impl):
        return registry.dispatch("moe_dispatch", x1, e1, p1, k1, 1, B * O,
                                 impl=impl)

    def comb(impl):
        return registry.dispatch("moe_combine", out, e1, g1, p1, k1,
                                 impl=impl)

    dk, dp_ = disp("cuda"), disp("torch")
    ck, cp = comb("cuda"), comb("torch")
    torch.cuda.synchronize()
    d_mis = mismatches(dk, dp_)
    tol = dsp.combine_tolerance(out, e1, g1, p1, k1)
    c_err = (ck.float() - cp.float()).abs()
    c_ratio = float(torch.where(tol > 0, c_err / tol.clamp_min(1e-30),
                                torch.where(c_err > 0, np.inf, 0.0)).max())
    if d_mis or not c_ratio <= 1.0:
        raise AssertionError(f"moe overflow: dispatch mismatches {d_mis}, "
                             f"combine {c_ratio} x its bound")
    kept = int(ov_keep.sum())
    isz = x.element_size()
    route = B * k * S * (4 + 4 + 1)
    work = {"moe_dispatch": kept * D * isz + route + B * O * D * isz,
            "moe_combine": kept * D * isz + route + B * k * S * 4 +
            B * S * D * isz}
    rec = {"phase": "moe-kernels", "case": "overflow-k1-bfloat16",
           "B": B, "S": S, "E": E, "k": k, "capacity": C,
           "overflow_slots": B * O, "one_group_tokens": B * S, "D": D,
           "dtype": "bfloat16", "primary_kept": int(keep.sum()),
           "overflow_kept": kept, "assignments": B * k * S,
           "experts_in_bucket": int((counts > 0).sum()),
           "tol": MOE_TOL, "dispatch_mismatches": d_mis,
           "max_abs_err": {"moe_dispatch": float((dk.float() - dp_.float())
                                                 .abs().max()),
                           "moe_combine": float(c_err.max())},
           "combine_max_err_over_tol": c_ratio, "kernels": {}}
    for kname, nbytes in work.items():
        fn = disp if kname == "moe_dispatch" else comb
        rec["kernels"][kname] = {
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None,
            "kernel_ms": time_ms(lambda: fn("cuda"), 20, flush),
            "kernel_device_ms": profiled_flushed_ms(lambda: fn("cuda"),
                                                    flush),
            "plain_ms": time_ms(lambda: fn("torch"), 5, flush)}
    # the dispatch's yardstick: the same gather as one index_select
    dest = torch.where(k1, p1.long(), B * O).reshape(-1)
    flat = torch.full((B * O + 1,), B * S, dtype=torch.long, device=dev)
    flat.scatter_(0, dest, torch.arange(B * S, device=dev))
    slot_tok = flat[:B * O]
    xz = torch.cat([x.reshape(B * S, D), x.new_zeros(1, D)])
    if not torch.equal(torch.index_select(xz, 0, slot_tok),
                       dk.reshape(B * O, D)):
        raise AssertionError("moe overflow: the index_select yardstick "
                             "computes another gather")
    r = rec["kernels"]["moe_dispatch"]
    r["library_ms"] = time_ms(lambda: torch.index_select(xz, 0, slot_tok),
                              20, flush)
    r["library_device_ms"] = profiled_flushed_ms(
        lambda: torch.index_select(xz, 0, slot_tok), flush)
    emit(rec)
    return rec


def phase_moe_dropless_exact(device="cuda", d=768, f=3072, E=64, B=2,
                             S=128):
    """fp32 (TF32 off): the dropless MoE layer (train-moe's width: d768,
    d_ff 3072, 64 experts) at a tight capacity (factor 0.25, so most
    assignments overflow), forward and gradients (input, gate, experts),
    through kernels #13/#14 on the card against its plain CPU version at
    the same weights and inputs (atol 1e-4 of the largest |value|: fp32
    GEMM sums of 768 and 3072 terms in other orders on two devices), and
    against the loose-capacity oracle on the card (the same bound; JAX's
    `test_dropless_serves_overflow_exactly_once`).  `moe.dropped_tokens`
    is 0 at overflow factor 1.0, and at factor 0.05 exactly B·k·S minus
    the primary and the overflow bucket's kept assignments.  Top-1 and
    top-2."""
    import torch

    from deepspeed_tpu_torch.kernels import moe_kernels
    from deepspeed_tpu_torch.moe import dispatch as dsp
    from deepspeed_tpu_torch.moe import layer as L
    from deepspeed_tpu_torch.monitor.counters import COUNTERS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"phase": "moe-dropless-exact", "config": f"MoE layer d{d}, d_ff "
           f"{f}, {E} experts, B {B}, S {S}, capacity factor 0.25, "
           "fp32, TF32 off", "cases": []}
    for k in (1, 2):
        cfg = L.MoEConfig(d_model=d, d_ff=f, num_experts=E, top_k=k,
                          capacity_factor=0.25, min_capacity=1,
                          noisy_gate_std=0.0)
        moe = L.MoE(cfg)
        cpu_p = moe.init(torch.Generator().manual_seed(k))
        # a gate that concentrates the tokens (a few experts preferred)
        with torch.no_grad():
            cpu_p.gate.w.add_(torch.randn(d, E, generator=torch.Generator()
                                          .manual_seed(9)) * 0.05)
        x_cpu = torch.randn(B, S, d, generator=torch.Generator()
                            .manual_seed(10 + k))
        g_cpu = torch.randn(B, S, d, generator=torch.Generator()
                            .manual_seed(20 + k))

        def run(params, x, g, oracle=False, factor=1.0):
            x = x.clone().requires_grad_()
            for p in params.parameters():
                p.grad = None
            m = moe
            if oracle:
                m = L.MoE(L.MoEConfig(d_model=d, d_ff=f, num_experts=E,
                                      top_k=k, capacity_factor=float(E),
                                      min_capacity=S, noisy_gate_std=0.0))
            dsp.flush_dispatch_stats(wait=True)
            snap = COUNTERS.snapshot()
            with dsp.moe_wire(dispatch="sorted", dropless=not oracle,
                              overflow_factor=factor):
                y, aux = m(params, x, train=True)
                ((y * g).sum() + aux).backward()
            dsp.flush_dispatch_stats(wait=True)
            dropped = COUNTERS.delta_since(snap).get(
                "moe.dropped_tokens", {"bytes": 0})["bytes"]
            grads = {n: p.grad.detach().clone()
                     for n, p in params.named_parameters()}
            grads["x"] = x.grad.detach().clone()
            return y.detach(), grads, dropped

        dev_p = L.MoEParams(*(t.detach().to(device) for t in (
            cpu_p.gate.w, cpu_p.experts.w1, cpu_p.experts.b1,
            cpu_p.experts.w2, cpu_p.experts.b2)))
        xd, gd = x_cpu.to(device), g_cpu.to(device)
        moe_kernels.reset_launches()
        y_k, gr_k, drop_k = run(dev_p, xd, gd)
        launches = {"all": dict(moe_kernels.LAUNCHES),
                    "overflow": dict(moe_kernels.LAUNCHES_ONE_EXPERT)}
        y_c, gr_c, drop_c = run(cpu_p, x_cpu, g_cpu)
        y_o, gr_o, _ = run(dev_p, xd, gd, oracle=True)

        def err(a, b):
            a, b = a.float().cpu(), b.float().cpu()
            return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

        errs = {"y_vs_cpu": err(y_k, y_c), "y_vs_oracle": err(y_k, y_o)}
        for n in gr_k:
            errs[f"grad_{n}_vs_cpu"] = err(gr_k[n], gr_c[n])
            errs[f"grad_{n}_vs_oracle"] = err(gr_k[n], gr_o[n])
        # the counts at a bucket too small: B·k·S - kept - overflow-kept
        with torch.no_grad():
            logits = xd @ dev_p.gate.w
            eidx, gate, pos, keep, _ = dsp.topk_routing(
                torch.softmax(logits, -1), k, moe.capacity(S, True))
            O = dsp.overflow_capacity(k, S, 0.05)
            _, ov_keep = dsp.overflow_keep(keep, O)
            want_small = B * k * S - int(keep.sum()) - int(ov_keep.sum())
        _, _, drop_small = run(dev_p, xd, gd, factor=0.05)
        overflowed = int((~keep).sum())
        # one call: a dispatch and a combine a bucket forward, each
        # other's gradient backward (none on a CPU rehearsal)
        n = 1 if device != "cpu" else 0
        ok = (max(errs.values()) <= 1e-4 and drop_k == drop_c == 0 and
              drop_small == want_small and overflowed > 0 and
              launches["overflow"] == {"moe_dispatch": 2 * n,
                                       "moe_combine": 2 * n}
              and launches["all"] == {"moe_dispatch": 4 * n,
                                      "moe_combine": 4 * n})
        case = {"k": k, "assignments": B * k * S, "overflowed": overflowed,
                "max_rel_err": errs, "tol": "1e-4 of max|value|",
                "dropped_factor_1": drop_k, "dropped_factor_1_cpu": drop_c,
                "dropped_factor_0.05": drop_small,
                "want_factor_0.05": want_small, "launches": launches}
        out["cases"].append(case)
        if not ok:
            emit(out)
            raise AssertionError(f"moe-dropless-exact k={k}: {case}")
    emit(out)
    return out


def train_dp_config(stage, red, wire, micro, world, lr, precision,
                    loss_impl=None):
    cfg = train_config(micro, lr, precision)
    cfg["train_batch_size"] = micro * world
    cfg["zero_optimization"] = {"stage": stage}
    cfg["comm"] = {"gradient_reduction": red, "wire_dtype": wire}
    return cfg


def phase_dp_exact(device="cuda", steps=4, micro=4, seq=64):
    """GPT-2 nano, fp32 (TF32 off), data parallel at world 1 over NCCL (a
    `file://` store under a temp dir; gloo on the CPU): ZeRO 0, 1 and 2
    × implicit / bucketed × the fp32 / split wires against the
    single-process engine (no process group) from the same weights and
    batches.  Bounds: losses within 1e-4 a step; masters within 1e-6 on
    the fp32 wire (a sum over one rank, a gather of one) and within
    steps × lr on the split wire (its fp16 mantissa rounds each gradient
    to 2^-11, and an Adam step moves an element at most lr).  Leaves the
    process group up for train-dp; returns the record."""
    import tempfile

    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.comm import dist
    from deepspeed_tpu_torch.models import GPT, gpt2_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr = 1e-3
    batches = list(stride_batches(steps, micro, seq, 64, 3))
    combos = [(st, red, w) for st in (0, 1, 2)
              for red, wires in (("implicit", ("fp32",)),
                                 ("bucketed", ("fp32", "split")))
              for w in wires]

    def run(stage, red, wire):
        model = GPT(gpt2_config("nano", max_seq_len=seq, vocab_size=64),
                    device=device,
                    generator=torch.Generator(device=device).manual_seed(4))
        eng, *_ = dt.initialize(model=model, config_params=train_dp_config(
            stage, red, wire, micro, 1, lr, "fp32"), device=device)
        losses = []
        for b in batches:
            losses.append(float(eng.forward(b)))
            eng.backward()
            eng.step()
        return losses, eng.module_state_dict(), eng._dp

    assert not dist.is_initialized()
    base = {c: run(*c) for c in combos}
    store = tempfile.mkdtemp(prefix="dstpu-dp-")
    dist.init_distributed(init_method=f"file://{store}/store", world_size=1,
                          rank=0, device=device)
    backend = torch.distributed.get_backend()
    rec = {"phase": "dp-exact", "config": f"gpt2 nano, seq {seq}, micro "
           f"{micro}, fp32, TF32 off, {steps} steps, Adam lr {lr}, "
           f"world 1 over {backend}", "backend": backend, "cases": []}
    for c in combos:
        losses, masters, on = run(*c)
        wl, wm, off = base[c]
        loss_err = max(abs(a - b) for a, b in zip(losses, wl))
        m_err = max(float(np.abs(masters[n] - wm[n]).max()) for n in wm)
        m_tol = 1e-6 if c[2] == "fp32" else steps * lr
        case = {"stage": c[0], "reduction": c[1], "wire": c[2],
                "data_parallel_path": on, "single_process_path": not off,
                "max_loss_diff": loss_err, "loss_tol": 1e-4,
                "max_master_diff": m_err, "master_tol": m_tol}
        rec["cases"].append(case)
        if not (on and not off and loss_err <= 1e-4 and m_err <= m_tol):
            emit(rec)
            raise AssertionError(f"dp-exact {c}: {case}")
    emit(rec)
    return rec


def _dp_probe_worker(rank, world, store, device, out_dir):
    """Each collective the data-parallel path calls, over gloo on CUDA
    tensors: the first that raises is recorded (by name and message) and
    stops the probe; the others after it are not tried."""
    import torch

    from deepspeed_tpu_torch.comm import dist

    dist.init_distributed(init_method=f"file://{store}", world_size=world,
                          rank=rank, dist_backend="gloo", device=device,
                          verbose=False)
    x = torch.arange(8, dtype=torch.float32, device=device) + rank
    tried = {}
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    ops = (("all_reduce", lambda: dist.all_reduce(x.clone())),
           ("all_reduce_max_int32", lambda: dist.all_reduce(
               x.to(torch.int32), op=dist.ReduceOp.MAX)),
           ("all_reduce_bf16", lambda: dist.all_reduce(
               x.to(torch.bfloat16))),
           ("all_gather", lambda: dist.all_gather(x)),
           ("all_gather_int8", lambda: dist.all_gather(x.to(torch.int8),
                                                       tiled=False)),
           ("reduce_scatter", lambda: dist.reduce_scatter(x)),
           # rank r sends 3 elements to rank 0 and 5 to rank 1
           ("all_to_all_uneven", lambda: dist.all_to_all_uneven(
               x, [3, 5], [3, 3] if rank == 0 else [5, 5])),
           ("broadcast", lambda: dist.broadcast(x)),
           ("barrier", lambda: dist.barrier()))
    for name, fn in ops:
        try:
            fn()
            sync()
            tried[name] = "ok"
        except Exception as e:  # the finding is recorded, not passed over
            tried[name] = f"{type(e).__name__}: {str(e)[:200]}"
            break
    with open(os.path.join(out_dir, f"probe{rank}.json"), "w") as f:
        json.dump(tried, f)
    dist.destroy()


def _dp_train_worker(rank, world, store, device, out_dir, job):
    """One rank of train-dp's world-2 run (gloo on the one card)."""
    import torch

    from deepspeed_tpu_torch.comm import dist

    dist.init_distributed(init_method=f"file://{store}", world_size=world,
                          rank=rank, dist_backend="gloo", device=device,
                          verbose=False)
    try:
        rec = _train_dp_run(device=device, **job)
    finally:
        dist.barrier()
        dist.destroy()
    with open(os.path.join(out_dir, f"train{rank}.json"), "w") as f:
        json.dump(rec, f)


def _train_dp_run(device, size, micro, world, warmup, steps, seq, data_seed,
                  wire="fp32", block=256):
    """GPT-2 `size` with the fused CE, bf16, ZeRO-2, the bucketed `wire`
    (block `block` for int8 / int4), on the global batches of
    `stride_batches(..., micro × world)`: warm-up, then timed steps with
    every kernel count reset just before; -> the record (losses, step ms,
    peak memory, launches, the wire's counters against `wire_nbytes`)."""
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.kernels import flash, fused_xent, quant_codec
    from deepspeed_tpu_torch.models import GPT, gpt2_config
    from deepspeed_tpu_torch.monitor.counters import COUNTERS
    from deepspeed_tpu_torch.runtime.comm.bucketing import wire_nbytes

    cfg = gpt2_config(size, loss_impl="pallas", max_seq_len=seq)
    model = GPT(cfg, device=device,
                generator=torch.Generator(device=device).manual_seed(0))
    conf = train_dp_config(2, "bucketed", wire, micro, world, 1e-4, "bf16")
    conf["comm"]["quant_block_size"] = block
    eng, *_ = dt.initialize(model=model, config_params=conf, device=device)
    data = stride_batches(warmup + steps, micro * world, seq, 64, data_seed)
    losses = [float(eng.train_batch(data)) for _ in range(warmup)]
    cuda = device != "cpu"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for counts in (flash.LAUNCHES, fused_xent.LAUNCHES):
        for k in counts:
            counts[k] = 0
    quant_codec.reset_launches()
    snap = COUNTERS.snapshot()
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(eng.train_batch(data)))
        if cuda:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    d = COUNTERS.delta_since(snap)
    plan = eng.bucket_plan   # None without a process group
    want_wire = (sum(wire_nbytes(b.padded, wire, block)
                     for b in plan.buckets) if plan is not None else None)
    wire_counts = {k: v for k, v in d.items()
                   if k.startswith(("bucket.", "grad_wire.", "dist."))}
    launches = {"flash": dict(flash.LAUNCHES),
                "fused_xent": dict(fused_xent.LAUNCHES)}
    held = sum(t.numel() for t in eng._opt_state["exp_avg"])
    rec = {"world": world, "rank": eng.dp_rank, "micro_per_rank": micro,
           "global_micro": micro * world, "losses": losses,
           "step_ms_mean": float(np.mean(step_ms)),
           "step_ms_min": float(np.min(step_ms)),
           "tokens_per_s": micro * world * seq * steps /
           (sum(step_ms) / 1e3),
           "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                              if cuda else None),
           "launches": launches, "wire_counters": wire_counts,
           "quant_launches": dict(quant_codec.LAUNCHES), "wire": wire,
           "n_buckets": plan.n_buckets if plan is not None else 0,
           "bucket_elems": ([b.padded for b in plan.buckets]
                            if plan is not None else []),
           "bucket_plan": plan.describe() if plan is not None else None,
           "wire_nbytes_per_step": want_wire,
           "optimizer_state_share": held / sum(p.numel()
                                                for p in eng._masters),
           "kernel_fallbacks": d.get("kernel.fallbacks", {}).get("calls", 0),
           "layers": cfg.num_layers, "steps": steps}
    eng.finalize_monitoring()
    return rec


def phase_train_dp(train_pallas, device="cuda", size="small", micro=8,
                   seq=1024, warmup=3, steps=10, w2_warmup=2, w2_steps=3):
    """train-dp: GPT-2 small at train-pallas's full width (seq 1024, micro
    8, bf16, fused CE) through the data-parallel path — ZeRO-2, the
    bucketed fp32 wire, world 1 over NCCL (dp-exact's process group):
    step ms and tokens/s beside train-pallas's from this run, peak
    memory, the `bucket.*` / `grad_wire.reduce` counters against the
    plan's `wire_nbytes`, each flash kernel layers × steps and each
    fused-CE kernel once a step.  Then two ranks on the one card over
    gloo: a probe of every collective the path calls on CUDA tensors;
    if all run, world 2 (spawned processes, micro 4 each, the same
    global batches) against world 1's losses on those batches (bound:
    3e-3 relative a step — bf16 products summed over two halves of the
    batch in another order, then Adam at lr 1e-4) with each rank holding
    about half of the optimizer state; if not, the record says which
    collective refused and world 2 does not run."""
    import multiprocessing as mp
    import tempfile

    import torch

    from deepspeed_tpu_torch.comm import dist

    if not dist.is_initialized():
        raise AssertionError("train-dp runs on dp-exact's process group")
    backend = torch.distributed.get_backend()
    w1 = _train_dp_run(device, size, micro, 1, warmup, steps, seq, 0)
    # every flash kernel once a layer a step, every fused-CE kernel once a
    # step (none on a CPU rehearsal, where the plain versions run)
    layers = w1["layers"]
    n_layers = layers if device != "cpu" else 0
    n_xent = 1 if device != "cpu" else 0
    if w1["launches"] != {
            "flash": {k: n_layers * steps for k in w1["launches"]["flash"]},
            "fused_xent": {k: n_xent * steps
                           for k in w1["launches"]["fused_xent"]}} \
            or (w1["kernel_fallbacks"] and device != "cpu"):
        raise AssertionError(f"train-dp launches {w1['launches']}, "
                             f"fallbacks {w1['kernel_fallbacks']}")
    wc = w1["wire_counters"]
    if wc["grad_wire.reduce"]["bytes"] != w1["wire_nbytes_per_step"] * steps \
            or wc["bucket.psum_scatter"]["bytes"] != \
            w1["wire_nbytes_per_step"] * steps:
        raise AssertionError(f"train-dp wire counters {wc} against "
                             f"{w1['wire_nbytes_per_step']} a step")
    if not all(np.isfinite(w1["losses"])) or \
            not w1["losses"][-1] < w1["losses"][0]:
        raise AssertionError(f"train-dp losses {w1['losses']}")
    rec = {"phase": "train-dp", "config": f"gpt2 {size} ({layers} "
           f"layers), seq {seq}, micro {micro}, bf16, fused CE, Adam lr 1e-4, "
           "WarmupLR 10, clipping 1.0, ZeRO-2, bucketed fp32 wire; stride "
           "stream over tokens < 64", "backend": backend, "world1": w1,
           "train_pallas_step_ms_mean": train_pallas.get("step_ms_mean"),
           "train_pallas_tokens_per_s": train_pallas.get("tokens_per_s"),
           "train_pallas_peak_mem_bytes": train_pallas.get("peak_mem_bytes")}
    dist.destroy()

    # two ranks on one card over gloo
    out = tempfile.mkdtemp(prefix="dstpu-dp2-")
    ctx = mp.get_context("spawn")

    def world2(target, args, timeout):
        procs = [ctx.Process(target=target,
                             args=(r, 2, f"{out}/{target.__name__}", device,
                                   out) + args) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        return [p.exitcode for p in procs]

    codes = world2(_dp_probe_worker, (), 120)
    probe = []
    for r in range(2):
        path = os.path.join(out, f"probe{r}.json")
        probe.append(json.load(open(path)) if os.path.exists(path) else None)
    rec["gloo_cuda_probe"] = {"exit_codes": codes, "ranks": probe}
    if None in probe or codes != [0, 0]:
        emit(rec)
        raise AssertionError(f"train-dp: the gloo probe itself failed "
                             f"(exit codes {codes})")
    works = all(all(v == "ok" for v in p.values()) and len(p) == 9
                for p in probe)
    rec["world2_on_one_card"] = works
    if not works:
        rec["world2_note"] = ("gloo does not run every collective the "
                              "data-parallel path calls on CUDA tensors "
                              "(gloo_cuda_probe names the first that "
                              "refused): world 2 on one card did not run")
        emit(rec)
        return rec
    # world 1 on world 2's batches, from this process (no process group)
    ref = _train_dp_run(device, size, micro, 1, w2_warmup, w2_steps, seq, 5)
    job = dict(size=size, micro=micro // 2, world=2, warmup=w2_warmup,
               steps=w2_steps, seq=seq, data_seed=5)
    codes = world2(_dp_train_worker, (job,), 900)
    ranks = []
    for r in range(2):
        path = os.path.join(out, f"train{r}.json")
        ranks.append(json.load(open(path)) if os.path.exists(path) else None)
    if codes != [0, 0] or None in ranks:
        raise AssertionError(f"train-dp world 2 exit codes {codes}")
    rel = max(abs(a - b) / abs(b) for r in ranks
              for a, b in zip(r["losses"], ref["losses"]))
    rec["world2"] = {"ranks": ranks, "world1_losses_same_batches":
                     ref["losses"], "max_loss_rel_diff": rel,
                     "loss_rel_tol": 3e-3, "job": job}
    for r in ranks:
        if r["launches"] != {
                "flash": {k: n_layers * w2_steps
                          for k in r["launches"]["flash"]},
                "fused_xent": {k: n_xent * w2_steps
                               for k in r["launches"]["fused_xent"]}} \
                or (r["kernel_fallbacks"] and device != "cpu") or \
                not 0.45 < r["optimizer_state_share"] < 0.55:
            emit(rec)
            raise AssertionError(f"train-dp world 2 rank {r['rank']}: "
                                 f"{r['launches']}, share "
                                 f"{r['optimizer_state_share']}")
    if not rel <= 3e-3:
        emit(rec)
        raise AssertionError(f"train-dp world 2 losses {rel} off world 1's")
    emit(rec)
    return rec


# -- the quantized gradient wire (qgZ) ----------------------------------------


def _spawn_ranks(target, world, out, args, timeout):
    """`target(rank, world, store, *args)` in `world` spawned processes
    (gloo on the one card); -> their exit codes.  Every process is joined,
    or killed past `timeout`."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    store = os.path.join(out, f"{target.__name__}-{world}-store")
    procs = [ctx.Process(target=target, args=(r, world, store) + tuple(args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    return [p.exitcode for p in procs]


def _capture_reduce(plan):
    """Keep the first reduction's flat buckets in and reduced buckets out
    (CPU copies) of a BucketPlan, by wrapping its `reduce`."""
    real, seen = plan.reduce, []

    def reduce(buckets):
        out = real(buckets)
        if not seen:
            # copies: the step unscales and clips the gradients in place
            seen.append(([b.detach().float().cpu().clone() for b in buckets],
                         [o.detach().float().cpu().clone() for o in out]))
        return out

    plan.reduce = reduce
    return seen


def qgz_oracle(flats, wire, block):
    """The reduced bucket from each rank's flat bucket `flats[r]` through
    the codec's plain version on the CPU (quantize, pack, unpack,
    dequantize: bitwise JAX's, tests/test_torch_qgz.py), the fp32 sum of
    the ranks' rows in rank order, / world."""
    import torch

    from deepspeed_tpu_torch.runtime.comm import quant as q

    rows = []
    for f in flats:
        n = f.numel()
        p, s = q.unpack_wire(q.pack_wire(*q.quantize_blockwise_ref(
            f, block, wire)), wire, block, n)
        rows.append(q.dequantize_blockwise_ref(p, s, wire, n).numpy())
    total = rows[0].copy()
    for r in rows[1:]:
        total = total + r
    return torch.from_numpy(total / np.float32(len(flats)))


_QGZ_CASES = [(w, st) for w in ("int8", "int4") for st in (0, 2)]


def _qgz_engine(device, wire, stage, world, micro=4, seq=64):
    """GPT-2 nano, fp32, ZeRO `stage`, the bucketed `wire` at block 256:
    one step on the first stride batch; -> the first reduction's buckets
    (in, out) and the #11 / #12 launches of the step."""
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.kernels import quant_codec
    from deepspeed_tpu_torch.models import GPT, gpt2_config

    model = GPT(gpt2_config("nano", max_seq_len=seq, vocab_size=64),
                device=device,
                generator=torch.Generator(device=device).manual_seed(4))
    cfg = train_dp_config(stage, "bucketed", wire, micro, world, 1e-3, "fp32")
    cfg["comm"]["quant_block_size"] = 256
    eng, *_ = dt.initialize(model=model, config_params=cfg, device=device)
    seen = _capture_reduce(eng.bucket_plan)
    quant_codec.reset_launches()
    batch = next(stride_batches(1, micro * world, seq, 64, 3))
    loss = float(eng.forward(batch))
    eng.backward()
    eng.step()
    if device != "cpu":
        torch.cuda.synchronize()
    return seen[0], dict(quant_codec.LAUNCHES), eng.bucket_plan.n_buckets, \
        loss


def _qgz_exact_worker(rank, world, store, device, out_dir):
    """One rank of qgz-exact's world 2 (gloo on the one card): each case's
    first reduction, in and out, to `out_dir`."""
    import torch

    from deepspeed_tpu_torch.comm import dist

    dist.init_distributed(init_method=f"file://{store}", world_size=world,
                          rank=rank, dist_backend="gloo", device=device,
                          verbose=False)
    try:
        got = {}
        for wire, stage in _QGZ_CASES:
            (ins, outs), launches, nb, loss = _qgz_engine(device, wire,
                                                          stage, world)
            for i, (a, b) in enumerate(zip(ins, outs)):
                got[f"{wire}-z{stage}-in{i}"] = a.numpy()
                got[f"{wire}-z{stage}-out{i}"] = b.numpy()
            got[f"{wire}-z{stage}-launches"] = np.array(
                [launches["quant_codec_quantize"],
                 launches["quant_codec_dequantize"], nb])
    finally:
        dist.barrier()
        dist.destroy()
    np.savez(os.path.join(out_dir, f"qgz{rank}.npz"), **got)


def phase_qgz_exact(device="cuda"):
    """qgz-exact: GPT-2 nano, fp32, the bucketed int8 and int4 wires
    (block 256) at ZeRO 0 and 2.  World 1 over NCCL (a `file://` store
    in a temp directory): a gather of one still quantizes and dequantizes,
    and each step's reduced buckets are bitwise `qgz_oracle`'s, the plain
    CPU version of the same buckets.  World 2 on the one card over gloo:
    each rank's reduced bucket bitwise the oracle's fp32 sum of both
    ranks' dequantized contributions / 2.  #11 and #12 launched once a
    bucket a reduction (none on a CPU rehearsal)."""
    import tempfile

    import torch

    from deepspeed_tpu_torch.comm import dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = tempfile.mkdtemp(prefix="dstpu-qgz-")
    dist.init_distributed(init_method=f"file://{out}/w1", world_size=1,
                          rank=0, device=device)
    rec = {"phase": "qgz-exact", "config": "gpt2 nano, seq 64, fp32, TF32 "
           "off, bucketed int8 / int4 wire, block 256, one step",
           "backend_world1": torch.distributed.get_backend(), "world1": [],
           "world2": []}
    want_launch = 1 if device != "cpu" else 0
    try:
        for wire, stage in _QGZ_CASES:
            (ins, outs), launches, nb, loss = _qgz_engine(device, wire,
                                                          stage, 1,
                                                          micro=8)
            bad = sum(mismatches(o, qgz_oracle([i], wire, 256))
                      for i, o in zip(ins, outs))
            case = {"wire": wire, "stage": stage, "buckets": nb,
                    "elements": sum(i.numel() for i in ins),
                    "mismatches_vs_plain": bad, "launches": launches,
                    "loss": loss}
            rec["world1"].append(case)
            if bad or launches != {"quant_codec_quantize": want_launch * nb,
                                   "quant_codec_dequantize": want_launch * nb}:
                emit(rec)
                raise AssertionError(f"qgz-exact world 1 {case}")
    finally:
        dist.destroy()
    codes = _spawn_ranks(_qgz_exact_worker, 2, out, (device, out), 300)
    if codes != [0, 0]:
        emit(rec)
        raise AssertionError(f"qgz-exact world 2 exit codes {codes}")
    ranks = [dict(np.load(os.path.join(out, f"qgz{r}.npz")))
             for r in range(2)]
    for wire, stage in _QGZ_CASES:
        key = f"{wire}-z{stage}"
        nb = int(ranks[0][f"{key}-launches"][2])
        bad = 0
        for i in range(nb):
            want = qgz_oracle([torch.from_numpy(r[f"{key}-in{i}"])
                               for r in ranks], wire, 256)
            bad += sum(mismatches(torch.from_numpy(r[f"{key}-out{i}"]), want)
                       for r in ranks)
        launches = [r[f"{key}-launches"][:2].tolist() for r in ranks]
        case = {"wire": wire, "stage": stage, "buckets": nb,
                "mismatches_vs_numpy_sum": bad, "launches_by_rank": launches}
        rec["world2"].append(case)
        if bad or any(x != [want_launch * nb] * 2 for x in launches):
            emit(rec)
            raise AssertionError(f"qgz-exact world 2 {case}")
    emit(rec)
    return rec


def codec_wire_shape(n, dtype, block, flush, rows=1):
    """#11 and #12 at one wire shape: `rows` chunks of `n` elements of
    `dtype` quantized int8 (one launch), and dequantized back to `dtype`
    (one launch): device times on events (L2 flushed), beside their plain
    versions' and their byte bounds, and the quantize's route."""
    import torch

    from deepspeed_tpu_torch.kernels import quant_codec, registry

    gen = torch.Generator(device="cuda").manual_seed(11)
    x = (torch.randn((rows, n), generator=gen, device="cuda") *
         1e-3).to(dtype)
    p, s = registry.dispatch("quant_codec_quantize", x, block, "int8",
                             impl="cuda")
    nb = p.shape[0] // rows
    pb, sb = p.reshape(rows, nb, block), s.reshape(rows, nb)
    total = rows * n
    esize = torch.finfo(dtype).bits // 8
    out = {"shape": f"{rows} x {n} {str(dtype).replace('torch.', '')}, "
           f"block {block}", "quantize_route":
           quant_codec.quantize_route(x, block)}
    for key, fn, nbytes in (
            ("quantize", lambda impl: registry.dispatch(
                "quant_codec_quantize", x, block, "int8", impl=impl),
             total * esize + p.numel() + s.numel() * 2),
            ("dequantize", lambda impl: registry.dispatch(
                "quant_codec_dequantize", pb, sb, "int8", n,
                out_dtype=dtype, impl=impl),
             p.numel() + s.numel() * 2 + total * esize)):
        got, want = fn("cuda"), fn("torch")
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        out[key] = {"kernel_ms": time_ms(lambda: fn("cuda"), 5, flush),
                    "plain_ms": time_ms(lambda: fn("torch"), 2, flush),
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "bytes": nbytes,
                    "mismatches": sum(mismatches(a, b) for a, b in pairs)}
        del got, want
        if out[key]["mismatches"]:
            raise AssertionError(f"codec at a wire shape: {out}")
    del x, p, s
    return out


def phase_train_dp_qgz(train_dp, flush, device="cuda", size="small",
                       micro=8, seq=1024, warmup=3, steps=10):
    """train-dp-qgz: train-dp's configuration (GPT-2 small, seq 1024,
    bf16, fused CE, ZeRO-2, bucketed) with `wire_dtype` "int8", block 256.
    World 1 over NCCL, micro 8: step ms and tokens/s beside train-dp's
    fp32 wire from this run, peak memory, `bucket.all_gather` and
    `grad_wire.reduce` bytes equal to the plan's `wire_nbytes` a step,
    #11 and #12 once a bucket a step, and the two kernels timed at the
    bucket's shape against their byte bounds.  Then two ranks on the one
    card over gloo, micro 4 each, on train-dp's world-2 batches: each
    step's loss within 2% of train-dp's world-2 fp32-wire losses
    (tests/test_comm_quant.py's int8 loss envelope)."""
    import tempfile

    import torch

    from deepspeed_tpu_torch.comm import dist

    out = tempfile.mkdtemp(prefix="dstpu-qgz-dp-")
    dist.init_distributed(init_method=f"file://{out}/w1", world_size=1,
                          rank=0, device=device)
    backend = torch.distributed.get_backend()
    try:
        w1 = _train_dp_run(device, size, micro, 1, warmup, steps, seq, 0,
                           wire="int8")
    finally:
        dist.destroy()
    gc.collect()
    torch.cuda.empty_cache()
    n_kernel = 1 if device != "cpu" else 0
    nb = w1["n_buckets"]
    wc = w1["wire_counters"]
    if w1["quant_launches"] != {"quant_codec_quantize": n_kernel * nb * steps,
                                "quant_codec_dequantize":
                                n_kernel * nb * steps} or \
            wc["bucket.all_gather"]["bytes"] != \
            w1["wire_nbytes_per_step"] * steps or \
            wc["grad_wire.reduce"]["bytes"] != \
            w1["wire_nbytes_per_step"] * steps or \
            (w1["kernel_fallbacks"] and device != "cpu"):
        raise AssertionError(f"train-dp-qgz world 1: {w1}")
    if not all(np.isfinite(w1["losses"])) or \
            not w1["losses"][-1] < w1["losses"][0]:
        raise AssertionError(f"train-dp-qgz losses {w1['losses']}")
    rec = {"phase": "train-dp-qgz", "config": f"gpt2 {size} "
           f"({w1['layers']} layers), seq {seq}, micro {micro}, bf16, fused "
           "CE, Adam lr 1e-4, WarmupLR 10, clipping 1.0, ZeRO-2, bucketed "
           "int8 wire, block 256; stride stream over tokens < 64",
           "backend": backend, "world1": w1,
           "train_dp_fp32_wire_step_ms_mean":
               train_dp["world1"]["step_ms_mean"],
           "train_dp_fp32_wire_tokens_per_s":
               train_dp["world1"]["tokens_per_s"],
           "train_dp_fp32_wire_peak_mem_bytes":
               train_dp["world1"]["peak_mem_bytes"]}
    if device != "cpu":
        rec["codec_at_bucket_shape"] = codec_wire_shape(
            w1["bucket_elems"][0], torch.float32, 256, flush)
    w2 = train_dp.get("world2")
    if not w2:
        rec["world2_note"] = "train-dp's world 2 did not run"
        emit(rec)
        return rec
    job = dict(w2["job"], wire="int8")
    codes = _spawn_ranks(_dp_train_worker, 2, out, (device, out, job), 900)
    ranks = []
    for r in range(2):
        path = os.path.join(out, f"train{r}.json")
        ranks.append(json.load(open(path)) if os.path.exists(path) else None)
    if codes != [0, 0] or None in ranks:
        raise AssertionError(f"train-dp-qgz world 2 exit codes {codes}")
    ref = {r["rank"]: r["losses"] for r in w2["ranks"]}
    rel = max(abs(a - b) / abs(b) for r in ranks
              for a, b in zip(r["losses"], ref[r["rank"]]))
    rec["world2"] = {"ranks": ranks, "fp32_wire_losses": ref,
                     "max_loss_rel_diff_vs_fp32_wire": rel,
                     "loss_rel_tol": 0.02}
    for r in ranks:
        if r["quant_launches"]["quant_codec_quantize"] != \
                n_kernel * r["n_buckets"] * r["steps"] or \
                (r["kernel_fallbacks"] and device != "cpu"):
            emit(rec)
            raise AssertionError(f"train-dp-qgz world 2 rank {r['rank']}: "
                                 f"{r['quant_launches']}")
    if not rel <= 0.02:
        emit(rec)
        raise AssertionError(f"train-dp-qgz world 2 losses {rel} off the "
                             f"fp32 wire's")
    emit(rec)
    return rec


# -- expert-parallel MoE over the explicit all-to-all wire --------------------

# a small MoE GPT for moe-wire-exact: E 8, top-2, on layers 1 and 3 of 4
MOE_WIRE_MODEL = dict(num_layers=4, d_model=256, num_heads=4, d_ff=1024,
                      vocab_size=512, num_experts=8, moe_top_k=2,
                      moe_layer_freq=2, moe_capacity_factor=1.25)
_MOE_WIRE_CASES = {2: [("fp32", "auto"), ("bf16", "auto"), ("int8", "auto"),
                       ("int4", "auto")],
                   4: [("fp32", "data"), ("fp32", "inner"),
                       ("int8", "data")]}
_MOE_WIRE_TOL = {"fp32": None, "bf16": 2e-2, "int8": 5e-2, "int4": 0.5}


def _moe_wire_run(device, world, wire, placement, hierarchy, steps, micro,
                  seq):
    """The small MoE GPT, fp32, TF32 off, ZeRO-1, the implicit reduction
    and `wire` (None: the local dispatch) over `steps` Zipf batches of the
    global batch; -> losses, grad norms, a2a counters, the #11-#14
    launches and the expert rows a rank holds."""
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.kernels import moe_kernels, quant_codec
    from deepspeed_tpu_torch.models import GPT, gpt2_config
    from deepspeed_tpu_torch.moe import dispatch as dsp
    from deepspeed_tpu_torch.monitor.counters import COUNTERS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt2_config("nano", max_seq_len=seq, **MOE_WIRE_MODEL)
    model = GPT(cfg, device=device,
                generator=torch.Generator(device=device).manual_seed(8))
    moe = {"dispatch": "sorted"}
    if wire is not None:
        moe.update(a2a_wire_dtype=wire, placement=placement)
    conf = train_config(micro, 1e-3, "fp32")
    conf["train_batch_size"] = micro * world
    conf["zero_optimization"] = {"stage": 1}
    conf["comm"] = {"moe": moe, "hierarchy": hierarchy}
    eng, *_ = dt.initialize(model=model, config_params=conf, device=device)
    quant_codec.reset_launches()
    moe_kernels.reset_launches()
    snap = COUNTERS.snapshot()
    losses, norms = [], []
    for b in vocab_batches(steps, micro * world, seq, cfg.vocab_size, 12):
        losses.append(float(eng.forward(b)))
        eng.backward()
        eng.step()
        norms.append(eng.get_global_grad_norm())
    d = COUNTERS.delta_since(snap)
    held = sorted({tuple(p.shape)[0] for n, p in eng.params.items()
                   if ".experts." in n})
    rec = {"losses": losses, "grad_norms": norms,
           "a2a": {k: v for k, v in d.items() if k.startswith("moe.a2a")},
           "launches": {**dict(moe_kernels.LAUNCHES),
                        **dict(quant_codec.LAUNCHES)},
           "experts_held": held,
           "moe_layers": sum(cfg.is_moe_layer(i)
                             for i in range(cfg.num_layers)),
           "capacity": None}
    from deepspeed_tpu_torch.moe.layer import MoE

    rec["capacity"] = MoE(cfg.moe_config()).capacity(seq, True)
    dsp.set_wire_config(dsp.MoEWireConfig())
    del eng, model
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return rec


def _moe_wire_worker(rank, world, store, device, out_dir, cases, hierarchy,
                     steps, micro, seq):
    """One rank of moe-wire-exact's world (gloo on the one card)."""
    from deepspeed_tpu_torch.comm import dist

    dist.init_distributed(init_method=f"file://{store}", world_size=world,
                          rank=rank, dist_backend="gloo", device=device,
                          verbose=False)
    try:
        got = {f"{w}-{p}": _moe_wire_run(device, world, w, p, hierarchy,
                                         steps, micro, seq)
               for w, p in cases}
    finally:
        dist.barrier()
        dist.destroy()
    with open(os.path.join(out_dir, f"moewire{world}-{rank}.json"), "w") as f:
        json.dump(got, f)


def _a2a_plan_bytes(world, outer, wire, placement, micro, cap, d, E=8,
                    block=256):
    """(bytes, inter bytes) one traversal of one rank of the plan."""
    from deepspeed_tpu_torch.comm.mesh import MeshInfo
    from deepspeed_tpu_torch.moe import dispatch as dsp

    mesh = MeshInfo(axis_sizes={"data": world},
                    data_hierarchy=(outer, world // outer)
                    if outer > 1 else None)
    plan = dsp.build_a2a_plan(dsp.MoEWireConfig(
        dispatch="sorted", a2a_wire_dtype=wire, placement=placement,
        quant_block_size=block), mesh, E, micro, cap, d)
    return plan.bytes_per_traversal, plan.inter_bytes_per_traversal, \
        len(plan.hops)


def phase_moe_wire_exact(device="cuda", steps=3, seq=128):
    """moe-wire-exact: a small MoE GPT (4 layers, d256, 8 experts on
    layers 1 and 3, top-2, capacity factor 1.25), fp32, TF32 off, ZeRO-1,
    the implicit reduction, global batch 4, 3 steps on a Zipf stream.
    World 1 (no process group: the local dispatch) is the reference.
    Two ranks on the one card over gloo (flat, ep 2) through the fp32,
    bf16, int8 and int4 wires, then four ranks (outer 2 x inner 2)
    through the fp32 wire under placement "data" (two hops) and "inner"
    (one hop inside an inner group) and int8 under "data".  Bounds: fp32
    losses and clipping norms within 1e-5 relative a step (only the
    expert products' row count differs); bf16 2e-2, int8 5e-2, int4 0.5
    absolute on the losses (JAX's `test_wire_parity_flat_mesh` bounds);
    `moe.a2a_bytes` / `moe.a2a_inter` equal to the plan's bytes x 4
    traversals x 2 MoE layers x steps; #13 / #14 twice a MoE layer a
    step, #11 / #12 four times a quantized hop a MoE layer a step."""
    import tempfile

    from deepspeed_tpu_torch.comm import dist

    if dist.is_initialized():
        raise AssertionError("moe-wire-exact: a process group is up")
    micro = 4
    ref = _moe_wire_run(device, 1, None, None, "none", steps, micro, seq)
    rec = {"phase": "moe-wire-exact", "config": "gpt2 4 layers, d256, 4 "
           "heads, d_ff 1024, vocab 512, 8 experts on layers 1 and 3, "
           f"top-2, capacity factor 1.25; seq {seq}, global batch {micro},"
           f" fp32, TF32 off, Adam lr 1e-3, ZeRO-1, implicit reduction; "
           f"{steps} steps on a Zipf stream", "world1": ref}
    out = tempfile.mkdtemp(prefix="dstpu-moewire-")
    kern = 1 if device != "cpu" else 0
    for world, outer in ((2, 1), (4, 2)):
        cases = _MOE_WIRE_CASES[world]
        codes = _spawn_ranks(_moe_wire_worker, world, out,
                             (device, out, cases, outer if outer > 1 else
                              "none", steps, micro // world, seq), 600)
        if codes != [0] * world:
            emit(rec)
            raise AssertionError(f"moe-wire-exact world {world} exit codes "
                                 f"{codes}")
        ranks = [json.load(open(os.path.join(out,
                                             f"moewire{world}-{r}.json")))
                 for r in range(world)]
        rec[f"world{world}"] = {}
        for wire, placement in cases:
            key = f"{wire}-{placement}"
            byt, inter, hops = _a2a_plan_bytes(
                world, outer, wire, placement, micro // world,
                ref["capacity"], MOE_WIRE_MODEL["d_model"])
            n_moe = ref["moe_layers"]
            worst_loss = max(abs(a - b) for r in ranks
                             for a, b in zip(r[key]["losses"],
                                             ref["losses"]))
            worst_rel = max(abs(a - b) / abs(b) for r in ranks
                            for a, b in zip(r[key]["losses"] +
                                            r[key]["grad_norms"],
                                            ref["losses"] +
                                            ref["grad_norms"]))
            quant_hops = hops if wire in ("int8", "int4") else 0
            want_launch = {"moe_dispatch": kern * 2 * n_moe * steps,
                           "moe_combine": kern * 2 * n_moe * steps,
                           "quant_codec_quantize":
                               kern * 4 * quant_hops * n_moe * steps,
                           "quant_codec_dequantize":
                               kern * 4 * quant_hops * n_moe * steps}
            case = {"world": world, "outer": outer, "wire": wire,
                    "placement": placement,
                    "max_loss_abs_diff": worst_loss,
                    "max_rel_diff_losses_and_norms": worst_rel,
                    "tol": _MOE_WIRE_TOL[wire] or 1e-5,
                    "a2a_by_rank": [r[key]["a2a"] for r in ranks],
                    "plan_bytes_per_traversal": byt,
                    "plan_inter_bytes_per_traversal": inter,
                    "launches_by_rank": [r[key]["launches"] for r in ranks],
                    "experts_held": ranks[0][key]["experts_held"]}
            rec[f"world{world}"][key] = case
            ok = (worst_rel <= 1e-5 if wire == "fp32" else
                  worst_loss <= _MOE_WIRE_TOL[wire])
            ok = ok and all(
                r[key]["a2a"].get("moe.a2a_bytes", {}).get("bytes") ==
                byt * 4 * n_moe * steps and
                r[key]["a2a"].get("moe.a2a_inter", {"bytes": 0})["bytes"] ==
                inter * 4 * n_moe * steps and
                r[key]["launches"] == want_launch for r in ranks)
            if not ok:
                emit(rec)
                raise AssertionError(f"moe-wire-exact {case}")
    emit(rec)
    return rec


def _moe_ep_run(device, world, wire, steps, micro, seq, layers, over=None):
    """train-moe's model at `layers` layers through the explicit `wire`
    (None: world 1's local dispatch), ZeRO-1, implicit, on the first
    `steps` Zipf batches of the global batch from the same init; -> the
    record (losses, step ms, peak memory, launches, counters, what a rank
    holds).  `over`: model overrides (a CPU rehearsal's small widths)."""
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.kernels import (flash, fused_xent, moe_kernels,
                                             quant_codec)
    from deepspeed_tpu_torch.models import GPT, gpt2_config
    from deepspeed_tpu_torch.moe import dispatch as dsp
    from deepspeed_tpu_torch.moe.layer import MoE
    from deepspeed_tpu_torch.monitor.counters import COUNTERS

    cfg = gpt2_config("small", max_seq_len=seq, loss_impl="pallas",
                      **dict(MOE_MODEL, num_layers=layers, **(over or {})))
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    model = GPT(cfg, device=device,
                generator=torch.Generator(device=device).manual_seed(0))
    cuda = device != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    conf = moe_train_config(micro, 1e-4, "bf16", "sorted")
    conf["train_batch_size"] = micro * world
    conf["zero_optimization"] = {"stage": 1}
    if wire is not None:
        conf["comm"]["moe"]["a2a_wire_dtype"] = wire
    eng, *_ = dt.initialize(model=model, config_params=conf, device=device)
    data = vocab_batches(steps, micro * world, seq, cfg.vocab_size, 21)
    losses = [float(eng.train_batch(data))]       # the first step: warm-up
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for counts in (flash.LAUNCHES, fused_xent.LAUNCHES):
        for k in counts:
            counts[k] = 0
    moe_kernels.reset_launches()
    quant_codec.reset_launches()
    snap = COUNTERS.snapshot()
    step_ms = []
    for _ in range(steps - 1):
        t0 = time.perf_counter()
        losses.append(float(eng.train_batch(data)))
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    d = COUNTERS.delta_since(snap)
    held = {n: list(p.shape) for n, p in eng.params.items()
            if ".experts." in n}
    moments = {n: list(t.shape) for n, t in
               zip(eng._param_names, eng._opt_state["exp_avg"])
               if ".experts." in n}
    dense_share = (sum(t.numel() for n, t in zip(eng._param_names,
                                                  eng._opt_state["exp_avg"])
                       if ".experts." not in n) /
                   sum(p.numel() for n, p in eng.params.items()
                       if ".experts." not in n))
    rec = {"world": world, "rank": eng.dp_rank, "wire": wire,
           "micro_per_rank": micro, "losses": losses,
           "step_ms": step_ms, "step_ms_mean": float(np.mean(step_ms)),
           "tokens_per_s": micro * world * seq * len(step_ms) /
           (sum(step_ms) / 1e3),
           "peak_mem_bytes": (torch.cuda.max_memory_allocated() if cuda
                              else None),
           "launches": {"flash": dict(flash.LAUNCHES),
                        "fused_xent": dict(fused_xent.LAUNCHES),
                        "moe": dict(moe_kernels.LAUNCHES),
                        "codec": dict(quant_codec.LAUNCHES)},
           "timed_steps": len(step_ms), "moe_layers": n_moe,
           "num_experts": cfg.num_experts, "d_model": cfg.d_model,
           "capacity": MoE(cfg.moe_config()).capacity(seq, True),
           "a2a": {k: v for k, v in d.items() if k.startswith("moe.a2a")},
           "kernel_fallbacks": d.get("kernel.fallbacks", {}).get("calls", 0),
           "expert_leaf_shapes": held, "expert_moment_shapes": moments,
           "dense_optimizer_state_share": dense_share}
    dsp.set_wire_config(dsp.MoEWireConfig())
    eng.finalize_monitoring()
    del eng, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return rec


def _moe_ep_worker(rank, world, store, device, out_dir, wires, steps, micro,
                   seq, layers, over):
    """One rank of train-moe-ep (gloo on the one card): each wire in turn,
    a fresh engine from the same init."""
    from deepspeed_tpu_torch.comm import dist

    dist.init_distributed(init_method=f"file://{store}", world_size=world,
                          rank=rank, dist_backend="gloo", device=device,
                          verbose=False)
    try:
        got = {w: _moe_ep_run(device, world, w, steps, micro, seq, layers,
                              over) for w in wires}
    finally:
        dist.barrier()
        dist.destroy()
    with open(os.path.join(out_dir, f"moeep{rank}.json"), "w") as f:
        json.dump(got, f)


def phase_train_moe_ep(train_moe, flush, device="cuda", steps=3, seq=2048,
                       layers=12, over=None):
    """train-moe-ep: train-moe's configuration at full width (12 layers,
    d768, 64 experts every other layer, top-1, capacity 1.0, seq 2048,
    bf16, fused CE), global batch 4, ZeRO-1, the implicit reduction,
    expert-parallel over two ranks on the one card over gloo (micro 2
    each): the int8 wire, then the fp32 wire, each a fresh engine from
    the same init over the same `steps` batches (the first a warm-up),
    against world 1 (micro 4, the local dispatch) on those batches:
    losses within 1e-3 relative (fp32 wire: bf16 products over another
    row count) and 2% (int8); step ms and tokens/s beside train-moe's;
    peak memory a rank; 32 experts a rank and their moments, half of
    the dense moments; #13 / #14 twice a MoE layer a step, #11 / #12
    four times a MoE layer a step on int8; the a2a counters equal to the
    plan's bytes; then #11 / #12 timed at one hop's shape (two chunks of
    E/2 x 2 x C x D bf16 elements).  A CPU rehearsal passes `device`
    "cpu", a short `seq` and small widths in `over` (no launches then,
    no timing of the codec)."""
    import tempfile

    import torch

    from deepspeed_tpu_torch.comm import dist

    if dist.is_initialized():
        raise AssertionError("train-moe-ep: a process group is up")
    ref = _moe_ep_run(device, 1, None, steps, 4, seq, layers, over)
    out = tempfile.mkdtemp(prefix="dstpu-moeep-")
    wires = ("int8", "fp32")
    codes = _spawn_ranks(_moe_ep_worker, 2, out,
                         (device, out, wires, steps, 2, seq, layers, over),
                         1200)
    ranks = []
    for r in range(2):
        path = os.path.join(out, f"moeep{r}.json")
        ranks.append(json.load(open(path)) if os.path.exists(path) else None)
    rec = {"phase": "train-moe-ep", "config": f"gpt2 125M+MoE-64 ({layers} "
           "layers, d768, 64 experts on every other layer, top-1, capacity "
           f"1.0, gate noise 1e-2), seq {seq}, global batch 4 (micro 2 a "
           "rank), bf16, fused CE, Adam lr 1e-4, WarmupLR 10, clipping 1.0, "
           "ZeRO-1, implicit reduction, comm.moe sorted + a2a_wire_dtype; "
           "two ranks on the one card over gloo (host-staged collectives: "
           "a time here measures gloo's host staging, not a wire)",
           "exit_codes": codes, "world1": ref,
           "train_moe_step_ms_mean": train_moe["step_ms_mean"],
           "train_moe_tokens_per_s": train_moe["tokens_per_s"],
           "train_moe_peak_mem_bytes": train_moe["peak_mem_bytes"]}
    if codes != [0, 0] or None in ranks:
        emit(rec)
        raise AssertionError(f"train-moe-ep exit codes {codes}")
    rec["ranks"] = ranks
    n_moe = ref["moe_layers"]
    timed = ref["timed_steps"]
    E = ref["num_experts"]
    kern = 1 if device != "cpu" else 0
    for wire, tol in (("int8", 0.02), ("fp32", 1e-3)):
        byt, inter, hops = _a2a_plan_bytes(2, 1, wire, "auto", 2,
                                           ref["capacity"], ref["d_model"],
                                           E=E)
        rel = max(abs(a - b) / abs(b) for r in ranks
                  for a, b in zip(r[wire]["losses"], ref["losses"]))
        q = kern * 4 * n_moe * timed if wire == "int8" else 0
        checks = {
            "max_loss_rel_diff_vs_world1": rel, "loss_rel_tol": tol,
            "plan_bytes_per_traversal": byt}
        rec[f"{wire}_checks"] = checks
        for r in ranks:
            g = r[wire]
            ok = (rel <= tol and not (kern and g["kernel_fallbacks"]) and
                  g["launches"]["moe"] == {k: kern * 2 * n_moe * timed
                                           for k in g["launches"]["moe"]} and
                  g["launches"]["codec"] == {k: q for k in
                                             g["launches"]["codec"]} and
                  g["a2a"]["moe.a2a_bytes"]["bytes"] ==
                  byt * 4 * n_moe * timed and
                  all(s[0] == E // 2 for s in
                      g["expert_leaf_shapes"].values()) and
                  all(s[0] == E // 2 for s in
                      g["expert_moment_shapes"].values()) and
                  0.45 < g["dense_optimizer_state_share"] < 0.55)
            if not ok:
                emit(rec)
                raise AssertionError(f"train-moe-ep {wire} rank "
                                     f"{g['rank']}: {checks}, {g}")
    if device != "cpu":
        rec["codec_at_a2a_chunk_shape"] = codec_wire_shape(
            E // 2 * 2 * ref["capacity"] * ref["d_model"], torch.bfloat16,
            256, flush, rows=2)
    emit(rec)
    return rec


# -- ZeRO stage 3 and the qwZ weight gather -------------------------------------

Z3_SEQ = 64


def _z3_nano_engine(device, stage, precision, wire=None, micro=4, world=2,
                    lr=1e-3):
    """GPT-2 nano (seq 64) at ZeRO `stage` on the implicit wire, qwZ
    `wire` (block 256) when given."""
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import GPT, gpt2_config

    model = GPT(gpt2_config("nano", max_seq_len=Z3_SEQ, vocab_size=64),
                device=device,
                generator=torch.Generator(device=device).manual_seed(4))
    cfg = train_dp_config(stage, "implicit", "fp32", micro, world, lr,
                          precision)
    if wire:
        cfg["zero_optimization"]["quantized_weights"] = wire
        cfg["comm"]["quant_block_size"] = 256
    eng, *_ = dt.initialize(model=model, config_params=cfg, device=device)
    return eng


def _z3_steps(eng, batches):
    losses, norms = [], []
    for b in batches:
        losses.append(float(eng.forward(b)))
        eng.backward()
        eng.step()
        norms.append(eng.get_global_grad_norm())
    return losses, norms


def _bits(t):
    """A CPU copy of `t` as numpy bits (bf16 as int16)."""
    import torch

    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _z3_exact_worker(rank, world, store, device, out_dir, steps, micro):
    """One rank of z3-exact's world 2 (gloo on the one card): stage 2 and
    stage 3 in fp32 and bf16, then qwZ int8 and int4 in bf16 with every
    gather's slices and replicas kept, to `out_dir`."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from deepspeed_tpu_torch.comm import dist
    from deepspeed_tpu_torch.kernels import quant_codec
    from deepspeed_tpu_torch.monitor.counters import COUNTERS

    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_distributed(init_method=f"file://{store}", world_size=world,
                          rank=rank, dist_backend="gloo", device=device,
                          verbose=False)
    batches = list(stride_batches(steps, micro * world, Z3_SEQ, 64, 3))
    got = {}
    try:
        for prec in ("fp32", "bf16"):
            for stage in (2, 3):
                eng = _z3_nano_engine(device, stage, prec, micro=micro,
                                      world=world)
                losses, norms = _z3_steps(eng, batches)
                key = f"{prec}-z{stage}"
                got[f"{key}:losses"] = np.array(losses)
                got[f"{key}:norms"] = np.array(norms)
                for n, v in eng.module_state_dict().items():
                    got[f"{key}:m:{n}"] = v
        for wire in ("int8", "int4"):
            eng = _z3_nano_engine(device, 3, "bf16", wire, micro, world)
            g = eng._qwz_gather
            seen = []
            real = g.gather_leaves

            def spy(indices, slices, out_dtype, real=real, seen=seen):
                out = real(indices, slices, out_dtype)
                seen.append((list(indices), [_bits(s) for s in slices],
                             [_bits(o) for o in out]))
                return out

            g.gather_leaves = spy
            quant_codec.reset_launches()
            snap = COUNTERS.snapshot()
            losses, _ = _z3_steps(eng, batches)
            if device != "cpu":
                torch.cuda.synchronize()
            d = COUNTERS.delta_since(snap).get("qwz.gather", {})
            got[f"{wire}:losses"] = np.array(losses)
            for n, v in eng.module_state_dict().items():
                got[f"{wire}:m:{n}"] = v
            got[f"{wire}:stats"] = np.array([
                d.get("bytes", 0), d.get("calls", 0),
                g.wire_bytes_per_gather, g.collectives_per_gather,
                len(eng._stage3.groups), eng.micro_steps,
                quant_codec.LAUNCHES["quant_codec_quantize"],
                quant_codec.LAUNCHES["quant_codec_dequantize"]])
            got[f"{wire}:gathers"] = np.array(len(seen))
            for k, (idx, sl, reps) in enumerate(seen):
                got[f"{wire}:g{k}:idx"] = np.array(idx)
                got[f"{wire}:g{k}:dims"] = np.array(
                    [eng.zero_plan.leaves[i].dim for i in idx])
                for j, (a, b) in enumerate(zip(sl, reps)):
                    got[f"{wire}:g{k}:s{j}"] = a
                    got[f"{wire}:g{k}:r{j}"] = b
    finally:
        dist.barrier()
        dist.destroy()
    np.savez(os.path.join(out_dir, f"z3x{rank}.npz"), **got)


def qwz_oracle(slices_by_rank, dims, wire, block=256):
    """The replicas of one gather from each rank's bf16 slices through the
    codec's plain version on the CPU (each slice zero-padded to whole
    blocks, quantize, pack, unpack, dequantize to bf16; bitwise JAX's,
    tests/test_torch_zero3.py), each rank's segment put at its place
    along the leaf's dimension."""
    import torch

    from deepspeed_tpu_torch.runtime.comm import quant as q

    rows, sizes = [], []
    for slices in slices_by_rank:
        flats, sizes = [], []
        for s in slices:
            f = s.reshape(-1)
            pad = q.padded_elems(f.numel(), block) - f.numel()
            flats.append(torch.cat([f, f.new_zeros(pad)]))
            sizes.append((f.numel(), f.numel() + pad))
        buf = torch.cat(flats)
        n = buf.numel()
        p, s = q.unpack_wire(q.pack_wire(*q.quantize_blockwise_ref(
            buf, block, wire)), wire, block, n)
        rows.append(q.dequantize_blockwise_ref(p, s, wire, n,
                                               out_dtype=torch.bfloat16))
    out, off = [], 0
    for j, (n, padded) in enumerate(sizes):
        shape = slices_by_rank[0][j].shape
        out.append(torch.cat([r[off:off + n].reshape(shape) for r in rows],
                             dim=int(dims[j])))
        off += padded
    return out


def tracks(ref_losses, ref_masters, losses, masters, wire):
    """tests/test_comm_quant.py's `_assert_tracks` (:326-345), copied:
    the last loss within 2%, every master element inside the wire's
    envelope, a rare near-zero gradient flipped by the quantization
    allowed to drift by Adam's lr.  -> (ok, the numbers)."""
    la, lb = ref_losses[-1], losses[-1]
    rtol = {"int8": 5e-2, "int4": 2.5e-1}[wire]
    max_abs = {"int8": 5e-2, "int4": 1.2e-1}[wire]
    bad_frac = {"int8": 0.05, "int4": 0.12}[wire]
    n_bad = n_total = 0
    worst = 0.0
    for n, x in ref_masters.items():
        diff = np.abs(x - masters[n])
        n_bad += int((diff > 1e-3 + rtol * np.abs(x)).sum())
        n_total += diff.size
        worst = max(worst, float(diff.max()))
    out = {"last_loss_ref": la, "last_loss": lb,
           "loss_rel_tol": 0.02, "max_master_diff": worst,
           "max_master_tol": max_abs, "off_share": n_bad / n_total,
           "off_share_tol": bad_frac}
    ok = abs(la - lb) <= 0.02 * max(abs(la), 1.0) and worst < max_abs \
        and n_bad / n_total < bad_frac
    return ok, out


def phase_z3_exact(device="cuda", steps=3, micro=4):
    """z3-exact: GPT-2 nano (seq 64), two ranks on the one card over gloo,
    deterministic algorithms, TF32 off.  Stage 3 (each block gathered for
    its forward and again for its backward) against stage 2 on the
    implicit wire: losses, clipping norms and masters bitwise, fp32 and
    bf16.  qwZ int8 and int4 (bf16, block 256): every gathered replica
    bitwise `qwz_oracle` of both ranks' slices, the losses and masters
    inside `tracks`' envelope of the unquantized bf16 stage 3, the
    `qwz.gather` bytes the plan's `wire_bytes_per_gather` a pass and #11
    and #12 once a group a pass, two passes a micro step."""
    import tempfile

    import torch

    out = tempfile.mkdtemp(prefix="dstpu-z3x-")
    codes = _spawn_ranks(_z3_exact_worker, 2, out, (device, out, steps,
                                                    micro), 300)
    rec = {"phase": "z3-exact", "config": f"gpt2 nano, seq {Z3_SEQ}, micro "
           f"{micro} a rank, world 2 over gloo on the one card, {steps} "
           "steps, Adam lr 1e-3, clipping 1.0, deterministic algorithms, "
           "TF32 off; qwZ block 256", "exit_codes": codes}
    if codes != [0, 0]:
        emit(rec)
        raise AssertionError(f"z3-exact exit codes {codes}")
    ranks = [dict(np.load(os.path.join(out, f"z3x{r}.npz")))
             for r in range(2)]
    want_kernel = 1 if device != "cpu" else 0

    def masters(r, key):
        return {k.split(":", 2)[2]: v for k, v in r.items()
                if k.startswith(f"{key}:m:")}

    bad = 0
    for r in ranks:
        for prec in ("fp32", "bf16"):
            a, b = f"{prec}-z2", f"{prec}-z3"
            bad += int(not np.array_equal(r[f"{a}:losses"], r[f"{b}:losses"]))
            bad += int(not np.array_equal(r[f"{a}:norms"], r[f"{b}:norms"]))
            ma, mb = masters(r, a), masters(r, b)
            bad += sum(int(not np.array_equal(ma[n], mb[n])) for n in ma)
    rec["stage3_vs_stage2_mismatches"] = bad
    rec["losses"] = {k: ranks[0][f"{k}:losses"].tolist() for k in (
        "fp32-z2", "fp32-z3", "bf16-z2", "bf16-z3", "int8", "int4")}
    rec["qwz"] = {}
    ok = bad == 0
    for wire in ("int8", "int4"):
        n = int(ranks[0][f"{wire}:gathers"])
        rep_bad = 0
        for k in range(n):
            idx = ranks[0][f"{wire}:g{k}:idx"]
            dims = ranks[0][f"{wire}:g{k}:dims"]
            sl = [[torch.from_numpy(r[f"{wire}:g{k}:s{j}"]).view(
                torch.bfloat16) for j in range(len(idx))] for r in ranks]
            want = qwz_oracle(sl, dims, wire)
            for r in ranks:
                for j, w in enumerate(want):
                    got = torch.from_numpy(r[f"{wire}:g{k}:r{j}"]).view(
                        torch.bfloat16)
                    rep_bad += mismatches(got, w)
        st = [ranks[i][f"{wire}:stats"].tolist() for i in range(2)]
        nbytes, calls, wire_bytes, coll, groups, micro_steps, l11, l12 = st[0]
        passes = 2 * micro_steps
        t_ok, env = tracks(ranks[0]["bf16-z3:losses"],
                           masters(ranks[0], "bf16-z3"),
                           ranks[0][f"{wire}:losses"],
                           masters(ranks[0], wire), wire)
        case = {"gathers": n, "replica_mismatches_vs_plain": rep_bad,
                "qwz_gather_bytes": nbytes, "qwz_gather_calls": calls,
                "wire_bytes_per_gather": wire_bytes,
                "collectives_per_gather": coll, "groups": groups,
                "micro_steps": micro_steps, "passes": passes,
                "launches_by_rank": {"quant_codec_quantize": [s[6] for s in st],
                                     "quant_codec_dequantize": [s[7] for s in st]},
                "tracks_unquantized": env}
        rec["qwz"][wire] = case
        ok = ok and rep_bad == 0 and t_ok and \
            nbytes == wire_bytes * passes and calls == coll * passes and \
            n == groups * passes and \
            all(s[6] == s[7] == want_kernel * groups * passes for s in st)
    emit(rec)
    if not ok:
        raise AssertionError(f"z3-exact: {rec}")
    return rec


def _z3_xl_run(device, stage, wire, micro, world, seq, warmup, steps,
               data_seed):
    """GPT-2 XL at full width with the fused CE, bf16, Adam lr 1e-4, at
    ZeRO `stage` on the implicit wire (qwZ `wire`, block 256, when given):
    warm-up, then timed steps with the counts reset just before; peak
    memory from the first step on."""
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.kernels import flash, fused_xent, quant_codec
    from deepspeed_tpu_torch.models import GPT, gpt2_config
    from deepspeed_tpu_torch.monitor.counters import COUNTERS
    from deepspeed_tpu_torch.runtime.comm.quant import padded_elems

    cfg = gpt2_config("xl", loss_impl="pallas", max_seq_len=seq)
    model = GPT(cfg, device=device,
                generator=torch.Generator(device=device).manual_seed(0))
    conf = train_dp_config(stage, "implicit", "fp32", micro, world, 1e-4,
                           "bf16")
    if wire:
        conf["zero_optimization"]["quantized_weights"] = wire
        conf["comm"]["quant_block_size"] = 256
    eng, *_ = dt.initialize(model=model, config_params=conf, device=device)
    del model
    gc.collect()
    cuda = device != "cpu"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    # the peak up to the first optimizer update (the first step's
    # forward, backward and reduction) beside the whole run's: the
    # update's new moments and parameters are a step's last transient
    before_update = [None]
    update = eng.optimizer.update

    def timed_update(*a, **kw):
        if cuda and before_update[0] is None:
            before_update[0] = torch.cuda.max_memory_allocated()
        return update(*a, **kw)

    eng.optimizer.update = timed_update
    data = stride_batches(warmup + steps, micro * world, seq, 64, data_seed)
    losses = [float(eng.train_batch(data)) for _ in range(warmup)]
    for counts in (flash.LAUNCHES, fused_xent.LAUNCHES):
        for k in counts:
            counts[k] = 0
    quant_codec.reset_launches()
    snap = COUNTERS.snapshot()
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(eng.train_batch(data)))
        if cuda:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    d = COUNTERS.delta_since(snap)
    s3, g = eng._stage3, eng._qwz_gather
    plan = eng.zero_plan
    rec = {"stage": stage, "wire": wire, "rank": eng.dp_rank,
           "losses": losses, "step_ms": step_ms,
           "step_ms_mean": float(np.mean(step_ms)),
           "tokens_per_s": micro * world * seq * steps /
           (sum(step_ms) / 1e3),
           "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                              if cuda else None),
           "peak_mem_bytes_before_update": before_update[0],
           "masters_bytes_held": sum(p.numel() * 4 for p in eng._masters),
           "optimizer_state_share": sum(
               t.numel() for t in eng._opt_state["exp_avg"]) /
           sum(math_prod(lp.shape) for lp in plan.leaves),
           "launches": {"flash": dict(flash.LAUNCHES),
                        "fused_xent": dict(fused_xent.LAUNCHES),
                        "quant_codec": dict(quant_codec.LAUNCHES)},
           "kernel_fallbacks": d.get("kernel.fallbacks", {}).get("calls", 0),
           "layers": cfg.num_layers, "steps": steps}
    if s3 is not None:
        rec.update(groups=len(s3.groups), gathers=s3.gathers,
                   peak_replica_bytes=s3.peak_bytes,
                   group_bytes_root=s3.group_bytes()[0],
                   group_bytes_block=max(s3.group_bytes()[1:]))
    if g is not None:
        blk = s3.groups[1]
        rec.update(
            qwz_gather_bytes_per_step=d["qwz.gather"]["bytes"] / steps,
            wire_bytes_per_gather=g.wire_bytes_per_gather,
            collectives_per_gather=g.collectives_per_gather,
            block_slice_elems=sum(padded_elems(
                math_prod(plan.leaves[i].owned_shape), 256) for i in blk))
    eng.finalize_monitoring()
    return rec


def math_prod(shape):
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _z3_train_worker(rank, world, store, device, out_dir, job):
    """One rank of train-z3 (gloo on the one card): stage 2, then stage 3
    with qwZ int8, each from the same init on the same batches."""
    import torch

    from deepspeed_tpu_torch.comm import dist

    dist.init_distributed(init_method=f"file://{store}", world_size=world,
                          rank=rank, dist_backend="gloo", device=device,
                          verbose=False)
    rec = {}
    try:
        for name, stage, wire, warmup, steps in job["cases"]:
            rec[name] = _z3_xl_run(device, stage, wire, job["micro"], world,
                                   job["seq"], warmup, steps, 7)
            gc.collect()
            if device != "cpu":
                torch.cuda.empty_cache()
    finally:
        dist.barrier()
        dist.destroy()
    with open(os.path.join(out_dir, f"z3train{rank}.json"), "w") as f:
        json.dump(rec, f)


def phase_train_z3(device="cuda", seq=1024, micro=1):
    """train-z3: GPT-2 XL at full width (48 layers, d 1600, 25 heads), seq
    1024, micro 1 a rank, bf16, fp32 masters, Adam, the fused CE, two
    ranks on the one card over gloo (whose host staging the step times
    measure, not a wire).  Stage 2 on the implicit wire (1 warm-up, 1
    timed step), then stage 3 with qwZ int8 at block 256 (1 warm-up, 2
    timed): peak memory a rank (stage 3 must hold less), step ms, the
    `qwz.gather` bytes a step (the plan's two passes), #1-#6 and #11 /
    #12 launches a step (#11 / #12 once a gather group a pass), and the
    stage-3 losses within 2% of stage 2's on the same batches.  Then #11
    and #12 timed at a block's fused slice shape against their byte
    bounds, beside their plain versions."""
    import tempfile

    import torch

    out = tempfile.mkdtemp(prefix="dstpu-z3t-")
    job = {"micro": micro, "seq": seq,
           "cases": [("z2", 2, None, 1, 1), ("z3-int8", 3, "int8", 1, 2)]}
    codes = _spawn_ranks(_z3_train_worker, 2, out, (device, out, job), 900)
    ranks = []
    for r in range(2):
        path = os.path.join(out, f"z3train{r}.json")
        ranks.append(json.load(open(path)) if os.path.exists(path) else None)
    rec = {"phase": "train-z3", "config": f"gpt2 xl (48 layers, d 1600, 25 "
           f"heads), seq {seq}, micro {micro} a rank, world 2 over gloo on "
           "the one card, bf16, fp32 masters, Adam lr 1e-4, WarmupLR 10, "
           "clipping 1.0, fused CE; stage 2 implicit wire (1 + 1 steps), "
           "stage 3 qwZ int8 block 256 (1 + 2 steps); stride stream over "
           "tokens < 64", "exit_codes": codes, "ranks": ranks}
    if codes != [0, 0] or None in ranks:
        emit(rec)
        raise AssertionError(f"train-z3 exit codes {codes}")
    n_kernel = 1 if device != "cpu" else 0
    rel = max(abs(a - b) / abs(b) for r in ranks
              for a, b in zip(r["z3-int8"]["losses"], r["z2"]["losses"]))
    rec["max_loss_rel_diff_z3_vs_z2"] = rel
    rec["loss_rel_tol"] = 0.02
    rec["peak_mem_bytes"] = {
        name: [r[name]["peak_mem_bytes"] for r in ranks]
        for name in ("z2", "z3-int8")}
    rec["peak_mem_bytes_before_update"] = {
        name: [r[name]["peak_mem_bytes_before_update"] for r in ranks]
        for name in ("z2", "z3-int8")}
    ok = rel <= 0.02 and all(np.isfinite(r[c]["losses"]).all()
                             for r in ranks for c in ("z2", "z3-int8"))
    for r in ranks:
        z2, z3 = r["z2"], r["z3-int8"]
        if device != "cpu":
            ok = ok and z3["peak_mem_bytes"] < z2["peak_mem_bytes"]
        for case in (z2, z3):
            st = case["steps"]
            ok = ok and case["launches"]["flash"] == {
                k: n_kernel * case["layers"] * st
                for k in case["launches"]["flash"]} and \
                case["launches"]["fused_xent"] == {
                    k: n_kernel * st
                    for k in case["launches"]["fused_xent"]} and \
                not (case["kernel_fallbacks"] and device != "cpu")
        passes = 2 * z3["steps"]
        ok = ok and z3["qwz_gather_bytes_per_step"] == \
            z3["wire_bytes_per_gather"] * 2 and \
            z3["launches"]["quant_codec"] == {
                "quant_codec_quantize": n_kernel * z3["groups"] * passes,
                "quant_codec_dequantize": n_kernel * z3["groups"] * passes}
    if device != "cpu":
        flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
        n = ranks[0]["z3-int8"]["block_slice_elems"]
        rec["codec_at_block_shape"] = {
            "quantize": codec_wire_shape(n, torch.bfloat16, 256,
                                         flush)["quantize"],
            "dequantize": codec_wire_shape(n, torch.bfloat16, 256, flush,
                                           rows=2)["dequantize"],
            "shape": f"one GPT-2 XL block's slices at world 2: {n} bf16 "
                     "elements (each leaf's slice padded to whole blocks) "
                     "quantized int8, block 256; 2 rows of them "
                     "dequantized to bf16"}
        del flush
    emit(rec)
    if not ok:
        raise AssertionError(f"train-z3: {rec}")
    return rec


# -- ZeRO-Offload and ZeRO-Infinity (host Adam, streamed blocks) -------------------

OX_TOL = {"loss_rtol": 1e-4, "master_rtol": 5e-3, "master_atol": 1e-5}


def host_rss_bytes():
    """This process's resident host memory (VmRSS)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return None


def free_host_cache():
    """Return the caching host allocator's pinned blocks to the system."""
    import torch

    gc.collect()
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()


class deterministic:
    """torch's deterministic algorithms for the bitwise comparisons (the
    embedding's backward sums its rows in a fixed order), TF32 off; both
    restored on exit."""

    def __enter__(self):
        import torch

        self.prev = (torch.are_deterministic_algorithms_enabled(),
                     torch.backends.cuda.matmul.allow_tf32)
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        torch.use_deterministic_algorithms(self.prev[0])
        torch.backends.cuda.matmul.allow_tf32 = self.prev[1]


def reset_train_launches():
    from deepspeed_tpu_torch.kernels import flash, fused_xent

    for counts in (flash.LAUNCHES, fused_xent.LAUNCHES):
        for k in counts:
            counts[k] = 0


def train_launches():
    from deepspeed_tpu_torch.kernels import flash, fused_xent

    return {**dict(flash.LAUNCHES), **dict(fused_xent.LAUNCHES)}


def ox_nano_config():
    """GPT nano's depth (3 layers) at head_dim 64 (d 128, 2 heads), seq
    256, vocab 512, the fused CE: the shape at which #1-#6 launch."""
    from deepspeed_tpu_torch.models import gpt2_config

    return gpt2_config("nano", d_model=128, num_heads=2, max_seq_len=256,
                       vocab_size=512, loss_impl="pallas")


def _ox_train(zero, device, steps, precision="fp32", micro=4, seq=256,
              gas=1):
    """`steps` engine steps of the nano model from seed 3 at ZeRO `zero`
    -> (losses, {name: fp32 master copy}, engine, launches)."""
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import GPT

    cfg = ox_nano_config()
    model = GPT(cfg, device=device,
                generator=torch.Generator(device=device).manual_seed(3))
    conf = train_config(micro, 1e-3, precision)
    conf["train_batch_size"] = micro * gas
    conf["gradient_accumulation_steps"] = gas
    conf["zero_optimization"] = zero
    eng, *_ = dt.initialize(model=model, config_params=conf, device=device)
    reset_train_launches()
    losses = []
    for x, y in stride_batches(steps * gas, micro, seq, 64, 5):
        losses.append(float(eng.forward((x, y))))
        eng.backward()
        eng.step()
    launches = train_launches()
    masters = {n: t.detach().float().cpu().clone()
               for n, t in eng.params.items()}
    return losses, masters, eng, launches


def _tracks(ref, got, what):
    """Losses within loss_rtol, masters within master_atol + master_rtol
    |ref| (OX_TOL); returns the worst ratios."""
    (lr_, mr), (lg, mg) = ref, got
    loss = max(abs(a - b) / abs(b) for a, b in zip(lg, lr_))
    w = max(float(((mg[n] - mr[n]).abs() /
                   (OX_TOL["master_atol"] +
                    OX_TOL["master_rtol"] * mr[n].abs())).max())
            for n in mr)
    if not (loss <= OX_TOL["loss_rtol"] and w <= 1.0):
        raise AssertionError(f"{what}: losses {lg} against {lr_} (worst "
                             f"rel {loss}), masters at {w} of the bound")
    return {"max_loss_rel_diff": loss, "max_master_diff_over_tol": w}


def _bitwise(ref, got, what):
    (lr_, mr), (lg, mg) = ref, got
    bad = sum(mismatches(mg[n], mr[n]) for n in mr)
    if lg != lr_ or bad:
        raise AssertionError(f"{what}: losses {lg} against {lr_}, {bad} "
                             "master elements differ")
    return {"loss_mismatches": 0, "master_mismatches": 0}


def phase_offload_exact(device="cuda", steps=3):
    """offload-exact: the nano model, fp32, TF32 off, deterministic
    algorithms.  The offload engine
    (the host Adam) against the port's own ZeRO-0 engine (FusedAdam on
    the device) within OX_TOL; the NVMe-moments run bitwise the RAM run;
    the card's host step (pinned, overlapped copies) bitwise the
    synchronous numpy step on the same gradients, at one GPT-2 XL
    block's leaf shapes, bf16 weights, clipping 1.0, with a step skipped
    for an inf."""
    with deterministic():
        return _offload_exact(device, steps)


def _offload_exact(device, steps):
    import tempfile

    import torch

    from deepspeed_tpu_torch.runtime.zero.offload import CPUOffloadRuntime

    rec = {"phase": "offload-exact", "tolerance": OX_TOL,
           "config": "gpt2 nano depth (3 layers) at d 128, 2 heads (Dh 64), "
                     "seq 256, vocab 512, fused CE, micro 4, fp32, Adam lr "
                     "1e-3, clip 1.0", "steps": steps}
    l0, m0, e0, _ = _ox_train({"stage": 0}, device, steps)
    del e0
    l1, m1, e1, n1 = _ox_train({"stage": 0, "offload_optimizer":
                                {"device": "cpu"}}, device, steps)
    assert e1._opt_state is None and e1._offload is not None
    rec["offload_vs_zero0"] = _tracks((l0, m0), (l1, m1), "offload-exact")
    rec["launches_offload"] = n1
    del e1
    with tempfile.TemporaryDirectory(prefix="dstpu-ox-") as d:
        l2, m2, e2, _ = _ox_train({"stage": 0, "offload_optimizer": {
            "device": "nvme", "nvme_path": d}}, device, steps)
        nv = e2._offload.nvme
        rec["nvme_vs_ram"] = _bitwise((l1, m1), (l2, m2), "offload nvme")
        rec["nvme_aio_engine"] = nv.handle.engine
        rec["nvme_bytes"] = {"read": nv.bytes_read,
                             "written": nv.bytes_written}
        del e2, nv
        gc.collect()
    # the host step: overlapped on the card against synchronous numpy
    from deepspeed_tpu_torch.models import GPT, gpt2_config

    blk = GPT(gpt2_config("xl", num_layers=1), device="meta").blocks[0]
    shapes = [tuple(p.shape) for _, p in sorted(blk.named_parameters())]
    gen = torch.Generator(device="cpu").manual_seed(5)
    leaves = [torch.randn(s, generator=gen) * 0.02 for s in shapes]
    hp = {"lr": 1e-3, "weight_decay": 0.01}
    card = CPUOffloadRuntime(leaves, hp, param_dtype=torch.bfloat16,
                             device=device)
    sync = CPUOffloadRuntime(leaves, hp, param_dtype=torch.bfloat16)
    out = [torch.empty(s, dtype=torch.bfloat16, device=device)
           for s in shapes]
    dgen = torch.Generator(device=device).manual_seed(6)
    steps_rec = []
    for step in range(4):
        g = [torch.randn(s, device=device, generator=dgen) * 64.0
             for s in shapes]
        if step == 2:
            g[-1].view(-1)[7] = float("inf")
        _, ov_c, n_c = card.step(g, 128.0, 1e-3, clip=1.0, out=out)
        host, ov_s, n_s = sync.step([t.cpu().numpy() for t in g], 128.0,
                                    1e-3, clip=1.0)
        if device != "cpu":
            torch.cuda.synchronize()
        bad = sum(mismatches(torch.from_numpy(a), torch.from_numpy(b))
                  for a, b in zip(card.masters, sync.masters))
        if not ov_s:
            bad += sum(mismatches(o.cpu(), h) for o, h in zip(out, host))
        if ov_c != ov_s or n_c != n_s or bad:
            raise AssertionError(f"offload host step {step}: overflow "
                                 f"{ov_c}/{ov_s}, norm {n_c}/{n_s}, {bad} "
                                 "elements differ")
        steps_rec.append({"overflow": ov_c, "norm": n_c,
                          **{k: round(v, 3)
                             for k, v in card.last_timing.items()}})
    rec["host_step_card_vs_sync"] = {
        "leaves": len(shapes), "elements": sum(int(np.prod(s))
                                               for s in shapes),
        "mismatches": 0, "steps": steps_rec}
    del card, sync, out
    free_host_cache()
    emit(rec)
    return rec


def phase_infinity_exact(device="cuda", steps=3):
    """infinity-exact: the nano model, fp32, TF32 off, deterministic
    algorithms.  The streamed
    engine (stage 3 + offload_param) against the resident ZeRO-0 engine
    from the same init: losses within 1e-4 relative, masters 5e-3
    relative + 1e-5; eval losses likewise; params_on_nvme with the
    moments on NVMe bitwise the RAM run; gradient accumulation (gas 2);
    launches exactly #1 2L, #2 / #3 L and #4-#6 1 a micro step."""
    with deterministic():
        return _infinity_exact(device, steps)


def _infinity_exact(device, steps):
    import tempfile

    n_kernel = 1 if device != "cpu" else 0
    rec = {"phase": "infinity-exact", "tolerance": OX_TOL, "steps": steps,
           "config": "as offload-exact"}
    l0, m0, e0, _ = _ox_train({"stage": 0}, device, steps)
    x, y = next(stride_batches(1, 4, 256, 64, 9))
    ev0 = float(e0.eval_batch((x, y)))
    del e0
    inf = {"stage": 3, "offload_param": {"device": "cpu"}}
    l1, m1, e1, n1 = _ox_train(inf, device, steps)
    rt = e1._infinity
    assert rt is not None and e1._opt_state is None and \
        all(p.device.type == "meta" for p in e1.module.parameters())
    rec["infinity_vs_zero0"] = _tracks((l0, m0), (l1, m1), "infinity-exact")
    ev1 = float(e1.eval_batch((x, y)))
    rec["eval_loss"] = {"zero0": ev0, "infinity": ev1}
    if abs(ev1 - ev0) > OX_TOL["loss_rtol"] * abs(ev0):
        raise AssertionError(f"infinity eval {ev1} against {ev0}")
    L = ox_nano_config().num_layers
    want = {"flash_attention_fwd": 2 * L * steps,
            "flash_attention_dq": L * steps, "flash_attention_dkv": L * steps,
            "fused_xent_fwd": steps, "fused_xent_dx": steps,
            "fused_xent_dw": steps}
    rec["launches"] = n1
    rec["launches_wanted"] = {k: n_kernel * v for k, v in want.items()}
    if n1 != rec["launches_wanted"]:
        raise AssertionError(f"infinity launches {n1}, wanted "
                             f"{rec['launches_wanted']}")
    del e1, rt
    with tempfile.TemporaryDirectory(prefix="dstpu-ix-") as d:
        l2, m2, e2, _ = _ox_train({"stage": 3, "offload_param": {
            "device": "nvme", "nvme_path": d}, "offload_optimizer": {
            "device": "nvme", "nvme_path": d}}, device, steps)
        rt = e2._infinity
        rec["nvme_vs_ram"] = _bitwise((l1, m1), (l2, m2), "infinity nvme")
        rec["nvme_aio_engine"] = rt.pager.engine
        rec["nvme_bytes"] = {
            "masters_read": rt.pager.bytes_read,
            "masters_written": rt.pager.bytes_written,
            "moments_read": rt.nvme.bytes_read,
            "moments_written": rt.nvme.bytes_written}
        del e2, rt
        gc.collect()
    # gradient accumulation: two micro steps of half the rows
    lg, mg, eg, _ = _ox_train(inf, device, steps, micro=2, gas=2)
    rec["gas2_losses"] = lg
    del eg
    free_host_cache()
    emit(rec)
    return rec


def _xl_engine_run(kind, device, layers, seq, micro, warmup, steps,
                   nvme_dir=None):
    """GPT-2 XL widths (`layers` deep), bf16, Adam lr 1e-4, WarmupLR,
    clip 1.0, fused CE, from DSTPU_SEED's init (the resident model drawn
    from a generator of that seed, the streamed one by `stream_init`, the
    same weights): kind "zero0", "offload" or "infinity" (RAM, or
    `nvme_dir` for masters and moments).  Warm-up, then timed steps with
    the counts reset just before: device peak from the first step on,
    step ms split into device busy, D2H, host Adam and H2D, host memory,
    #1-#6 launches."""
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import GPT, gpt2_config
    from deepspeed_tpu_torch.monitor.counters import COUNTERS

    cuda = device != "cpu"
    seed = int(os.environ.get("DSTPU_SEED", 42))
    cfg = gpt2_config("xl", loss_impl="pallas", max_seq_len=seq,
                      num_layers=layers)
    zero = {"zero0": {"stage": 0},
            "offload": {"stage": 0, "offload_optimizer": {"device": "cpu"}},
            "infinity": {"stage": 3, "offload_param": {"device": "cpu"}}}[kind]
    if nvme_dir is not None:
        zero = {"stage": 3,
                "offload_param": {"device": "nvme", "nvme_path": nvme_dir},
                "offload_optimizer": {"device": "nvme",
                                      "nvme_path": nvme_dir}}
    conf = train_config(micro, 1e-4, "bf16")
    conf["zero_optimization"] = zero
    rss0 = host_rss_bytes()
    t0 = time.perf_counter()
    if kind == "infinity":
        model = GPT(cfg, device="meta")
    else:
        model = GPT(cfg, device=device,
                    generator=torch.Generator(device=device).manual_seed(seed))
    eng, *_ = dt.initialize(model=model, config_params=conf, device=device)
    del model
    gc.collect()
    init_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    rt = eng._infinity
    if rt is not None:
        rt.profile = True
    data = stride_batches(warmup + steps, micro, seq, 64, 7)
    losses, split = [], []
    for i in range(warmup + steps):
        if i == warmup:
            reset_train_launches()
            snap = COUNTERS.snapshot()
            if rt is not None:
                rt.timing()
                if rt.pager is not None:
                    io0 = (rt.pager.bytes_read, rt.pager.bytes_written,
                           rt.nvme.bytes_read, rt.nvme.bytes_written)
        x, y = next(data)
        ts = time.perf_counter()
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        loss = eng.forward((x, y))
        if cuda:
            e1.record()
        eng.backward()
        eng.step()
        losses.append(float(loss))
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - ts) * 1e3
        s = {"step_ms": ms}
        if rt is not None:
            t = rt.timing()
            s.update(device_busy_ms=t["compute_ms"], h2d_ms=t["h2d_ms"],
                     d2h_ms=t["d2h_ms"], host_check_ms=t["host_check_ms"],
                     host_adam_ms=t["adam_ms"])
        elif cuda:
            s["device_fwd_bwd_ms"] = e0.elapsed_time(e1)
            if eng._offload is not None:
                lt = eng._offload.last_timing
                s.update(device_busy_ms=s["device_fwd_bwd_ms"],
                         d2h_ms=lt.get("d2h_ms"),
                         host_check_ms=lt.get("host_check_ms"),
                         host_adam_ms=lt.get("adam_ms"),
                         h2d_ms=lt.get("h2d_ms"))
        if i >= warmup:
            split.append(s)
    d = COUNTERS.delta_since(snap)
    step_ms = [s["step_ms"] for s in split]
    rec = {"kind": kind if nvme_dir is None else "infinity-nvme",
           "layers": layers, "init_s": init_s, "losses": losses,
           "step_ms": step_ms, "step_ms_mean": float(np.mean(step_ms)),
           "tokens_per_s": micro * seq * steps / (sum(step_ms) / 1e3),
           "split": split,
           "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                              if cuda else None),
           "host_rss_bytes": host_rss_bytes(),
           "host_rss_growth_bytes": host_rss_bytes() - rss0,
           "launches": train_launches(),
           "kernel_fallbacks": d.get("kernel.fallbacks", {}).get("calls", 0),
           "steps": steps}
    host = rt if rt is not None else eng._offload
    if host is not None:
        rec["runtime_host_bytes"] = host.host_bytes()
        rec["pinned_bytes"] = host.pinned_bytes()
    if rt is not None and rt.pager is not None:
        io1 = (rt.pager.bytes_read, rt.pager.bytes_written,
               rt.nvme.bytes_read, rt.nvme.bytes_written)
        rec["nvme_bytes_per_step"] = dict(zip(
            ("masters_read", "masters_written", "moments_read",
             "moments_written"), [(b - a) / steps for a, b in zip(io0, io1)]))
        rec["aio_engine"] = rt.pager.engine
    if rt is not None:
        rec["device_param_tensors"] = sum(
            1 for p in eng.module.parameters() if p.device.type != "meta")
    eng.finalize_monitoring()
    del eng, rt, host
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    free_host_cache()
    return rec


def _check_xl(rec, layers, device):
    n_kernel = 1 if device != "cpu" else 0
    st = rec["steps"]
    infinity = rec["kind"].startswith("infinity")
    fwd = (2 if infinity else 1) * layers * st
    want = {"flash_attention_fwd": fwd, "flash_attention_dq": layers * st,
            "flash_attention_dkv": layers * st, "fused_xent_fwd": st,
            "fused_xent_dx": st, "fused_xent_dw": st}
    want = {k: n_kernel * v for k, v in want.items()}
    ok = rec["launches"] == want and np.isfinite(rec["losses"]).all() and \
        not (rec["kernel_fallbacks"] and device != "cpu")
    if infinity:
        ok = ok and rec["device_param_tensors"] == 0
    return ok, want


def phase_train_offload_infinity(device="cuda", seq=1024, micro=1,
                                 layers=48, warmup=1, steps=2):
    """train-offload and train-infinity: GPT-2 XL at full width (48
    layers, d 1600, 25 heads, 1.56 B parameters), seq 1024, micro 1,
    bf16, fp32 masters, Adam, WarmupLR, clip 1.0, fused CE, dropout 0;
    1 warm-up + 2 timed steps each: ZeRO-0 on the card, then ZeRO-Offload
    (stage 0, offload_optimizer cpu), then ZeRO-Infinity (stage 3,
    offload_param cpu), from the same init on the same batches.  Device
    peak must fall from ZeRO-0 to Offload to Infinity; #1 L (Infinity
    2L), #2 / #3 L and #4-#6 once a step; losses within 2% of ZeRO-0's."""
    runs = {}
    for kind in ("zero0", "offload", "infinity"):
        runs[kind] = _xl_engine_run(kind, device, layers, seq, micro, warmup,
                                    steps)
        emit({"phase": f"train-{kind}", **runs[kind]})
    rec = {"phase": "train-offload-infinity",
           "config": f"gpt2 xl widths, {layers} layers, seq {seq}, micro "
                     f"{micro}, bf16, fp32 masters, Adam lr 1e-4, WarmupLR "
                     "10, clip 1.0, fused CE, dropout 0; stride stream over "
                     "tokens < 64", "loss_rel_tol": 0.02}
    ok = True
    for kind, r in runs.items():
        good, want = _check_xl(r, layers, device)
        ok = ok and good
        rec[f"{kind}_launches_wanted"] = want
        rec[f"{kind}_loss_rel_diff_vs_zero0"] = max(
            abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                runs["zero0"]["losses"]))
        ok = ok and rec[f"{kind}_loss_rel_diff_vs_zero0"] <= 0.02
    peaks = [runs[k]["peak_mem_bytes"] for k in ("zero0", "offload",
                                                 "infinity")]
    rec["peak_mem_bytes"] = dict(zip(("zero0", "offload", "infinity"),
                                     peaks))
    if device != "cpu":
        ok = ok and peaks[0] > peaks[1] > peaks[2]
    emit(rec)
    if not ok:
        raise AssertionError(f"train-offload-infinity: {rec}")
    return runs


def phase_train_infinity_nvme(device="cuda", seq=1024, micro=1, layers=4,
                              warmup=1, steps=2):
    """train-infinity-nvme: GPT-2 XL widths with the depth cut to 4
    layers (a cut), masters and moments on NVMe in a temporary directory
    removed afterwards: bytes read and written a step, the aio engine
    that ran, step ms split, #1-#6 launches."""
    import shutil
    import tempfile

    d = tempfile.mkdtemp(prefix="dstpu-inf-nvme-")
    try:
        r = _xl_engine_run("infinity", device, layers, seq, micro, warmup,
                           steps, nvme_dir=d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    ok, want = _check_xl(r, layers, device)
    rec = {"phase": "train-infinity-nvme",
           "config": f"gpt2 xl widths, depth cut to {layers} layers, seq "
                     f"{seq}, micro {micro}, bf16, masters and moments on "
                     "NVMe (a temporary directory, removed)", **r,
           "launches_wanted": want}
    ok = ok and all(v > 0 for v in r["nvme_bytes_per_step"].values())
    emit(rec)
    if not ok:
        raise AssertionError(f"train-infinity-nvme: {rec}")
    return rec


# -- BERT pretraining through the sparse kernels ----------------------------------


def bert_batches(steps, micro, seq, vocab, seed, mask_id=103):
    """MLM + NSP batches over `vocab_batches`' Zipf stream: 15% of the
    positions labelled, their inputs replaced by [MASK] (id 103 in BERT's
    vocabulary), segment ids for two halves, random NSP labels, and no
    attention mask (packed full-length pretraining sequences)."""
    rng = np.random.RandomState(seed + 1)
    segments = (np.arange(seq) >= seq // 2).astype(np.int64)
    for x, _ in vocab_batches(steps, micro, seq, vocab, seed):
        pick = rng.rand(micro, seq) < 0.15
        yield {"input_ids": np.where(pick, mask_id, x),
               "token_type_ids": np.repeat(segments[None], micro, 0),
               "mlm_labels": np.where(pick, x, -100),
               "nsp_labels": rng.randint(0, 2, micro)}


def bert_large_sparse(seq, **over):
    """BERT-large at published widths (24 layers, d1024, 16 heads, d_ff
    4096, vocab 30528, pre-LN, dropout 0.1) with the tutorial's fixed
    sparsity at block 128."""
    from deepspeed_tpu_torch.models import bert_config
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig

    return bert_config("bert-large", max_seq_len=seq,
                       sparsity_config=FixedSparsityConfig(
                           num_heads=16, block=128, **BERT_SPARSITY), **over)


def phase_bert_sparse_exact():
    """fp32, TF32 off: BERT-large width (d1024, 16 heads), 2 layers, seq
    1024, block 128, micro 2, attention and hidden dropout 0.1, 5 engine
    steps through kernels #7-#9, then the same steps from the same weights
    with their plain versions forced (per-step loss within 1e-4, weights
    within 2 lr steps: the two differ in the order of fp32 sums only);
    then at dropout 0 the kernel walk against the gather path
    (`block_sparse_attention`, the same function), likewise."""
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.kernels import flash_sparse as fsk
    from deepspeed_tpu_torch.kernels import registry
    from deepspeed_tpu_torch.models import Bert
    from deepspeed_tpu_torch.monitor.counters import COUNTERS
    from deepspeed_tpu_torch.ops.sparse_attention import flash_sparse as ofs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr, steps, micro, seq = 1e-4, 5, 2, 1024
    real_dispatch = ofs.dispatch

    def plain_sparse(name, *a, impl="auto", **kw):
        if name.startswith("flash_sparse_"):
            impl = "torch"
        return real_dispatch(name, *a, impl=impl, **kw)

    def run(dropout, path):
        cfg = bert_large_sparse(seq, num_layers=2, attn_dropout=dropout,
                                hidden_dropout=dropout,
                                compute_dtype=torch.float32)
        model = Bert(cfg, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(3))
        eng, *_ = dt.initialize(model=model,
                                config_params=train_config(micro, lr, "fp32"))
        n0 = dict(fsk.LAUNCHES)
        snap = COUNTERS.snapshot()
        ofs.dispatch = plain_sparse if path == "plain" else real_dispatch
        try:
            with registry.kernel_config(ops={
                    "sparse_attention": "xla" if path == "gather"
                    else "auto"}):
                losses = []
                for batch in bert_batches(steps, micro, seq, cfg.vocab_size,
                                          5):
                    losses.append(float(eng.forward(batch)))
                    eng.backward()
                    eng.step()
        finally:
            ofs.dispatch = real_dispatch
        d = COUNTERS.delta_since(snap)
        out = (losses, {n: p.detach().clone() for n, p in eng.params.items()},
               {k: fsk.LAUNCHES[k] - n0[k] for k in n0},
               d.get("kernel.fallbacks", {"calls": 0})["calls"])
        del eng, model
        gc.collect()
        torch.cuda.empty_cache()
        return out

    pairs = {"dropout": (run(0.1, "kernel"), run(0.1, "plain")),
             "gather": (run(0.0, "kernel"), run(0.0, "gather"))}
    rec = {"phase": "bert-sparse-exact", "config": "bert-large width (d1024, "
           "16 heads, d_ff 4096, vocab 30528), 2 layers, seq 1024, micro 2, "
           "fixed layout block 128 (local 4, global 1), fp32, TF32 off, "
           "Adam lr 1e-4", "steps": steps, "loss_tol": 1e-4,
           "weight_tol": 2 * lr * steps}
    per_run = 2 * steps                  # 2 layers, one launch each a step
    for key, ((lk, pk, nk, fk), (lp, pp, npl, fp)) in pairs.items():
        other = "plain" if key == "dropout" else "gather"
        loss_err = max(abs(a - b) for a, b in zip(lk, lp))
        w_err = max((pk[n] - pp[n]).abs().max().item() for n in pk)
        rec[key] = {"runs": f"kernel vs {other}",
                    "dropout": 0.1 if key == "dropout" else 0.0,
                    "launches_kernel_run": nk, "launches_other_run": npl,
                    "fallbacks_kernel_run": fk, "fallbacks_other_run": fp,
                    "losses_kernel": lk, f"losses_{other}": lp,
                    "max_loss_diff": loss_err, "max_weight_diff": w_err}
        if nk != {k: per_run for k in nk} or any(npl.values()) or fk:
            raise AssertionError(f"bert-sparse-exact ({key}): kernels "
                                 f"launched {nk} / {npl}, fallbacks {fk}")
        if not (loss_err <= 1e-4 and w_err <= 2 * lr * steps):
            raise AssertionError(f"bert-sparse-exact ({key}): losses differ "
                                 f"by {loss_err}, weights by {w_err}")
    emit(rec)
    return rec


def phase_train_bert_sparse(warmup=3, steps=10):
    """BERT-large (24 layers, d1024, 16 heads) MLM + NSP pretraining at seq
    4096 with the fixed layout at block 128 (local 4, global 1: 11 active
    blocks a row of 32), micro 2 (8,192 tokens a step), bf16 with fp32
    masters, Adam 1e-4, WarmupLR, clipping 1.0, dropout 0.1, no attention
    mask, the position table extended from 512 to 4096 rows by
    SparseAttentionUtils.extend_position_embedding; Zipf token stream.
    Warm-up steps, then timed steps with the launch counts reset just
    before: each of #7-#9 exactly 24 x steps."""
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.kernels import flash, flash_sparse, fused_xent
    from deepspeed_tpu_torch.models import Bert
    from deepspeed_tpu_torch.monitor.counters import COUNTERS
    from deepspeed_tpu_torch.ops.sparse_attention import SparseAttentionUtils

    micro, seq = 2, 4096
    cfg = bert_large_sparse(seq)
    model = Bert(cfg, device="cuda",
                 generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        pe = model.embeddings["position"]
        pe.copy_(SparseAttentionUtils.extend_position_embedding(
            pe[:512].clone(), seq))
    eng, *_ = dt.initialize(model=model,
                            config_params=train_config(micro, 1e-4, "bf16"))
    data = bert_batches(warmup + steps + 2, micro, seq, cfg.vocab_size, 0)
    losses = [float(eng.train_batch(data)) for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counts in (flash_sparse.LAUNCHES, flash.LAUNCHES, fused_xent.LAUNCHES):
        for k in counts:
            counts[k] = 0
    snap = COUNTERS.snapshot()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    step_ms, timed = [], []
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
    launches = dict(flash_sparse.LAUNCHES)
    d = COUNTERS.delta_since(snap)
    losses += [float(x) for x in timed]
    if launches != {k: cfg.num_layers * steps for k in launches} or \
            any(flash.LAUNCHES.values()) or any(fused_xent.LAUNCHES.values()):
        raise AssertionError(f"sparse launches {launches} (dense flash "
                             f"{flash.LAUNCHES}), expected {cfg.num_layers} "
                             f"x {steps} each")
    if d.get("kernel.fallbacks") or \
            d["kernel.dispatches"]["calls"] != 3 * cfg.num_layers * steps:
        raise AssertionError(f"the gather path or a plain version ran on "
                             f"the training path: {d}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    tokens = micro * seq * steps
    rec = {"phase": "train-bert-sparse",
           "config": "bert-large (24 layers, d1024, 16 heads, d_ff 4096, "
           "vocab 30528, pre-LN, dropout 0.1), seq 4096, micro 2, gas 1, "
           "bf16, Adam lr 1e-4, WarmupLR 10 steps, clipping 1.0; fixed "
           "sparsity block 128 (local 4, global 1), no attention mask; "
           "MLM 15% + NSP over a Zipf stream of the 30528 ids",
           "warmup_steps": warmup, "timed_steps": steps,
           "tokens_per_s": tokens / (sum(step_ms) / 1e3),
           "step_ms_mean": float(np.mean(step_ms)),
           "step_ms_min": float(np.min(step_ms)),
           "device_span_ms": span_ms,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "param_count": sum(p.numel() for p in eng.params.values()),
           "first_loss": losses[0], "last_loss": losses[-1],
           "losses": losses, "sparse_launches": launches}
    emit(rec)
    return rec, eng, data


def sparse_entries(sparse_cases, probe, train_bert, exact):
    main = sparse_cases[0]           # the training shape, bf16
    out = []
    # name, JAX line, output whose error is reported, route key (the
    # kernels that have more than one route)
    for name, line, err, route in (("flash_sparse_fwd", 73, "out", "fwd_route"),
                                   ("flash_sparse_dq", 171, "dq", "dq_route"),
                                   ("flash_sparse_dkv", 208, "dk", None)):
        k = main["kernels"][name]
        out.append({
            "name": name, "route": "cuda",
            "source": "deepspeed_tpu_torch/kernels/csrc/flash_sparse.cu",
            "replaces": "deepspeed_tpu/ops/sparse_attention/flash_sparse.py:"
                        f"{line}",
            "launches": train_bert["sparse_launches"][name],
            "launches_by_path": {
                "train-bert-sparse (timed steps)":
                    train_bert["sparse_launches"][name],
                "bert-sparse-exact (kernel runs)":
                    exact["dropout"]["launches_kernel_run"][name] +
                    exact["gather"]["launches_kernel_run"][name]},
            "max_abs_err": main["max_abs_err"][err],
            "max_err_over_tol": main["max_err_over_tol"],
            "ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            # SDPA with the layout as a boolean mask for the forward; its
            # backward (dQ, dK and dV in one call) jointly for #8 and #9
            "library_ms": k["library_ms"],
            **({"library_joint": k["library_joint"]}
               if "library_joint" in k else {}),
            "dense_flash_ms": main["dense_flash_ms"][
                name.replace("sparse", "attention")],
            **({"kernel_route": main[route],
                "routes_by_case": {c["case"]: c[route]
                                   for c in sparse_cases}}
               if route else {}),
            "shape": "B=2 S=4096 H=16 Dh=64 bf16, fixed layout block 128 "
                     f"(W {main['W']}, Wq {main['Wq']}, density "
                     f"{main['density']:.3f})",
            "mask_probe": {p["layout"]: {d: c["mask_mismatches"]
                                         for d, c in p["cases"].items()}
                           for p in probe},
            "domain": domain(sparse_cases, ("Dh", "block", "dtype")),
            "cases": [{"case": c["case"],
                       "max_err_over_tol": c["max_err_over_tol"],
                       **({"kernel_ms": c["kernels"][name]["kernel_ms"],
                           "plain_ms": c["kernels"][name]["plain_ms"],
                           "bound_ms": c["kernels"][name]["bound_ms"]}
                          if "kernel_ms" in c["kernels"][name] else {})}
                      for c in sparse_cases]})
    return out


def build_all():
    """Compile the kernel libraries, one nvcc per source, and the host
    ops (the CPU Adam, the aio engine), one g++ each, all started
    together; returns the build record."""
    from deepspeed_tpu_torch.kernels import build
    from deepspeed_tpu_torch.ops import op_builder

    sources = ("paged_attention.cu", "paged_attention_f16.cu",
               "paged_attention_int8.cu", "paged_attention_int4.cu",
               "flash_attention.cu", "fused_xent.cu",
               "quant_codec.cu", "moe_dispatch.cu", "flash_sparse.cu")
    t0 = time.perf_counter()

    def timed_build(src):
        t = time.perf_counter()
        build.build(src)
        return src, time.perf_counter() - t

    def timed_host_op(name):
        t = time.perf_counter()
        op_builder.get_op(name)
        return name, time.perf_counter() - t

    with ThreadPoolExecutor(len(sources) + 2) as pool:
        host = pool.map(timed_host_op, list(op_builder.ALL_OPS))
        each = dict(pool.map(timed_build, sources))
        host = dict(host)
    from deepspeed_tpu_torch.ops.aio import uring_supported

    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "seconds_by_source": each,
            "host_ops": {"seconds": host,
                         "compiler": op_builder.builder.find_cxx(),
                         "io_uring_supported": uring_supported()},
            "ptxas": {src: [ln.strip() for ln in
                            build.BUILD_LOGS.get(src, "").splitlines()
                            if "registers" in ln or "Compiling entry" in ln
                            or "spill" in ln]
                      for src in sources}}


def z3_launches(train_z3, family, name):
    """train-z3's launches of one kernel, each rank, stage 2 and stage 3
    (qwZ int8)."""
    return {f"train-z3 {case} rank {r['z2']['rank']}":
            r[case]["launches"][family][name]
            for r in train_z3["ranks"] for case in ("z2", "z3-int8")}


def xl_launches(xl_runs, name):
    """train-zero0 / train-offload / train-infinity (GPT-2 XL) and
    train-infinity-nvme launches of one of #1-#6 over their timed
    steps."""
    return {f"train-{r['kind']}": r["launches"][name] for r in xl_runs}


def flash_entries(flash_cases, train, train_resume, train_dp, train_z3,
                  xl_runs):
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
            "launches_by_path": {
                "train": train["flash_launches"][name],
                "train-resume": train_resume["launches"][name],
                **dp_launches(train_dp, "flash", name),
                **z3_launches(train_z3, "flash", name),
                **xl_launches(xl_runs, name)},
            "max_abs_err": main["max_abs_err"][
                {"fwd": "out", "dq": "dq", "dkv": "dk"}[short]],
            "ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k.get("library_ms"),
            **({"library_joint": k["library_joint"]}
               if "library_joint" in k else {}),
            **({"kernel_route": main[f"{short}_route"]}
               if short in ("dq", "dkv") else {}),
            "shape": "B=8 S=1024 H=12 Dh=64 bf16 causal",
            "cases": [{"case": c["case"],
                       "max_err_over_tol": c["max_err_over_tol"],
                       "routes": {"dq": c["dq_route"],
                                  "dkv": c["dkv_route"]},
                       **({"kernel_ms": c["kernels"][name]["kernel_ms"],
                           "plain_ms": c["kernels"][name]["plain_ms"],
                           "bound_ms": c["kernels"][name]["bound_ms"]}
                          if "kernel_ms" in c["kernels"][name] else {})}
                      for c in flash_cases]})
    if "sdpa_fwd_bwd_ms" in main:
        out[0]["sdpa_fwd_bwd_ms"] = main["sdpa_fwd_bwd_ms"]
    dom = domain(flash_cases)
    for e in out:
        e["domain"] = dom
    return out


def domain(cases, keys=("Dh", "dtype")):
    """The head dims (and blocks, dtypes) a family's cases launched."""
    return {k: sorted({c[k] for c in cases}) for k in keys}


def xent_entries(xent_cases, train_pallas, train_resume, train_dp,
                 train_z3, xl_runs):
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
            "launches_by_path": {
                "train-pallas": train_pallas["fused_xent_launches"][name],
                "train-resume": train_resume["launches"][name],
                **dp_launches(train_dp, "fused_xent", name),
                **z3_launches(train_z3, "fused_xent", name),
                **xl_launches(xl_runs, name)},
            "max_abs_err": main["max_abs_err"][err],
            "ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            # no one PyTorch call computes the fused CE; the forward's bf16
            # product alone is the yardstick beside it
            "library_ms": None, "matmul_ms": main["matmul_ms"],
            "shape": "N=8192 D=768 V=50304 bf16, tied head",
            **({"kernel_route": main["dw_route"],
                "design": "the wgmma kernel issues the bound's two "
                          "products once (over N and V rounded up to its "
                          "16- and 64-row tiles); the count, derived from "
                          "the design, is the xent record's "
                          "dw_tensor_flops_by_design"}
               if name == "fused_xent_dw" else {}),
            **({"kernel_route": main["dx_route"],
                "design": "the wgmma kernel in its dx role issues the "
                          "bound's two products once (over N and V rounded "
                          "up to its 64- and 16-row tiles); the count, "
                          "derived from the design, is the xent record's "
                          "dx_tensor_flops_by_design"}
               if name == "fused_xent_dx" else {}),
            **({"kernel_route": main["fwd_route"],
                "design": "the wgmma forward issues the bound's product "
                          "once over N, V and D rounded up to its 128 x "
                          "256 tiles and 64-column chunks; the count, "
                          "derived from the design, is the xent record's "
                          "fwd_tensor_flops_by_design"}
               if name == "fused_xent_fwd" else {}),
            "cases": [{"case": c["case"],
                       "max_err_over_tol": c["max_err_over_tol"],
                       "kernel_ms": c["kernels"][name].get("kernel_ms"),
                       "plain_ms": c["kernels"][name].get("plain_ms"),
                       "bound_ms": c["kernels"][name]["bound_ms"],
                       **({"kernel_route": c["fwd_route"]}
                          if name == "fused_xent_fwd" else {}),
                       **({"kernel_route": c["dw_route"]}
                          if name == "fused_xent_dw" else {}),
                       **({"kernel_route": c["dx_route"]}
                          if name == "fused_xent_dx" else {})}
                      for c in xent_cases]})
    return out


def wire_codec_launches(train_dp_qgz, train_moe_ep, name):
    """#11's or #12's launches on the quantized wires' paths: train-dp-qgz
    (world 1 over NCCL, each rank of world 2 over gloo) and train-moe-ep's
    int8 wire (each rank)."""
    out = {"train-dp-qgz world 1":
           train_dp_qgz["world1"]["quant_launches"][name]}
    for r in (train_dp_qgz.get("world2") or {}).get("ranks", []):
        out[f"train-dp-qgz world 2 rank {r['rank']}"] = \
            r["quant_launches"][name]
    for r in train_moe_ep["ranks"]:
        out[f"train-moe-ep rank {r['int8']['rank']} (int8 wire)"] = \
            r["int8"]["launches"]["codec"][name]
    return out


def qwz_codec_launches(z3_exact, train_z3, name):
    """#11's or #12's launches on the qwZ weight gather's path: z3-exact
    (int8 and int4, each rank) and train-z3's stage 3 (each rank)."""
    out = {}
    for wire in ("int8", "int4"):
        for r, n in enumerate(z3_exact["qwz"][wire]["launches_by_rank"][
                name]):
            out[f"z3-exact qwZ {wire} rank {r}"] = n
    for r in train_z3["ranks"]:
        out[f"train-z3 qwZ int8 rank {r['z3-int8']['rank']}"] = \
            r["z3-int8"]["launches"]["quant_codec"][name]
    return out


def codec_entries(codec, serve_qw, train_dp_qgz, train_moe_ep, z3_exact,
                  train_z3):
    tree = serve_qw["codec_tree"]
    block = train_z3.get("codec_at_block_shape", {})
    leaves = serve_qw["quantize_launches_at_build"]
    q, dq = tree["quantize-int8"], tree["dequantize-int8"]
    common = {"route": "cuda", "bound_by": "bytes", "library_ms": None,
              "source": "deepspeed_tpu_torch/kernels/csrc/quant_codec.cu",
              "mismatches": serve_qw["leaf_mismatches"],
              "per_leaf_shape_l2_flushed":
                  serve_qw["codec_per_shape_l2_flushed"]}
    return [
        {"name": "quant_codec_quantize",
         "replaces": "deepspeed_tpu/kernels/quant_codec.py:64",
         "launches": leaves,
         "launches_by_path": {
             "serve-qw (build)": leaves,
             **wire_codec_launches(train_dp_qgz, train_moe_ep,
                                   "quant_codec_quantize"),
             **qwz_codec_launches(z3_exact, train_z3,
                                  "quant_codec_quantize")},
         "qwz_block_shape": {"shape": block.get("shape"),
                             **(block.get("quantize") or {})},
         "qgz_bucket_shape":
             train_dp_qgz.get("codec_at_bucket_shape", {}).get("quantize"),
         "a2a_chunk_shape":
             train_moe_ep["codec_at_a2a_chunk_shape"]["quantize"],
         "launches_by_kernel_route":
             serve_qw["quantize_launches_at_build_by_route"],
         "kernel_routes": "vector: block % 8 == 0, block / 8 a power of "
                          "two up to 32 or a multiple of 32, x 16-byte "
                          "aligned (quant_codec.route_of); generic: the "
                          "rest",
         "max_abs_err": serve_qw["leaf_max_abs_err"]["quantize_max_abs_err"],
         # device times (torch.profiler) over the tree's quantize loop,
         # the build's loop run again; the build itself as an events span
         "ms": q["kernel_ms"], "plain_ms": q["plain_ms"],
         "bound_ms": q["bound_ms"],
         "build_span_ms": serve_qw["quantize_build_ms"],
         "span_ms": q["kernel_span_ms"], "plain_span_ms": q["plain_span_ms"],
         "shape": f"every matrix leaf of gpt2 xl bf16 ({leaves} leaves, "
                  f"{tree['elements']} elements), int8, block 256: the "
                  "engine's one-time build", **common,
         "cases": [{k: c[k] for k in ("case", "route", "mismatches",
                                      "quantize_max_abs_err")}
                   for c in codec["cases"]]},
        {"name": "quant_codec_dequantize",
         "replaces": "deepspeed_tpu/kernels/quant_codec.py:128",
         "launches": serve_qw["dequantize_launches"],
         "launches_by_path": {
             "serve-qw (forwards)": serve_qw["dequantize_launches"],
             **wire_codec_launches(train_dp_qgz, train_moe_ep,
                                   "quant_codec_dequantize"),
             **qwz_codec_launches(z3_exact, train_z3,
                                  "quant_codec_dequantize")},
         "qwz_block_shape": {"shape": block.get("shape"),
                             **(block.get("dequantize") or {})},
         "qgz_bucket_shape":
             train_dp_qgz.get("codec_at_bucket_shape", {}).get("dequantize"),
         "a2a_chunk_shape":
             train_moe_ep["codec_at_a2a_chunk_shape"]["dequantize"],
         "max_abs_err":
             serve_qw["leaf_max_abs_err"]["dequantize_max_abs_err"],
         # the profiler's device time of a served forward's dequantizes;
         # the same over one loop of the tree's leaves, beside the plain
         # version's, and both loops' spans
         "ms": serve_qw["profile"]["dequantize_ms_per_forward"],
         "tree_loop_ms": dq["kernel_ms"], "plain_ms": dq["plain_ms"],
         "bound_ms": dq["bound_ms"],
         "span_ms": dq["kernel_span_ms"], "plain_span_ms": dq["plain_span_ms"],
         "shape": f"one forward: every matrix leaf of gpt2 xl ({leaves}) "
                  "int8 -> bf16, block 256", **common,
         "int4": tree["dequantize-int4"],
         "cases": [{k: c[k] for k in ("case", "mismatches",
                                      "dequantize_max_abs_err")}
                   for c in codec["cases"]]}]


def dp_launches(train_dp, family, name):
    """train-dp's launches of one kernel: world 1 (NCCL), and each rank
    of world 2 on the one card (gloo) where it ran."""
    out = {"train-dp world 1": train_dp["world1"]["launches"][family][name]}
    for r in (train_dp.get("world2") or {}).get("ranks", []):
        out[f"train-dp world 2 rank {r['rank']}"] = \
            r["launches"][family][name]
    return out


def moe_entries(moe_cases, train_moe, overflow_case, train_dropless,
                train_moe_ep):
    main = moe_cases[0]              # the training shape, top-1, bf16
    out = []
    for name, line in (("moe_dispatch", 52), ("moe_combine", 100)):
        k = main["kernels"][name]
        out.append({
            "name": name, "route": "cuda",
            "source": "deepspeed_tpu_torch/kernels/csrc/moe_dispatch.cu",
            "replaces": f"deepspeed_tpu/kernels/moe_kernels.py:{line}",
            "launches": train_moe["moe_launches"][name],
            "launches_by_path": {
                "train-moe": train_moe["moe_launches"][name],
                "train-moe-dropless (both passes)":
                    train_dropless["moe_launches"][name],
                "train-moe-dropless (overflow pass)":
                    train_dropless["moe_launches_overflow"][name],
                **{f"train-moe-ep rank {r[w]['rank']} ({w} wire)":
                   r[w]["launches"]["moe"][name]
                   for r in train_moe_ep["ranks"] for w in ("int8", "fp32")}},
            # the overflow pass's shape: one group of B·S tokens, one
            # expert of B·O slots (moe_overflow_case)
            "overflow_shape": {
                "shape": f"1 group of {overflow_case['one_group_tokens']} "
                         f"tokens, 1 expert x {overflow_case['overflow_slots']}"
                         f" slots, D=768 bf16, top-1, "
                         f"{overflow_case['overflow_kept']} kept",
                **{f: overflow_case["kernels"][name].get(f) for f in
                   ("kernel_ms", "kernel_device_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "library_device_ms")},
                "max_abs_err": overflow_case["max_abs_err"][name]},
            "max_abs_err": main["max_abs_err"][name],
            # ms / library_ms on CUDA events around a call (as earlier
            # runs recorded them); the *_device_ms their own kernels'
            # device time under torch.profiler
            "ms": k["kernel_ms"], "kernel_device_ms": k["kernel_device_ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
            "library_device_ms": k["library_device_ms"],
            "library_call": ("torch.index_select" if name == "moe_dispatch"
                             else "F.embedding_bag(per_sample_weights)"),
            **({"device_ops_per_call": k["profile"]["device_ops_per_call"]}
               if "profile" in k else {}),
            **({"gate_grad": main["gate_grad"]}
               if name == "moe_combine" else {}),
            "shape": "B=4 S=2048 E=64 C=32 D=768 bf16 top-1",
            "cases": [{"case": c["case"],
                       "dispatch_mismatches": c["dispatch_mismatches"],
                       "combine_max_err_over_tol":
                           c["combine_max_err_over_tol"],
                       **{f: c["kernels"][name].get(f) for f in
                          ("kernel_ms", "kernel_device_ms", "plain_ms",
                           "bound_ms", "library_ms", "library_device_ms")}}
                      for c in moe_cases]})
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
                                 rng.randint(256, 768, size=8), gen, flush,
                                 ops=dtype == torch.bfloat16))
        cases.append(kernel_case(f"prefill-{dn}", 1, 128, 25, 64, 16, 64,
                                 dtype, [448], gen, flush))
    cases.append(kernel_case("decode-bfloat16-dh128", 8, 1, 16, 128, 16, 64,
                             torch.bfloat16, rng.randint(256, 768, size=8),
                             gen, flush))
    mark("paged")
    flash_cases = phase_flash(gen, flush)
    flash_cases += phase_flash_draws()
    phase_flash_repeat()
    mark("flash")
    sparse_cases, sparse_probe = phase_sparse(flush)
    phase_sparse_repeat()
    mark("sparse")
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
    # the head_dim-generic instantiation: GPT-2 nano's Dh 16 (3 heads) and
    # Dh 256, each cache kind, at decode and at a prefill chunk, with q in
    # bf16 and in fp32 (a dense cache in q's dtype)
    for Dh, H in ((16, 3), (256, 8)):
        for kv in ("dense", "int8", "int4"):
            for dtype in (torch.bfloat16, torch.float32):
                dn = str(dtype).replace("torch.", "")
                cases.append(kernel_case(
                    f"decode-dh{Dh}-{kv}-{dn}", 8, 1, H, Dh, 16, 64, dtype,
                    rng.randint(256, 768, size=8), gen, flush, kv=kv))
                cases.append(kernel_case(
                    f"prefill-dh{Dh}-{kv}-{dn}", 1, 128, H, Dh, 16, 64,
                    dtype, [448], gen, flush, kv=kv))
    # head dims off the multiples of 8: Dh 20 and 100 in every cache kind,
    # an odd Dh (33) dense and int8 (an int4 cache needs an even one), q
    # bf16, decode and a prefill chunk; drawn from a generator of their own
    # so that the later phases' draws stay as they were
    gen_dh = torch.Generator(device="cuda").manual_seed(7)
    for Dh, H, kinds in ((20, 4, ("dense", "int8", "int4")),
                         (100, 8, ("dense", "int8", "int4")),
                         (33, 4, ("dense", "int8"))):
        for kv in kinds:
            cases.append(kernel_case(
                f"decode-dh{Dh}-{kv}-bfloat16", 8, 1, H, Dh, 16, 64,
                torch.bfloat16, rng.randint(256, 768, size=8), gen_dh, flush,
                kv=kv))
            cases.append(kernel_case(
                f"prefill-dh{Dh}-{kv}-bfloat16", 1, 128, H, Dh, 16, 64,
                torch.bfloat16, [448], gen_dh, flush, kv=kv))
    # above 1024 columns (q.k streamed over pieces), one slot over a
    # 4096-key table (32 key splits), and the tensor-core prefill in fp16
    # at Dh 128 from a position mid-block
    cases.append(kernel_case("decode-dh1032-bfloat16", 8, 1, 2, 1032, 16, 16,
                             torch.bfloat16, rng.randint(64, 256, size=8),
                             gen_dh, flush))
    cases.append(kernel_case("verify-dh2048-float32", 4, 5, 2, 2048, 16, 16,
                             torch.float32, rng.randint(64, 250, size=4),
                             gen_dh, flush))
    cases.append(kernel_case("decode-long-b1-bfloat16", 1, 1, 25, 64, 16, 256,
                             torch.bfloat16, [4000], gen_dh, flush))
    cases.append(kernel_case("prefill-float16-dh128", 1, 128, 16, 128, 16, 64,
                             torch.float16, [453], gen_dh, flush))
    mark("paged-head-dims")
    xent_cases = phase_xent(gen, flush)
    phase_xent_repeat()
    mark("xent")
    codec = phase_codec()
    moe_cases = phase_moe_kernels(gen, flush)
    overflow_case = moe_overflow_case(gen, flush)
    mark("codec-moe-kernels")

    phase_exact()
    mark("exact")
    nano = phase_serve_nano_exact()
    mark("serve-nano-exact")
    phase_spec_exact()
    mark("spec-exact")
    phase_serve_qw_exact()
    mark("serve-qw-exact")
    serve, eng = phase_serve()
    rs = np.random.RandomState(1)   # fresh tokens: no prefix-cache hit
    serve_profile = profile_replay(
        eng, [rs.randint(0, 50257, (n,)).tolist() for n in
              serve["prompt_lens"]], serve["max_new_tokens"],
        serve["prefill_chunks"], serve["decode_steps"],
        serve["device_span_ms"], "phase 5's traffic replayed on fresh "
        f"prompts: lengths {serve['prompt_lens']}, "
        f"{serve['max_new_tokens']} new tokens each, gpt2 xl bf16")
    emit(serve_profile)
    mark("serve")
    serve_spec = phase_serve_spec(eng.model)
    mark("serve-spec")
    serve_qw = phase_serve_qw(eng.model, serve, flush)
    mark("serve-qw")
    fleet_exact = phase_fleet_exact()
    mark("fleet-exact")
    serve_fleet = phase_serve_fleet(eng.model, serve,
                                    serve_profile["device_idle_share"])
    mark("serve-fleet")
    serve_chaos = phase_serve_chaos(eng.model)
    mark("serve-chaos")
    del eng, flush
    gc.collect()
    torch.cuda.empty_cache()

    phase_train_exact()
    phase_train_exact_pallas()
    phase_moe_exact()
    mark("train-exact")
    phase_moe_dropless_exact()
    mark("moe-dropless-exact")
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
    gc.collect()
    torch.cuda.empty_cache()
    mark("train-pallas")
    phase_dp_exact()
    mark("dp-exact")
    train_dp = phase_train_dp(train_pallas)
    gc.collect()
    torch.cuda.empty_cache()
    mark("train-dp")
    phase_qgz_exact()
    mark("qgz-exact")
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    train_dp_qgz = phase_train_dp_qgz(train_dp, flush)
    gc.collect()
    torch.cuda.empty_cache()
    mark("train-dp-qgz")
    train_resume = phase_train_resume()
    mark("train-resume")
    train_moe, teng, data = phase_train_moe()
    emit(phase_train_profile(teng, data, train_moe))
    del teng, data
    gc.collect()
    torch.cuda.empty_cache()
    mark("train-moe")
    train_dropless, teng, data = phase_train_moe(warmup=2, steps=6,
                                                 dropless=True)
    train_dropless["train_moe_step_ms_mean"] = train_moe["step_ms_mean"]
    train_dropless["train_moe_tokens_per_s"] = train_moe["tokens_per_s"]
    train_dropless["train_moe_peak_mem_bytes"] = train_moe["peak_mem_bytes"]
    emit({"phase": "train-moe-dropless-vs-train-moe", **{
        k: train_dropless[k] for k in (
            "step_ms_mean", "tokens_per_s", "peak_mem_bytes",
            "train_moe_step_ms_mean", "train_moe_tokens_per_s",
            "train_moe_peak_mem_bytes", "dropped_by_step")}})
    del teng, data
    gc.collect()
    torch.cuda.empty_cache()
    mark("train-moe-dropless")
    phase_moe_wire_exact()
    mark("moe-wire-exact")
    train_moe_ep = phase_train_moe_ep(train_moe, flush)
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    mark("train-moe-ep")
    z3_exact = phase_z3_exact()
    mark("z3-exact")
    train_z3 = phase_train_z3()
    gc.collect()
    torch.cuda.empty_cache()
    mark("train-z3")
    phase_offload_exact()
    mark("offload-exact")
    phase_infinity_exact()
    mark("infinity-exact")
    xl_runs = list(phase_train_offload_infinity().values())
    mark("train-offload-infinity")
    xl_runs.append(phase_train_infinity_nvme())
    mark("train-infinity-nvme")
    bert_exact = phase_bert_sparse_exact()
    mark("bert-sparse-exact")
    train_bert, teng, data = phase_train_bert_sparse()
    emit(phase_train_profile(teng, data, train_bert))
    del teng, data
    mark("train-bert-sparse")
    emit({"phase": "seconds", **seconds})

    main_case = next(c for c in cases if c["case"] == "decode-bfloat16")
    prefill_case = next(c for c in cases if c["case"] == "prefill-bfloat16")
    spec4 = serve_spec["spec"]
    # the paged kernel's main paths: their launches, by kind and by route
    paged_paths = {"serve (dense bf16 KV)": serve,
                   "serve-spec (int8 KV, draft 4)": spec4,
                   "serve-qw (int8 weights)": serve_qw,
                   "serve-fleet (2 replicas, worker threads)": serve_fleet,
                   "fleet-exact (nano fp32, 2 replicas)": fleet_exact,
                   "serve-chaos (a worker, a shed)": serve_chaos}
    print(card, flush=True)
    emit({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "deepspeed_tpu_torch/kernels/csrc/paged_attention.cuh",
        "replaces": "deepspeed_tpu/kernels/paged.py:127",
        "launches": sum(r["paged_launches"] for r in paged_paths.values()),
        "launches_by_path": {k: r["paged_launches"]
                             for k, r in paged_paths.items()},
        # the serving runs' launches by kind of call and by route, as the
        # wrapper counts them where it launches
        "launches_by_kind": {
            k: sum(r["paged_launches_by_kind"][k]
                   for r in paged_paths.values())
            for k in serve["paged_launches_by_kind"]},
        "launches_by_kernel_route": {
            k: sum(r["paged_launches_by_route"][k]
                   for r in paged_paths.values())
            for k in serve["paged_launches_by_route"]},
        "kernel_route": main_case["route"],
        "kernel_routes": "split-keys: decode, verify, every cache kind and "
                         "head_dim; tensor-cores: prefill chunks (T >= 16) "
                         "over a dense bf16/fp16 cache, q in its dtype, Dh "
                         "64/128",
        "device_ops_per_call":
            main_case["device_split"]["device_ops_per_call"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": "decode B=8 T=1 H=25 Dh=64 bf16, table 64 x 16",
        "prefill": {k: prefill_case[k] for k in (
            "route", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err", "max_err_over_tol")},
        "domain": domain(cases, ("Dh", "kv", "dtype")),
        "serve_nano_exact_launches": nano["paged_launches"],
        "cases": [{k: c[k] for k in ("case", "kv", "route", "n_splits",
                                     "max_abs_err", "tol",
                                     "max_err_over_tol", "kernel_ms",
                                     "plain_ms", "library_ms", "bound_ms",
                                     "bound_by", "kernel_host_us")}
                  for c in cases]}] +
        flash_entries(flash_cases, train, train_resume, train_dp,
                      train_z3, xl_runs) +
        xent_entries(xent_cases, train_pallas, train_resume, train_dp,
                     train_z3, xl_runs) +
        codec_entries(codec, serve_qw, train_dp_qgz, train_moe_ep,
                      z3_exact, train_z3) +
        moe_entries(moe_cases, train_moe, overflow_case, train_dropless,
                    train_moe_ep) +
        sparse_entries(sparse_cases, sparse_probe, train_bert, bert_exact)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Does the flash dQ excess move between processes?

    python3 chip_dq_processes.py [N]

On one NVIDIA GPU: builds the flash kernels once, then runs N (default
12) fresh Python processes with the plain version's cuBLAS choices
pinned and N with torch's defaults, each of which computes, on the inputs of
tests/test_torch_flash.py's dh128-bias-dropout fp16 case
(`chip_smoke.dh128_test_inputs`), the kernel's dQ, the plain version's
dQ and the plain version in float64 (`chip_smoke.dq_fp64`); pinned
means reduced-precision reductions off for bf16 and fp16, TF32 off and a
fixed cuBLAS workspace (CUBLAS_WORKSPACE_CONFIG :4096:8).  Each process
prints the worst |kernel - plain|, |kernel -
fp64| and |plain - fp64| over dQ's per-element bound
(`kernels/flash.py` `kernel_tolerances`) and a hash of each side's dQ
bits; the script prints every process's line and, for each mode,
whether any hash or ratio moved between processes, and exits nonzero if
a process failed.  It
imports nothing of JAX.
"""

import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def one_process(pinned: bool):
    import numpy as np
    import torch

    if pinned:
        m = torch.backends.cuda.matmul
        m.allow_bf16_reduced_precision_reduction = False
        m.allow_fp16_reduced_precision_reduction = False
        m.allow_tf32 = False
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from deepspeed_tpu_torch.kernels import flash, registry

    B, S, H, D = cs.TEST_DH128
    inputs = cs.dh128_test_inputs()
    a = [t.to("cuda", torch.float16) for t in inputs[:4]]
    kb = inputs[4]
    opts = dict(causal=True, scale=D ** -0.5, block_q=128, block_k=128,
                rate=0.2, seed=1234, bh_offset=0, n_heads=H)
    out, lse = registry.dispatch("flash_attention_fwd", *a[:3], kb,
                                 impl="torch", **opts)
    delta = (a[3].float() * out.float()).sum(-1)
    args = (*a, lse, delta, kb)
    kern = registry.dispatch("flash_attention_dq", *args, impl="cuda",
                             **opts)
    plain = registry.dispatch("flash_attention_dq", *args, impl="torch",
                              **opts)
    dk, dv = registry.dispatch("flash_attention_dkv", *args, impl="torch",
                               **opts)
    tol = flash.kernel_tolerances(*a, kb, {"out": out, "dq": plain,
                                           "dk": dk, "dv": dv},
                                  **opts)["dq"].double()
    ref = cs.dq_fp64(a, lse, delta, kb, opts)
    torch.cuda.synchronize()

    def digest(t):
        return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]

    kp = (kern.double() - plain.double()).abs() / tol
    at = int(kp.argmax())
    print(json.dumps({
        "kernel_vs_plain_over_tol_max": float(kp.max()),
        "kernel_vs_fp64_over_tol_max": float(((kern.double() - ref).abs()
                                              / tol).max()),
        "plain_vs_fp64_over_tol_max": float(((plain.double() - ref).abs()
                                             / tol).max()),
        "worst_index": [int(i) for i in np.unravel_index(at, kp.shape)],
        "kernel_dq_sha": digest(kern), "plain_dq_sha": digest(plain),
        "lse_sha": digest(lse), "out_sha": digest(out)}), flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_dq_processes: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) > 1 and sys.argv[1] in ("--one", "--one-default"):
        one_process(sys.argv[1] == "--one")
        return 0
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    sys.path.insert(0, HERE)
    from deepspeed_tpu_torch.kernels import build

    build.build("flash_attention.cu")
    failed = 0
    for mode, flag, env in (
            ("pinned", "--one",
             dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")),
            ("default", "--one-default", dict(os.environ))):
        recs = []
        for i in range(n):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   flag], env=env, capture_output=True,
                                  text=True, timeout=300)
            line = (proc.stdout.strip().splitlines() or [""])[-1]
            if proc.returncode != 0 or not line.startswith("{"):
                failed += 1
                print(json.dumps({"mode": mode, "process": i,
                                  "rc": proc.returncode,
                                  "stderr": proc.stderr[-2000:]}),
                      flush=True)
                continue
            rec = dict(json.loads(line), mode=mode, process=i)
            recs.append(rec)
            print(json.dumps(rec), flush=True)
        keys = ("kernel_dq_sha", "plain_dq_sha", "lse_sha", "out_sha",
                "kernel_vs_plain_over_tol_max")
        print(json.dumps({
            "mode": mode, "processes": len(recs),
            "distinct": {k: sorted({str(r[k]) for r in recs}) for k in keys},
            "moved": {k: len({str(r[k]) for r in recs}) > 1 for k in keys},
            "settings": ({"allow_bf16_reduced_precision_reduction": False,
                          "allow_fp16_reduced_precision_reduction": False,
                          "allow_tf32": False,
                          "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
                         if mode == "pinned" else "torch defaults")}),
            flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

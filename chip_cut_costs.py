#!/usr/bin/env python3
"""What chip_smoke.py's cut checks cost, and what its train-monitor phase
costs, on one GPU (chip_smoke.py's phase functions, timed on the host
clock to a synchronize):

* part "repeats": `phase_sparse_repeat` and `phase_xent_repeat` at 50 and
  at 5 runs, then `phase_train_resume` and `phase_train_monitor`;
* part "exact": `phase_moe_dropless_exact` at top-1 and top-2 and at
  top-2 alone, `phase_z3_exact` at 3 and 2 steps, `phase_moe_wire_exact`
  at 3 and 2 steps.

    python3 chip_cut_costs.py [repeats] [exact]    # both when none named

Prints one `cut-seconds` JSON line after each timing (the last holds them
all), beside the phases' own lines.
"""

from __future__ import annotations

import os
import sys
import time


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_cut_costs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs

    parts = [a for a in argv if a in ("repeats", "exact")] or \
        ["repeats", "exact"]
    out = {"card": cs.gpu_name_and_limit()}

    def timed(name, fn):
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t
        cs.emit({"phase": "cut-seconds", **out})
        return res

    cs.emit(cs.build_all())
    if "repeats" in parts:
        timed("sparse_repeat_50", lambda: cs.phase_sparse_repeat(50))
        timed("sparse_repeat_5", lambda: cs.phase_sparse_repeat(5))
        timed("xent_repeat_50", lambda: cs.phase_xent_repeat(50))
        timed("xent_repeat_5", lambda: cs.phase_xent_repeat(5))
        ref = timed("train-resume", cs.phase_train_resume)
        timed("train-monitor", lambda: cs.phase_train_monitor(ref))
        del ref
    if "exact" in parts:
        timed("moe_dropless_exact_k12",
              lambda: cs.phase_moe_dropless_exact(ks=(1, 2)))
        timed("moe_dropless_exact_k2",
              lambda: cs.phase_moe_dropless_exact(ks=(2,)))
        timed("z3_exact_3", lambda: cs.phase_z3_exact(steps=3))
        timed("z3_exact_2", lambda: cs.phase_z3_exact(steps=2))
        timed("moe_wire_exact_3", lambda: cs.phase_moe_wire_exact(steps=3))
        timed("moe_wire_exact_2", lambda: cs.phase_moe_wire_exact(steps=2))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""FLOPS profiler — the port of
deepspeed_tpu/profiling/flops_profiler/profiler.py.

Reference: deepspeed/profiling/flops_profiler/profiler.py monkey-patches
torch.nn.functional (:501-596) to count MACs per call.  The JAX package
reads XLA's cost analysis and walks the jaxpr instead; the port counts
what a call really dispatches: `torch.utils.flop_counter.FlopCounterMode`
over one execution, which counts the products (matmuls, batched
matmuls, convolutions, attention) by aten op and by module.

The hand-written kernels report their own products: a ctypes launch is
invisible to the flop counter, so while `analyze_fn` counts, flash
attention #1-#3 and the fused CE #4-#6 are credited the products of the
dense path they replace (kernels/registry.py `product_count`; the
formulas beside their wrappers), and whatever the counter saw inside
those calls (a plain version's blocked loops) is left out.  A step
reports the same count with the kernels, their plain versions or the
dense path.  Causal attention is counted as the full square the dense
path computes.

`flops` is that product count.  It leaves out the elementwise work
(softmax, norms, activations, the optimizer) that XLA's cost analysis
adds to the JAX package's `flops`; its `by_primitive["dot_general"]` is
the JAX figure to compare with.  Utilization is stated against the
card's dense peak for the compute dtype (`PEAK_FLOPS`).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

from ...utils.device import wait_for
from ...utils.logging import log_dist

# dense peaks (no sparsity) of the cards the port measures on, FLOP/s by
# compute dtype: NVIDIA's H100 SXM data sheet, at its 700 W limit
PEAK_FLOPS = {
    "H100": {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12},
}


def _device_peak_flops(dtype: str = "bfloat16") -> float:
    """The current card's dense peak for `dtype`; 0 on the CPU or an
    unknown card (utilization is then omitted)."""
    try:
        import torch

        if not torch.cuda.is_available():
            return 0.0
        kind = torch.cuda.get_device_name()
    except Exception:
        return 0.0
    for name, peaks in PEAK_FLOPS.items():
        if name.lower() in kind.lower():
            return peaks.get(str(dtype).replace("torch.", ""), 0.0)
    return 0.0


def _count_params(params) -> int:
    if hasattr(params, "parameters"):
        params = list(params.parameters())
    elif isinstance(params, dict):
        params = list(params.values())
    return sum(int(p.numel()) for p in params if hasattr(p, "numel"))


def _op_name(op) -> str:
    """`aten.mm.default` -> "mm" (the counter's key, as a string)."""
    name = str(op)
    if name.startswith("aten."):
        name = name[len("aten."):]
    return name.split(".")[0]


def analyze_fn(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Count the products of ONE execution of `fn(*args, **kwargs)`
    (forward and, when `fn` runs it, backward): total flops, the
    per-op breakdown (`by_primitive`: aten ops by name and the kernel
    ops' credited products) and per-module totals (`by_scope`).  The
    call's result is returned under "result".  Counting changes no
    value: the counter only reads each op's shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    from ...kernels.registry import product_count

    mode = FlopCounterMode(display=False)

    def native() -> Dict[str, int]:
        return {_op_name(k): int(v) for k, v in
                mode.get_flop_counts().get("Global", {}).items()}

    with mode, product_count(native) as pc:
        result = fn(*args, **kwargs)
    by_prim: Dict[str, int] = {}
    for k, v in native().items():
        v -= pc.excluded.get(k, 0)
        if v:
            by_prim[k] = v
    by_prim.update(pc.credited)
    by_scope = {}
    for scope, ops in mode.get_flop_counts().items():
        if scope != "Global":
            by_scope[scope] = int(sum(ops.values()))
    total = float(sum(by_prim.values()))
    return {
        "flops": total,
        "flops_estimated": total,
        "by_primitive": by_prim,
        "by_scope": by_scope,
        "result": result,
    }


# ---------------------------------------------------------------------------


class FlopsProfiler:
    """API parity with reference profiler.py:11-341.

    Usage (also driven by the engine at flops_profiler.profile_step):
        prof = FlopsProfiler()
        prof.start_profile()
        loss = engine.forward(batch)      # any calls
        prof.stop_profile(params=engine.params, sync=loss)
        prof.print_model_profile()
    `stop_profile(fn, args)` counts `fn(*args)` by running it once more.
    """

    def __init__(self, model=None, config=None):
        self.model = model
        self.config = config
        self.started = False
        self.stats: Dict[str, Any] = {}

    def start_profile(self, ignore_list=None):
        self.started = True
        self._t0 = time.time()

    def stop_profile(self, fn: Optional[Callable] = None, args: Tuple = (),
                     params=None, sync=None):
        if not self.started:
            return
        if sync is not None:  # asynchronous CUDA: wait before the clock
            wait_for(sync)
        self.duration = time.time() - self._t0
        if fn is not None:
            self.stats = analyze_fn(fn, *args)
            self.stats.pop("result", None)
        if params is not None:
            self.stats["params"] = _count_params(params)
        self.started = False

    def end_profile(self):
        self.stats = {}

    # accessors (reference get_total_* :220-260)
    def get_total_flops(self, as_string=False):
        f = self.stats.get("flops", 0.0)
        return number_to_string(f, "FLOPs") if as_string else f

    def get_total_params(self, as_string=False):
        p = self.stats.get("params", 0)
        return number_to_string(p, "params") if as_string else p

    def get_total_duration(self, as_string=False):
        d = getattr(self, "duration", 0.0)
        return f"{d * 1000:.2f} ms" if as_string else d

    def print_model_profile(self, profile_step=None, module_depth=-1,
                            top_modules=3, detailed=True, output_file=None,
                            dtype="bfloat16"):
        lines = ["", "-" * 26 + " flops profiler " + "-" * 26]
        if profile_step is not None:
            lines.append(f"profile step:                   {profile_step}")
        if "params" in self.stats:
            lines.append(f"params:                         "
                         f"{number_to_string(self.stats['params'], '')}")
        lines.append(f"fwd+bwd flops per step:         "
                     f"{number_to_string(self.stats.get('flops', 0), 'FLOPs')}")
        dur = getattr(self, "duration", 0.0)
        if dur > 0:
            lines.append(f"step latency:                   {dur*1000:.2f} ms")
            achieved = self.stats.get("flops", 0) / dur
            lines.append(f"achieved:                       "
                         f"{number_to_string(achieved, 'FLOPS')}")
            peak = _device_peak_flops(dtype)
            if peak:
                lines.append(f"utilization ({dtype} peak):"
                             f"{' ' * max(1, 10 - len(dtype))}"
                             f"{100.0 * achieved / peak:.1f} %")
        if detailed and self.stats.get("by_primitive"):
            lines.append("flops by primitive:")
            total = max(sum(self.stats["by_primitive"].values()), 1)
            for prim, f in sorted(self.stats["by_primitive"].items(),
                                  key=lambda kv: -kv[1])[:max(top_modules, 3)]:
                lines.append(f"  {prim:<28} {number_to_string(f, ''):>10} "
                             f"({100.0 * f / total:.1f}%)")
        if detailed and self.stats.get("by_scope"):
            scopes = {k: v for k, v in self.stats["by_scope"].items()}
            if len(scopes) > 1:
                lines.append("flops by scope:")
                for scope, f in sorted(scopes.items(),
                                       key=lambda kv: -kv[1])[:top_modules]:
                    lines.append(f"  {scope:<28} {number_to_string(f, ''):>10}")
        lines.append("-" * 68)
        text = "\n".join(lines)
        if output_file:
            with open(output_file, "w") as fh:
                fh.write(text)
        log_dist(text, ranks=[0])
        return text


def number_to_string(num, unit="") -> str:
    num = float(num)
    for mag, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(num) >= mag:
            return f"{num / mag:.2f} {suffix}{unit}"
    return f"{num:.2f} {unit}".rstrip()


def get_model_profile(model, batch, as_string=False):
    """One-call profile (reference profiler.py:599-685 get_model_profile):
    returns (flops, macs, params) of one forward of `model.loss(batch,
    train=False)` under no_grad, on the model's own weights (the JAX
    package initializes a fresh tree; a torch module carries its own)."""
    import torch

    def fn():
        with torch.no_grad():
            return model.loss(batch, train=False)

    stats = analyze_fn(fn)
    flops = stats["flops"]
    macs = flops / 2.0
    nparams = _count_params(model)
    if as_string:
        return (number_to_string(flops, "FLOPs"),
                number_to_string(macs, "MACs"),
                number_to_string(nparams, "params"))
    return flops, macs, nparams

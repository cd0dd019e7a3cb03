"""FLOPS profiler config — the port's copy of
deepspeed_tpu/profiling/config.py (reference:
deepspeed/profiling/config.py)."""

from ..runtime.config_utils import DeepSpeedConfigObject, get_scalar_param

FLOPS_PROFILER = "flops_profiler"
FLOPS_PROFILER_ENABLED = "enabled"
FLOPS_PROFILER_PROFILE_STEP = "profile_step"
FLOPS_PROFILER_MODULE_DEPTH = "module_depth"
FLOPS_PROFILER_TOP_MODULES = "top_modules"
FLOPS_PROFILER_DETAILED = "detailed"


class DeepSpeedFlopsProfilerConfig(DeepSpeedConfigObject):
    def __init__(self, param_dict):
        super().__init__()
        d = param_dict.get(FLOPS_PROFILER, {}) or {}
        self.enabled = get_scalar_param(d, FLOPS_PROFILER_ENABLED, False)
        self.profile_step = get_scalar_param(d, FLOPS_PROFILER_PROFILE_STEP, 1)
        self.module_depth = get_scalar_param(d, FLOPS_PROFILER_MODULE_DEPTH, -1)
        self.top_modules = get_scalar_param(d, FLOPS_PROFILER_TOP_MODULES, 3)
        self.detailed = get_scalar_param(d, FLOPS_PROFILER_DETAILED, True)

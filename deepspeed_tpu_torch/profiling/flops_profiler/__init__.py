from .profiler import (FlopsProfiler, analyze_fn, get_model_profile,
                       number_to_string)

__all__ = ["FlopsProfiler", "analyze_fn", "get_model_profile",
           "number_to_string"]

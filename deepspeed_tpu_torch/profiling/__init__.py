"""The flops profiler (the port of deepspeed_tpu/profiling)."""

"""The single-process training runtime (the port of deepspeed_tpu/runtime/)."""

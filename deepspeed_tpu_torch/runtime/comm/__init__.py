"""Communication-side codecs (the port of deepspeed_tpu/runtime/comm/)."""

"""ZeRO stages 1 and 2 (the port of deepspeed_tpu/runtime/zero/)."""

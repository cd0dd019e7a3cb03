"""deepspeed_tpu_torch.moe — the Mixture-of-Experts layer and its sorted
token movement (the port of deepspeed_tpu/moe/, one device)."""

from .dispatch import (MoEWireConfig, flush_dispatch_stats, get_wire_config,
                       moe_wire, parse_moe_config, set_wire_config)
from .layer import MoE, MoEConfig, top_k_gating

__all__ = ["MoE", "MoEConfig", "MoEWireConfig", "flush_dispatch_stats",
           "get_wire_config", "moe_wire", "parse_moe_config",
           "set_wire_config", "top_k_gating"]

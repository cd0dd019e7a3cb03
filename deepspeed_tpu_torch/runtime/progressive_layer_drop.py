"""Progressive Layer Drop curriculum — a copy of
deepspeed_tpu/runtime/progressive_layer_drop.py (reference:
deepspeed/runtime/progressive_layer_drop.py:5).

theta(t) = (1 - theta_base) * exp(-gamma * t) + theta_base — the keep
probability handed to the model each step; the model draws a per-layer
keep mask with it from the engine's generator (models/gpt.py).
"""

import numpy as np

from ..utils.logging import log_dist


class ProgressiveLayerDrop:
    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0
        log_dist(f"Enabled progressive layer dropping (theta = {self.theta})",
                 ranks=[0])

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self):
        return self.current_theta

    def update_state(self, global_step: int):
        self.current_theta = ((1.0 - self.theta) *
                              np.exp(-self.gamma * global_step) + self.theta)

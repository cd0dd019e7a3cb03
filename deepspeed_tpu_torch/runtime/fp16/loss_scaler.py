"""Loss scaling, static and dynamic — the port of
deepspeed_tpu/runtime/fp16/loss_scaler.py.

The scaler state is a dict of 0-dim tensors on the training device and
`update_scale_jit` is the JAX package's branchless update written with
`torch.where`, so the skip-step decision stays on the device and the host
never has to read the overflow flag to take a step.  The classes keep the
JAX package's host-side API (reference: deepspeed/runtime/fp16/
loss_scaler.py, Megatron lineage).
"""

from __future__ import annotations

import torch

# config keys (reference loss_scaler.py:19-22)
INITIAL_LOSS_SCALE = "init_scale"
SCALE_WINDOW = "scale_window"
DELAYED_SHIFT = "delayed_shift"
MIN_LOSS_SCALE = "min_scale"


def make_scaler_state(init_scale: float, device="cpu") -> dict:
    """The state carried from step to step (loss_scaler.py:22)."""
    return {
        "cur_scale": torch.tensor(init_scale, dtype=torch.float32,
                                  device=device),
        "cur_iter": torch.tensor(0, dtype=torch.int32, device=device),
        "last_overflow_iter": torch.tensor(-1, dtype=torch.int32,
                                           device=device),
        "cur_hysteresis": torch.tensor(1, dtype=torch.int32, device=device),
    }


def update_scale_jit(state: dict, overflow, *, scale_factor: float = 2.0,
                     scale_window: int = 1000, min_scale: float = 1.0,
                     delayed_shift: int = 1,
                     consecutive_hysteresis: bool = False) -> dict:
    """Branchless DynamicLossScaler.update_scale (loss_scaler.py:32);
    `overflow` is a bool tensor."""
    cur_scale = state["cur_scale"]
    cur_iter = state["cur_iter"] + 1
    cur_hyst = state["cur_hysteresis"]
    shifts = torch.full_like(cur_hyst, delayed_shift)

    shift_now = (cur_hyst <= 1) | (delayed_shift == 1)
    dec_scale = torch.clamp_min(cur_scale / scale_factor, min_scale)

    window_hit = torch.remainder(cur_iter - state["last_overflow_iter"],
                                 scale_window) == 0
    inc_scale = torch.where(window_hit, cur_scale * scale_factor, cur_scale)

    new_scale = torch.where(overflow,
                            torch.where(shift_now, dec_scale, cur_scale),
                            inc_scale)
    new_hyst = torch.where(
        overflow,
        torch.where(shift_now, cur_hyst, cur_hyst - 1),
        torch.where(window_hit & (not consecutive_hysteresis), shifts,
                    shifts if consecutive_hysteresis else cur_hyst))
    new_last_overflow = torch.where(overflow, cur_iter,
                                    state["last_overflow_iter"])
    return {
        "cur_scale": new_scale,
        "cur_iter": cur_iter,
        "last_overflow_iter": new_last_overflow,
        "cur_hysteresis": new_hyst,
    }


class LossScalerBase:
    """Host-side API parity (reference LossScalerBase)."""

    def __init__(self, cur_scale):
        self.cur_scale = float(cur_scale)

    @property
    def loss_scale(self):
        return self.cur_scale

    def update_scale(self, overflow):
        pass

    def state_dict(self):
        return {"cur_scale": self.cur_scale}

    def load_state_dict(self, sd):
        self.cur_scale = sd["cur_scale"]


class LossScaler(LossScalerBase):
    """Static loss scale (reference LossScaler)."""

    def __init__(self, scale=1.0):
        super().__init__(scale)
        self.dynamic = False

    def jit_state(self, device="cpu"):
        return make_scaler_state(self.cur_scale, device)

    def jit_update(self, state, overflow):
        state = dict(state)
        state["cur_iter"] = state["cur_iter"] + 1
        return state


class DynamicLossScaler(LossScalerBase):
    """Dynamic loss scale (reference DynamicLossScaler)."""

    def __init__(self, init_scale=2 ** 32, scale_factor=2.0, scale_window=1000,
                 min_scale=1.0, delayed_shift=1, consecutive_hysteresis=False,
                 raise_error_at_min_scale=True):
        super().__init__(init_scale)
        self.dynamic = True
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.delayed_shift = delayed_shift
        self.consecutive_hysteresis = consecutive_hysteresis
        self.raise_error_at_min_scale = raise_error_at_min_scale
        self.cur_iter = 0
        self.last_overflow_iter = -1
        self.cur_hysteresis = delayed_shift

    def jit_state(self, device="cpu"):
        st = make_scaler_state(self.cur_scale, device)
        st["cur_iter"].fill_(self.cur_iter)
        st["last_overflow_iter"].fill_(self.last_overflow_iter)
        st["cur_hysteresis"].fill_(self.cur_hysteresis)
        return st

    def jit_update(self, state, overflow):
        return update_scale_jit(
            state, overflow, scale_factor=self.scale_factor,
            scale_window=self.scale_window, min_scale=self.min_scale,
            delayed_shift=self.delayed_shift,
            consecutive_hysteresis=self.consecutive_hysteresis)

    # host-side mirror (used outside the step, e.g. tests)
    def update_scale(self, overflow):
        self.cur_iter += 1
        if overflow:
            if self.delayed_shift == 1 or self.cur_hysteresis == 1:
                if self.cur_scale == self.min_scale and self.raise_error_at_min_scale:
                    raise RuntimeError(
                        "Current loss scale already at minimum - cannot "
                        "decrease scale anymore. Exiting run.")
                self.cur_scale = max(self.cur_scale / self.scale_factor,
                                     self.min_scale)
            else:
                self.cur_hysteresis -= 1
            self.last_overflow_iter = self.cur_iter
        else:
            if self.consecutive_hysteresis:
                self.cur_hysteresis = self.delayed_shift
            if (self.cur_iter - self.last_overflow_iter) % self.scale_window == 0:
                if not self.consecutive_hysteresis:
                    self.cur_hysteresis = self.delayed_shift
                self.cur_scale *= self.scale_factor

    def state_dict(self):
        return {"cur_scale": self.cur_scale, "cur_iter": self.cur_iter,
                "last_overflow_iter": self.last_overflow_iter,
                "cur_hysteresis": self.cur_hysteresis}

    def load_state_dict(self, sd):
        self.cur_scale = sd["cur_scale"]
        self.cur_iter = sd.get("cur_iter", 0)
        self.last_overflow_iter = sd.get("last_overflow_iter", -1)
        self.cur_hysteresis = sd.get("cur_hysteresis", self.delayed_shift)


def create_loss_scaler(ds_config) -> LossScalerBase:
    """Build from DeepSpeedConfig (loss_scaler.py:175)."""
    if ds_config.precision == "float16":
        if ds_config.loss_scale == 0:
            return DynamicLossScaler(
                init_scale=2 ** ds_config.initial_scale_power,
                scale_window=ds_config.loss_scale_window,
                min_scale=ds_config.min_loss_scale,
                delayed_shift=ds_config.hysteresis)
        return LossScaler(scale=ds_config.loss_scale)
    # bf16/fp32 need no loss scaling
    return LossScaler(scale=1.0)

"""Batch-size ramp scheduler — the port of
deepspeed_tpu/runtime/bs_schedules.py (the EleutherAI addition).

Ramps the batch size in `num_intervals` linear stairs from
ceil(final * min_batch_size_multiplier) to final over warmup_num_steps;
its state dict is the step it has reached.
"""

import math

import numpy as np


class BatchSizeScheduler:
    def __init__(self, final_batch_size, min_batch_size_multiplier: float = 0.01,
                 warmup_num_steps: int = 1000, num_intervals: int = 4,
                 last_batch_iteration: int = -1, deepspeed=None):
        self.warmup_num_steps = warmup_num_steps
        self.last_batch_iteration = last_batch_iteration
        self.final_batch_size = final_batch_size
        self.num_intervals = num_intervals
        self.min_batch_size_multiplier = min_batch_size_multiplier
        self.schedule = self._build_schedule()
        self.current_batch_size = None
        self.deepspeed = deepspeed

    def _build_schedule(self):
        start = math.ceil(self.min_batch_size_multiplier * self.final_batch_size)
        batch_sizes = np.linspace(start, self.final_batch_size,
                                  num=self.num_intervals, dtype=int)
        steps = np.linspace(0, self.warmup_num_steps, num=self.num_intervals,
                            dtype=int)
        schedule = {}
        prev = None
        for step, bs in zip(steps, batch_sizes):
            if int(bs) != prev:
                schedule[int(step)] = int(bs)
            prev = int(bs)
        return schedule

    def get_current_batch_size(self):
        keys = sorted(self.schedule.keys(), reverse=True)
        for k in keys:
            if self.last_batch_iteration >= k:
                return self.schedule[k]
        return self.schedule[keys[-1]]

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        self.current_batch_size = self.get_current_batch_size()

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]

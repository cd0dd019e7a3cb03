"""Overflow check and gradient norms — the port of
deepspeed_tpu/runtime/utils.py:101-142, over lists of tensors (the leaves
of the JAX pytree), as multi-tensor `_foreach` reductions that stay on
the device — `partition_uniform` (:36) and `ThroughputTimer` (:171)."""

from __future__ import annotations

import time

import torch

from ..utils.logging import logger


def has_overflow(grads):
    """Bool tensor: any grad is inf/nan.  The per-tensor max |g| is NaN
    or inf exactly when the tensor holds a NaN or an inf."""
    amax = torch._foreach_norm(grads, float("inf"))
    return torch.logical_not(torch.isfinite(torch.stack(amax)).all())


def global_grad_norm_sq(grads):
    """Sum of squared grad entries (fp32)."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.stack(norms).square().sum()


def clip_grad_norm(grads, max_norm: float, norm_sq=None):
    """Global-norm clipping as one scale (reference clip_grad_norm_
    semantics), applied to `grads` in place.  Returns (grads, pre-clip
    norm)."""
    if norm_sq is None:
        norm_sq = global_grad_norm_sq(grads)
    norm = torch.sqrt(norm_sq)
    scale = torch.clamp_max(max_norm / (norm + 1e-6), 1.0)
    torch._foreach_mul_(grads, scale)
    return grads, norm


def partition_uniform(num_items: int, num_parts: int):
    """num_parts+1 boundaries splitting num_items as evenly as possible
    (the port's copy of deepspeed_tpu/runtime/utils.py:36, reference
    runtime/utils.py:333)."""
    parts = [0] * (num_parts + 1)
    if num_items <= num_parts:
        for p in range(num_parts + 1):
            parts[p] = min(p, num_items)
        return parts
    chunksize = num_items // num_parts
    residual = num_items % num_parts
    for p in range(1, num_parts + 1):
        parts[p] = parts[p - 1] + chunksize + (1 if p <= residual else 0)
    return parts


class ThroughputTimer:
    """samples/sec reporting (deepspeed_tpu/runtime/utils.py:171,
    reference utils/timer.py:105): the first `start_step` steps are left
    out (warm-up and the kernels' first-call builds)."""

    def __init__(self, batch_size, num_workers=1, start_step=2,
                 steps_per_output=50, monitor_memory=False, logging_fn=None):
        self.batch_size = max(1, batch_size)
        self.num_workers = num_workers
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or logger.info
        self.initialized = False
        self.epoch_count = 0
        self.local_step_count = 0
        self.total_step_count = 0
        self.total_elapsed_time = 0.0
        self.start_time = 0.0

    def start(self):
        if not self.initialized:
            self.initialized = True
        self.start_time = time.time()

    def stop(self, report_speed=True):
        self.total_step_count += 1
        self.local_step_count += 1
        if self.total_step_count <= self.start_step:
            return  # skip warmup steps
        duration = time.time() - self.start_time
        self.total_elapsed_time += duration
        if report_speed and self.local_step_count % self.steps_per_output == 0:
            self.logging(
                f"step={self.total_step_count}, "
                f"samples/sec={self.avg_samples_per_sec():.1f}")

    def avg_samples_per_sec(self):
        counted = self.total_step_count - self.start_step
        if counted > 0 and self.total_elapsed_time > 0:
            return self.batch_size * self.num_workers * counted / \
                self.total_elapsed_time
        return 0.0

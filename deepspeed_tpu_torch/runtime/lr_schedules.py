"""LR schedules: LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR.

The port's copy of deepspeed_tpu/runtime/lr_schedules.py (reference:
deepspeed/runtime/lr_schedules.py:301,408,677,761), unchanged: pure-Python
step-based schedulers that mutate `optimizer.param_groups[i]["lr"]` exactly
like the reference, so user loops port unchanged.  The engine reads the
current lr at each optimizer step.
"""

import math

from ..utils.logging import logger

# config/CLI key names (reference lr_schedules.py:15-53)
LR_SCHEDULE = "lr_schedule"
LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]

LR_RANGE_TEST_MIN_LR = "lr_range_test_min_lr"
LR_RANGE_TEST_STEP_RATE = "lr_range_test_step_rate"
LR_RANGE_TEST_STEP_SIZE = "lr_range_test_step_size"
LR_RANGE_TEST_STAIRCASE = "lr_range_test_staircase"

CYCLE_MIN_LR = "cycle_min_lr"
CYCLE_MAX_LR = "cycle_max_lr"
DECAY_LR_RATE = "decay_lr_rate"
CYCLE_FIRST_STEP_SIZE = "cycle_first_step_size"
CYCLE_SECOND_STEP_SIZE = "cycle_second_step_size"
CYCLE_FIRST_STAIR_COUNT = "cycle_first_stair_count"
CYCLE_SECOND_STAIR_COUNT = "cycle_second_stair_count"
DECAY_STEP_SIZE = "decay_step_size"
CYCLE_MIN_MOM = "cycle_min_mom"
CYCLE_MAX_MOM = "cycle_max_mom"
DECAY_MOM_RATE = "decay_mom_rate"

WARMUP_MIN_LR = "warmup_min_lr"
WARMUP_MAX_LR = "warmup_max_lr"
WARMUP_NUM_STEPS = "warmup_num_steps"
TOTAL_NUM_STEPS = "total_num_steps"


def add_tuning_arguments(parser):
    """CLI args for LR schedules (reference lr_schedules.py:54)."""
    group = parser.add_argument_group("Convergence Tuning",
                                      "Convergence tuning configurations")
    group.add_argument("--lr_schedule", type=str, default=None,
                       help="LR schedule for training.")
    group.add_argument("--lr_range_test_min_lr", type=float, default=0.001)
    group.add_argument("--lr_range_test_step_rate", type=float, default=1.0)
    group.add_argument("--lr_range_test_step_size", type=int, default=1000)
    group.add_argument("--lr_range_test_staircase", type=bool, default=False)
    group.add_argument("--cycle_first_step_size", type=int, default=1000)
    group.add_argument("--cycle_first_stair_count", type=int, default=-1)
    group.add_argument("--cycle_second_step_size", type=int, default=-1)
    group.add_argument("--cycle_second_stair_count", type=int, default=-1)
    group.add_argument("--decay_step_size", type=int, default=1000)
    group.add_argument("--cycle_min_lr", type=float, default=0.01)
    group.add_argument("--cycle_max_lr", type=float, default=0.1)
    group.add_argument("--decay_lr_rate", type=float, default=0.0)
    group.add_argument("--cycle_min_mom", type=float, default=0.8)
    group.add_argument("--cycle_max_mom", type=float, default=0.9)
    group.add_argument("--decay_mom_rate", type=float, default=0.0)
    group.add_argument("--warmup_min_lr", type=float, default=0)
    group.add_argument("--warmup_max_lr", type=float, default=0.001)
    group.add_argument("--warmup_num_steps", type=int, default=1000)
    return parser


def _get_optimizer(optimizer):
    if hasattr(optimizer, "param_groups"):
        return optimizer
    if hasattr(optimizer, "optimizer") and hasattr(optimizer.optimizer,
                                                   "param_groups"):
        return optimizer.optimizer
    raise TypeError(
        f"{type(optimizer).__name__} has no param_groups; not an optimizer")


def _format_param(optimizer, value, name):
    if isinstance(value, (list, tuple)):
        if len(value) != len(optimizer.param_groups):
            raise ValueError(
                f"expected {len(optimizer.param_groups)} values for {name}, "
                f"got {len(value)}")
        return list(value)
    return [value] * len(optimizer.param_groups)


class _LRSchedulerBase:
    def get_last_lr(self):
        assert getattr(self, "_last_lr", None) is not None, \
            "need to call step() first"
        return self._last_lr

    def _update_optimizer(self, group_lrs):
        for param_group, lr in zip(self.optimizer.param_groups, group_lrs):
            param_group["lr"] = lr

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        self._update_optimizer(self.get_lr())
        self._last_lr = [g["lr"] for g in self.optimizer.param_groups]

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class LRRangeTest(_LRSchedulerBase):
    """LR range test: lr = min_lr * (1 + step_rate * interval) (reference :301)."""

    def __init__(self, optimizer, lr_range_test_min_lr=1e-3,
                 lr_range_test_step_size=2000, lr_range_test_step_rate=1.0,
                 lr_range_test_staircase=False, last_batch_iteration=-1):
        self.optimizer = _get_optimizer(optimizer)
        self.min_lr = _format_param(self.optimizer, lr_range_test_min_lr,
                                    "lr_range_test_min_lr")
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        self.last_batch_iteration = last_batch_iteration
        if last_batch_iteration == -1:
            self._update_optimizer(self.min_lr)

    def _interval(self):
        x = float(self.last_batch_iteration + 1) / self.step_size
        return math.floor(x) if self.staircase else x

    def get_lr(self):
        inc = 1 + self.step_rate * self._interval()
        return [lr * inc for lr in self.min_lr]


class OneCycle(_LRSchedulerBase):
    """1Cycle LR (+inverse momentum cycle) with post-cycle decay (reference :408)."""

    def __init__(self, optimizer, cycle_min_lr, cycle_max_lr, decay_lr_rate=0.0,
                 cycle_first_step_size=2000, cycle_second_step_size=None,
                 cycle_first_stair_count=0, cycle_second_stair_count=None,
                 decay_step_size=0, cycle_momentum=True, cycle_min_mom=0.8,
                 cycle_max_mom=0.9, decay_mom_rate=0.0,
                 last_batch_iteration=-1):
        self.optimizer = _get_optimizer(optimizer)
        first = float(cycle_first_step_size)
        second = float(cycle_second_step_size
                       if cycle_second_step_size is not None else first)
        self.total_size = first + second
        self.step_ratio = first / self.total_size
        self.first_stair_count = cycle_first_stair_count
        self.second_stair_count = (cycle_first_stair_count
                                   if cycle_second_stair_count is None
                                   else cycle_second_stair_count)
        self.decay_step_size = decay_step_size

        self.min_lrs = _format_param(self.optimizer, cycle_min_lr, "cycle_min_lr")
        self.max_lrs = _format_param(self.optimizer, cycle_max_lr, "cycle_max_lr")
        self.decay_lr_rate = decay_lr_rate
        if last_batch_iteration == -1:
            self._update_optimizer(self.min_lrs)

        self.cycle_momentum = cycle_momentum
        if cycle_momentum:
            if not all("betas" in g for g in self.optimizer.param_groups):
                logger.warning("cycle_momentum disabled: optimizer has no betas")
                self.cycle_momentum = False
            else:
                self.decay_mom_rate = decay_mom_rate
                n_groups = len(self.optimizer.param_groups)
                self.min_moms = [(cycle_min_mom, 0.99)] * n_groups
                self.max_moms = [(cycle_max_mom, 0.99)] * n_groups
                if last_batch_iteration == -1:
                    for mom, group in zip(self.min_moms,
                                          self.optimizer.param_groups):
                        group["betas"] = mom
        self.last_batch_iteration = last_batch_iteration

    def _scale_factor(self):
        batch_iteration = self.last_batch_iteration + 1
        cycle = math.floor(1 + batch_iteration / self.total_size)
        x = 1.0 + batch_iteration / self.total_size - cycle
        if x <= self.step_ratio:
            return x / self.step_ratio
        return (x - 1) / (self.step_ratio - 1)

    def _get_cycle_lr(self):
        scale = self._scale_factor()
        return [min_lr + (max_lr - min_lr) * scale
                for min_lr, max_lr in zip(self.min_lrs, self.max_lrs)]

    def _get_decay_lr(self, decay_batch_iteration):
        factor = 1 + self.decay_lr_rate * (decay_batch_iteration /
                                           self.decay_step_size)
        return [min_lr / factor for min_lr in self.min_lrs]

    def get_lr(self):
        if (self.last_batch_iteration + 1) < self.total_size or \
                not self.decay_step_size:
            return self._get_cycle_lr()
        return self._get_decay_lr(self.last_batch_iteration - self.total_size + 1)

    def _get_cycle_mom(self):
        scale = self._scale_factor()
        moms = []
        for base_betas, max_betas in zip(self.min_moms, self.max_moms):
            height = (max_betas[0] - base_betas[0]) * scale
            moms.append((max_betas[0] - height, base_betas[1]))
        return moms

    def _get_decay_mom(self, decay_batch_iteration):
        factor = 1 + self.decay_mom_rate * (decay_batch_iteration /
                                            self.decay_step_size)
        return [(beta0 * factor, beta1) for beta0, beta1 in self.max_moms]

    def get_mom(self):
        if not self.cycle_momentum:
            return None
        if (self.last_batch_iteration + 1) < self.total_size or \
                not self.decay_step_size:
            return self._get_cycle_mom()
        return self._get_decay_mom(self.last_batch_iteration -
                                   self.total_size + 1)

    def step(self, batch_iteration=None):
        if batch_iteration is None:
            batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = batch_iteration
        self._update_optimizer(self.get_lr())
        self._last_lr = [g["lr"] for g in self.optimizer.param_groups]
        if self.cycle_momentum:
            for param_group, mom in zip(self.optimizer.param_groups,
                                        self.get_mom()):
                param_group["betas"] = mom


class WarmupLR(_LRSchedulerBase):
    """Log-warmup from min_lr to max_lr over warmup_num_steps, then flat
    (reference :677)."""

    def __init__(self, optimizer, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, last_batch_iteration=-1):
        self.optimizer = _get_optimizer(optimizer)
        self.min_lrs = _format_param(self.optimizer, warmup_min_lr, "min_lr")
        self.max_lrs = _format_param(self.optimizer, warmup_max_lr, "max_lr")
        self.delta_lrs = [b - s for b, s in zip(self.max_lrs, self.min_lrs)]
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)
        self.last_batch_iteration = last_batch_iteration

    def _get_gamma(self):
        if self.last_batch_iteration < self.warmup_num_steps:
            return self.inverse_log_warm_up * math.log(
                self.last_batch_iteration + 1)
        return 1.0

    def get_lr(self):
        if self.last_batch_iteration < 0:
            logger.warning("Attempting to get learning rate from scheduler "
                           "before it has started")
            return [0.0]
        gamma = self._get_gamma()
        return [min_lr + (delta * gamma)
                for min_lr, delta in zip(self.min_lrs, self.delta_lrs)]


class WarmupDecayLR(WarmupLR):
    """Warmup then linear decay to 0 over total_num_steps (reference :761)."""

    def __init__(self, optimizer, total_num_steps, warmup_min_lr=0.0,
                 warmup_max_lr=0.001, warmup_num_steps=1000,
                 last_batch_iteration=-1):
        self.total_num_steps = total_num_steps
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr,
                         warmup_num_steps, last_batch_iteration)
        if self.total_num_steps < self.warmup_num_steps:
            logger.warning(
                f"total_num_steps {total_num_steps} is less than "
                f"warmup_num_steps {warmup_num_steps}")

    def _get_gamma(self):
        if self.last_batch_iteration < self.warmup_num_steps:
            return self.inverse_log_warm_up * math.log(
                self.last_batch_iteration + 1)
        return max(0.0,
                   float(self.total_num_steps - self.last_batch_iteration) /
                   float(max(1.0, self.total_num_steps - self.warmup_num_steps)))


SCHEDULERS = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
}


def get_scheduler_class(name):
    if name not in SCHEDULERS:
        raise ValueError(
            f"unknown scheduler {name!r}; valid: {VALID_LR_SCHEDULES}")
    return SCHEDULERS[name]

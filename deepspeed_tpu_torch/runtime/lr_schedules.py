"""Learning-rate schedules. Port of
``deepspeed_tpu/runtime/lr_schedules.py``: LRRangeTest, OneCycle, WarmupLR,
WarmupDecayLR and the constant schedule as pure ``step -> lr`` functions of
a Python step count (the engine evaluates them on the host), and the thin
stateful wrapper with the ``step()/get_lr()/state_dict()`` object API."""

import math
from typing import Any, Callable, Dict, Optional

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

WARMUP_MIN_LR = "warmup_min_lr"
WARMUP_MAX_LR = "warmup_max_lr"
WARMUP_NUM_STEPS = "warmup_num_steps"
WARMUP_TYPE = "warmup_type"
WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"
TOTAL_NUM_STEPS = "total_num_steps"

CYCLE_MIN_LR = "cycle_min_lr"
CYCLE_MAX_LR = "cycle_max_lr"
CYCLE_FIRST_STEP_SIZE = "cycle_first_step_size"
CYCLE_SECOND_STEP_SIZE = "cycle_second_step_size"
DECAY_STEP_SIZE = "decay_step_size"
DECAY_LR_RATE = "decay_lr_rate"

Schedule = Callable[[Any], float]  # step -> lr


def lr_range_test(min_lr: float = 1e-3, step_rate: float = 1.0,
                  step_size: int = 2000, staircase: bool = False) -> Schedule:
    """LR range test: the rate grows with the step, continuously or in
    stairs."""

    def schedule(step):
        interval = step / step_size
        if staircase:
            interval = math.floor(interval)
        return min_lr * (1.0 + interval * step_rate)

    return schedule


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000,
              warmup_type: str = WARMUP_LOG_RATE) -> Schedule:
    """Warm-up (log or linear), then constant."""
    warmup_num_steps = max(2, warmup_num_steps)
    delta = warmup_max_lr - warmup_min_lr
    inverse_log_warm_up = 1.0 / math.log(warmup_num_steps)

    def schedule(step):
        step = float(step)
        if warmup_type == WARMUP_LOG_RATE:
            gamma = inverse_log_warm_up * math.log(max(step, 1.0) + 1.0)
        else:
            gamma = step / warmup_num_steps
        return warmup_min_lr + delta * min(gamma, 1.0)

    return schedule


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = WARMUP_LOG_RATE) -> Schedule:
    """Warm-up, then linear decay to zero at ``total_num_steps``."""
    base = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                     warmup_type)
    warm_steps = max(2, warmup_num_steps)

    def schedule(step):
        step = float(step)
        if step < warm_steps:
            return base(step)
        decay = max(0.0, (total_num_steps - step)
                    / max(1.0, float(total_num_steps - warm_steps)))
        return warmup_max_lr * decay

    return schedule


def one_cycle(cycle_min_lr: float, cycle_max_lr: float,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None,
              decay_step_size: int = 0,
              decay_lr_rate: float = 0.0) -> Schedule:
    """1-cycle policy: min to max over the first leg, max to min over the
    second, then decay."""
    first = float(cycle_first_step_size)
    second = float(cycle_second_step_size
                   if cycle_second_step_size is not None
                   else cycle_first_step_size)
    total_cycle = first + second
    span = cycle_max_lr - cycle_min_lr

    def schedule(step):
        step = float(step)
        if step > total_cycle:
            if decay_step_size > 0 and decay_lr_rate > 0:
                decay_steps = math.floor((step - total_cycle) / decay_step_size)
                return cycle_min_lr / (1.0 + decay_lr_rate
                                       * max(decay_steps, 0.0))
            return cycle_min_lr
        if step <= first:
            return cycle_min_lr + span * min(max(step / first, 0.0), 1.0)
        return cycle_max_lr - span * min(max((step - first) / second, 0.0),
                                         1.0)

    return schedule


def constant_lr(lr: float) -> Schedule:
    def schedule(step):
        del step
        return float(lr)

    return schedule


def get_lr_schedule(name: Optional[str], params: Dict[str, Any],
                    base_lr: float = 1e-3) -> Schedule:
    """The JSON ``scheduler`` section (name and params) -> schedule."""
    if name is None:
        return constant_lr(base_lr)
    if name == LR_RANGE_TEST:
        return lr_range_test(
            min_lr=params.get(LR_RANGE_TEST_MIN_LR, 1e-3),
            step_rate=params.get(LR_RANGE_TEST_STEP_RATE, 1.0),
            step_size=params.get(LR_RANGE_TEST_STEP_SIZE, 2000),
            staircase=params.get(LR_RANGE_TEST_STAIRCASE, False))
    if name == WARMUP_LR:
        return warmup_lr(
            warmup_min_lr=params.get(WARMUP_MIN_LR, 0.0),
            warmup_max_lr=params.get(WARMUP_MAX_LR, base_lr),
            warmup_num_steps=params.get(WARMUP_NUM_STEPS, 1000),
            warmup_type=params.get(WARMUP_TYPE, WARMUP_LOG_RATE))
    if name == WARMUP_DECAY_LR:
        return warmup_decay_lr(
            total_num_steps=params[TOTAL_NUM_STEPS],
            warmup_min_lr=params.get(WARMUP_MIN_LR, 0.0),
            warmup_max_lr=params.get(WARMUP_MAX_LR, base_lr),
            warmup_num_steps=params.get(WARMUP_NUM_STEPS, 1000),
            warmup_type=params.get(WARMUP_TYPE, WARMUP_LOG_RATE))
    if name == ONE_CYCLE:
        return one_cycle(
            cycle_min_lr=params[CYCLE_MIN_LR],
            cycle_max_lr=params[CYCLE_MAX_LR],
            cycle_first_step_size=params.get(CYCLE_FIRST_STEP_SIZE, 2000),
            cycle_second_step_size=params.get(CYCLE_SECOND_STEP_SIZE),
            decay_step_size=params.get(DECAY_STEP_SIZE, 0),
            decay_lr_rate=params.get(DECAY_LR_RATE, 0.0))
    raise ValueError(f"unknown lr schedule {name}; valid: {VALID_LR_SCHEDULES}")


class LRScheduler:
    """Stateful wrapper with the object API
    (step/get_lr/state_dict/load_state_dict)."""

    def __init__(self, schedule: Schedule, last_batch_iteration: int = -1):
        self.schedule = schedule
        self.last_batch_iteration = last_batch_iteration

    def step(self, last_batch_iteration: Optional[int] = None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self):
        return [float(self.schedule(max(0, self.last_batch_iteration)))]

    def get_last_lr(self):
        return self.get_lr()

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]

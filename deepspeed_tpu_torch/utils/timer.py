"""Wall-clock and throughput timers.

Port of ``deepspeed_tpu/utils/timer.py``: named timers with an optional
device synchronisation at start and stop, a do-nothing stand-in when
``wall_clock_breakdown`` is off, the samples/s meter with a warm-up skip,
and ``trim_mean``. The synchronisation is
``torch.cuda.synchronize(device)`` on the card and nothing on the host,
where every operation has finished when it returns. Unlike the JAX
package's best-effort flush, a failing synchronisation raises.
"""

import time
from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from deepspeed_tpu_torch.utils.logging import logger

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"
TRAIN_BATCH_TIMER = "train_batch"


def device_sync(device: Optional[torch.device]) -> None:
    """Wait for the work queued on ``device`` (a no-op on the host)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class SynchronizedWallClockTimer:
    """Named timers; ``sync=True`` at start or stop waits for
    ``device`` first."""

    class Timer:
        def __init__(self, name: str, device=None):
            self.name_ = name
            self.device = device
            self.started_ = False
            self.start_time = 0.0
            self.elapsed_records: List[float] = []

        def start(self, sync: bool = False):
            if self.started_:
                raise RuntimeError(f"{self.name_} timer has already been "
                                   f"started")
            if sync:
                device_sync(self.device)
            self.start_time = time.time()
            self.started_ = True

        def stop(self, reset: bool = False, record: bool = True,
                 sync: bool = False):
            if not self.started_:
                raise RuntimeError(f"{self.name_} timer is not started")
            if sync:
                device_sync(self.device)
            elapsed = time.time() - self.start_time
            if record:
                self.elapsed_records.append(elapsed)
            self.started_ = False

        def reset(self):
            self.started_ = False
            self.elapsed_records = []

        def elapsed(self, reset: bool = True) -> float:
            """Total seconds recorded so far."""
            total = sum(self.elapsed_records)
            if self.started_:
                total += time.time() - self.start_time
            if reset:
                self.reset()
            return total

        def mean(self) -> float:
            if not self.elapsed_records:
                return 0.0
            return sum(self.elapsed_records) / len(self.elapsed_records)

    def __init__(self, device=None):
        self.device = device
        self.timers: "OrderedDict[str, SynchronizedWallClockTimer.Timer]" \
            = OrderedDict()

    def __call__(self, name: str) -> "SynchronizedWallClockTimer.Timer":
        if name not in self.timers:
            self.timers[name] = self.Timer(name, self.device)
        return self.timers[name]

    def get_timers(self):
        return self.timers

    def log(self, names: List[str], normalizer: float = 1.0,
            reset: bool = True, memory_breakdown: bool = False):
        if normalizer <= 0.0:
            raise ValueError(f"normalizer must be positive, got {normalizer}")
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) * 1e3 / normalizer
                string += f" | {name}: {ms:.2f}"
        if memory_breakdown and self.device is not None \
                and torch.device(self.device).type == "cuda":
            string += (f" | device mem: allocated "
                       f"{torch.cuda.memory_allocated(self.device) / 2**30:.2f}"
                       f"GB, peak "
                       f"{torch.cuda.max_memory_allocated(self.device) / 2**30:.2f}"
                       f"GB")
        logger.info(string)

    def means(self, names: List[str]) -> Dict[str, float]:
        return {n: self.timers[n].mean() for n in names if n in self.timers}


class NoopTimer:
    """Disabled-timer stand-in, so call sites need no branch."""

    class Timer:
        def start(self, **kw):
            ...

        def stop(self, **kw):
            ...

        def reset(self):
            ...

        def elapsed(self, **kw):
            return 0.0

        def mean(self):
            return 0.0

    def __call__(self, name):
        return self.Timer()

    def get_timers(self):
        return {}

    def log(self, *a, **kw):
        ...

    def means(self, *a, **kw):
        return {}


class ThroughputTimer:
    """Samples/s meter that skips the first ``start_step`` steps.

    The JAX package's meter waits for the device at the start and the stop
    of every step. This one waits only where it reports: at the start of
    the first counted step, every ``steps_per_output`` steps, and in
    :meth:`avg_samples_per_sec`; between those points the host runs ahead
    of the device as the engine's step does. Its times are the wall clock
    of those windows, so they include the host's time between steps (the
    next batch's loading)."""

    def __init__(self, batch_size: int, start_step: int = 2,
                 steps_per_output: int = 50, logging_fn=None, device=None):
        self.started = False
        self.batch_size = max(1, batch_size)
        self.start_step = start_step
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0.0      # the closed windows' seconds
        self.steps_per_output = steps_per_output
        self.logging = logging_fn or logger.info
        self.device = device
        self.initialized = False
        self.window_start: Optional[float] = None
        self.window_step = 0               # global steps when it opened

    def update_epoch_count(self):
        self.epoch_count += 1
        self.micro_step_count = 0

    def start(self):
        self.initialized = True
        self.started = True
        if self.window_start is None \
                and self.global_step_count >= self.start_step:
            device_sync(self.device)
            self.window_start = time.perf_counter()
            self.window_step = self.global_step_count

    def stop(self, global_step: bool = False, report_speed: bool = True):
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        if not global_step:
            return
        self.global_step_count += 1
        if self.window_start is not None and report_speed \
                and self.global_step_count % self.steps_per_output == 0:
            steps, seconds = self._close_window()
            self.logging(
                f"epoch={self.epoch_count}/micro_step="
                f"{self.micro_step_count}/global_step="
                f"{self.global_step_count}, RunningAvgSamplesPerSec="
                f"{self.avg_samples_per_sec():.2f}, CurrSamplesPerSec="
                f"{self.batch_size * steps / seconds:.2f}")

    def _close_window(self):
        """(steps, seconds) of the open window, which the device has
        finished; the next window opens now."""
        device_sync(self.device)
        now = time.perf_counter()
        steps = self.global_step_count - self.window_step
        seconds = now - self.window_start
        self.total_elapsed_time += seconds
        self.window_start, self.window_step = now, self.global_step_count
        return steps, seconds

    def avg_samples_per_sec(self) -> float:
        """Samples/s since the first counted step (waits for the
        device)."""
        if self.global_step_count <= self.start_step \
                or self.window_start is None:
            return float("-inf")
        if self.global_step_count > self.window_step:
            self._close_window()
        if self.total_elapsed_time <= 0:
            return float("-inf")
        samples = self.batch_size * (self.global_step_count
                                     - self.start_step)
        return samples / self.total_elapsed_time


def trim_mean(data: List[float], trim_percent: float) -> float:
    """Mean of ``data`` without its top and bottom ``trim_percent``."""
    if not 0.0 <= trim_percent <= 1.0:
        raise ValueError(f"trim_percent must be in [0, 1], got "
                         f"{trim_percent}")
    n = len(data)
    if n == 0:
        return 0.0
    data = sorted(data)
    trim = int(n * trim_percent)
    trimmed = data[trim:n - trim] or data
    return sum(trimmed) / len(trimmed)

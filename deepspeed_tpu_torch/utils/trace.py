"""Trace capture and hot-path annotation over ``torch.profiler``.

Port of ``deepspeed_tpu/utils/trace.py``, whose named scopes and XPlane
captures become ``torch.profiler``'s record functions and Chrome traces:

- :func:`instrument` runs a function under a named range
  (``torch.profiler.record_function``): a ``user_annotation`` span on the
  host's timeline of a capture, around the operations and kernels it
  launches;
- :func:`annotation` is the same range as a context manager;
- :func:`capture` traces the enclosed block and writes one Chrome trace
  (``.json``; chrome://tracing or Perfetto read it) into ``log_dir``: the
  host's operations always, the card's kernels and copies (CUDA activity,
  through CUPTI) when a card is visible.

Usage::

    from deepspeed_tpu_torch.utils import trace

    @trace.instrument()
    def hot_path(...): ...

    with trace.capture("build/traces") as cap:
        engine.train_batch(batch)
    print(cap.path)

or let the engines drive it: ``DeepSpeedEngine.start_trace(log_dir,
steps=3)`` traces the next 3 ``train_batch`` calls,
``ServingEngine.capture_profile(steps, outdir)`` the next scheduler
iterations. Outside a capture a range costs one record-function call.
"""

import contextlib
import functools
import itertools
import os
from typing import Optional

import torch

_written = itertools.count()


def instrument(name: Optional[str] = None):
    """Decorator naming a function's range in a trace (its qualified name
    by default): the ``instrument_w_nvtx`` analogue."""

    def deco(fn):
        scope = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(scope):
                return fn(*args, **kwargs)

        return wrapped

    return deco


def annotation(name: str):
    """A named range of the trace, as a context manager (NVTX push/pop)."""
    return torch.profiler.record_function(name)


class Capture:
    """One trace window: :meth:`start` opens a ``torch.profiler`` session
    (CPU activity, and CUDA activity when a card is visible), :meth:`stop`
    closes it and writes the Chrome trace to :attr:`path`, a new file in
    ``log_dir``. :attr:`profile` keeps the session for its
    ``key_averages()``."""

    def __init__(self, log_dir: str):
        self.log_dir = str(log_dir)
        self.path: Optional[str] = None
        self.profile = None

    def start(self) -> "Capture":
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.profile = torch.profiler.profile(activities=activities)
        self.profile.start()
        return self

    def stop(self) -> str:
        self.profile.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(
            self.log_dir, f"trace_{os.getpid()}_{next(_written)}.json")
        self.profile.export_chrome_trace(self.path)
        return self.path


@contextlib.contextmanager
def capture(log_dir: str):
    """Trace the enclosed block into a Chrome trace in ``log_dir``; yields
    the :class:`Capture`, whose ``path`` is set on exit."""
    cap = Capture(log_dir).start()
    try:
        yield cap
    finally:
        cap.stop()

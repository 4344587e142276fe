"""Step-time breakdown: sampled per-phase timing of scheduler steps
(admission, prefill, decode, bookkeeping).

Port of ``deepspeed_tpu/telemetry/breakdown.py``. Kernel launches are
asynchronous, so a phase's wall time means something only after a device
barrier: otherwise the prefill's kernels bill to the decode phase and the
decode's to the next step's admission. The barrier (the serving engine's
``_sync_devices``: ``torch.cuda.synchronize`` on the card, nothing on the
host) runs only on sampled steps, every ``sample_every``-th; the other
steps pay one modulo and a branch.

A sampled step's laps land in the registry (``serving_step_<phase>_s``
histograms and the ``serving_step_s`` total) and in the tracer as one
``step_phase`` record, which the Chrome-trace export draws as consecutive
slices on the scheduler row.
"""

import time
from typing import Callable, Dict, Optional

from deepspeed_tpu_torch.telemetry.metrics import MetricsRegistry

PHASES = ("admission", "prefill", "decode", "bookkeeping")

# wall-seconds ladder: scheduler phases run 10 us .. 1 s
_PHASE_BUCKETS = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3,
                  5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


class StepBreakdown:
    """Drive from the scheduler as::

        sampled = bd.begin(step_idx, sync=engine_sync)   # maybe sync+stamp
        ...admission work...;  bd.lap("admission")
        ...prefill work...;    bd.lap("prefill")
        ...decode work...;     bd.lap("decode")
        ...bookkeeping...;     bd.finish(occupancy=occ)  # lap + record

    On non-sampled steps every call is a single boolean check."""

    enabled = True

    def __init__(self, registry: MetricsRegistry, tracer,
                 sample_every: int = 16):
        self.sample_every = max(1, int(sample_every))
        self._tracer = tracer
        self._hists = {
            ph: registry.histogram(
                f"serving_step_{ph}_s",
                help=f"sampled wall seconds per step in the {ph} phase",
                buckets=_PHASE_BUCKETS)
            for ph in PHASES}
        self._total = registry.histogram(
            "serving_step_s", help="sampled total wall seconds per step",
            buckets=_PHASE_BUCKETS)
        self._sampling = False
        self._step = -1
        self._sync: Optional[Callable[[], None]] = None
        self._t0 = 0.0
        self._durs: Dict[str, float] = {}

    def begin(self, step: int, sync: Optional[Callable[[], None]] = None
              ) -> bool:
        """Arm the breakdown for ``step`` if it is a sampled one. The
        sync drains work queued by PREVIOUS steps so the first lap is
        not billed for their tail."""
        self._sampling = (step % self.sample_every == 0)
        if not self._sampling:
            return False
        self._step = step
        self._sync = sync
        self._durs = {}
        if sync is not None:
            sync()
        self._t0 = time.perf_counter()
        return True

    def lap(self, phase: str) -> None:
        """Close the current phase: sync (device work dispatched during
        the phase bills to it, not to the next) and stamp."""
        if not self._sampling:
            return
        if self._sync is not None:
            self._sync()
        t = time.perf_counter()
        self._durs[phase] = self._durs.get(phase, 0.0) + (t - self._t0)
        self._t0 = t

    def finish(self, occupancy: Optional[int] = None) -> None:
        """Final lap (everything since the decode lap is bookkeeping),
        then publish: histograms per phase + one tracer record."""
        if not self._sampling:
            return
        self.lap("bookkeeping")
        self._sampling = False
        total = sum(self._durs.values())
        for ph, d in self._durs.items():
            self._hists[ph].observe(d)
        self._total.observe(total)
        data = {f"{ph}_s": d for ph, d in self._durs.items()}
        data["total_s"] = total
        if occupancy is not None:
            data["occupancy"] = int(occupancy)
        self._tracer.event("step_phase", step=self._step, **data)


class NoopBreakdown:
    """The telemetry-off twin: ``begin`` reports not-sampled and every
    other call is a constant-time no-op."""

    enabled = False
    sample_every = 0

    def begin(self, step, sync=None) -> bool:
        return False

    def lap(self, phase) -> None:
        pass

    def finish(self, occupancy=None) -> None:
        pass

"""Serving telemetry: request-lifecycle tracing, a metrics registry with
Prometheus and Perfetto exporters, a sampled step-time breakdown, and cost
accounting.

Port of ``deepspeed_tpu/telemetry/`` for the serving engine
(:class:`~deepspeed_tpu_torch.inference.serving.ServingEngine`):

- :class:`~deepspeed_tpu_torch.telemetry.metrics.MetricsRegistry`:
  counters, gauges, fixed-bucket histograms; Prometheus text and
  Monitor scalars;
- :class:`~deepspeed_tpu_torch.telemetry.tracer.RequestTracer`: the
  ring-buffered lifecycle events, exported as Chrome-trace JSON and read
  back by :func:`read_serving_trace` (a router's fleet trace by
  :func:`read_fleet_trace`);
- :class:`~deepspeed_tpu_torch.telemetry.breakdown.StepBreakdown`:
  sampled per-phase step timing behind a device barrier;
- :mod:`~deepspeed_tpu_torch.telemetry.costs`: analytic FLOPs, HBM bytes
  and KV block-seconds per dispatch, request and tenant;
- :class:`~deepspeed_tpu_torch.telemetry.flight.FlightRecorder`: the
  CRC-stamped postmortem artifact a ``DegradedError`` writes first.

``ServingEngine(telemetry=)``: True or False forces it, a
:class:`Telemetry` instance is used as it is (one shared by several
engines aggregates them), None reads ``DS_TELEMETRY`` (default off: the
no-op twins, one attribute access per call site). Telemetry on implies
cost accounting, which ``cost_accounting=`` or ``DS_COST_ACCOUNTING``
also turns on alone; ``flight_recorder=`` or ``DS_FLIGHT_RECORDER`` arms
the flight recorder.
"""

import time
from typing import Optional

from deepspeed_tpu_torch.telemetry.breakdown import (NoopBreakdown, PHASES,
                                                     StepBreakdown)
from deepspeed_tpu_torch.telemetry.costs import (CostAccountant, NOOP_COSTS,
                                                 NoopCostAccountant,
                                                 ProgramCostRegistry,
                                                 device_peak_flops,
                                                 model_flops_per_token)
from deepspeed_tpu_torch.telemetry.flight import (FlightRecorder,
                                                  NOOP_FLIGHT,
                                                  NoopFlightRecorder,
                                                  load_artifact)
from deepspeed_tpu_torch.telemetry.metrics import (Counter, DEFAULT_BUCKETS,
                                                   Gauge, Histogram,
                                                   MetricsRegistry,
                                                   RATE_BUCKETS,
                                                   TEMP_BUCKETS,
                                                   merge_registries)
from deepspeed_tpu_torch.telemetry.tracer import (NoopTracer, RequestTracer,
                                                  read_fleet_trace,
                                                  read_serving_trace)
from deepspeed_tpu_torch.utils.env import resolve_flag

__all__ = ["Telemetry", "NoopTelemetry", "NOOP", "resolve_telemetry",
           "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "RequestTracer", "NoopTracer", "read_serving_trace",
           "read_fleet_trace",
           "StepBreakdown", "NoopBreakdown", "PHASES", "DEFAULT_BUCKETS",
           "RATE_BUCKETS", "TEMP_BUCKETS", "merge_registries",
           "CostAccountant", "NoopCostAccountant", "NOOP_COSTS",
           "ProgramCostRegistry", "device_peak_flops",
           "model_flops_per_token", "FlightRecorder", "NoopFlightRecorder",
           "NOOP_FLIGHT", "load_artifact"]


def resolve_telemetry(flag: Optional[bool] = None) -> bool:
    """An explicit flag wins, then ``DS_TELEMETRY``; default off."""
    return resolve_flag("DS_TELEMETRY", flag)


class Telemetry:
    """One registry, one tracer and one breakdown, shared by everything a
    serving engine emits."""

    enabled = True

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 trace_capacity: int = 65536, sample_every: int = 16,
                 clock=time.perf_counter):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = RequestTracer(capacity=trace_capacity, clock=clock)
        self.breakdown = StepBreakdown(self.registry, self.tracer,
                                       sample_every=sample_every)

    def to_prometheus(self) -> str:
        return self.registry.to_prometheus()

    def export_trace(self, path: str) -> str:
        return self.tracer.export(path)

    def to_scalars(self, step: int):
        return self.registry.to_scalars(step)


class NoopTelemetry:
    """The off bundle: no registry (the engine keeps a private one for its
    stats), no records, no sampling."""

    enabled = False
    registry = None

    def __init__(self):
        self.tracer = NoopTracer()
        self.breakdown = NoopBreakdown()

    def to_prometheus(self) -> str:
        return ""

    def export_trace(self, path: str) -> str:
        return self.tracer.export(path)

    def to_scalars(self, step: int):
        return []


NOOP = NoopTelemetry()

"""Metrics registry: counters, gauges and fixed-bucket histograms.

Port of ``deepspeed_tpu/telemetry/metrics.py``, the same classes and
exporters, so the two packages' registries read alike: one registry holds
every metric the serving scheduler emits; ``to_prometheus`` gives the
Prometheus text exposition and ``to_scalars`` the ``(tag, value, step)``
tuples of :class:`deepspeed_tpu_torch.utils.monitor.Monitor`.

Everything here is host-side Python: observing a value is a dict lookup
and an add, with no tensor and no device work. Histograms bucket at
observe time into preallocated counts (Prometheus ``le`` semantics) and
estimate percentiles by linear interpolation inside the owning bucket;
beside the buckets each keeps a bounded ring of recent ``(at, value)``
observations for windowed summaries. Clocks are the caller's (scheduler
steps, or seconds), so the default ladder spans both.
"""

from bisect import bisect_left
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# log-ish ladder covering sub-millisecond wall clocks AND integer step
# clocks: 1-2.5-5 decades from 100us to 250 units
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0)

# even ladder over [0, 1] for ratio-valued histograms (speculative
# accept_rate, hit rates): 5%-wide buckets keep the p50/p95 of a rate
# meaningful where the timing ladder above would dump every sample
# into two buckets
RATE_BUCKETS: Tuple[float, ...] = tuple(
    round(0.05 * i, 2) for i in range(1, 21))

# ladder for sampling-temperature histograms: a 0.0 bucket isolates
# greedy traffic, then 0.1-wide steps over the practical (0, 2] range
# (anything hotter lands in +Inf — it is noise-temperature anyway)
TEMP_BUCKETS: Tuple[float, ...] = (0.0,) + tuple(
    round(0.1 * i, 1) for i in range(1, 21))


def _fmt(v) -> str:
    """Prometheus sample formatting: integral values render without the
    trailing ``.0`` so counter lines stay the conventional ``name 42``."""
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class Counter:
    """Monotonic counter. ``value`` stays an int while fed ints (the
    serving stats view compares against ints in tests)."""
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram with Prometheus ``le`` (inclusive upper
    bound) semantics; the last bucket is the implicit ``+Inf`` overflow.
    ``percentile`` linearly interpolates inside the owning bucket and
    clamps the overflow bucket to the largest observed value, so an
    estimate never exceeds reality.

    Alongside the cumulative buckets the histogram keeps a bounded ring
    of the most recent ``(at, value)`` observations so controllers can
    ask for "p99 over the last N clock units" (``window_summary``)
    instead of the lifetime digest. The ring is host-side and O(1) per
    observe; it never feeds the Prometheus exposition, which stays
    cumulative-only."""
    __slots__ = ("name", "help", "uppers", "counts", "sum", "count",
                 "_vmax", "_ring", "_seq")

    #: default ring depth — enough for a few windows of serving traffic
    #: without unbounded growth (SLO windows are tens of observations)
    WINDOW_CAPACITY = 1024

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None,
                 window_capacity: Optional[int] = None):
        self.name = name
        self.help = help
        ups = tuple(sorted(float(b) for b in
                           (DEFAULT_BUCKETS if buckets is None else buckets)))
        if not ups:
            raise ValueError(f"histogram {name}: needs >= 1 finite bucket")
        self.uppers = ups
        self.counts = [0] * (len(ups) + 1)   # [+ overflow]
        self.sum = 0.0
        self.count = 0
        self._vmax = 0.0
        cap = self.WINDOW_CAPACITY if window_capacity is None \
            else int(window_capacity)
        self._ring: deque = deque(maxlen=max(cap, 1))
        self._seq = 0

    def observe(self, v, at: Optional[float] = None) -> None:
        """Record one observation. ``at`` is the caller's clock (step
        index or seconds); when omitted it defaults to the observation
        sequence number so windows degrade to "last N observations"."""
        v = float(v)
        self.counts[bisect_left(self.uppers, v)] += 1
        self.sum += v
        self.count += 1
        if v > self._vmax:
            self._vmax = v
        self._ring.append((self._seq if at is None else float(at), v))
        self._seq += 1

    def window_values(self, window: Optional[float] = None,
                      now: Optional[float] = None) -> List[float]:
        """Raw values from the ring with ``at >= now - window``; the
        whole ring when ``window`` is None. ``now`` defaults to the
        newest observation's clock, so a quiet histogram still reports
        its latest window instead of an empty one."""
        if not self._ring:
            return []
        if window is None:
            return [v for _, v in self._ring]
        if now is None:
            now = self._ring[-1][0]
        lo = now - float(window)
        return [v for at, v in self._ring if at >= lo]

    def window_summary(self, window: Optional[float] = None,
                       now: Optional[float] = None) -> Dict[str, float]:
        """Exact p50/p95/p99/mean over the recent-observation ring —
        same keys as ``summary`` but computed from raw windowed values
        (numpy-style linear interpolation) rather than bucket counts."""
        vals = sorted(self.window_values(window, now))
        if not vals:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0,
                    "mean": 0.0, "count": 0.0}

        def pct(q: float) -> float:
            rank = (q / 100.0) * (len(vals) - 1)
            lo = int(rank)
            hi = min(lo + 1, len(vals) - 1)
            return vals[lo] + (vals[hi] - vals[lo]) * (rank - lo)

        return {"p50": pct(50), "p95": pct(95), "p99": pct(99),
                "mean": sum(vals) / len(vals), "count": float(len(vals))}

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (q in [0, 100]) from the bucket
        counts — same interpolation as PromQL histogram_quantile."""
        if self.count == 0:
            return 0.0
        target = (q / 100.0) * self.count
        cum = 0
        lo = 0.0
        for i, ub in enumerate(self.uppers):
            c = self.counts[i]
            if c and cum + c >= target:
                frac = min(max((target - cum) / c, 0.0), 1.0)
                return min(lo + (ub - lo) * frac, self._vmax)
            cum += c
            lo = ub
        return self._vmax      # lives in the overflow bucket

    def summary(self) -> Dict[str, float]:
        """p50/p95/p99 digest — the shape Monitor.write_scalars expands
        into ``tag/p50`` style sub-scalars."""
        return {"p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99),
                "mean": self.sum / self.count if self.count else 0.0,
                "count": float(self.count)}


class MetricsRegistry:
    """Name -> metric map with get-or-create accessors (re-requesting a
    name returns the same instance, so serving phases and exporters
    never race on registration order)."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name, help)
        return c

    def gauge(self, name: str, help: str = "") -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, help)
        return g

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, help, buckets)
        return h

    def names(self) -> List[str]:
        return (list(self._counters) + list(self._gauges)
                + list(self._histograms))

    # -- exporters -----------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4): HELP/TYPE headers
        per family, cumulative ``_bucket{le=...}`` series + ``_sum`` /
        ``_count`` for histograms."""
        out: List[str] = []
        for c in self._counters.values():
            if c.help:
                out.append(f"# HELP {c.name} {c.help}")
            out.append(f"# TYPE {c.name} counter")
            out.append(f"{c.name} {_fmt(c.value)}")
        for g in self._gauges.values():
            if g.help:
                out.append(f"# HELP {g.name} {g.help}")
            out.append(f"# TYPE {g.name} gauge")
            out.append(f"{g.name} {_fmt(g.value)}")
        for h in self._histograms.values():
            if h.help:
                out.append(f"# HELP {h.name} {h.help}")
            out.append(f"# TYPE {h.name} histogram")
            cum = 0
            for i, ub in enumerate(h.uppers):
                cum += h.counts[i]
                out.append(f'{h.name}_bucket{{le="{_fmt(ub)}"}} {cum}')
            out.append(f'{h.name}_bucket{{le="+Inf"}} {h.count}')
            out.append(f"{h.name}_sum {_fmt(h.sum)}")
            out.append(f"{h.name}_count {h.count}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> Dict[str, Dict]:
        """Plain-data dump: counter and gauge values, histogram summaries."""
        return {
            "counters": {n: c.value for n, c in self._counters.items()},
            "gauges": {n: g.value for n, g in self._gauges.items()},
            "histograms": {n: h.summary()
                           for n, h in self._histograms.items()},
        }

    def to_scalars(self, step: int) -> List[Tuple[str, object, int]]:
        """``(tag, value, step)`` tuples for Monitor.write_scalars —
        histogram entries carry their summary dict, which the monitor
        expands into ``tag/p50`` etc."""
        out: List[Tuple[str, object, int]] = []
        for n, c in self._counters.items():
            out.append((n, c.value, step))
        for n, g in self._gauges.items():
            out.append((n, g.value, step))
        for n, h in self._histograms.items():
            out.append((n, h.summary(), step))
        return out


def merge_registries(regs: Iterable["MetricsRegistry"]) -> "MetricsRegistry":
    """Fold several per-replica registries into one fleet view.

    Counters and gauges sum (the serving gauges — occupancy, queue
    depth, blocks in use — are extensive quantities, so the fleet total
    is the meaningful aggregate); histograms require an identical
    bucket ladder and merge bucket-wise, with the recent-observation
    rings interleaved by clock so ``window_summary`` on the merged
    histogram sees the fleet's latest traffic. The inputs are left
    untouched — this is a snapshot-style fold, safe to call every
    controller tick."""
    out = MetricsRegistry()
    for reg in regs:
        for n, c in reg._counters.items():
            out.counter(n, c.help).inc(c.value)
        for n, g in reg._gauges.items():
            mg = out.gauge(n, g.help)
            mg.set(mg.value + g.value)
        for n, h in reg._histograms.items():
            mh = out.histogram(n, h.help, h.uppers)
            if mh.uppers != h.uppers:
                raise ValueError(
                    f"histogram {n}: bucket ladders differ across "
                    f"replicas — fleet merge needs identical ladders")
            for i, c in enumerate(h.counts):
                mh.counts[i] += c
            mh.sum += h.sum
            mh.count += h.count
            if h._vmax > mh._vmax:
                mh._vmax = h._vmax
            merged = sorted(list(mh._ring) + list(h._ring),
                            key=lambda p: p[0])
            mh._ring.clear()
            mh._ring.extend(merged[-mh._ring.maxlen:])
            mh._seq = max(mh._seq, h._seq)
    return out

"""Request-lifecycle tracer: a host-side ring buffer of scheduler events,
exported as a Chrome-trace / Perfetto JSON timeline.

Port of ``deepspeed_tpu/telemetry/tracer.py``. Each request transition of
the serving scheduler is one record: ``enqueue`` -> ``admit`` (with the
prefix match) -> ``prefill_chunk``* -> ``prefill_done`` -> ``first_token``
-> ``evict`` / re-``admit`` -> ``finish``, beside scheduler-lane records
(``step_phase``, ``horizon_step``, ``spec_verify``, ``watchdog``,
``degraded``, and ``fault``, which the serving engine's listener on its
fault injector records at the scheduler step) and the cache's (``cow``,
``cache_evict_block``, ``cache_spill``, ``cache_restore``,
``cache_restore_corrupt``). A record is
``(ts, etype, rid, step, slot, data)``; recording is one tuple build and
an indexed store into a preallocated ring (``dropped`` counts the records
overwritten once it wraps), and nothing is serialized before
:meth:`RequestTracer.export`.

The export turns the point records into per-request spans (``queued``
enqueue -> admit, ``prefill`` admit -> prefill_done, ``decode``
prefill_done -> finish or evict; an evicted request opens a new queued
span) on one row per request, and the scheduler's records into instants
and slices on row 0. :func:`read_serving_trace` reads an export back into
a summary of spans, terminal states and step phases.
"""

import collections
import gzip
import json
import time
from typing import Any, Callable, Dict, List, Optional

# record layout: (ts, etype, rid, step, slot, data-dict-or-None)
_TS, _ETYPE, _RID, _STEP, _SLOT, _DATA = range(6)

# lifecycle phases, in the order a healthy request traverses them
SPAN_QUEUED = "queued"
SPAN_PREFILL = "prefill"
SPAN_DECODE = "decode"


class RequestTracer:
    """Ring-buffered event recorder. ``event()`` is the only hot-path
    entry point; everything else is export-time."""

    enabled = True

    def __init__(self, capacity: int = 65536,
                 clock: Callable[[], float] = time.perf_counter):
        self.capacity = int(capacity)
        if self.capacity <= 0:
            raise ValueError("tracer capacity must be positive")
        self._clock = clock
        self._buf: List[Optional[tuple]] = [None] * self.capacity
        self._n = 0          # total records ever written

    # -- recording (hot path) ------------------------------------------
    def event(self, etype: str, rid: Any = None, step: int = -1,
              slot: int = -1, **data) -> None:
        self._buf[self._n % self.capacity] = (
            self._clock(), etype, rid, step, slot, data or None)
        self._n += 1

    # -- inspection ----------------------------------------------------
    @property
    def dropped(self) -> int:
        return max(0, self._n - self.capacity)

    def records(self) -> List[tuple]:
        """Surviving records, oldest first."""
        if self._n <= self.capacity:
            return [r for r in self._buf[:self._n]]
        head = self._n % self.capacity
        return self._buf[head:] + self._buf[:head]

    def events_of(self, rid: Any) -> List[tuple]:
        return [r for r in self.records() if r[_RID] == rid]

    def reset(self) -> None:
        self._buf = [None] * self.capacity
        self._n = 0

    # -- export --------------------------------------------------------
    def to_chrome_trace(self) -> Dict:
        """Chrome-trace/Perfetto JSON object. pid 1 is the serving
        process; tid 0 the scheduler lane (step phases, faults,
        watchdog); tids 1.. one lane per request in first-seen order.
        Request lifecycles become ``ph: "X"`` complete events; faults
        and terminal states become ``ph: "i"`` instants; sampled step
        occupancy becomes a ``ph: "C"`` counter track."""
        recs = self.records()
        events: List[Dict] = [
            {"ph": "M", "pid": 1, "name": "process_name",
             "args": {"name": "deepspeed_tpu_torch.serving"}},
            {"ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
             "args": {"name": "scheduler"}},
        ]
        if not recs:
            return {"traceEvents": events, "displayTimeUnit": "ms",
                    "dropped_events": 0}
        t0 = recs[0][_TS]

        def us(ts: float) -> float:
            return round((ts - t0) * 1e6, 3)

        tids: Dict[Any, int] = {}

        def tid_of(rid: Any) -> int:
            t = tids.get(rid)
            if t is None:
                t = tids[rid] = len(tids) + 1
                events.append({"ph": "M", "pid": 1, "tid": t,
                               "name": "thread_name",
                               "args": {"name": f"req {rid}"}})
            return t

        # open[rid] = (span_name, start_ts, start_args)
        open_span: Dict[Any, tuple] = {}

        def close(rid: Any, ts: float, extra: Optional[Dict] = None) -> None:
            sp = open_span.pop(rid, None)
            if sp is None:
                return
            name, start, args = sp
            a = {"rid": str(rid)}
            a.update(args or {})
            a.update(extra or {})
            events.append({"ph": "X", "pid": 1, "tid": tid_of(rid),
                           "cat": "request", "name": name,
                           "ts": us(start), "dur": us(ts) - us(start),
                           "args": a})

        for ts, etype, rid, step, slot, data in recs:
            data = data or {}
            if etype == "enqueue":
                close(rid, ts)           # defensive: rid reuse
                open_span[rid] = (SPAN_QUEUED, ts, {})
            elif etype == "admit":
                close(rid, ts)
                open_span[rid] = (SPAN_PREFILL, ts, {
                    "slot": slot,
                    "prefix_hit": bool(data.get("matched", 0)),
                    "matched_tokens": data.get("matched", 0)})
            elif etype == "prefill_done":
                close(rid, ts)
                open_span[rid] = (SPAN_DECODE, ts, {"slot": slot})
            elif etype == "evict":
                close(rid, ts, {"evicted": True})
                open_span[rid] = (SPAN_QUEUED, ts, {"requeued": True})
                events.append({"ph": "i", "pid": 1, "tid": tid_of(rid),
                               "cat": "request", "name": "evict",
                               "ts": us(ts), "s": "t",
                               "args": {"rid": str(rid), "slot": slot,
                                        "step": step}})
            elif etype == "finish":
                state = data.get("state", "done")
                # a request shed/timed out straight from the queue (or a
                # prefill-final-chunk finish) closes whatever span is open
                if rid not in open_span:
                    open_span[rid] = (SPAN_QUEUED, ts, {})
                close(rid, ts, {"state": state})
                events.append({"ph": "i", "pid": 1, "tid": tid_of(rid),
                               "cat": "request", "name": f"finish:{state}",
                               "ts": us(ts), "s": "t",
                               "args": {"rid": str(rid), "step": step,
                                        "generated":
                                            data.get("generated", 0)}})
            elif etype == "step_phase":
                # consecutive slices on the scheduler lane, one per phase
                start = ts - data.get("total_s", 0.0)
                for ph in ("admission", "prefill", "decode", "bookkeeping"):
                    d = data.get(f"{ph}_s")
                    if d is None:
                        continue
                    events.append({"ph": "X", "pid": 1, "tid": 0,
                                   "cat": "step", "name": ph,
                                   "ts": us(start), "dur": round(d * 1e6, 3),
                                   "args": {"step": step}})
                    start += d
                if "occupancy" in data:
                    events.append({"ph": "C", "pid": 1, "name": "occupancy",
                                   "ts": us(ts),
                                   "args": {"slots": data["occupancy"]}})
            elif etype == "fault":
                events.append({"ph": "i", "pid": 1, "tid": 0,
                               "cat": "fault",
                               "name": f"fault:{data.get('site')}:"
                                       f"{data.get('kind')}",
                               "ts": us(ts), "s": "g",
                               "args": {"site": data.get("site"),
                                        "kind": data.get("kind"),
                                        "visit": data.get("visit"),
                                        "step": step}})
            else:
                # first_token, prefill_chunk, cow, cache_evict_block,
                # watchdog, degraded, ... — instant on the owning lane
                tid = tid_of(rid) if rid is not None else 0
                a = {"step": step}
                if rid is not None:
                    a["rid"] = str(rid)
                a.update(data)
                events.append({"ph": "i", "pid": 1, "tid": tid,
                               "cat": "scheduler", "name": etype,
                               "ts": us(ts), "s": "t", "args": a})
        # whatever is still open at export time renders as in-flight
        last = recs[-1][_TS]
        for rid in list(open_span):
            close(rid, last, {"in_flight": True})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "dropped_events": self.dropped}

    def export(self, path: str) -> str:
        """Write the Chrome-trace JSON to ``path`` (load it in Perfetto
        or chrome://tracing; :func:`read_serving_trace` summarizes it)."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


class NoopTracer:
    """The telemetry-off twin: every entry point is a constant-time
    no-op, so the scheduler's call sites need no branching."""

    enabled = False
    capacity = 0
    dropped = 0

    def event(self, etype, rid=None, step=-1, slot=-1, **data) -> None:
        pass

    def events_of(self, rid) -> List[tuple]:
        return []

    def records(self) -> List[tuple]:
        return []

    def reset(self) -> None:
        pass

    def to_chrome_trace(self) -> Dict:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "dropped_events": 0}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


def read_serving_trace(path: str) -> Dict:
    """Summary of an exported serving trace (a ``.json`` file, or
    ``.json.gz``): per request its span names in time order, its terminal
    state and the microseconds its spans cover; the sampled step phases'
    microseconds; the event and dropped-record counts. The same summary
    as the JAX package's ``tools/trace_analyze.py analyze_serving_trace``,
    with the injected faults in time order (site, kind, visit, step,
    ts)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    events = trace.get("traceEvents", [])
    requests: Dict[Any, Dict] = {}
    phase_us: collections.Counter = collections.Counter()
    faults: List[Dict] = []
    for e in events:
        ph, cat = e.get("ph"), e.get("cat")
        if ph == "X" and cat == "request":
            rid = e.get("args", {}).get("rid")
            r = requests.setdefault(rid, {"spans": [], "state": None,
                                          "span_us": 0.0})
            r["spans"].append((e["ts"], e["name"]))
            r["span_us"] += e.get("dur", 0.0)
            state = e.get("args", {}).get("state")
            if state:
                r["state"] = state
        elif ph == "X" and cat == "step":
            phase_us[e["name"]] += e.get("dur", 0.0)
        elif ph == "i" and cat == "fault":
            faults.append(dict(e.get("args", {}), ts=e.get("ts")))
    for r in requests.values():
        r["spans"] = [name for _, name in sorted(r["spans"],
                                                 key=lambda s: s[0])]
    return {"n_events": len(events),
            "dropped_events": trace.get("dropped_events", 0),
            "requests": requests,
            "phase_us": {k: round(v, 1) for k, v in phase_us.items()},
            "faults": faults}


def read_fleet_trace(path: str) -> Dict:
    """Summary of an exported router trace (the fleet's shared telemetry):
    dispatches per replica and how many resumed a request, the breaker
    (health) transitions, drains, warm restarts, fleet-shape (``scale``)
    changes, router-side sheds, total degrades, and every ``autoscale``
    decision with the windowed metrics that triggered it, with the counts
    by action. The same summary as the JAX package's
    ``tools/trace_analyze.py analyze_fleet_trace``."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    events = trace.get("traceEvents", [])
    per_replica: collections.Counter = collections.Counter()
    resumed = 0
    sheds = 0
    lists: Dict[str, List[Dict]] = {
        "breaker": [], "drain": [], "restart": [], "scale": [],
        "autoscale": [], "degraded": []}
    for e in events:
        if e.get("ph") != "i" or e.get("cat") != "scheduler":
            continue
        name, a = e.get("name"), dict(e.get("args", {}))
        a["ts"] = e.get("ts")
        if name == "dispatch":
            per_replica[a.get("replica")] += 1
            resumed += bool(a.get("resumed"))
        elif name == "shed":
            sheds += 1
        elif name in lists:
            lists[name].append(a)
    decisions = lists["autoscale"]
    return {
        "n_events": len(events),
        "dispatch": {"total": sum(per_replica.values()),
                     "per_replica": {str(k): v for k, v
                                     in sorted(per_replica.items())},
                     "resumed": resumed},
        "breaker": lists["breaker"],
        "drains": lists["drain"],
        "restarts": lists["restart"],
        "scale": lists["scale"],
        "autoscale": {"decisions": decisions,
                      "by_action": dict(collections.Counter(
                          d.get("action") for d in decisions))},
        "sheds": sheds,
        "degraded": lists["degraded"],
    }

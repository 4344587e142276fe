"""SLO autoscaler: the policy loop between the serving telemetry and the
router's fleet.

Port of ``deepspeed_tpu/inference/autoscale.py``. The router has the
actuators (``ReplicaRouter.add_replica`` / ``retire_replica`` and the
``shed_batch`` admission gate) and the replicas' registries the sensors
(TTFT, TPOT and queue-wait histograms, health gauges); this module closes
the loop.

:class:`SLOController` is a host-side policy object the router ticks once
per :meth:`~deepspeed_tpu_torch.inference.router.ReplicaRouter.step`.
Every ``eval_every`` ticks it reads the **windowed** fleet view
(``Histogram.window_summary`` over the recent-observation rings, merged
across every registry of the fleet: "p99 TTFT over the last ``window``
clock units", not lifetime) and the live load (queue depth plus occupied
slots), and decides one of:

- ``scale_up``: windowed p99 TTFT over ``ttft_slo`` (or, with
  ``tpot_slo`` set, p99 TPOT over it, or the queue over ``queue_high``)
  and the fleet below ``max_replicas``: add a replica through the
  router's ``replica_factory``. In a disaggregated fleet (any
  ``prefill`` replica) the pools scale independently: TTFT pressure alone
  adds a ``prefill`` replica (prefills queue), TPOT or queue pressure a
  ``decode`` replica (streams stall); a role-less fleet adds ``mixed``
  replicas.
- ``tighten``: over the SLO but the fleet cannot grow: close the
  ``shed_batch`` gate, so ``priority="batch"`` traffic sheds at the front
  door. ``relax`` opens it again once windowed p99 falls below
  ``relax_ratio * ttft_slo`` (or the window is empty).
- ``retire``: the fleet has been idle (nothing queued, no slot held) for
  ``idle_to_retire`` clock units and is above ``min_replicas``: drain and
  retire the highest-index active replica, never the last decode-capable
  one (the router settles its migrations first).
- ``noop``: everything inside the envelope.

``cooldown`` clock units separate two fleet-shape changes. Every
evaluation lands in the trace as an ``autoscale`` instant carrying the
metrics that triggered it, and bumps the ``autoscale_*`` registry
metrics, so a run rebuilds from its exported trace
(``telemetry.read_fleet_trace``). The controller launches no device work,
and its decisions are a pure function of the router's metric state: a
seeded load replays the same decision list. A router built without
``autoscale=`` is the fixed fleet, bit for bit.
"""

from typing import Dict, List, Optional

from deepspeed_tpu_torch.telemetry.metrics import Histogram
from deepspeed_tpu_torch.utils.logging import logger

# decision kinds, in the order the policy considers them
SCALE_UP, RETIRE, TIGHTEN, RELAX, NOOP = (
    "scale_up", "retire", "tighten", "relax", "noop")

_DECISION_COUNTERS = (
    ("decisions", "controller evaluations (all decision kinds)"),
    ("scale_ups", "scale-up decisions taken"),
    ("retires", "retire decisions taken"),
    ("tightens", "admission-tighten decisions taken"),
    ("relaxes", "admission-relax decisions taken"),
    ("noops", "evaluations that changed nothing"),
)


class SLOController:
    """Windowed-SLO policy for :class:`ReplicaRouter` (module docstring
    has the control law).

    All times are in the router's scheduler clock units — step indices
    in tests, seconds under ``wall_clock=True`` — matching the units
    the TTFT histograms observe in.

    - ``ttft_slo``: the p99 TTFT budget; windowed p99 above it is the
      scale-up / tighten trigger.
    - ``tpot_slo``: optional p99 time-per-output-token budget read off
      the fleet's ``serving_tpot`` histograms; pressure here scales
      the DECODE pool in a disaggregated fleet. None = TTFT/queue
      policy only (the pre-disaggregation bit-reference).
    - ``window``: how far back the windowed percentile looks.
    - ``eval_every``: ticks between evaluations (the hook itself is a
      counter increment on the off-ticks).
    - ``min_replicas`` / ``max_replicas``: fleet-size envelope; only
      non-broken, non-retired replicas count.
    - ``cooldown``: minimum clock distance between fleet-shape changes
      (scale-ups and retires share it).
    - ``idle_to_retire``: consecutive idle clock units before a
      scale-down.
    - ``relax_ratio``: hysteresis — the admission gate re-opens only
      once windowed p99 drops below ``relax_ratio * ttft_slo``.
    - ``min_samples``: windowed observations required before the p99
      is trusted (a 1-sample "p99" is noise).
    - ``queue_high``: optional LEADING indicator — mean queued
      requests per active replica above this also counts as SLO
      pressure. TTFT is a lagging signal (a spike's damage is already
      in the queue before the first late token is observed); queue
      depth lets the controller act while the backlog is still
      building. None = pure windowed-TTFT policy.
    """

    def __init__(self, *, ttft_slo: float, tpot_slo: Optional[float] = None,
                 window: float = 32.0,
                 eval_every: int = 4, min_replicas: int = 1,
                 max_replicas: int = 4, cooldown: float = 16.0,
                 idle_to_retire: float = 32.0, relax_ratio: float = 0.5,
                 min_samples: int = 4, queue_high: Optional[float] = None):
        if ttft_slo <= 0:
            raise ValueError("ttft_slo must be positive")
        if tpot_slo is not None and tpot_slo <= 0:
            raise ValueError("tpot_slo must be positive when set")
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        self.ttft_slo = float(ttft_slo)
        self.tpot_slo = None if tpot_slo is None else float(tpot_slo)
        self.window = float(window)
        self.eval_every = max(1, int(eval_every))
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.cooldown = float(cooldown)
        self.idle_to_retire = float(idle_to_retire)
        self.relax_ratio = float(relax_ratio)
        self.min_samples = max(1, int(min_samples))
        self.queue_high = None if queue_high is None else float(queue_high)
        self.decisions: List[Dict] = []      # host-side decision log
        self._ticks = 0
        self._last_resize: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._stat = None                    # lazily bound to a router

    # -- policy --------------------------------------------------------
    def on_step(self, router, now: float) -> Optional[str]:
        """Router hook: one tick. Returns the decision kind on
        evaluation ticks, None otherwise."""
        self._ticks += 1
        if self._ticks % self.eval_every:
            return None
        return self._evaluate(router, now)

    def _evaluate(self, router, now: float) -> str:
        self._bind(router)
        win = self._window_view(router, now)
        tpot_win = (self._window_view(router, now, metric="serving_tpot")
                    if self.tpot_slo is not None else None)
        active = [rep for rep in router.replicas
                  if rep.health not in ("broken", "retired")]
        qdepth = sum(len(rep.srv.queue) for rep in active)
        load = qdepth + sum(
            sum(1 for s in rep.srv.slots if s is not None)
            for rep in active)
        # idle bookkeeping: a completely quiet fleet starts (or
        # continues) the idle clock; any work resets it
        if load == 0:
            if self._idle_since is None:
                self._idle_since = now
        else:
            self._idle_since = None
        idle_for = 0.0 if self._idle_since is None \
            else max(0.0, now - self._idle_since)

        p99, count = win["p99"], win["count"]
        pressure = (self.queue_high is not None and active
                    and qdepth / len(active) > self.queue_high)
        ttft_over = count >= self.min_samples and p99 > self.ttft_slo
        tpot_over = (tpot_win is not None
                     and tpot_win["count"] >= self.min_samples
                     and tpot_win["p99"] > self.tpot_slo)
        over = ttft_over or tpot_over or pressure
        cooled = (self._last_resize is None
                  or now - self._last_resize >= self.cooldown)
        # disaggregated fleets scale their two pools independently:
        # TTFT pressure means prefills are queueing (add prefill),
        # TPOT or queue pressure means decode streams are stalling
        # (add decode); a role-less fleet keeps adding mixed replicas
        disagg = any(rep.role == "prefill" for rep in router.replicas)
        grow_role = "mixed"
        if disagg:
            grow_role = ("prefill"
                         if ttft_over and not (tpot_over or pressure)
                         else "decode")

        action = NOOP
        if over and len(active) < self.max_replicas and cooled \
                and router.replica_factory is not None:
            idx = router.add_replica(
                now=now, role=grow_role,
                reason=f"p99 ttft {p99:.3g} (slo "
                       f"{self.ttft_slo:.3g}), queue {qdepth}")
            self._last_resize = now
            action = SCALE_UP
            detail = {"replica": idx, "role": grow_role}
        elif over and not router.shed_batch:
            router.shed_batch = True
            action = TIGHTEN
            detail = {}
        elif router.shed_batch \
                and (count < self.min_samples
                     or p99 <= self.relax_ratio * self.ttft_slo) \
                and not tpot_over:
            # the window shows no pressure (below the hysteresis floor)
            # or no evidence at all (spike cleared, ring drained past
            # the window) — re-open the gate
            router.shed_batch = False
            action = RELAX
            detail = {}
        elif (not over and len(active) > self.min_replicas and cooled
              and idle_for >= self.idle_to_retire):
            # role-aware victim: never the last decode-capable replica
            # (the router would refuse; a fleet of only prefill
            # replicas cannot finish a single request)
            decode_capable = [r for r in active if r.role != "prefill"]
            cands = [r for r in active
                     if r.role == "prefill" or len(decode_capable) > 1]
            if cands:
                victim = max(rep.idx for rep in cands)
                router.retire_replica(victim, now=now,
                                      reason="sustained idle")
                self._last_resize = now
                self._idle_since = now   # restart the idle clock
                action = RETIRE
                detail = {"replica": victim}
            else:
                detail = {}
        else:
            detail = {}

        decision = {
            "at": now, "action": action,
            "p99_ttft": p99, "window_count": count,
            "window": self.window, "ttft_slo": self.ttft_slo,
            "load": load, "queue_depth": qdepth,
            "queue_pressure": bool(pressure), "idle_for": idle_for,
            "active_replicas": len(active),
            "shed_batch": router.shed_batch,
        }
        if tpot_win is not None:
            decision["p99_tpot"] = tpot_win["p99"]
            decision["tpot_window_count"] = tpot_win["count"]
            decision["tpot_slo"] = self.tpot_slo
        decision.update(detail)
        self.decisions.append(decision)
        self._stat["decisions"].inc()
        key = {SCALE_UP: "scale_ups", RETIRE: "retires",
               TIGHTEN: "tightens", RELAX: "relaxes", NOOP: "noops"}
        self._stat[key[action]].inc()
        self._g_target.set(len([rep for rep in router.replicas
                                if rep.health not in ("broken",
                                                      "retired")]))
        self._g_tight.set(1 if router.shed_batch else 0)
        # the decision AND its triggering metrics land in the trace —
        # what read_fleet_trace rebuilds the decisions from
        router.telemetry.tracer.event("autoscale", step=router._clock,
                                      **decision)
        if action != NOOP:
            logger.info(f"autoscale: {action} "
                        f"(p99_ttft={p99:.4g} slo={self.ttft_slo:.4g} "
                        f"load={load} active={decision['active_replicas']})")
        return action

    # -- plumbing ------------------------------------------------------
    def _bind(self, router) -> None:
        """Lazily register the ``autoscale_*`` metrics on the router's
        registry (the controller cannot do it at construction: it does
        not know its router yet)."""
        if self._stat is not None:
            return
        self._stat = {}
        for key, help_ in _DECISION_COUNTERS:
            self._stat[key] = router.metrics.counter(
                f"autoscale_{key}", help_)
        self._g_target = router.metrics.gauge(
            "autoscale_target_replicas",
            "active (non-broken, non-retired) replicas after the last "
            "controller decision")
        self._g_tight = router.metrics.gauge(
            "autoscale_admission_tight",
            "1 while the shed_batch admission gate is closed")

    def _window_view(self, router, now: float,
                     metric: str = "serving_ttft") -> Dict[str, float]:
        """Fleet-windowed latency digest for ``metric`` (TTFT by
        default, TPOT for the decode-pool signal): interleave the
        recent-observation rings of every matching histogram in the
        fleet into one scratch histogram and summarize the window
        ending at ``now``. Count 0 when telemetry is off fleet-wide."""
        scratch = Histogram(f"fleet_{metric}_window")
        pairs = []
        for reg in router.fleet_registries():
            h = reg._histograms.get(metric)
            if h is not None:
                pairs.extend(h._ring)
        pairs.sort(key=lambda p: p[0])
        scratch._ring.extend(pairs[-scratch._ring.maxlen:])
        return scratch.window_summary(window=self.window, now=now)

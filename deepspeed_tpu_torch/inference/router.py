"""Replica-fleet serving router: health-gated dispatch over N
:class:`~deepspeed_tpu_torch.inference.serving.ServingEngine` replicas.

Port of ``deepspeed_tpu/inference/router.py``. One serving engine is one
failure domain: a watchdog trip or a wedged device degrades all of its
traffic. The router is the scale-out tier above it (the Orca and vLLM
deployment shape): N replicas, each with its own paged KV pool and slots,
behind one ``submit``/``step``/``run`` front door, stepped round-robin in
one host loop. Replicas that share one ``InferenceEngine`` share its
weights; the router launches no device work of its own.

**Dispatch** is least-loaded (queue depth plus occupied slots). A request
without a deadline first tries adapter affinity (the replica that last
served its ``adapter_id``, where the adapter is pool-resident), then
prefix affinity (the replica that served the same first
``affinity_tokens`` tokens, where the prefix blocks are warm); either is
taken only while that replica is at most ``affinity_max_imbalance``
requests busier than the least-loaded one. A request with a deadline
skips affinity: its enemy is queue wait, not a cold prefill.

**Health** is a per-replica state machine with a consecutive-failure
circuit breaker::

    healthy --failure--> suspect --(breaker_threshold)--> broken
       ^                   |                                 |
       |<----success-------+                          warm restart
       |                                                     v
       +<--- probe completes --- recovering <----------------+

A transient failure (an injected ``device_error`` at ``router.step``,
retry exhaustion) makes a replica ``suspect``; ``breaker_threshold`` in a
row make it ``broken``, as a ``crash`` or a replica's own
:class:`DegradedError` does at once. :meth:`ReplicaRouter.restart_replica`
rebuilds a broken replica through ``replica_factory`` from the newest
valid checkpoint tag under ``ckpt_dir`` (``runtime/checkpointing.py``:
the ``latest`` pointer if it validates, else newest first over
``list_tags``); it rejoins ``recovering``, admitting at most
``probe_admissions`` requests until one of them completes cleanly.

**Drain**: a broken replica's finished results are merged, its
``pending_snapshot(release=True)`` frees its pool, entries already
terminal fleet-wide are dropped and the rest are resubmitted on
survivors, where they re-prefill prompt plus emitted tokens: greedy
streams are the undisturbed ones, and sampled ones too (a draw is keyed
by the seed and the tokens emitted). With no dispatchable replica left
the router raises one fleet :class:`DegradedError` carrying the merged
results and every orphaned request.

**Elasticity**: :meth:`ReplicaRouter.add_replica` and
:meth:`ReplicaRouter.retire_replica` (a retire drains through the same
snapshot path and parks the replica ``retired``, never stepped again),
and the ``shed_batch`` gate in :meth:`ReplicaRouter.submit`: the
actuators of the optional ``autoscale`` controller
(``inference/autoscale.py``), ticked once per step. ``autoscale=None``
is the fixed fleet, bit for bit.

**Disaggregation**: each replica has a role, ``prefill``, ``decode`` or
``mixed`` (the default; ``roles=None`` is the role-less fleet, bit for
bit). A prefill replica runs chunked prefill only, emits the first token
and parks the request in a ``handoff`` slot; the router then migrates
its KV chain through a CRC-checked host staging pool
(``PagedKVCache.migrate_gather`` on the source, ``land_parked`` into
free-list blocks only on the destination; int8 pools carry their
scales) and resubmits the request, which the decode replica's admission
adopts without re-prefilling. Any failure (an injected fault, a CRC
mismatch, a refused budget or landing, a crash of either end) frees both
sides and re-dispatches the request for a cold re-prefill on a decode
replica: the same tokens either way. ``migrations`` and
``migration_fallbacks`` count the two outcomes.

**Faults** (``utils/faults.py``): ``router.dispatch`` (after the choice,
before the submit), ``router.step`` (before each replica's step),
``router.drain`` (before any drain state moves),
``router.migrate_gather``, ``router.migrate_scatter`` and
``router.migrate_corrupt`` (a stored byte flipped, so the landing's CRC32
check catches it): each fires before the state it guards moves.

**Telemetry**: the ``router_*`` stats, per-replica health gauges
(``router_replica_health_r<i>``: 0 healthy, 1 suspect, 2 broken, 3
recovering, 4 retired), replicas by state and by role, the
``router_dispatch_queue_wait`` histogram, and ``dispatch``, ``drain``,
``breaker``, ``restart``, ``scale``, ``migrate``, ``shed`` and
``degraded`` tracer events (``telemetry.read_fleet_trace`` reads them
back). :meth:`ReplicaRouter.fleet_snapshot` and
:meth:`ReplicaRouter.to_prometheus` merge every registry of the fleet. A
fleet flight recorder writes an artifact on a break and on a total
degrade.
"""

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

import numpy as np

from deepspeed_tpu_torch.inference.host_tier import (HostBlockPool,
                                                     HostCorruption)
from deepspeed_tpu_torch.inference.paged_cache import CacheExhausted
from deepspeed_tpu_torch.inference.serving import (DegradedError,
                                                   ServeRequest,
                                                   ServingEngine, _StatsView,
                                                   snapshot_entry)
from deepspeed_tpu_torch.runtime.checkpointing import (get_latest_tag,
                                                       list_tags,
                                                       validate_tag)
from deepspeed_tpu_torch.telemetry import (NOOP, MetricsRegistry,
                                           NoopTelemetry, Telemetry,
                                           merge_registries,
                                           resolve_telemetry)
from deepspeed_tpu_torch.telemetry.flight import FlightRecorder, NOOP_FLIGHT
from deepspeed_tpu_torch.utils import faults as faults_lib
from deepspeed_tpu_torch.utils.env import flag_names, resolve_flag
from deepspeed_tpu_torch.utils.faults import (InjectedCrash,
                                              TransientDeviceError)
from deepspeed_tpu_torch.utils.logging import logger

# health states, in escalation order; gauge codes are the indices.
# RETIRED is terminal and reachable only through retire_replica (scale-
# down) — unlike BROKEN it is deliberate, drained, and never restarted.
HEALTHY, SUSPECT, BROKEN, RECOVERING, RETIRED = (
    "healthy", "suspect", "broken", "recovering", "retired")
HEALTH_CODES = {HEALTHY: 0, SUSPECT: 1, BROKEN: 2, RECOVERING: 3,
                RETIRED: 4}

# replica roles (disaggregated prefill/decode fleets): a "prefill"
# replica runs chunked prefill only and hands finished prefixes off; a
# "decode" replica lands migrations and decodes; "mixed" (the default)
# does both — an all-mixed fleet is bit-identical to the role-less one.
ROLES = ("prefill", "decode", "mixed")

_ROUTER_STAT_FIELDS = (
    ("steps", "c", "router scheduler iterations"),
    ("dispatched", "c", "requests dispatched to a replica"),
    ("affinity_hits", "c", "dispatches routed by prefix affinity"),
    ("adapter_affinity_hits", "c", "dispatches routed by adapter affinity "
                                   "(the target already holds the "
                                   "request's LoRA adapter pool-resident)"),
    ("redispatches", "c", "dispatch retries after a dispatch-site fault"),
    ("drained_requests", "c",
     "in-flight requests drained from a broken replica onto survivors"),
    ("breaker_trips", "c", "circuit-breaker openings (replica -> broken)"),
    ("restarts", "c", "replica warm restarts"),
    ("fleet_degraded", "c",
     "total-degrade events (no dispatchable replica left)"),
    ("scale_ups", "c", "replicas added to the fleet (add_replica)"),
    ("retires", "c", "replicas retired from the fleet (retire_replica)"),
    ("shed", "c",
     "requests shed router-side by the tightened-admission gate"),
    ("migrations", "c",
     "KV migrations landed prefill->decode (disaggregated handoff)"),
    ("migration_fallbacks", "c",
     "migrations degraded to a cold re-prefill on the decode side"),
)


class _Replica:
    """Router-side record for one replica: the engine, its health
    state, the consecutive-failure count the breaker watches, and the
    probe rids whose clean completion closes a half-open breaker."""

    def __init__(self, idx: int, srv: ServingEngine,
                 role: str = "mixed"):
        self.idx = idx
        self.srv = srv
        self.role = role
        self.health = HEALTHY
        self.failures = 0            # consecutive, reset on success
        self.probe_rids: Set[Any] = set()
        self.restarts = 0


class ReplicaRouter:
    """Least-loaded / deadline-aware / prefix-affine dispatcher over N
    serving replicas with circuit-breaker health tracking and drain-on-
    failure (module docstring has the full contract).

    - ``replicas``: the ServingEngine fleet (sharing one
      ``InferenceEngine`` shares its weights).
    - ``roles``: optional per-replica role list (``prefill`` /
      ``decode`` / ``mixed``); None = all ``mixed``, bit-identical to
      the role-less fleet (module docstring, **Disaggregation**).
    - ``replica_factory``: ``(replica_id, checkpoint_tag) ->
      ServingEngine`` used by :meth:`restart_replica`; ``ckpt_dir``
      points the warm restart at a crash-safe checkpoint directory
      (tag resolved by newest-valid walk-back, None when absent).
    - ``breaker_threshold``: consecutive transient failures before the
      breaker trips the replica to ``broken``.
    - ``probe_admissions``: max in-flight requests a ``recovering``
      replica may hold (half-open admission window).
    - ``affinity_tokens`` / ``affinity_max_imbalance``: prefix-affinity
      key width and the extra backlog an affine replica may carry
      before least-loaded wins.
    - ``faults`` / ``telemetry``: as on ``ServingEngine`` (pass one
      shared :class:`~deepspeed_tpu_torch.telemetry.Telemetry` to aggregate
      fleet metrics into one registry).
    - ``autoscale``: optional SLO controller with an
      ``on_step(router, now)`` hook, ticked once per :meth:`step`
      (see :mod:`deepspeed_tpu_torch.inference.autoscale`). Default None:
      the fixed-fleet bit-reference.
    """

    def __init__(self, replicas: Sequence[ServingEngine], *,
                 roles: Optional[Sequence[str]] = None,
                 replica_factory: Optional[Callable] = None,
                 ckpt_dir: Optional[str] = None,
                 breaker_threshold: int = 3,
                 probe_admissions: int = 2,
                 affinity_tokens: int = 16,
                 affinity_max_imbalance: int = 4,
                 faults: Optional[faults_lib.FaultInjector] = None,
                 telemetry=None,
                 autoscale=None,
                 flight_recorder: Optional[bool] = None,
                 flight_dir: Optional[str] = None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        if any(getattr(r.engine, "mp_size", 1) > 1 for r in replicas):
            from deepspeed_tpu_torch.parallel.tensor import \
                TP_SERVING_FEATURES
            raise NotImplementedError(
                f"a router over replicas with mp_size > 1 waits for "
                f"{TP_SERVING_FEATURES}")
        role_list = (["mixed"] * len(replicas) if roles is None
                     else [str(r) for r in roles])
        if len(role_list) != len(replicas):
            raise ValueError("roles must name one role per replica")
        for r in role_list:
            if r not in ROLES:
                raise ValueError(f"unknown replica role {r!r} "
                                 f"(expected one of {ROLES})")
        if "prefill" in role_list and not any(
                r != "prefill" for r in role_list):
            raise ValueError(
                "a disaggregated fleet needs at least one decode-"
                "capable (decode/mixed) replica")
        self.replicas = [_Replica(i, srv, role=role_list[i])
                         for i, srv in enumerate(replicas)]
        for rep in self.replicas:
            # the router is the single source of truth for roles: a
            # prefill replica parks finished prefills for migration
            # instead of decoding them (serving.py handoff contract)
            rep.srv.prefill_only = (rep.role == "prefill")
        self.replica_factory = replica_factory
        self.ckpt_dir = ckpt_dir
        self.breaker_threshold = max(1, int(breaker_threshold))
        self.probe_admissions = max(1, int(probe_admissions))
        self.affinity_tokens = int(affinity_tokens)
        self.affinity_max_imbalance = int(affinity_max_imbalance)
        self.faults = faults if faults is not None else faults_lib.active()
        if isinstance(telemetry, (Telemetry, NoopTelemetry)):
            self.telemetry = telemetry
        elif resolve_telemetry(telemetry):
            self.telemetry = Telemetry()
        else:
            self.telemetry = NOOP
        self.metrics = (self.telemetry.registry if self.telemetry.enabled
                        else MetricsRegistry())
        self._stat = {}
        for key, kind, help_ in _ROUTER_STAT_FIELDS:
            make = (self.metrics.counter if kind == "c"
                    else self.metrics.gauge)
            self._stat[key] = make(f"router_{key}", help_)
        self.stats = _StatsView(self._stat)
        # per-replica health gauges: the registry has no label support,
        # so each replica gets its own name (indices only grow —
        # add_replica appends, retire parks the gauge at 4 — so the
        # scrape series stay stable)
        self._g_health = [self._mk_health_gauge(i)
                          for i in range(len(self.replicas))]
        # fleet-shape gauges: replicas currently in each health state,
        # the controller's (and any scraper's) one-look fleet view
        self._g_state = {
            state: self.metrics.gauge(
                f"router_replicas_{state}",
                f"replicas currently {state}")
            for state in HEALTH_CODES}
        # pool-shape gauges (disaggregated fleets): non-retired
        # replicas per role, the SLO controller's per-pool capacity view
        self._g_role = {
            role: self.metrics.gauge(
                f"router_replicas_role_{role}",
                f"non-retired replicas with the {role} role")
            for role in ROLES}
        self._update_state_gauges()
        self._h_qwait = (self.metrics.histogram(
            "router_dispatch_queue_wait",
            "submit-to-(re)dispatch wait (scheduler clock units; >0 "
            "only for drained/redispatched requests)")
            if self.telemetry.enabled else None)
        # fleet-merged terminal state captured off broken replicas
        # before their engines are discarded; live replicas keep their
        # own `finished` until results() merges everything
        self._results: Dict[Any, np.ndarray] = {}
        self._finished: List[ServeRequest] = []
        self._orphans: List[ServeRequest] = []   # undispatchable drain work
        self._affinity: Dict[bytes, int] = {}
        # adapter affinity: the last replica that served
        # each adapter_id — steering a tenant back there turns its next
        # admission into a pool hit instead of a reload, under the SAME
        # imbalance cap the prefix affinity honors
        self._adapter_affinity: Dict[str, int] = {}
        self._rr = 0                             # round-robin step cursor
        self._clock = 0
        # SLO controller hook: ticked once per step() when set; the
        # shed_batch gate is its admission actuator (submit() sheds
        # priority="batch" requests while tightened). Default None =
        # the fixed-fleet bit-reference.
        self.autoscale = autoscale
        self.shed_batch = False
        # fleet flight recorder (telemetry/flight.py): breaker breaks
        # and total degrades write a postmortem artifact bundling the
        # fleet view — per-replica engines keep their own recorders
        if resolve_flag("DS_FLIGHT_RECORDER", flight_recorder):
            self.flight = FlightRecorder(
                outdir=flight_dir or (resolve_flag("DS_FLIGHT_DIR")
                                      or None),
                sections=self._flight_sections(), label="router",
                device=self.replicas[0].srv.engine.device)
        else:
            self.flight = NOOP_FLIGHT
        # replica-to-replica migration channel: one CRC-checked host
        # staging pool for the whole fleet, the host tier's storage
        # carrying KV between pools. Only disaggregated fleets use it;
        # each replica makes its migration staging up front, so a
        # steady-state migration allocates no device memory.
        self._mig_pool = HostBlockPool()
        if any(rep.role == "prefill" for rep in self.replicas):
            for rep in self.replicas:
                rep.srv.cache.warm_migration()

    def _flight_sections(self) -> Dict:
        """Fleet postmortem section providers (called only at dump
        time): merged fleet metrics + health, the router's own tracer
        ring, autoscaler decisions, fired faults, resolved flags, and
        every replica's cost-accounting state."""
        return {
            "tracer": lambda: [list(r)
                               for r in self.telemetry.tracer.records()],
            "metrics": lambda: self.fleet_snapshot(),
            "stats": lambda: dict(self.stats),
            "autoscale": lambda: (list(self.autoscale.decisions)
                                  if self.autoscale is not None else []),
            "faults": lambda: [list(f) for f in self.faults.fired],
            "flags": lambda: {n: resolve_flag(n) for n in flag_names()},
            "costs": lambda: {
                f"r{rep.idx}": rep.srv.costs.snapshot()
                for rep in self.replicas},
            "requests": lambda: [
                dict(row, replica=rep.idx)
                for rep in self.replicas
                for row in rep.srv._flight_requests()],
        }

    def _mk_health_gauge(self, i: int):
        return self.metrics.gauge(
            f"router_replica_health_r{i}",
            "replica health (0 healthy / 1 suspect / 2 broken / "
            "3 recovering / 4 retired)")

    def _update_state_gauges(self) -> None:
        for state, g in self._g_state.items():
            g.set(sum(1 for rep in self.replicas if rep.health == state))
        for role, g in self._g_role.items():
            g.set(sum(1 for rep in self.replicas
                      if rep.role == role and rep.health != RETIRED))

    # -- API -----------------------------------------------------------
    def submit(self, req: ServeRequest, now: float = 0.0) -> bool:
        """Dispatch ``req`` to the best dispatchable replica. Returns
        the target's ``submit`` result (False = shed by its bounded
        queue, or here by the tightened-admission gate). Raises a
        fleet-level :class:`DegradedError` when no replica can take
        traffic."""
        if self.shed_batch and req.priority == "batch":
            # admission tightened by the SLO controller: batch-class
            # traffic sheds at the front door (same terminal shape as
            # an engine-side queue-bound shed) so interactive traffic
            # keeps the fleet's headroom
            req.state = "shed"
            req.finished_at = now
            self._results.setdefault(req.rid, req.tokens)
            self._finished.append(req)
            self._stat["shed"].inc()
            self.telemetry.tracer.event(
                "shed", rid=req.rid, step=self._clock,
                reason="admission tightened", priority=req.priority)
            return False
        ok = self._dispatch(req, now)
        if self._orphans:
            raise self._fleet_degraded(
                f"no dispatchable replica for request {req.rid!r}")
        return bool(ok)

    @property
    def busy(self) -> bool:
        return any(rep.health not in (BROKEN, RETIRED) and rep.srv.busy
                   for rep in self.replicas)

    def step(self, now: Optional[float] = None) -> int:
        """One fleet iteration: step every non-broken busy replica once,
        in round-robin rotation, firing the ``router.step`` chaos site
        per replica. Failures feed the breaker; a broken replica's
        in-flight work drains onto survivors before the step returns.
        Returns the fleet-wide decode occupancy."""
        if now is None:
            now = float(self._clock)
        occ = 0
        n = len(self.replicas)
        for k in range(n):
            rep = self.replicas[(self._rr + k) % n]
            if rep.health in (BROKEN, RETIRED) or not rep.srv.busy:
                continue
            try:
                self.faults.fire("router.step")
                occ += rep.srv.step(now)
            except TransientDeviceError as e:
                self._note_failure(rep, now, str(e))
            except DegradedError as e:
                # the replica's own watchdog/non-drain contract fired:
                # its scheduler state is still consistent, so the
                # standard drain path recovers everything it held
                self._break(rep, now, f"degraded: {e}")
                self._drain(rep, now)
            except InjectedCrash as e:
                self._break(rep, now, f"crash: {e}")
                self._drain(rep, now)
            else:
                self._note_success(rep, now)
        # disaggregated handoff harvest: a prefill-role replica whose
        # chunked prefill just finished parks the request in a handoff
        # slot — migrate each one to a decode-capable replica now, or
        # degrade it to a cold re-prefill (never leave it wedged)
        for rep in list(self.replicas):
            if rep.health in (BROKEN, RETIRED) or not rep.srv.prefill_only:
                continue
            for slot, hreq in list(rep.srv.ready_handoffs()):
                if rep.health in (BROKEN, RETIRED):
                    break     # a crash mid-harvest already drained it
                self._migrate(rep, slot, hreq, now)
        self._rr = (self._rr + 1) % n
        self._clock += 1
        self._stat["steps"].inc()
        if self._orphans:
            # a drain this step could not place everything: ONE
            # fleet-level raise carrying every orphaned request
            raise self._fleet_degraded(
                "no dispatchable replica left for drained work")
        if self.autoscale is not None:
            # controller tick AFTER the fleet stepped (so the windowed
            # metrics include this iteration's tokens) and AFTER the
            # orphan check (a degraded fleet raises, it doesn't scale)
            self.autoscale.on_step(self, now)
        return occ

    def run(self, requests=None, max_steps: int = 1_000_000,
            wall_clock: bool = False) -> Dict[Any, np.ndarray]:
        """Submit ``requests`` and step the fleet until idle. Returns
        fleet-merged {rid: prompt+generated}. Raises the fleet-level
        :class:`DegradedError` (with merged results + pending) on total
        degrade or non-drain."""
        for r in (requests or []):
            self.submit(r, now=time.perf_counter() if wall_clock else 0.0)
        steps = 0
        while self.busy:
            self.step(time.perf_counter() if wall_clock else None)
            steps += 1
            if steps > max_steps:
                raise self._fleet_degraded(
                    f"fleet did not drain in {max_steps} steps")
        return self.results()

    def results(self) -> Dict[Any, np.ndarray]:
        """Fleet-merged {rid: prompt+generated}: terminal work captured
        off broken replicas, overlaid with every live replica's
        finished list (a drained rid's survivor-side completion wins)."""
        merged = dict(self._results)
        for rep in self.replicas:
            for r in rep.srv.finished:
                merged[r.rid] = r.tokens
        return merged

    def health(self) -> List[str]:
        """Per-replica health states, by replica index."""
        return [rep.health for rep in self.replicas]

    def restart_replica(self, idx: int, now: float = 0.0) -> Optional[str]:
        """Warm-restart a broken replica through ``replica_factory``,
        loading from the newest VALID checkpoint tag under ``ckpt_dir``
        (walk-back semantics; None when no valid tag exists). The
        rebuilt replica rejoins as ``recovering`` — half-open until a
        probe request completes cleanly. Returns the tag used."""
        rep = self.replicas[idx]
        if rep.health != BROKEN:
            raise ValueError(
                f"replica {idx} is {rep.health}, not broken")
        if self.replica_factory is None:
            raise RuntimeError(
                "restart_replica needs a replica_factory")
        tag = self._restart_tag()
        rep.srv = self.replica_factory(idx, tag)
        rep.failures = 0
        rep.probe_rids = set()
        rep.restarts += 1
        self._set_health(rep, RECOVERING, now, reason="warm restart")
        self._stat["restarts"].inc()
        self.telemetry.tracer.event("restart", step=self._clock,
                                    replica=idx, tag=tag)
        logger.info(f"router: replica {idx} warm-restarted from "
                    f"checkpoint tag {tag!r}; recovering")
        return tag

    # -- elasticity ----------------------------------------------------
    def add_replica(self, srv: Optional[ServingEngine] = None,
                    now: float = 0.0, reason: str = "",
                    role: str = "mixed") -> int:
        """Grow the fleet by one replica and return its index. With no
        explicit engine the replica comes from ``replica_factory``,
        warm-started from the newest valid checkpoint tag (the same
        walk-back :meth:`restart_replica` uses). The newcomer joins
        ``healthy`` and is immediately dispatchable; sharing the
        fleet's ``InferenceEngine`` shares its weights. ``role``
        places the newcomer in a disaggregated pool (default
        ``mixed`` — the role-less shape)."""
        if role not in ROLES:
            raise ValueError(f"unknown replica role {role!r} "
                             f"(expected one of {ROLES})")
        idx = len(self.replicas)
        if srv is None:
            if self.replica_factory is None:
                raise RuntimeError(
                    "add_replica needs an engine or a replica_factory")
            srv = self.replica_factory(idx, self._restart_tag())
        self.replicas.append(_Replica(idx, srv, role=role))
        srv.prefill_only = (role == "prefill")
        if any(rep.role == "prefill" for rep in self.replicas):
            # the newcomer may source or land migrations: make its
            # staging outside the steady state
            srv.cache.warm_migration()
        self._g_health.append(self._mk_health_gauge(idx))
        self._g_health[idx].set(HEALTH_CODES[HEALTHY])
        self._update_state_gauges()
        self._stat["scale_ups"].inc()
        self.telemetry.tracer.event(
            "scale", step=self._clock, action="add", replica=idx,
            reason=reason, role=role)
        logger.info(f"router: replica {idx} added as {role} "
                    f"({reason or 'manual'})")
        return idx

    def retire_replica(self, idx: int, now: float = 0.0,
                       reason: str = "") -> int:
        """Scale-down: permanently remove replica ``idx`` from
        rotation. Its in-flight work drains onto survivors through the
        SAME snapshot/release path a breaker drain uses (so retiring a
        busy replica is token-lossless), then the replica parks
        ``retired`` — never stepped, never dispatched to, never
        restarted. Refuses to retire the last replica able to take
        traffic. Returns the number of requests drained across."""
        rep = self.replicas[idx]
        if rep.health == RETIRED:
            raise ValueError(f"replica {idx} is already retired")
        survivors = [r for r in self.replicas
                     if r.idx != idx and r.health not in (BROKEN, RETIRED)]
        if not survivors:
            raise ValueError(
                "cannot retire the last dispatchable replica")
        if rep.role != "prefill" and all(s.role == "prefill"
                                         for s in survivors):
            raise ValueError(
                "cannot retire the last decode-capable replica")
        # settle in-flight migrations FIRST (the abort_transfers
        # discipline): finished prefills parked in handoff slots
        # migrate out while the replica can still gather; anything that
        # cannot land degrades to a cold re-prefill on a survivor
        for slot, hreq in list(rep.srv.ready_handoffs()):
            if rep.health in (BROKEN, RETIRED):
                break         # a crash mid-settle already drained it
            self._migrate(rep, slot, hreq, now)
        self._set_health(rep, RETIRED, now, reason=reason or "scale-down")
        placed = self._drain(rep, now)
        self._stat["retires"].inc()
        self.telemetry.tracer.event(
            "scale", step=self._clock, action="retire", replica=idx,
            reason=reason, resumed=placed)
        logger.info(f"router: replica {idx} retired "
                    f"({reason or 'manual'}; {placed} drained)")
        if self._orphans:
            raise self._fleet_degraded(
                f"no dispatchable replica for work drained off "
                f"retired replica {idx}")
        return placed

    # -- fleet observability -------------------------------------------
    def fleet_registries(self) -> List[MetricsRegistry]:
        """Every distinct metrics registry in the fleet (router +
        replicas), deduped by identity — replicas sharing one
        ``Telemetry`` contribute their registry once."""
        regs: List[MetricsRegistry] = []
        seen: Set[int] = set()
        for reg in [self.metrics] + [rep.srv.metrics
                                     for rep in self.replicas]:
            if id(reg) not in seen:
                seen.add(id(reg))
                regs.append(reg)
        return regs

    def fleet_snapshot(self) -> Dict[str, Dict]:
        """Fleet-merged registry snapshot (counters/gauges summed,
        histograms bucket-merged across replicas) plus the fleet shape:
        per-replica health and replicas-by-state counts."""
        snap = merge_registries(self.fleet_registries()).snapshot()
        health = self.health()
        snap["fleet"] = {
            "replicas": len(health),
            "health": health,
            "by_state": {state: health.count(state)
                         for state in HEALTH_CODES},
        }
        return snap

    def to_prometheus(self) -> str:
        """Merged Prometheus text exposition across every registry in
        the fleet — one scrape body for the whole deployment."""
        return merge_registries(self.fleet_registries()).to_prometheus()

    # -- dispatch ------------------------------------------------------
    def _affinity_key(self, prompt) -> Optional[bytes]:
        if len(prompt) == 0:
            return None
        lead = np.asarray(prompt[:self.affinity_tokens], np.int32)
        return lead.tobytes()

    def _load(self, rep: _Replica) -> int:
        srv = rep.srv
        return len(srv.queue) + sum(1 for s in srv.slots if s is not None)

    def _dispatchable(self, rep: _Replica) -> bool:
        if rep.health in (BROKEN, RETIRED):
            return False
        if rep.health == RECOVERING:
            # half-open: a recovering replica holds at most
            # probe_admissions in-flight requests until a probe
            # completion closes the breaker
            return self._load(rep) < self.probe_admissions
        return True

    def _choose(self, req: ServeRequest,
                excluded: Set[int]) -> Optional[_Replica]:
        cands = [rep for rep in self.replicas
                 if rep.idx not in excluded and self._dispatchable(rep)]
        # role fence (disaggregated fleets): resumed/migrated work needs
        # a decode-capable target — a prefill-only replica would just
        # hand it off again. Fresh work prefers the prefill pool but may
        # still land on decode replicas when it is the only pool left
        # (they are full engines; role is policy, not capability).
        if bool(len(req.out)):
            cands = [rep for rep in cands if rep.role != "prefill"]
        else:
            pref = [rep for rep in cands if rep.role != "decode"]
            if pref:
                cands = pref
        if not cands:
            return None
        best = min(cands, key=lambda rep: (self._load(rep), rep.idx))
        if req.deadline is None:
            # adapter affinity outranks prefix affinity: a pool reload
            # (H2D copy at admission) costs more than re-prefilling a
            # shared prefix, and a deadline still outranks both
            aid = req.adapter_id
            idx = (self._adapter_affinity.get(aid)
                   if aid is not None else None)
            if idx is not None and idx != best.idx:
                aff = next((rep for rep in cands if rep.idx == idx), None)
                if aff is not None and (self._load(aff) <= self._load(best)
                                        + self.affinity_max_imbalance):
                    self._stat["adapter_affinity_hits"].inc()
                    return aff
            key = self._affinity_key(req.prompt)
            idx = self._affinity.get(key) if key is not None else None
            if idx is not None and idx != best.idx:
                aff = next((rep for rep in cands if rep.idx == idx), None)
                if aff is not None and (self._load(aff) <= self._load(best)
                                        + self.affinity_max_imbalance):
                    self._stat["affinity_hits"].inc()
                    return aff
        return best

    def _dispatch(self, req: ServeRequest, now: float,
                  excluded: Optional[Set[int]] = None) -> Optional[bool]:
        """Pick a target and submit. The ``router.dispatch`` site fires
        AFTER the choice and BEFORE the submit, so nothing has mutated
        when a fault retries the dispatch against the next-best
        replica; a ``crash`` there kills the chosen replica (which then
        drains). With no dispatchable replica left, the request joins
        ``_orphans`` and None is returned — the CALLER raises the one
        fleet-level DegradedError once it has orphaned everything it
        holds, so the error's pending is complete."""
        excluded = set(excluded or ())
        while True:
            rep = self._choose(req, excluded)
            if rep is None:
                self._orphans.append(req)
                return None
            try:
                self.faults.fire("router.dispatch")
            except TransientDeviceError as e:
                self._stat["redispatches"].inc()
                self._note_failure(rep, now, str(e))
                excluded.add(rep.idx)
                continue
            except InjectedCrash as e:
                self._break(rep, now, f"crash: {e}")
                excluded.add(rep.idx)
                self._drain(rep, now)
                continue
            if self._h_qwait is not None and req.submitted_at is not None:
                self._h_qwait.observe(max(0.0, now - req.submitted_at),
                                      at=now)
            ok = rep.srv.submit(req, now=now)
            key = self._affinity_key(req.prompt)
            if ok and key is not None:
                self._affinity[key] = rep.idx
            if ok and req.adapter_id is not None:
                self._adapter_affinity[req.adapter_id] = rep.idx
            if ok and rep.health == RECOVERING:
                rep.probe_rids.add(req.rid)
            self._stat["dispatched"].inc()
            self.telemetry.tracer.event(
                "dispatch", rid=req.rid, step=self._clock,
                replica=rep.idx, load=self._load(rep),
                resumed=bool(req.out))
            return ok

    # -- health --------------------------------------------------------
    def _set_health(self, rep: _Replica, state: str, now: float,
                    reason: str = "") -> None:
        if rep.health == state:
            return
        prev, rep.health = rep.health, state
        self._g_health[rep.idx].set(HEALTH_CODES[state])
        self._update_state_gauges()
        self.telemetry.tracer.event(
            "breaker", step=self._clock, replica=rep.idx,
            state=state, prev=prev, reason=reason)

    def _break(self, rep: _Replica, now: float, reason: str) -> None:
        if rep.health == BROKEN:
            return
        logger.warning(f"router: replica {rep.idx} broken ({reason})")
        self._set_health(rep, BROKEN, now, reason=reason)
        self._stat["breaker_trips"].inc()
        rep.failures = 0
        self.flight.dump(f"breaker: replica {rep.idx} broken ({reason})")

    def _note_failure(self, rep: _Replica, now: float, reason: str) -> None:
        """Feed the breaker: suspect on the first failure, broken (and
        drained) at the threshold; any failure while recovering
        re-opens the breaker immediately."""
        rep.failures += 1
        if rep.health == RECOVERING:
            self._break(rep, now, f"probe failed: {reason}")
            self._drain(rep, now)
        elif rep.failures >= self.breaker_threshold:
            self._break(rep, now,
                        f"{rep.failures} consecutive failures: {reason}")
            self._drain(rep, now)
        elif rep.health == HEALTHY:
            logger.warning(
                f"router: replica {rep.idx} suspect ({reason})")
            self._set_health(rep, SUSPECT, now, reason=reason)

    def _note_success(self, rep: _Replica, now: float) -> None:
        rep.failures = 0
        if rep.health == SUSPECT:
            self._set_health(rep, HEALTHY, now, reason="clean step")
        elif rep.health == RECOVERING and rep.probe_rids:
            # a probe that ran to state=done proves the rebuilt replica
            # end-to-end (admission, prefill, decode, retire) — close
            # the breaker
            done = {r.rid for r in rep.srv.finished if r.state == "done"}
            if rep.probe_rids & done:
                rep.probe_rids = set()
                self._set_health(rep, HEALTHY, now,
                                 reason="probe completed")
                logger.info(f"router: replica {rep.idx} recovered")

    # -- migration (disaggregated prefill/decode) ----------------------
    def _decode_target(self, src: _Replica) -> Optional[_Replica]:
        """Least-loaded decode-capable replica other than ``src`` — the
        landing side of a KV migration."""
        cands = [rep for rep in self.replicas
                 if rep.idx != src.idx and rep.role != "prefill"
                 and self._dispatchable(rep)]
        if not cands:
            return None
        return min(cands, key=lambda rep: (self._load(rep), rep.idx))

    def _resume_in_place(self, req: ServeRequest, entry: Dict) -> None:
        """Rebuild ``req`` from its snapshot entry IN the same object:
        the caller that submitted the request keeps its reference, so
        ``state``/``finished_at``/``tokens`` stay observable through
        the migration (load_gen's drive records per-request SLOs off
        the objects it submitted). Unlike a cross-drain resume, the
        fleet shares one scheduler clock, so the original latency
        stamps remain comparable — they are restored by
        ``_restamp`` after the destination's submit re-stamps them."""
        fresh = ServeRequest.from_snapshot(entry)
        req.__dict__.update(fresh.__dict__)

    @staticmethod
    def _restamp(req: ServeRequest, stamps: tuple) -> None:
        """Put back the pre-migration latency stamps: ``submitted_at``
        (submit re-stamped it), ``first_token_at`` (the first token
        REALLY left the prefill replica before the handoff — TTFT must
        not be re-measured, nor the TTFT histogram double-observed)
        and the already-emitted tokens' ``token_times``."""
        req.submitted_at, req.first_token_at = stamps[0], stamps[1]
        req.token_times = list(stamps[2]) + list(req.token_times)

    def _migrate(self, src: _Replica, slot: int, req: ServeRequest,
                 now: float) -> bool:
        """Move one finished prefill's KV chain from ``src`` (handoff
        slot ``slot``) to a decode-capable replica through the
        CRC-verified host-DRAM channel — per-array CRC32 on the way in,
        free-list-only landing on the way out — then resume the request
        there WITHOUT re-prefilling (admission adopts the parked chain).

        Degradation ladder: ANY failure — a fault
        at a ``router.migrate_*`` site, host-budget refusal, CRC
        mismatch, destination capacity refusal, or a crash that breaks
        either endpoint — discards the partial landing, frees both
        sides, and re-dispatches the request for a cold re-prefill on
        the decode side. Token-identical either way (snapshot resume
        re-prefills prompt + already-emitted tokens); counted in
        ``router_migration_fallbacks``. Returns True only for a landed
        migration."""
        keys: List[int] = []
        dest: Optional[_Replica] = None
        stage = "gather"
        try:
            dest = self._decode_target(src)
            if dest is None:
                raise TransientDeviceError(
                    "no decode-capable replica to land the migration")
            self.faults.fire("router.migrate_gather")
            handle = src.srv.cache.migrate_gather(slot, self._mig_pool)
            keys = list(handle["keys"])
            fault = self.faults.fire("router.migrate_corrupt")
            if fault is not None and keys:
                # flip a real stored byte: the genuine per-array CRC32
                # verify in land_parked drives the degrade below —
                # corrupted KV can never reach attention as cached truth
                self._mig_pool.corrupt(keys[0])
            stage = "scatter"
            self.faults.fire("router.migrate_scatter")
            dest.srv.cache.land_parked(req.rid, keys, self._mig_pool,
                                       handle["length"])
        except InjectedCrash as e:
            # a crash breaks the acting endpoint: the gather side is
            # the source, the scatter side is the destination
            victim = src if stage == "gather" else dest
            for k in keys:
                self._mig_pool.discard(k)
            if dest is not None:
                dest.srv.cache.drop_parked(req.rid)
            self._break(victim, now, f"crash: {e}")
            self._drain(victim, now)
            if victim is src:
                # the drain just snapshotted the handoff request,
                # resumed it cold on a survivor, and counted it in
                # migration_fallbacks — nothing left to settle here
                return False
            self._migration_fallback(src, req, now, f"crash: {e}",
                                     dest=dest)
            return False
        except (TransientDeviceError, CacheExhausted, HostCorruption) as e:
            self._migration_fallback(src, req, now, str(e), keys=keys,
                                     dest=dest)
            return False
        # landed: the host copies served their purpose; the destination
        # owns the device-resident chain (parked until admission adopts)
        for k in keys:
            self._mig_pool.discard(k)
        entry = snapshot_entry(req, kv_handle={
            "blocks": int(handle["n_blocks"]),
            "length": int(handle["length"]),
            "src": src.idx, "dest": dest.idx})
        src.srv.release_handoff(req.rid)
        stamps = (req.submitted_at, req.first_token_at,
                  list(req.token_times))
        self._resume_in_place(req, entry)
        ok = dest.srv.submit(req, now=now)
        if not ok:
            # bounded-queue shed at the destination: free the landing
            # and degrade cold on whoever has room
            dest.srv.cache.drop_parked(req.rid)
            self._stat["migration_fallbacks"].inc()
            self.telemetry.tracer.event(
                "migrate", rid=req.rid, step=self._clock, src=src.idx,
                dest=dest.idx, ok=False,
                reason="destination queue full")
            self._dispatch(req, now, excluded={src.idx, dest.idx})
            self._restamp(req, stamps)
            return False
        self._restamp(req, stamps)
        if dest.health == RECOVERING:
            dest.probe_rids.add(req.rid)
        self._stat["migrations"].inc()
        self.telemetry.tracer.event(
            "migrate", rid=req.rid, step=self._clock, src=src.idx,
            dest=dest.idx, blocks=int(handle["n_blocks"]),
            length=int(handle["length"]), ok=True)
        return True

    def _migration_fallback(self, src: _Replica, req: ServeRequest,
                            now: float, reason: str,
                            keys: Sequence[int] = (),
                            dest: Optional[_Replica] = None) -> None:
        """Bottom rung of the migration ladder: discard the host
        copies and any partial landing, free the source's handoff
        slot, and re-dispatch the request for a cold re-prefill on the
        decode side — the same recompute-on-resume path drains use, so
        the output stays token-identical."""
        for k in keys:
            self._mig_pool.discard(k)
        if dest is not None:
            dest.srv.cache.drop_parked(req.rid)
        entry = snapshot_entry(req)
        src.srv.release_handoff(req.rid)
        self._stat["migration_fallbacks"].inc()
        self.telemetry.tracer.event(
            "migrate", rid=req.rid, step=self._clock, src=src.idx,
            dest=(dest.idx if dest is not None else None), ok=False,
            reason=reason)
        stamps = (req.submitted_at, req.first_token_at,
                  list(req.token_times))
        self._resume_in_place(req, entry)
        self._dispatch(req, now, excluded={src.idx})
        self._restamp(req, stamps)

    # -- drain ---------------------------------------------------------
    def _drain(self, rep: _Replica, now: float) -> int:
        """Move a broken replica's work to survivors: merge its
        terminal results, snapshot-and-release its in-flight requests
        (freeing the dead pool's block refs and prefix pins), dedup
        rids already terminal fleet-wide, and resubmit the rest.

        Never raises: undispatchable work (no survivors, or a ``crash``
        injected at ``router.drain``) lands in ``_orphans``, and the
        entry point that triggered the drain raises ONE fleet-level
        :class:`DegradedError` carrying all of it — total degrade
        loses nothing."""
        crashed = False
        for _attempt in range(3):
            try:
                self.faults.fire("router.drain")
                break
            except TransientDeviceError:
                # fired before any state moved: retrying the drain is
                # safe, and a drain must not die to a transient
                self._stat["redispatches"].inc()
                continue
            except InjectedCrash:
                # crash mid-drain: the drain logic is dead — orphan the
                # whole snapshot (escalates to total degrade upstream)
                crashed = True
                break
        self._absorb_terminal(rep)
        # pending_snapshot(release=True) settles the dead replica's
        # in-flight host-tier spills first (abort_transfers); record how
        # many were cut short so a chaos run's timeline shows the
        # drain/spill interaction explicitly. Migrations cut short the
        # same way — finished prefills still parked in handoff slots
        # (source side) and landed chains not yet adopted (destination
        # side, freed by abort_parked) — degrade to cold re-prefills
        # through the snapshot resume below and count as fallbacks.
        mig_cut = len(rep.srv.ready_handoffs())
        parked_aborts_before = rep.srv.cache.parked_aborts
        spill_aborts_before = rep.srv.cache.host_spill_aborts
        snap = rep.srv.pending_snapshot(release=True)
        spill_aborts = rep.srv.cache.host_spill_aborts - spill_aborts_before
        mig_cut += rep.srv.cache.parked_aborts - parked_aborts_before
        if mig_cut:
            self._stat["migration_fallbacks"].inc(mig_cut)
        reqs = [ServeRequest.from_snapshot(s) for s in snap
                if s["rid"] not in self._results]
        placed = 0
        failed = crashed
        for req in reqs:
            if failed:
                self._orphans.append(req)
                continue
            if self._dispatch(req, now, excluded={rep.idx}) is None:
                failed = True        # req orphaned; orphan the rest too
                continue
            placed += 1
            self._stat["drained_requests"].inc()
        self.telemetry.tracer.event(
            "drain", step=self._clock, replica=rep.idx,
            resumed=placed, rids=[r.rid for r in reqs],
            spill_aborts=spill_aborts, migrations_cut=mig_cut)
        logger.warning(
            f"router: drained {placed}/{len(reqs)} in-flight requests "
            f"from replica {rep.idx} onto survivors")
        return placed

    def _absorb_terminal(self, rep: _Replica) -> None:
        """Capture a dead replica's finished requests before its engine
        is discarded (first writer wins: a rid already captured from an
        earlier break keeps its tokens)."""
        for r in rep.srv.finished:
            if r.rid not in self._results:
                self._results[r.rid] = r.tokens
                self._finished.append(r)

    def _fleet_degraded(self, message: str) -> DegradedError:
        self._stat["fleet_degraded"].inc()
        orphans, self._orphans = self._orphans, []
        merged = self.results()
        pending = [snapshot_entry(r) for r in orphans]
        for rep in self.replicas:
            if rep.health not in (BROKEN, RETIRED):
                pending.extend(
                    s for s in rep.srv.pending_snapshot()
                    if s["rid"] not in merged)
        self.telemetry.tracer.event("degraded", step=self._clock,
                                    message=message)
        self.flight.dump(f"fleet degraded: {message}")
        return DegradedError(
            message, results=merged, finished=list(self._finished),
            pending=pending, stats=dict(self.stats))

    # -- checkpoint walk-back ------------------------------------------
    def _restart_tag(self) -> Optional[str]:
        """Newest valid checkpoint tag under ``ckpt_dir``: the
        ``latest`` pointer when it validates, else newest-first over
        ``list_tags`` (a torn/corrupt tag is skipped, never loaded)."""
        if self.ckpt_dir is None:
            return None
        tag = get_latest_tag(self.ckpt_dir)
        if tag is not None and validate_tag(self.ckpt_dir, tag):
            return tag
        for cand in list_tags(self.ckpt_dir):
            if validate_tag(self.ckpt_dir, cand):
                return cand
        return None

"""Deterministic fault injection: the chaos substrate of the serving
engine's robustness layer and of the checkpoint commit points.

Port of ``deepspeed_tpu/utils/faults.py``. A :class:`FaultInjector` holds
an ordered set of :class:`Fault` specs, each bound to a named **site** (a
point in the code that calls :meth:`FaultInjector.fire`) and to the
visits of that site on which it fires. The same spec and seed give the
same failures, so chaos tests assert exact outcomes (token parity, the
tag ``load_checkpoint`` lands on) rather than "it did not crash".

Sites:

====================== =====================================================
``serving.decode``     before each batched decode dispatch (one token or a
                       horizon)
``serving.prefill``    before each prefill-chunk dispatch
``serving.spec_draft`` before the per-slot draft proposals of a speculative
                       step; the step degrades to plain decode
``serving.horizon``    before a multi-step decode dispatch, before any
                       capacity or slot state moves; the step degrades to
                       one-token decode
``engine.prefill``     ``InferenceEngine.prefill_into_slot``
``engine.decode``      ``InferenceEngine.decode_slots`` and
                       ``decode_horizon``
``engine.verify``      ``InferenceEngine.verify_slots``; the scheduler
                       degrades the step to plain decode, never retries it
``cache.quantize``     in the engine's slot programs with int8 pools, after
                       the ``engine.*`` site
``cache.allocate``     ``PagedKVCache.allocate`` (admission)
``cache.ensure``       ``PagedKVCache.ensure_capacity`` (growth)
``cache.match``        before the prefix lookup of ``allocate``;
                       ``cache_exhausted`` serves the request as a cold miss
``cache.cow``          before a copy-on-write, before any bookkeeping moves;
                       ``cache_exhausted`` raises ``CacheExhausted`` and the
                       admission retries
``cache.spill``        before a host-tier spill batch; ``cache_exhausted``
                       skips the batch behind the daemon's backoff
``cache.restore``      before a host-to-device block restore;
                       ``cache_exhausted`` cuts the match there (the tail
                       re-prefills, the host entry survives)
``cache.host_corrupt`` at a restore, after ``cache.restore`` passed;
                       ``cache_exhausted`` flips a real stored byte, so the
                       CRC32 check itself drives the degrade
``cache.adapter_load`` before an adapter load moves any pool state
                       (``inference/adapters.py``); ``cache_exhausted``
                       and ``device_error`` retire the request ``error``
``checkpoint.pre_commit``  after the state is written, before the staged
                       tag directory is renamed into place
``checkpoint.commit``  after that rename, before ``latest`` moves
``router.dispatch``    after the router picks a target replica, before the
                       request is submitted to it: a retry picks again
                       among untouched replicas
``router.step``        before each replica's step in the router's loop;
                       ``crash`` breaks that replica (its work drains onto
                       survivors)
``router.drain``       at the start of a broken replica's drain, before any
                       snapshot or redistribution state moves
``router.migrate_gather``  before the source replica copies a finished
                       prefill's KV chain to the host staging pool; any
                       failure falls back to a cold re-prefill on the
                       decode side
``router.migrate_scatter``  before the destination replica lands the
                       chain into its free list; a failure (a refused
                       landing too) discards the partial landing and
                       falls back cold
``router.migrate_corrupt``  after the gather, before the landing;
                       ``cache_exhausted`` flips a real stored byte, so
                       the landing's CRC32 check drives the fallback
====================== =====================================================

Every site of the slot programs fires before the first write into the
pools, which the port updates in place: a retried step never writes a
token's K/V twice.

Kinds: ``device_error`` raises :class:`TransientDeviceError` (the serving
engine retries with doubling backoff and seeded jitter); ``crash`` raises
:class:`InjectedCrash` (a killed process); ``slow`` sleeps ``param``
seconds inside the caller's timed region (the step watchdog's trigger);
``cache_exhausted`` is returned to the site, which raises its own
``CacheExhausted`` or degrades.

The ambient injector is :func:`install`-ed (tests use :func:`injected`)
or parsed once from ``DS_FAULTS`` / ``DS_FAULT_SEED``::

    DS_FAULTS="serving.decode:device_error@3;checkpoint.commit:crash@0"

Entry grammar: ``site:kind@step[*count][~param]`` joined by ``;`` (or
``,``): fire ``kind`` at ``site`` on visits ``[step, step + count)`` with
the float ``param``.
"""

import time
import warnings
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class FaultError(Exception):
    """Base class of every injected failure."""


class UnknownFaultSiteWarning(UserWarning):
    """A fault spec names a site no code path fires: almost always a typo,
    which would otherwise inject nothing without a word."""


class TransientDeviceError(FaultError):
    """A device dispatch failed in a retryable way; the serving engine's
    backoff handles it."""


class InjectedCrash(FaultError):
    """Simulated process death: raised where the process would die, so
    nothing after the site (a rename, the ``latest`` pointer) happens."""


@dataclass(frozen=True)
class Fault:
    """Fire ``kind`` at ``site`` on visits ``[step, step + count)``;
    ``param`` is the sleep seconds of ``slow``."""
    site: str
    kind: str
    step: int = 0
    count: int = 1
    param: float = 0.0

    def matches(self, visit: int) -> bool:
        return self.step <= visit < self.step + self.count


KINDS = ("device_error", "crash", "slow", "cache_exhausted")

# every site some code path fires (the table above); a subsystem adding
# sites registers them, so that parse_spec flags only typos
KNOWN_SITES = {
    "serving.decode", "serving.prefill", "serving.spec_draft",
    "serving.horizon",
    "engine.prefill", "engine.decode", "engine.verify",
    "cache.allocate", "cache.ensure", "cache.match", "cache.cow",
    "cache.quantize", "cache.spill", "cache.restore", "cache.host_corrupt",
    "cache.adapter_load",
    "checkpoint.pre_commit", "checkpoint.commit",
    "router.dispatch", "router.step", "router.drain",
    "router.migrate_gather", "router.migrate_scatter",
    "router.migrate_corrupt",
}

_warned_sites: set = set()


def register_site(site: str) -> None:
    """Declare ``site`` a real fire point, so :func:`parse_spec` takes it
    without a warning."""
    KNOWN_SITES.add(site)


def parse_spec(spec: str) -> List[Fault]:
    """Parse the ``DS_FAULTS`` grammar. A site no code path fires warns
    once per site (:class:`UnknownFaultSiteWarning`)."""
    faults: List[Fault] = []
    for entry in spec.replace(",", ";").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        try:
            site, rest = entry.split(":", 1)
            kind, rest = rest.split("@", 1)
            param = 0.0
            count = 1
            if "~" in rest:
                rest, p = rest.split("~", 1)
                param = float(p)
            if "*" in rest:
                rest, c = rest.split("*", 1)
                count = int(c)
            step = int(rest)
        except ValueError as e:
            raise ValueError(
                f"bad fault spec entry {entry!r} (want "
                f"site:kind@step[*count][~param]): {e}") from e
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in {entry!r} "
                             f"(known: {', '.join(KINDS)})")
        site = site.strip()
        if site not in KNOWN_SITES and site not in _warned_sites:
            _warned_sites.add(site)
            warnings.warn(
                f"fault spec names unknown site {site!r} — no "
                f"instrumented code path fires it, so this entry "
                f"injects nothing (known sites: "
                f"{', '.join(sorted(KNOWN_SITES))})",
                UnknownFaultSiteWarning, stacklevel=2)
        faults.append(Fault(site=site, kind=kind.strip(), step=step,
                            count=count, param=param))
    return faults


class FaultInjector:
    """Deterministic, seedable fault scheduler.

    :meth:`visit` counts a site's visits and returns the matching
    :class:`Fault` (or None); :meth:`fire` also acts on the generic kinds
    (raise, sleep) and returns the others for the site to interpret.
    ``fired`` logs ``(site, kind, visit)`` of every fault that fired.
    ``rng`` (``numpy.random.default_rng(seed)``, as in JAX) draws the
    serving engine's retry jitter, so one seed pins the whole failure and
    recovery timeline."""

    def __init__(self, faults: Sequence[Fault] = (), seed: int = 0):
        self.faults: List[Fault] = list(faults)
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.visits: Dict[str, int] = {}
        self.fired: List[Tuple[str, str, int]] = []
        # called on every fired fault before its kind acts, so a raise
        # still reaches them (the serving tracer's fault records)
        self._listeners: List = []

    def add_listener(self, cb) -> None:
        """Register ``cb(site, kind, visit)``, called on every fired
        fault."""
        self._listeners.append(cb)

    def remove_listener(self, cb) -> None:
        if cb in self._listeners:
            self._listeners.remove(cb)

    @classmethod
    def from_env(cls, env=None) -> "FaultInjector":
        """The injector ``DS_FAULTS`` and ``DS_FAULT_SEED`` describe (in
        ``env``, default the process environment)."""
        from deepspeed_tpu_torch.utils.env import resolve_flag
        return cls(parse_spec(resolve_flag("DS_FAULTS", env=env)),
                   seed=resolve_flag("DS_FAULT_SEED", env=env))

    def visit(self, site: str) -> Optional[Fault]:
        n = self.visits.get(site, 0)
        self.visits[site] = n + 1
        for f in self.faults:
            if f.site == site and f.matches(n):
                self.fired.append((site, f.kind, n))
                for cb in self._listeners:
                    cb(site, f.kind, n)
                return f
        return None

    def fire(self, site: str) -> Optional[Fault]:
        """Visit ``site`` and act on the matched fault: raise the generic
        kinds, sleep for ``slow``, return the rest."""
        f = self.visit(site)
        if f is None:
            return None
        n = self.visits[site] - 1
        if f.kind == "device_error":
            raise TransientDeviceError(
                f"injected device error at {site} (visit {n})")
        if f.kind == "crash":
            raise InjectedCrash(f"injected crash at {site} (visit {n})")
        if f.kind == "slow":
            time.sleep(f.param)
        return f

    def jitter(self, scale: float) -> float:
        """Deterministic backoff jitter in ``[0, scale)``."""
        return float(self.rng.uniform(0.0, scale))

    def reset(self) -> None:
        """Rewind the visit counters, the log and the generator: the same
        timeline replays."""
        self.visits.clear()
        self.fired.clear()
        self.rng = np.random.default_rng(self.seed)


_active: Optional[FaultInjector] = None


def active() -> FaultInjector:
    """The ambient injector: the installed one, else the one
    ``DS_FAULTS`` describes (parsed once; empty, it injects nothing)."""
    global _active
    if _active is None:
        _active = FaultInjector.from_env()
    return _active


def install(injector: Optional[FaultInjector]) -> Optional[FaultInjector]:
    """Install ``injector`` as the ambient one (None: parsed from the
    environment again on next use). Returns the previous injector."""
    global _active
    prev = _active
    _active = injector
    return prev


def maybe_fire(site: str) -> Optional[Fault]:
    """The site hook: fire against the ambient injector."""
    return active().fire(site)


@contextmanager
def injected(*faults: Fault, seed: int = 0):
    """A fresh ambient injector for the block::

        with faults.injected(Fault("serving.decode", "device_error",
                                   step=3)) as inj:
            srv.run(reqs)
        assert inj.fired
    """
    inj = FaultInjector(faults, seed=seed)
    prev = install(inj)
    try:
        yield inj
    finally:
        install(prev)

"""Deterministic fault injection at the checkpoint commit points.

Port of what ``deepspeed_tpu/runtime/checkpointing.py`` needs from
``deepspeed_tpu/utils/faults.py``: a :class:`Fault` names a site and the
visit at which it fires, a :class:`FaultInjector` counts the visits of
each site, and :func:`maybe_fire` raises :class:`InjectedCrash` where a
scheduled crash is due, exactly where a killed process would stop. Two
sites exist:

``checkpoint.pre_commit``  after the state is written, before the staged
                           tag directory is renamed into place
``checkpoint.commit``      after that rename, before ``latest`` moves

The only kind is ``crash``. The serving sites, the other kinds
(``device_error``, ``slow``, ``cache_exhausted``), the ``DS_FAULTS``
environment variable, deadlines and the watchdog wait for the serving
slice.
"""

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

KINDS = ("crash",)
KNOWN_SITES = ("checkpoint.pre_commit", "checkpoint.commit")


class InjectedCrash(Exception):
    """Simulated process death: raised where the process would die, so
    nothing after the site (a rename, the ``latest`` pointer) happens."""


@dataclass(frozen=True)
class Fault:
    """Fire ``kind`` at ``site`` on visits ``[step, step + count)``."""
    site: str
    kind: str
    step: int = 0
    count: int = 1

    def matches(self, visit: int) -> bool:
        return self.step <= visit < self.step + self.count


class FaultInjector:
    """Counts the visits of each site and fires the fault scheduled for
    a visit. ``fired`` logs ``(site, kind, visit)`` of every fault that
    fired."""

    def __init__(self, faults: Sequence[Fault] = ()):
        for f in faults:
            if f.kind not in KINDS:
                raise NotImplementedError(
                    f"fault kind {f.kind!r} waits for the serving slice "
                    f"(ported: {KINDS})")
            if f.site not in KNOWN_SITES:
                raise NotImplementedError(
                    f"fault site {f.site!r} waits for the serving slice "
                    f"(ported: {KNOWN_SITES})")
        self.faults: List[Fault] = list(faults)
        self.visits: Dict[str, int] = {}
        self.fired: List[Tuple[str, str, int]] = []

    def visit(self, site: str) -> Optional[Fault]:
        n = self.visits.get(site, 0)
        self.visits[site] = n + 1
        for f in self.faults:
            if f.site == site and f.matches(n):
                self.fired.append((site, f.kind, n))
                return f
        return None

    def fire(self, site: str) -> Optional[Fault]:
        """Visit ``site``; raise :class:`InjectedCrash` if a crash is
        due."""
        f = self.visit(site)
        if f is not None:
            raise InjectedCrash(f"injected crash at {site} "
                                f"(visit {self.visits[site] - 1})")
        return None


_active: Optional[FaultInjector] = None


def active() -> FaultInjector:
    """The installed injector, or an empty one."""
    global _active
    if _active is None:
        _active = FaultInjector()
    return _active


def install(injector: Optional[FaultInjector]) -> Optional[FaultInjector]:
    """Install ``injector`` as the ambient one (None: an empty one on next
    use). Returns the previous injector."""
    global _active
    prev = _active
    _active = injector
    return prev


def maybe_fire(site: str) -> Optional[Fault]:
    """The site hook: fire against the ambient injector."""
    return active().fire(site)


@contextmanager
def injected(*faults: Fault):
    """A fresh injector for the block::

        with faults.injected(Fault("checkpoint.commit", "crash")) as inj:
            engine.save_checkpoint(path)      # raises InjectedCrash
    """
    inj = FaultInjector(faults)
    prev = install(inj)
    try:
        yield inj
    finally:
        install(prev)

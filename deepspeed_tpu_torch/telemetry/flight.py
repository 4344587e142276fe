"""Flight recorder: postmortem artifacts of serving incidents.

Port of ``deepspeed_tpu/telemetry/flight.py``. When the serving engine
raises ``DegradedError`` the evidence would otherwise live only in the
process that raised it. Armed, the recorder writes one self-contained,
versioned, CRC-stamped JSON artifact first: the tracer ring, the metrics
snapshot and histogram windows, the stats, the fired faults, the resolved
``DS_*`` flags, the program cost registry, the cost accounting, a row per
request, and the identity of the process (Python, torch, CUDA, the card).
``python -m deepspeed_tpu_torch.tools.postmortem`` rebuilds a timeline and
a cost summary from the file alone, as the JAX package's
``tools/postmortem.py`` does; each reads the other's artifacts.

``ServingEngine(flight_recorder=)`` or ``DS_FLIGHT_RECORDER`` (default
off: :data:`NOOP_FLIGHT`, whose ``dump`` does nothing). On, it costs
nothing until an incident, then one ``json.dump`` on the failure path.
At most :attr:`FlightRecorder.MAX_ARTIFACTS` artifacts stay in a
directory, the oldest deleted first.
"""

import json
import os
import platform
import tempfile
import time
import zlib
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["ARTIFACT_VERSION", "FlightRecorder", "NoopFlightRecorder",
           "NOOP_FLIGHT", "canonical_json", "verify_artifact",
           "load_artifact"]

#: bumped when the body's schema changes incompatibly; readers refuse a
#: version they do not know
ARTIFACT_VERSION = 1


def canonical_json(body: Dict) -> str:
    """The serialization the CRC covers: sorted keys, no whitespace.
    ``body`` is plain JSON data already (the recorder round-trips it
    through json before stamping, so a reader recomputes the same
    bytes)."""
    return json.dumps(body, sort_keys=True, separators=(",", ":"))


def _normalize(obj):
    """``obj`` as plain JSON data (tuples become lists, other objects
    their repr), so the CRC survives a write and a read."""
    return json.loads(json.dumps(obj, default=repr))


class FlightRecorder:
    """An armed recorder over a set of section providers.

    ``sections`` maps a section name to a callable returning its plain
    data, called at :meth:`dump` time only; a provider that fails leaves
    an ``{"error": ...}`` stub in its section instead of losing the
    artifact. ``device`` is the device the engine runs on, which the
    identity names."""

    enabled = True
    MAX_ARTIFACTS = 8

    def __init__(self, outdir: Optional[str] = None,
                 sections: Optional[Dict[str, Callable[[], object]]] = None,
                 label: str = "serving", device=None):
        self.outdir = outdir or os.path.join(tempfile.gettempdir(),
                                             "ds_flight")
        self.label = label
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)
        self.sections: Dict[str, Callable[[], object]] = dict(sections or {})
        self.dumps: List[str] = []        # paths written by this recorder
        self._seq = 0

    def add_section(self, name: str, provider: Callable[[], object]) -> None:
        """Add (or replace) the section ``name``, read at each dump."""
        self.sections[name] = provider

    def dump(self, reason: str, extra: Optional[Dict] = None) -> str:
        """Write one artifact; returns its path."""
        body: Dict = {
            "schema": ARTIFACT_VERSION,
            "label": self.label,
            "reason": str(reason),
            "wall_time": time.time(),
            "identity": _identity(self.device),
        }
        for name, provider in self.sections.items():
            try:
                body[name] = provider()
            except Exception as e:   # a section must not cost the artifact
                body[name] = {"error": f"{type(e).__name__}: {e}"}
        if extra:
            body["extra"] = extra
        body = _normalize(body)
        artifact = {
            "version": ARTIFACT_VERSION,
            "crc32": zlib.crc32(canonical_json(body).encode("utf-8")),
            "body": body,
        }
        os.makedirs(self.outdir, exist_ok=True)
        self._seq += 1
        fname = (f"postmortem-{self.label}-{int(time.time() * 1000)}"
                 f"-{os.getpid()}-{self._seq}.json")
        path = os.path.join(self.outdir, fname)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(artifact, f, sort_keys=True)
        self.dumps.append(path)
        self._prune()
        return path

    def _prune(self) -> None:
        """Keep the newest :attr:`MAX_ARTIFACTS` artifacts of the
        directory."""
        try:
            files = sorted(
                f for f in os.listdir(self.outdir)
                if f.startswith("postmortem-") and f.endswith(".json"))
            for stale in files[:-self.MAX_ARTIFACTS]:
                os.unlink(os.path.join(self.outdir, stale))
        except OSError:
            pass


class NoopFlightRecorder:
    """The off twin: no directory, no sections, ``dump`` returns None."""

    enabled = False
    outdir = None
    sections: Dict = {}
    dumps: List[str] = []

    def add_section(self, name, provider) -> None:
        pass

    def dump(self, reason: str, extra=None):
        return None


NOOP_FLIGHT = NoopFlightRecorder()


def _identity(device: torch.device) -> Dict:
    """The process and its device, under the keys of the JAX recorder's
    identity that the readers use: ``backend`` is ``gpu`` for an engine
    on the card and ``cpu`` on the host."""
    out: Dict = {"python": platform.python_version(),
                 "platform": platform.platform(),
                 "torch": torch.__version__,
                 "cuda": torch.version.cuda}
    if device.type == "cuda":
        out.update(backend="gpu",
                   device_kind=torch.cuda.get_device_name(device),
                   device_count=torch.cuda.device_count())
    else:
        out.update(backend="cpu", device_kind="cpu", device_count=1)
    return out


def load_artifact(path: str) -> Dict:
    """Read and verify an artifact; returns its body. Raises ValueError
    on an unknown version or a CRC mismatch."""
    with open(path, "r", encoding="utf-8") as f:
        artifact = json.load(f)
    verify_artifact(artifact)
    return artifact["body"]


def verify_artifact(artifact: Dict) -> None:
    """Raise ValueError unless ``artifact`` is a recorder artifact of a
    known version whose CRC matches its body."""
    if not isinstance(artifact, dict) or "body" not in artifact:
        raise ValueError("not a flight-recorder artifact (no body)")
    ver = artifact.get("version")
    if ver != ARTIFACT_VERSION:
        raise ValueError(f"unknown postmortem artifact version {ver!r} "
                         f"(reader knows {ARTIFACT_VERSION})")
    want = artifact.get("crc32")
    got = zlib.crc32(canonical_json(artifact["body"]).encode("utf-8"))
    if want != got:
        raise ValueError(f"postmortem CRC mismatch: stamped {want}, "
                         f"recomputed {got} — artifact corrupt")

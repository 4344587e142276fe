"""Postmortem reader: rebuild a serving incident from a flight-recorder
artifact alone.

The port's copy of the JAX package's ``tools/postmortem.py``. It reads the
versioned, CRC-stamped JSON that ``deepspeed_tpu_torch/telemetry/flight.py``
(or the JAX package's recorder) writes when the serving engine raises
``DegradedError``, and rebuilds

- the request timeline from the tracer ring (per rid: enqueue, admit,
  prefill, ... finish, with times relative to the oldest record),
- the faults that fired before the incident,
- the cost summary per tenant and dispatch class (FLOPs, HBM bytes,
  dispatches, KV block-seconds),
- the resolved flags and the identity of the process that raised.

It uses the standard library only, so it runs where neither torch nor
the serving objects are; the verification therefore repeats (rather than
imports) ``telemetry/flight.py``'s: the same canonical serialization, CRC
and version gate.

Usage::

    python -m deepspeed_tpu_torch.tools.postmortem <artifact.json>
    python -m deepspeed_tpu_torch.tools.postmortem <artifact.json> --json
"""

import json
import sys
import zlib

#: telemetry/flight.py's ARTIFACT_VERSION
ARTIFACT_VERSION = 1


def canonical_json(body):
    """Same canonical form the recorder CRC-stamps: sorted keys, no
    whitespace."""
    return json.dumps(body, sort_keys=True, separators=(",", ":"))


def verify_artifact(artifact):
    """Raise ValueError on unknown version or CRC mismatch."""
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


def load_artifact(path):
    with open(path, "r", encoding="utf-8") as f:
        artifact = json.load(f)
    verify_artifact(artifact)
    return artifact["body"]


# ---------------------------------------------------------------------------
# reconstruction
# ---------------------------------------------------------------------------

def _request_timeline(records):
    """Group tracer records by rid into ordered event lists with
    timestamps relative to the oldest record in the ring."""
    if not records:
        return {}, 0.0
    t0 = min(r[0] for r in records)
    per_rid = {}
    for rec in records:
        ts, etype, rid, step, slot = rec[0], rec[1], rec[2], rec[3], rec[4]
        data = rec[5] if len(rec) > 5 else None
        key = rid if rid is not None else "<system>"
        per_rid.setdefault(key, []).append({
            "t": round(ts - t0, 6), "event": etype, "step": step,
            "slot": slot, "data": data,
        })
    return per_rid, t0


def _sum_footprint(fp):
    """Total flops/bytes/dispatches across dispatch classes of one
    footprint dict (tolerates the block_seconds scalar key)."""
    out = {"flops": 0, "hbm_bytes": 0, "dispatches": 0,
           "block_seconds": 0}
    for key, val in fp.items():
        if key == "block_seconds":
            out["block_seconds"] += int(val)
        elif isinstance(val, dict):
            for k in ("flops", "hbm_bytes", "dispatches"):
                out[k] += int(val.get(k, 0))
    return out


def analyze_postmortem(body, quiet=True):
    """Pure reconstruction: artifact body dict -> stable summary dict.

    The summary is what ``--json`` prints and what the round-trip test
    compares against live objects, so keep the schema stable: top-level
    keys ``incident``, ``identity``, ``requests``, ``faults``,
    ``autoscale``, ``tenants``, ``totals``, ``flags``, ``programs``.
    """
    records = body.get("tracer") or []
    per_rid, _ = _request_timeline(records)

    requests = {}
    rows = body.get("requests")
    if isinstance(rows, list):
        for row in rows:
            if isinstance(row, dict) and "rid" in row:
                requests[row["rid"]] = row
    # merge the tracer-derived timeline into (or create) each request row
    summary_requests = {}
    # rids of one type sort as they are; integer rids beside the
    # "<system>" lane of the scheduler's records sort by type first
    for rid in sorted(set(per_rid) | set(requests),
                      key=lambda r: (type(r).__name__, r)):
        row = dict(requests.get(rid, {}))
        events = per_rid.get(rid, [])
        row["events"] = events
        row["event_counts"] = {}
        for ev in events:
            row["event_counts"][ev["event"]] = \
                row["event_counts"].get(ev["event"], 0) + 1
        if "cost" in row and isinstance(row["cost"], dict):
            row["cost_total"] = _sum_footprint(row["cost"])
        summary_requests[rid] = row

    costs = body.get("costs") or {}
    tenants = {}
    for tid, fp in sorted((costs.get("tenants") or {}).items()):
        tenants[tid] = {"footprint": fp, "total": _sum_footprint(fp)}

    programs = body.get("programs") or {}
    if isinstance(programs, dict) and "programs" in programs:
        programs = programs["programs"]

    summary = {
        "incident": {
            "label": body.get("label"),
            "reason": body.get("reason"),
            "wall_time": body.get("wall_time"),
            "schema": body.get("schema"),
        },
        "identity": body.get("identity") or {},
        "requests": summary_requests,
        "faults": body.get("faults") or [],
        "autoscale": body.get("autoscale") or [],
        "tenants": tenants,
        "totals": {
            "per_class": costs.get("totals") or {},
            "flops_total": int(costs.get("flops_total") or 0),
            "hbm_bytes_total": int(costs.get("hbm_bytes_total") or 0),
            "block_seconds_total": int(costs.get("block_seconds_total")
                                       or 0),
        },
        "flags": body.get("flags") or {},
        "programs": {"count": len(programs),
                     "ids": sorted(programs)},
    }
    if not quiet:
        print(format_report(summary))
    return summary


def format_report(summary):
    """Human-readable incident report."""
    lines = []
    inc = summary["incident"]
    ident = summary["identity"]
    lines.append(f"== postmortem: {inc.get('label')} ==")
    lines.append(f"reason      : {inc.get('reason')}")
    lines.append(f"wall_time   : {inc.get('wall_time')}")
    runtime = (f"torch {ident.get('torch')} / cuda {ident.get('cuda')}"
               if "torch" in ident else f"jax {ident.get('jax')}")
    lines.append(f"identity    : python {ident.get('python')} / {runtime} / "
                 f"backend {ident.get('backend', '?')} "
                 f"({ident.get('device_kind', '?')})")
    lines.append(f"programs    : {summary['programs']['count']} in cost "
                 f"registry")

    lines.append("")
    lines.append(f"-- requests ({len(summary['requests'])}) --")
    for rid, row in summary["requests"].items():
        counts = " ".join(f"{k}x{v}" for k, v in
                          sorted(row.get("event_counts", {}).items()))
        state = row.get("state", "?")
        lines.append(f"  {rid:<16} state={state:<9} "
                     f"gen={row.get('generated', '?'):<4} {counts}")
        tot = row.get("cost_total")
        if tot:
            lines.append(f"  {'':<16} cost: {tot['flops']} flops, "
                         f"{tot['hbm_bytes']} hbm bytes, "
                         f"{tot['dispatches']} dispatches, "
                         f"{tot['block_seconds']} block-seconds")
        for ev in row.get("events", []):
            data = "" if ev["data"] is None else f" {ev['data']}"
            lines.append(f"    +{ev['t']:.4f}s step={ev['step']} "
                         f"slot={ev['slot']} {ev['event']}{data}")

    if summary["faults"]:
        lines.append("")
        lines.append(f"-- fired faults ({len(summary['faults'])}) --")
        for f in summary["faults"]:
            lines.append(f"  {f}")

    if summary["autoscale"]:
        lines.append("")
        lines.append(f"-- autoscaler decisions "
                     f"({len(summary['autoscale'])}) --")
        for d in summary["autoscale"]:
            lines.append(f"  {d}")

    lines.append("")
    lines.append("-- cost summary --")
    tot = summary["totals"]
    lines.append(f"  global: {tot['flops_total']} flops, "
                 f"{tot['hbm_bytes_total']} hbm bytes, "
                 f"{tot['block_seconds_total']} kv block-seconds")
    for cls, c in sorted(tot["per_class"].items()):
        lines.append(f"    {cls:<8} {c.get('dispatches', 0):>8} dispatches "
                     f"{c.get('flops', 0):>16} flops "
                     f"{c.get('hbm_bytes', 0):>16} bytes")
    for tid, t in summary["tenants"].items():
        tt = t["total"]
        lines.append(f"  tenant {tid:<12} {tt['flops']} flops, "
                     f"{tt['hbm_bytes']} hbm bytes, "
                     f"{tt['block_seconds']} block-seconds")
    return "\n".join(lines)


def main(argv):
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    path = argv[0]
    as_json = "--json" in argv[1:]
    try:
        body = load_artifact(path)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"postmortem: cannot read {path}: {e}", file=sys.stderr)
        return 2
    summary = analyze_postmortem(body)
    try:
        if as_json:
            # through JSON once first: integer rids become strings, so the
            # keys sort beside "<system>"
            print(json.dumps(json.loads(json.dumps(summary)), indent=2,
                             sort_keys=True))
        else:
            print(format_report(summary))
    except BrokenPipeError:
        # downstream pager/head closed the pipe — normal CLI exit
        sys.stderr.close()
        return 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

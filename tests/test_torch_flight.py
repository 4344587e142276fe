"""The port's flight recorder and postmortem reader against the JAX
package's on the CPU.

A port engine degraded by its watchdog writes its artifact before the
``DegradedError`` leaves it; the JAX package's reader
(``tools/postmortem.py``) and the port's
(``deepspeed_tpu_torch/tools/postmortem.py``) both accept it and rebuild
the same summary from it, and the JAX engine's artifact of the same
incident carries the same requests, faults, stats, costs, flags and
tracer records (timestamps aside). A JAX artifact is read by the port's
reader as by JAX's; a tampered byte or an unknown version is refused by
both. Both engines run one tiny float32 model in the ``SERVE_KW``
geometry, their watchdogs on a clock that only a sleep moves
(``tests/test_torch_chaos.py FakeClock``), so nothing here depends on the
host's load.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from deepspeed_tpu.telemetry import flight as jflight
from deepspeed_tpu_torch.telemetry import flight as tflight
from deepspeed_tpu_torch.tools import postmortem as tpm
from test_torch_chaos import (PKGS, FakeClock, clocks,  # noqa: F401
                              engines, one_torch_thread, prompts_of)
from test_torch_serving import SERVE_KW
from tools import postmortem as jpm
from tools.trace_analyze import analyze_cost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = "serving.decode:slow@4*2~0.05"


@pytest.fixture(scope="module")
def incident(engines, tmp_path_factory):
    """{package: (engine, artifact path, fired log)} of one watchdog
    incident: two decode dispatches over budget on the fake clock."""
    p1, p2 = prompts_of((6, 9), seed=12)
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name, smod, fmod in PKGS:
            clock = FakeClock()
            mp.setattr(smod, "time", clock)
            mp.setattr(fmod, "time", clock)
            with fmod.injected(*fmod.parse_spec(SPEC), seed=0) as inj:
                srv = smod.ServingEngine(
                    engines[name], step_time_budget_s=0.01, watchdog_grace=2,
                    telemetry=True, flight_recorder=True,
                    flight_dir=str(tmp_path_factory.mktemp(name)),
                    **SERVE_KW)
                with pytest.raises(smod.DegradedError, match="over budget"):
                    srv.run([smod.ServeRequest(rid="a", prompt=p1,
                                               max_new_tokens=12),
                             smod.ServeRequest(rid="b", prompt=p2,
                                               max_new_tokens=3)])
            assert len(srv.flight.dumps) == 1
            out[name] = (srv, srv.flight.dumps[0], list(inj.fired))
    finally:
        mp.undo()
    return out


def records(body):
    """The tracer ring without timestamps and the breakdown's wall-clock
    phases."""
    return [r[1:] for r in body["tracer"] if r[1] != "step_phase"]


def test_port_artifact_read_by_both_readers(incident):
    """Every reader accepts the port's artifact with one body; JAX's and
    the port's ``analyze_postmortem`` give the same summary, whose faults
    are the injector's log, whose request rows and costs are the live
    engine's, and whose identity names torch and the host."""
    srv, path, fired = incident["port"]
    body = tflight.load_artifact(path)
    assert tpm.load_artifact(path) == jpm.load_artifact(path) == \
        jflight.load_artifact(path) == body
    summary = tpm.analyze_postmortem(body)
    assert summary == jpm.analyze_postmortem(body)
    assert summary["incident"]["reason"].startswith("degraded: decode step "
                                                    "over budget")
    assert [tuple(f) for f in summary["faults"]] == fired == [
        ("serving.decode", "slow", 4), ("serving.decode", "slow", 5)]
    rows = summary["requests"]
    assert rows["b"]["state"] == "done" and rows["a"]["slot"] == 0
    assert rows["a"]["event_counts"]["enqueue"] == 1
    assert rows["b"]["event_counts"]["finish"] == 1
    live = srv.costs.snapshot()
    assert summary["totals"]["per_class"] == live["totals"]
    assert summary["totals"]["flops_total"] == live["flops_total"]
    assert summary["programs"]["count"] == len(srv.cost_registry.entries)
    assert summary["flags"]["DS_FLIGHT_RECORDER"] is False
    ident = summary["identity"]
    assert ident["backend"] == "cpu" and ident["torch"] and \
        ident["device_count"] == 1
    assert body["stats"] == dict(srv.stats)
    # the JAX package's cost reader takes the port's artifact too
    assert analyze_cost(path, quiet=True)["flops_total"] == \
        live["flops_total"]
    report = tpm.format_report(summary)
    assert "torch" in report and "degraded" in report


def test_port_and_jax_artifacts_of_one_incident_agree(incident):
    """The two engines' artifacts of the same incident: the same sections,
    requests, faults, stats, flags, costs, tracer records and program
    catalog, the LoRA twins included; only the identity, the wall time and
    the name of the callable behind each program (``attr``) are the
    package's own."""
    got, ref = (tflight.load_artifact(incident[n][1])
                for n in ("port", "jax"))
    assert set(got) == set(ref)
    for key in ("schema", "label", "reason", "stats", "faults", "flags",
                "requests", "costs"):
        assert got[key] == ref[key], key

    def catalog(body):
        return {pid: {k: v for k, v in e.items() if k != "attr"}
                for pid, e in body["programs"]["programs"].items()}
    assert catalog(got) == catalog(ref)
    assert any(pid.endswith("_ql") for pid in catalog(got))
    assert records(got) == records(ref)
    assert [r[0] for r in records(got) if r[0] in ("watchdog", "degraded",
                                                   "fault")] == \
        ["fault", "watchdog", "fault", "watchdog", "degraded"]
    summaries = [tpm.analyze_postmortem(b) for b in (got, ref)]
    for key in ("faults", "totals", "tenants", "flags"):
        assert summaries[0][key] == summaries[1][key], key


def test_jax_artifact_read_by_the_port_reader(incident):
    """The port's stdlib reader takes the JAX engine's artifact: the
    same body, summary and report as the JAX reader's."""
    path = incident["jax"][1]
    body = tpm.load_artifact(path)
    assert body == jpm.load_artifact(path)
    summary = tpm.analyze_postmortem(body)
    assert summary == jpm.analyze_postmortem(body)
    assert tpm.format_report(summary) == jpm.format_report(summary)
    assert [tuple(f) for f in summary["faults"]] == incident["jax"][2]


@pytest.mark.parametrize("who", ["port", "jax"])
def test_tampered_artifact_refused_by_both_readers(incident, tmp_path, who):
    """A changed byte fails the CRC, an unknown version the version gate,
    a file without a body the shape check, in every reader alike."""
    with open(incident[who][1]) as f:
        artifact = json.load(f)
    bad = str(tmp_path / "bad.json")
    readers = (tflight.load_artifact, tpm.load_artifact,
               jflight.load_artifact, jpm.load_artifact)
    for edit, match in (
            (lambda a: a["body"].update(reason="tampered"), "CRC"),
            (lambda a: a.update(version=99), "version"),
            (lambda a: a.pop("body"), "no body")):
        edit(artifact)
        with open(bad, "w") as f:
            json.dump(artifact, f)
        msgs = []
        for read in readers:
            with pytest.raises(ValueError, match=match) as ei:
                read(bad)
            msgs.append(str(ei.value))
        assert len(set(msgs)) == 1


def test_recorder_bound_sections_and_off_twin(tmp_path):
    """At most MAX_ARTIFACTS files stay, a failing section leaves an error
    stub (the artifact survives), ``extra`` rides along; the off twin
    writes nothing; all as the JAX recorder does."""
    outs = []
    for mod in (tflight, jflight):
        d = tmp_path / mod.__name__.split(".")[0]
        rec = mod.FlightRecorder(outdir=str(d), sections={
            "ok": lambda: {"t": (1, 2)}, "bad": lambda: 1 / 0})
        paths = [rec.dump(f"r{i}", extra={"i": i}) for i in range(10)]
        files = sorted(os.listdir(d))
        assert len(files) == mod.FlightRecorder.MAX_ARTIFACTS
        body = mod.load_artifact(paths[-1])
        outs.append({k: body[k] for k in ("ok", "bad", "extra", "reason",
                                          "label", "schema")})
        assert mod.NOOP_FLIGHT.dump("x") is None
        assert not mod.NOOP_FLIGHT.enabled and rec.enabled
    assert outs[0] == outs[1]
    assert outs[0]["bad"] == {"error": "ZeroDivisionError: division by zero"}
    assert tflight.canonical_json({"b": 1, "a": [1]}) == \
        jflight.canonical_json({"b": 1, "a": [1]}) == '{"a":[1],"b":1}'


def test_postmortem_cli(incident):
    """``python -m deepspeed_tpu_torch.tools.postmortem`` prints the
    report, or the summary as JSON, and exits 2 on an unreadable file;
    the module imports the standard library only."""
    path = incident["port"][1]
    env = dict(os.environ, PYTHONPATH=REPO)

    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "deepspeed_tpu_torch.tools.postmortem",
             *args], cwd=REPO, env=env, capture_output=True, text=True,
            timeout=120)
    res = cli(path)
    assert res.returncode == 0 and "== postmortem: serving ==" in res.stdout
    res = cli(path, "--json")
    assert res.returncode == 0
    assert json.loads(res.stdout) == json.loads(json.dumps(
        tpm.analyze_postmortem(tpm.load_artifact(path))))
    res = cli(os.path.join(os.path.dirname(path), "missing.json"))
    assert res.returncode == 2 and "cannot read" in res.stderr
    assert cli("--help").returncode == 0
    with open(tpm.__file__) as f:
        tree = ast.parse(f.read())
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert roots <= set(sys.stdlib_module_names), roots


def test_degraded_engine_keeps_serving_after_the_dump(incident, clocks):
    """The dump leaves the engine consistent: stepping on (on the fake
    clock again) drains both engines to the same streams, every request
    done."""
    outs = []
    for name in ("port", "jax"):
        srv = incident[name][0]
        out = srv.run()
        outs.append({k: np.asarray(v).tolist() for k, v in out.items()})
        assert {r.state for r in srv.finished} == {"done"}
    assert outs[0] == outs[1] and set(outs[0]) == {"a", "b"}


def test_port_reader_takes_integer_rids(tmp_path):
    """Integer rids beside the ``<system>`` lane of the scheduler's records
    (a fault record has no rid) sort by type in the port's reader, and
    its ``--json`` output writes them as strings. The JAX reader's sort
    raises TypeError on them: a reference fault the port does not copy
    (ROADMAP.md section 3)."""
    rec = tflight.FlightRecorder(outdir=str(tmp_path), sections={
        "tracer": lambda: [
            [0.0, "enqueue", 1, 0, -1, None],
            [0.1, "fault", None, 0, -1, {"site": "serving.decode",
                                         "kind": "slow", "visit": 0}],
            [0.2, "enqueue", 0, 0, -1, None]],
        "requests": lambda: [{"rid": 0, "state": "done"},
                             {"rid": 1, "state": "queued"}]})
    path = rec.dump("integer rids")
    summary = tpm.analyze_postmortem(tflight.load_artifact(path))
    assert list(summary["requests"]) == [0, 1, "<system>"]
    assert summary["requests"]["<system>"]["event_counts"] == {"fault": 1}
    with pytest.raises(TypeError):
        jpm.analyze_postmortem(jpm.load_artifact(path))
    res = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.tools.postmortem", path,
         "--json"], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert sorted(json.loads(res.stdout)["requests"]) == ["0", "1",
                                                          "<system>"]

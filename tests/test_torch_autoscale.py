"""The port's SLO autoscaler and the router's elasticity against the JAX
package's on the CPU.

The JAX suite's cases (``tests/test_autoscale.py``), run in both packages
on the same fleets (the ``SERVE_KW`` geometry over the same numpy float32
parameters) and the same seeded requests, on the scheduler clock. Held
equal: the controller's ``decisions`` list (every field: the windowed p99,
counts, load, queue depth, replica counts, the actions), the router's
stats, health and tracer records, the streams (each equal to a solo
``generate``), and the summary ``read_fleet_trace`` rebuilds from the
port's exported trace against what the JAX ``analyze_fleet_trace`` reads
from the JAX export.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from deepspeed_tpu.inference import autoscale as jautoscale
from deepspeed_tpu.inference import router as jrouter
from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.telemetry import Telemetry as JTelemetry
from deepspeed_tpu.utils import faults as jfaults
from deepspeed_tpu_torch.inference import autoscale as tautoscale
from deepspeed_tpu_torch.inference import router as trouter
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.telemetry import Telemetry as TTelemetry
from deepspeed_tpu_torch.telemetry import read_fleet_trace
from deepspeed_tpu_torch.utils import faults as tfaults
from test_torch_chaos import engines  # noqa: F401
from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_router import outcome, prompts_of, requests, solo
from test_torch_serving import SERVE_KW
from tools.trace_analyze import analyze_fleet_trace

PKGS = (("jax", jserving, jrouter, jautoscale, jfaults, JTelemetry),
        ("port", tserving, trouter, tautoscale, tfaults, TTelemetry))
BURST = dict(ttft_slo=2.0, window=8.0, eval_every=1, cooldown=2.0,
             max_replicas=3, min_samples=2, queue_high=1.5,
             idle_to_retire=1e9)


def both(fn, engines):
    """``fn(k)`` per package: ``k.srv(telemetry=None)`` builds a replica,
    ``k.r``, ``k.a``, ``k.f`` the router, autoscale and faults modules."""
    out = {}
    for name, smod, rmod, amod, fmod, tel in PKGS:
        def srv(telemetry=None, _s=smod, _e=engines[name]):
            return _s.ServingEngine(_e, telemetry=telemetry, **SERVE_KW)
        out[name] = fn(SimpleNamespace(s=smod, r=rmod, a=amod, f=fmod,
                                       srv=srv, Telemetry=tel))
    return out


def test_decision_constants_match_jax():
    assert tautoscale._DECISION_COUNTERS == jautoscale._DECISION_COUNTERS
    assert (tautoscale.SCALE_UP, tautoscale.RETIRE, tautoscale.TIGHTEN,
            tautoscale.RELAX, tautoscale.NOOP) == \
        (jautoscale.SCALE_UP, jautoscale.RETIRE, jautoscale.TIGHTEN,
         jautoscale.RELAX, jautoscale.NOOP)
    for bad in (dict(ttft_slo=0), dict(ttft_slo=1.0, tpot_slo=-1.0),
                dict(ttft_slo=1.0, min_replicas=3, max_replicas=2)):
        with pytest.raises(ValueError):
            tautoscale.SLOController(**bad)


# ---------------------------------------------------------------------------
# elasticity (no controller)
# ---------------------------------------------------------------------------

def test_add_and_retire_replica_mechanics(engines):
    p = prompts_of((6,))[0]

    def run(k):
        router = k.r.ReplicaRouter([k.srv()],
                                   replica_factory=lambda i, tag: k.srv())
        errors = []
        idx = router.add_replica(now=1.0, reason="test")
        drained = router.retire_replica(1, now=2.0)
        for call in (lambda: router.retire_replica(1),
                     lambda: router.retire_replica(0)):
            with pytest.raises(ValueError) as ei:
                call()
            errors.append(str(ei.value))
        router.submit(k.s.ServeRequest(rid="x", prompt=p, max_new_tokens=4))
        idle = (len(router.replicas[1].srv.queue) == 0
                and all(s is None for s in router.replicas[1].srv.slots))
        bare = k.r.ReplicaRouter([k.srv()])
        with pytest.raises(RuntimeError, match="replica_factory"):
            bare.add_replica()
        return (idx, drained, errors, idle, router.health(),
                dict(router.stats), bare.add_replica(srv=k.srv()))
    got = both(run, engines)
    assert got["port"] == got["jax"]
    idx, drained, errors, idle, health, stats, bare_idx = got["port"]
    assert (idx, drained, idle, bare_idx) == (1, 0, True, 1)
    assert "already retired" in errors[0]
    assert "last dispatchable" in errors[1]
    assert health == ["healthy", "retired"]
    assert stats["scale_ups"] == 1 and stats["retires"] == 1


def test_retire_busy_replica_token_parity(engines):
    """Retiring a replica mid-decode drains it onto the survivor through
    the breaker's snapshot path: the solo streams."""
    prompts = prompts_of((6, 9, 12, 5), seed=4)
    refs = solo(engines, prompts, 6)

    def run(k):
        router = k.r.ReplicaRouter([k.srv(), k.srv()], telemetry=True)
        for r in requests(k, prompts):
            router.submit(r, now=0.0)
        for _ in range(3):
            router.step()
        busy = router.replicas[1].srv.busy
        drained = router.retire_replica(1, now=3.0, reason="scale-down")
        return outcome(router, router.run()), busy, drained
    got = both(run, engines)
    assert got["port"] == got["jax"]
    res, busy, drained = got["port"]
    assert busy and drained > 0
    assert res["stats"]["drained_requests"] == drained
    for i, ref in enumerate(refs):
        np.testing.assert_array_equal(res["results"][i], ref)


def test_tightened_admission_sheds_batch_class_only(engines):
    p1, p2 = prompts_of((6, 7), seed=2)

    def run(k):
        tel = k.Telemetry()
        router = k.r.ReplicaRouter([k.srv(tel)], telemetry=tel)
        router.shed_batch = True
        batch = k.s.ServeRequest(rid="b", prompt=p1, max_new_tokens=4,
                                 priority="batch")
        inter = k.s.ServeRequest(rid="i", prompt=p2, max_new_tokens=4,
                                 priority="interactive")
        ok = (router.submit(batch, now=1.0), router.submit(inter, now=1.0))
        out = router.run()
        router.shed_batch = False
        again = router.submit(k.s.ServeRequest(
            rid="b2", prompt=p1.copy(), max_new_tokens=4, priority="batch"),
            now=2.0)
        sheds = [r[5] for r in tel.tracer.records() if r[1] == "shed"]
        return (ok, batch.state, batch.finished_at,
                {r: [int(t) for t in v] for r, v in out.items()},
                dict(router.stats), sheds, again)
    got = both(run, engines)
    assert got["port"] == got["jax"]
    ok, state, fin, out, stats, sheds, again = got["port"]
    assert ok == (False, True) and (state, fin) == ("shed", 1.0)
    assert len(out["b"]) == len(p1) and stats["shed"] == 1
    assert len(sheds) == 1 and sheds[0]["priority"] == "batch" and again


# ---------------------------------------------------------------------------
# the control loop
# ---------------------------------------------------------------------------

def test_controller_scales_up_under_burst(engines):
    """A burst one replica cannot absorb: two scale-ups, cooldown apart,
    every decision carrying its triggering metrics, the same list in both
    packages."""
    prompts = prompts_of((6, 8, 10, 7, 9, 6, 8, 11), seed=5)

    def run(k):
        tel = k.Telemetry()
        ctrl = k.a.SLOController(**BURST)
        router = k.r.ReplicaRouter(
            [k.srv(tel)], replica_factory=lambda i, tag: k.srv(tel),
            telemetry=tel, autoscale=ctrl)
        out = router.run(requests(k, prompts))
        snap = router.fleet_snapshot()
        return (outcome(router, out), ctrl.decisions,
                {n: snap["counters"][n] for n in
                 ("autoscale_scale_ups", "autoscale_decisions",
                  "router_scale_ups")},
                snap["gauges"]["autoscale_target_replicas"])
    got = both(run, engines)
    assert got["port"] == got["jax"]
    res, decisions, counters, target = got["port"]
    ups = [d for d in decisions if d["action"] == "scale_up"]
    assert len(ups) == 2 and res["health"] == ["healthy"] * 3
    for d in ups:
        assert d["queue_pressure"] or d["p99_ttft"] > 2.0
    assert counters == {"autoscale_scale_ups": 2,
                        "autoscale_decisions": len(decisions),
                        "router_scale_ups": 2} and target == 3
    assert ups[1]["at"] - ups[0]["at"] >= 2.0
    for i, ref in enumerate(solo(engines, prompts, 6)):
        np.testing.assert_array_equal(res["results"][i], ref)


def test_controller_retires_on_sustained_idle(engines):
    prompts = prompts_of((6, 7), seed=6)

    def run(k):
        ctrl = k.a.SLOController(ttft_slo=100.0, window=4.0, eval_every=1,
                                 cooldown=1.0, min_replicas=1,
                                 max_replicas=3, idle_to_retire=5.0,
                                 min_samples=2)
        router = k.r.ReplicaRouter([k.srv() for _ in range(3)],
                                   autoscale=ctrl)
        out = router.run(requests(k, prompts, n=4))
        for t in range(20):
            router.step(float(100 + t))
        return sorted(out), ctrl.decisions, router.health(), \
            dict(router.stats)
    got = both(run, engines)
    assert got["port"] == got["jax"]
    rids, decisions, health, stats = got["port"]
    retires = [d["replica"] for d in decisions if d["action"] == "retire"]
    assert rids == [0, 1] and retires == [2, 1]
    assert health == ["healthy", "retired", "retired"]
    assert stats["retires"] == 2


def test_controller_tighten_relax_hysteresis(engines):
    prompts = prompts_of((8, 9, 10, 7), seed=7)

    def run(k):
        tel = k.Telemetry()
        ctrl = k.a.SLOController(ttft_slo=1.0, window=6.0, eval_every=1,
                                 max_replicas=1, min_samples=1,
                                 relax_ratio=0.5, queue_high=0.5,
                                 idle_to_retire=1e9)
        router = k.r.ReplicaRouter([k.srv(tel)], telemetry=tel,
                                   autoscale=ctrl)
        out = router.run(requests(k, prompts))
        tight = router.shed_batch
        for t in range(12):
            router.step(float(200 + t))
        return (sorted(out), ctrl.decisions, tight, router.shed_batch,
                router.metrics.gauge("autoscale_admission_tight").value)
    got = both(run, engines)
    assert got["port"] == got["jax"]
    rids, decisions, tight, after, gauge = got["port"]
    actions = [d["action"] for d in decisions]
    assert rids == [0, 1, 2, 3] and "scale_up" not in actions
    assert tight is True and after is False and gauge == 0
    assert actions.index("relax") > actions.index("tighten")
    assert decisions[actions.index("tighten")]["shed_batch"] is True


def test_controller_off_is_bit_reference(engines):
    """autoscale=None and a controller that never triggers give the same
    streams, the solo ones, and the controller only noops."""
    prompts = prompts_of((6, 9, 12, 5), seed=8)
    refs = solo(engines, prompts, 6)

    def run(k):
        outs = []
        for ctrl in (None, k.a.SLOController(ttft_slo=1e9,
                                             idle_to_retire=1e9)):
            router = k.r.ReplicaRouter([k.srv(), k.srv()], autoscale=ctrl)
            outs.append((outcome(router, router.run(requests(k, prompts))),
                         ctrl.decisions if ctrl else None))
        return outs
    got = both(run, engines)
    assert got["port"] == got["jax"]
    (off, _), (on, decisions) = got["port"]
    assert off["results"] == on["results"] and off["health"] == on["health"]
    assert decisions and all(d["action"] == "noop" for d in decisions)
    for i, ref in enumerate(refs):
        np.testing.assert_array_equal(on["results"][i], ref)


def test_chaos_with_controller_active(engines):
    """Breaker trips and drains under seeded router.step faults with the
    controller ticking: the solo streams, the same decisions."""
    prompts = prompts_of((6, 9, 12, 5, 8, 10), seed=10)
    refs = solo(engines, prompts, 6)

    def run(k):
        with k.f.injected(k.f.Fault("router.step", "device_error", step=4,
                                    count=3), seed=0) as inj:
            ctrl = k.a.SLOController(**dict(BURST, max_replicas=4))
            router = k.r.ReplicaRouter(
                [k.srv(), k.srv()], replica_factory=lambda i, tag: k.srv(),
                autoscale=ctrl, breaker_threshold=2, telemetry=True)
            out = router.run(requests(k, prompts))
        return outcome(router, out), ctrl.decisions, list(inj.fired)
    got = both(run, engines)
    assert got["port"] == got["jax"]
    res, decisions, fired = got["port"]
    assert fired and decisions and res["stats"]["breaker_trips"] >= 1
    for i, ref in enumerate(refs):
        np.testing.assert_array_equal(res["results"][i], ref)


def test_decisions_rebuilt_from_the_trace(engines, tmp_path):
    """Every evaluation lands in the export as an ``autoscale`` instant
    with its metrics: ``read_fleet_trace`` on the port's export gives the
    JAX reader's summary of the JAX export, timestamps aside, and its
    decisions are the controller's."""
    prompts = prompts_of((6, 8, 10, 7, 9, 6, 8, 11), seed=11)

    def run(k):
        tel = k.Telemetry()
        ctrl = k.a.SLOController(**BURST)
        router = k.r.ReplicaRouter(
            [k.srv(tel)], replica_factory=lambda i, tag: k.srv(tel),
            telemetry=tel, autoscale=ctrl)
        router.run(requests(k, prompts))
        path = tel.export_trace(str(tmp_path / f"{k.r.__name__}.json"))
        return path, ctrl.decisions, dict(router.stats)

    def untimed(summary):
        def strip(rows):
            return [{k: v for k, v in r.items() if k != "ts"} for r in rows]
        out = dict(summary)
        for key in ("breaker", "drains", "restarts", "scale", "degraded"):
            out[key] = strip(summary[key])
        out["autoscale"] = dict(summary["autoscale"], decisions=strip(
            summary["autoscale"]["decisions"]))
        return out
    got = both(run, engines)
    path, decisions, stats = got["port"]
    summary = read_fleet_trace(path)
    assert untimed(summary) == untimed(analyze_fleet_trace(got["jax"][0],
                                                           quiet=True))
    assert untimed(read_fleet_trace(got["jax"][0])) == untimed(summary)
    traced = summary["autoscale"]["decisions"]
    assert len(traced) == len(decisions) == len(got["jax"][1])
    for t, want in zip(traced, decisions):
        assert {k: t[k] for k in want} == dict(want, at=want["at"])
    ups = summary["autoscale"]["by_action"]["scale_up"]
    assert ups == stats["scale_ups"] >= 1
    assert [s["replica"] for s in summary["scale"]
            if s["action"] == "add"] == list(range(1, 1 + ups))
    assert summary["dispatch"]["total"] == len(prompts)

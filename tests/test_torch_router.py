"""The port's replica router against the JAX package's on the CPU.

Both packages build the same fleet (replicas sharing one engine over the
same numpy float32 parameters, the ``SERVE_KW`` geometry, so each JAX
slot program compiles once for the module), under the same fault specs,
and drain the same seeded requests. Held equal: the router's tracer
records (dispatch order with replica and load, breaker transitions,
drains, restarts), the stats, the health of every replica, the streams
(and each equal to a solo ``generate``), the breaker's half-open window,
the checkpoint walk-back of a warm restart, ``fleet_snapshot`` and the
merged Prometheus text, and the fleet flight artifact as the port's
postmortem reader reads it. The watchdog case runs both packages on
``tests/test_torch_chaos.py FakeClock``, so the replicas read the same
step times on any host.
"""

import json
import re
import time
from types import SimpleNamespace

import numpy as np
import pytest

from deepspeed_tpu.inference import router as jrouter
from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.telemetry import Telemetry as JTelemetry
from deepspeed_tpu.utils import faults as jfaults
from deepspeed_tpu_torch.inference import router as trouter
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.telemetry import Telemetry as TTelemetry
from deepspeed_tpu_torch.tools import postmortem as tpostmortem
from deepspeed_tpu_torch.utils import faults as tfaults
from test_torch_chaos import clocks, engines  # noqa: F401
from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_serving import SERVE_KW
from test_torch_telemetry import _records

PKGS = (("jax", jserving, jrouter, jfaults, JTelemetry),
        ("port", tserving, trouter, tfaults, TTelemetry))


def prompts_of(lengths, seed=1):
    r = np.random.default_rng(seed)
    return [r.integers(1, 128, n).astype(np.int32) for n in lengths]


def solo(engines, prompts, n):
    """Solo greedy references (the port's ``generate``, which
    tests/test_torch_serving.py holds to the JAX one)."""
    return [engines["port"].generate(p[None], max_new_tokens=n)[0]
            for p in prompts]


def both(fn, engines, spec=()):
    """``fn(k)`` per package, where ``k`` carries the package's serving,
    router and faults modules, a fresh injector over ``spec`` (rows of
    ``Fault`` arguments), the engine and a ``fleet(n)`` maker. Returns
    {package name: fn's result}."""
    out = {}
    for name, smod, rmod, fmod, tel in PKGS:
        inj = fmod.FaultInjector([fmod.Fault(*f) for f in spec], seed=0)

        def fleet(n, _s=smod, _e=engines[name], **kw):
            return [_s.ServingEngine(_e, **dict(SERVE_KW, **kw))
                    for _ in range(n)]
        out[name] = fn(SimpleNamespace(s=smod, r=rmod, f=fmod, inj=inj,
                                       eng=engines[name], fleet=fleet,
                                       Telemetry=tel))
    return out


def requests(k, prompts, n=6, **kw):
    return [k.s.ServeRequest(rid=i, prompt=p, max_new_tokens=n, **kw)
            for i, p in enumerate(prompts)]


def router_records(router):
    """The router's tracer records without timestamps; a CRC value in a
    migration's fallback reason is the packages' own float bytes."""
    out = []
    for etype, rid, step, slot, data in _records(router):
        if "reason" in data:
            data["reason"] = re.sub(r"0x[0-9a-f]{8}", "0x*", data["reason"])
        out.append((etype, rid, step, slot, data))
    return out


def outcome(router, out=None):
    """What a fleet run left: results, each request's terminal state,
    the stats, the health and (with telemetry) the tracer records."""
    out = router.results() if out is None else out
    states = {r.rid: r.state for r in router._finished}
    for rep in router.replicas:
        states.update({r.rid: r.state for r in rep.srv.finished})
    return dict(results={rid: [int(t) for t in v] for rid, v in out.items()},
                states=states, stats=dict(router.stats),
                health=router.health(), records=router_records(router))


def assert_streams(out, refs):
    assert set(out) == set(range(len(refs)))
    for i, ref in enumerate(refs):
        np.testing.assert_array_equal(out[i], ref)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_constants_match_jax():
    assert trouter.HEALTH_CODES == jrouter.HEALTH_CODES
    assert trouter.ROLES == jrouter.ROLES
    assert trouter._ROUTER_STAT_FIELDS == jrouter._ROUTER_STAT_FIELDS


def test_dispatch_least_loaded_prefix_affinity_and_deadline(engines):
    """Least-loaded placement with the index tie-break; a same-prefix
    follow-up returns to its replica; a deadline skips affinity."""
    p = prompts_of((6, 7, 8, 9), seed=3)
    extra = prompts_of((5,), seed=8)[0]
    sys_a, sys_b = prompts_of((20, 20), seed=5)

    def run(k):
        fleet = k.fleet(2)
        router = k.r.ReplicaRouter(fleet, telemetry=True)
        fleet[0].submit(k.s.ServeRequest(rid="x0", prompt=p[0]))
        fleet[0].submit(k.s.ServeRequest(rid="x1", prompt=p[1]))
        router.submit(k.s.ServeRequest(rid="a", prompt=p[2]))
        router.submit(k.s.ServeRequest(rid="b", prompt=p[3]))
        router.submit(k.s.ServeRequest(rid="c", prompt=extra))
        router.submit(k.s.ServeRequest(rid="sb", prompt=sys_b))
        router.submit(k.s.ServeRequest(rid="sa1", prompt=sys_a))
        router.submit(k.s.ServeRequest(rid="sa2", prompt=sys_a.copy()))
        router.submit(k.s.ServeRequest(rid="sa3", prompt=sys_a.copy(),
                                       deadline=1e9))
        return ([[r.rid for r in f.queue] for f in fleet],
                dict(router.stats), router_records(router))
    got = both(run, engines)
    assert got["port"] == got["jax"]
    queues, stats, _ = got["port"]
    # sa2 follows sa1 by affinity (loads 4 and 3), sa3 has a deadline
    assert queues == [["x0", "x1", "c", "sa1", "sa2"], ["a", "b", "sb", "sa3"]]
    assert stats["dispatched"] == 7 and stats["affinity_hits"] == 1


def test_prefix_affinity_warms_shared_blocks(engines):
    """With the prefix cache on, affinity-routed traffic hits the shared
    blocks on its home replica; the streams are the solo ones."""
    sys_p = prompts_of((16,), seed=6)[0]
    tails = prompts_of((4, 4, 4), seed=7)
    prompts = [np.concatenate([sys_p, t]) for t in tails]
    refs = solo(engines, prompts, 4)

    def run(k):
        fleet = k.fleet(2, prefix_cache=True)
        router = k.r.ReplicaRouter(fleet, telemetry=True)
        reqs = requests(k, prompts, n=4)
        out = {}
        for r in reqs:
            router.submit(r)
            out.update(router.run())
        home = router._affinity[router._affinity_key(sys_p)]
        return (outcome(router, out),
                [dict(f.stats)["prefix_hits"] for f in fleet], home)
    got = both(run, engines)
    assert got["port"] == got["jax"]
    res, hits, home = got["port"]
    assert hits[home] >= 1
    assert_streams(res["results"], refs)


# ---------------------------------------------------------------------------
# the circuit breaker
# ---------------------------------------------------------------------------

def test_breaker_state_machine(engines):
    """healthy -> suspect -> healthy -> suspect -> broken at the
    threshold; the broken replica drains onto the survivor."""
    prompts = prompts_of((6, 9), seed=11)
    refs = solo(engines, prompts, 8)

    def run(k):
        fleet = k.fleet(2, faults=k.inj)
        router = k.r.ReplicaRouter(fleet, breaker_threshold=2,
                                   faults=k.inj, telemetry=True)
        for r in requests(k, prompts, n=8):
            fleet[0].submit(r)
        health = []
        for _ in range(4):
            router.step()
            health.append(router.health())
        out = router.run()
        return outcome(router, out), health, list(k.inj.fired)
    got = both(run, engines, spec=[("router.step", "device_error", 0),
                                   ("router.step", "device_error", 2, 2)])
    assert got["port"] == got["jax"]
    res, health, fired = got["port"]
    assert health == [["suspect", "healthy"], ["healthy", "healthy"],
                      ["suspect", "healthy"], ["broken", "healthy"]]
    assert res["stats"]["breaker_trips"] == 1
    assert res["stats"]["drained_requests"] == 2 and len(fired) == 3
    assert_streams(res["results"], refs)


def test_recovering_half_open_admissions(engines):
    """A recovering replica admits at most probe_admissions requests;
    the probe's clean completion closes the breaker."""
    p = prompts_of((5, 6, 7), seed=13)

    def run(k):
        fleet = k.fleet(2)
        router = k.r.ReplicaRouter(
            fleet, probe_admissions=1, telemetry=True,
            replica_factory=lambda i, tag: k.fleet(1)[0])
        router.replicas[0].health = "broken"
        router.restart_replica(0)
        after_restart = router.health()
        for i, q in enumerate(p):
            router.submit(k.s.ServeRequest(rid=f"p{i}", prompt=q))
        queues = [[r.rid for r in rep.srv.queue] for rep in router.replicas]
        router.run()
        return outcome(router), after_restart, queues
    got = both(run, engines)
    assert got["port"] == got["jax"]
    res, after_restart, queues = got["port"]
    assert after_restart == ["recovering", "healthy"]
    assert queues == [["p0"], ["p1", "p2"]]
    assert res["health"] == ["healthy", "healthy"]


def test_warm_restart_checkpoint_walkback(engines, tmp_path):
    """A crash breaks a replica; restart_replica skips the torn
    ``latest`` tag for the newest valid one, and a probe closes the
    breaker."""
    root = tmp_path / "ckpts"
    (root / "t_good" / "state").mkdir(parents=True)
    time.sleep(0.01)
    (root / "t_torn").mkdir()
    (root / "latest").write_text("t_torn")
    prompts = prompts_of((7, 8), seed=17)
    refs = solo(engines, prompts, 6)
    probe_p, ballast_p = prompts_of((5,), seed=19)[0], \
        prompts_of((5,), seed=23)[0]

    def run(k):
        calls = []

        def factory(idx, tag):
            calls.append((idx, tag))
            return k.fleet(1)[0]
        router = k.r.ReplicaRouter(k.fleet(2, faults=k.inj),
                                   replica_factory=factory,
                                   ckpt_dir=str(root), faults=k.inj,
                                   telemetry=True)
        out = router.run(requests(k, prompts, n=6))
        broken = router.health().index("broken")
        tag = router.restart_replica(broken)
        recovering = router.health()
        router.replicas[1 - broken].srv.submit(k.s.ServeRequest(
            rid="ballast", prompt=ballast_p, max_new_tokens=4))
        router.submit(k.s.ServeRequest(rid="probe", prompt=probe_p,
                                       max_new_tokens=4))
        on_broken = [r.rid for r in router.replicas[broken].srv.queue]
        router.run()
        return (outcome(router, out), tag, calls, recovering, on_broken,
                router.health())
    got = both(run, engines, spec=[("router.step", "crash", 1)])
    assert got["port"] == got["jax"]
    res, tag, calls, recovering, on_broken, health = got["port"]
    broken = recovering.index("recovering")
    assert tag == "t_good" and calls == [(broken, "t_good")]
    assert on_broken == ["probe"] and health == ["healthy", "healthy"]
    assert res["stats"]["restarts"] == 1
    assert_streams(res["results"], refs)


# ---------------------------------------------------------------------------
# drain parity under chaos
# ---------------------------------------------------------------------------

CHAOS = {
    "crash_mid_decode": ([("router.step", "crash", 7)], {}),
    "device_error_burst": ([("router.step", "device_error", 6, 7)], {}),
    "watchdog_degraded": ([("serving.decode", "slow", 5, 1, 0.05)],
                          dict(step_time_budget_s=0.01, watchdog_grace=1)),
    "dispatch_site_faults": ([("router.dispatch", "device_error", 1),
                              ("router.dispatch", "crash", 4)], {}),
    "drain_site_transient": ([("router.step", "crash", 7),
                              ("router.drain", "device_error", 0)], {}),
}


@pytest.mark.parametrize("case", sorted(CHAOS))
def test_drain_parity_matches_jax(engines, clocks, case):
    """Three replicas, six requests, the JAX test's fault spec: the same
    breaks, drains and dispatches in both packages, and every stream is
    the solo one."""
    spec, fleet_kw = CHAOS[case]
    prompts = prompts_of(tuple(5 + (i % 4) * 3 for i in range(6)), seed=29)
    refs = solo(engines, prompts, 8)

    def run(k):
        router = k.r.ReplicaRouter(k.fleet(3, faults=k.inj, **fleet_kw),
                                   faults=k.inj, telemetry=True)
        out = router.run(requests(k, prompts, n=8))
        return outcome(router, out), list(k.inj.fired)
    got = both(run, engines, spec=spec)
    assert got["port"] == got["jax"]
    res, fired = got["port"]
    assert fired
    assert_streams(res["results"], refs)
    assert set(res["states"].values()) == {"done"}
    st = res["stats"]
    if case != "device_error_burst":
        assert res["health"].count("broken") == 1
    if case == "crash_mid_decode":
        assert st["breaker_trips"] == 1 and st["drained_requests"] >= 1
    if case == "dispatch_site_faults":
        assert st["redispatches"] >= 1
    if case in ("device_error_burst", "watchdog_degraded",
                "drain_site_transient"):
        assert st["drained_requests"] >= 1


def test_all_broken_total_degrade(engines):
    """Every replica broken: one fleet DegradedError whose results and
    pending cover every rid once, and whose pending resumes in a fresh
    engine to the solo streams."""
    prompts = prompts_of((6, 9, 12, 5, 8), seed=31)
    refs = solo(engines, prompts, 8)

    def run(k):
        router = k.r.ReplicaRouter(k.fleet(3, faults=k.inj), faults=k.inj,
                                   telemetry=True)
        with pytest.raises(k.s.DegradedError) as ei:
            router.run(requests(k, prompts, n=8))
        e = ei.value
        fresh = k.fleet(1)[0]
        out = fresh.run([k.s.ServeRequest.from_snapshot(s)
                         for s in e.pending])
        out.update(e.results)
        return (router.health(), dict(router.stats),
                sorted(e.results), sorted(s["rid"] for s in e.pending),
                {rid: [int(t) for t in v] for rid, v in out.items()},
                router_records(router))
    got = both(run, engines, spec=[("router.step", "crash", 4, 1000)])
    assert got["port"] == got["jax"]
    health, stats, done, pending, out, _ = got["port"]
    assert health == ["broken"] * 3 and stats["fleet_degraded"] >= 1
    assert set(done) | set(pending) == set(range(5))
    assert not set(done) & set(pending)
    assert_streams(out, refs)


# ---------------------------------------------------------------------------
# fleet observability
# ---------------------------------------------------------------------------

def test_fleet_snapshot_and_merged_prometheus(engines):
    """fleet_snapshot and to_prometheus merge every registry of the fleet
    (a shared one counted once) with the fleet's shape attached."""
    prompts = prompts_of((6, 7, 8), seed=3)

    def run(k):
        tel_a, tel_b = k.Telemetry(), k.Telemetry()
        router = k.r.ReplicaRouter(
            [k.s.ServingEngine(k.eng, telemetry=tel_a, **SERVE_KW),
             k.s.ServingEngine(k.eng, telemetry=tel_b, **SERVE_KW)],
            telemetry=tel_a)
        for r in requests(k, prompts, n=4):
            router.submit(r, now=0.0)
        router.run()
        snap = router.fleet_snapshot()
        # the step-phase histograms time the host: their buckets and sums
        # are wall-clock, their counts compare
        prom = [ln for ln in router.to_prometheus().splitlines()
                if not re.match(r"serving_step_(\w+_)?s_(bucket|sum)", ln)]
        return (len(router.fleet_registries()), snap["fleet"],
                snap["counters"], snap["gauges"],
                snap["histograms"]["serving_ttft"], prom)
    got = both(run, engines)
    assert got["port"] == got["jax"]
    n_regs, fleet, counters, gauges, ttft, prom = got["port"]
    assert n_regs == 2 and fleet["by_state"]["healthy"] == 2
    assert counters["serving_completed"] == 3
    assert counters["router_dispatched"] == 3 and ttft["count"] == 3
    for name, _, _ in trouter._ROUTER_STAT_FIELDS:
        assert sum(ln.startswith(f"router_{name} ") for ln in prom) == 1
    assert "router_replicas_healthy 2" in prom
    assert any(ln.startswith("serving_ttft_bucket") for ln in prom)


def test_fleet_flight_artifact_read_by_the_port(engines, tmp_path):
    """A breaker break writes a router-label artifact bundling the
    replicas' costs and request rows; the port's postmortem reader reads
    it, and the JAX artifact of the same run, as the JAX reader does."""
    from tools import postmortem as jpostmortem
    prompts = prompts_of((5, 8, 11, 6), seed=17)

    def run(k):
        outdir = str(tmp_path / k.r.__name__)
        fleet = k.fleet(3, faults=k.inj, telemetry=k.Telemetry())
        router = k.r.ReplicaRouter(fleet, faults=k.inj,
                                   flight_recorder=True, flight_dir=outdir)
        router.run(requests(k, prompts, n=8))
        return router.flight.dumps[-1], dict(router.stats)
    got = both(run, engines, spec=[("router.step", "crash", 7)])
    assert got["port"][1] == got["jax"][1]
    for path, _ in got.values():
        body = tpostmortem.load_artifact(path)
        assert body == jpostmortem.load_artifact(path)
        assert body["label"] == "router"
        assert body["reason"].startswith("breaker:")
        assert set(body["costs"]) == {"r0", "r1", "r2"}
        assert any(row.get("replica") is not None
                   for row in body["requests"])
        summary = tpostmortem.analyze_postmortem(body, quiet=True)
        assert json.dumps(summary, sort_keys=True, default=str) == \
            json.dumps(jpostmortem.analyze_postmortem(body, quiet=True),
                       sort_keys=True, default=str)
        assert summary["incident"]["label"] == "router"
    # the two runs' artifacts carry the same request rows
    rows = [{(r["rid"], r["replica"], r["state"]) for r in
             tpostmortem.load_artifact(p)["requests"]}
            for p, _ in got.values()]
    assert rows[0] == rows[1]

"""The port's disaggregated prefill/decode fleet against the JAX package's
on the CPU.

A ``prefill`` replica parks each finished prefill in a ``handoff`` slot;
the router migrates its KV chain through the CRC-checked host staging
pool into a ``decode`` replica's free list, whose admission adopts it.
Both packages run the same fleets (the ``SERVE_KW`` geometry, so each JAX
slot program compiles once per pool mode) under the same fault specs.
Held equal: the streams (each equal to a solo ``generate``), the stats,
the router's tracer records and the caches' ``parked_*`` counters; and in
the port, every landed block (and its int8 scales) equal byte for byte
to the source block it was gathered from. Each ``router.migrate_*`` site
degrades to a cold re-prefill, a corrupted host block is caught by the
landing's CRC32 and never served, and the parked request's jump past a
blocked queue head is taken under a seeded open load from the port's
``load_gen``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import router as jrouter
from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.utils import faults as jfaults
from deepspeed_tpu_torch.inference import router as trouter
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.inference.paged_cache import to_numpy
from deepspeed_tpu_torch.tools import load_gen as tload_gen
from deepspeed_tpu_torch.utils import faults as tfaults
from test_torch_chaos import engines  # noqa: F401
from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_router import (outcome, prompts_of, requests, router_records,
                               solo)
from test_torch_serving import SERVE_KW
from tools import load_gen as jload_gen

PKGS = (("jax", jserving, jrouter, jfaults, jload_gen),
        ("port", tserving, trouter, tfaults, tload_gen))
POOLS = ("k", "v", "k_scale", "v_scale")


def both(fn, engines, spec=(), **fleet_kw):
    """``fn(k)`` per package (see tests/test_torch_router.py ``both``),
    with ``k.fleet(n)`` building replicas of ``SERVE_KW`` + ``fleet_kw``
    and ``k.lg`` the package's load generator."""
    out = {}
    for name, smod, rmod, fmod, lg in PKGS:
        inj = fmod.FaultInjector([fmod.Fault(*f) for f in spec], seed=0)

        def fleet(n, _s=smod, _e=engines[name], **kw):
            return [_s.ServingEngine(_e, **dict(SERVE_KW, **fleet_kw, **kw))
                    for _ in range(n)]
        out[name] = fn(SimpleNamespace(s=smod, r=rmod, f=fmod, inj=inj,
                                       eng=engines[name], fleet=fleet,
                                       lg=lg, port=name == "port"))
    return out


def host(pool, ids):
    """Blocks ``ids`` of a pool (either package's) as numpy."""
    if isinstance(pool, torch.Tensor):
        return to_numpy(pool[:, ids].contiguous())
    return np.asarray(pool)[:, ids]


def spy_migrations(router):
    """Record every landed migration: the source chain's blocks as the
    gather read them and the blocks as they landed, per pool."""
    log = []
    gathered = {}
    for rep in router.replicas:
        cache = rep.srv.cache

        def gather(slot, pool, _c=cache, _orig=cache.migrate_gather):
            chain = list(_c._owned[slot])
            handle = _orig(slot, pool)
            gathered[tuple(handle["keys"])] = [
                host(getattr(_c, n), chain) for n in POOLS
                if getattr(_c, n) is not None]
            return handle

        def land(rid, keys, pool, length, _c=cache, _orig=cache.land_parked):
            n = _orig(rid, keys, pool, length)
            ids = list(_c._parked[rid][0])
            log.append((rid, gathered[tuple(keys)],
                        [host(getattr(_c, n), ids) for n in POOLS
                         if getattr(_c, n) is not None]))
            return n
        cache.migrate_gather, cache.land_parked = gather, land
    return log


def assert_pools_clean(router):
    """Both sides' blocks balance after the fleet drains: nothing parked,
    nothing mid-transfer, no host staging key left."""
    for rep in router.replicas:
        st = rep.srv.cache.stats()
        assert st["parked_blocks"] == 0, (rep.idx, st)
        assert not rep.srv.cache._in_transfer, rep.idx
        assert st["free_blocks"] + st["cached_blocks"] \
            == st["num_blocks"], (rep.idx, st)
    assert len(router._mig_pool) == 0, "leaked host staging keys"


def parked_stats(router):
    return [{k: v for k, v in rep.srv.cache.stats().items()
             if k.startswith("parked_")} for rep in router.replicas]


# ---------------------------------------------------------------------------
# migration parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_migration_parity_matches_jax(engines, kv_quant):
    """Every request prefills on the prefill replica, migrates, and
    decodes on the decode replica with no fallback; the landed blocks
    are the gathered ones byte for byte (scales too)."""
    prompts = prompts_of((6, 9, 12, 8))
    refs = solo(engines, prompts, 6)

    def run(k):
        router = k.r.ReplicaRouter(k.fleet(2), roles=["prefill", "decode"],
                                   telemetry=True)
        log = spy_migrations(router)
        out = router.run(requests(k, prompts))
        assert_pools_clean(router)
        return outcome(router, out), parked_stats(router), log
    got = both(run, engines, kv_quant=kv_quant)
    (res, parked, log), (jres, jparked, jlog) = got["port"], got["jax"]
    assert res == jres and parked == jparked
    assert res["stats"]["migrations"] == 4
    assert res["stats"]["migration_fallbacks"] == 0
    assert parked == [{"parked_blocks": 0, "parked_adopted": 0,
                       "parked_aborts": 0},
                      {"parked_blocks": 0, "parked_adopted": 4,
                       "parked_aborts": 0}]
    if kv_quant == "off":
        for i, ref in enumerate(refs):
            np.testing.assert_array_equal(res["results"][i], ref)
    assert [rid for rid, _, _ in log] == [0, 1, 2, 3]
    for (rid, src, dst), (_, jsrc, _) in zip(log, jlog):
        assert len(src) == (4 if kv_quant == "int8" else 2)
        for a, b, j in zip(src, dst, jsrc):
            assert a.dtype == b.dtype and np.array_equal(a, b), rid
            if kv_quant == "off":
                np.testing.assert_allclose(a, j, rtol=1e-5, atol=1e-5)


def test_role_validation(engines):
    """The role vocabulary is closed and a fleet with prefill replicas
    needs a decode-capable one, with the JAX messages."""
    msgs = []
    for _, smod, rmod, _, _ in PKGS:
        eng = engines["port" if rmod is trouter else "jax"]
        fleet = [smod.ServingEngine(eng, **SERVE_KW) for _ in range(2)]
        row = []
        for roles in (["prefill", "archon"], ["prefill", "prefill"],
                      ["prefill"]):
            with pytest.raises(ValueError) as ei:
                rmod.ReplicaRouter(fleet, roles=roles)
            row.append(str(ei.value))
        msgs.append(row)
    assert msgs[0] == msgs[1]
    assert "role" in msgs[1][0] and "decode-" in msgs[1][1]


def test_snapshot_kv_handle_round_trips(engines):
    """A migration's resume entry carries ``kv_handle``, which
    ``from_snapshot`` ignores: the rebuilt request is the same."""
    req = tserving.ServeRequest(rid=3, prompt=prompts_of((5,))[0],
                                max_new_tokens=4, out=[7])
    entry = tserving.snapshot_entry(req, kv_handle={
        "blocks": 2, "length": 5, "src": 0, "dest": 1})
    back = tserving.ServeRequest.from_snapshot(entry)
    assert tserving.snapshot_entry(back) == tserving.snapshot_entry(req)
    jentry = jserving.snapshot_entry(jserving.ServeRequest.from_snapshot(
        entry), kv_handle=entry["kv_handle"])
    assert jentry == entry


# ---------------------------------------------------------------------------
# the degradation ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site,kind", [
    ("router.migrate_gather", "device_error"),
    ("router.migrate_scatter", "device_error"),
    ("router.migrate_corrupt", "cache_exhausted"),
    ("router.migrate_gather", "crash"),
    ("router.migrate_scatter", "crash"),
])
def test_migration_fault_degrades_cold_like_jax(engines, site, kind):
    """A fault at each migrate site (a crash breaks the acting end, so
    the fleet keeps a decode survivor) lands that request cold with the
    solo stream, counted in ``migration_fallbacks``, and leaks nothing."""
    prompts = prompts_of((6, 9, 12, 8))
    refs = solo(engines, prompts, 6)
    n, roles = (3, ["prefill", "decode", "decode"]) if kind == "crash" \
        else (2, ["prefill", "decode"])

    def run(k):
        router = k.r.ReplicaRouter(k.fleet(n), roles=roles, faults=k.inj,
                                   telemetry=True)
        out = router.run(requests(k, prompts))
        assert_pools_clean(router)
        return outcome(router, out), parked_stats(router), \
            list(k.inj.fired)
    got = both(run, engines, spec=[(site, kind, 0, 1)])
    assert got["port"] == got["jax"]
    res, _, fired = got["port"]
    assert fired and res["stats"]["migration_fallbacks"] >= 1
    for i, ref in enumerate(refs):
        np.testing.assert_array_equal(res["results"][i], ref)
    if kind == "crash":
        assert res["stats"]["breaker_trips"] == 1


def test_corrupt_block_detected_never_served(engines):
    """The corrupt site flips a stored byte: the landing's CRC32 check
    refuses it (the fallback's reason names it), no landed block was
    parked, and the request's stream is the solo one."""
    prompts = prompts_of((8,), seed=3)
    refs = solo(engines, prompts, 6)

    def run(k):
        router = k.r.ReplicaRouter(k.fleet(2), roles=["prefill", "decode"],
                                   faults=k.inj, telemetry=True)
        out = router.run(requests(k, prompts))
        return outcome(router, out), parked_stats(router)
    got = both(run, engines, spec=[("router.migrate_corrupt",
                                    "cache_exhausted", 0, 1)])
    assert got["port"] == got["jax"]
    res, parked = got["port"]
    falls = [d for e, _, _, _, d in res["records"]
             if e == "migrate" and not d.get("ok")]
    assert len(falls) == 1 and "CRC32" in falls[0]["reason"]
    assert parked[1]["parked_adopted"] == 0
    np.testing.assert_array_equal(res["results"][0], refs[0])


# ---------------------------------------------------------------------------
# retire and breaker against an in-flight migration
# ---------------------------------------------------------------------------

def test_retire_prefill_settles_handoffs_first(engines):
    """Retiring the prefill replica with a handoff parked migrates it
    first; the requests finish on the decode side with the solo streams."""
    prompts = prompts_of((6, 9))
    refs = solo(engines, prompts, 6)

    def run(k):
        fleet = k.fleet(2)
        router = k.r.ReplicaRouter(fleet, roles=["prefill", "decode"],
                                   telemetry=True)
        for req in requests(k, prompts):
            router.submit(req)
        for _ in range(16):
            fleet[0].step()
            if fleet[0].ready_handoffs():
                break
        parked = [s for s, _ in fleet[0].ready_handoffs()]
        router.retire_replica(0)
        out = router.run(max_steps=500)
        assert_pools_clean(router)
        return outcome(router, out), parked
    got = both(run, engines)
    assert got["port"] == got["jax"]
    res, parked = got["port"]
    assert parked and res["health"] == ["retired", "healthy"]
    assert res["stats"]["migrations"] >= 1
    for i, ref in enumerate(refs):
        np.testing.assert_array_equal(res["results"][i], ref)


def test_breaker_trip_mid_migration_lands_cold(engines):
    """A crash in the gather breaks the source: its drain resumes the cut
    migration cold on a survivor, with the solo streams and no leak."""
    prompts = prompts_of((6, 9, 12, 8))
    refs = solo(engines, prompts, 6)

    def run(k):
        router = k.r.ReplicaRouter(k.fleet(3),
                                   roles=["prefill", "decode", "decode"],
                                   faults=k.inj, telemetry=True)
        out = router.run(requests(k, prompts))
        assert_pools_clean(router)
        return outcome(router, out)
    got = both(run, engines, spec=[("router.migrate_gather", "crash", 0)])
    assert got["port"] == got["jax"]
    res = got["port"]
    assert res["stats"]["migration_fallbacks"] >= 1
    assert res["stats"]["breaker_trips"] >= 1
    for i, ref in enumerate(refs):
        np.testing.assert_array_equal(res["results"][i], ref)


def test_retire_last_decode_capable_refused(engines):
    """The fleet keeps a landing zone: retiring its only decode-capable
    replica raises; the prefill replica itself may retire."""
    def run(k):
        router = k.r.ReplicaRouter(k.fleet(2), roles=["prefill", "decode"])
        with pytest.raises(ValueError, match="decode-capable") as ei:
            router.retire_replica(1)
        router.retire_replica(0)
        return str(ei.value), router.health()
    got = both(run, engines)
    assert got["port"] == got["jax"]
    assert got["port"][1] == ["retired", "healthy"]


def test_prefill_only_engine_parks_and_releases(engines):
    """A prefill-only engine alone: the finished prefill emits the first
    token and parks in ``handoff`` (no decode step runs for it);
    ``release_handoff`` frees its blocks, once."""
    p = prompts_of((9,), seed=4)[0]

    def run(k):
        srv = k.fleet(1, prefill_only=True)[0]
        req = k.s.ServeRequest(rid="h", prompt=p, max_new_tokens=4)
        srv.submit(req)
        steps = 0
        while not srv.ready_handoffs():
            srv.step()
            steps += 1
        seen = (steps, req.state, list(req.out), req.first_token_at,
                [s for s, _ in srv.ready_handoffs()],
                dict(srv.stats)["decode_steps"])
        srv.step()                       # a parked slot never decodes
        return seen, list(req.out), srv.release_handoff("h"), \
            srv.release_handoff("h"), srv.cache.free_blocks, srv.busy
    got = both(run, engines)
    assert got["port"] == got["jax"]
    seen, out, first, again, free, busy = got["port"]
    assert seen[1] == "handoff" and len(seen[2]) == 1 and seen[5] == 0
    assert out == seen[2] and (first, again, busy) == (True, False, False)
    assert free == SERVE_KW["num_blocks"]


def test_parked_jump_under_bursty_open_load(engines):
    """A tier-1-sized open-load trace of the mixed mix (a burst, then a
    trickle) against one prefill and one decode replica: a cold request
    at the decode replica's queue head waits for blocks that parked
    chains behind it hold, and admission takes a parked request past it
    (counted here). Every stream is the solo one, as in JAX."""
    def run(k):
        entries = k.lg.make_requests(seed=2, mix="mixed",
                                     phases=[(4, 1.0), (6, 0.2)],
                                     vocab_size=128, max_prompt_len=40)
        fleet = k.fleet(2)
        router = k.r.ReplicaRouter(fleet, roles=["prefill", "decode"],
                                   telemetry=True)
        dest, jumps = fleet[1], []

        def adopt(slot, rid, _orig=dest.cache.adopt_parked):
            if dest.queue[0].rid != rid:
                jumps.append(rid)
            return _orig(slot, rid)
        dest.cache.adopt_parked = adopt
        res = k.lg.drive(router, entries, mode="open", include_tokens=True,
                         max_steps=3000)
        assert_pools_clean(router)
        return entries, res, jumps, dict(router.stats), \
            router_records(router)
    got = both(run, engines)
    assert got["port"][1:] == got["jax"][1:]
    entries, res, jumps, stats, _ = got["port"]
    assert len(entries) == 8 and jumps and stats["migrations"] >= 1
    refs = solo(engines, [np.asarray(e["prompt"], np.int32)
                          for e in entries], 16)
    for e, rec, ref in zip(entries, res["per_request"], refs):
        n = len(e["prompt"]) + int(e["max_new_tokens"])
        assert rec["state"] == "done"
        assert rec["tokens"] == [int(t) for t in ref[:n]], rec["rid"]

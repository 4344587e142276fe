"""The port's fault-tolerance layer against the JAX package on the CPU.

Both packages get the same numpy parameters and the same fault spec
string, parsed by each package's own ``parse_spec`` and installed as each
package's ambient injector, and drain the same seeded requests through one
tiny float32 engine pair in the ``SERVE_KW`` geometry of
``tests/test_torch_serving.py``. Held equal: the parsed faults, the
errors and the unknown-site warnings; the injector's schedule, log and
jitter; under injected faults the token streams (identical), the fired
log, the stats, the terminal states, the backoff pauses (``time.sleep``
recorded in each serving module), the ``DegradedError`` snapshots
(integers exactly, logprobs to 1e-5) and their resumption in a fresh
engine; and the degrade branches of the prefix cache, speculation, the
decode horizon and the host tier.

No test here depends on the host's load: each serving and faults module
gets a clock that only a sleep moves (:class:`FakeClock`), so a step takes
no time on it and a ``slow`` fault exactly its parameter, and the
watchdog reads the same elapsed times in both packages on any host.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import engine as jengine
from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.utils import faults as jfaults
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.utils import faults as tfaults
from test_torch_model import numpy_params, one_torch_thread  # noqa: F401
from test_torch_serving import CONFIGS, SERVE_KW

# (name, serving module, faults module) of each package
PKGS = (("jax", jserving, jfaults), ("port", tserving, tfaults))
LP_TOL = 1e-5


class FakeClock:
    """Stands in for the ``time`` module of a serving and a faults module:
    ``perf_counter`` reads a clock that only ``sleep`` moves, and ``sleep``
    records its pause instead of waiting."""

    def __init__(self):
        self.now = 0.0
        self.pauses = []

    def perf_counter(self):
        return self.now

    def sleep(self, seconds):
        self.pauses.append(seconds)
        self.now += seconds


@pytest.fixture(scope="module")
def engines(devices):
    """{package name: engine} over the same float32 parameters."""
    fields = CONFIGS["gpt2"]
    jcfg = jgpt.GPTConfig(**fields, dtype=jnp.float32,
                          use_flash_attention=False, remat=False)
    tcfg = tgpt.GPTConfig(**fields, dtype=torch.float32)
    npp = numpy_params(jcfg)
    return {"jax": jengine.InferenceEngine(
                config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, npp),
                dtype=jnp.float32),
            "port": init_inference(model=(tcfg, params_from_numpy(
                npp, tcfg, device="cpu")), dtype=torch.float32,
                device="cpu")}


@pytest.fixture
def clocks(monkeypatch):
    """A :class:`FakeClock` per package, in its serving and faults
    modules."""
    out = {}
    for name, smod, fmod in PKGS:
        out[name] = FakeClock()
        monkeypatch.setattr(smod, "time", out[name])
        monkeypatch.setattr(fmod, "time", out[name])
    return out


def prompts_of(lengths, seed=1, vocab=128):
    r = np.random.default_rng(seed)
    return [r.integers(1, vocab, n).astype(np.int32) for n in lengths]


def requests(smod, prompts, n_new, **kw):
    return [smod.ServeRequest(rid=i, prompt=p, max_new_tokens=n_new, **kw)
            for i, p in enumerate(prompts)]


def serve(smod, eng, reqs, **kw):
    """A fault-free drain of ``reqs``; returns the engine."""
    srv = smod.ServingEngine(eng, **SERVE_KW, **kw)
    srv.run(reqs)
    return srv


def outcome(srv, reqs=None):
    """What a drain left: per rid its state and tokens, the stats."""
    reqs = srv.finished if reqs is None else reqs
    return ({r.rid: (r.state, list(map(int, r.tokens))) for r in reqs},
            dict(srv.stats))


def both(fn, engines, spec="", seed=0):
    """``fn(smod, eng)`` in each package with the ``spec`` faults as its
    ambient injector; returns {name: (fn's result, the fired log)}."""
    got = {}
    for name, smod, fmod in PKGS:
        with fmod.injected(*fmod.parse_spec(spec), seed=seed) as inj:
            got[name] = (fn(smod, engines[name]), list(inj.fired))
    return got


def assert_entries_equal(got, ref):
    """Snapshot entries: every field exactly, logprobs to LP_TOL."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        np.testing.assert_allclose(g["out_logprobs"], r["out_logprobs"],
                                   rtol=LP_TOL, atol=LP_TOL)
        assert {k: v for k, v in g.items() if k != "out_logprobs"} == \
            {k: v for k, v in r.items() if k != "out_logprobs"}


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------

def test_kinds_sites_and_snapshot_fields_match_jax():
    assert tfaults.KINDS == jfaults.KINDS
    assert tfaults.KNOWN_SITES == jfaults.KNOWN_SITES
    assert tserving.TERMINAL_STATES == jserving.TERMINAL_STATES
    assert tserving.SNAPSHOT_EPHEMERAL == jserving.SNAPSHOT_EPHEMERAL
    for name in ("FaultError", "TransientDeviceError", "InjectedCrash",
                 "UnknownFaultSiteWarning"):
        t, j = getattr(tfaults, name), getattr(jfaults, name)
        assert [c.__name__ for c in t.__mro__] == \
            [c.__name__ for c in j.__mro__]


@pytest.mark.parametrize("spec", [
    "serving.decode:device_error@3;cache.ensure:cache_exhausted@5*2~0.5",
    "engine.decode:slow@0~0.1, checkpoint.commit:crash@2",
    " ; serving.horizon:device_error@1*3;", "",
    "no-colon-here", "serving.decode:meteor_strike@0",
    "serving.decode:crash@x", "serving.decode:slow@1~fast",
    "serving.decode:crash@1*two"])
def test_parse_spec_matches_jax(spec):
    """The same faults, or the same error message, from both parsers."""
    got = []
    for fmod in (tfaults, jfaults):
        try:
            got.append([(f.site, f.kind, f.step, f.count, f.param)
                        for f in fmod.parse_spec(spec)])
        except ValueError as e:
            got.append(str(e))
    assert got[0] == got[1]


def test_unknown_site_warns_once_like_jax():
    """A typo'd site warns once per site in each package, with the same
    message; known sites parse quietly."""
    got = []
    for fmod in (tfaults, jfaults):
        fmod._warned_sites.discard("serving.prefil")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fmod.parse_spec("serving.prefil:crash@0;serving.prefil:slow@1")
            fmod.parse_spec("serving.prefil:crash@0;serving.decode:crash@0")
        got.append([(w.category.__name__, str(w.message)) for w in caught])
    assert got[0] == got[1] and len(got[0]) == 1
    assert got[0][0][0] == "UnknownFaultSiteWarning"
    assert "serving.prefil" in got[0][0][1]


def _injector_ops(fmod):
    seen = []
    inj = fmod.FaultInjector([fmod.Fault("s", "slow", step=1, count=2),
                              fmod.Fault("a", "device_error"),
                              fmod.Fault("b", "crash"),
                              fmod.Fault("c", "cache_exhausted")], seed=42)
    heard = []
    inj.add_listener(lambda *a: heard.append(a))
    seen.append([getattr(inj.visit("s"), "kind", None) for _ in range(4)])
    for site in ("a", "b", "c", "c"):
        try:
            f = inj.fire(site)
            seen.append(None if f is None else f.kind)
        except fmod.FaultError as e:
            seen.append((type(e).__name__, str(e)))
    seen += [list(inj.fired), heard[:], dict(inj.visits)]
    seen.append([inj.jitter(0.5) for _ in range(5)])
    inj.reset()
    seen += [inj.fired, [inj.jitter(0.5) for _ in range(5)]]
    env = fmod.FaultInjector.from_env({"DS_FAULTS": "x.y:crash@2",
                                       "DS_FAULT_SEED": "7"})
    seen.append(([(f.site, f.kind, f.step) for f in env.faults], env.seed,
                 fmod.FaultInjector.from_env({}).faults))
    base = fmod.active()
    with fmod.injected(fmod.Fault("q", "slow"), seed=5) as inj:
        seen.append((fmod.active() is inj, inj.seed))
    seen.append(fmod.active() is base)
    return seen


def test_injector_schedule_log_jitter_and_env_match_jax():
    """The visit schedule, the raised kinds, the fired log, the listeners,
    the seeded jitter (a ``numpy.random.default_rng``, number for number),
    ``reset``, ``from_env`` and ``injected`` behave alike."""
    got, ref = _injector_ops(tfaults), _injector_ops(jfaults)
    assert got == ref
    assert got[0] == [None, "slow", "slow", None]


# ---------------------------------------------------------------------------
# serving under chaos
# ---------------------------------------------------------------------------

CHAOS = ("serving.prefill:device_error@1;serving.decode:device_error@2;"
         "engine.decode:device_error@4;serving.decode:slow@6~0.005;"
         "cache.ensure:cache_exhausted@5")


def test_chaos_drain_matches_jax(engines, clocks):
    """The chaos drain of tests/test_chaos.py: cache exhaustion, device
    errors at the serving and engine sites and a slow step, all from one
    seeded spec. Both packages give the fault-free streams, exactly one
    terminal state per request, the same fired log, stats, backoff pauses
    and tracer ``fault`` records."""
    prompts = prompts_of((5, 9, 12, 3))

    def run(smod, eng):
        srv = smod.ServingEngine(eng, max_retries=3, retry_backoff_s=0.001,
                                 telemetry=True, **SERVE_KW)
        srv.run(requests(smod, prompts, 6))
        faults = [(r[1], r[3], r[5]) for r in
                  srv.telemetry.tracer.records() if r[1] == "fault"]
        return outcome(srv), faults

    clean = both(run, engines)
    chaos = both(run, engines, CHAOS)
    assert chaos["port"] == chaos["jax"]
    assert clocks["port"].pauses == clocks["jax"].pauses
    (done, stats), faults = chaos["port"][0]
    assert {rid: s for rid, (s, _) in done.items()} == {
        i: "done" for i in range(4)}
    assert done == clean["port"][0][0][0] == clean["jax"][0][0][0]
    assert stats["retries"] == 3 and stats["evictions"] >= 1
    # three backoff pauses, and the slow fault's sleep
    assert sorted(clocks["port"].pauses)[-1] == 0.005
    assert len(clocks["port"].pauses) == 4
    fired = chaos["port"][1]
    assert {k for _, k, _ in fired} == {"device_error", "cache_exhausted",
                                        "slow"}
    assert [(d["site"], d["kind"], d["visit"]) for _, _, d in faults] == fired


def test_deadlines_time_out_slot_holders_and_queued_requests(engines):
    """A slot holder past its deadline retires as ``timeout`` with a
    prefix of its stream and frees its blocks; a queued request past its
    deadline never takes a slot; the rest is untouched, in both
    packages alike."""
    p1, p2, p3 = prompts_of((6, 7, 8), seed=5)

    def run(smod, eng):
        srv = smod.ServingEngine(eng, **SERVE_KW)
        srv.run([smod.ServeRequest(rid="t", prompt=p1, max_new_tokens=30,
                                   deadline=4.0),
                 smod.ServeRequest(rid="ok", prompt=p2, max_new_tokens=8),
                 smod.ServeRequest(rid="q", prompt=p3, max_new_tokens=4,
                                   deadline=2.0)])
        return outcome(srv), bool(srv.cache.active.any())

    got = both(run, engines)
    assert got["port"] == got["jax"]
    (done, stats), active = got["port"][0]
    assert not active and stats["timeouts"] == 2
    assert done["q"] == ("timeout", list(p3))
    assert done["t"][0] == "timeout" and len(p1) < len(done["t"][1]) < 36
    assert done["ok"][0] == "done"
    ref = engines["port"].generate(p1[None], 30)[0].tolist()
    assert done["t"][1] == ref[:len(done["t"][1])]


def test_bounded_queue_sheds_the_newest(engines):
    """``max_queue``: a submit into a full queue is answered ``shed`` at
    once; the backpressure gauge reads the queue's fullness, 0 after the
    drain, in both packages alike."""
    prompts = prompts_of((5, 6, 7, 4), seed=8)

    def run(smod, eng):
        srv = smod.ServingEngine(eng, max_queue=2, **SERVE_KW)
        seen = []
        for r in requests(smod, prompts, 4):
            seen.append((srv.submit(r), srv.stats["backpressure"]))
        srv.run()
        return seen, outcome(srv), srv.stats["backpressure"]

    got = both(run, engines)
    assert got["port"] == got["jax"]
    seen, (done, stats), bp = got["port"][0]
    assert seen == [(True, 0.5), (True, 1.0), (False, 1.0), (False, 1.0)]
    assert [done[i][0] for i in range(4)] == ["done", "done", "shed", "shed"]
    assert done[2][1] == list(prompts[2]) and stats["shed"] == 2
    assert bp == 0.0


def test_retry_exhaustion_propagates(engines, clocks):
    """A fault that outlasts ``max_retries`` surfaces as the package's
    TransientDeviceError after the same retries and pauses."""
    p = prompts_of((6,), seed=15)[0]

    def run(smod, eng):
        srv = smod.ServingEngine(eng, max_retries=2, retry_backoff_s=0.001,
                                 **SERVE_KW)
        try:
            srv.run([smod.ServeRequest(rid=0, prompt=p, max_new_tokens=5)])
        except Exception as e:
            return type(e).__name__, str(e), dict(srv.stats)

    got = both(run, engines, "serving.decode:device_error@0*10")
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == "TransientDeviceError"
    assert got["port"][0][2]["retries"] == 2
    assert clocks["port"].pauses == clocks["jax"].pauses
    assert len(clocks["port"].pauses) == 2


def test_backoff_capped_by_the_tightest_slot_deadline(engines, clocks):
    """With ``retry_backoff_s=5`` each pause would be 0.5 s; a slot
    holder 0.25 ticks from its deadline caps every pause at 0.25, and the
    request then times out with its tokens, in both packages alike."""
    pd, pn = prompts_of((7, 5), seed=41)

    def run(smod, eng):
        srv = smod.ServingEngine(eng, max_retries=3, retry_backoff_s=5.0,
                                 **SERVE_KW)
        srv.run([smod.ServeRequest(rid="d", prompt=pd, max_new_tokens=20,
                                   deadline=3.25),
                 smod.ServeRequest(rid="n", prompt=pn, max_new_tokens=8)])
        return outcome(srv)

    got = both(run, engines, "serving.decode:device_error@3*3")
    assert got["port"] == got["jax"]
    assert clocks["port"].pauses == clocks["jax"].pauses == [0.25] * 3
    done, stats = got["port"][0]
    assert done["d"][0] == "timeout" and done["n"][0] == "done"
    assert stats["retries"] == 3 and stats["timeouts"] == 1


def test_watchdog_degraded_error_keeps_everything(engines, clocks):
    """Two decode dispatches over budget in a row (a ``slow`` fault of
    0.05 s against a 0.01 s budget, on the fake clock) raise the
    package's DegradedError after the step's bookkeeping: the finished
    results, the snapshot of the work in flight and the stats are the
    JAX engine's, and stepping on drains to the fault-free streams."""
    p1, p2 = prompts_of((6, 9), seed=12)
    spec = "serving.decode:slow@4*2~0.05"

    def run(smod, eng):
        srv = smod.ServingEngine(eng, step_time_budget_s=0.01,
                                 watchdog_grace=2, telemetry=True,
                                 **SERVE_KW)
        reqs = [smod.ServeRequest(rid="a", prompt=p1, max_new_tokens=12,
                                  logprobs=True),
                smod.ServeRequest(rid="b", prompt=p2, max_new_tokens=3)]
        try:
            srv.run(reqs)
            raise AssertionError("the watchdog did not trip")
        except smod.DegradedError as e:
            err = (str(e), {k: v.tolist() for k, v in e.results.items()},
                   [r.rid for r in e.finished], e.pending, e.stats)
        out = srv.run()
        events = [(r[1], r[3], r[5]) for r in srv.telemetry.tracer.records()
                  if r[1] in ("watchdog", "degraded")]
        return err, outcome(srv, reqs), events

    got = both(run, engines, spec)
    clean = outcome(serve(tserving, engines["port"], [
        tserving.ServeRequest(rid="a", prompt=p1, max_new_tokens=12),
        tserving.ServeRequest(rid="b", prompt=p2, max_new_tokens=3)]))[0]
    (msg, results, finished, pending, stats), after, events = \
        got["port"][0]
    jerr, jafter, jevents = got["jax"][0]
    assert (msg, results, finished, stats) == \
        (jerr[0], jerr[1], jerr[2], jerr[4])
    assert_entries_equal(pending, jerr[3])
    assert "over budget" in msg and [p["rid"] for p in pending] == ["a"]
    assert 0 < pending[0]["generated"] < 12 and pending[0]["slot"] == 0
    assert stats["watchdog_trips"] == 2 and finished == ["b"]
    assert after == jafter and events == jevents
    assert [e[0] for e in events] == ["watchdog", "watchdog", "degraded"]
    assert after[0] == clean
    assert got["port"][1] == got["jax"][1] == [
        ("serving.decode", "slow", 4), ("serving.decode", "slow", 5)]


def test_pending_snapshot_resumes_into_a_fresh_engine(engines, clocks):
    """The degraded engine's ``pending_snapshot(release=True)`` is the
    JAX engine's (and frees every block); its entries, rebuilt by
    ``ServeRequest.from_snapshot``, finish in a fresh engine with the
    undisturbed streams."""
    prompts = prompts_of((6, 9, 12), seed=43)

    def run(smod, eng):
        srv = smod.ServingEngine(eng, step_time_budget_s=0.01,
                                 watchdog_grace=1, **SERVE_KW)
        try:
            srv.run(requests(smod, prompts, 8, logprobs=True))
            raise AssertionError("the watchdog did not trip")
        except smod.DegradedError as e:
            err = e
        snap = srv.pending_snapshot(release=True)
        freed = (srv.cache.held_blocks, bool(srv.queue),
                 bool((srv.cache._refcount == 0).all()))
        fresh = smod.ServingEngine(eng, **SERVE_KW)
        out = fresh.run([smod.ServeRequest.from_snapshot(s) for s in snap])
        out.update(err.results)
        return snap, freed, {k: v.tolist() for k, v in out.items()}, \
            [r.state for r in fresh.finished]

    got = both(run, engines, "serving.decode:slow@3~0.05")
    snap, freed, out, states = got["port"][0]
    jsnap, jfreed, jout, jstates = got["jax"][0]
    assert_entries_equal(snap, jsnap)
    assert {s["rid"] for s in snap} and freed == jfreed == (0, False, True)
    assert states == jstates and set(states) == {"done"}
    assert out == jout and len(out) == 3
    ref = serve(tserving, engines["port"], requests(tserving, prompts, 8))
    assert out == {r.rid: r.tokens.tolist() for r in ref.finished}
    entry = snap[0]
    again = tserving.snapshot_entry(tserving.ServeRequest.from_snapshot(
        entry), **{k: entry[k] for k in ("slot", "queue_pos") if k in entry})
    assert {k: v for k, v in again.items() if k != "state"} == \
        {k: v for k, v in entry.items() if k != "state"}


def test_sampled_snapshot_resumes_its_draws(engines, clocks):
    """A sampled request resumed from the snapshot continues its draws
    (keyed by its seed and the tokens it emitted): the port's resumed
    streams and logprobs are its undisturbed ones. The draws are the
    port's own, not JAX's bits (ROADMAP's parity conventions), so this
    holds the port to itself."""
    prompts = prompts_of((6, 9, 12), seed=44)
    reqs = lambda: requests(tserving, prompts, 8, logprobs=True,  # noqa: E731
                            temperature=0.7, seed=3)
    with tfaults.injected(*tfaults.parse_spec("serving.decode:slow@5~0.05")):
        srv = tserving.ServingEngine(engines["port"], step_time_budget_s=0.01,
                                     watchdog_grace=1, **SERVE_KW)
        with pytest.raises(tserving.DegradedError) as ei:
            srv.run(reqs())
    snap = srv.pending_snapshot(release=True)
    assert snap and all(s["temperature"] == 0.7 for s in snap)
    fresh = serve(tserving, engines["port"],
                  [tserving.ServeRequest.from_snapshot(s) for s in snap])
    got = {r.rid: (r.tokens.tolist(), r.out_logprobs)
           for r in ei.value.finished + fresh.finished}
    ref = serve(tserving, engines["port"], reqs())
    assert len(got) == 3
    for r in ref.finished:
        assert got[r.rid][0] == r.tokens.tolist()
        np.testing.assert_allclose(got[r.rid][1], r.out_logprobs,
                                   rtol=LP_TOL, atol=LP_TOL)


def test_non_drain_raises_degraded_error(engines):
    """``run`` past ``max_steps`` raises DegradedError with the finished
    results and the work in flight, as in JAX."""
    p1, p2 = prompts_of((5, 6), seed=17)

    def run(smod, eng):
        srv = smod.ServingEngine(eng, **SERVE_KW)
        try:
            srv.run([smod.ServeRequest(rid="slow", prompt=p1,
                                       max_new_tokens=30),
                     smod.ServeRequest(rid="quick", prompt=p2,
                                       max_new_tokens=2)], max_steps=5)
        except smod.DegradedError as e:
            return str(e), sorted(e.results), [p["rid"] for p in e.pending]

    got = both(run, engines)
    assert got["port"] == got["jax"]
    assert got["port"][0][1:] == (["quick"], ["slow"])


# ---------------------------------------------------------------------------
# the extensions' degrade branches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_prefix_cache_fault_sites(engines, kv_quant):
    """``cache.match`` serves one admission as a cold miss, ``cache.cow``
    fails a copy-on-write admission before any bookkeeping moves (it
    retries at the next step), a device error rides along: the same
    streams, hits, copies and stats as JAX, and no leaked reference."""
    base = np.arange(1, 31, dtype=np.int32)
    div = base.copy()
    div[21] = 99                         # diverges inside a block
    spec = ("cache.match:cache_exhausted@1;cache.cow:cache_exhausted@0;"
            "serving.decode:device_error@2")

    def run(smod, eng):
        srv = smod.ServingEngine(eng, prefix_cache=True, kv_quant=kv_quant,
                                 retry_backoff_s=0.0, **SERVE_KW)
        for i, p in enumerate((base, base, div)):
            srv.run([smod.ServeRequest(rid=i, prompt=p, max_new_tokens=6)])
        return (outcome(srv), srv.cache.cow_copies, srv.cache.held_blocks,
                bool((srv.cache._refcount == 0).all()))

    got = both(run, engines, spec)
    assert got["port"] == got["jax"]
    (done, stats), cow, held, clean = got["port"][0]
    assert stats["prefix_hits"] == 1 and cow == 1 and stats["retries"] == 1
    assert held == 0 and clean
    assert {s for s, _, _ in got["port"][1]} == {
        "cache.match", "cache.cow", "serving.decode"}
    cold = serve(tserving, engines["port"], [
        tserving.ServeRequest(rid=i, prompt=p, max_new_tokens=6)
        for i, p in enumerate((base, base, div))], kv_quant=kv_quant)
    assert done == outcome(cold)[0]


@pytest.mark.parametrize("site", ["engine.verify", "serving.spec_draft"])
def test_spec_faults_degrade_to_plain_decode(engines, site):
    """A draft or verify fault degrades that step to plain decode
    (``spec_fallbacks``), which then runs: the spec-off streams and the
    JAX engine's counters."""
    prompts = prompts_of((5, 9, 12, 3))

    def run(smod, eng, spec=True):
        srv = smod.ServingEngine(eng, spec_decode=spec, spec_k=2,
                                 **SERVE_KW)
        srv.run(requests(smod, prompts, 8))
        return outcome(srv)

    got = both(run, engines, f"{site}:device_error@1*3")
    assert got["port"] == got["jax"]
    done, stats = got["port"][0]
    assert stats["spec_fallbacks"] == 3
    assert stats["decode_steps"] > stats["spec_steps"]
    assert stats["completed"] == len(prompts)
    off = serve(tserving, engines["port"], requests(tserving, prompts, 8))
    assert done == outcome(off)[0]


def test_horizon_fault_and_deadline_clamp(engines):
    """``serving.horizon`` degrades a horizon to one token
    (``horizon_fallbacks``) with the N = 1 streams; a deadline caps a
    slot's horizon budget, so the timed-out partial stream is N = 1's;
    both as in JAX."""
    prompts = prompts_of((5, 9, 12, 3))
    p1, p2 = prompts_of((6, 7), seed=5)

    def run(smod, eng, n=4):
        srv = smod.ServingEngine(eng, decode_horizon=n, **SERVE_KW)
        srv.run(requests(smod, prompts, 10))
        dl = smod.ServingEngine(eng, decode_horizon=n, **SERVE_KW)
        dl.run([smod.ServeRequest(rid="t", prompt=p1, max_new_tokens=30,
                                  deadline=4.0),
                smod.ServeRequest(rid="ok", prompt=p2, max_new_tokens=8)])
        return outcome(srv), outcome(dl)

    got = both(run, engines, "serving.horizon:device_error@1*3")
    assert got["port"] == got["jax"]
    (done, stats), (dl_done, dl_stats) = got["port"][0]
    assert stats["horizon_fallbacks"] == 3
    assert got["port"][1] == [("serving.horizon", "device_error", v)
                              for v in (1, 2, 3)]
    one = both(lambda smod, eng: run(smod, eng, n=1), engines)["port"][0]
    assert done == one[0][0]
    assert dl_done == one[1][0] and dl_done["t"][0] == "timeout"
    assert dl_stats["timeouts"] == 1


SYS_A = np.arange(1, 25, dtype=np.int32)
SYS_B = np.arange(60, 84, dtype=np.int32)


def tier_workload():
    """A-A-A B-B-B A-A over two 24-token system prompts: A's chain
    spills while B runs and restores when A returns."""
    def fam(sys_prompt, n, seed):
        r = np.random.default_rng(seed)
        return [np.concatenate([sys_prompt, r.integers(30, 58, 4).astype(
            np.int32)]) for _ in range(n)]
    return fam(SYS_A, 3, 0) + fam(SYS_B, 3, 1) + fam(SYS_A, 2, 2)


@pytest.mark.parametrize("site", ["cache.spill", "cache.restore",
                                  "cache.host_corrupt"])
def test_host_tier_fault_sites(engines, site):
    """A failed spill stays on the device behind the daemon's backoff, a
    failed restore cuts the match (the tail re-prefills, the host entry
    survives), a corrupted host block fails its CRC32 and its chain
    re-prefills: the tier-off streams and the JAX engine's host counters
    in every case."""
    prompts = tier_workload()

    def run(smod, eng, tier=True):
        srv = smod.ServingEngine(eng, prefix_cache=True, host_tier=tier,
                                 spill_watermark=99, **SERVE_KW)
        for i, p in enumerate(prompts):
            srv.run([smod.ServeRequest(rid=i, prompt=p, max_new_tokens=6)])
        return (outcome(srv), srv.cache.held_blocks,
                bool((srv.cache._refcount == 0).all()))

    got = both(run, engines, f"{site}:cache_exhausted@0")
    assert got["port"] == got["jax"]
    assert got["port"][1] == [(site, "cache_exhausted", 0)]
    (done, stats), held, clean = got["port"][0]
    assert held == 0 and clean and stats["host_spills"] > 0
    if site != "cache.spill":
        assert stats["host_restore_failures"] >= 1
    off = both(lambda smod, eng: run(smod, eng, tier=False), engines)
    assert done == off["port"][0][0][0]


def test_fault_listener_does_not_keep_a_dropped_engine(engines):
    """A telemetry-on engine listens on the ambient injector, which
    outlives it: the port's listener holds the engine weakly, so a dropped
    engine and its pools are freed, while a live one still records the
    ``fault``. The JAX engine's bound-method listener keeps it alive (a
    reference fault the port does not copy, ROADMAP.md section 3)."""
    import gc
    import weakref
    alive = {}
    for name, smod, fmod in PKGS:
        with fmod.injected(*fmod.parse_spec("cache.adapter_load:slow@0")) as inj:
            srv = smod.ServingEngine(engines[name], telemetry=True,
                                     **SERVE_KW)
            inj.fire("cache.adapter_load")
            assert [r[1] for r in srv.telemetry.tracer.records()] == \
                ["fault"]
            ref = weakref.ref(srv)
            del srv
            gc.collect()
            alive[name] = ref() is not None
            inj.fire("cache.adapter_load")
    assert alive == {"port": False, "jax": True}

"""The port's serving telemetry against the JAX package's, on the CPU in
float32.

The registry, tracer and breakdown get the same operations in both
packages and must give the same numbers, Prometheus text and Chrome
trace. Then both serving engines drain the same traffic on the internal
step clock (``now=None``) with telemetry on, through each path the port
serves: an evict/requeue drain, the prefix cache with copy-on-write,
speculative decode, the decode horizon at N = 8 and the host tier with a
spill, a restore and a corrupted restore, in both pool modes where the
port's tests of that path run both. What is held equal, artifact by
artifact:

- stats: ``list(srv.stats)`` (the order too) and every value;
- the registry: counter and gauge values, and of every histogram on the
  step clock the bucket counts, sum and count; the Prometheus text of
  every family not on the wall clock;
- the tracer: ``(etype, rid, step, slot, fields)`` of every record, the
  timestamps and the wall-clock fields dropped; the exported trace read
  by the JAX package's ``tools/trace_analyze.py`` and by the port's
  ``read_serving_trace`` gives the same spans, states and phases;
- costs: ``costs.snapshot()`` integer for integer, and
  ``cost_registry.to_json()`` entry for entry.

The sampled KV-quantization error (``serving_kv_quant_error``) is a value
read from the int8 scale pools, which the two packages round alike only
to the float32 tier: its bucket counts are equal and its sum agrees to
1e-5. Wall clock, never compared: the breakdown's ``serving_step_*`` histograms
and ``step_phase`` seconds, the host tier's ``kv_host_restore_ms`` and
``cache_restore`` ms. The cost cards and ``program_*`` gauges include the
LoRA twins (``_l``, ``_ql``) in both packages.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.inference import engine as jengine
from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.utils import monitor as jmonitor
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.utils import monitor as tmonitor
from test_torch_model import numpy_params, one_torch_thread  # noqa: F401
from test_torch_serving import CONFIGS, SERVE_KW
from tools.trace_analyze import analyze_serving_trace

WALL_FIELDS = {"step_phase": None, "cache_restore": ("ms",)}
VALUE_HIST = "serving_kv_quant_error"


@pytest.fixture(scope="module")
def pair():
    fields = CONFIGS["gpt2"]
    jcfg = jgpt.GPTConfig(**fields, dtype=jnp.float32,
                          use_flash_attention=False, remat=False)
    tcfg = tgpt.GPTConfig(**fields, dtype=torch.float32)
    npp = numpy_params(jcfg)
    jeng = jengine.InferenceEngine(
        config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, npp),
        dtype=jnp.float32)
    teng = init_inference(model=(tcfg, params_from_numpy(npp, tcfg,
                                                         device="cpu")),
                          dtype=torch.float32, device="cpu")
    return jeng, teng


def prompts_of(lengths, vocab=128, seed=1):
    r = np.random.default_rng(seed)
    return [r.integers(1, vocab, n).astype(np.int32) for n in lengths]


# ---------------------------------------------------------------------------
# the registry, tracer and breakdown alone
# ---------------------------------------------------------------------------

def _fill(mod, buckets):
    reg = mod.MetricsRegistry()
    reg.counter("requests_total", "requests").inc(3)
    reg.gauge("queue_depth").set(2.5)
    h = reg.histogram("latency_s", "latency", buckets=buckets)
    vals = np.random.default_rng(4).gamma(2.0, 0.3, 200)
    for i, v in enumerate(vals):
        h.observe(float(v), at=float(i))
    return reg, h


@pytest.mark.parametrize("ladder", ["default", "rate", "temp", "custom"])
def test_registry_matches_jax(ladder):
    buckets = {"default": None, "rate": "RATE_BUCKETS",
               "temp": "TEMP_BUCKETS", "custom": (0.25, 0.5, 1.0)}[ladder]
    regs = []
    for mod in (jtel, ttel):
        b = getattr(mod, buckets) if isinstance(buckets, str) else buckets
        regs.append(_fill(mod, b))
    (jr, jh), (tr, th) = regs
    assert tr.to_prometheus() == jr.to_prometheus()
    assert tr.snapshot() == jr.snapshot()
    assert tr.to_scalars(5) == jr.to_scalars(5)
    assert th.counts == jh.counts and th.uppers == jh.uppers
    for q in (1, 50, 90, 99):
        assert th.percentile(q) == jh.percentile(q)
    for window in (None, 50.0):
        assert th.window_summary(window) == jh.window_summary(window)
    merged = [mod.merge_registries([r, r]) for mod, r in
              ((jtel, jr), (ttel, tr))]
    assert merged[1].to_prometheus() == merged[0].to_prometheus()
    assert merged[1].histogram("latency_s").window_summary(20.0) == \
        merged[0].histogram("latency_s").window_summary(20.0)


def test_monitor_takes_histogram_summaries_as_jax(tmp_path, monkeypatch):
    """Registry scalars, histogram summaries included, go through each
    package's Monitor into the same ``tag/p50`` style JSONL rows."""
    monkeypatch.setattr(jmonitor, "_try_tensorboard_writer", lambda d: None)
    monkeypatch.setattr(tmonitor, "_tensorboard_writer", lambda d: None)
    rows = []
    for mod, mon in ((jtel, jmonitor), (ttel, tmonitor)):
        reg = mod.MetricsRegistry()
        reg.counter("serving_completed").inc(4)
        h = reg.histogram("serving_ttft", buckets=(1.0, 2.0, 4.0))
        for v in (0.5, 1.5, 3.0):
            h.observe(v)
        m = mon.Monitor(output_path=str(tmp_path / mod.__name__),
                        job_name="tele")
        m.write_scalars(reg.to_scalars(step=7))
        m.close()
        with open(tmp_path / mod.__name__ / "tele" / "scalars.jsonl") as f:
            rows.append([json.loads(line) for line in f])
    assert rows[1] == rows[0]
    assert {"serving_ttft/p50", "serving_ttft/count"} <= \
        {r["tag"] for r in rows[1]}


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


def _lifecycle(tracer):
    tracer.event("enqueue", rid="a", step=0, queue_len=0)
    tracer.event("enqueue", rid="b", step=0, queue_len=1)
    tracer.event("admit", rid="a", step=0, slot=0, matched=4, evictions=0)
    tracer.event("prefill_chunk", rid="a", step=0, slot=0, start=4, n=8)
    tracer.event("prefill_done", rid="a", step=1, slot=0)
    tracer.event("first_token", rid="a", step=1, slot=0)
    tracer.event("evict", rid="a", step=2, slot=0, generated=1)
    tracer.event("cow", src=3, dst=5)
    tracer.event("admit", rid="a", step=3, slot=1, matched=0, evictions=1)
    tracer.event("step_phase", step=4, admission_s=0.001, decode_s=0.002,
                 total_s=0.003, occupancy=1)
    tracer.event("finish", rid="a", step=5, slot=1, state="done",
                 generated=3)


@pytest.mark.parametrize("capacity", [64, 5])
def test_tracer_and_chrome_trace_match_jax(tmp_path, capacity):
    tracers = [mod.RequestTracer(capacity=capacity, clock=_Clock())
               for mod in (jtel, ttel)]
    for t in tracers:
        _lifecycle(t)
    jt, tt = tracers
    assert tt.records() == jt.records() and tt.dropped == jt.dropped
    assert tt.events_of("a") == jt.events_of("a")
    jc, tc = jt.to_chrome_trace(), tt.to_chrome_trace()
    # the process row's name is each package's own
    jc["traceEvents"][0]["args"]["name"] = "serving"
    tc["traceEvents"][0]["args"]["name"] = "serving"
    assert tc == jc
    summaries = [analyze_serving_trace(jt.export(str(tmp_path / "j.json")),
                                       quiet=True),
                 ttel.read_serving_trace(tt.export(str(tmp_path /
                                                       "t.json")))]
    assert summaries[1] == summaries[0]
    tt.reset()
    assert tt.records() == [] and tt.dropped == 0


def test_step_breakdown_samples_every_nth_step():
    reg = ttel.MetricsRegistry()
    tr = ttel.RequestTracer()
    bd = ttel.StepBreakdown(reg, tr, sample_every=4)
    syncs = []
    for step in range(8):
        sampled = bd.begin(step, sync=lambda: syncs.append(1))
        assert sampled == (step % 4 == 0)
        for ph in ("admission", "prefill", "decode"):
            bd.lap(ph)
        bd.finish(occupancy=2)
    # the barrier runs at begin and at each of the four laps, on the two
    # sampled steps only
    assert len(syncs) == 2 * 5
    assert reg.histogram("serving_step_decode_s").count == 2
    assert reg.histogram("serving_step_s").count == 2
    phases = [r for r in tr.records() if r[1] == "step_phase"]
    assert [r[3] for r in phases] == [0, 4]
    assert phases[0][5]["occupancy"] == 2
    assert set(phases[0][5]) == {"admission_s", "prefill_s", "decode_s",
                                 "bookkeeping_s", "total_s", "occupancy"}
    off = ttel.NoopBreakdown()
    assert not off.begin(0, sync=lambda: syncs.append(1))
    assert len(syncs) == 10


@pytest.mark.parametrize("env,flag,want", [
    (None, None, False), ("on", None, True), ("off", None, False),
    (None, True, True), ("on", False, False)])
def test_resolve_telemetry_like_jax(monkeypatch, env, flag, want):
    if env is None:
        monkeypatch.delenv("DS_TELEMETRY", raising=False)
    else:
        monkeypatch.setenv("DS_TELEMETRY", env)
    assert ttel.resolve_telemetry(flag) is jtel.resolve_telemetry(flag) \
        is want


# ---------------------------------------------------------------------------
# serving drains against the JAX engine
# ---------------------------------------------------------------------------

def _host_traffic(mod, n_sys=4, per=3, seed=5):
    """``tests/test_torch_host_tier.py``'s traffic: 4 system prompts of 3
    blocks, 3 requests each in round robin, 4 new tokens."""
    r = np.random.default_rng(seed)
    systems = [r.integers(1, 128, 12) for _ in range(n_sys)]
    reqs = []
    for i in range(n_sys * per):
        p = np.concatenate([systems[i % n_sys],
                            r.integers(1, 128, int(r.integers(3, 7)))])
        reqs.append(mod.ServeRequest(rid=i, prompt=p.astype(np.int32),
                                     max_new_tokens=4))
    return reqs


def _prefix_traffic(mod):
    """A shared 10-token prefix, diverging mid-block (copy-on-write), a
    full repeat and an unrelated prompt."""
    base = prompts_of((10,), seed=31)[0]
    tails = prompts_of((5, 3, 6), seed=32)
    prompts = [np.concatenate([base, tails[0]]),
               np.concatenate([base[:7], tails[1]]),
               np.concatenate([base, tails[0]]),
               np.concatenate([base[:9], tails[2]]),
               prompts_of((8,), seed=33)[0]]
    return [mod.ServeRequest(rid=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(prompts)]


DRAINS = {
    # the tight pool: decode growth forces a preemption and a requeue
    "evict": dict(knobs={}, watermark=0),
    "evict_int8": dict(knobs={"kv_quant": "int8"}, watermark=0),
    "prefix": dict(knobs={"prefix_cache": True}),
    "prefix_int8": dict(knobs={"prefix_cache": True, "kv_quant": "int8"}),
    "spec": dict(knobs={"spec_decode": True, "spec_k": 2}),
    "horizon8": dict(knobs={"decode_horizon": 8}),
    "host_tier": dict(knobs={"prefix_cache": True, "host_tier": True,
                             "num_blocks": 14}),
    "host_tier_int8": dict(knobs={"prefix_cache": True, "host_tier": True,
                                  "num_blocks": 14, "kv_quant": "int8"}),
}


def _requests(mod, name):
    if name.startswith("evict"):
        p1, p2 = prompts_of((30, 28), seed=9)
        return [mod.ServeRequest(rid="a", prompt=p1, max_new_tokens=22),
                mod.ServeRequest(rid="b", prompt=p2, max_new_tokens=20)]
    if name.startswith("prefix"):
        return _prefix_traffic(mod)
    if name == "spec":
        return [mod.ServeRequest(rid=i, prompt=np.tile(p, 3),
                                 max_new_tokens=8)
                for i, p in enumerate(prompts_of((4, 5, 3), seed=7))]
    if name == "horizon8":
        return [mod.ServeRequest(rid=i, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts_of((6, 11, 4), seed=3))]
    return _host_traffic(mod)


def drain(mod, eng, name, telemetry=True):
    spec = DRAINS[name]
    tel = mod.Telemetry(sample_every=4) if telemetry is True else telemetry
    srv = mod.ServingEngine(eng, telemetry=tel,
                            **dict(SERVE_KW, **spec["knobs"]))
    if "watermark" in spec:
        srv.cache.watermark = spec["watermark"]
    reqs = _requests(mod, name)
    out = {}
    if name.startswith("host_tier"):
        # the first half leaves chains on the host; one entry is
        # corrupted before the rest arrive
        out = srv.run(reqs[:6])
        srv.cache.host_pool.corrupt(next(iter(srv.cache.host_pool._entries)))
        reqs = reqs[6:]
    out.update(srv.run(reqs))
    return srv, {k: v.tolist() for k, v in out.items()}


@pytest.fixture(scope="module")
def drains(pair):
    """Each drain once per package, the port's also with telemetry off."""
    jeng, teng = pair
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (drain(jserving, jeng, name),
                           drain(tserving, teng, name),
                           drain(tserving, teng, name, telemetry=False))
        return cache[name]
    return get


def _wall(name):
    return name.startswith("serving_step_") or name == "kv_host_restore_ms"


def _families(text):
    """Prometheus text by family: {name: its lines}."""
    fams, cur = {}, None
    for line in text.splitlines():
        if line.startswith("# HELP "):
            cur = line.split()[2]
        elif line.startswith("# TYPE "):
            cur = line.split()[2]
        fams.setdefault(cur, []).append(line)
    return fams


def _records(srv):
    out = []
    for _, etype, rid, step, slot, data in srv.telemetry.tracer.records():
        data = dict(data or {})
        if etype in WALL_FIELDS:
            drop = WALL_FIELDS[etype]
            data = {k: v for k, v in data.items()
                    if not (k.endswith("_s") if drop is None
                            else k in drop)}
        out.append((etype, rid, step, slot, data))
    return out


@pytest.mark.parametrize("name", sorted(DRAINS))
def test_drain_telemetry_matches_jax(drains, name, tmp_path):
    (js, jout), (ts, tout), (off, off_out) = drains(name)
    assert tout == jout
    # off mode is the same tokens with nothing recorded
    assert off_out == tout
    assert off.telemetry.tracer.records() == []
    # stats: the keys in order, the values
    assert list(ts.stats) == list(js.stats)
    assert dict(ts.stats) == dict(js.stats)
    assert list(off.stats) == list(js.stats)
    assert dict(off.stats) == dict(js.stats)
    # the registry
    jm, tm = js.metrics, ts.metrics
    assert list(tm._counters) == list(jm._counters)
    assert {n: c.value for n, c in tm._counters.items()} == \
        {n: c.value for n, c in jm._counters.items()}
    jg = {n: g.value for n, g in jm._gauges.items()}
    assert list(tm._gauges) == list(jg)
    assert {n: g.value for n, g in tm._gauges.items()} == jg
    assert list(tm._histograms) == list(jm._histograms)
    for n, h in jm._histograms.items():
        th = tm._histograms[n]
        assert th.uppers == h.uppers and th.count == h.count, n
        if n == VALUE_HIST:
            assert th.counts == h.counts
            np.testing.assert_allclose(th.sum, h.sum, rtol=1e-5)
        elif not _wall(n):
            assert (th.counts, th.sum) == (h.counts, h.sum), n
    jf, tf = _families(jm.to_prometheus()), _families(tm.to_prometheus())
    assert set(tf) == set(jf)
    for n in tf:
        if n == VALUE_HIST:
            assert [x for x in tf[n] if "_sum " not in x] == \
                [x for x in jf[n] if "_sum " not in x]
        elif not _wall(n):
            assert tf[n] == jf[n], n
    # the tracer, and its export read back
    assert _records(ts) == _records(js)
    assert ts.telemetry.tracer.dropped == 0
    summaries = []
    for srv, read in ((js, lambda p: analyze_serving_trace(p, quiet=True)),
                      (ts, ttel.read_serving_trace)):
        path = str(tmp_path / f"{id(srv)}.json")
        s = read(srv.telemetry.export_trace(path))
        for r in s["requests"].values():
            del r["span_us"]
        s["phase_us"] = sorted(s["phase_us"])
        summaries.append(s)
    assert summaries[1] == summaries[0]
    assert all(r["state"] == "done"
               for r in summaries[1]["requests"].values())
    # costs
    assert ts.costs.snapshot() == js.costs.snapshot()
    for r in ts.finished:
        jr = next(q for q in js.finished if q.rid == r.rid)
        assert r.cost == jr.cost
    jp = js.cost_registry.to_json()["programs"]
    tp = ts.cost_registry.to_json()["programs"]
    assert set(jp) == set(tp)
    for pid, entry in tp.items():
        assert {k: v for k, v in entry.items() if k != "attr"} == \
            {k: v for k, v in jp[pid].items() if k != "attr"}, pid


def test_drains_exercise_their_paths(drains):
    """Each drain reaches what it is there for."""
    got = {name: drains(name)[1][0] for name in DRAINS}
    for name in ("evict", "evict_int8"):
        st = got[name].stats
        assert st["evictions"] >= 1
        assert any(r[1] == "evict" for r in
                   got[name].telemetry.tracer.records())
    assert got["evict_int8"].metrics.histogram(
        "serving_kv_quant_error").count > 0
    for name in ("prefix", "prefix_int8"):
        etypes = {r[1] for r in got[name].telemetry.tracer.records()}
        assert "cow" in etypes and got[name].stats["prefix_hits"] >= 2
    assert got["spec"].stats["spec_steps"] > 0
    assert got["spec"].stats["spec_accepted"] > 0
    assert got["horizon8"].metrics.histogram(
        "serving_horizon_tokens").count > 0
    for name in ("host_tier", "host_tier_int8"):
        srv = got[name]
        etypes = [r[1] for r in srv.telemetry.tracer.records()]
        assert {"cache_spill", "cache_restore",
                "cache_restore_corrupt"} <= set(etypes)
        assert srv.stats["host_restore_failures"] == 1
        assert srv.metrics.histogram("kv_host_restore_ms").count == \
            srv.stats["host_restores"] > 0


def test_stats_view_is_read_only_and_registry_backed(drains):
    srv = drains("evict")[1][0]
    assert list(srv.stats) == [k for k, _, _ in jserving._STAT_FIELDS]
    with pytest.raises(TypeError):
        srv.stats["steps"] = 99
    assert srv.stats["completed"] == srv.metrics.snapshot()[
        "counters"]["serving_completed"] == 2
    for key in ("timeouts", "shed", "retries", "watchdog_trips",
                "backpressure", "spec_fallbacks", "horizon_fallbacks",
                "adapter_hits", "adapter_loads", "adapter_evictions",
                "adapter_load_errors"):
        assert srv.stats[key] == 0


def test_off_mode_keeps_only_the_stats(pair):
    _, teng = pair
    srv = tserving.ServingEngine(teng, telemetry=False, **SERVE_KW)
    srv.run([tserving.ServeRequest(rid="n", prompt=prompts_of((8,))[0],
                                   max_new_tokens=6)])
    assert isinstance(srv.telemetry, ttel.NoopTelemetry)
    assert srv.metrics is not None and not srv.metrics._histograms
    assert srv.metrics.names() == [f"serving_{k}" for k, kind, _ in
                                   jserving._STAT_FIELDS if kind == "c"] + \
        [f"serving_{k}" for k, kind, _ in jserving._STAT_FIELDS
         if kind == "g"]
    assert srv.stats["completed"] == 1
    assert srv.cache.tracer is None
    t0 = time.perf_counter()
    ev = srv.telemetry.tracer.event
    for i in range(50_000):
        ev("enqueue", rid=i, step=i)
    assert time.perf_counter() - t0 < 0.5
    assert srv.telemetry.tracer.records() == []


def test_shared_telemetry_and_env_flag(pair, monkeypatch):
    """A ``Telemetry`` instance is used as it is; ``DS_TELEMETRY=on``
    turns the plane on when the knob is None, and the knob wins."""
    _, teng = pair
    tel = ttel.Telemetry()
    srv = tserving.ServingEngine(teng, telemetry=tel, **SERVE_KW)
    assert srv.telemetry is tel and srv.metrics is tel.registry
    assert srv.cache.tracer is tel.tracer
    monkeypatch.setenv("DS_TELEMETRY", "on")
    assert tserving.ServingEngine(teng, **SERVE_KW).telemetry.enabled
    assert not tserving.ServingEngine(teng, telemetry=False,
                                      **SERVE_KW).telemetry.enabled


def test_flight_recorder_waits_for_the_fault_tolerance_slice(pair,
                                                            monkeypatch):
    """The fault-tolerance slice ported the flight recorder: its knobs and
    flags resolve to the JAX engine's recorder (on or off, and its
    directory); the artifacts themselves are tests/test_torch_flight.py's."""
    jeng, teng = pair

    def recorders(**kw):
        return [(s.flight.enabled, s.flight.outdir) for s in (
            mod.ServingEngine(eng, num_slots=1, **kw)
            for mod, eng in ((tserving, teng), (jserving, jeng)))]

    for kw in ({}, dict(flight_recorder=True),
               dict(flight_recorder=True, flight_dir="flight"),
               dict(flight_recorder=False, flight_dir="flight")):
        got = recorders(**kw)
        assert got[0] == got[1], kw
        assert got[0][0] is bool(kw.get("flight_recorder"))
    monkeypatch.setenv("DS_FLIGHT_RECORDER", "on")
    monkeypatch.setenv("DS_FLIGHT_DIR", "from-env")
    got = recorders()
    assert got[0] == got[1] == (True, "from-env")
    assert recorders(flight_recorder=False)[0][0] is False
    assert ttel.FlightRecorder is ttel.flight.FlightRecorder

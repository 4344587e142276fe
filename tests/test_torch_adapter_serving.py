"""The port's multi-tenant LoRA serving against the JAX package on the CPU.

Both packages get the same numpy base parameters and the same numpy
adapter exports (``block/<target>/lora_{a,b,scale}``, the
``runtime/lora.py`` format), and drain the same seeded requests. Held
equal, float32: the streams (identical, and identical to a solo
``generate`` of the adapter merged into the weights), the slot programs'
logits and pools under ``lora=`` (rtol/atol 1e-5), ``AdapterPool``
validation errors and ``stats()``, the ``adapter_*`` stats, the gauges,
the tracer records and the cost records, exactly. A base-only request in
a ``lora_serve=True`` engine gives the LoRA-off stream and logprobs bit
for bit.

The JAX engines of this module share one geometry per program family
(``SERVE_KW`` with a pool of two rank-4 blocks; ``spec_k`` 3; the int8
pools at ``decode_horizon`` 4), so each LoRA program compiles once. The
router's adapter affinity runs a two-replica fleet of each package. Not
covered here: the JAX compile-count contract (the port compiles
nothing).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import adapters as jadapters
from deepspeed_tpu.inference import engine as jengine
from deepspeed_tpu.inference import router as jrouter
from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.utils import faults as jfaults
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference import adapters as tadapters
from deepspeed_tpu_torch.inference import router as trouter
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.runtime import lora as tlora
from deepspeed_tpu_torch.utils import faults as tfaults
from test_torch_model import numpy_params, one_torch_thread  # noqa: F401
from test_torch_serving import CONFIGS, SERVE_KW
from test_torch_telemetry import _records

TOL = dict(rtol=1e-5, atol=1e-5)
LORA_KW = dict(SERVE_KW, lora_serve=True, lora_pool_blocks=2,
               lora_max_rank=4, lora_rank_block=4)
SPEC_K = 3
PKGS = (("jax", jserving, jfaults), ("port", tserving, tfaults))


def adapter_export(npp, seed, rank=4, scale_b=0.05):
    """A seeded adapter on every dense target of the numpy tree ``npp``,
    in the export format. B is noise (``add_lora``'s B = 0 would be a
    no-op adapter), so an adapted stream really leaves the base one."""
    rng = np.random.default_rng(seed)
    out = {}
    for t in tlora.DEFAULT_TARGETS:
        entry = npp["block"].get(t)
        if entry is None:
            continue
        L, din, dout = entry["kernel"].shape
        out[f"block/{t}/lora_a"] = (rng.standard_normal((L, din, rank))
                                    / np.sqrt(rank)).astype(np.float32)
        out[f"block/{t}/lora_b"] = (rng.standard_normal((L, rank, dout))
                                    * scale_b).astype(np.float32)
        out[f"block/{t}/lora_scale"] = np.full((L,), 2.0, np.float32)
    return out


def adapted_tree(npp, sd):
    """``npp`` with the export ``sd`` attached to its entries."""
    block = {k: dict(v) for k, v in npp["block"].items()}
    for key, val in sd.items():
        _, t, leaf = key.split("/")
        block[t][leaf] = val
    return dict(npp, block=block)


@pytest.fixture(scope="module")
def stack(devices):
    """The engine pair over the gpt2-dialect float32 parameters, three
    adapter exports and each adapter merged into a port engine (the solo
    ``generate`` references)."""
    fields = CONFIGS["gpt2"]
    jcfg = jgpt.GPTConfig(**fields, dtype=jnp.float32,
                          use_flash_attention=False, remat=False)
    tcfg = tgpt.GPTConfig(**fields, dtype=torch.float32)
    npp = numpy_params(jcfg)

    def port_engine(tree):
        return init_inference(model=(tcfg, params_from_numpy(
            tree, tcfg, device="cpu")), dtype=torch.float32, device="cpu")
    sds = {f"t{i}": adapter_export(npp, seed=i) for i in (1, 2, 3)}
    merged = {aid: init_inference(model=(tcfg, tlora.merge_lora(
        params_from_numpy(adapted_tree(npp, sd), tcfg, device="cpu"))),
        dtype=torch.float32, device="cpu") for aid, sd in sds.items()}
    return SimpleNamespace(
        npp=npp, tcfg=tcfg, sds=sds, merged=merged,
        jax=jengine.InferenceEngine(
            config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, npp),
            dtype=jnp.float32),
        port=port_engine(npp))


def prompts_of(lengths, seed):
    r = np.random.default_rng(seed)
    return [r.integers(1, 128, n).astype(np.int32) for n in lengths]


def ref_of(stack, aid, prompt, n):
    """The solo greedy stream of ``prompt`` under adapter ``aid`` merged
    into the weights (None: the base model)."""
    eng = stack.port if aid is None else stack.merged[aid]
    return eng.generate(prompt[None], max_new_tokens=n)[0]


def serve(stack, pkg, jobs, aids=("t1", "t2", "t3"), faults=None, **kw):
    """Drain ``jobs`` ((rid, prompt, new, adapter_id) rows) through a
    fresh serving engine of package ``pkg`` with ``aids`` registered.
    Returns (engine, {rid: tokens}, {rid: request})."""
    mod = jserving if pkg == "jax" else tserving
    args = dict(LORA_KW, **kw)
    if faults is not None:
        args["faults"] = faults
    srv = mod.ServingEngine(getattr(stack, pkg), **args)
    if srv.adapters is not None:
        for aid in aids:
            srv.register_adapter(aid, stack.sds[aid])
    reqs = {rid: mod.ServeRequest(rid=rid, prompt=p, max_new_tokens=n,
                                  adapter_id=aid, logprobs=True)
            for rid, p, n, aid in jobs}
    out = srv.run(list(reqs.values()))
    return srv, out, reqs


def assert_same_streams(a, b):
    assert sorted(a, key=str) == sorted(b, key=str)
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid], err_msg=str(rid))


# ---------------------------------------------------------------------------
# the adapter pool: validation, paging, refcounts, LRU
# ---------------------------------------------------------------------------

def _bad_exports(stack):
    sd = stack.sds["t1"]
    return {
        "rank above max_rank": adapter_export(stack.npp, seed=9, rank=8),
        "unexpected key": {"not/an/export/key": np.zeros(3)},
        "unknown target": {"block/warp_core/lora_a": np.zeros(3)},
        "missing leaf": {k: v for k, v in sd.items() if "lora_a" not in k},
        "shape": {k: (v[:, :-1] if k.endswith("lora_a") else v)
                  for k, v in sd.items()},
        "mixed ranks": dict(sd, **{
            k: v for k, v in adapter_export(stack.npp, seed=9,
                                            rank=2).items()
            if k.startswith("block/qkv/")}),
        "empty": {},
    }


@pytest.mark.parametrize("case", sorted(
    ["rank above max_rank", "unexpected key", "unknown target",
     "missing leaf", "shape", "mixed ranks", "empty"]))
def test_register_validation_matches_jax(stack, case):
    """Each malformed export fails with the JAX pool's error and message;
    registration alone moves nothing into the device pool."""
    bad = _bad_exports(stack)[case]
    msgs = []
    for pool in (jadapters.AdapterPool(stack.jax, pool_blocks=2, max_rank=4,
                                       rank_block=4),
                 tadapters.AdapterPool(stack.port, pool_blocks=2, max_rank=4,
                                       rank_block=4)):
        with pytest.raises(ValueError) as err:
            pool.register("bad", bad)
        msgs.append(str(err.value))
        pool.register("t1", stack.sds["t1"])
        assert pool.registered() == ["t1"]
        assert pool.stats()["resident"] == 0 and pool.stats()["loads"] == 0
    assert msgs[1] == msgs[0]


def test_pool_paging_refcounts_lru_match_jax(stack):
    """The JAX test's acquire/release sequence on both pools: the same
    rows, errors and ``stats()`` after every step, a hit's row the
    resident one, an evicted adapter's blocks reused."""
    pools = (jadapters.AdapterPool(stack.jax, pool_blocks=2, max_rank=4,
                                   rank_block=4),
             tadapters.AdapterPool(stack.port, pool_blocks=2, max_rank=4,
                                   rank_block=4))
    for pool in pools:
        assert pool.blocks_per_adapter == 1
        for aid, src in (("t0", "t1"), ("t1", "t2"), ("t2", "t1")):
            pool.register(aid, stack.sds[src])
    script = [("acquire", "never-registered"), ("acquire", "t0"),
              ("acquire", "t1"), ("acquire", "t0"), ("release", "t0"),
              ("acquire", "t2"), ("release", "t0"), ("acquire", "t2"),
              ("release", "t1"), ("acquire", "t0"), ("release", "t1")]
    for op, aid in script:
        got = []
        for pool in pools:
            try:
                res = getattr(pool, op)(aid)
                got.append(("ok", None if res is None
                            else np.asarray(res).tolist()))
            except Exception as e:          # the error is the result here
                got.append((type(e).__name__, str(e)))
            got[-1] += (pool.stats(),)
        assert got[1] == got[0], (op, aid)
    st = pools[1].stats()
    assert (st["evictions"], st["loads"], st["hits"]) == (2, 4, 1)
    # the port's pool on the host: t0's reload wrote its chunk into the
    # block t1 left, and block 0 stayed zero
    row = pools[1]._row("t0")
    a = pools[1].a_pool["qkv"]
    assert not a[:, 0].any()
    np.testing.assert_array_equal(a[:, int(row[0])].numpy(),
                                  stack.sds["t1"]["block/qkv/lora_a"])
    np.testing.assert_allclose(
        pools[1].b_pool["mlp_out"][:, int(row[0])].numpy(),
        np.asarray(pools[0].b_pool["mlp_out"][:, int(row[0])]), **TOL)


# ---------------------------------------------------------------------------
# the slot programs under lora=
# ---------------------------------------------------------------------------

def test_slot_programs_with_adapters_match_jax(stack):
    """``prefill_into_slot``, ``decode_slots`` and ``verify_slots`` with
    ``lora=`` (a slot under t1, one base-only): the JAX ``_l`` programs'
    logits and pools, to 1e-5."""
    outs = []
    for name, mod, _ in PKGS:
        srv = mod.ServingEngine(getattr(stack, name), **LORA_KW)
        srv.register_adapter("t1", stack.sds["t1"])
        eng, c, pool = srv.engine, srv.cache, srv.adapters
        rows = np.stack([pool.acquire("t1"),
                         np.zeros(pool.blocks_per_adapter, np.int32)])
        got = {}
        for slot, p in enumerate(prompts_of((7, 5), seed=31)):
            c.allocate(slot, 12)
            chunk = np.zeros(8, np.int32)
            chunk[:len(p)] = p
            out = eng.prefill_into_slot(c.k, c.v, c.tables[slot], chunk, 0,
                                        len(p), lora=pool.lora_args(
                                            rows[slot]))
            got[f"prefill{slot}"] = out[0]
            c.k, c.v = out[1:]
            c.advance(slot, len(p))
        toks = np.array([11, 12], np.int32)
        active = np.ones(2, bool)
        out = eng.decode_slots(c.k, c.v, c.tables, c.lengths, toks, active,
                               lora=pool.lora_args(rows))
        got["decode"] = out[0]
        c.k, c.v = out[1:]
        c.advance(0, 1)
        c.advance(1, 1)
        chunk = np.arange(2 * (SPEC_K + 1), dtype=np.int32).reshape(2, -1)
        out = eng.verify_slots(c.k, c.v, c.tables, c.lengths, chunk + 3,
                               active, lora=pool.lora_args(rows))
        got["verify"], got["k"], got["v"] = out
        outs.append({k: np.asarray(v) for k, v in got.items()})
    for key in outs[0]:
        np.testing.assert_allclose(outs[1][key], outs[0][key], **TOL,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# serving: streams, stats, telemetry
# ---------------------------------------------------------------------------

MIX = [("a", 0, 6, "t1"), ("b", 1, 6, "t2"), ("c", 2, 5, None),
       ("d", 3, 4, "t3"), ("e", 4, 5, "t1"), ("f", 5, 3, None)]


def mix_jobs(seed=5):
    prompts = prompts_of((5, 8, 11, 6, 7, 9), seed=seed)
    return [(rid, prompts[i], n, aid) for rid, i, n, aid in MIX]


def test_mixed_drain_matches_jax_and_merged(stack):
    """Two slots, a pool of two blocks, three tenants and base-only
    requests: heterogeneous batches, hits, LRU evictions and reloads.
    Streams equal JAX's and each adapter's merged ``generate``; base-only
    streams and logprobs equal the LoRA-off drain's bit for bit; the
    stats, registry, tracer records (with ``adapter_load``) and costs
    equal JAX's."""
    jobs = mix_jobs()
    (js, jout, _), (ts, tout, treqs) = (
        serve(stack, name, jobs, telemetry=True) for name, _, _ in PKGS)
    assert_same_streams(tout, jout)
    for rid, p, n, aid in jobs:
        np.testing.assert_array_equal(tout[rid],
                                      ref_of(stack, aid, p, n), err_msg=rid)
    assert not np.array_equal(tout["a"][5:], ref_of(stack, None, jobs[0][1],
                                                    6)[5:])
    st = ts.adapters.stats()
    assert st == js.adapters.stats()
    assert (st["loads"], st["evictions"]) == (ts.stats["adapter_loads"],
                                              ts.stats["adapter_evictions"])
    assert st["evictions"] >= 1 and st["hits"] == ts.stats["adapter_hits"]
    assert dict(ts.stats) == dict(js.stats)
    assert ts.stats["peak_occupancy"] == 2
    tm, jm = ts.metrics, js.metrics
    assert {n: g.value for n, g in tm._gauges.items()} == \
        {n: g.value for n, g in jm._gauges.items()}
    assert list(tm._gauges) == list(jm._gauges)
    assert tm.gauge("lora_pool_bytes").value == ts.adapters.pool_bytes
    assert tm.gauge("lora_active_adapters").value == 2
    assert _records(ts) == _records(js)
    assert sum(r[0] == "adapter_load" for r in _records(ts)) == st["loads"]
    assert ts.costs.snapshot() == js.costs.snapshot()
    for r in ts.finished:
        jr = next(q for q in js.finished if q.rid == r.rid)
        assert r.cost == jr.cost and r.state == jr.state == "done"
    assert ts.cost_registry.to_json() == {"programs": {
        pid: dict(e, attr=ts.cost_registry.entries[pid]["attr"])
        for pid, e in js.cost_registry.to_json()["programs"].items()}}
    # every pin dropped with its slot; the last two tenants stay warm
    assert all(ts.adapters.refcount(a) == 0 for a in stack.sds)
    assert not ts._slot_arows.any()


def test_base_only_slots_bit_for_bit_beside_tenants(stack):
    """The base-only requests of the mixed drain, decoding beside adapter
    slots in a LoRA-on engine, give the streams and logprobs of the same
    drain with LoRA off and no adapter request (the zero block adds
    exactly +0.0 to their rows)."""
    jobs = mix_jobs()
    _, on_out, on_reqs = serve(stack, "port", jobs)
    off_jobs = [(rid, p, n, None) for rid, p, n, _ in jobs]
    off, off_out, off_reqs = serve(stack, "port", off_jobs, lora_serve=False)
    assert off.adapters is None
    for rid, p, n, aid in jobs:
        if aid is None:
            np.testing.assert_array_equal(on_out[rid], off_out[rid])
            assert on_reqs[rid].out_logprobs == off_reqs[rid].out_logprobs
        else:
            assert not np.array_equal(on_out[rid], off_out[rid])


def test_snapshot_drain_carries_adapter(stack):
    """``pending_snapshot(release=True)`` mid-decode drops the pin with
    the blocks and carries ``adapter_id``; a fresh engine resumes the
    request under the same adapter to the merged stream, as in JAX."""
    p = prompts_of((7,), seed=10)[0]
    snaps = []
    for name, mod, _ in PKGS:
        srv = mod.ServingEngine(getattr(stack, name), **LORA_KW)
        srv.register_adapter("t1", stack.sds["t1"])
        req = mod.ServeRequest(rid="r", prompt=p, max_new_tokens=8,
                               adapter_id="t1")
        srv.submit(req, now=0)
        step = 0
        while srv.busy and len(req.out) < 3:
            srv.step(step)
            step += 1
        snap = srv.pending_snapshot(release=True)
        assert snap[0]["adapter_id"] == "t1"
        assert not srv._slot_arows.any()
        assert srv.adapters.stats()["resident"] == 1
        fresh = mod.ServingEngine(getattr(stack, name), **LORA_KW)
        fresh.register_adapter("t1", stack.sds["t1"])
        out = fresh.run([mod.ServeRequest.from_snapshot(s) for s in snap])
        np.testing.assert_array_equal(out["r"], ref_of(stack, "t1", p, 8))
        snaps.append([{k: v for k, v in s.items() if k != "out_logprobs"}
                      for s in snap])
    assert tserving.ServeRequest.from_snapshot(snaps[1][0]).adapter_id == "t1"
    assert snaps[1] == snaps[0]


@pytest.mark.parametrize("kind", ["cache_exhausted", "device_error"])
def test_load_fault_retires_error_as_jax(stack, kind):
    """A faulted load retires its request ``error`` with the batch
    serving on; the pool's ``stats()`` is what it was before the load
    (the site fires before any pool state moves); the same tenant loads
    once the fault has passed. States, stats and streams equal JAX's."""
    p1, p2 = prompts_of((6, 8), seed=12)
    res = []
    for name, mod, flib in PKGS:
        inj = flib.FaultInjector([flib.Fault("cache.adapter_load", kind,
                                             step=0)], seed=0)
        srv = mod.ServingEngine(getattr(stack, name), **LORA_KW, faults=inj)
        srv.register_adapter("t1", stack.sds["t1"])
        before = srv.adapters.stats()
        pools = [t.clone() if name == "port" else np.asarray(t)
                 for t in srv.adapters.a_pool.values()]
        bad = mod.ServeRequest(rid="bad", prompt=p1, max_new_tokens=5,
                               adapter_id="t1")
        ok = mod.ServeRequest(rid="ok", prompt=p2, max_new_tokens=5)
        out = srv.run([bad, ok])
        assert (bad.state, ok.state) == ("error", "done")
        assert srv.adapters.stats() == before
        if name == "port":
            for a, b in zip(pools, srv.adapters.a_pool.values()):
                assert torch.equal(a, b)
        retry = mod.ServeRequest(rid="again", prompt=p1, max_new_tokens=5,
                                 adapter_id="t1")
        out.update(srv.run([retry]))
        assert retry.state == "done"
        res.append((out, dict(srv.stats), srv.adapters.stats(),
                    [tuple(f) for f in inj.fired]))
    assert_same_streams(res[1][0], res[0][0])
    assert res[1][1:] == res[0][1:]
    assert res[1][1]["adapter_load_errors"] == 1
    np.testing.assert_array_equal(res[1][0]["again"],
                                  ref_of(stack, "t1", p1, 5))
    np.testing.assert_array_equal(res[1][0]["ok"],
                                  ref_of(stack, None, p2, 5))


def test_unregistered_adapter_and_lora_off(stack):
    """An unregistered adapter retires ``error`` beside a served tenant,
    as in JAX; with LoRA off there is no pool, ``register_adapter``
    raises, and a request naming an adapter retires ``error`` instead of
    being served base tokens."""
    p1, p2 = prompts_of((5, 6), seed=14)
    jobs = [("g", p1, 4, "nobody"), ("r", p2, 4, "t1")]
    (js, jout, jreqs), (ts, tout, treqs) = (
        serve(stack, name, jobs, aids=("t1",)) for name, _, _ in PKGS)
    assert_same_streams(tout, jout)
    assert treqs["g"].state == jreqs["g"].state == "error"
    assert treqs["r"].state == "done"
    np.testing.assert_array_equal(tout["r"], ref_of(stack, "t1", p2, 4))
    assert dict(ts.stats) == dict(js.stats)
    assert ts.stats["adapter_load_errors"] == 1
    off = tserving.ServingEngine(stack.port, num_slots=1, block_size=4,
                                 num_blocks=12, lora_serve=False)
    assert off.adapters is None
    with pytest.raises(ValueError, match="lora_serve"):
        off.register_adapter("t1", stack.sds["t1"])
    stray = tserving.ServeRequest(rid="s", prompt=p1, max_new_tokens=4,
                                  adapter_id="t1")
    off.run([stray])
    assert stray.state == "error" and stray.out == []
    assert off.stats["adapter_load_errors"] == 1


def test_every_slot_release_drops_the_pin(stack):
    """Timeout, KV eviction (recompute preemption), ``n > 1`` clones, a
    ``DegradedError`` and the drain after it: every path that frees a
    slot drops its adapter pin, and every finished stream is its merged
    reference."""
    p = prompts_of((6, 4, 4), seed=16)
    # 8 usable blocks of 4: the twins (18 tokens each) admitted beside
    # the request that times out outgrow the pool, and the younger twin
    # is preempted
    srv = tserving.ServingEngine(stack.port, **dict(
        LORA_KW, num_slots=3, num_blocks=9, max_evictions=4))
    for aid in ("t1", "t2"):
        srv.register_adapter(aid, stack.sds[aid])
    late = tserving.ServeRequest(rid="late", prompt=p[0], max_new_tokens=20,
                                 adapter_id="t2", deadline=4.0)
    twins = tserving.ServeRequest(rid="n", prompt=p[1], max_new_tokens=14,
                                  adapter_id="t1", n=2, temperature=0.0)
    long = tserving.ServeRequest(rid="long", prompt=p[2], max_new_tokens=14,
                                 adapter_id="t2")
    with pytest.raises(tserving.DegradedError) as err:
        srv.run([twins, late, long], max_steps=6)
    assert err.value.pending and {e["adapter_id"] for e in
                                  err.value.pending} <= {"t1", "t2"}
    srv.run()
    assert late.state == "timeout" and len(late.out) > 0
    assert srv.stats["evictions"] >= 1
    for r in srv.finished:
        if r.state == "done":
            np.testing.assert_array_equal(
                r.tokens, ref_of(stack, r.adapter_id, np.asarray(r.prompt),
                                 r.max_new_tokens))
    assert {r.rid for r in srv.finished} == {"late", "n", "n#1", "long"}
    assert all(srv.adapters.refcount(a) == 0 for a in ("t1", "t2"))
    assert not srv._slot_arows.any()


# ---------------------------------------------------------------------------
# interplay: prefix cache, speculation, int8 KV, the horizon
# ---------------------------------------------------------------------------

def test_prefix_cache_bypass_both_ways(stack):
    """Adapter-carrying requests neither match cached prefixes nor
    publish their own; base-only traffic keeps sharing. As in JAX."""
    shared = prompts_of((12,), seed=17)[0]
    jobs = [(f"b{i}", shared.copy(), 4, None) for i in range(2)] + \
        [(f"a{i}", shared.copy(), 4, "t1") for i in range(2)] + \
        [("b2", shared.copy(), 4, None)]
    res = []
    for name, mod, _ in PKGS:
        srv = mod.ServingEngine(getattr(stack, name),
                                **dict(LORA_KW, prefix_cache=True))
        srv.register_adapter("t1", stack.sds["t1"])
        out, hits = {}, []
        for group in (jobs[:1], jobs[1:2], jobs[2:4], jobs[4:]):
            out.update(srv.run([mod.ServeRequest(rid=r, prompt=p,
                                                 max_new_tokens=n,
                                                 adapter_id=a)
                                for r, p, n, a in group]))
            hits.append(srv.stats["prefix_hits"])
        res.append((out, hits, dict(srv.stats)))
    assert_same_streams(res[1][0], res[0][0])
    assert res[1][1:] == res[0][1:]
    assert res[1][1] == [0, 1, 1, 2]
    for rid, p, n, aid in jobs:
        np.testing.assert_array_equal(res[1][0][rid],
                                      ref_of(stack, aid, p, n))


def test_spec_decode_under_adapters_matches_jax(stack):
    """Speculation verifies each slot's drafts under its adapter: greedy
    streams equal spec off, the merged references and JAX's."""
    jobs = mix_jobs(seed=19)[:4]
    (js, jout, _), (ts, tout, _) = (
        serve(stack, name, jobs, spec_decode=True, spec_k=SPEC_K)
        for name, _, _ in PKGS)
    assert_same_streams(tout, jout)
    for rid, p, n, aid in jobs:
        np.testing.assert_array_equal(tout[rid], ref_of(stack, aid, p, n))
    assert ts.stats["spec_steps"] >= 1
    assert dict(ts.stats) == dict(js.stats)


def test_int8_pools_and_horizon_under_adapters(stack):
    """Int8 KV pools (the ``_ql`` path) with the decode horizon at N = 4:
    the JAX streams and stats, and the port's N = 1 streams."""
    jobs = mix_jobs(seed=22)[:4]
    kw = dict(kv_quant="int8", decode_horizon=4)
    (js, jout, _), (ts, tout, _) = (serve(stack, name, jobs, **kw)
                                    for name, _, _ in PKGS)
    assert_same_streams(tout, jout)
    assert dict(ts.stats) == dict(js.stats)
    one_srv, one, _ = serve(stack, "port", jobs, kv_quant="int8")
    assert_same_streams(tout, one)
    assert ts.stats["decode_steps"] < one_srv.stats["decode_steps"]
    # float pools at N = 4: the merged references
    _, hz, _ = serve(stack, "port", jobs, decode_horizon=4)
    for rid, p, n, aid in jobs:
        np.testing.assert_array_equal(hz[rid], ref_of(stack, aid, p, n))


def test_router_adapter_affinity_dispatch_and_parity(stack):
    """A deadline-free request naming an adapter returns to the replica
    whose pool holds it (a hit, not a reload) under the imbalance cap;
    deadline traffic goes least-loaded. The same queues, stats and
    streams in both packages, each the merged adapter's solo stream."""
    p_b, p_a = prompts_of((8, 8), seed=24)
    ref = ref_of(stack, "t1", p_a, 4)
    got = {}
    for pkg, smod, rmod in (("jax", jserving, jrouter),
                            ("port", tserving, trouter)):
        fleet = [smod.ServingEngine(getattr(stack, pkg), **LORA_KW)
                 for _ in range(2)]
        for rep in fleet:
            rep.register_adapter("t1", stack.sds["t1"])
        router = rmod.ReplicaRouter(fleet)
        queues = []
        for rid, p, kw in (("b1", p_b, {}), ("a1", p_a, dict(adapter_id="t1")),
                           ("a2", p_a.copy(), dict(adapter_id="t1")),
                           ("a3", p_a.copy(), dict(adapter_id="t1",
                                                   deadline=1e9))):
            router.submit(smod.ServeRequest(rid=rid, prompt=p,
                                            max_new_tokens=4, **kw))
            queues.append([[r.rid for r in f.queue] for f in fleet])
        out = router.run()
        got[pkg] = (queues, dict(router.stats),
                    {rid: [int(t) for t in v] for rid, v in out.items()},
                    [f.adapters.stats() for f in fleet])
    assert got["port"] == got["jax"]
    queues, stats, out, pools = got["port"]
    # the tenant seeds replica 1; its follow-up beats the tie-break there;
    # the deadline request goes to the less loaded replica 0
    assert queues[-1] == [["b1", "a3"], ["a1", "a2"]]
    assert stats["adapter_affinity_hits"] >= 1
    for rid in ("a1", "a2", "a3"):
        np.testing.assert_array_equal(out[rid], ref)
    assert pools[1]["hits"] >= 1

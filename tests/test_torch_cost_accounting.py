"""The port's cost accounting against the JAX package's, on the CPU.

The analytic formulas give the JAX integers; the program cost registry
gives the JAX registry's analytic cards (the ``"analytic"`` branch both
take on the CPU), entry for entry, for every program the port has.
Conservation is exact in every drain the port serves (evict/requeue, the
prefix cache's copy-on-write, speculative decode, the decode horizon at
N = 8, the host tier's spills and restores): the footprints of the
finished requests plus the system footprint equal the class totals, and
those the registry's counters. Off, the accountant is the no-op twin:
the same tokens, no cost metric. The drains' cost snapshots are held
equal to the JAX engine's in ``tests/test_torch_telemetry.py``.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.inference import engine as jengine
from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.telemetry import costs as jcosts
from deepspeed_tpu.utils import jit_registry
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.telemetry import NOOP_COSTS, Telemetry
from deepspeed_tpu_torch.telemetry import costs as tcosts
from test_torch_model import numpy_params, one_torch_thread  # noqa: F401
from test_torch_serving import CONFIGS, SERVE_KW
from test_torch_telemetry import drain, prompts_of

CLASSES = tcosts.DISPATCH_CLASSES


@pytest.fixture(scope="module")
def cfgs():
    out = {}
    for name in ("gpt2", "llama"):
        fields = CONFIGS[name]
        out[name] = (jgpt.GPTConfig(**fields, dtype=jnp.float32,
                                    use_flash_attention=False, remat=False),
                     tgpt.GPTConfig(**fields, dtype=torch.float32))
    return out


@pytest.fixture(scope="module")
def pair(cfgs):
    jcfg, tcfg = cfgs["gpt2"]
    npp = numpy_params(jcfg)
    jeng = jengine.InferenceEngine(
        config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, npp),
        dtype=jnp.float32)
    teng = init_inference(model=(tcfg, params_from_numpy(npp, tcfg,
                                                         device="cpu")),
                          dtype=torch.float32, device="cpu")
    return jeng, teng


# ---------------------------------------------------------------------------
# the analytic model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_analytic_formulas_equal_jax(cfgs, name):
    jcfg, tcfg = cfgs[name]
    assert tcosts.model_flops_per_token(tcfg) == \
        jcosts.model_flops_per_token(jcfg)
    assert tcosts.weight_bytes(tcfg, 4) == jcosts.weight_bytes(jcfg, 4)
    for n, s in ((1, 0), (5, 7), (8, 0), (4, 8), (12, 0), (3, 61)):
        assert tcosts.attn_flops(tcfg, n, s) == jcosts.attn_flops(jcfg, n, s)
        assert tcosts.infer_flops(tcfg, n, s) == \
            jcosts.infer_flops(jcfg, n, s)
        for kv_tok, itemsize, weights in ((64, 4, True), (1056, 2, False)):
            assert tcosts.infer_hbm_bytes(tcfg, n, s, kv_tok, itemsize,
                                          weights) == \
                jcosts.infer_hbm_bytes(jcfg, n, s, kv_tok, itemsize, weights)
    # a chunked prefill costs what one shot does
    assert tcosts.infer_flops(tcfg, 12, 0) == \
        tcosts.infer_flops(tcfg, 8, 0) + tcosts.infer_flops(tcfg, 4, 8)


@pytest.mark.parametrize("total,n", [(10, 3), (7, 7), (0, 4), (5, 0),
                                     (1_000_003, 8)])
def test_split_even_and_footprints_equal_jax(total, n):
    shares = tcosts.split_even(total, n)
    assert shares == jcosts.split_even(total, n)
    assert sum(shares) == (total if n > 0 else 0)
    fp = tcosts.new_footprint()
    assert fp == jcosts.new_footprint()
    fp["decode"]["flops"] = total
    fp["block_seconds"] = n
    assert tcosts.merge_footprints([fp, fp, None]) == \
        jcosts.merge_footprints([fp, fp, None])
    assert tcosts.footprint_totals(fp) == jcosts.footprint_totals(fp)


def test_program_catalog_is_the_jax_one_without_lora():
    """The whole JAX catalog, in its order, the LoRA twins (``_l``,
    ``_ql``) included since the LoRA-serving slice: each twin is the
    ``lora=`` mode of its program's callable."""
    assert tcosts.DISPATCH_CLASSES == jit_registry.DISPATCH_CLASSES
    jax_ids = [(pid, cls) for pid, _, cls in jit_registry.engine_programs()]
    assert [(pid, cls) for pid, _, cls in tcosts.ENGINE_PROGRAMS] == jax_ids
    attr = {pid: a for pid, a, _ in tcosts.ENGINE_PROGRAMS}
    for pid in attr:
        if pid.endswith(("_l", "_ql")):
            assert attr[pid] == attr[pid.rsplit("_", 1)[0]]


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_program_cost_registry_equals_jax(pair, kv_quant):
    jeng, teng = pair
    regs = []
    for mod, eng, reg in ((jserving, jeng, jcosts.ProgramCostRegistry()),
                          (tserving, teng, tcosts.ProgramCostRegistry())):
        srv = mod.ServingEngine(eng, kv_quant=kv_quant, **SERVE_KW)
        reg.populate(eng, cache=srv.cache)
        regs.append(reg.to_json()["programs"])
    # without a cache: the engine dtype's KV bytes, blocks of 16
    bare = [jcosts.ProgramCostRegistry(), tcosts.ProgramCostRegistry()]
    bare[0].populate(jeng)
    bare[1].populate(teng)
    for (jp, tp) in (regs, [r.to_json()["programs"] for r in bare]):
        assert set(jp) == set(tp)
        for pid, entry in tp.items():
            assert entry["source"] == jp[pid]["source"] == "analytic"
            assert {k: v for k, v in entry.items() if k != "attr"} == \
                {k: v for k, v in jp[pid].items() if k != "attr"}, pid
            assert entry["attr"] == dict(
                (p, a) for p, a, _ in tcosts.ENGINE_PROGRAMS)[pid]


# ---------------------------------------------------------------------------
# conservation in the port's drains
# ---------------------------------------------------------------------------

def _assert_conserved(srv):
    """Footprints + system == totals == counters, exactly."""
    folded = {c: {"flops": 0, "hbm_bytes": 0, "dispatches": 0}
              for c in CLASSES}
    fps = [r.cost for r in srv.finished] + [srv.costs.system]
    for fp in fps:
        for c in CLASSES:
            for k in folded[c]:
                folded[c][k] += fp[c][k]
    bs = sum(fp["block_seconds"] for fp in fps)
    for c in CLASSES:
        assert folded[c] == srv.costs.totals[c], c
    assert bs == srv.costs.block_seconds_total
    counters = srv.metrics.snapshot()["counters"]
    assert counters["serving_flops_total"] == \
        sum(folded[c]["flops"] for c in CLASSES)
    assert counters["serving_hbm_bytes_total"] == \
        sum(folded[c]["hbm_bytes"] for c in CLASSES)
    assert counters["serving_kv_block_seconds"] == bs
    # the tenants re-fold to the totals; requests without an adapter are
    # "base", the ownerless spills "system"
    assert set(srv.costs.tenants) <= {"base", "system"}
    for c in CLASSES:
        for k in ("flops", "hbm_bytes", "dispatches"):
            assert sum(fp[c][k] for fp in srv.costs.tenants.values()) == \
                srv.costs.totals[c][k]


@pytest.mark.parametrize("name", ["evict", "prefix", "spec", "horizon8",
                                  "host_tier_int8"])
def test_conservation_is_exact(pair, name):
    _, teng = pair
    srv, _ = drain(tserving, teng, name)
    _assert_conserved(srv)
    tot = srv.costs.totals
    gen = sum(len(r.out) for r in srv.finished)
    assert tot["prefill"]["flops"] > 0
    if name == "evict":
        victim = next(r for r in srv.finished if r.evictions > 0)
        assert victim.cost["prefill"]["dispatches"] >= 2
    if name == "prefix":
        assert tot["cow"]["dispatches"] == srv.cache.cow_copies > 0
    if name == "spec":
        assert tot["verify"]["dispatches"] > 0
        assert tot["decode"]["dispatches"] == 0
    if name == "horizon8":
        # fewer decode dispatches than tokens, FLOPs for every token
        assert 0 < tot["decode"]["dispatches"] < gen
        assert tot["decode"]["flops"] >= (gen - len(srv.finished)) * \
            tcosts.model_flops_per_token(teng.cfg)
    if name == "host_tier_int8":
        # restores are the admitting request's, spills the system's
        spills, restores = srv.stats["host_spills"], \
            srv.stats["host_restores"]
        assert tot["spill"]["dispatches"] == spills + restores
        assert srv.costs.system["spill"]["dispatches"] == spills > 0
        assert srv.costs.block_bytes == \
            srv.cache.bytes_per_token * srv.cache.block_size + \
            srv.cache.scale_bytes_per_block


# ---------------------------------------------------------------------------
# on, off, and the knob alone
# ---------------------------------------------------------------------------

def test_off_mode_same_tokens_no_cost_metrics(pair):
    _, teng = pair
    runs = {}
    for tel in (Telemetry(), False):
        srv = tserving.ServingEngine(teng, telemetry=tel, **SERVE_KW)
        out = srv.run([tserving.ServeRequest(rid=i, prompt=p,
                                             max_new_tokens=6)
                       for i, p in enumerate(prompts_of((5, 9, 12),
                                                        seed=13))])
        runs[bool(tel)] = (srv, {k: v.tolist() for k, v in out.items()})
    assert runs[True][1] == runs[False][1]
    off = runs[False][0]
    assert off.costs is NOOP_COSTS and not off.costs.enabled
    assert off.cost_registry is None and off.costs.snapshot() == {}
    for name in ("serving_flops_total", "serving_hbm_bytes_total",
                 "serving_kv_block_seconds"):
        assert name not in off.metrics.names()
        assert name in runs[True][0].metrics.names()
    assert all(r.cost == tcosts.new_footprint() for r in off.finished)


@pytest.mark.parametrize("how", ["knob", "env"])
def test_cost_accounting_without_telemetry_equals_jax(pair, how,
                                                      monkeypatch):
    """``cost_accounting=True`` (or ``DS_COST_ACCOUNTING=on``) with
    telemetry off: the charges land in the private registry, the
    snapshot is the JAX engine's, no histogram and no record exists."""
    jeng, teng = pair
    kw = {"cost_accounting": True} if how == "knob" else {}
    if how == "env":
        monkeypatch.setenv("DS_COST_ACCOUNTING", "on")
    srvs = []
    for mod, eng in ((jserving, jeng), (tserving, teng)):
        srv = mod.ServingEngine(eng, telemetry=False, **kw, **SERVE_KW)
        srv.run([mod.ServeRequest(rid="n", prompt=prompts_of((8,),
                                                             seed=2)[0],
                                  max_new_tokens=6)])
        srvs.append(srv)
    js, ts = srvs
    assert ts.costs.enabled and not ts.telemetry.enabled
    _assert_conserved(ts)
    assert ts.costs.snapshot() == js.costs.snapshot()
    assert ts.metrics.counter("serving_flops_total").value > 0
    assert not ts.metrics._histograms
    assert not any(n.startswith("program_") for n in ts.metrics.names())
    assert ts.telemetry.tracer.records() == []

"""Parity of the port's speculative decoding with the JAX package on the
CPU: the fp64 Leviathan primitives, the drafters, ``verify_slots``,
``ServingEngine(spec_decode=True)`` in both pool modes, the static
``generate_speculative``, and the ``DS_*`` environment flags that the
serving constructor reads.

Tolerances: tokens identical; ``verify_slots`` logits to rtol/atol 1e-5
(float32); the fp64 primitives, ``spec_verify_tokens`` and the n-gram
drafter bit for bit on the same inputs. Every JAX serving engine here
uses one ``spec_k`` (:data:`SPEC_K`) and the ``SERVE_KW`` geometry, so
each verify program compiles once per pool mode. The sampled serving
path's first token comes from the port's own sampler (torch has no
threefry), so sampled serving is held to the target's distribution, not
to JAX's streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sstats

from deepspeed_tpu.inference import engine as jengine
from deepspeed_tpu.inference import sampling as jsampling
from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.inference import spec_decode as jspec
from deepspeed_tpu.inference import speculative as jspeculative
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.utils import env as jenv
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference import sampling as tsampling
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.inference import spec_decode as tspec
from deepspeed_tpu_torch.inference import speculative as tspeculative
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.utils import env as tenv
from deepspeed_tpu_torch.utils import faults as tfaults
from test_torch_int8_serving import _assert_pools_close
from test_torch_model import numpy_params
from test_torch_serving import (CONFIGS, SERVE_KW,  # noqa: F401
                                one_torch_thread, pair)

TOL = dict(rtol=1e-5, atol=1e-5)
SPEC_K = 3


def repeating_prompts(lengths, vocab, seed=3, period=5):
    """Prompts that repeat a seeded span, so that prompt lookup
    proposes tokens the target accepts."""
    r = np.random.default_rng(seed)
    return [np.tile(r.integers(1, vocab, period), n // period + 1)[:n]
            .astype(np.int32) for n in lengths]


# ---------------------------------------------------------------------------
# the fp64 Leviathan primitives and the drafters: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knobs", [(1.0, 0, 1.0), (0.7, 5, 1.0),
                                   (1.3, 0, 0.8), (0.9, 12, 0.6)])
def test_fp64_primitives_match_jax(knobs):
    temp, top_k, top_p = knobs
    r = np.random.default_rng(int(temp * 10) + top_k)
    logits = (r.standard_normal((3, 40)) * 3).astype(np.float32)
    p = tsampling.fp64_dist(logits, temp, top_k, top_p)
    np.testing.assert_array_equal(
        p, jsampling.fp64_dist(logits, temp, top_k, top_p))
    q = tsampling.fp64_dist(logits[::-1].copy(), temp)
    u = r.random(3)
    for name, args in (("nucleus_truncate", (p, 0.7)),
                       ("inverse_cdf", (p, u)),
                       ("accept_prob", (p[:, 3], q[:, 3])),
                       ("residual_dist", (p[0], q[0])),
                       ("residual_dist", (p[1], p[1])),
                       ("point_mass_residual", (p[2], int(p[2].argmax()))),
                       ("position_uniforms", (2**63 + 5, 17, 4))):
        np.testing.assert_array_equal(
            getattr(tsampling, name)(*args), getattr(jsampling, name)(*args),
            err_msg=name)


@pytest.mark.parametrize("seed", [0, 7, 2**40 + 3])
def test_spec_verify_tokens_match_jax(seed):
    """The sampled verify of a draft chunk: the same tokens, logprobs and
    acceptance count, for proposals that mix likely and unlikely
    tokens."""
    r = np.random.default_rng(seed % 1000)
    for trial in range(6):
        rows = tsampling.fp64_dist(
            (r.standard_normal((SPEC_K + 1, 30)) * 2.5).astype(np.float32),
            0.8, top_p=0.95)
        prop = np.where(r.random(SPEC_K) < 0.6, rows[:-1].argmax(-1),
                        r.integers(0, 30, SPEC_K)).astype(np.int32)
        got = tsampling.spec_verify_tokens(rows, prop, seed, 11 + trial)
        ref = jsampling.spec_verify_tokens(rows, prop, seed, 11 + trial)
        assert got == ref


def test_ngram_draft_matches_jax():
    r = np.random.default_rng(4)
    ours, theirs = tspec.NGramDraft(), jspec.NGramDraft()
    for n in (0, 1, 2, 5, 9, 30):
        ctx = np.tile(r.integers(0, 6, 4), 8)[:n]
        if n == 30:
            ctx = r.integers(0, 50, n)
        for k in (1, 3, 5):
            got = ours.propose(ctx, k)
            assert got.dtype == np.int32 and got.shape == (k,)
            np.testing.assert_array_equal(got, theirs.propose(ctx, k))
    np.testing.assert_array_equal(ours.propose([1, 2, 3, 4, 1, 2, 3], 3),
                                  [4, 1, 2])
    with pytest.raises(ValueError, match="min_ngram"):
        tspec.NGramDraft(max_ngram=1, min_ngram=2)


# ---------------------------------------------------------------------------
# the DS_* flags
# ---------------------------------------------------------------------------

def test_env_registry_matches_jax():
    """The same flags, kinds, defaults, choices and aliases, and the same
    value or ValueError for every spelling of every flag."""
    assert tenv.flag_names() == jenv.flag_names()
    spellings = ("", "on", "OFF", " 1 ", "0", "true", "no", "yes", "none",
                 "int8", "7", "-2", "2.5", "ngram", "sideways")
    for name in tenv.flag_names():
        t, j = tenv.FLAGS[name], jenv.FLAGS[name]
        assert (t.kind, t.default, t.choices, dict(t.aliases)) == \
            (j.kind, j.default, j.choices, dict(j.aliases)), name
        for raw in spellings:
            outs = []
            for mod in (tenv, jenv):
                try:
                    outs.append(mod.resolve_flag(name, env={name: raw}))
                except ValueError:
                    outs.append("ValueError")
            assert outs[0] == outs[1], (name, raw, outs)
        for override in (True, False, 3, "on"):
            outs = []
            for mod in (tenv, jenv):
                try:
                    outs.append(mod.resolve_flag(name, override))
                except ValueError:
                    outs.append("ValueError")
            assert outs[0] == outs[1], (name, override, outs)
    with pytest.raises(KeyError):
        tenv.resolve_flag("DS_NO_SUCH_FLAG")


@pytest.mark.parametrize("flag,values", [
    ("DS_SPEC_DECODE", ("on", "off", "1", "0", "true", "false", "yes", "",
                        " On ")),
    ("DS_SPEC_K", ("6", "1", "", " 2 ")),
    ("DS_SPEC_DRAFT", ("ngram", "", " NGRAM ")),
    ("DS_KV_QUANT", ("int8", "on", "off", "1", "0", "none", "", "TRUE")),
])
def test_serving_flags_resolve_like_jax(monkeypatch, flag, values):
    from deepspeed_tpu.ops import quantizer as jquant
    from deepspeed_tpu_torch.ops import quantizer as tquant
    resolve = {"DS_SPEC_DECODE": (tspec.resolve_spec_decode,
                                  jspec.resolve_spec_decode),
               "DS_SPEC_K": (tspec.resolve_spec_k, jspec.resolve_spec_k),
               "DS_SPEC_DRAFT": (tspec.resolve_spec_draft,
                                 jspec.resolve_spec_draft),
               "DS_KV_QUANT": (tquant.resolve_kv_quant,
                               jquant.resolve_kv_quant)}[flag]
    explicit = {"DS_SPEC_DECODE": (True, False), "DS_SPEC_K": (2, 5),
                "DS_SPEC_DRAFT": ("ngram",),
                "DS_KV_QUANT": (True, False, "int8", "off")}[flag]
    for value in values:
        monkeypatch.setenv(flag, value)
        for arg in (None,) + explicit:
            assert resolve[0](arg) == resolve[1](arg), (value, arg)
    bad = {"DS_SPEC_DECODE": "sideways", "DS_SPEC_K": "0",
           "DS_SPEC_DRAFT": "eagle", "DS_KV_QUANT": "fp8"}[flag]
    monkeypatch.setenv(flag, bad)
    for fn in resolve:
        with pytest.raises(ValueError):
            fn(None)


def test_kv_quant_env_builds_int8_pools_like_jax(pair, monkeypatch):
    """``DS_KV_QUANT=int8`` with ``kv_quant`` left at None: both packages'
    ``ServingEngine(eng)`` build int8 pools and serve the same greedy
    streams."""
    jeng, teng = pair
    monkeypatch.setenv("DS_KV_QUANT", "int8")
    js = jserving.ServingEngine(jeng, **SERVE_KW)
    ts = tserving.ServingEngine(teng, **SERVE_KW)
    assert js.kv_quant == ts.kv_quant == "int8"
    assert ts.cache.quantized and ts.cache.k.dtype == torch.int8
    assert ts.cache.k_scale is not None
    prompts = repeating_prompts((9, 14, 5), jeng.cfg.vocab_size)
    jo = js.run([jserving.ServeRequest(rid=i, prompt=p, max_new_tokens=6)
                 for i, p in enumerate(prompts)])
    to = ts.run([tserving.ServeRequest(rid=i, prompt=p, max_new_tokens=6)
                 for i, p in enumerate(prompts)])
    for rid in jo:
        np.testing.assert_array_equal(to[rid], jo[rid])
    _assert_pools_close(ts.cache.k, js.cache.k, ts.cache.k_scale,
                        js.cache.k_scale)


def test_waiting_env_flags_raise(pair, monkeypatch):
    """Every ``DS_*`` flag the JAX serving constructor reads is ported and
    read where JAX reads it. The host tier's, the horizon's and
    telemetry's flags: tests/test_torch_host_tier.py,
    test_torch_horizon.py and test_torch_telemetry.py resolve them
    against JAX. The fault-tolerance slice ported ``DS_FLIGHT_RECORDER``,
    ``DS_FLIGHT_DIR``, ``DS_FAULTS`` and ``DS_FAULT_SEED``: they arm the
    recorder and the ambient injector, as in JAX
    (tests/test_torch_chaos.py). The LoRA-serving slice ported
    ``DS_LORA_SERVE`` and its pool flags: ``DS_LORA_SERVE=true`` turns
    the adapter pool on in both packages, an explicit ``lora_serve``
    wins over it, and a pool flag is read only with LoRA serving on."""
    jeng, teng = pair
    monkeypatch.setenv("DS_LORA_SERVE", "true")
    monkeypatch.setenv("DS_LORA_MAX_RANK", "4")
    pools = [mod.ServingEngine(eng, num_slots=1).adapters
             for mod, eng in ((jserving, jeng), (tserving, teng))]
    assert pools[1].stats() == pools[0].stats()
    assert pools[1].max_rank == pools[0].max_rank == 4
    for mod, eng in ((jserving, jeng), (tserving, teng)):
        assert mod.ServingEngine(eng, num_slots=1,
                                 lora_serve=False).adapters is None
    monkeypatch.delenv("DS_LORA_SERVE")
    assert tserving.ServingEngine(teng, num_slots=1).adapters is None
    for flag, value in (("DS_FLIGHT_DIR", "/tmp/x"), ("DS_FAULT_SEED", "5"),
                        ("DS_LORA_MAX_RANK", "4"),
                        ("DS_KV_HOST_BUDGET_MB", "9"),
                        ("DS_PAGED_DECODE_IMPL", "pallas"),
                        ("DS_INT8_FUSED", "on")):
        monkeypatch.setenv(flag, value)
    tserving.ServingEngine(teng, num_slots=1)
    monkeypatch.setenv("DS_FLIGHT_RECORDER", "on")
    srv = tserving.ServingEngine(teng, num_slots=1)
    assert srv.flight.enabled and srv.flight.outdir == "/tmp/x"
    assert not tserving.ServingEngine(teng, num_slots=1,
                                      flight_recorder=False).flight.enabled
    monkeypatch.setenv("DS_FAULTS", "serving.decode:device_error@3")
    prev = tfaults.install(None)       # the ambient injector reads the env
    try:
        srv = tserving.ServingEngine(teng, num_slots=1)
        assert srv.faults is tfaults.active()
        assert (srv.faults.faults, srv.faults.seed) == (
            [tfaults.Fault("serving.decode", "device_error", step=3)], 5)
        assert srv.cache.faults is srv.faults
    finally:
        tfaults.install(prev)


# ---------------------------------------------------------------------------
# the verify program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_verify_slots_logits_match_jax(pair, kv_quant):
    """Two slots prefilled in chunks, then verify chunks of SPEC_K + 1
    tokens: one straddling a block edge, one slot inactive, one at the
    edge of the table's capacity; logits of active slots to 1e-5 and the
    pools after."""
    jeng, teng = pair
    cfg = jeng.cfg
    bs, C, N = SERVE_KW["block_size"], SERVE_KW["prefill_chunk"], 25
    NB = jgpt.decode_geometry(cfg, bs)[0]
    L, Hkv, Dh = cfg.n_layers, cfg.kv_heads, cfg.head_dim
    shape = (L, N, bs, Hkv, Dh)
    quant = kv_quant == "int8"
    if quant:
        jp = [jnp.zeros(shape, jnp.int8), jnp.zeros(shape, jnp.int8),
              jnp.zeros((L, N, Hkv)), jnp.zeros((L, N, Hkv))]
        tp = [torch.zeros(shape, dtype=torch.int8),
              torch.zeros(shape, dtype=torch.int8),
              torch.zeros((L, N, Hkv)), torch.zeros((L, N, Hkv))]
    else:
        jp = [jnp.zeros(shape), jnp.zeros(shape)]
        tp = [torch.zeros(shape), torch.zeros(shape)]

    def call(eng, pools, fn, *args):
        kw = dict(k_scale=pools[2], v_scale=pools[3]) if quant else {}
        out = getattr(eng, fn)(pools[0], pools[1], *args, **kw)
        pools[:] = list(out[-len(pools):])
        return out[0]

    tables = np.zeros((2, NB), np.int32)
    tables[:, :12] = np.arange(1, N).reshape(2, 12)
    prompts = repeating_prompts((7, 18), cfg.vocab_size, seed=6)
    for slot, p in enumerate(prompts):
        for start in range(0, len(p), C):
            n = min(C, len(p) - start)
            chunk = np.zeros(C, np.int32)
            chunk[:n] = p[start:start + n]
            args = (tables[slot], chunk, start, n)
            call(jeng, jp, "prefill_into_slot", *args)
            call(teng, tp, "prefill_into_slot", *args)
    lengths = np.array([len(p) for p in prompts], np.int32)
    r = np.random.default_rng(2)
    for active in ([True, True], [False, True], [True, True]):
        active = np.array(active)
        chunk = r.integers(1, cfg.vocab_size, (2, SPEC_K + 1)).astype(
            np.int32)
        args = (tables, lengths, chunk, active)
        lj = call(jeng, jp, "verify_slots", *args)
        lt = call(teng, tp, "verify_slots", *args)
        assert tuple(lt.shape) == (2, SPEC_K + 1, cfg.vocab_size)
        np.testing.assert_allclose(lt.numpy()[active],
                                   np.asarray(lj)[active], **TOL)
        lengths = lengths + np.where(active, 2, 0).astype(np.int32)
    # slot 1 at the edge of its 12 blocks: writes past them go to trash
    lengths[1] = 12 * bs - 2
    args = (tables, lengths, chunk, np.array([True, True]))
    lj = call(jeng, jp, "verify_slots", *args)
    lt = call(teng, tp, "verify_slots", *args)
    np.testing.assert_allclose(lt.numpy()[:, :2], np.asarray(lj)[:, :2],
                               **TOL)
    if quant:
        _assert_pools_close(tp[0], jp[0], tp[2], jp[2])
        _assert_pools_close(tp[1], jp[1], tp[3], jp[3])
    else:
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.numpy()[:, 1:],
                                       np.asarray(j)[:, 1:], **TOL)


# ---------------------------------------------------------------------------
# serving: the port against JAX, spec on against spec off
# ---------------------------------------------------------------------------

SCENARIOS = {
    "repeats": dict(lengths=(12, 9, 14, 7), n_new=10),
    # zero watermark, growth beyond the pool: a preemption and requeue
    "eviction": dict(lengths=(30, 28), n_new=(30, 28), watermark=0),
    # a shared prompt prefix with the prefix cache on
    "prefix": dict(lengths=(9, 13, 6), n_new=10, prefix=True),
    "int8": dict(lengths=(12, 9, 14, 7), n_new=10, kv_quant="int8"),
    "int8_prefix": dict(lengths=(9, 13, 6), n_new=10, kv_quant="int8",
                        prefix=True),
}
SPEC_STATS = ("spec_steps", "spec_slot_steps", "spec_proposed",
              "spec_accepted", "spec_emitted", "spec_k_capped",
              "decode_steps", "evictions", "prefix_hits",
              "prefix_tokens_saved", "completed")


def _scenario_prompts(sc, vocab):
    prompts = repeating_prompts(sc["lengths"], vocab)
    if sc.get("prefix"):
        system = repeating_prompts((12,), vocab, seed=8)[0]
        prompts = [np.concatenate([system, p]) for p in prompts]
    return prompts


def _serve(mod, eng, prompts, n_new, spec=True, watermark=None, **kw):
    srv = mod.ServingEngine(eng, spec_decode=spec, spec_k=SPEC_K,
                            **SERVE_KW, **kw)
    if watermark is not None:
        srv.cache.watermark = watermark
    if isinstance(n_new, int):
        n_new = [n_new] * len(prompts)
    out = srv.run([mod.ServeRequest(rid=i, prompt=p, max_new_tokens=n,
                                    logprobs=True)
                   for i, (p, n) in enumerate(zip(prompts, n_new))])
    return out, srv


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_spec_serving_streams_match_jax(pair, scenario):
    jeng, teng = pair
    sc = SCENARIOS[scenario]
    prompts = _scenario_prompts(sc, jeng.cfg.vocab_size)
    kw = dict(kv_quant=sc.get("kv_quant", "off"),
              prefix_cache=sc.get("prefix", False),
              watermark=sc.get("watermark"))
    jo, js = _serve(jserving, jeng, prompts, sc["n_new"], **kw)
    to, ts = _serve(tserving, teng, prompts, sc["n_new"], **kw)
    off, _ = _serve(tserving, teng, prompts, sc["n_new"], spec=False, **kw)
    assert sorted(to) == sorted(jo) == sorted(off)
    for rid in jo:
        np.testing.assert_array_equal(to[rid], jo[rid])
        np.testing.assert_array_equal(to[rid], off[rid])
    for key in SPEC_STATS:
        assert ts.stats[key] == js.stats[key], key
    assert ts.stats["spec_accepted"] > 0
    assert ts.stats["spec_emitted"] > ts.stats["spec_slot_steps"]
    # greedy logprobs come from the verify logits, one per token
    for r in ts.finished:
        assert len(r.out_logprobs) == len(r.out)
        assert all(np.isfinite(r.out_logprobs)) and max(r.out_logprobs) <= 0
    if scenario == "eviction":
        assert ts.stats["evictions"] >= 1
    if sc.get("prefix"):
        assert ts.stats["prefix_hits"] >= 1
    if scenario.startswith("int8"):
        _assert_pools_close(ts.cache.k, js.cache.k, ts.cache.k_scale,
                            js.cache.k_scale)
        _assert_pools_close(ts.cache.v, js.cache.v, ts.cache.v_scale,
                            js.cache.v_scale)


class _HalfOracle:
    """Perfect continuations for the requests it knows (their reference
    streams), the last vocabulary id for the rest: two slots of one
    verify step accept different prefix lengths."""

    def __init__(self, refs, vocab):
        self.refs = [np.asarray(r) for r in refs]
        self.vocab = vocab

    def propose(self, context, k):
        ctx = np.asarray(context)
        for ref in self.refs:
            if ctx.size <= ref.size and np.array_equal(ref[:ctx.size], ctx):
                out = np.full((k,), self.vocab - 1, np.int64)
                cont = ref[ctx.size:ctx.size + k]
                out[:cont.size] = cont
                return out.astype(np.int32)
        return np.full((k,), self.vocab - 1, np.int32)


def test_spec_per_slot_acceptance_and_adaptive_cap(pair):
    """Acceptance is per slot: with an oracle for request 0 and garbage
    for request 1, one verify step accepts drafts in one slot and none in
    the other. A slot whose acceptance falls under ``spec_accept_floor``
    is capped to one draft token (``spec_k_capped``), as in JAX; the
    streams stay the spec-off streams."""
    jeng, teng = pair
    V = jeng.cfg.vocab_size
    prompts = repeating_prompts((6, 6), V, seed=5)
    off, _ = _serve(tserving, teng, prompts, 12, spec=False)
    oracle = _HalfOracle([off[0]], V)
    srv = tserving.ServingEngine(teng, spec_decode=True, spec_k=SPEC_K,
                                 spec_draft=oracle, **SERVE_KW)
    accepted, last = {}, {}
    advance, rollback = srv.cache.advance, srv.cache.rollback

    def on_advance(slot, n):
        last[slot] = n
        advance(slot, n)

    def on_rollback(slot, n):
        # the spec step advances acc + 1, then rolls back
        accepted.setdefault(srv.stats["spec_steps"], {})[slot] = \
            last[slot] - 1
        rollback(slot, n)
    srv.cache.advance, srv.cache.rollback = on_advance, on_rollback
    on = srv.run([tserving.ServeRequest(rid=i, prompt=p, max_new_tokens=12)
                  for i, p in enumerate(prompts)])
    for rid in off:
        np.testing.assert_array_equal(on[rid], off[rid])
    assert any(len(a) == 2 and a[0] > 0 and a[1] == 0
               for a in accepted.values()), accepted
    # the adaptive cap, against JAX on the same drafter
    kw = dict(spec_draft=oracle, spec_accept_floor=0.5, spec_adapt_warmup=1)
    jo, js = _serve(jserving, jeng, prompts, 12, **kw)
    to, ts = _serve(tserving, teng, prompts, 12, **kw)
    assert ts.stats["spec_k_capped"] > 0
    for key in SPEC_STATS:
        assert ts.stats[key] == js.stats[key], key
    for rid in jo:
        np.testing.assert_array_equal(to[rid], jo[rid])
        np.testing.assert_array_equal(to[rid], off[rid])


def test_spec_serving_knobs_and_drafters(pair, monkeypatch):
    """``spec_decode``/``spec_k``/``spec_draft`` left at None follow the
    environment; a draft engine is wrapped in ``ModelDraft``, whose
    proposals are the draft's greedy ``generate`` of a left-padded
    window."""
    jeng, teng = pair
    monkeypatch.setenv("DS_SPEC_DECODE", "on")
    monkeypatch.setenv("DS_SPEC_K", "2")
    for mod, eng in ((jserving, jeng), (tserving, teng)):
        srv = mod.ServingEngine(eng, num_slots=1, block_size=4)
        assert srv.spec_decode and srv.spec_k == 2
        assert isinstance(srv.draft, (jspec.NGramDraft, tspec.NGramDraft))
    assert not tserving.ServingEngine(teng, num_slots=1,
                                      spec_decode=False).spec_decode
    monkeypatch.setenv("DS_SPEC_DRAFT", "eagle")
    with pytest.raises(ValueError, match="DS_SPEC_DRAFT"):
        tserving.ServingEngine(teng, num_slots=1)
    monkeypatch.delenv("DS_SPEC_DRAFT")
    draft = tspec.make_draft(teng)
    assert isinstance(draft, tspec.ModelDraft)
    ctx = repeating_prompts((20,), teng.cfg.vocab_size)[0]
    window = 16
    got = tspec.ModelDraft(teng, window=window).propose(ctx, 3)
    ref = jspec.ModelDraft(jeng, window=window).propose(ctx, 3)
    np.testing.assert_array_equal(got, ref)
    solo = teng.generate(ctx[-window:][None], 3)[0, window:]
    np.testing.assert_array_equal(got, solo)
    with pytest.raises(ValueError, match="spec_draft"):
        tspec.make_draft(object())


def _sharp_engine(vocab=24, seed=0):
    """A tiny untied model whose head is scaled up: sharp, distinct
    next-token distributions, so a biased sampler would show."""
    cfg = tgpt.GPTConfig(vocab_size=vocab, n_layers=2, n_heads=2, d_model=32,
                         max_seq_len=32, tie_embeddings=False,
                         dtype=torch.float32)
    params = tgpt.init_params(cfg, seed=seed, device="cpu")
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 12.0
    return init_inference(model=(cfg, params), dtype=torch.float32,
                          device="cpu")


def test_sampled_spec_serving_keeps_the_target_distribution():
    """Sampled speculation is lossless: the second generated token (the
    first that the verify decides, through ``spec_verify_tokens``) has
    the target's exact two-step marginal sum_x1 p(x1) p(x2 | x1), by a
    chi-square test at a fixed seed; taking every draft token (the
    n-gram drafter proposes x1 again here) would give the first token's
    marginal, which the same test rejects."""
    eng = _sharp_engine()
    V, prompt = eng.cfg.vocab_size, np.array([3, 7, 1], np.int32)

    def probs(tokens):
        logits, _ = eng._prefill_fn(torch.as_tensor(tokens, dtype=torch.long))
        return tsampling.fp64_dist(logits[:, -1].numpy(), 1.0)

    p1 = probs(prompt[None])[0]
    p2 = probs(np.concatenate([np.repeat(prompt[None], V, 0),
                               np.arange(V)[:, None]], axis=1))
    exact = p1 @ p2
    n = 800
    srv = tserving.ServingEngine(eng, num_slots=8, block_size=4,
                                 num_blocks=32, prefill_chunk=8,
                                 spec_decode=True, spec_k=2)
    out = srv.run([tserving.ServeRequest(rid=i, prompt=prompt,
                                         max_new_tokens=2, temperature=1.0,
                                         seed=1000 + i, logprobs=True)
                   for i in range(n)])
    assert srv.stats["spec_steps"] > 0 and srv.stats["sampled_tokens"] == 2 * n
    counts = np.bincount([out[i][-1] for i in range(n)], minlength=V)

    def pvalue(p):
        keep = p * n >= 5
        obs = np.append(counts[keep], counts[~keep].sum())
        exp = np.append(p[keep], p[~keep].sum()) * n
        return sstats.chisquare(obs, exp).pvalue
    assert np.abs(exact - p1).sum() / 2 > 0.15
    assert pvalue(exact) > 1e-3, (counts, exact * n)
    assert pvalue(p1) < 1e-6
    lps = [lp for r in srv.finished for lp in r.out_logprobs]
    assert len(lps) == 2 * n and np.isfinite(lps).all()


# ---------------------------------------------------------------------------
# generate_speculative
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def drafts(pair):
    """A 1-layer draft of the pair's vocabulary, in both packages."""
    jeng, _ = pair
    fields = dict(vocab_size=jeng.cfg.vocab_size, n_layers=1, n_heads=2,
                  d_model=16, max_seq_len=64)
    jcfg = jgpt.GPTConfig(**fields, dtype=jnp.float32,
                          use_flash_attention=False, remat=False)
    tcfg = tgpt.GPTConfig(**fields, dtype=torch.float32)
    npp = numpy_params(jcfg, seed=5)
    jd = jengine.InferenceEngine(
        config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, npp),
        dtype=jnp.float32)
    td = init_inference(model=(tcfg, params_from_numpy(npp, tcfg,
                                                       device="cpu")),
                        dtype=torch.float32, device="cpu")
    return jd, td


def test_generate_speculative_matches_target_and_jax(pair, drafts):
    """Greedy output equals ``target.generate`` and JAX's
    ``generate_speculative`` for several gammas; sampled output equals
    JAX's at the same seed (the same numpy generator and fp64 math); a
    perfect draft accepts everything; a vocabulary mismatch raises."""
    jeng, teng = pair
    jd, td = drafts
    toks = np.random.default_rng(0).integers(
        1, jeng.cfg.vocab_size, (2, 7)).astype(np.int32)
    ref = teng.generate(toks, max_new_tokens=12)
    for gamma in (1, 3):
        got, st = tspeculative.generate_speculative(
            teng, td, toks, max_new_tokens=12, gamma=gamma,
            return_stats=True)
        jgot, jst = jspeculative.generate_speculative(
            jeng, jd, toks, max_new_tokens=12, gamma=gamma,
            return_stats=True)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, jgot)
        assert st == jst
    got = tspeculative.generate_speculative(teng, td, toks, 10, gamma=3,
                                            temperature=0.9, top_k=8,
                                            seed=11)
    jgot = jspeculative.generate_speculative(jeng, jd, toks, 10, gamma=3,
                                             temperature=0.9, top_k=8,
                                             seed=11)
    np.testing.assert_array_equal(got, jgot)
    got, st = tspeculative.generate_speculative(
        teng, teng, toks[:1], max_new_tokens=12, gamma=4, return_stats=True)
    np.testing.assert_array_equal(got, ref[:1])
    assert st["accepted_per_round"] >= 3.3 and st["rounds"] <= 3, st
    cfg = tgpt.GPTConfig(vocab_size=96, n_layers=1, n_heads=2, d_model=16,
                         max_seq_len=64, dtype=torch.float32)
    bad = init_inference(model=(cfg, tgpt.init_params(cfg, 2, device="cpu")),
                         dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        tspeculative.generate_speculative(teng, bad, toks)

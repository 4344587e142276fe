"""Parity of the port's serving path (deepspeed_tpu_torch.inference) with
the JAX package on the CPU.

Both packages get the same numpy parameters (through
``params_from_numpy``) and the same seeded requests: the static
``generate`` path, the paged slot programs and ``ServingEngine.run``
must agree — logits to rtol/atol 1e-5 in float32, greedy token streams
identically, across chunked prefill, slots joining a running batch and
eviction/requeue. The configurations are a gpt2-dialect tiny model
(layernorm, gelu, learned positions, tied head) and llama-tiny cut to two
layers with a sliding window (rmsnorm, swiglu, rotary, GQA).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import engine as jengine
from deepspeed_tpu.inference import sampling as jsampling
from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference import sampling as tsampling
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.inference.paged_cache import (CacheExhausted,
                                                       PagedKVCache)
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.runtime.checkpointing import CheckpointError
from test_torch_model import numpy_params, one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
CONFIGS = {
    "gpt2": dict(vocab_size=128, n_layers=2, n_heads=4, d_model=32,
                 max_seq_len=64),
    "llama": dict(jgpt.PRESETS["llama-tiny"], n_layers=2, attn_window=8,
                  max_seq_len=64),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request, devices):
    """(JAX engine, port engine) over the same float32 parameters."""
    fields = CONFIGS[request.param]
    jcfg = jgpt.GPTConfig(**fields, dtype=jnp.float32,
                          use_flash_attention=False, remat=False)
    tcfg = tgpt.GPTConfig(**fields, dtype=torch.float32)
    npp = numpy_params(jcfg)
    tp = params_from_numpy(npp, tcfg, device="cpu")
    jeng = jengine.InferenceEngine(
        config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, npp),
        dtype=jnp.float32)
    teng = init_inference(model=(tcfg, tp), dtype=torch.float32,
                          device="cpu")
    return jeng, teng


def prompts_of(lengths, vocab, seed=1):
    r = np.random.default_rng(seed)
    return [r.integers(1, vocab, n).astype(np.int32) for n in lengths]


# ---------------------------------------------------------------------------
# static path: _prefill_fn / _decode_fn / generate
# ---------------------------------------------------------------------------

def test_static_logits_and_generate_match_jax(pair):
    jeng, teng = pair
    V = jeng.cfg.vocab_size
    tokens = np.stack(prompts_of((9, 9), V, seed=5))
    mask = (np.arange(9)[None] >= np.array([0, 3])[:, None]).astype(np.float32)
    for m in (None, mask):
        lj, cj = jeng._prefill(jeng.params, jnp.asarray(tokens),
                               None if m is None else jnp.asarray(m))
        lt, ct = teng._prefill_fn(torch.from_numpy(tokens).long(),
                                  None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        row_len = None if m is None else m.sum(1).astype(np.int64)
        tok = np.asarray(lj)[:, -1].argmax(-1)
        for i in range(3):     # teacher-forced with JAX's greedy tokens
            rp = None if row_len is None else row_len + i
            lj, cj = jeng._decode(
                jeng.params, cj, jnp.asarray(tok[:, None], jnp.int32),
                jnp.asarray(9 + i, jnp.int32),
                None if rp is None else jnp.asarray(rp, jnp.int32))
            lt, ct = teng._decode_fn(
                ct, torch.from_numpy(tok[:, None]).long(), 9 + i,
                None if rp is None else torch.from_numpy(rp))
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
            tok = np.asarray(lj)[:, -1].argmax(-1)
        np.testing.assert_array_equal(
            teng.generate(tokens, 6, attention_mask=m),
            jeng.generate(tokens, 6, attention_mask=m))


# ---------------------------------------------------------------------------
# paged slot programs: prefill_into_slot / decode_slots
# ---------------------------------------------------------------------------

def test_paged_slot_programs_match_jax(pair):
    jeng, teng = pair
    cfg = jeng.cfg
    # the pool, table and chunk shapes of SERVE_KW, so JAX compiles each
    # slot program once for this file
    bs, C, N = SERVE_KW["block_size"], SERVE_KW["prefill_chunk"], 25
    NB = jgpt.decode_geometry(cfg, bs)[0]
    L, Hkv, Dh = cfg.n_layers, cfg.kv_heads, cfg.head_dim
    shape = (L, N, bs, Hkv, Dh)
    kj, vj = jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)
    kt, vt = torch.zeros(shape), torch.zeros(shape)
    tables = np.zeros((2, NB), np.int32)
    tables[:, :12] = np.arange(1, N).reshape(2, 12)
    prompts = prompts_of((7, 10), cfg.vocab_size, seed=6)
    nxt = np.zeros(2, np.int32)
    for slot, p in enumerate(prompts):
        for start in range(0, len(p), C):
            n = min(C, len(p) - start)
            chunk = np.zeros(C, np.int32)
            chunk[:n] = p[start:start + n]
            lj, kj, vj = jeng.prefill_into_slot(kj, vj, tables[slot], chunk,
                                                start, n)
            lt, kt, vt = teng.prefill_into_slot(kt, vt, tables[slot], chunk,
                                                start, n)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        nxt[slot] = np.asarray(lj)[0, -1].argmax()
    lengths = np.array([len(p) for p in prompts], np.int32)
    for step, active in enumerate(([True, True], [True, False], [True, True])):
        active = np.array(active)
        lj, kj, vj = jeng.decode_slots(kj, vj, tables, lengths, nxt, active)
        lt, kt, vt = teng.decode_slots(kt, vt, tables, lengths, nxt, active)
        np.testing.assert_allclose(lt.numpy()[active],
                                   np.asarray(lj)[active], **TOL)
        nxt = np.where(active, np.asarray(lj)[:, -1].argmax(-1), nxt)
        lengths = lengths + active
    # every allocated block holds the same K/V (block 0 is trash)
    np.testing.assert_allclose(kt.numpy()[:, 1:], np.asarray(kj)[:, 1:],
                               **TOL)
    np.testing.assert_allclose(vt.numpy()[:, 1:], np.asarray(vj)[:, 1:],
                               **TOL)
    # with an all-greedy sample_state the step also emits argmax tokens
    # and their log-probabilities
    lt, toks, lps, kt, vt = teng.decode_slots(
        kt, vt, tables, lengths, nxt, np.array([True, True]),
        sample_state=tsampling.greedy_state(2, cfg.vocab_size))
    np.testing.assert_array_equal(toks.numpy(), lt[:, -1].argmax(-1).numpy())
    np.testing.assert_allclose(
        lps.numpy(), torch.log_softmax(lt[:, -1], -1).max(-1).values.numpy(),
        rtol=1e-6)


def test_decode_slots_masks_capacity_overflow_write():
    """A slot at its full block budget writes its new K/V to the trash
    block, never into its own last live block."""
    cfg = tgpt.GPTConfig(vocab_size=64, n_layers=2, n_heads=4, d_model=32,
                         max_seq_len=12, dtype=torch.float32)
    eng = InferenceEngine(config=cfg, dtype=torch.float32, device="cpu",
                          params=tgpt.init_params(cfg, 0, device="cpu"))
    bs, NB = 4, 3
    g = torch.Generator().manual_seed(0)
    kp = torch.randn((2, 8, bs, 4, 8), generator=g)
    vp = torch.randn((2, 8, bs, 4, 8), generator=g)
    k0, v0 = kp.clone(), vp.clone()
    tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    eng.decode_slots(kp, vp, tables, np.array([NB * bs, 5], np.int32),
                     np.array([3, 4], np.int32), np.array([True, True]))
    assert torch.equal(kp[:, 1:4], k0[:, 1:4])
    assert not torch.equal(kp[:, 5, 1], k0[:, 5, 1])
    assert not torch.equal(vp[:, 5, 1], v0[:, 5, 1])


# ---------------------------------------------------------------------------
# ServingEngine.run: identical token streams
# ---------------------------------------------------------------------------

# one pool, table and chunk geometry for every JAX serving run of a
# configuration, so its slot programs compile once
SERVE_KW = dict(num_slots=2, block_size=4, num_blocks=24, prefill_chunk=8)
SCENARIOS = {
    # mixed prompt lengths, two requests decode in one step
    "mixed": dict(lengths=(5, 9, 12, 3), n_new=6),
    # a prompt longer than the chunk prefills over several iterations
    "chunked": dict(lengths=(40,), n_new=4),
    # zero watermark: decode growth needs 25 blocks of the 24, which
    # forces a preemption
    "eviction": dict(lengths=(30, 28), n_new=(22, 20), watermark=0),
}


def _requests(mod, prompts, n_new, **kw):
    if isinstance(n_new, int):
        n_new = [n_new] * len(prompts)
    return [mod.ServeRequest(rid=i, prompt=p, max_new_tokens=n, **kw)
            for i, (p, n) in enumerate(zip(prompts, n_new))]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_serving_streams_match_jax(pair, scenario):
    jeng, teng = pair
    sc = SCENARIOS[scenario]
    prompts = prompts_of(sc["lengths"], jeng.cfg.vocab_size, seed=9)
    js = jserving.ServingEngine(jeng, **SERVE_KW)
    ts = tserving.ServingEngine(teng, **SERVE_KW)
    if "watermark" in sc:
        js.cache.watermark = ts.cache.watermark = sc["watermark"]
    jo = js.run(_requests(jserving, prompts, sc["n_new"]))
    to = ts.run(_requests(tserving, prompts, sc["n_new"]))
    assert sorted(to) == sorted(jo)
    for rid in jo:
        np.testing.assert_array_equal(to[rid], jo[rid])
    for key in ("completed", "evictions", "prefill_chunks", "peak_occupancy",
                "decode_steps"):
        assert ts.stats[key] == js.stats[key], key
    if scenario == "mixed":
        assert ts.stats["peak_occupancy"] > 1
        for i, p in enumerate(prompts):    # the greedy parity contract
            np.testing.assert_array_equal(
                to[i], teng.generate(p[None], sc["n_new"])[0])
    if scenario == "eviction":
        assert ts.stats["evictions"] >= 1
    if scenario == "chunked":
        assert ts.stats["prefill_chunks"] == 5


def test_admission_waits_when_cache_full(pair):
    """One request's worth of blocks (plus the watermark): the second
    request waits in the queue instead of claiming a slot, then runs."""
    _, teng = pair
    prompts = prompts_of((8, 8), teng.cfg.vocab_size, seed=4)
    srv = tserving.ServingEngine(teng, num_slots=2, block_size=4,
                                 num_blocks=5, prefill_chunk=8)
    out = srv.run(_requests(tserving, prompts, 4))
    assert srv.stats["peak_occupancy"] == 1
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(out[i], teng.generate(p[None], 4)[0])


def test_serving_eos_stop_matches_jax(pair):
    jeng, teng = pair
    p = prompts_of((6,), jeng.cfg.vocab_size, seed=2)[0]
    ref = teng.generate(p[None], 8)[0]
    eos = int(ref[len(p) + 2])
    first = len(p) + int(np.argmax(ref[len(p):] == eos))
    reqs = dict(max_new_tokens=8, eos_id=eos)
    to = tserving.ServingEngine(teng, **SERVE_KW).run(
        [tserving.ServeRequest(rid=0, prompt=p, **reqs)])
    jo = jserving.ServingEngine(jeng, **SERVE_KW).run(
        [jserving.ServeRequest(rid=0, prompt=p, **reqs)])
    np.testing.assert_array_equal(to[0], ref[:first + 1])
    np.testing.assert_array_equal(to[0], jo[0])


def test_staggered_arrival_joins_running_batch(pair):
    """A request arriving mid-decode joins the running batch and both
    streams stay equal to solo generate."""
    _, teng = pair
    p1, p2 = prompts_of((6, 8), teng.cfg.vocab_size, seed=11)
    ref1 = teng.generate(p1[None], 12)[0]
    ref2 = teng.generate(p2[None], 6)[0]
    srv = tserving.ServingEngine(teng, num_slots=2, block_size=4,
                                 num_blocks=24, prefill_chunk=8)
    srv.submit(tserving.ServeRequest(rid="r1", prompt=p1, max_new_tokens=12))
    occ, step = [], 0
    while srv.busy:
        if step == 4:
            srv.submit(tserving.ServeRequest(rid="r2", prompt=p2,
                                             max_new_tokens=6), now=step)
        occ.append(srv.step(step))
        step += 1
    assert max(occ) == 2
    done = {r.rid: r for r in srv.finished}
    np.testing.assert_array_equal(done["r1"].tokens, ref1)
    np.testing.assert_array_equal(done["r2"].tokens, ref2)
    assert done["r2"].first_token_at < done["r1"].finished_at


# ---------------------------------------------------------------------------
# allocator unit tests (mirror tests/test_serving.py)
# ---------------------------------------------------------------------------

def _tiny_cfg():
    return tgpt.GPTConfig(vocab_size=128, n_layers=2, n_heads=4, d_model=32,
                          max_seq_len=64, dtype=torch.float32)


def test_paged_allocator_alloc_append_free():
    c = PagedKVCache(_tiny_cfg(), num_slots=2, block_size=4, num_blocks=6,
                     device="cpu")
    assert c.free_blocks == 6 and c.used_blocks == 0
    c.allocate(0, 5)
    assert c.free_blocks == 4 and c.used_blocks == 2
    assert (c.tables[0, :2] > 0).all()
    c.advance(0, 5)
    c.ensure_capacity(0, 8)
    assert c.used_blocks == 2
    c.ensure_capacity(0, 9)
    assert c.used_blocks == 3 and c.capacity_tokens(0) == 12
    c.allocate(1, 4)
    assert c.free_blocks == 2
    c.free(0)
    assert c.free_blocks == 5 and not c.active[0]
    assert (c.tables[0] == 0).all() and c.lengths[0] == 0
    c.allocate(0, 20)
    assert c.free_blocks == 0


def test_paged_allocator_exhaustion_and_watermark():
    c = PagedKVCache(_tiny_cfg(), num_slots=2, block_size=4, num_blocks=3,
                     watermark=1, device="cpu")
    with pytest.raises(CacheExhausted):
        c.allocate(0, 16)
    c.allocate(0, 12)
    with pytest.raises(CacheExhausted):
        c.ensure_capacity(0, 13)
    c.free(0)
    assert c.can_admit(8) and not c.can_admit(12)


def test_paged_allocator_hardening_and_stats():
    c = PagedKVCache(_tiny_cfg(), num_slots=2, block_size=4, num_blocks=6,
                     device="cpu")
    c.allocate(0, 5)
    with pytest.raises(ValueError, match="already allocated"):
        c.allocate(0, 4)
    c.advance(0, 5)
    s = c.stats()
    assert s["used_blocks"] == 2 and s["free_blocks"] == 4
    assert s["held_blocks"] == 2
    assert s["fragmentation"] == round(1 - 5 / 8, 4)
    bid = c._owned[0][0]
    c.free(0)
    c.free(0)
    assert c.free_blocks == 6 and c.stats()["fragmentation"] == 0.0
    with pytest.raises(ValueError, match="double free"):
        c._release(bid)
    with pytest.raises(ValueError, match="foreign block"):
        c._release(0)
    with pytest.raises(ValueError, match="out of range"):
        c.allocate(5, 4)


def test_paged_cache_hbm_budget_watermark(devices):
    cfg = _tiny_cfg()
    per_tok = tgpt.kv_bytes_per_token(cfg, torch.float32)
    c = PagedKVCache(cfg, num_slots=2, block_size=4,
                     hbm_budget_bytes=per_tok * 4 * 10, dtype=torch.float32,
                     device="cpu")
    assert c.free_blocks == 10
    c.allocate(0, 6)
    assert c.used_block_bytes() == 2 * 4 * per_tok
    assert c.static_equivalent_bytes(2) == 2 * 64 * per_tok
    jcfg = jgpt.GPTConfig(vocab_size=128, n_layers=2, n_heads=4, d_model=32,
                          max_seq_len=64)
    assert per_tok == jgpt.kv_bytes_per_token(jcfg, jnp.float32)
    with pytest.raises(ValueError):
        PagedKVCache(cfg, num_slots=1, block_size=4, hbm_budget_bytes=1,
                     device="cpu")


# ---------------------------------------------------------------------------
# the sampled path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knobs", [(0.7, 0, 1.0), (1.3, 5, 1.0),
                                   (0.9, 0, 0.8), (1.0, 12, 0.6)])
def test_truncation_matches_fp64_dist(knobs):
    """temperature -> top-k -> top-p gives JAX's fp64 reference
    distribution (float32 pipeline vs float64 reference: atol 1e-6)."""
    temp, top_k, top_p = knobs
    logits = np.random.default_rng(3).standard_normal((3, 40)) * 2
    z = tsampling.truncate(
        torch.tensor(logits, dtype=torch.float32),
        torch.full((3,), temp), torch.full((3,), top_k),
        torch.full((3,), top_p), torch.ones(3),
        torch.zeros(3, 40, dtype=torch.bool))
    got = torch.softmax(z.double(), dim=-1).numpy()
    ref = jsampling.fp64_dist(logits.astype(np.float32), temp, top_k, top_p)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_repetition_penalty_and_draw_distribution():
    logits = torch.tensor([[2.0, -1.0, 0.5, 0.0]])
    seen = torch.tensor([[True, True, False, False]])
    z = tsampling.truncate(logits, torch.ones(1), torch.zeros(1, dtype=int),
                           torch.ones(1), torch.full((1,), 2.0), seen)
    assert torch.equal(z, torch.tensor([[1.0, -2.0, 0.5, 0.0]]))
    # Gumbel-max draws follow softmax(z): 4000 positions of one seed
    V, n = 6, 4000
    lg = torch.tensor(np.linspace(-1, 1, V), dtype=torch.float32)[None]
    counts = np.zeros(V)
    for pos in range(n):
        tok, _ = tsampling.sample_tokens(
            lg, [7], [pos], [1.0], [0], [1.0], [1.0], np.zeros((1, V), bool))
        counts[int(tok[0])] += 1
    np.testing.assert_allclose(counts / n, torch.softmax(lg, -1)[0].numpy(),
                               atol=0.03)


def test_sampled_streams_survive_eviction(pair):
    """A sampled stream is a pure function of (seed, tokens generated):
    the same requests give the same tokens with and without a
    preemption, and greedy lanes in the mixed batch stay greedy."""
    _, teng = pair
    prompts = prompts_of((10, 9), teng.cfg.vocab_size, seed=9)

    def run(num_blocks):
        srv = tserving.ServingEngine(teng, num_slots=2, block_size=4,
                                     num_blocks=num_blocks, prefill_chunk=8)
        srv.cache.watermark = 0
        reqs = [tserving.ServeRequest(rid=0, prompt=prompts[0],
                                      max_new_tokens=12, temperature=0.8,
                                      top_k=20, top_p=0.9, seed=5,
                                      logprobs=True),
                tserving.ServeRequest(rid=1, prompt=prompts[1],
                                      max_new_tokens=10)]
        return srv.run(reqs), srv
    roomy, s1 = run(40)
    tight, s2 = run(7)
    assert s1.stats["evictions"] == 0 and s2.stats["evictions"] >= 1
    for rid in roomy:
        np.testing.assert_array_equal(tight[rid], roomy[rid])
    np.testing.assert_array_equal(
        roomy[1], teng.generate(prompts[1][None], 10)[0])
    sampled = next(r for r in s1.finished if r.rid == 0)
    assert len(sampled.out_logprobs) == 12
    assert all(lp <= 0.0 for lp in sampled.out_logprobs)
    assert s1.stats["sampled_tokens"] == 12


# ---------------------------------------------------------------------------
# what waits for later slices
# ---------------------------------------------------------------------------

def test_waiting_features_raise(pair):
    jeng, teng = pair
    # prefix_cache, spec_decode, host_tier, decode_horizon, telemetry, the
    # fault-tolerance knobs and LoRA serving are ported: their cases are
    # the parity tests of tests/test_torch_prefix_cache.py,
    # test_torch_spec_decode.py, test_torch_host_tier.py,
    # test_torch_horizon.py, test_torch_telemetry.py, test_torch_chaos.py,
    # test_torch_flight.py and test_torch_adapter_serving.py. The
    # prefill-only role is taken as JAX takes it: a finished prefill
    # emits its first token and parks in handoff for the router
    # (tests/test_torch_disagg.py drives the fleet)
    p, = prompts_of((9,), jeng.cfg.vocab_size, seed=3)
    parked = []
    for mod, eng in ((jserving, jeng), (tserving, teng)):
        srv = mod.ServingEngine(eng, prefill_only=True, **SERVE_KW)
        req = mod.ServeRequest(rid="p", prompt=p, max_new_tokens=4)
        srv.submit(req)
        while not srv.ready_handoffs():
            srv.step()
        parked.append((srv.prefill_only, req.state, list(req.out),
                       [slot for slot, _ in srv.ready_handoffs()],
                       srv.release_handoff("p"),
                       srv.cache.stats()["free_blocks"], srv.busy))
    assert parked[1] == parked[0]
    assert parked[1][:2] == (True, "handoff") and len(parked[1][2]) == 1
    # lora_serve=True builds the adapter pool the JAX engine builds
    pools = [mod.ServingEngine(eng, num_slots=1, lora_serve=True).adapters
             for mod, eng in ((jserving, jeng), (tserving, teng))]
    assert pools[1].stats() == pools[0].stats()
    assert pools[1].blocks_per_adapter == pools[0].blocks_per_adapter == 2
    # the fault-tolerance knobs serve: a queue of one sheds the second
    # request at once, a generous budget never trips the watchdog
    srv = tserving.ServingEngine(teng, num_slots=1, block_size=4,
                                 max_queue=1, step_time_budget_s=60.0,
                                 flight_recorder=False)
    kept, shed = (tserving.ServeRequest(rid=i, prompt=np.ones(3, np.int32),
                                        max_new_tokens=2) for i in range(2))
    assert srv.submit(kept) and not srv.submit(shed)
    assert srv.stats["backpressure"] == 1.0 and shed.state == "shed"
    out = srv.run()
    assert kept.state == "done" and len(out[0]) == 5 and len(out[1]) == 3
    assert srv.stats["watchdog_trips"] == 0 and srv.stats["shed"] == 1
    tserving.ServingEngine(teng, num_slots=1, spec_decode=False,
                           decode_horizon=1, kv_quant="off")
    # the host tier without the prefix cache is inert, as in JAX
    assert not tserving.ServingEngine(teng, num_slots=1,
                                      host_tier=True).host_tier
    with pytest.raises(ValueError, match="DS_DECODE_HORIZON"):
        tserving.ServingEngine(teng, num_slots=1, decode_horizon=33)
    # an unknown knob is Python's own TypeError, as in JAX
    with pytest.raises(TypeError, match="unexpected keyword.*no_such_knob"):
        tserving.ServingEngine(teng, num_slots=1, no_such_knob=1)
    model = (teng.cfg, teng.params)
    # tensor parallelism needs a process group of mp_size ranks
    with pytest.raises(ValueError, match="init_distributed"):
        InferenceEngine(model, device="cpu", mp_size=2)
    with pytest.raises(CheckpointError, match="latest"):
        InferenceEngine(model, device="cpu", checkpoint="ckpt")
    srv = tserving.ServingEngine(teng, num_slots=1, block_size=4)
    with pytest.raises(ValueError, match="max_seq_len"):
        srv.submit(tserving.ServeRequest(
            rid=0, prompt=np.ones(60, np.int32), max_new_tokens=30))


# the JAX ServingEngine's sub-knobs with their JAX defaults
# (deepspeed_tpu/inference/serving.py, ServingEngine.__init__)
JAX_SUB_KNOBS = dict(watchdog_grace=2, max_retries=3, retry_backoff_s=0.02,
                     spec_accept_floor=0.125, spec_adapt_warmup=4,
                     spill_watermark=None, lora_pool_mb=None,
                     lora_pool_blocks=None, lora_max_rank=None,
                     lora_rank_block=None, flight_dir=None)


def test_jax_engine_keywords_are_taken():
    """``replace_with_kernel_inject`` is taken at any value, as the JAX
    engine takes it; ``decode_impl`` other than None names a switch the
    port does not have and raises ValueError in both engines."""
    fields = CONFIGS["gpt2"]
    tcfg = tgpt.GPTConfig(**fields, dtype=torch.float32)
    params = tgpt.init_params(tcfg, seed=0, device="cpu")
    for inject in (True, False):
        eng = init_inference(model=(tcfg, params), dtype=torch.float32,
                             replace_with_kernel_inject=inject, device="cpu")
        assert eng.generate(np.ones((1, 3), np.int32), 2).shape == (1, 5)
    init_inference(model=(tcfg, params), decode_impl=None, device="cpu")
    with pytest.raises(ValueError, match="dispatches by device"):
        init_inference(model=(tcfg, params), decode_impl="gather",
                       device="cpu")
    eng = init_inference(model=(tcfg, params), dtype=torch.float32,
                         device="cpu")
    tserving.ServingEngine(eng, num_slots=1, decode_impl=None)
    for impl in ("gather", "pallas"):
        with pytest.raises(ValueError, match="no implementation switch"):
            tserving.ServingEngine(eng, num_slots=1, decode_impl=impl)


def test_jax_sub_knobs_at_their_defaults():
    """Each sub-knob of the JAX constructor is taken at its JAX default,
    all together too, and the ported ones at other values; an unknown
    knob raises Python's own TypeError, as in JAX."""
    fields = CONFIGS["gpt2"]
    tcfg = tgpt.GPTConfig(**fields, dtype=torch.float32)
    eng = init_inference(model=(tcfg, tgpt.init_params(tcfg, seed=0,
                                                       device="cpu")),
                         dtype=torch.float32, device="cpu")
    for knob, value in JAX_SUB_KNOBS.items():
        tserving.ServingEngine(eng, num_slots=1, **{knob: value})
    tserving.ServingEngine(eng, num_slots=1, **JAX_SUB_KNOBS)
    tserving.ServingEngine(eng, watchdog_grace=2.0)
    # the fault-tolerance slice's sub-knobs take any value, as in JAX
    srv = tserving.ServingEngine(eng, num_slots=1, watchdog_grace=5,
                                 max_retries=0, retry_backoff_s=0.5,
                                 flight_dir="elsewhere")
    assert (srv.watchdog_grace, srv.max_retries, srv.retry_backoff_s,
            srv.flight.enabled) == (5, 0, 0.5, False)
    # the prefill-only role is a plain flag, as in JAX
    for flag in (True, False):
        assert tserving.ServingEngine(eng, num_slots=1,
                                      prefill_only=flag).prefill_only is flag
    # the LoRA slice's sub-knobs take any value, as in JAX: read only with
    # lora_serve on, where they size the adapter pool
    for knob, value in (("lora_pool_blocks", 4), ("lora_max_rank", 8)):
        assert tserving.ServingEngine(eng, num_slots=1,
                                      **{knob: value}).adapters is None
    pool = tserving.ServingEngine(eng, num_slots=1, lora_serve=True,
                                  lora_pool_blocks=4, lora_max_rank=8,
                                  lora_rank_block=8).adapters
    assert (pool.stats()["pool_blocks"], pool.num_blocks,
            pool.blocks_per_adapter) == (4, 5, 1)
    # the host tier's sub-knob is ported with it
    assert tserving.ServingEngine(
        eng, num_slots=1, spill_watermark=4).cache.spill_watermark == 4
    with pytest.raises(TypeError, match="unexpected keyword.*watchdog"):
        tserving.ServingEngine(eng, num_slots=1, watchdog=2)


def test_serving_non_drain_raises(pair):
    """run() that hits max_steps raises instead of returning partial
    output; the finished requests stay on the engine."""
    _, teng = pair
    p1, p2 = prompts_of((5, 6), teng.cfg.vocab_size, seed=17)
    srv = tserving.ServingEngine(teng, num_slots=2, block_size=4,
                                 num_blocks=24)
    with pytest.raises(RuntimeError, match="did not drain"):
        srv.run([tserving.ServeRequest(rid="slow", prompt=p1,
                                       max_new_tokens=30),
                 tserving.ServeRequest(rid="quick", prompt=p2,
                                       max_new_tokens=2)], max_steps=5)
    assert [r.rid for r in srv.finished] == ["quick"]
    np.testing.assert_array_equal(srv.finished[0].tokens,
                                  teng.generate(p2[None], 2)[0])
    assert srv.stats["steps"] == 6

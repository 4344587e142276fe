"""The port's multi-step decode horizon and the request fields ``stop`` and
``n``, against the JAX package and against the port's own one-token
decode, on the CPU in float32.

``ServingEngine(decode_horizon=N)`` runs up to N decode iterations in one
``InferenceEngine.decode_horizon`` call. Its streams must equal the N = 1
streams token for token: greedy, sampled (the port's host-drawn noise is
drawn for the whole horizon before its loop), with a stop sequence hit
mid-horizon, and with eviction and requeue in a small pool, in both pool
modes. Greedy streams at N = 1 and N = 4 equal the JAX package's at the
same N (the ``pair`` fixture's gpt2 and llama-tiny engines and the
``SERVE_KW`` geometry of ``tests/test_torch_serving.py``, so each JAX
program compiles once). ``stop`` and ``n`` serve as in JAX: the same
streams, ``stop_hits``, candidate rids and seeds.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import sampling as jsampling
from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.utils import env as jenv
from deepspeed_tpu_torch.inference import sampling as tsampling
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.utils import env as tenv
from test_torch_serving import (SERVE_KW, one_torch_thread,  # noqa: F401
                                pair, prompts_of)


def run(srv, reqs):
    out = srv.run(reqs)
    return {rid: out[rid].tolist() for rid in out}


def requests(mod, prompts, n_new, **kw):
    return [mod.ServeRequest(rid=i, prompt=p, max_new_tokens=n_new, **kw)
            for i, p in enumerate(prompts)]


def sampled(mod, prompts, n_new):
    """Half greedy, half sampled with their own seeds and knobs (one with
    a repetition penalty, which the horizon marks on the device)."""
    out = []
    for i, p in enumerate(prompts):
        kw = {}
        if i % 2:
            kw = dict(temperature=0.8, top_k=20, top_p=0.9, seed=11 + i,
                      repetition_penalty=1.3 if i == 1 else None)
        out.append(mod.ServeRequest(rid=i, prompt=p, max_new_tokens=n_new,
                                    logprobs=True, **kw))
    return out


# ---------------------------------------------------------------------------
# the flag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("raw", ["", "1", "4", "32", "0", "33", "-2", "x"])
def test_decode_horizon_flag_resolves_like_jax(raw, monkeypatch):
    """``DS_DECODE_HORIZON`` resolves as in JAX: 1 unset, the integer in
    1..32, ``ValueError`` outside it or on a non-integer; an explicit
    value wins over the flag."""
    monkeypatch.setenv("DS_DECODE_HORIZON", raw)
    got = []
    for mod in (tenv, jenv):
        try:
            got.append(mod.resolve_decode_horizon())
        except ValueError as e:
            got.append(type(e))
    assert got[0] == got[1]
    assert tenv.MAX_DECODE_HORIZON == jenv.MAX_DECODE_HORIZON == 32
    assert tenv.resolve_decode_horizon(8) == jenv.resolve_decode_horizon(8)


def test_decode_horizon_flag_reaches_the_engine(pair, monkeypatch):
    _, teng = pair
    monkeypatch.setenv("DS_DECODE_HORIZON", "4")
    assert tserving.ServingEngine(teng, num_slots=1).decode_horizon == 4
    assert tserving.ServingEngine(teng, num_slots=1,
                                  decode_horizon=2).decode_horizon == 2
    monkeypatch.setenv("DS_DECODE_HORIZON", "40")
    with pytest.raises(ValueError, match="DS_DECODE_HORIZON"):
        tserving.ServingEngine(teng, num_slots=1)


# ---------------------------------------------------------------------------
# the engine call
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_horizon_iteration_zero_is_decode_slots(pair, kv_quant):
    """Iteration 0 of ``decode_horizon`` is ``decode_slots`` bit for bit
    (tokens, logprobs, pools), with one slot sampled and one inactive;
    a budget of 1 freezes a lane after one token."""
    _, teng = pair
    V = teng.cfg.vocab_size
    srv = tserving.ServingEngine(teng, kv_quant=kv_quant, **SERVE_KW)
    srv.run([tserving.ServeRequest(rid=0, prompt=prompts_of((9,), V)[0],
                                   max_new_tokens=1)])
    c = srv.cache
    c.allocate(0, 14)
    c.allocate(1, 14)
    c.lengths[:] = (9, 13)
    state = srv.sampler
    state.admit(0, tsampling.SamplingParams(temperature=0.7, seed=3))
    lanes = state.lanes(np.array([4, 2]))
    pools = [t.clone() for t in c._pools()]
    args = (c.tables, c.lengths, np.array([5, 7], np.int32),
            np.array([True, False]))
    sc = dict(k_scale=c.k_scale, v_scale=c.v_scale)
    one = teng.decode_slots(c.k, c.v, *args, sample_state=lanes, **sc)
    after_one = [t.clone() for t in c._pools()]
    for t, p in zip(c._pools(), pools):
        t.copy_(p)
    W, S = tserving.HORIZON_STOP_WIDTH, tserving.HORIZON_MAX_STOPS
    hz = teng.decode_horizon(
        c.k, c.v, *args, 3, np.array([1, 3]), np.full(2, -1),
        np.zeros((2, S, W)), np.zeros((2, S)), np.full((2, W), -1),
        sample_state=lanes, **sc)
    assert torch.equal(hz[0][0], one[1]) and torch.equal(hz[1][0], one[2])
    assert hz[2].tolist() == [1, 0] and hz[3].tolist() == [True, True]
    for t, p in zip(c._pools(), after_one):     # block 0 is the trash
        assert torch.equal(t[:, 1:], p[:, 1:])


# ---------------------------------------------------------------------------
# serving: N > 1 against N = 1, and against JAX
# ---------------------------------------------------------------------------

def test_horizon_greedy_streams_match_jax(pair):
    """Greedy streams at N = 1 and N = 4 equal the JAX package's at the
    same N, and the port's stats count one decode dispatch per horizon
    as JAX's do."""
    jeng, teng = pair
    prompts = prompts_of((5, 9, 12, 3), jeng.cfg.vocab_size, seed=9)
    for n in (1, 4):
        js = jserving.ServingEngine(jeng, decode_horizon=n, **SERVE_KW)
        ts = tserving.ServingEngine(teng, decode_horizon=n, **SERVE_KW)
        jo = run(js, requests(jserving, prompts, 10))
        to = run(ts, requests(tserving, prompts, 10))
        assert to == jo
        for key in ("completed", "prefill_chunks", "decode_steps", "steps"):
            assert ts.stats[key] == js.stats[key], (n, key)
        assert ts._step_clock == js._step_clock
        if n == 4:
            assert ts.stats["decode_steps"] < 40 // 2


SCENARIOS = {
    # greedy and sampled lanes side by side
    "sampled": dict(lengths=(5, 9, 12, 3), n_new=11),
    # stops taken from the N = 1 streams: two-token stops hit
    # mid-horizon, a 9-token stop the device leaves to the host
    "stop": dict(lengths=(5, 9, 12, 3), n_new=14, stop=True),
    # a pool that forces eviction and requeue (the horizon shortens when
    # the pool is dry)
    "eviction": dict(lengths=(30, 28), n_new=22, watermark=0),
}


def _serve(teng, sc, n, kv_quant, stops=None):
    srv = tserving.ServingEngine(teng, decode_horizon=n, kv_quant=kv_quant,
                                 **SERVE_KW)
    if "watermark" in sc:
        srv.cache.watermark = sc["watermark"]
    reqs = sampled(tserving, prompts_of(sc["lengths"], teng.cfg.vocab_size,
                                        seed=9), sc["n_new"])
    for r in reqs:
        r.stop = None if stops is None else stops.get(r.rid)
    out = run(srv, reqs)
    lps = {r.rid: r.out_logprobs for r in reqs}
    return out, lps, srv


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_horizon_streams_equal_one_token_decode(pair, scenario, kv_quant):
    """The port's streams at N = 2, 4 and 8 equal its own N = 1 streams,
    in both pool modes, and so do the logprobs where nothing is evicted.
    (A horizon takes its blocks earlier, so a request is evicted at
    another token than at N = 1; the re-prefill of its tokens rounds
    differently from their decode, in the last bits in float32 and by
    the requantization of the blocks with int8 pools, so the logprobs of
    an evicted request are not the N = 1 run's bits.)"""
    _, teng = pair
    sc = SCENARIOS[scenario]
    ref, ref_lps, srv1 = _serve(teng, sc, 1, kv_quant)
    stops = None
    if sc.get("stop"):
        plen = {i: len(p) for i, p in enumerate(
            prompts_of(sc["lengths"], teng.cfg.vocab_size, seed=9))}
        gen = {i: ref[i][plen[i]:] for i in ref}
        stops = {0: [[999, 998], gen[0][5:7]], 1: [gen[1][2:4]],
                 2: [gen[2][1:10]]}
        ref, ref_lps, srv1 = _serve(teng, sc, 1, kv_quant, stops)
        assert srv1.stats["stop_hits"] == 3
        assert len(ref[0]) - plen[0] <= 7 and len(ref[2]) - plen[2] <= 10
    if scenario == "eviction":
        assert srv1.stats["evictions"] >= 1
    for n in (2, 4, 8):
        got, lps, srv = _serve(teng, sc, n, kv_quant, stops)
        assert got == ref, n
        if scenario == "eviction":
            assert srv.stats["evictions"] >= 1
        else:
            assert lps == ref_lps, n
        assert srv.stats["stop_hits"] == srv1.stats["stop_hits"]
        assert srv.stats["decode_steps"] < srv1.stats["decode_steps"]
    if scenario == "sampled":
        assert srv.stats["sampled_tokens"] == srv1.stats["sampled_tokens"] > 0


def test_speculation_takes_precedence_over_the_horizon(pair):
    """With speculative decode on, the horizon is not run: the streams and
    the verify counts are those of speculation alone."""
    _, teng = pair
    prompts = prompts_of((9, 12), teng.cfg.vocab_size, seed=9)
    outs, stats = [], []
    for n in (1, 4):
        srv = tserving.ServingEngine(teng, spec_decode=True, spec_k=2,
                                     decode_horizon=n, **SERVE_KW)
        outs.append(run(srv, requests(tserving, prompts, 8)))
        stats.append(dict(srv.stats))
    assert outs[0] == outs[1]
    assert stats[1]["spec_steps"] == stats[1]["decode_steps"] > 0
    assert stats[0] == stats[1]


# ---------------------------------------------------------------------------
# the repair: stop and n
# ---------------------------------------------------------------------------

def test_stop_and_n_serve_as_in_jax(pair):
    """``ServeRequest(stop=..., n=...)`` serves as in JAX: the same
    streams (the stop tokens kept), ``stop_hits``, candidate rids and
    seeds; ``n < 1`` raises."""
    jeng, teng = pair
    prompts = prompts_of((7, 10), jeng.cfg.vocab_size, seed=4)
    js = jserving.ServingEngine(jeng, **SERVE_KW)
    plain = run(js, requests(jserving, prompts, 8))
    gen = plain[0][7:]
    outs, seeds = [], []
    for mod, eng in ((jserving, jeng), (tserving, teng)):
        srv = mod.ServingEngine(eng, **SERVE_KW)
        reqs = [mod.ServeRequest(rid="a", prompt=prompts[0],
                                 max_new_tokens=8, stop=[gen[3:5]], n=3,
                                 seed=21),
                mod.ServeRequest(rid="b", prompt=prompts[1],
                                 max_new_tokens=8, stop=[[1, 2, 3]])]
        for r in reqs:
            srv.submit(r)
        seeds.append({r.rid: (r.seed, r.n) for r in srv.queue})
        outs.append((run(srv, []), srv.stats["stop_hits"]))
        with pytest.raises(ValueError, match="n must be >= 1"):
            srv.submit(mod.ServeRequest(rid="c", prompt=prompts[0], n=0))
    assert seeds[0] == seeds[1]
    assert sorted(seeds[1]) == ["a", "a#1", "a#2", "b"]
    assert seeds[1]["a#2"] == (jsampling.candidate_seed(21, 2), 1)
    assert outs[0][1] == outs[1][1] == 3
    assert outs[0][0].keys() == outs[1][0].keys()
    for rid in outs[0][0]:
        np.testing.assert_array_equal(outs[1][0][rid], outs[0][0][rid])
    a = outs[1][0]["a"]
    assert a[-2:] == gen[3:5] and a == plain[0][:len(a)] and len(a) <= 12


@pytest.mark.parametrize("seed", [0, 7, 2**40 + 3, -5])
def test_candidate_seed_is_jax_bits(seed):
    for i in range(4):
        assert tsampling.candidate_seed(seed, i) == \
            jsampling.candidate_seed(seed, i)


def test_stop_hit_inside_a_horizon_of_the_jax_engine(pair):
    """A two-token stop reached in the middle of a horizon finishes the
    request at the same token in both packages at N = 4."""
    jeng, teng = pair
    prompts = prompts_of((6, 11), jeng.cfg.vocab_size, seed=12)
    js = jserving.ServingEngine(jeng, **SERVE_KW)
    gen = run(js, requests(jserving, prompts, 12))[1][11:]
    outs = []
    for mod, eng in ((jserving, jeng), (tserving, teng)):
        srv = mod.ServingEngine(eng, decode_horizon=4, **SERVE_KW)
        reqs = requests(mod, prompts, 12, stop=[gen[5:7]])
        outs.append((run(srv, reqs), srv.stats["stop_hits"]))
    assert outs[0] == outs[1]
    assert outs[1][0][1][-2:] == gen[5:7] and len(outs[1][0][1]) <= 11 + 7


def test_horizon_tokens_stamp_one_tick_apart(pair):
    """At N = 4 the step clock advances by the tokens produced, and a
    request's tokens are stamped one tick apart, as at N = 1."""
    _, teng = pair
    prompts = prompts_of((5, 9), teng.cfg.vocab_size, seed=9)
    stamps = []
    for n in (1, 4):
        srv = tserving.ServingEngine(teng, decode_horizon=n, **SERVE_KW)
        reqs = requests(tserving, prompts, 9)
        srv.run(reqs)
        stamps.append([np.diff(r.token_times).tolist() for r in reqs])
        assert srv.last_step_span >= 1.0
    assert stamps[0] == stamps[1]

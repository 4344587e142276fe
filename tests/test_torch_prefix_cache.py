"""Parity of the port's shared-prefix cache with the JAX package on the
CPU: the radix index, the refcounted allocator with copy-on-write, and
``ServingEngine(prefix_cache=True)`` in both pool modes.

The index and allocator cases run the JAX object and the port's object
through the same operation sequence and compare what each returns and
its state (block ids, refcounts, tables, lengths, ``stats()``). The
serving cases (the ``pair`` fixture's gpt2 and llama-tiny engines, the
``SERVE_KW`` pool geometry, so each JAX slot program compiles once per
pool mode) hold the port's streams, ``prefix_hits`` and
``prefix_tokens_saved`` to JAX's, and the streams to cache-off serving:
tokens identical. With int8 pools the pools are compared as
``tests/test_torch_int8_serving.py`` compares them (codes within one
step in at most 1% of the entries, scales to 1e-5, the trash block left
out); a copy-on-write copies codes and scales bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import paged_cache as jpaged
from deepspeed_tpu.inference import prefix_index as jindex
from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu_torch.inference import paged_cache as tpaged
from deepspeed_tpu_torch.inference import prefix_index as tindex
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.models import gpt as tgpt
from test_torch_int8_serving import _assert_pools_close
from test_torch_serving import (CONFIGS, SERVE_KW,  # noqa: F401
                                one_torch_thread, pair)


def toks(*vals):
    return np.asarray(vals, np.int32)


def match_state(m):
    return (list(m.block_ids), m.matched, m.cow_src, m.cow_tokens)


# ---------------------------------------------------------------------------
# the radix index
# ---------------------------------------------------------------------------

def _index_ops(ix):
    """One operation sequence over an index; returns what it observed."""
    seen = []
    t = np.arange(12, dtype=np.int32)
    seen.append(ix.insert(t, [5, 6, 7]))
    seen.append(match_state(ix.match(t, max_tokens=12)))       # full blocks
    seen.append(match_state(ix.match(t[:8], max_tokens=8)))
    t2 = t.copy()
    t2[4] = 99                            # divergence at a block's start
    seen.append(match_state(ix.match(t2, max_tokens=12)))
    t2 = t.copy()
    t2[6] = 99                            # inside block 1: COW candidate
    seen.append(match_state(ix.match(t2, max_tokens=12)))
    seen.append(match_state(ix.match(t, max_tokens=11)))       # len-1 cap
    t3 = t.copy()
    t3[5] = 50
    seen.append(ix.insert(t3, [5, 9, 0]))
    q = t.copy()
    q[7] = 77                             # the longest common run wins
    seen.append(match_state(ix.match(q, max_tokens=12)))
    seen.append(ix.insert(t, [8, 10, 11]))                    # dedup
    try:
        ix.insert(toks(9, 9, 9, 9), [5])
    except ValueError as e:
        seen.append("already registered" in str(e))
    seen.append(len(ix))
    return seen


def test_index_match_insert_dedup_match_jax():
    got, ref = (_index_ops(mod.PrefixIndex(block_size=4)) for mod in
                (tindex, jindex))
    assert got == ref
    assert got[4] == ([5], 6, 6, 2)       # partial match -> COW of block 6
    assert got[-2] is True


def _lru_ops(ix):
    seen = []
    a, b = toks(1, 2, 3, 4), toks(1, 2, 9, 9)
    ix.insert(a, [10, 11])
    ix.insert(b, [10, 12])
    seen.append(ix.pop_evictable(lambda bid: bid == 10))     # interior
    ix.match(b, max_tokens=4)
    seen.append(ix.evictable_count(lambda b: True))
    seen.append(ix.evictable_count(lambda b: b == 12))
    seen += [ix.pop_evictable(lambda bid: True) for _ in range(4)]
    ix.insert(toks(1, 2, 3, 4), [5, 6])
    seen += [ix.remove_block(5), ix.remove_block(6), ix.remove_block(5),
             5 in ix, len(ix)]
    return seen


def test_index_lru_leaf_only_eviction_matches_jax():
    got, ref = (_lru_ops(mod.PrefixIndex(block_size=2)) for mod in
                (tindex, jindex))
    assert got == ref
    assert got[:7] == [None, 3, 1, 11, 12, 10, None]


# ---------------------------------------------------------------------------
# the refcounted allocator
# ---------------------------------------------------------------------------

def _caches(num_blocks=16, block_size=4, watermark=0):
    fields = CONFIGS["gpt2"]
    jc = jpaged.PagedKVCache(
        jgpt.GPTConfig(**fields), num_slots=4, block_size=block_size,
        num_blocks=num_blocks, dtype=jnp.float32, watermark=watermark,
        prefix_cache=True)
    tc = tpaged.PagedKVCache(
        tgpt.GPTConfig(**fields, dtype=torch.float32), num_slots=4,
        block_size=block_size, num_blocks=num_blocks, dtype=torch.float32,
        watermark=watermark, prefix_cache=True, device="cpu")
    return jc, tc


STATE_KEYS = ("num_blocks", "free_blocks", "used_blocks", "held_blocks",
              "shared_blocks", "cached_blocks", "fragmentation",
              "tokens_in_flight", "peak_used_blocks", "prefix_hits",
              "prefix_misses", "prefix_tokens_saved", "cow_copies",
              "cache_block_evictions")


def assert_same_state(jc, tc):
    js, ts = jc.stats(), tc.stats()
    assert {k: ts[k] for k in STATE_KEYS} == {k: js[k] for k in STATE_KEYS}
    assert tc._owned == jc._owned
    np.testing.assert_array_equal(tc._refcount, jc._refcount)
    np.testing.assert_array_equal(tc.tables, jc.tables)
    np.testing.assert_array_equal(tc.lengths, jc.lengths)
    assert tc._free == jc._free


def prefilled(c, slot, tokens):
    """allocate, mark the prompt written, publish it."""
    m = c.allocate(slot, len(tokens), tokens=tokens)
    c.lengths[slot] = len(tokens)
    c.register_prefix(slot, tokens)
    return m


def _run_both(ops, **kw):
    jc, tc = _caches(**kw)
    out = []
    for c in (jc, tc):
        seen = []
        for op in ops:
            try:
                seen.append(op(c))
            except tpaged.CacheExhausted:
                seen.append("exhausted")
            except jpaged.CacheExhausted:
                seen.append("exhausted")
        out.append(seen)
    assert out[1] == out[0]
    assert_same_state(jc, tc)
    return out[1], tc


T16 = np.arange(16, dtype=np.int32)


def test_allocator_sharing_and_refcounts_match_jax():
    seen, tc = _run_both([
        lambda c: prefilled(c, 0, T16),
        lambda c: c.allocate(1, 16, tokens=T16),    # 3 shared + COW of 4th
        lambda c: (c.shared_blocks, c.cow_copies, int(c.lengths[1])),
        lambda c: c.free(1),
        lambda c: [int(c._refcount[b]) for b in c._owned[0]],
    ])
    assert seen[1] == 15 and seen[2] == (3, 1, 15)
    assert seen[4] == [1, 1, 1, 1]


def test_allocator_never_reclaims_held_blocks_matches_jax():
    seen, tc = _run_both([
        lambda c: prefilled(c, 0, T16),
        lambda c: c.free(0),                         # 4 blocks cached
        lambda c: prefilled(c, 1, 100 + T16),        # the pool is full
        lambda c: c.allocate(2, 16, tokens=200 + T16),  # reclaims the LRU
        lambda c: (c.cache_block_evictions,
                   set(c._owned[2]).isdisjoint(c._owned[1])),
        lambda c: c.allocate(3, 16),
    ], num_blocks=8)
    assert seen[4] == (4, True) and seen[5] == "exhausted"


def test_allocator_cached_blocks_revive_and_admission_matches_jax():
    seen, tc = _run_both([
        lambda c: prefilled(c, 0, T16),
        lambda c: c.free(0),
        lambda c: (c.blocks_needed(16, tokens=T16),
                   c.blocks_needed(16, tokens=100 + T16),
                   c.available_blocks(tokens=T16),
                   c.available_blocks(tokens=100 + T16),
                   c.can_admit(16, tokens=T16)),
        lambda c: c.allocate(1, 16, tokens=T16),    # revived from the cache
        lambda c: c.stats()["held_blocks"],
    ], num_blocks=6, watermark=1)
    # admission charges only the uncached suffix
    assert seen[2] == (1, 4, 2, 6, True)
    assert seen[3] == 15 and seen[4] == 4


def test_allocator_rollback_and_hardening_match_jax():
    seen, tc = _run_both([
        lambda c: c.allocate(0, 6),
        lambda c: c.advance(0, 6),
        lambda c: c.ensure_capacity(0, 11),           # a straddling chunk
        lambda c: c.advance(0, 1),
        lambda c: c.rollback(0, 7),                   # full reject
        lambda c: (int(c.lengths[0]), c.used_blocks, int(c.tables[0, 2])),
        lambda c: c.ensure_capacity(0, 12),
        lambda c: c.advance(0, 2),
        lambda c: c.rollback(0, 8),
        lambda c: (int(c.lengths[0]), c.used_blocks),
    ], num_blocks=8)
    assert seen[5] == (7, 2, 0) and seen[9] == (8, 2)
    for target in (9, -1):
        with pytest.raises(ValueError, match="outside the allocated"):
            tc.rollback(0, target)
    with pytest.raises(ValueError, match="not active"):
        tc.rollback(1, 0)
    bid = tc._owned[0][0]
    tc.free(0)
    tc.free(0)                                        # idempotent
    with pytest.raises(ValueError, match="double free"):
        tc._release(bid)
    with pytest.raises(ValueError, match="foreign block"):
        tc._release(0)


def test_cow_copies_codes_and_scales_bit_for_bit(pair):
    """The engine's copy programs (``cow_blocks``, ``cow_blocks_q``) move
    one block of every layer, in both packages, and the port's cache
    calls them."""
    jeng, teng = pair
    cfg = jeng.cfg
    shape = (cfg.n_layers, 6, 4, cfg.kv_heads, cfg.head_dim)
    r = np.random.default_rng(0)
    k, v = (r.standard_normal(shape).astype(np.float32) for _ in range(2))
    kq, vq = (r.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
    ks, vs = (r.random(shape[:2] + shape[3:4]).astype(np.float32)
              for _ in range(2))
    jout = jeng.cow_blocks(jnp.asarray(k), jnp.asarray(v), 2, 5)
    tout = teng.cow_blocks(torch.from_numpy(k.copy()),
                           torch.from_numpy(v.copy()), 2, 5)
    jq = jeng.cow_blocks_q(*map(jnp.asarray, (kq, vq, ks, vs)), 1, 3)
    tq = teng.cow_blocks_q(*(torch.from_numpy(a.copy())
                             for a in (kq, vq, ks, vs)), 1, 3)
    for t, j in zip(tout + tq, tuple(jout) + tuple(jq)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tout[0][:, 5].numpy(), k[:, 2])
    np.testing.assert_array_equal(tq[2][:, 3].numpy(), ks[:, 1])


# ---------------------------------------------------------------------------
# serving: the port against JAX, warm against cold
# ---------------------------------------------------------------------------

SYS = np.arange(1, 13, dtype=np.int32)      # 12 tokens: 3 blocks of 4


def _prompts(scenario, vocab):
    r = np.random.default_rng(3)
    if scenario == "block_edge":   # suffixes start on a block edge
        return [np.concatenate([SYS, r.integers(1, vocab, n)]).astype(
            np.int32) for n in (5, 7, 4, 9)], 6
    if scenario == "mid_block":    # diverges inside a block: COW
        base = (1 + np.arange(18) % (vocab - 1)).astype(np.int32)
        div = base.copy()
        div[14] = vocab - 1
        return [base, div, base[:15].copy()], 6
    # requeue: a pool tight enough that a sharing request is preempted
    return [np.concatenate([SYS, r.integers(1, vocab, n)]).astype(np.int32)
            for n in (16, 18, 20)], (4, 24, 24)


def _drain(mod, eng, prompts, n_new, kv_quant, prefix, watermark=None):
    srv = mod.ServingEngine(eng, kv_quant=kv_quant, prefix_cache=prefix,
                            **SERVE_KW)
    if watermark is not None:
        srv.cache.watermark = watermark
    if isinstance(n_new, int):
        n_new = [n_new] * len(prompts)
    out = {}
    for i, (p, n) in enumerate(zip(prompts, n_new)):
        # the first request warms the index; the rest run together
        reqs = [mod.ServeRequest(rid=i, prompt=p, max_new_tokens=n)]
        if i == 0:
            out.update(srv.run(reqs))
        else:
            srv.submit(reqs[0])
    out.update(srv.run())
    return out, srv


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
@pytest.mark.parametrize("scenario", ["block_edge", "mid_block", "requeue"])
def test_prefix_serving_streams_match_jax(pair, scenario, kv_quant):
    jeng, teng = pair
    prompts, n_new = _prompts(scenario, jeng.cfg.vocab_size)
    wm = 0 if scenario == "requeue" else None
    jo, js = _drain(jserving, jeng, prompts, n_new, kv_quant, True, wm)
    to, ts = _drain(tserving, teng, prompts, n_new, kv_quant, True, wm)
    cold, cs = _drain(tserving, teng, prompts, n_new, kv_quant, False, wm)
    assert sorted(to) == sorted(jo) == sorted(cold)
    for rid in jo:
        np.testing.assert_array_equal(to[rid], jo[rid])
        np.testing.assert_array_equal(to[rid], cold[rid])
    for key in ("prefix_hits", "prefix_tokens_saved", "completed",
                "evictions", "prefill_chunks", "decode_steps"):
        assert ts.stats[key] == js.stats[key], key
    for key in ("cow_copies", "cache_block_evictions", "shared_blocks",
                "cached_blocks", "held_blocks"):
        assert ts.cache.stats()[key] == js.cache.stats()[key], key
    assert ts.stats["prefix_hits"] >= 2
    assert ts.stats["prefill_chunks"] < cs.stats["prefill_chunks"]
    assert cs.stats["prefix_hits"] == 0
    if scenario == "mid_block":
        assert ts.cache.cow_copies >= 1
    if scenario == "requeue":
        assert ts.stats["evictions"] >= 1
    assert ts.cache.held_blocks == 0
    if kv_quant == "int8":
        assert ts.cache.k.dtype == torch.int8
        _assert_pools_close(ts.cache.k, js.cache.k, ts.cache.k_scale,
                            js.cache.k_scale)
        _assert_pools_close(ts.cache.v, js.cache.v, ts.cache.v_scale,
                            js.cache.v_scale)


def test_prefix_cache_knob_resolves_like_jax(monkeypatch):
    for value in (None, "on", "off", "1", "0", "true", "no", "", " ON "):
        if value is None:
            monkeypatch.delenv("DS_PREFIX_CACHE", raising=False)
        else:
            monkeypatch.setenv("DS_PREFIX_CACHE", value)
        for explicit in (None, True, False):
            assert tpaged.resolve_prefix_cache(explicit) == \
                jpaged.resolve_prefix_cache(explicit), (value, explicit)
    monkeypatch.setenv("DS_PREFIX_CACHE", "sideways")
    for mod in (tpaged, jpaged):
        with pytest.raises(ValueError, match="DS_PREFIX_CACHE"):
            mod.resolve_prefix_cache(None)


def test_serving_reads_prefix_cache_from_env(pair, monkeypatch):
    """``prefix_cache`` left at None follows ``DS_PREFIX_CACHE`` in both
    packages; an explicit False wins."""
    jeng, teng = pair
    monkeypatch.setenv("DS_PREFIX_CACHE", "on")
    kw = dict(num_slots=1, block_size=4)
    for mod, eng in ((jserving, jeng), (tserving, teng)):
        assert mod.ServingEngine(eng, **kw).cache.index is not None
        assert mod.ServingEngine(eng, prefix_cache=False,
                                 **kw).cache.index is None

"""The port's host-DRAM KV tier against the JAX package on the CPU.

The host pool, the prefix index's tier tags and the cache's spill and
restore are run through the same operation sequences in both packages and
compared by what each returns and by their state. A spilled and restored
block is bit for bit what was spilled (codes and fp32 scales with int8
pools). ``ServingEngine(prefix_cache=True, host_tier=True)`` drains the
same traffic as the JAX engine (the ``pair`` fixture's engines, the
``SERVE_KW`` geometry of ``tests/test_torch_serving.py``): the same
streams and host counters, and with the tier off the same streams; a
corrupted host entry makes its chain re-prefill with the streams
unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import host_tier as jhost
from deepspeed_tpu.inference import paged_cache as jpaged
from deepspeed_tpu.inference import prefix_index as jindex
from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu_torch.inference import host_tier as thost
from deepspeed_tpu_torch.inference import paged_cache as tpaged
from deepspeed_tpu_torch.inference import prefix_index as tindex
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.models import gpt as tgpt
from test_torch_serving import (CONFIGS, SERVE_KW,  # noqa: F401
                                one_torch_thread, pair)

HOST_KEYS = ("host_spills", "host_restores", "host_restore_failures")


# ---------------------------------------------------------------------------
# the flags and the host pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier,mb", [("", ""), ("on", "9"), ("0", "0.5"),
                                     ("maybe", "x")])
def test_host_tier_flags_resolve_like_jax(tier, mb, monkeypatch):
    """``DS_KV_HOST_TIER`` and ``DS_KV_HOST_BUDGET_MB`` resolve as in JAX
    (off and 256 MiB unset, ``ValueError`` on a bad value); an explicit
    argument wins."""
    monkeypatch.setenv("DS_KV_HOST_TIER", tier)
    monkeypatch.setenv("DS_KV_HOST_BUDGET_MB", mb)
    for fn in ("resolve_host_tier", "resolve_host_budget"):
        got = []
        for mod in (thost, jhost):
            try:
                got.append(getattr(mod, fn)())
            except ValueError as e:
                got.append(type(e))
        assert got[0] == got[1], fn
    assert thost.resolve_host_tier(True) is jhost.resolve_host_tier(True)
    assert thost.resolve_host_budget(123) == jhost.resolve_host_budget(123)


def test_serving_reads_the_host_tier_flag(pair, monkeypatch):
    _, teng = pair
    monkeypatch.setenv("DS_KV_HOST_TIER", "on")
    monkeypatch.setenv("DS_KV_HOST_BUDGET_MB", "3")
    srv = tserving.ServingEngine(teng, prefix_cache=True, **SERVE_KW)
    assert srv.host_tier and srv.cache.host_pool.budget_bytes == 3 << 20
    assert not tserving.ServingEngine(teng, **SERVE_KW).host_tier
    assert not tserving.ServingEngine(teng, prefix_cache=True,
                                      host_tier=False, **SERVE_KW).host_tier


def _pool_ops(pool, mod):
    r = np.random.default_rng(0)
    a = (r.standard_normal((2, 4, 3)).astype(np.float32),
         r.integers(-127, 128, (2, 5)).astype(np.int8))
    seen = [pool.put(a), pool.put(a)]
    a[0][0, 0, 0] = 7.0            # the stored bytes are copies
    got = pool.get(0)
    seen.append(float(got[0][0, 0, 0]) != 7.0)
    seen.append(pool.put(a))       # over the budget
    pool.discard(0)
    pool.discard(0)
    seen += [len(pool), pool.bytes_used, 0 in pool, 1 in pool]
    seen.append(pool.put(a))       # keys are never reused
    pool.corrupt(2)
    try:
        pool.get(2)
        seen.append("served")
    except mod.HostCorruption:
        seen.append("corrupt")
    seen.append(np.array_equal(pool.get(1)[1], a[1]))
    try:
        pool.get(0)
    except KeyError:
        seen.append("missing")
    return seen


def test_host_pool_round_trip_crc_and_budget_match_jax():
    nbytes = 2 * 4 * 3 * 4 + 2 * 5
    got, ref = (_pool_ops(mod.HostBlockPool(2 * nbytes), mod)
                for mod in (thost, jhost))
    assert got == ref
    assert got[:4] == [0, 1, True, None] and got[-3:] == ["corrupt", True,
                                                            "missing"]


# ---------------------------------------------------------------------------
# the index's tier tags
# ---------------------------------------------------------------------------

def toks(*vals):
    return np.asarray(vals, np.int32)


def _tier_ops(ix):
    seen = []
    displaced = []
    t = np.arange(12, dtype=np.int32)
    ix.insert(t, [5, 6, 7])
    ix.insert(toks(0, 1, 2, 3, 9, 9, 9, 9), [5, 8])
    seen.append(ix.spill_candidates(lambda b: True, 2))
    ix.to_host(6, 100)
    ix.to_host(7, 101)
    m = ix.match(t, max_tokens=12)
    seen.append((m.block_ids, m.tiers, m.matched, m.cow_src))
    q = t.copy()
    q[6] = 50                      # a near miss on a host block: no COW
    m = ix.match(q, max_tokens=12)
    seen.append((m.block_ids, m.tiers, m.matched, m.cow_src))
    seen += [len(ix), ix.host_len(), 6 in ix, 5 in ix]
    # block 5 is an ancestor of host nodes: never evictable
    seen.append(ix.evictable_count(lambda b: True))
    seen.append(ix.pop_evictable(lambda b: b != 8))
    ix.to_device(100, 12)
    seen.append(ix.match(t, max_tokens=12).tiers)
    # a fresh prefill of a spilled chunk takes it back to the device
    seen.append(ix.insert(t, [5, 12, 13], on_host_displaced=displaced.append))
    seen.append((displaced, ix.host_len()))
    ix.to_host(13, 102)
    ix.insert(np.concatenate([t, toks(4, 4, 4, 4)]), [5, 12, 0, 14])
    seen.append(ix.remove_subtree(102))
    seen.append(ix.remove_subtree(102))
    seen += [len(ix), ix.host_len(), ix.match(t, max_tokens=12).tiers]
    return seen


def test_index_tier_tags_and_host_keys_match_jax():
    got, ref = (_tier_ops(mod.PrefixIndex(block_size=4))
                for mod in (tindex, jindex))
    assert got == ref
    assert got[1] == ([5, 100, 101], ["device", "host", "host"], 12, None)
    assert got[2][3] is None and got[7] == 1


# ---------------------------------------------------------------------------
# the cache: spill, restore, backoff, abort
# ---------------------------------------------------------------------------

def _caches(kv_quant="off", num_blocks=16, **kw):
    fields = CONFIGS["gpt2"]
    common = dict(num_slots=2, block_size=4, num_blocks=num_blocks,
                  watermark=0, prefix_cache=True, host_tier=True,
                  kv_quant=kv_quant, **kw)
    jc = jpaged.PagedKVCache(jgpt.GPTConfig(**fields), dtype=jnp.float32,
                             **common)
    tc = tpaged.PagedKVCache(tgpt.GPTConfig(**fields, dtype=torch.float32),
                             dtype=torch.float32, device="cpu", **common)
    return jc, tc


def _fill(tc, jc=None, seed=0):
    """Random pool contents (codes and scales with int8), the same in
    both caches."""
    r = np.random.default_rng(seed)
    for name in ("k", "v", "k_scale", "v_scale"):
        t = getattr(tc, name)
        if t is None:
            continue
        if t.dtype == torch.int8:
            a = r.integers(-127, 128, tuple(t.shape)).astype(np.int8)
        else:
            a = r.standard_normal(tuple(t.shape)).astype(np.float32)
        t.copy_(torch.from_numpy(a))
        if jc is not None:
            setattr(jc, name, jnp.asarray(a))


def published(c, slot, tokens):
    c.allocate(slot, len(tokens), tokens=tokens)
    c.lengths[slot] = len(tokens)
    c.register_prefix(slot, tokens)
    c.free(slot)


T12 = np.arange(12, dtype=np.int32)


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_cache_spill_restore_round_trip(kv_quant):
    """A published chain spills over two ticks (dispatch, then harvest)
    and a later match restores it into free blocks: codes (and scales)
    bit for bit, the counters, tables and free list as JAX's."""
    jc, tc = _caches(kv_quant, spill_watermark=100)
    _fill(tc, jc)
    before = {}
    for c in (jc, tc):
        published(c, 0, T12)
    for b in tc.index._by_block:
        before[b] = [np.array(t[:, b]) for t in tc._pools()]
    seen = []
    for c in (jc, tc):
        seen.append([c.spill_tick(), len(c._in_transfer), c.spill_tick(),
                     c.host_blocks, c.host_bytes, c.free_blocks])
    assert seen[0] == seen[1] and seen[1][:4] == [0, 3, 3, 3]
    assert tc.host_bytes == 3 * tc.block_size * tc.bytes_per_token \
        + 3 * tc.scale_bytes_per_block
    _fill(tc, seed=1)              # the device copies are gone
    for c in (jc, tc):
        seen.append(c.allocate(1, 14, tokens=np.concatenate(
            [T12, [77, 78]]).astype(np.int32)))
        seen.append([c.host_restores, c.host_blocks, c.free_blocks,
                     c.tables[1].tolist()])
    assert seen[2:4] == seen[4:6] and seen[4] == 12
    for b, old in zip(tc._owned[1][:3], before.values()):
        for t, o in zip(tc._pools(), old):
            np.testing.assert_array_equal(np.array(t[:, b]), o)
    assert len(tc.drain_restore_ms()) == 3 and tc.drain_restore_ms() == []


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_block_gather_and_scatter_match_jax(pair, kv_quant):
    """``paged_cache.gather_blocks`` (a spill's device half) and
    ``scatter_block`` (a restore's) against the JAX engine's
    ``gather_blocks``/``scatter_block`` (``_q`` with int8 pools), bit for
    bit, the scales with the codes; the scatter touches one block of
    every layer."""
    jeng, teng = pair
    cfg = jeng.cfg
    shape = (cfg.n_layers, 9, 4, cfg.kv_heads, cfg.head_dim)
    r = np.random.default_rng(2)
    quant = kv_quant == "int8"
    pools = [r.integers(-127, 128, shape).astype(np.int8) if quant else
             r.standard_normal(shape).astype(np.float32) for _ in range(2)]
    if quant:
        pools += [r.random(shape[:2] + shape[3:4]).astype(np.float32)
                  for _ in range(2)]
    sfx = "_q" if quant else ""
    ids = np.array([3, 0, 7, 3], np.int32)
    got = tpaged.gather_blocks([torch.from_numpy(a.copy()) for a in pools],
                               torch.from_numpy(ids).long())
    ref = getattr(jeng, "gather_blocks" + sfx)(
        *[jnp.asarray(a) for a in pools], ids)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    blk = [np.array(w)[:, 2] for w in ref]
    got = [torch.from_numpy(a.copy()) for a in pools]
    tpaged.scatter_block(got, [torch.from_numpy(b) for b in blk], 5)
    ref = getattr(jeng, "scatter_block" + sfx)(
        *[jnp.asarray(a) for a in pools], *[jnp.asarray(b) for b in blk], 5)
    for g, w, a in zip(got, ref, pools):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy()[:, 5], a[:, 7])


def test_spill_backoff_doubles_and_resets():
    """A full host budget refuses the landing (the block stays on the
    device) and backs the daemon off 1, 2, 4 ticks; a landing resets the
    backoff. The ticks, counters and state equal JAX's."""
    fields = CONFIGS["gpt2"]
    seen = []
    for mod, cfg, dt, kw in (
            (jpaged, jgpt.GPTConfig(**fields), jnp.float32, {}),
            (tpaged, tgpt.GPTConfig(**fields, dtype=torch.float32),
             torch.float32, dict(device="cpu"))):
        c = mod.PagedKVCache(cfg, num_slots=2, block_size=4, num_blocks=16,
                             dtype=dt, watermark=0, prefix_cache=True,
                             host_tier=True, host_budget_bytes=1,
                             transfer_blocks=1, spill_watermark=100, **kw)
        published(c, 0, T12)
        trace = []
        for _ in range(10):
            c.spill_tick()
            trace.append((c.host_budget_refusals, c._spill_cooldown,
                          c._spill_backoff))
        c.host_pool.budget_bytes = 1 << 30
        for _ in range(12):
            c.spill_tick()
            trace.append((c.host_spills, c._spill_backoff))
        seen.append(trace)
    assert seen[0] == seen[1]
    backoffs = [t[2] for t in seen[1][:10]]
    assert backoffs == sorted(backoffs) and {2, 4, 8} <= set(backoffs)
    assert seen[1][-1] == (3, 1)


def test_abort_transfers_leaves_the_free_list_balanced():
    """A spill in flight, one of its blocks claimed again, then aborted:
    every block is on the free list, held or cached, exactly once, as in
    JAX."""
    jc, tc = _caches(spill_watermark=100)
    out = []
    for c in (jc, tc):
        published(c, 0, T12)
        c.spill_tick()
        c.allocate(1, 6, tokens=T12[:6])       # claims a block in flight
        seen = [c.abort_transfers(), c.host_spill_aborts,
                sorted(c._in_transfer)]
        c.free(1)
        seen += [c.free_blocks, c.used_blocks, c.spill_tick(),
                 c.spill_tick(), c.host_blocks]
        out.append(seen)
        # nothing held: each block is free or cached, exactly once
        assert len(c._free) + len(c.index) == c.num_blocks - 1
        assert len(set(c._free)) == len(c._free)
        assert not set(c._free) & set(c.index._by_block)
    assert out[0] == out[1] and out[1][:3] == [3, 3, []]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _traffic(mod, vocab, n_sys=4, per=3, seed=5):
    """``n_sys`` system prompts of 12 tokens (3 blocks), ``per`` requests
    each in round robin, seeded suffixes of 3-6 tokens, 4 new tokens."""
    r = np.random.default_rng(seed)
    systems = [r.integers(1, vocab, 12) for _ in range(n_sys)]
    reqs = []
    for i in range(n_sys * per):
        p = np.concatenate([systems[i % n_sys],
                            r.integers(1, vocab, int(r.integers(3, 7)))])
        reqs.append(mod.ServeRequest(rid=i, prompt=p.astype(np.int32),
                                     max_new_tokens=4))
    return reqs


def _drain(mod, eng, tier, kv_quant="off", corrupt=False):
    srv = mod.ServingEngine(eng, prefix_cache=True, host_tier=tier,
                            kv_quant=kv_quant,
                            **dict(SERVE_KW, num_blocks=14))
    reqs = _traffic(mod, eng.cfg.vocab_size)
    out = {}
    if corrupt:
        # the first 6 requests leave chains on the host; one entry is
        # corrupted before the rest arrive
        out = srv.run(reqs[:6])
        srv.cache.host_pool.corrupt(next(iter(srv.cache.host_pool._entries)))
        reqs = reqs[6:]
    out.update(srv.run(reqs))
    return {k: v.tolist() for k, v in out.items()}, srv


def test_host_tier_drain_matches_jax(pair):
    """The same traffic through both packages with the tier on: the same
    streams and host counters; with the tier off the same streams, and
    restores where the tier-off run re-prefilled."""
    jeng, teng = pair
    runs = {}
    for tier in (False, True):
        for name, mod, eng in (("jax", jserving, jeng),
                               ("port", tserving, teng)):
            out, srv = _drain(mod, eng, tier)
            runs[name, tier] = (out, {k: srv.stats[k] for k in
                                      HOST_KEYS + ("prefill_chunks",
                                                   "prefix_tokens_saved")})
    for tier in (False, True):
        assert runs["port", tier] == runs["jax", tier]
    assert runs["port", True][0] == runs["port", False][0]
    st = runs["port", True][1]
    assert st["host_spills"] > 0 and st["host_restores"] > 0
    assert st["prefill_chunks"] < runs["port", False][1]["prefill_chunks"]


def test_host_tier_int8_streams_match_tier_off(pair):
    """With int8 pools the scales spill and restore with the codes: the
    tier-on streams equal the tier-off ones, with restores."""
    _, teng = pair
    off, _ = _drain(tserving, teng, False, kv_quant="int8")
    on, srv = _drain(tserving, teng, True, kv_quant="int8")
    assert on == off and srv.stats["host_restores"] > 0


def test_corrupted_host_entry_re_prefills(pair):
    """A corrupted host entry fails its CRC at restore: its chain is
    discarded and re-prefilled, ``host_restore_failures`` counts it, and
    the streams are the tier-off ones, in both packages alike."""
    jeng, teng = pair
    off, _ = _drain(tserving, teng, False)
    got = []
    for mod, eng in ((jserving, jeng), (tserving, teng)):
        out, srv = _drain(mod, eng, True, corrupt=True)
        got.append((out, {k: srv.stats[k] for k in HOST_KEYS}))
    assert got[0] == got[1]
    assert got[1][0] == off and got[1][1]["host_restore_failures"] == 1

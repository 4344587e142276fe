"""Block-paged KV cache: fixed-size blocks and per-slot block tables.

Port of the private-block allocator of
``deepspeed_tpu/inference/paged_cache.py`` (PagedAttention, Kwon et al.
SOSP '23). K/V live in pools ``[L, N_blocks, block, Hkv, Dh]`` on the
device; each serving slot owns an ordered list of block ids (its table),
handed out by a free list, so cache memory follows the tokens in flight.
Block 0 is the trash block: writes of masked lanes (chunk padding,
inactive slots) land there, so the slot programs need no branch. The
bookkeeping (tables, lengths, the free list) is host numpy; the engine's
slot programs write the pools in place.

``kv_quant="int8"`` stores the pools as int8 with fp32 scale pools
``k_scale``/``v_scale`` ``[L, N_blocks, Hkv]`` beside them (one scale per
block and kv head, ``ops/quantizer.py``); the slot programs requantize
the blocks they write.

Shared-prefix caching (``prefix_cache=True`` or ``DS_PREFIX_CACHE=on``):
blocks carry refcounts and a radix index (``inference/prefix_index.py``)
maps full block-sized token chunks to the blocks already holding their
K/V. Admission maps a prompt's longest cached prefix into the slot
read-only and charges the pool only for the uncached suffix; a
divergence inside a block copies that block into a fresh one
(copy-on-write, ``copy_block``, which the engine's
``cow_blocks``/``cow_blocks_q`` call too).
A finished request's indexed blocks stay resident at refcount 0 and are
reclaimed least recently used first when the free list runs dry. With
the cache off the allocator is the refcount-free one, bit for bit.

Host-DRAM tier (``host_tier=True`` or ``DS_KV_HOST_TIER=on``, with the
prefix cache on; without it the knob resolves to off, as in JAX):
refcount-zero indexed blocks spill to a
:class:`~deepspeed_tpu_torch.inference.host_tier.HostBlockPool` instead
of dying at eviction. :meth:`PagedKVCache.spill_tick`, run once per
serving step after the decode dispatch, harvests the previous tick's
spill and, when the free list is under ``spill_watermark``, gathers up to
``transfer_blocks`` least recently used candidates into a staging tensor
(:func:`gather_blocks`) whose copy to pinned host buffers runs on a copy
stream; the next tick waits for that copy, stores the blocks with their
CRC32s and frees them on the device (the double buffer). A prefix match
that reaches host links restores them at admission, in prefix order,
into free-list blocks (:func:`scatter_block`, on the compute stream, so
the prefill that reads a block comes after its copy). Every failure
degrades and none gives wrong K/V: a full host budget leaves the block
on the device (plain eviction stays its fate) and backs the daemon off,
a CRC mismatch discards the chain and its subtree (cold re-prefill), a
dry free list truncates the match.

Migration between replicas (the router's disaggregated prefill/decode
fleet, ``inference/router.py``): :meth:`PagedKVCache.migrate_gather`
copies a finished prefill's chain to the host in ``transfer_blocks``-wide
batches and stores each block in a
:class:`~deepspeed_tpu_torch.inference.host_tier.HostBlockPool` with its
CRC32; :meth:`PagedKVCache.land_parked` on the destination checks every
CRC and scatters the blocks into free-list blocks only (a landing never
evicts), where they wait as a parked chain until admission adopts it
(:meth:`PagedKVCache.adopt_parked`). Int8 pools carry their scale blocks
both ways. :meth:`PagedKVCache.warm_migration` makes the staging tensors
once, so a migration allocates no device memory.

Fault injection (``faults=``, a ``utils/faults.FaultInjector``): the
sites ``cache.allocate``, ``cache.ensure``, ``cache.match``,
``cache.cow``, ``cache.spill``, ``cache.restore`` and
``cache.host_corrupt`` fire where the JAX cache fires them, each before
the bookkeeping it guards moves.
"""

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.inference.host_tier import (HostBlockPool,
                                                     HostCorruption,
                                                     resolve_host_tier)
from deepspeed_tpu_torch.inference.prefix_index import (PrefixIndex,
                                                        PrefixMatch)
from deepspeed_tpu_torch.models.gpt import (GPTConfig, decode_geometry,
                                            kv_bytes_per_token)
from deepspeed_tpu_torch.ops.quantizer import resolve_kv_quant
from deepspeed_tpu_torch.utils.env import resolve_flag


class CacheExhausted(Exception):
    """The free list cannot cover an allocation: the scheduler's cue to
    evict and requeue instead of running out of device memory."""


def copy_block(pools, src: int, dst: int) -> None:
    """Copy block ``src`` to ``dst`` in every layer of each pool
    ``[L, N_blocks, ...]``, in place: the device half of copy-on-write
    (with int8 pools the scale pools are among ``pools``)."""
    with torch.inference_mode():
        for t in pools:
            t[:, dst] = t[:, src]


def gather_blocks(pools, ids: torch.Tensor,
                  out: Optional[List[torch.Tensor]] = None
                  ) -> List[torch.Tensor]:
    """Blocks ``ids`` of every layer of each pool ``[L, N_blocks, ...]``,
    as contiguous tensors ``[L, len(ids), ...]``: the device half of a
    spill or a migration (with int8 pools the scale pools are among
    ``pools``). With ``out`` the blocks land in those tensors, one per
    pool, and no memory is allocated."""
    with torch.inference_mode():
        if out is None:
            return [t.index_select(1, ids) for t in pools]
        for t, o in zip(pools, out):
            torch.index_select(t, 1, ids, out=o)
        return out


def scatter_block(pools, payload, dst: int) -> None:
    """Write one block's arrays ``payload`` (each ``[L, ...]``, on the
    host or on the pools' device) into block ``dst`` of every pool, in
    place: the device half of a restore. A host array is copied on the
    current stream, after whatever work is queued there."""
    with torch.inference_mode():
        for t, a in zip(pools, payload):
            t[:, dst].copy_(a, non_blocking=True)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor's numpy view (bf16, which numpy lacks, as int16)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of :func:`to_numpy`: a host tensor of ``dtype``."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(dtype) if t.dtype != dtype else t


def resolve_prefix_cache(flag: Optional[bool] = None) -> bool:
    """The shared-prefix cache switch: an explicit argument wins, else
    ``DS_PREFIX_CACHE``, else off."""
    return resolve_flag("DS_PREFIX_CACHE", flag)


class PagedKVCache:
    """Pools + free-list allocator + per-slot block tables.

    ``num_blocks`` is given directly or derived from ``hbm_budget_bytes``
    through the per-token cache cost; by default it is the static
    reservation's worth (``num_slots`` full sequences). ``watermark`` free
    blocks are held back at admission so every active slot can grow into
    its next decode block without an immediate eviction. ``kv_quant``
    (``"off"``/``"int8"`` or the JAX package's aliases) selects int8
    pools with per-(block, kv head) fp32 scales.

    With ``prefix_cache=True`` a block is in exactly one of three states:
    on the free list, held (refcount > 0, shared blocks count once per
    slot mapping them) or cached (indexed, refcount 0, reclaimable)."""

    def __init__(self, cfg: GPTConfig, *, num_slots: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 hbm_budget_bytes: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 max_seq_len: Optional[int] = None,
                 watermark: Optional[int] = None, device=None,
                 kv_quant=None, prefix_cache: bool = False,
                 host_tier: Optional[bool] = None,
                 host_budget_bytes: Optional[int] = None,
                 transfer_blocks: int = 4,
                 spill_watermark: Optional[int] = None, tracer=None,
                 faults=None, model_parallel: int = 1):
        self.cfg = cfg
        # the fault injector (utils/faults.FaultInjector; None: no site
        # fires): cache.allocate and cache.ensure raise a synthetic
        # CacheExhausted, so the scheduler's eviction runs without a
        # smaller pool; cache.match, cache.cow, cache.spill,
        # cache.restore and cache.host_corrupt drive the degrade paths
        self.faults = faults
        # the serving telemetry's RequestTracer (None: nothing recorded):
        # COW copies, reclaims of cached blocks, spills and restores land
        # in the serving timeline
        self.tracer = tracer
        self.block_size = int(block_size)
        self.num_slots = int(num_slots)
        self.blocks_per_slot, self.tokens_per_slot = decode_geometry(
            cfg, self.block_size, max_seq_len)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.kv_quant = resolve_kv_quant(kv_quant)
        self.quantized = self.kv_quant == "int8"
        L, Hkv, Dh = cfg.n_layers, cfg.kv_heads, cfg.head_dim
        # a tensor-parallel rank's pools hold its kv heads; the byte
        # accounting and the block counts stay the whole model's, as the
        # JAX package's replicated pools count them
        self.pool_kv_heads = Hkv // int(model_parallel)
        self.pool_dtype = torch.int8 if self.quantized else dtype
        self.bytes_per_token = kv_bytes_per_token(cfg, self.pool_dtype)
        # K and V scales of every layer and kv head, fp32, per block
        self.scale_bytes_per_block = 2 * L * Hkv * 4 if self.quantized else 0
        if num_blocks is None:
            if hbm_budget_bytes:
                num_blocks = int(hbm_budget_bytes
                                 // (self.bytes_per_token * self.block_size
                                     + self.scale_bytes_per_block))
            else:
                # counted in blocks, not bytes: the scales must not shave
                # the pool below its slots' capacity
                num_blocks = self.num_slots * self.blocks_per_slot
        # +1: block 0 is the reserved trash block, never allocated
        self.num_blocks = int(num_blocks) + 1
        if self.num_blocks < 2:
            raise ValueError(
                f"HBM budget covers {self.num_blocks - 1} blocks; the "
                f"pool needs at least 1 allocatable block")
        self.k = torch.zeros((L, self.num_blocks, self.block_size,
                              self.pool_kv_heads, Dh),
                             dtype=self.pool_dtype, device=self.device)
        self.v = torch.zeros_like(self.k)
        self.k_scale = self.v_scale = None
        if self.quantized:
            self.k_scale = torch.zeros((L, self.num_blocks,
                                        self.pool_kv_heads),
                                       dtype=torch.float32, device=self.device)
            self.v_scale = torch.zeros_like(self.k_scale)
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._owned: List[List[int]] = [[] for _ in range(num_slots)]
        self._refcount = np.zeros((self.num_blocks,), np.int32)
        self.tables = np.zeros((num_slots, self.blocks_per_slot), np.int32)
        self.lengths = np.zeros((num_slots,), np.int32)
        self.active = np.zeros((num_slots,), bool)
        self.watermark = num_slots if watermark is None else int(watermark)
        self.prefix_cache = bool(prefix_cache)
        self.index: Optional[PrefixIndex] = \
            PrefixIndex(self.block_size) if self.prefix_cache else None
        # the host tier needs the index: only indexed blocks spill
        self.host_tier = resolve_host_tier(host_tier) and \
            self.index is not None
        self.host_pool: Optional[HostBlockPool] = \
            HostBlockPool(host_budget_bytes) if self.host_tier else None
        self.transfer_blocks = max(1, int(transfer_blocks))
        # spilling starts one transfer batch above the admission watermark
        self.spill_watermark = (self.watermark + self.transfer_blocks) \
            if spill_watermark is None else int(spill_watermark)
        # blocks whose bytes are on their way to the host: out of every
        # reclaim predicate, and freed only by the harvest
        self._in_transfer: set = set()
        # (block ids, staging tensors, the copy's event or None on the host)
        self._pending_spill = None
        self._pinned: Optional[List[torch.Tensor]] = None
        self._copy_stream = None
        # pinned restore buffers, their device block (a copy into a
        # strided pool slice from the host would allocate a temporary)
        # and the event of the copy reading them
        self._restore_buf: Optional[List[torch.Tensor]] = None
        self._restore_dev: Optional[List[torch.Tensor]] = None
        self._restore_event = None
        self._spill_cooldown = 0     # ticks until the next spill attempt
        self._spill_backoff = 1      # the cooldown after the next failure
        self._restore_ms: List[float] = []
        self.peak_used_blocks = 0
        # prefix-cache counters (mirrored into the serving stats)
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_tokens_saved = 0
        self.cow_copies = 0
        self.cache_block_evictions = 0
        # host-tier counters
        self.host_spills = 0
        self.host_restores = 0
        self.host_restore_failures = 0
        self.host_spill_aborts = 0
        self.host_budget_refusals = 0
        # migrated chains landed here, waiting for admission to adopt
        # them: {rid: (block ids, resident length)}
        self._parked: Dict = {}
        self.parked_adopted = 0
        self.parked_aborts = 0
        # the migration's staging (warm_migration): the device ids and
        # gather tensors, and their pinned host twins on the card
        self._mig_ids: Optional[torch.Tensor] = None
        self._mig_staged: Optional[List[torch.Tensor]] = None
        self._mig_host: Optional[List[torch.Tensor]] = None

    # -- accounting ----------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Blocks off the free list: held by slots or cached."""
        return (self.num_blocks - 1) - len(self._free)

    @property
    def held_blocks(self) -> int:
        """Blocks mapped into at least one slot table."""
        return int((self._refcount > 0).sum())

    @property
    def shared_blocks(self) -> int:
        """Blocks mapped by more than one slot."""
        return int((self._refcount > 1).sum())

    def _reclaimable(self, bid: int) -> bool:
        """The one reclaim predicate: refcount zero and not on its way
        to the host (the harvest would otherwise store the bytes of a
        block already handed out again)."""
        return self._refcount[bid] == 0 and bid not in self._in_transfer

    @property
    def cached_blocks(self) -> int:
        """Indexed blocks no slot holds: resident and reclaimable."""
        if self.index is None:
            return 0
        return self.index.evictable_count(self._reclaimable)

    @property
    def host_blocks(self) -> int:
        """Blocks resident on the host tier."""
        return len(self.host_pool) if self.host_pool is not None else 0

    @property
    def host_bytes(self) -> int:
        """Host bytes the spilled blocks occupy."""
        return self.host_pool.bytes_used if self.host_pool is not None \
            else 0

    @property
    def tokens_in_flight(self) -> int:
        return int(self.lengths.sum())

    def stats(self) -> Dict[str, float]:
        """Block counts by state, the internal fragmentation of slot
        tables (allocated but unwritten positions over capacity), the pool
        dtype and the cache bytes per token (scales included)."""
        cap_tokens = sum(len(o) for o in self._owned) * self.block_size
        frag = (1.0 - self.tokens_in_flight / cap_tokens) if cap_tokens \
            else 0.0
        return {
            "num_blocks": self.num_blocks - 1,
            "free_blocks": self.free_blocks,
            "used_blocks": self.used_blocks,
            "held_blocks": self.held_blocks,
            "shared_blocks": self.shared_blocks,
            "cached_blocks": self.cached_blocks,
            "fragmentation": round(float(frag), 4),
            "tokens_in_flight": self.tokens_in_flight,
            "peak_used_blocks": self.peak_used_blocks,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_tokens_saved": self.prefix_tokens_saved,
            "cow_copies": self.cow_copies,
            "cache_block_evictions": self.cache_block_evictions,
            "host_blocks": self.host_blocks,
            "host_bytes": self.host_bytes,
            "host_spills": self.host_spills,
            "host_restores": self.host_restores,
            "host_restore_failures": self.host_restore_failures,
            "host_spill_aborts": self.host_spill_aborts,
            "host_budget_refusals": self.host_budget_refusals,
            "parked_blocks": sum(len(b) for b, _ in self._parked.values()),
            "parked_adopted": self.parked_adopted,
            "parked_aborts": self.parked_aborts,
            "pool_dtype": str(self.pool_dtype).replace("torch.", ""),
            "kv_bytes_per_token": self.bytes_per_token
            + self.scale_bytes_per_block / self.block_size,
        }

    def used_block_bytes(self) -> int:
        """Bytes held by allocated blocks (follows tokens in flight),
        their scales included."""
        return self.used_blocks * (self.block_size * self.bytes_per_token
                                   + self.scale_bytes_per_block)

    def static_equivalent_bytes(self, batch: int,
                                max_seq_len: Optional[int] = None) -> int:
        """What the static [B, S_max] cache reserves for the same batch."""
        s = max_seq_len or self.cfg.max_seq_len
        return batch * s * self.bytes_per_token

    def blocks_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.block_size)

    def at_capacity(self, slot: int) -> bool:
        """The slot has consumed its whole block budget: the next decode
        write would clamp into its last live block, so the scheduler must
        finish the request first."""
        return int(self.lengths[slot]) >= self.tokens_per_slot

    # -- admission control ----------------------------------------------
    def _match(self, tokens, touch: bool = False) -> PrefixMatch:
        """The longest cached prefix of ``tokens``, leaving one token to
        prefill; ``touch`` (an allocation) moves the LRU order."""
        if self.index is None or tokens is None or len(tokens) < 2:
            return PrefixMatch()
        return self.index.match(tokens, max_tokens=len(tokens) - 1,
                                touch=touch)

    def blocks_needed(self, n_tokens: int, tokens=None) -> int:
        """Fresh blocks an allocation would take after prefix sharing (a
        copy-on-write still needs its fresh block, and a host link its
        restore target)."""
        return self.blocks_for(n_tokens) - \
            self._match(tokens).tiers.count("device")

    def available_blocks(self, tokens=None) -> int:
        """Free blocks plus reclaimable cached blocks, leaving out the
        blocks a match on ``tokens`` would map (a chain block at refcount
        0 cannot be both shared into the slot and reclaimed for it; host
        links are keys, not blocks, and pin nothing)."""
        n = len(self._free)
        if self.index is not None:
            m = self._match(tokens)
            pinned = {b for b, t in zip(m.block_ids, m.tiers)
                      if t == "device"}
            if m.cow_src is not None:
                pinned.add(m.cow_src)
            n += self.index.evictable_count(
                lambda b: self._reclaimable(b) and b not in pinned)
        return n

    def can_admit(self, n_tokens: int, tokens=None,
                  watermark: Optional[int] = None) -> bool:
        """Blocks for the uncached part of the prompt are available AND
        the watermark reserve stays intact."""
        wm = self.watermark if watermark is None else int(watermark)
        return self.available_blocks(tokens) >= \
            self.blocks_needed(n_tokens, tokens) + wm

    # -- allocator -----------------------------------------------------
    def allocate(self, slot: int, n_tokens: int, tokens=None) -> int:
        """Reserve blocks covering ``n_tokens`` for a fresh slot. With the
        prefix cache on and the prompt's ``tokens`` given, the longest
        cached prefix is mapped in read-only (refcount + 1) and only the
        uncached suffix takes fresh blocks; a divergence inside a block
        copies the partially matching block into the first fresh one.
        Returns the prefix tokens already resident (0 on a miss or with
        the cache off): the slot's length starts there."""
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {self.num_slots})")
        if self.active[slot] or self._owned[slot]:
            raise ValueError(f"slot {slot} is already allocated; free() "
                             f"it before re-allocating")
        self._maybe_inject("cache.allocate", slot)
        need_total = self.blocks_for(n_tokens)
        if need_total > self.blocks_per_slot:
            raise ValueError(
                f"{n_tokens} tokens need {need_total} blocks > per-slot "
                f"table width {self.blocks_per_slot}")
        m = self._match_for_allocate(tokens)
        # every fault site has fired: claim the matched blocks (not
        # reclaimable below), check, commit; a pool shortage rolls the
        # claim back
        pinned = list(m.block_ids)
        if m.cow_src is not None:
            pinned.append(m.cow_src)
        for bid in pinned:
            self._refcount[bid] += 1
        fresh_need = need_total - len(m.block_ids)
        avail = len(self._free)
        if self.index is not None:
            avail += self.index.evictable_count(self._reclaimable)
        if fresh_need > avail:
            for bid in pinned:
                self._refcount[bid] -= 1
            raise CacheExhausted(
                f"need {fresh_need} fresh blocks "
                f"({need_total} total, {len(m.block_ids)} shared), "
                f"{avail} available")
        ids = [self._pop_free() for _ in range(fresh_need)]
        if m.cow_src is not None:
            # the partial block: copied into the first fresh block; the
            # suffix prefill overwrites it from the divergence on
            self._cow(m.cow_src, ids[0])
            self._refcount[m.cow_src] -= 1
        for bid in ids:
            self._refcount[bid] = 1
        all_ids = m.block_ids + ids
        self._owned[slot] = list(all_ids)
        self.tables[slot, :] = 0
        self.tables[slot, :len(all_ids)] = all_ids
        self.lengths[slot] = m.matched
        self.active[slot] = True
        if self.index is not None and tokens is not None:
            if m.matched > 0:
                self.prefix_hits += 1
                self.prefix_tokens_saved += m.matched
            else:
                self.prefix_misses += 1
        self._mark()
        return m.matched

    def _match_for_allocate(self, tokens) -> PrefixMatch:
        """The allocation's prefix match (it moves the LRU order), with
        its fault sites: ``cache.match`` serves the request as a cold
        miss, ``cache.cow`` fails the copy-on-write; both fire before any
        bookkeeping moves, so a failure leaves the allocator as it was."""
        if self.index is None or tokens is None or len(tokens) < 2:
            return PrefixMatch()
        f = self._fire("cache.match")
        if f is not None and f.kind == "cache_exhausted":
            return PrefixMatch()
        m = self._match(tokens, touch=True)
        if "host" in m.tiers:
            m = self._restore_match(m)
        if m.cow_src is not None:
            f = self._fire("cache.cow")
            if f is not None and f.kind == "cache_exhausted":
                raise CacheExhausted(
                    "injected copy-on-write failure at cache.cow "
                    f"({self.free_blocks} blocks actually free)")
        return m

    def _restore_match(self, m: PrefixMatch) -> PrefixMatch:
        """Bring a match's host links back to the device, in prefix
        order, each into a free-list block (a restore never reclaims: the
        admission must not eat the cache it is hitting). The first link
        that cannot be restored (dry free list, a ``cache.restore``
        fault, CRC mismatch) truncates the match there: the restored
        prefix is kept and the rest re-prefills. A ``cache.host_corrupt``
        fault flips a stored byte, so the CRC32 check does the
        degrading."""
        for i, tier in enumerate(m.tiers):
            if tier == "device":
                continue
            ok = False
            if self._free:
                f = self._fire("cache.restore")
                if f is not None and f.kind == "cache_exhausted":
                    # the host entry survives for a later match
                    self.host_restore_failures += 1
                else:
                    f = self._fire("cache.host_corrupt")
                    if f is not None and f.kind == "cache_exhausted":
                        self.host_pool.corrupt(m.block_ids[i])
                    ok = self._dispatch_restore(m.block_ids[i], i, m)
            if not ok:
                return self._truncate_match(m, i)
        return m

    def _dispatch_restore(self, key: int, i: int, m: PrefixMatch) -> bool:
        """One block's restore: the CRC-checked fetch, the copy into a
        free block, the index back on the device; ``m`` is updated in
        place. On a CRC mismatch the key's subtree is discarded (every
        descendant's prefix runs through the bad chunk) and False is
        returned."""
        t0 = time.perf_counter()
        try:
            payload = self.host_pool.get(key)
        except HostCorruption:
            dev, hosts = self.index.remove_subtree(key)
            for hk in hosts:
                self.host_pool.discard(hk)
            for bid in dev:
                # unindexed device descendants at refcount 0 go back to
                # the free list; held or in-transfer ones are settled by
                # their release or the harvest
                if self._refcount[bid] == 0 and \
                        bid not in self._in_transfer:
                    self._free.append(bid)
            self.host_restore_failures += 1
            if self.tracer is not None:
                self.tracer.event("cache_restore_corrupt", key=int(key),
                                  dropped_host=len(hosts),
                                  dropped_device=len(dev))
            return False
        bid = self._free.pop()
        self._scatter(payload, bid)
        self.index.to_device(key, bid)
        self.host_pool.discard(key)
        m.block_ids[i] = bid
        m.tiers[i] = "device"
        self.host_restores += 1
        ms = (time.perf_counter() - t0) * 1000.0
        self._restore_ms.append(ms)
        if self.tracer is not None:
            self.tracer.event("cache_restore", block=bid, key=int(key),
                              ms=round(ms, 3))
        return True

    def _truncate_match(self, m: PrefixMatch, i: int) -> PrefixMatch:
        """Keep the device prefix ``[0, i)`` of a match; the copy-on-write
        candidate hangs off the whole chain's tail, so it goes too."""
        return PrefixMatch(block_ids=m.block_ids[:i], tiers=m.tiers[:i],
                           matched=i * self.block_size)

    def ensure_capacity(self, slot: int, n_tokens: int) -> None:
        """Grow the slot's table until it covers ``n_tokens``; when the
        free list is dry, reclaim least recently used cached blocks
        first (request preemption is the scheduler's last resort)."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self._maybe_inject("cache.ensure", slot)
        need = self.blocks_for(n_tokens)
        if need > self.blocks_per_slot:
            raise ValueError(
                f"{n_tokens} tokens exceed the per-slot capacity "
                f"{self.tokens_per_slot}")
        while len(self._owned[slot]) < need:
            bid = self._pop_free()
            self._refcount[bid] = 1
            self.tables[slot, len(self._owned[slot])] = bid
            self._owned[slot].append(bid)
        self._mark()

    def advance(self, slot: int, n_tokens: int) -> None:
        """Record ``n_tokens`` newly written to the slot's cache."""
        new_len = int(self.lengths[slot]) + int(n_tokens)
        if new_len > len(self._owned[slot]) * self.block_size:
            raise ValueError(f"slot {slot}: {new_len} tokens exceed its "
                             f"{len(self._owned[slot])} blocks")
        self.lengths[slot] = new_len

    def capacity_tokens(self, slot: int) -> int:
        """Token positions the slot's allocated blocks cover: the cap on
        how far a speculative chunk may advance before rollback."""
        return len(self._owned[slot]) * self.block_size

    def horizon_budget(self, slot: int, n_tokens: int) -> int:
        """The capacity grant of a multi-step decode horizon: grow the
        slot's table towards ``n_tokens`` positions, but take a dry pool
        as a shorter horizon, never as a failure (no eviction happens
        for horizon tokens). Returns the token positions granted."""
        want = min(int(n_tokens), self.tokens_per_slot)
        if want > self.capacity_tokens(slot):
            try:
                self.ensure_capacity(slot, want)
            except CacheExhausted:
                pass
        return min(self.capacity_tokens(slot), self.tokens_per_slot)

    def rollback(self, slot: int, n_tokens: int) -> None:
        """Shrink the slot's length to ``n_tokens`` and release every
        owned tail block the shorter length no longer covers, so a
        rejected draft chunk that crossed a block edge pins no block.
        Stale K/V inside the kept partial block is rewritten by the next
        chunk before any query reads it. Only a length within the
        allocated capacity is a legal target, and only owned tail blocks
        are released (shared prefix blocks sit below the prompt, which a
        rollback never crosses)."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        n_tokens = int(n_tokens)
        if not 0 <= n_tokens <= self.capacity_tokens(slot):
            raise ValueError(
                f"rollback target {n_tokens} outside the allocated "
                f"capacity [0, {self.capacity_tokens(slot)}] of slot "
                f"{slot}")
        keep = self.blocks_for(n_tokens)
        while len(self._owned[slot]) > keep:
            bid = self._owned[slot].pop()
            self.tables[slot, len(self._owned[slot])] = 0
            self._release(bid)
        self.lengths[slot] = n_tokens

    def free(self, slot: int) -> None:
        """Release the slot's references. Idempotent. A block whose
        refcount drops to 0 returns to the free list, unless the prefix
        index holds it: then it stays resident as reclaimable cache."""
        for bid in reversed(self._owned[slot]):
            self._release(bid)
        self._owned[slot] = []
        self.tables[slot, :] = 0
        self.lengths[slot] = 0
        self.active[slot] = False

    def register_prefix(self, slot: int, tokens) -> int:
        """Publish the slot's full prompt blocks in the prefix index, once
        the prompt is prefilled (a full block is never written again).
        Chunks already cached keep their block; the slot's duplicate
        stays private. Returns the blocks newly registered."""
        if self.index is None or tokens is None:
            return 0
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        n_full = min(len(tokens) // self.block_size,
                     len(self._owned[slot]))
        if int(self.lengths[slot]) < n_full * self.block_size:
            raise ValueError(
                f"slot {slot} holds {int(self.lengths[slot])} tokens; "
                f"cannot register {n_full} full blocks before they are "
                f"written")
        # a chunk that had spilled moves back onto the slot's fresh copy,
        # and its host bytes are dropped
        return self.index.insert(
            np.asarray(tokens, np.int32), self._owned[slot][:n_full],
            on_host_displaced=(self.host_pool.discard
                               if self.host_pool is not None else None))

    # -- host-tier spill daemon ----------------------------------------
    def spill_tick(self) -> int:
        """One tick of the spill daemon, run once per serving step after
        the decode dispatch: harvest the previous tick's spill, then,
        when the free list is under ``spill_watermark``, start the next
        over the least recently used candidates. Returns the blocks
        stored on the host this tick."""
        if not self.host_tier:
            return 0
        landed = self._harvest_spill()
        if self._spill_cooldown > 0:
            self._spill_cooldown -= 1
            return landed
        if len(self._free) >= self.spill_watermark:
            return landed
        f = self._fire("cache.spill")
        if f is not None and f.kind == "cache_exhausted":
            # the candidates stay on the device, behind the backoff
            self._note_spill_failure()
            return landed
        ids = self.index.spill_candidates(self._reclaimable,
                                          self.transfer_blocks)
        if not ids:
            return landed
        # a fixed width: short batches pad with the trash block
        padded = np.zeros((self.transfer_blocks,), np.int64)
        padded[:len(ids)] = ids
        staged = gather_blocks(self._pools(), torch.as_tensor(
            padded, device=self.device))
        done = None
        if self.device.type == "cuda":
            done = self._copy_to_pinned(staged)
        self._in_transfer.update(ids)
        self._pending_spill = (list(ids), staged, done)
        if self.tracer is not None:
            self.tracer.event("cache_spill", blocks=[int(b) for b in ids])
        return landed

    def _copy_to_pinned(self, staged):
        """Copy the staging tensors into the pinned host buffers on the
        copy stream, after the gather queued on the compute stream.
        Returns the copy's event. The staging tensors are recorded on the
        copy stream (and kept by the pending spill), so their memory is
        not reused before the copy has read it; the pinned buffers are
        only written again after the harvest has waited for this copy."""
        if self._pinned is None:
            self._pinned = [torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True) for t in staged]
            self._copy_stream = torch.cuda.Stream(device=self.device)
        gathered = torch.cuda.Event()
        gathered.record()
        stream = self._copy_stream
        with torch.cuda.stream(stream):
            stream.wait_event(gathered)
            for buf, t in zip(self._pinned, staged):
                buf.copy_(t, non_blocking=True)
                t.record_stream(stream)
            done = torch.cuda.Event()
            done.record(stream)
        return done

    def _harvest_spill(self) -> int:
        """Settle the pending spill: wait for its copy, then per block
        store it on the host (CRC32 at ``put``), move its index node to
        the host and free the device block, or abort it (it was claimed
        or unindexed meanwhile: the device copy stays authoritative)."""
        if self._pending_spill is None:
            return 0
        ids, staged, done = self._pending_spill
        self._pending_spill = None
        if done is not None:
            done.synchronize()
            host = [to_numpy(b) for b in self._pinned]
        else:
            host = [to_numpy(t) for t in staged]
        landed = 0
        for i, bid in enumerate(ids):
            self._in_transfer.discard(bid)
            if self._refcount[bid] != 0 or bid not in self.index:
                self.host_spill_aborts += 1
                if self._refcount[bid] == 0 and bid not in self.index:
                    # unindexed in flight: _release left it to us
                    self._free.append(bid)
                continue
            key = self.host_pool.put(tuple(a[:, i] for a in host))
            if key is None:
                # a full budget is policy: the block stays on the device
                self.host_budget_refusals += 1
                self._note_spill_failure()
                continue
            self.index.to_host(bid, key)
            self._free.append(bid)
            self.host_spills += 1
            landed += 1
        if landed:
            self._spill_backoff = 1
        return landed

    def _note_spill_failure(self) -> None:
        """Back off (in daemon ticks, doubling up to 64) after a failed
        spill, so a failing path is not retried every step."""
        self._spill_cooldown = self._spill_backoff
        self._spill_backoff = min(self._spill_backoff * 2, 64)

    def abort_transfers(self) -> int:
        """Drop the pending spill (its blocks stay on the device) and
        settle every in-transfer block, so all are releasable. Returns
        how many spills were aborted."""
        aborted = 0
        if self._pending_spill is not None:
            ids, _, done = self._pending_spill
            self._pending_spill = None
            if done is not None:
                done.synchronize()
            aborted = len(ids)
            self.host_spill_aborts += aborted
        for bid in sorted(self._in_transfer):
            self._in_transfer.discard(bid)
            if self._refcount[bid] == 0 and not (
                    self.index is not None and bid in self.index):
                self._free.append(bid)
        return aborted

    # -- replica-to-replica migration ------------------------------------
    def warm_migration(self) -> None:
        """Make the migration's staging once: the device tensors a
        ``transfer_blocks``-wide gather lands in, the ids tensor, and on
        the card their pinned host twins and the restore buffers. Then a
        migration allocates no device memory. A gather and a scatter of
        the trash block run once, as the JAX cache warms its programs.
        Idempotent."""
        if self._mig_staged is not None:
            return
        pools = self._pools()
        tb = self.transfer_blocks
        self._mig_ids = torch.zeros((tb,), dtype=torch.int64,
                                    device=self.device)
        self._mig_staged = [torch.empty((t.shape[0], tb) + t.shape[2:],
                                        dtype=t.dtype, device=self.device)
                            for t in pools]
        if self.device.type == "cuda":
            self._mig_host = [torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=True)
                              for t in self._mig_staged]
        host = self._gather_to_host(np.zeros((tb,), np.int64))
        self._scatter(tuple(a[:, 0] for a in host), 0)

    def _gather_to_host(self, ids: np.ndarray) -> List[np.ndarray]:
        """Gather ``transfer_blocks`` block ids into the staging tensors
        and copy them to the host, waited for: the copy comes after the
        work queued on the stream (the prefill's writes), as the JAX
        cache's ``jax.device_get``."""
        self._mig_ids.copy_(torch.from_numpy(ids))
        staged = gather_blocks(self._pools(), self._mig_ids,
                               out=self._mig_staged)
        if self._mig_host is not None:
            for buf, t in zip(self._mig_host, staged):
                buf.copy_(t)
            staged = self._mig_host
        return [to_numpy(t) for t in staged]

    def migrate_gather(self, slot: int, pool: HostBlockPool) -> Dict:
        """Source half of a migration: copy the slot's owned chain to the
        host in ``transfer_blocks``-wide batches (short batches pad with
        the trash block) and :meth:`HostBlockPool.put` each block, so
        every array carries the CRC32 the landing checks. Returns
        ``{"keys", "length", "n_blocks"}``, the migration's ``kv_handle``.
        On any failure (a refused host budget raises
        :class:`CacheExhausted`) the stored keys are discarded and the
        slot is left as it was: the source still owns its blocks."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self.warm_migration()
        chain = list(self._owned[slot])
        keys: List[int] = []
        try:
            for start in range(0, len(chain), self.transfer_blocks):
                ids = chain[start:start + self.transfer_blocks]
                padded = np.zeros((self.transfer_blocks,), np.int64)
                padded[:len(ids)] = ids
                host = self._gather_to_host(padded)
                for i in range(len(ids)):
                    key = pool.put(tuple(a[:, i] for a in host))
                    if key is None:
                        raise CacheExhausted(
                            f"migration host budget refused block "
                            f"{len(keys) + 1}/{len(chain)}")
                    keys.append(key)
        except Exception:
            for k in keys:
                pool.discard(k)
            raise
        return {"keys": keys, "length": int(self.lengths[slot]),
                "n_blocks": len(chain)}

    def land_parked(self, rid, keys: List[int], pool: HostBlockPool,
                    length: int) -> int:
        """Destination half: fetch each migrated block with its CRC32
        checked and scatter it into a free-list block (a landing never
        evicts: the decode side's cache is not eaten by an incoming
        migration; a dry free list raises :class:`CacheExhausted`). The
        landed chain parks under ``rid`` until :meth:`adopt_parked`. A
        failure part way (corruption, a dry list) returns every landed
        block to the free list and re-raises; the host entries stay the
        caller's to discard."""
        if rid in self._parked:
            raise ValueError(f"request {rid!r} already has a parked chain")
        self.warm_migration()
        landed: List[int] = []
        try:
            for key in keys:
                payload = pool.get(key)      # CRC32 -> HostCorruption
                if not self._free:
                    raise CacheExhausted(
                        f"migration landing needs a free block "
                        f"({len(landed)}/{len(keys)} landed)")
                bid = self._free.pop()
                self._scatter(payload, bid)
                landed.append(bid)
        except Exception:
            self._free.extend(reversed(landed))
            raise
        self._parked[rid] = (landed, int(length))
        self._mark()
        return len(landed)

    def has_parked(self, rid) -> bool:
        """True when a migrated chain is parked for ``rid``."""
        return rid in self._parked

    def adopt_parked(self, slot: int, rid) -> int:
        """Install the parked chain as ``slot``'s owned blocks, the
        migration's analogue of a prefix hit in :meth:`allocate`: the
        slot starts with ``length`` tokens resident (refcount 1, private:
        migrated blocks are never shared) and prefill covers only the
        tokens emitted since. Returns the resident length."""
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {self.num_slots})")
        if self.active[slot] or self._owned[slot]:
            raise ValueError(f"slot {slot} is already allocated; free() "
                             f"it before adopting a parked chain")
        bids, length = self._parked.pop(rid)
        for bid in bids:
            self._refcount[bid] = 1
        self._owned[slot] = list(bids)
        self.tables[slot, :] = 0
        self.tables[slot, :len(bids)] = bids
        self.lengths[slot] = length
        self.active[slot] = True
        self.parked_adopted += 1
        self._mark()
        return length

    def drop_parked(self, rid) -> int:
        """Return a parked chain's blocks to the free list (idempotent:
        the fallback and the drain may both try). Returns blocks freed."""
        entry = self._parked.pop(rid, None)
        if entry is None:
            return 0
        bids, _ = entry
        self._free.extend(reversed(bids))
        self.parked_aborts += 1
        return len(bids)

    def abort_parked(self) -> int:
        """Drop every parked chain, as :meth:`abort_transfers` settles the
        spills: a replica settles its landings before
        ``pending_snapshot(release=True)`` hands its requests away (each
        re-prefills cold on a survivor). Returns chains dropped."""
        rids = list(self._parked)
        for rid in rids:
            self.drop_parked(rid)
        return len(rids)

    def drain_restore_ms(self) -> List[float]:
        """Hand over the per-restore host times (ms) since the last call
        and reset them."""
        out = self._restore_ms
        self._restore_ms = []
        return out

    def _pools(self) -> List[torch.Tensor]:
        return [t for t in (self.k, self.v, self.k_scale, self.v_scale)
                if t is not None]

    def _scatter(self, payload, bid: int) -> None:
        """Restore ``payload`` into block ``bid``. On the card the host
        arrays go through pinned buffers and a contiguous device block,
        copied on the compute stream (so the prefill that reads the block
        comes after), and no device memory is allocated; a pinned buffer
        is rewritten only after the copy that read it last has
        finished."""
        pools = self._pools()
        arrays = [from_numpy(a, t.dtype) for a, t in zip(payload, pools)]
        if self.device.type == "cuda":
            if self._restore_buf is None:
                self._restore_buf = [torch.empty(a.shape, dtype=a.dtype,
                                                 pin_memory=True)
                                     for a in arrays]
                self._restore_dev = [torch.empty(a.shape, dtype=a.dtype,
                                                 device=self.device)
                                     for a in arrays]
            elif self._restore_event is not None:
                self._restore_event.synchronize()
            for buf, dev, a in zip(self._restore_buf, self._restore_dev,
                                   arrays):
                buf.copy_(a)
                dev.copy_(buf, non_blocking=True)
            arrays = self._restore_dev
        scatter_block(pools, arrays, bid)
        if self.device.type == "cuda":
            self._restore_event = torch.cuda.Event()
            self._restore_event.record()

    # -- internals -----------------------------------------------------
    def _cow(self, src: int, dst: int) -> None:
        copy_block(self._pools(), int(src), int(dst))
        self.cow_copies += 1
        if self.tracer is not None:
            self.tracer.event("cow", src=src, dst=dst)

    def _pop_free(self) -> int:
        """The next usable block: the free list, else the least recently
        used cached block (unregistered from the index)."""
        if self._free:
            return self._free.pop()
        if self.index is not None:
            bid = self.index.pop_evictable(self._reclaimable)
            if bid is not None:
                self.cache_block_evictions += 1
                if self.tracer is not None:
                    self.tracer.event("cache_evict_block", block=bid)
                return bid
        raise CacheExhausted("free list empty and no reclaimable "
                             "cached blocks")

    def _release(self, bid: int) -> None:
        """Drop one reference; a foreign or already-free block id is a
        bookkeeping bug and raises instead of corrupting the pool."""
        if not 0 < bid < self.num_blocks:
            raise ValueError(f"foreign block id {bid} (pool has blocks "
                             f"1..{self.num_blocks - 1}; 0 is the trash "
                             f"block)")
        if self._refcount[bid] <= 0:
            raise ValueError(f"double free of block {bid}")
        self._refcount[bid] -= 1
        # an in-transfer block is freed by the harvest alone
        if self._refcount[bid] == 0 and bid not in self._in_transfer \
                and not (self.index is not None and bid in self.index):
            self._free.append(bid)

    def _mark(self):
        self.peak_used_blocks = max(self.peak_used_blocks, self.used_blocks)

    def _fire(self, site: str):
        if self.faults is None:
            return None
        return self.faults.fire(site)

    def _maybe_inject(self, site: str, slot: int) -> None:
        f = self._fire(site)
        if f is not None and f.kind == "cache_exhausted":
            raise CacheExhausted(
                f"injected cache exhaustion at {site} (slot {slot}, "
                f"{self.free_blocks} blocks actually free)")

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

Prefix sharing, copy-on-write, the host tier and migration wait for their
slices.
"""

from typing import Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.models.gpt import (GPTConfig, decode_geometry,
                                            kv_bytes_per_token)
from deepspeed_tpu_torch.ops.quantizer import resolve_kv_quant


class CacheExhausted(Exception):
    """The free list cannot cover an allocation: the scheduler's cue to
    evict and requeue instead of running out of device memory."""


class PagedKVCache:
    """Pools + free-list allocator + per-slot block tables.

    ``num_blocks`` is given directly or derived from ``hbm_budget_bytes``
    through the per-token cache cost; by default it is the static
    reservation's worth (``num_slots`` full sequences). ``watermark`` free
    blocks are held back at admission so every active slot can grow into
    its next decode block without an immediate eviction. ``kv_quant``
    (``"off"``/``"int8"`` or the JAX package's aliases) selects int8
    pools with per-(block, kv head) fp32 scales."""

    def __init__(self, cfg: GPTConfig, *, num_slots: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 hbm_budget_bytes: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 max_seq_len: Optional[int] = None,
                 watermark: Optional[int] = None, device=None,
                 kv_quant=None):
        self.cfg = cfg
        self.block_size = int(block_size)
        self.num_slots = int(num_slots)
        self.blocks_per_slot, self.tokens_per_slot = decode_geometry(
            cfg, self.block_size, max_seq_len)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.kv_quant = resolve_kv_quant(kv_quant)
        self.quantized = self.kv_quant == "int8"
        L, Hkv, Dh = cfg.n_layers, cfg.kv_heads, cfg.head_dim
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
        self.k = torch.zeros((L, self.num_blocks, self.block_size, Hkv, Dh),
                             dtype=self.pool_dtype, device=self.device)
        self.v = torch.zeros_like(self.k)
        self.k_scale = self.v_scale = None
        if self.quantized:
            self.k_scale = torch.zeros((L, self.num_blocks, Hkv),
                                       dtype=torch.float32, device=self.device)
            self.v_scale = torch.zeros_like(self.k_scale)
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._owned: List[List[int]] = [[] for _ in range(num_slots)]
        self._refcount = np.zeros((self.num_blocks,), np.int32)
        self.tables = np.zeros((num_slots, self.blocks_per_slot), np.int32)
        self.lengths = np.zeros((num_slots,), np.int32)
        self.active = np.zeros((num_slots,), bool)
        self.watermark = num_slots if watermark is None else int(watermark)
        self.peak_used_blocks = 0

    # -- accounting ----------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    @property
    def held_blocks(self) -> int:
        return int((self._refcount > 0).sum())

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
            "fragmentation": round(float(frag), 4),
            "tokens_in_flight": self.tokens_in_flight,
            "peak_used_blocks": self.peak_used_blocks,
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

    def can_admit(self, n_tokens: int,
                  watermark: Optional[int] = None) -> bool:
        """Blocks for the prompt are free AND the watermark reserve stays
        intact."""
        wm = self.watermark if watermark is None else int(watermark)
        return len(self._free) >= self.blocks_for(n_tokens) + wm

    # -- allocator -----------------------------------------------------
    def allocate(self, slot: int, n_tokens: int) -> int:
        """Reserve blocks covering ``n_tokens`` for a fresh slot. Returns
        the tokens already resident (always 0 without prefix sharing)."""
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {self.num_slots})")
        if self.active[slot] or self._owned[slot]:
            raise ValueError(f"slot {slot} is already allocated; free() "
                             f"it before re-allocating")
        need = self.blocks_for(n_tokens)
        if need > self.blocks_per_slot:
            raise ValueError(
                f"{n_tokens} tokens need {need} blocks > per-slot "
                f"table width {self.blocks_per_slot}")
        if need > len(self._free):
            raise CacheExhausted(f"need {need} fresh blocks, "
                                 f"{len(self._free)} available")
        ids = [self._pop_free() for _ in range(need)]
        for bid in ids:
            self._refcount[bid] = 1
        self._owned[slot] = ids
        self.tables[slot, :] = 0
        self.tables[slot, :need] = ids
        self.lengths[slot] = 0
        self.active[slot] = True
        self._mark()
        return 0

    def ensure_capacity(self, slot: int, n_tokens: int) -> None:
        """Grow the slot's table until it covers ``n_tokens``."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
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
        """Token positions the slot's allocated blocks cover."""
        return len(self._owned[slot]) * self.block_size

    def free(self, slot: int) -> None:
        """Return the slot's blocks to the pool. Idempotent."""
        for bid in reversed(self._owned[slot]):
            self._release(bid)
        self._owned[slot] = []
        self.tables[slot, :] = 0
        self.lengths[slot] = 0
        self.active[slot] = False

    def _pop_free(self) -> int:
        if not self._free:
            raise CacheExhausted("free list empty")
        return self._free.pop()

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
        if self._refcount[bid] == 0:
            self._free.append(bid)

    def _mark(self):
        self.peak_used_blocks = max(self.peak_used_blocks, self.used_blocks)

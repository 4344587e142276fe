"""Host-DRAM second tier of the paged KV cache: spilled block storage.

Port of ``deepspeed_tpu/inference/host_tier.py``. Under device-memory
pressure the prefix cache's only answer used to be evicting a
refcount-zero cached block and losing its K/V (the next hit re-prefills).
A :class:`HostBlockPool` keeps such blocks in host memory instead, so a
later hit on a spilled chain restores the bytes rather than recomputing
them.

The pool is a dict of contiguous numpy copies under a byte budget. The
policy (what spills, when, what a failed restore degrades to) and the
transfers live in ``inference/paged_cache.py``. This module owns
durability: every stored array carries a CRC32 computed at :meth:`put`
and checked at :meth:`get`, so a corrupted host buffer surfaces as
:class:`HostCorruption` and the cache discards the chain and re-prefills;
wrong K/V is never served as cached.

A full budget is not an error: :meth:`HostBlockPool.put` returns None
and the caller leaves the block on the device, where plain LRU eviction,
the tier-off behaviour, stays the backstop.
"""

import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.utils.env import resolve_flag


class HostCorruption(Exception):
    """A host-tier block failed its CRC32 check at restore time: the
    cache's cue to discard the chain and re-prefill it."""


def resolve_host_tier(flag: Optional[bool] = None) -> bool:
    """The host-DRAM KV tier switch: an explicit argument wins, else
    ``DS_KV_HOST_TIER``, else off."""
    return resolve_flag("DS_KV_HOST_TIER", flag)


def resolve_host_budget(budget_bytes: Optional[int] = None) -> int:
    """The host tier's byte budget: an explicit argument wins, else
    ``DS_KV_HOST_BUDGET_MB`` (default 256 MiB)."""
    if budget_bytes is not None:
        return int(budget_bytes)
    return int(resolve_flag("DS_KV_HOST_BUDGET_MB") * (1 << 20))


class HostBlockPool:
    """CRC-tagged host storage for spilled KV blocks.

    One entry holds one pool block as a tuple of contiguous numpy arrays:
    ``(k_blk, v_blk)`` of shape ``[L, bs, Hkv, Dh]``, plus the fp32
    ``(k_scale, v_scale)`` ``[L, Hkv]`` with int8 pools (a restored block
    dequantizes to exactly what was spilled). Keys are increasing ints
    minted by :meth:`put` and never reused, so a stale key can only miss,
    never alias."""

    def __init__(self, budget_bytes: Optional[int] = None):
        self.budget_bytes = resolve_host_budget(budget_bytes)
        # key -> (arrays, crcs, nbytes)
        self._entries: Dict[int, Tuple[tuple, tuple, int]] = {}
        self._next_key = 0
        self.bytes_used = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: int) -> bool:
        return int(key) in self._entries

    def put(self, arrays: tuple) -> Optional[int]:
        """Store one block's arrays; returns its key, or None when the
        byte budget cannot cover it."""
        # always copy: a caller's later write to its buffer must not
        # reach the stored bytes
        copies = tuple(np.array(a, order="C", copy=True) for a in arrays)
        nbytes = sum(int(c.nbytes) for c in copies)
        if self.bytes_used + nbytes > self.budget_bytes:
            return None
        crcs = tuple(zlib.crc32(c) for c in copies)
        key = self._next_key
        self._next_key += 1
        self._entries[key] = (copies, crcs, nbytes)
        self.bytes_used += nbytes
        return key

    def get(self, key: int) -> tuple:
        """A block's arrays, every CRC32 checked. Raises
        :class:`HostCorruption` on a mismatch (the entry stays: the cache
        owns the chain's clean-up) and ``KeyError`` on an unknown key."""
        arrays, crcs, _ = self._entries[int(key)]
        for i, (a, crc) in enumerate(zip(arrays, crcs)):
            if zlib.crc32(a) != crc:
                raise HostCorruption(
                    f"host block {key} array {i} failed its CRC32 check "
                    f"(stored 0x{crc:08x})")
        return arrays

    def discard(self, key: int) -> None:
        """Drop an entry; idempotent."""
        entry = self._entries.pop(int(key), None)
        if entry is not None:
            self.bytes_used -= entry[2]

    def corrupt(self, key: int) -> None:
        """Flip one byte of a stored block in place: the test helper
        behind the CRC-mismatch path."""
        arrays, _, _ = self._entries[int(key)]
        flat = arrays[0].reshape(-1).view(np.uint8)
        flat[0] ^= 0xFF

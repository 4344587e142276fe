"""Host-side radix index over full block-sized token chunks: the lookup
behind the paged KV cache's shared-prefix caching.

Port of ``deepspeed_tpu/inference/prefix_index.py`` (vLLM automatic
prefix caching, Kwon et al. SOSP '23; SGLang RadixAttention). The edges
of the tree are full ``block_size`` token chunks and each node names the
pool block holding that chunk's K/V. The model is causal, so a block's
K/V depend only on the tokens at and before it: two requests that agree
on their first ``k * block_size`` tokens can read the same ``k`` blocks.

The index maps prefixes to block ids and keeps LRU order (a logical
tick, so the order is deterministic); the cache owns the refcounts and
passes its reclaim predicate (``refcount == 0``) to :meth:`pop_evictable`.
Only leaves are evictable, so a cached chain never dangles. A match
returns the longest cached chain plus, when the query diverges or ends
inside the next block, a copy-on-write candidate: the child sharing the
longest leading run of tokens, which the cache copies into a fresh block.

With the host tier (``inference/host_tier.py``) a node is tagged
``"device"`` (its ``block`` is a pool block id) or ``"host"`` (its
``host_key`` names the spilled bytes, ``block`` is -1). Host nodes are
kept out of the device namespace: ``len(index)``, ``block in index`` and
every reclaim predicate see device blocks only. A spilled interior node
keeps its subtree reachable (the chain restores link by link), and the
device ancestors of a host node are never evictable.
"""

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np


def _chunk_key(tokens: np.ndarray) -> bytes:
    return np.ascontiguousarray(tokens, dtype=np.int32).tobytes()


class _Node:
    """One cached block: its full token chunk, its pool block id and its
    links. ``last_used`` is the index's logical tick. ``tier`` is
    ``"device"`` (``block`` valid) or ``"host"`` (``host_key`` valid,
    ``block`` -1)."""

    __slots__ = ("chunk", "block", "parent", "children", "last_used",
                 "tier", "host_key")

    def __init__(self, chunk: np.ndarray, block: int,
                 parent: Optional["_Node"]):
        self.chunk = chunk
        self.block = block
        self.parent = parent
        self.children: Dict[bytes, "_Node"] = {}
        self.last_used = 0
        self.tier = "device"
        self.host_key: Optional[int] = None


@dataclass
class PrefixMatch:
    """``block_ids``: the chain of fully shared blocks (mapped read-only);
    ``cow_src``/``cow_tokens``: the partially matching block to copy on
    write and how many of its leading positions are reused. ``matched``
    counts reusable tokens, ``len(block_ids) * block_size +
    cow_tokens``. ``tiers`` parallels ``block_ids``: a ``"host"`` entry
    is a host-pool key the cache must restore before the chain can be
    mapped (the copy-on-write candidate is always on the device)."""
    block_ids: List[int] = field(default_factory=list)
    matched: int = 0
    cow_src: Optional[int] = None
    cow_tokens: int = 0
    tiers: List[str] = field(default_factory=list)


class PrefixIndex:
    """Radix tree of full-block token chunks -> pool block ids."""

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self._root = _Node(np.zeros((0,), np.int32), -1, None)
        self._by_block: Dict[int, _Node] = {}
        # host-tier nodes by host key, apart from _by_block so that no
        # device predicate can confuse a key with a block id
        self._by_host: Dict[int, _Node] = {}
        self._tick = 0

    def __len__(self) -> int:
        """Device-tier nodes; :meth:`host_len` counts the spilled ones."""
        return len(self._by_block)

    def __contains__(self, block_id: int) -> bool:
        return int(block_id) in self._by_block

    def host_len(self) -> int:
        return len(self._by_host)

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.last_used = self._tick

    def match(self, tokens: np.ndarray, max_tokens: int,
              touch: bool = True) -> PrefixMatch:
        """Longest cached prefix of ``tokens``, capped at ``max_tokens``
        (the caller caps at ``len(tokens) - 1``, so one token is always
        left to prefill: its logits give the first generated token).
        ``touch=False`` peeks without moving the LRU order."""
        tokens = np.asarray(tokens, np.int32)
        bs = self.block_size
        max_tokens = min(int(max_tokens), len(tokens))
        node = self._root
        m = PrefixMatch()
        while m.matched + bs <= max_tokens:
            child = node.children.get(
                _chunk_key(tokens[m.matched:m.matched + bs]))
            if child is None:
                break
            node = child
            m.block_ids.append(child.block if child.tier == "device"
                               else child.host_key)
            m.tiers.append(child.tier)
            m.matched += bs
            if touch:
                self._touch(child)
        # the device child sharing the longest leading run of the
        # remainder is the copy-on-write candidate (a spilled block cannot
        # be copied on the device: a near miss on one is a miss)
        rem = tokens[m.matched:max_tokens]
        if len(rem) > 0:
            best, best_j = None, 0
            for child in node.children.values():
                if child.tier != "device":
                    continue
                j = _common_prefix_len(child.chunk, rem)
                if j > best_j:
                    best, best_j = child, j
            if best is not None:
                m.cow_src = best.block
                m.cow_tokens = best_j
                m.matched += best_j
                if touch:
                    self._touch(best)
        return m

    def insert(self, tokens: np.ndarray, block_ids: List[int],
               on_host_displaced: Optional[Callable[[int], None]] = None
               ) -> int:
        """Register a chain: chunk ``i`` of ``tokens`` lives in
        ``block_ids[i]``. Chunks already cached on the device keep their
        block (the caller's duplicate stays private and is freed with its
        slot). A chunk whose node is on the host moves back to the device
        on the caller's fresh block, and ``on_host_displaced(host_key)``
        lets the cache drop the redundant host copy. Returns how many
        blocks were newly registered."""
        tokens = np.asarray(tokens, np.int32)
        bs = self.block_size
        n_full = min(len(tokens) // bs, len(block_ids))
        node = self._root
        added = 0
        for i in range(n_full):
            chunk = tokens[i * bs:(i + 1) * bs]
            key = _chunk_key(chunk)
            child = node.children.get(key)
            if child is None:
                bid = int(block_ids[i])
                if bid in self._by_block:
                    raise ValueError(
                        f"block {bid} is already registered in the index")
                child = _Node(chunk.copy(), bid, node)
                node.children[key] = child
                self._by_block[bid] = child
                added += 1
            elif child.tier == "host":
                bid = int(block_ids[i])
                if bid in self._by_block:
                    raise ValueError(
                        f"block {bid} is already registered in the index")
                displaced = child.host_key
                del self._by_host[displaced]
                child.tier, child.host_key, child.block = "device", None, bid
                self._by_block[bid] = child
                if on_host_displaced is not None:
                    on_host_displaced(displaced)
                added += 1
            self._touch(child)
            node = child
        return added

    # -- tier transitions ----------------------------------------------
    def to_host(self, block_id: int, host_key: int) -> None:
        """Move a device node to the host tier: ``block_id`` leaves the
        index (the pool block is the cache's to free) and ``host_key``
        names its bytes from here on."""
        node = self._by_block.pop(int(block_id))
        node.tier, node.host_key, node.block = "host", int(host_key), -1
        self._by_host[node.host_key] = node

    def to_device(self, host_key: int, block_id: int) -> None:
        """Move a host node back to the device onto the restored
        ``block_id`` (the cache has already written its bytes there)."""
        node = self._by_host.pop(int(host_key))
        node.tier, node.host_key, node.block = "device", None, int(block_id)
        self._by_block[node.block] = node

    def spill_candidates(self, can_spill: Callable[[int], bool],
                         limit: int) -> List[int]:
        """Up to ``limit`` device blocks passing ``can_spill``, least
        recently used first. Unlike :meth:`pop_evictable` these may be
        interior nodes: a spilled interior keeps its subtree reachable."""
        cands = [n for n in self._by_block.values() if can_spill(n.block)]
        cands.sort(key=lambda n: n.last_used)
        return [n.block for n in cands[:int(limit)]]

    def remove_subtree(self, host_key: int):
        """Remove the host node ``host_key`` and every descendant (their
        prefixes run through it). Returns ``(device_ids, host_keys)`` of
        everything removed: the corruption path's clean-up list."""
        node = self._by_host.get(int(host_key))
        if node is None:
            return [], []
        dev: List[int] = []
        hosts: List[int] = []

        def walk(n: _Node) -> None:
            for c in list(n.children.values()):
                walk(c)
            n.children.clear()
            if n.tier == "host":
                hosts.append(n.host_key)
                self._by_host.pop(n.host_key, None)
            else:
                dev.append(n.block)
                self._by_block.pop(n.block, None)
            n.parent.children.pop(_chunk_key(n.chunk), None)

        walk(node)
        return dev, hosts

    # -- eviction --------------------------------------------------------
    def _host_pinned(self) -> frozenset:
        """The device ancestors of host nodes: a host child never leaves
        by device eviction, so no leaf-first cascade reaches them."""
        pinned = set()
        for n in self._by_host.values():
            p = n.parent
            while p is not None and p is not self._root:
                if p.tier == "device":
                    if p.block in pinned:
                        break       # the rest of this chain is walked
                    pinned.add(p.block)
                p = p.parent
        return frozenset(pinned)

    def evictable_count(self, can_evict: Callable[[int], bool]) -> int:
        """Cached blocks reclaimable now: every indexed block the
        predicate clears (leaf-first pops expose interior nodes in turn,
        and a parent's refcount is at least its child's), less the
        device ancestors of host nodes (:meth:`_host_pinned`)."""
        blocked = self._host_pinned()
        return sum(1 for bid in self._by_block
                   if can_evict(bid) and bid not in blocked)

    def pop_evictable(self, can_evict: Callable[[int], bool]
                      ) -> Optional[int]:
        """Remove and return the least recently used leaf block that
        passes ``can_evict``, or None."""
        victim = None
        for node in self._by_block.values():
            if node.children or not can_evict(node.block):
                continue
            if victim is None or node.last_used < victim.last_used:
                victim = node
        if victim is None:
            return None
        self._remove(victim)
        return victim.block

    def remove_block(self, block_id: int) -> bool:
        """Unregister ``block_id`` if it is a leaf; False otherwise."""
        node = self._by_block.get(int(block_id))
        if node is None or node.children:
            return False
        self._remove(node)
        return True

    def _remove(self, node: _Node) -> None:
        if node.children:
            raise ValueError(f"block {node.block} is an interior node")
        del self._by_block[node.block]
        node.parent.children.pop(_chunk_key(node.chunk), None)


def _common_prefix_len(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if len(neq) else n

"""Multi-tenant LoRA serving: the adapter registry and its paged pool.

Port of ``deepspeed_tpu/inference/adapters.py`` (S-LoRA, Sheng et al.
2023; Punica, Chen et al. 2023): many unmerged adapters share one base
model in one engine. The slot programs apply them as gathered low-rank
products indexed by a per-slot adapter-table row
(``InferenceEngine._gather_lora`` and ``ops/layers.py dense``).

- **Registry**: :meth:`AdapterPool.register` parses the
  ``runtime/lora.py`` export (an ``.npz`` path or an
  ``adapter_state_dict`` mapping), checks every leaf against the base
  kernels, folds ``lora_scale`` into B once in float32 and stages the
  result on the host in rank-block chunks. Registration touches no
  device memory.
- **Paged pool**: per-target device pools ``a[t] [L, NB, in, rb]`` and
  ``b[t] [L, NB, rb, out]`` in the engine's compute dtype, paged over the
  rank axis: an adapter of rank r holds ``ceil(r / rank_block)`` blocks.
  Block 0 is a permanent all-zeros trash block (a base-only slot's row is
  all zeros, so its delta is exactly +0.0), the free list is LIFO, a
  resident adapter has a refcount, and a full pool evicts the
  least-recently-used refcount-zero adapter. A load writes the adapter's
  blocks into the pools in place on the engine's device: no program to
  warm up.
- **Degradation**: the ``cache.adapter_load`` fault site fires before any
  pool state moves, the order that keeps a failed load harmless when the
  pools are written in place. ``cache_exhausted`` (and a full pool with
  every resident pinned, and an unregistered id) raise
  :class:`AdapterLoadError`; ``device_error`` raises the retryable
  ``TransientDeviceError``. The serving engine retires the request with
  state ``error`` for either.
"""

import math
from typing import Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.lora import DEFAULT_TARGETS
from deepspeed_tpu_torch.utils import faults as faults_lib
from deepspeed_tpu_torch.utils.env import resolve_flag

__all__ = ["AdapterLoadError", "AdapterPool", "resolve_lora_serve"]


class AdapterLoadError(RuntimeError):
    """An adapter could not be made pool-resident (unregistered id, pool
    exhausted with every resident adapter pinned, or an injected
    ``cache.adapter_load`` exhaustion). The serving engine retires the
    owning request with state ``error``."""


def resolve_lora_serve(override=None) -> bool:
    """``DS_LORA_SERVE``: an explicit argument wins, then the environment,
    then off (base-only serving is the bit reference)."""
    return resolve_flag("DS_LORA_SERVE", override)


class AdapterPool:
    """The adapter registry and the fixed-size paged device pool (the
    module docstring has the design).

    - ``engine``: the ``InferenceEngine`` whose base kernels (``kernel``,
      or an int8 entry's ``q``) size the per-target pools, and whose
      device and compute dtype the pools take.
    - ``pool_mb`` / ``pool_blocks``: the capacity as a MiB budget
      (``DS_LORA_POOL_MB``) or an explicit block count, which wins.
    - ``max_rank`` / ``rank_block``: the largest rank taken and the rank
      width of one block (``DS_LORA_MAX_RANK``, ``DS_LORA_RANK_BLOCK``);
      together they fix the width of every adapter-table row,
      ``ceil(max_rank / rank_block)``.
    - ``faults`` / ``tracer`` / ``hooks``: the injector of the
      ``cache.adapter_load`` site (default the ambient one), a tracer for
      the ``adapter_load`` event, and ``{"on_hit", "on_load", "on_evict"}``
      callbacks (the serving engine's counters).
    """

    def __init__(self, engine, *, pool_mb: Optional[float] = None,
                 pool_blocks: Optional[int] = None,
                 max_rank: Optional[int] = None,
                 rank_block: Optional[int] = None,
                 faults: Optional[faults_lib.FaultInjector] = None,
                 tracer=None,
                 hooks: Optional[Mapping[str, Callable]] = None):
        self.engine = engine
        self.faults = faults if faults is not None else faults_lib.active()
        self.tracer = tracer
        self.hooks = dict(hooks or {})
        self.max_rank = int(resolve_flag("DS_LORA_MAX_RANK", max_rank))
        self.rank_block = int(resolve_flag("DS_LORA_RANK_BLOCK", rank_block))
        if self.max_rank < 1 or self.rank_block < 1:
            raise ValueError("max_rank and rank_block must be >= 1")
        self.blocks_per_adapter = math.ceil(self.max_rank / self.rank_block)

        # (L, in, out) of each target the model has (no mlp_gate on gelu)
        block = engine.params["block"]
        self._shapes: Dict[str, tuple] = {}
        for t in DEFAULT_TARGETS:
            entry = block.get(t)
            if not isinstance(entry, dict):
                continue
            kern = entry.get("kernel", entry.get("q"))
            if kern is not None:
                self._shapes[t] = tuple(kern.shape)
        if not self._shapes:
            raise ValueError("base model has no adaptable dense targets")
        self.n_layers = next(iter(self._shapes.values()))[0]
        self.dtype = engine.dtype
        rb = self.rank_block
        self._block_bytes = sum(
            (din * rb + rb * dout) * L * self.dtype.itemsize
            for (L, din, dout) in self._shapes.values())

        if pool_blocks is None:
            budget = resolve_flag("DS_LORA_POOL_MB", pool_mb) * (1 << 20)
            pool_blocks = max(self.blocks_per_adapter,
                              int(budget // self._block_bytes))
        if pool_blocks < self.blocks_per_adapter:
            raise ValueError(
                f"adapter pool of {pool_blocks} blocks cannot hold one "
                f"max-rank adapter ({self.blocks_per_adapter} blocks)")
        # block 0 is the all-zeros trash block, never allocated
        self.num_blocks = int(pool_blocks) + 1
        dev = engine.device
        self.a_pool = {t: torch.zeros((L, self.num_blocks, din, rb),
                                      dtype=self.dtype, device=dev)
                       for t, (L, din, dout) in self._shapes.items()}
        self.b_pool = {t: torch.zeros((L, self.num_blocks, rb, dout),
                                      dtype=self.dtype, device=dev)
                       for t, (L, din, dout) in self._shapes.items()}

        # the allocator, as the paged KV cache's: a LIFO free list (pop()
        # yields ascending ids), refcounts, an LRU clock over residents
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._staged: Dict[str, List[Dict[str, Dict[str, np.ndarray]]]] = {}
        self._rank: Dict[str, int] = {}
        self._blocks: Dict[str, List[int]] = {}
        self._refcount: Dict[str, int] = {}
        self._last_used: Dict[str, int] = {}
        self._tick = 0
        self.hits = 0
        self.loads = 0
        self.evictions = 0

    def _zero_chunks(self):
        rb = self.rank_block
        a = {t: np.zeros((L, din, rb), np.float32)
             for t, (L, din, dout) in self._shapes.items()}
        b = {t: np.zeros((L, rb, dout), np.float32)
             for t, (L, din, dout) in self._shapes.items()}
        return a, b

    # -- registry ------------------------------------------------------
    def register(self, adapter_id: str,
                 source: Union[str, Mapping[str, np.ndarray]]) -> None:
        """Stage ``source`` (an ``.npz`` path or an ``adapter_state_dict``
        mapping, the ``runtime/lora.py`` export) on the host under
        ``adapter_id``: every leaf checked against the base kernels,
        ``lora_scale`` folded into B in float32, both factors cut into
        rank blocks zero-padded to ``rank_block`` (a target the adapter
        leaves out gets zero chunks). No device memory moves until
        :meth:`acquire`."""
        if isinstance(source, str):
            with np.load(source) as data:
                flat = {k: np.asarray(data[k]) for k in data.files}
        else:
            flat = {k: np.asarray(v) for k, v in source.items()}
        per_target: Dict[str, Dict[str, np.ndarray]] = {}
        for key, val in flat.items():
            parts = key.split("/")
            if len(parts) != 3 or parts[0] != "block":
                raise ValueError(
                    f"adapter {adapter_id!r}: unexpected export key "
                    f"{key!r} (want 'block/<target>/lora_*')")
            _, target, leaf = parts
            if target not in self._shapes:
                raise ValueError(
                    f"adapter {adapter_id!r} adapts {target!r}, which "
                    f"the base model does not expose")
            per_target.setdefault(target, {})[leaf] = val
        if not per_target:
            raise ValueError(f"adapter {adapter_id!r}: empty export")

        rank = None
        for t, leaves in per_target.items():
            missing = {"lora_a", "lora_b", "lora_scale"} - set(leaves)
            if missing:
                raise ValueError(
                    f"adapter {adapter_id!r}/{t}: missing {sorted(missing)}")
            L, din, dout = self._shapes[t]
            a, b = leaves["lora_a"], leaves["lora_b"]
            r = a.shape[-1]
            if a.shape != (L, din, r) or b.shape != (L, r, dout):
                raise ValueError(
                    f"adapter {adapter_id!r}/{t}: shapes A{a.shape} "
                    f"B{b.shape} do not match base ({L}, {din}, {dout})")
            if rank is None:
                rank = r
            elif r != rank:
                raise ValueError(
                    f"adapter {adapter_id!r}: mixed ranks {rank} vs {r}")
        if rank > self.max_rank:
            raise ValueError(
                f"adapter {adapter_id!r} rank {rank} exceeds the pool's "
                f"max_rank {self.max_rank} (DS_LORA_MAX_RANK)")

        rb = self.rank_block
        chunks = []
        for j in range(math.ceil(rank / rb)):
            a_c, b_c = self._zero_chunks()
            lo, hi = j * rb, min((j + 1) * rb, rank)
            for t, leaves in per_target.items():
                scale = leaves["lora_scale"].astype(np.float32)
                a_c[t][:, :, :hi - lo] = \
                    leaves["lora_a"][:, :, lo:hi].astype(np.float32)
                b_c[t][:, :hi - lo, :] = \
                    leaves["lora_b"][:, lo:hi, :].astype(np.float32) \
                    * scale[:, None, None]
            chunks.append({"a": a_c, "b": b_c})
        self._staged[adapter_id] = chunks
        self._rank[adapter_id] = int(rank)

    def registered(self) -> List[str]:
        return sorted(self._staged)

    # -- residency -----------------------------------------------------
    @property
    def active_adapters(self) -> int:
        return len(self._blocks)

    @property
    def pool_bytes(self) -> int:
        """Device bytes of the pools, the trash block included."""
        return self._block_bytes * self.num_blocks

    def resident(self, adapter_id: str) -> bool:
        return adapter_id in self._blocks

    def refcount(self, adapter_id: str) -> int:
        """In-flight requests pinning ``adapter_id`` (0 when it is not
        resident)."""
        return self._refcount.get(adapter_id, 0)

    def _evict_one(self) -> bool:
        """Evict the least-recently-used refcount-zero resident, its
        blocks back to the free list; False when every resident is
        pinned. The evicted blocks keep their bytes until the next load
        overwrites them: no table row points at them."""
        victims = [aid for aid, rc in self._refcount.items() if rc == 0]
        if not victims:
            return False
        victim = min(victims, key=lambda aid: self._last_used[aid])
        self._free.extend(self._blocks.pop(victim))
        del self._refcount[victim]
        del self._last_used[victim]
        self.evictions += 1
        hook = self.hooks.get("on_evict")
        if hook is not None:
            hook()
        return True

    def _pop_free(self) -> int:
        if not self._free and not self._evict_one():
            raise AdapterLoadError(
                "adapter pool exhausted: every resident adapter is "
                "pinned by an in-flight request")
        return self._free.pop()

    @torch.inference_mode()
    def _write(self, bid: int, chunk) -> None:
        """Write one rank block of every target into pool block ``bid``,
        in place, in the pools' dtype."""
        for t in self.a_pool:
            self.a_pool[t][:, bid].copy_(torch.from_numpy(chunk["a"][t]))
            self.b_pool[t][:, bid].copy_(torch.from_numpy(chunk["b"][t]))

    def acquire(self, adapter_id: str) -> np.ndarray:
        """Pin ``adapter_id`` for one request and return its table row
        (``[blocks_per_adapter]`` int32, zero-padded). A miss loads the
        adapter; the ``cache.adapter_load`` site fires before any pool
        state moves, so a failed load leaves the pool as it was. Raises
        :class:`AdapterLoadError` (or the injector's
        ``TransientDeviceError``); the caller owns one :meth:`release`."""
        if adapter_id not in self._staged:
            raise AdapterLoadError(
                f"adapter {adapter_id!r} is not registered")
        self._tick += 1
        if adapter_id in self._blocks:
            self._refcount[adapter_id] += 1
            self._last_used[adapter_id] = self._tick
            self.hits += 1
            hook = self.hooks.get("on_hit")
            if hook is not None:
                hook()
            return self._row(adapter_id)
        fault = self.faults.fire("cache.adapter_load")
        if fault is not None and fault.kind == "cache_exhausted":
            raise AdapterLoadError(
                f"injected adapter-pool exhaustion loading {adapter_id!r}")
        chunks = self._staged[adapter_id]
        blocks: List[int] = []
        try:
            for _ in chunks:
                blocks.append(self._pop_free())
        except AdapterLoadError:
            self._free.extend(reversed(blocks))
            raise
        for bid, chunk in zip(blocks, chunks):
            self._write(bid, chunk)
        self._blocks[adapter_id] = blocks
        self._refcount[adapter_id] = 1
        self._last_used[adapter_id] = self._tick
        self.loads += 1
        hook = self.hooks.get("on_load")
        if hook is not None:
            hook()
        if self.tracer is not None:
            self.tracer.event(
                "adapter_load", adapter=adapter_id,
                rank=self._rank[adapter_id], blocks=len(blocks),
                resident=len(self._blocks))
        return self._row(adapter_id)

    def release(self, adapter_id: str) -> None:
        """Drop one pin. The blocks stay resident (an evictable warm
        entry) until the pool needs the room."""
        rc = self._refcount.get(adapter_id)
        if rc is None or rc <= 0:
            raise ValueError(
                f"release of non-acquired adapter {adapter_id!r}")
        self._refcount[adapter_id] = rc - 1

    def _row(self, adapter_id: str) -> np.ndarray:
        row = np.zeros((self.blocks_per_adapter,), np.int32)
        blocks = self._blocks[adapter_id]
        row[:len(blocks)] = blocks
        return row

    # -- program plumbing ---------------------------------------------
    def lora_args(self, rows) -> tuple:
        """The engine's ``lora=`` operand: ``(a_pool, b_pool, rows)`` with
        a copy of ``rows``, ``[B, NBa]`` (decode, verify) or ``[NBa]`` (one
        prefill slot)."""
        return (self.a_pool, self.b_pool, np.array(rows, np.int32))

    def stats(self) -> Dict[str, int]:
        return {
            "registered": len(self._staged),
            "resident": len(self._blocks),
            "pool_blocks": self.num_blocks - 1,
            "free_blocks": len(self._free),
            "pool_bytes": self.pool_bytes,
            "hits": self.hits,
            "loads": self.loads,
            "evictions": self.evictions,
        }

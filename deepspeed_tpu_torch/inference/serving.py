"""Continuous-batching serving scheduler over the paged KV cache.

Port of the core of ``deepspeed_tpu/inference/serving.py`` (Orca-style
iteration-level batching, Yu et al. OSDI '22). A fixed set of decode
slots; every iteration

1. **admission**: queued requests claim free slots when the paged cache
   can cover their prompt and keep the watermark reserve;
2. **prefill**: admitted requests prefill their prompt into their slot in
   fixed-width chunks, one chunk per slot per iteration, so a long prompt
   never stalls the running batch for more than one chunk;
3. **decode**: every decoding slot advances one token through
   ``InferenceEngine.decode_slots``, each at its own position.

When the pool runs dry mid-decode the scheduler evicts the most recently
admitted request: its blocks return to the pool and it requeues at the
front with prompt + generated as its new prompt, whose re-prefill
reproduces the pre-eviction state exactly (recompute preemption).
``max_evictions`` pins a request against further eviction, so an
eviction storm cannot livelock.

Greedy parity contract, as in the JAX package: every temperature=0
request's output is token-for-token identical to a solo
``InferenceEngine.generate`` run of its prompt.

``kv_quant="int8"`` keeps the paged cache as int8 blocks with
per-(block, kv head) fp32 scales; it is resolved once in the constructor
and the scale pools ride through every prefill and decode call. The
prefix cache, speculative decode, the host tier, LoRA, the multi-step
decode horizon, telemetry (with it the KV-quant gauges), fault
injection, deadlines, queue shedding, the step watchdog and the
prefill-only role wait for later slices; the constructor raises on a
knob that asks for one of them.
"""

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.inference import sampling
from deepspeed_tpu_torch.inference.paged_cache import (CacheExhausted,
                                                       PagedKVCache)
from deepspeed_tpu_torch.ops.quantizer import resolve_kv_quant

# constructor knobs of the JAX scheduler that wait for a later slice:
# {knob: (the values that leave it off, the slice that brings it)}. The
# values are the JAX defaults (and the explicit "off" spellings); any
# other value raises NotImplementedError naming the slice
_PREFIX, _SPEC, _HOST = "prefix-cache", "speculative-decode", "host-tier"
_LORA, _HORIZON, _TELEMETRY = "LoRA-serving", "decode-horizon", "telemetry"
_FAULTS, _ROLES = "fault-tolerance", "prefill-only-role"
_WAITING = {
    "prefix_cache": ((None, False), _PREFIX),
    "spec_decode": ((None, False), _SPEC), "spec_k": ((None,), _SPEC),
    "spec_draft": ((None,), _SPEC), "spec_accept_floor": ((0.125,), _SPEC),
    "spec_adapt_warmup": ((4,), _SPEC),
    "host_tier": ((None, False), _HOST),
    "host_budget_bytes": ((None,), _HOST),
    "spill_watermark": ((None,), _HOST),
    "lora_serve": ((None, False), _LORA), "lora_pool_mb": ((None,), _LORA),
    "lora_pool_blocks": ((None,), _LORA), "lora_max_rank": ((None,), _LORA),
    "lora_rank_block": ((None,), _LORA),
    "decode_horizon": ((None, 1), _HORIZON),
    "telemetry": ((None, False), _TELEMETRY),
    "cost_accounting": ((None, False), _TELEMETRY),
    "flight_recorder": ((None, False), _TELEMETRY),
    "flight_dir": ((None,), _TELEMETRY),
    "faults": ((None,), _FAULTS), "max_queue": ((None,), _FAULTS),
    "step_time_budget_s": ((None,), _FAULTS),
    "watchdog_grace": ((2,), _FAULTS), "max_retries": ((3,), _FAULTS),
    "retry_backoff_s": ((0.02,), _FAULTS),
    "prefill_only": ((False,), _ROLES),
}


@dataclass
class ServeRequest:
    """One generation request. ``out`` accumulates generated token ids,
    ``token_times`` the scheduler-clock stamp of each. Sampling knobs of
    None take the engine-wide defaults; ``logprobs=True`` records each
    emitted token's log-probability in ``out_logprobs``."""
    rid: Any
    prompt: np.ndarray
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: Optional[int] = None
    repetition_penalty: Optional[float] = None
    logprobs: bool = False
    out: List[int] = field(default_factory=list)
    out_logprobs: List[float] = field(default_factory=list)
    state: str = "queued"      # queued | prefill | decode | done
    token_times: List[float] = field(default_factory=list)
    submitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    evictions: int = 0
    _admit_seq: int = -1                 # eviction picks the youngest
    _work: Optional[np.ndarray] = None   # prompt (+generated, on resume)

    @property
    def tokens(self) -> np.ndarray:
        """prompt + generated, the generate()-shaped result row."""
        return np.concatenate([np.asarray(self.prompt, np.int32),
                               np.asarray(self.out, np.int32)])


class ServingEngine:
    """Continuous-batching front end for an ``InferenceEngine``.

    ``num_blocks`` / ``hbm_budget_bytes`` bound the paged cache,
    ``num_slots`` the decode batch, ``prefill_chunk`` the prompt work of
    one iteration. ``temperature`` / ``top_k`` / ``seed`` are defaults for
    requests that leave theirs at None. ``max_evictions`` is the per-request
    preemption cap. ``kv_quant``: ``"off"`` (default) or ``"int8"`` paged
    KV blocks (the JAX package's aliases are accepted). ``decode_impl``
    must stay None: the port picks the decode attention by device, not by
    a switch. The JAX constructor's other knobs are accepted at their
    JAX defaults (``_WAITING``) and raise NotImplementedError otherwise."""

    def __init__(self, engine, *, num_slots: int = 4, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 hbm_budget_bytes: Optional[int] = None,
                 prefill_chunk: int = 64, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0, max_evictions: int = 8,
                 kv_quant=None, decode_impl: Optional[str] = None,
                 **waiting):
        if decode_impl is not None:
            raise ValueError(
                f"ServingEngine(decode_impl={decode_impl!r}): the port "
                f"dispatches by device (the K3 kernel on the card, its "
                f"plain version on the host) and has no implementation "
                f"switch; leave decode_impl at None")
        for knob, value in waiting.items():
            if knob not in _WAITING:
                raise TypeError(f"ServingEngine got an unknown knob {knob!r}")
            off, slice_name = _WAITING[knob]
            if value not in off:
                raise NotImplementedError(
                    f"ServingEngine({knob}={value!r}) waits for the "
                    f"{slice_name} slice of the port; only {off} is taken")
        self.engine = engine
        self.kv_quant = resolve_kv_quant(kv_quant)
        self.cache = PagedKVCache(
            engine.cfg, num_slots=num_slots, block_size=block_size,
            num_blocks=num_blocks, hbm_budget_bytes=hbm_budget_bytes,
            dtype=engine.dtype, max_seq_len=engine.max_seq_len,
            device=engine.device, kv_quant=self.kv_quant)
        self.num_slots = num_slots
        self.prefill_chunk = int(prefill_chunk)
        self.temperature = temperature
        self.top_k = top_k
        self.seed = int(seed)
        self.max_evictions = int(max_evictions)
        self.sampler = sampling.SlotSamplerState(num_slots,
                                                 engine.cfg.vocab_size)
        self.queue: deque = deque()
        self.slots: List[Optional[ServeRequest]] = [None] * num_slots
        self.finished: List[ServeRequest] = []
        self._progress = np.zeros((num_slots,), np.int64)  # prefilled toks
        self._admit_counter = 0
        self._step_clock = 0
        self.stats: Dict[str, int] = {
            k: 0 for k in ("steps", "occupancy_sum", "peak_occupancy",
                           "evictions", "admitted", "completed",
                           "prefill_chunks", "decode_steps", "evict_capped",
                           "sampled_tokens")}

    def submit(self, req: ServeRequest, now: float = 0.0) -> bool:
        """Enqueue ``req``; malformed requests raise ValueError."""
        total = len(req.prompt) + req.max_new_tokens
        if total > self.engine.max_seq_len:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + "
                f"max_new {req.max_new_tokens} exceeds max_seq_len "
                f"{self.engine.max_seq_len}")
        if self.cache.blocks_for(total) > self.cache.num_blocks - 1:
            raise ValueError(
                f"request {req.rid} needs more blocks than the whole pool")
        sampling.resolve_params(req, self.temperature, self.top_k, self.seed)
        req.submitted_at = now
        req._work = np.asarray(req.tokens if req.out else req.prompt,
                               np.int32)
        self.queue.append(req)
        return True

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def step(self, now: Optional[float] = None) -> int:
        """One scheduler iteration: admit, prefill chunks, decode. Returns
        the number of decoding slots this iteration."""
        if now is None:
            now = float(self._step_clock)
        self._admit(now)
        self._prefill_step(now)
        occ = self._decode_step(now)
        self._step_clock += 1
        self.stats["steps"] += 1
        self.stats["occupancy_sum"] += occ
        self.stats["peak_occupancy"] = max(self.stats["peak_occupancy"], occ)
        return occ

    def run(self, requests=None, max_steps: int = 1_000_000,
            wall_clock: bool = False) -> Dict[Any, np.ndarray]:
        """Submit ``requests`` (if given) and step until idle. Returns
        {rid: prompt+generated} for every finished request."""
        for r in (requests or []):
            self.submit(r, now=time.perf_counter() if wall_clock else 0.0)
        steps = 0
        while self.busy:
            self.step(time.perf_counter() if wall_clock else None)
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"serving did not drain in {max_steps} steps "
                    f"(queue {len(self.queue)})")
        return {r.rid: r.tokens for r in self.finished}

    # -- phases ----------------------------------------------------------
    def _admit(self, now: float = 0.0) -> None:
        # FIFO head-of-line: a preempted request (appendleft) resumes
        # before newer arrivals
        while self.queue:
            slot = next((i for i, s in enumerate(self.slots) if s is None),
                        None)
            if slot is None:
                break
            req = self.queue[0]
            occupied = any(s is not None for s in self.slots)
            # an idle engine skips the watermark so a lone request that
            # fits the pool always makes progress
            if not self.cache.can_admit(len(req._work),
                                        watermark=None if occupied else 0):
                break
            try:
                matched = self.cache.allocate(slot, len(req._work))
            except CacheExhausted:
                break
            self.queue.popleft()
            self.slots[slot] = req
            self._progress[slot] = matched
            req.state = "prefill"
            req._admit_seq = self._admit_counter
            self._admit_counter += 1
            params = sampling.resolve_params(req, self.temperature,
                                             self.top_k, self.seed)
            # the repetition-penalty mask seeds from prompt + generated,
            # so a resumed request keeps its penalty state
            self.sampler.admit(slot, params, req._work)
            self.stats["admitted"] += 1

    def _prefill_step(self, now: float) -> None:
        for slot, req in enumerate(self.slots):
            if req is None or req.state != "prefill":
                continue
            done = int(self._progress[slot])
            n = min(self.prefill_chunk, len(req._work) - done)
            chunk = np.zeros((self.prefill_chunk,), np.int32)
            chunk[:n] = req._work[done:done + n]
            lane = self.sampler.lane(slot, len(req.out))
            out = self.engine.prefill_into_slot(
                self.cache.k, self.cache.v, self.cache.tables[slot], chunk,
                done, n, k_scale=self.cache.k_scale,
                v_scale=self.cache.v_scale, sample_state=lane)
            tok, lp = out[1], out[2]
            self._store_pools(out[3:])
            self.cache.advance(slot, n)
            self._progress[slot] = done + n
            self.stats["prefill_chunks"] += 1
            if self._progress[slot] == len(req._work):
                # final chunk: its last position yields the next token (on
                # resume, exactly the pre-eviction one)
                self._emit(slot, req, int(tok[0]), float(lp[0]), now)
                if req.state != "done":
                    req.state = "decode"

    def _decode_step(self, now: float) -> int:
        # every decoding slot needs room for one more token; exhaustion
        # evicts the youngest request rather than overrunning the pool
        for slot, req in enumerate(self.slots):
            if req is None or req.state != "decode":
                continue
            if self.cache.at_capacity(slot):
                # the next write would clamp into the slot's last live
                # block; eviction is no escape (the resume prompt is as
                # long), so finish the request
                self._finish(slot, req, now)
                continue
            while True:
                try:
                    self.cache.ensure_capacity(
                        slot, int(self.cache.lengths[slot]) + 1)
                    break
                except CacheExhausted:
                    if self._evict_one(exclude=slot):
                        continue
                    # nobody else is evictable: preempt this request,
                    # unless the storm guard pinned it; then truncate
                    if req.evictions < self.max_evictions:
                        self._preempt(slot)
                    else:
                        self.stats["evict_capped"] += 1
                        self._finish(slot, req, now)
                    break
        live = [i for i, r in enumerate(self.slots)
                if r is not None and r.state == "decode"]
        if not live:
            return 0
        tokens = np.zeros((self.num_slots,), np.int32)
        active = np.zeros((self.num_slots,), bool)
        gen_counts = np.zeros((self.num_slots,), np.int64)
        for i in live:
            tokens[i] = self.slots[i].out[-1]
            active[i] = True
            gen_counts[i] = len(self.slots[i].out)
        out = self.engine.decode_slots(
            self.cache.k, self.cache.v, self.cache.tables, self.cache.lengths,
            tokens, active, k_scale=self.cache.k_scale,
            v_scale=self.cache.v_scale,
            sample_state=self.sampler.lanes(gen_counts))
        toks, lps = out[1], out[2]
        self._store_pools(out[3:])
        self.stats["decode_steps"] += 1
        # one host transfer for every slot's token and logprob
        toks = toks.cpu().numpy()
        lps = lps.cpu().numpy()
        for i in live:
            self.cache.advance(i, 1)
            self._emit(i, self.slots[i], int(toks[i]), float(lps[i]), now)
        return len(live)

    def _store_pools(self, pools) -> None:
        """The pools (and, with int8 pools, the scale pools) a slot
        program returned."""
        self.cache.k, self.cache.v = pools[:2]
        if self.cache.quantized:
            self.cache.k_scale, self.cache.v_scale = pools[2:]

    def _finish(self, slot: int, req: ServeRequest, now: float) -> None:
        """Retire a request: blocks back to the pool, slot reopened."""
        req.state = "done"
        req.finished_at = now
        self.cache.free(slot)
        self.slots[slot] = None
        self.sampler.release(slot)
        self.finished.append(req)
        self.stats["completed"] += 1

    def _emit(self, slot: int, req: ServeRequest, tok: int, lp: float,
              now: float) -> None:
        """Record one token the sampler chose: output, logprob, latency
        stamps, then the max_new_tokens / eos check."""
        self.sampler.observe(slot, tok)
        if req.logprobs:
            req.out_logprobs.append(lp)
        if self.sampler.temps[slot] > 0.0:
            self.stats["sampled_tokens"] += 1
        req.out.append(tok)
        req.token_times.append(now)
        if req.first_token_at is None:
            req.first_token_at = now
        if (len(req.out) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)):
            self._finish(slot, req, now)

    def _evict_one(self, exclude: int) -> bool:
        """Preempt the most recently admitted live request other than
        ``exclude``, skipping requests at the eviction cap."""
        victim = None
        capped = 0
        for i, r in enumerate(self.slots):
            if i == exclude or r is None:
                continue
            if r.evictions >= self.max_evictions:
                capped += 1
                continue
            if victim is None or r._admit_seq > self.slots[victim]._admit_seq:
                victim = i
        if victim is None:
            self.stats["evict_capped"] += capped
            return False
        self._preempt(victim)
        return True

    def _preempt(self, slot: int) -> None:
        """Free the slot and requeue its request at the front for
        recompute-on-resume: the new working prompt is prompt+generated."""
        req = self.slots[slot]
        req._work = req.tokens
        req.state = "queued"
        req.evictions += 1
        self.stats["evictions"] += 1
        self.cache.free(slot)
        self.slots[slot] = None
        self.sampler.release(slot)
        self.queue.appendleft(req)

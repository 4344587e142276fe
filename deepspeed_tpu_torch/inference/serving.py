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
and the scale pools ride through every prefill and decode call.

Shared-prefix caching (``prefix_cache=True`` or ``DS_PREFIX_CACHE=on``):
admission matches the request's longest cached prefix, maps those blocks
into the slot read-only and starts prefill at the matched boundary; when
the prompt is prefilled its full blocks are published for the next
request. ``stats["prefix_hits"]`` and ``stats["prefix_tokens_saved"]``
count the win. Starting prefill at a nonzero offset over shared blocks
gives the cold logits (the prefill chunk attends the slot's whole table
under the causal mask), so warm and cold streams are the same.

Speculative decoding (``spec_decode=True`` or ``DS_SPEC_DECODE=on``):
every decode iteration a drafter (``inference/spec_decode.py``, prompt
lookup by default) proposes ``spec_k`` tokens per decoding slot, one
``InferenceEngine.verify_slots`` call scores all ``spec_k + 1``
positions (the paged kernel's verify mode on the card), and each slot
accepts its longest draft prefix: by agreement with the target's argmax
for a greedy slot, and by rejection sampling
(``sampling.spec_verify_tokens``) for a sampled slot, whose distribution
is the target's. The slot then commits ``accepted + 1`` tokens and rolls
its cache back past the first reject (``cache.rollback``). A slot whose acceptance falls under
``spec_accept_floor`` (after ``spec_adapt_warmup`` verifies) accepts at
most one draft token until it recovers. In float32 a greedy slot's
stream is the spec-off stream token for token. In bf16, or with int8
pools, the verify mode rounds differently from the decode mode, so the
two streams agree until a near-tie of the logits flips; a spec-on stream
is then reproduced only by another spec-on run.

The multi-step decode horizon (``decode_horizon=N`` or
``DS_DECODE_HORIZON=N``, 1 <= N <= 32): each decode phase runs up to N
iterations in one ``InferenceEngine.decode_horizon`` call, with each
slot's budget, eos and stop sequences freezing its lane on the device,
and one host transfer for the whole horizon. Admission and eviction run
at the horizon's boundary, and the harvest replays each slot's tokens
through the same ``_emit`` as one-token decode, so the streams are the
N = 1 streams. A slot that cannot grow by N tokens runs a shorter
horizon (``PagedKVCache.horizon_budget``); eviction happens only for the
first token, as at N = 1. Speculation, when on, takes precedence. The
step clock advances by the tokens the horizon produced, so the
one-token-per-tick stamps of ``token_times`` keep their meaning.

The host-DRAM KV tier (``host_tier=True`` or ``DS_KV_HOST_TIER=on``,
with the prefix cache; ``host_budget_bytes``, ``spill_watermark``):
cached prefix blocks spill to host memory under pool pressure
(``PagedKVCache.spill_tick``, right after every decode dispatch) and a
later hit restores them instead of re-prefilling. ``stats`` mirrors the
cache's ``host_*`` counters.

Requests take ``stop`` (token-id sequences: the request finishes once
``out`` ends with one, the stop tokens kept, counted in
``stats["stop_hits"]``) and ``n`` (``n > 1`` candidates: the clones get
the rids ``rid#i`` and the seeds ``sampling.candidate_seed(seed, i)``),
as in JAX.

Every knob above, and ``kv_quant``, left at None is read from the
environment as the JAX engine reads it (``utils/env.py``). LoRA,
telemetry (with it the KV-quant gauges and the horizon histogram),
fault injection, deadlines, queue shedding, the step watchdog and the
prefill-only role wait for later slices: the constructor raises on a
knob, or an environment flag, that asks for one of them. Without fault
injection there is no "degrade this step to plain decode" branch: a
verify or a horizon on the card launches its kernels or raises.
"""

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.inference import sampling
from deepspeed_tpu_torch.inference.host_tier import resolve_host_tier
from deepspeed_tpu_torch.inference.paged_cache import (CacheExhausted,
                                                       PagedKVCache,
                                                       resolve_prefix_cache)
from deepspeed_tpu_torch.inference.spec_decode import (make_draft,
                                                       resolve_spec_decode,
                                                       resolve_spec_k)
from deepspeed_tpu_torch.ops.quantizer import resolve_kv_quant
from deepspeed_tpu_torch.utils.env import (check_waiting_flags,
                                           resolve_decode_horizon)

# stop sequences the horizon checks on the device: a stop longer than
# HORIZON_STOP_WIDTH tokens, or past the first HORIZON_MAX_STOPS, leaves
# its lane running to its budget, and the host's _emit cuts the stream at
# the true hit (only the early freeze is lost)
HORIZON_STOP_WIDTH = 8
HORIZON_MAX_STOPS = 4

# constructor knobs of the JAX scheduler that wait for a later slice:
# {knob: (the values that leave it off, the slice that brings it)}. The
# values are the JAX defaults (and the explicit "off" spellings); any
# other value raises NotImplementedError naming the slice
_LORA, _TELEMETRY, _FAULTS = "LoRA-serving", "telemetry", "fault-tolerance"
_ROLES = "prefill-only-role"
_WAITING = {
    "lora_serve": ((None, False), _LORA), "lora_pool_mb": ((None,), _LORA),
    "lora_pool_blocks": ((None,), _LORA), "lora_max_rank": ((None,), _LORA),
    "lora_rank_block": ((None,), _LORA),
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
    emitted token's log-probability in ``out_logprobs``. ``stop`` is a
    list of token-id sequences: the request finishes as soon as ``out``
    ends with one of them (the stop tokens stay in ``out``). ``n > 1``
    expands at submit into ``n`` candidates (rids ``rid#1`` ..
    ``rid#n-1`` beside the original), seeded by
    :func:`sampling.candidate_seed`."""
    rid: Any
    prompt: np.ndarray
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: Optional[int] = None
    repetition_penalty: Optional[float] = None
    stop: Optional[List[Sequence[int]]] = None
    logprobs: bool = False
    n: int = 1
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
    preemption cap. ``kv_quant``: ``"off"`` or ``"int8"`` paged KV blocks
    (the JAX package's aliases are accepted). ``prefix_cache``: share
    cached prefix blocks across requests. ``spec_decode``, ``spec_k``
    (draft tokens per step), ``spec_draft`` (``"ngram"``, a draft
    ``InferenceEngine`` or an object with ``propose(context, k)``),
    ``spec_accept_floor`` and ``spec_adapt_warmup``: speculative decoding
    with adaptive depth. ``decode_horizon``: decode iterations per
    dispatch (1..32). ``host_tier``, ``host_budget_bytes`` (default 256
    MiB) and ``spill_watermark`` (free blocks under which the cache
    spills; default the admission watermark plus one transfer batch):
    the host-DRAM KV tier, inert without the prefix cache. Each of
    ``kv_quant``, ``prefix_cache``, ``spec_decode``, ``spec_k``,
    ``spec_draft``, ``decode_horizon``, ``host_tier`` and
    ``host_budget_bytes`` left at None is read from its ``DS_*``
    environment flag, else off (``spec_k`` 4, ``spec_draft`` ngram,
    ``decode_horizon`` 1). ``decode_impl``
    must stay None: the port picks the decode attention by device, not by
    a switch. The JAX constructor's other knobs are accepted at their
    JAX defaults (``_WAITING``) and raise NotImplementedError otherwise."""

    def __init__(self, engine, *, num_slots: int = 4, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 hbm_budget_bytes: Optional[int] = None,
                 prefill_chunk: int = 64, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0, max_evictions: int = 8,
                 kv_quant=None, decode_impl: Optional[str] = None,
                 prefix_cache: Optional[bool] = None,
                 spec_decode: Optional[bool] = None,
                 spec_k: Optional[int] = None, spec_draft=None,
                 spec_accept_floor: float = 0.125,
                 spec_adapt_warmup: int = 4,
                 decode_horizon: Optional[int] = None,
                 host_tier: Optional[bool] = None,
                 host_budget_bytes: Optional[int] = None,
                 spill_watermark: Optional[int] = None, **waiting):
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
        check_waiting_flags(waiting)
        self.engine = engine
        self.kv_quant = resolve_kv_quant(kv_quant)
        self.prefix_cache = resolve_prefix_cache(prefix_cache)
        self.cache = PagedKVCache(
            engine.cfg, num_slots=num_slots, block_size=block_size,
            num_blocks=num_blocks, hbm_budget_bytes=hbm_budget_bytes,
            dtype=engine.dtype, max_seq_len=engine.max_seq_len,
            device=engine.device, kv_quant=self.kv_quant,
            prefix_cache=self.prefix_cache,
            host_tier=resolve_host_tier(host_tier),
            host_budget_bytes=host_budget_bytes,
            spill_watermark=spill_watermark)
        # the effective switch: the cache keeps the tier off without the
        # prefix index
        self.host_tier = self.cache.host_tier
        # the horizon is fixed for the run; with speculation on, the
        # verify chunk is the multi-token step and takes precedence
        self.decode_horizon = resolve_decode_horizon(decode_horizon)
        # the step clock ticks once per emitted token: a horizon that
        # produced p tokens takes p ticks (_horizon_ticks), and its tokens
        # are stamped now, now + 1, ... as N = 1 would stamp them.
        # last_step_span tells a caller that drives its own clock how far
        # a step went; token_time_unit is the stamp spacing such a caller
        # announces (0.0: every token of a horizon at the dispatch time)
        self._horizon_ticks = 1
        self._token_tick = 1.0
        self.last_step_span = 1.0
        self.token_time_unit = 0.0
        # iterations of the one-token decode body run: one per plain
        # decode step, the iterations of each horizon (K3 runs once per
        # layer in each)
        self.decode_iterations = 0
        # speculative decode: the drafter and the chunk length are fixed
        # for the run
        self.spec_decode = resolve_spec_decode(spec_decode)
        self.spec_k = resolve_spec_k(spec_k)
        self.draft = make_draft(spec_draft) if self.spec_decode else None
        self.spec_accept_floor = float(spec_accept_floor)
        self.spec_adapt_warmup = int(spec_adapt_warmup)
        self._accept_ewma = np.ones(num_slots, np.float64)
        self._spec_obs = np.zeros(num_slots, np.int64)
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
                           "sampled_tokens", "prefix_hits",
                           "prefix_tokens_saved", "spec_steps",
                           "spec_slot_steps", "spec_proposed",
                           "spec_accepted", "spec_emitted", "spec_k_capped",
                           "stop_hits", "host_blocks", "host_bytes",
                           "host_spills", "host_restores",
                           "host_restore_failures")}

    def submit(self, req: ServeRequest, now: float = 0.0) -> bool:
        """Enqueue ``req`` (and, with ``n > 1``, its candidates);
        malformed requests raise ValueError."""
        total = len(req.prompt) + req.max_new_tokens
        if total > self.engine.max_seq_len:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + "
                f"max_new {req.max_new_tokens} exceeds max_seq_len "
                f"{self.engine.max_seq_len}")
        if self.cache.blocks_for(total) > self.cache.num_blocks - 1:
            raise ValueError(
                f"request {req.rid} needs more blocks than the whole pool")
        # resolved here so that the candidates' seeds derive from the seed
        # admission will use
        params = sampling.resolve_params(req, self.temperature, self.top_k,
                                         self.seed)
        if req.n < 1:
            raise ValueError(f"request {req.rid}: n must be >= 1, "
                             f"got {req.n}")
        if req.n > 1:
            # the original is candidate 0; n is pinned to 1 on every
            # piece, so a resubmitted piece never expands again
            n, req.n = req.n, 1
            ok = self.submit(req, now=now)
            for i in range(1, n):
                clone = ServeRequest(
                    rid=f"{req.rid}#{i}", prompt=req.prompt,
                    max_new_tokens=req.max_new_tokens, eos_id=req.eos_id,
                    temperature=req.temperature, top_k=req.top_k,
                    top_p=req.top_p,
                    seed=sampling.candidate_seed(params.seed, i),
                    repetition_penalty=req.repetition_penalty,
                    stop=req.stop, logprobs=req.logprobs, n=1)
                ok = self.submit(clone, now=now) and ok
            return ok
        req.submitted_at = now
        req._work = np.asarray(req.tokens if req.out else req.prompt,
                               np.int32)
        self.queue.append(req)
        return True

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def step(self, now: Optional[float] = None) -> int:
        """One scheduler iteration: admit, prefill chunks, decode (one
        token, a horizon or a verify), then the host tier's spill tick.
        Returns the number of decoding slots this iteration."""
        if now is None:
            now = float(self._step_clock)
            self._token_tick = 1.0
        else:
            self._token_tick = float(self.token_time_unit)
        self._horizon_ticks = 1
        self._admit(now)
        self._prefill_step(now)
        occ = self._decode_step(now)
        self._spill_step()
        self._step_clock += self._horizon_ticks
        self.last_step_span = float(self._horizon_ticks)
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
            # (the charge covers only the uncached suffix when the prefix
            # cache can share blocks)
            if not self.cache.can_admit(len(req._work), tokens=req._work,
                                        watermark=None if occupied else 0):
                break
            try:
                matched = self.cache.allocate(slot, len(req._work),
                                              tokens=req._work)
            except CacheExhausted:
                break
            self.queue.popleft()
            self.slots[slot] = req
            # prefill resumes at the matched boundary: the shared blocks'
            # K/V is resident
            self._progress[slot] = matched
            # the cache counts the prefix hits; the stats read its counters
            self.stats["prefix_hits"] = self.cache.prefix_hits
            self.stats["prefix_tokens_saved"] = self.cache.prefix_tokens_saved
            req.state = "prefill"
            req._admit_seq = self._admit_counter
            self._admit_counter += 1
            params = sampling.resolve_params(req, self.temperature,
                                             self.top_k, self.seed)
            # the repetition-penalty mask seeds from prompt + generated,
            # so a resumed request keeps its penalty state
            self.sampler.admit(slot, params, req._work)
            self._accept_ewma[slot] = 1.0
            self._spec_obs[slot] = 0
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
                # prompt resident: publish its full blocks for the next
                # request sharing the prefix (before _emit, which may free
                # the slot)
                self.cache.register_prefix(slot, req._work)
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
        if self.spec_decode:
            return self._spec_decode_step(live, now)
        if self.decode_horizon > 1:
            return self._horizon_decode_step(live, now)
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
        self.decode_iterations += 1
        # one host transfer for every slot's token and logprob
        toks = toks.cpu().numpy()
        lps = lps.cpu().numpy()
        for i in live:
            self.cache.advance(i, 1)
            self._emit(i, self.slots[i], int(toks[i]), float(lps[i]), now)
        return len(live)

    def _horizon_decode_step(self, live: List[int], now: float) -> int:
        """Up to ``decode_horizon`` decode iterations over the decoding
        slots in one ``decode_horizon`` call, each slot's budget, eos and
        stop sequences freezing its lane on the device, then one host
        transfer and the replay of each slot's tokens through ``_emit``
        (which stays the authority on stops the device does not model).
        Capacity is opportunistic: a slot that cannot grow by N tokens
        runs a shorter horizon; the plain preamble already secured its
        first token."""
        N = self.decode_horizon
        B, W = self.num_slots, HORIZON_STOP_WIDTH
        tokens = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        gen_counts = np.zeros((B,), np.int64)
        budgets = np.zeros((B,), np.int32)
        eos_ids = np.full((B,), -1, np.int32)
        stop_ids = np.zeros((B, HORIZON_MAX_STOPS, W), np.int32)
        stop_lens = np.zeros((B, HORIZON_MAX_STOPS), np.int32)
        tail = np.full((B, W), -1, np.int32)
        for i in live:
            req = self.slots[i]
            tokens[i] = req.out[-1]
            active[i] = True
            gen_counts[i] = len(req.out)
            length = int(self.cache.lengths[i])
            granted = self.cache.horizon_budget(
                i, min(length + N, self.cache.tokens_per_slot))
            # >= 1: the preamble secured one token of room, and a request
            # with nothing left to emit has finished already
            budgets[i] = max(1, min(N, granted - length,
                                    req.max_new_tokens - len(req.out)))
            if req.eos_id is not None:
                eos_ids[i] = int(req.eos_id)
            row = 0
            for stop in (req.stop or ()):
                if 0 < len(stop) <= W and row < HORIZON_MAX_STOPS:
                    stop_ids[i, row, W - len(stop):] = [int(t) for t in stop]
                    stop_lens[i, row] = len(stop)
                    row += 1
            w = min(len(req.out), W)
            if req.stop and w:
                tail[i, W - w:] = req.out[-w:]
        # no lane can emit more than its budget: the largest one is the
        # horizon's length
        n_steps = int(budgets[live].max())
        out = self.engine.decode_horizon(
            self.cache.k, self.cache.v, self.cache.tables, self.cache.lengths,
            tokens, active, n_steps, budgets, eos_ids, stop_ids, stop_lens,
            tail, k_scale=self.cache.k_scale, v_scale=self.cache.v_scale,
            sample_state=self.sampler.lanes(gen_counts))
        self._store_pools(out[4:])
        self.stats["decode_steps"] += 1
        self.decode_iterations += n_steps
        # one host transfer harvests the whole horizon
        produced = out[2].cpu().numpy()
        toks = out[0].cpu().numpy()
        lps = out[1].cpu().numpy()
        tick = self._token_tick
        ticks = 1
        for i in live:
            req = self.slots[i]
            p = int(produced[i])
            # one advance covers the horizon (p is within the grant); a
            # finish below frees the slot with any surplus writes
            self.cache.advance(i, p)
            for j in range(p):
                self._emit(i, req, int(toks[j, i]), float(lps[j, i]),
                           now + j * tick)
                if req.state == "done":
                    # a stop the device does not model hit first: the
                    # surplus tokens go with the freed slot
                    break
            ticks = max(ticks, p)
        self._horizon_ticks = ticks
        return len(live)

    def _spec_decode_step(self, live: List[int], now: float) -> int:
        """One speculative iteration over the decoding slots: draft
        ``spec_k`` tokens per slot, verify all ``spec_k + 1`` positions in
        one ``verify_slots`` call, accept each slot's draft prefix, emit
        the accepted tokens and the target's correction, and roll the
        cache back past the first reject. Capacity is opportunistic: a
        slot that cannot grow to the whole chunk speculates shallower
        (eviction is never triggered for draft tokens, only for the
        committed token the plain preamble guaranteed)."""
        G = self.spec_k + 1
        proposals = {i: np.asarray(self.draft.propose(self.slots[i].tokens,
                                                      self.spec_k),
                                   np.int32).ravel() for i in live}
        caps = {}
        for i in live:
            length = int(self.cache.lengths[i])
            want = min(length + G, self.cache.tokens_per_slot)
            if want > self.cache.capacity_tokens(i):
                try:
                    self.cache.ensure_capacity(i, want)
                except CacheExhausted:
                    pass          # speculate into whatever room exists
            caps[i] = min(self.cache.capacity_tokens(i),
                          self.cache.tokens_per_slot) - length
        tokens = np.zeros((self.num_slots, G), np.int32)
        active = np.zeros((self.num_slots,), bool)
        for i in live:
            tokens[i, 0] = self.slots[i].out[-1]   # the pending token
            tokens[i, 1:] = proposals[i][:self.spec_k]
            active[i] = True
        out = self.engine.verify_slots(
            self.cache.k, self.cache.v, self.cache.tables, self.cache.lengths,
            tokens, active, k_scale=self.cache.k_scale,
            v_scale=self.cache.v_scale)
        logits = out[0]
        self._store_pools(out[1:])
        self.stats["decode_steps"] += 1
        self.stats["spec_steps"] += 1
        # the target's choice at every chunk position: the argmax of the
        # fp32 logits, as the greedy lane of the plain decode step takes
        greedy = torch.argmax(logits.float(), dim=-1).cpu().numpy()
        # sampled slots (and greedy ones that want logprobs) read the
        # whole verify logits on the host for the fp64 math
        logits_host = None
        if any(self.sampler.params[i].sampled or self.slots[i].logprobs
               for i in live):
            logits_host = logits.float().cpu().numpy()
        proposed = accepted = emitted = 0
        for i in live:
            req = self.slots[i]
            params = self.sampler.params[i]
            # caps >= 1: the preamble guaranteed the committed token
            k_live = max(0, min(self.spec_k, caps[i] - 1))
            if (self.spec_accept_floor > 0.0 and k_live > 1
                    and self._spec_obs[i] >= self.spec_adapt_warmup
                    and self._accept_ewma[i] < self.spec_accept_floor):
                self.stats["spec_k_capped"] += 1
                k_live = 1
            prop = proposals[i]
            if params.sampled:
                # position j decides generation index len(out) + j with
                # uniforms keyed by (seed, index)
                rows = sampling.fp64_dist(
                    logits_host[i, :k_live + 1], params.temperature,
                    top_k=params.top_k, top_p=params.top_p)
                toks, lps, acc = sampling.spec_verify_tokens(
                    rows, prop[:k_live], params.seed, len(req.out))
            else:
                acc = 0
                while acc < k_live and greedy[i, acc] == prop[acc]:
                    acc += 1
                toks = [int(t) for t in prop[:acc]] + [int(greedy[i, acc])]
                lps = [None] * len(toks)
                if req.logprobs:
                    lps = [math.log(max(float(sampling.fp64_dist(
                        logits_host[i, j], 1.0)[t]), 1e-300))
                        for j, t in enumerate(toks)]
            if k_live > 0:
                self._accept_ewma[i] = (0.8 * self._accept_ewma[i]
                                        + 0.2 * (acc / k_live))
                self._spec_obs[i] += 1
            proposed += k_live
            accepted += acc
            # commit the pending token and the accepted drafts, then drop
            # the tail blocks only the rejected suffix used
            new_len = int(self.cache.lengths[i]) + acc + 1
            self.cache.advance(i, acc + 1)
            self.cache.rollback(i, new_len)
            self.stats["spec_slot_steps"] += 1
            for tok, lp in zip(toks, lps):
                emitted += 1
                self._emit(i, req, int(tok), lp, now)
                if req.state == "done":
                    break
        self.stats["spec_proposed"] += proposed
        self.stats["spec_accepted"] += accepted
        self.stats["spec_emitted"] += emitted
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

    def _emit(self, slot: int, req: ServeRequest, tok: int,
              lp: Optional[float], now: float) -> None:
        """Record one token the sampler (or the speculative verify) chose:
        output, logprob, latency stamps, then the stop-sequence,
        max_new_tokens and eos checks."""
        self.sampler.observe(slot, tok)
        if req.logprobs and lp is not None:
            req.out_logprobs.append(lp)
        if self.sampler.temps[slot] > 0.0:
            self.stats["sampled_tokens"] += 1
        req.out.append(tok)
        req.token_times.append(now)
        if req.first_token_at is None:
            req.first_token_at = now
        for stop in (req.stop or ()):
            n = len(stop)
            if n and len(req.out) >= n and \
                    req.out[-n:] == [int(t) for t in stop]:
                # the matched stop tokens stay in out
                self.stats["stop_hits"] += 1
                self._finish(slot, req, now)
                return
        if (len(req.out) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)):
            self._finish(slot, req, now)

    def _spill_step(self) -> None:
        """The host tier's daemon tick, right after the decode dispatch:
        the spill it starts overlaps the next step, and the previous
        tick's is harvested here."""
        if self.host_tier:
            self.cache.spill_tick()
            self._sync_host_stats()

    def _sync_host_stats(self) -> None:
        """Mirror the cache's host-tier counters into the stats (the
        cache keeps the counts)."""
        c = self.cache
        self.stats.update(host_blocks=c.host_blocks, host_bytes=c.host_bytes,
                          host_spills=c.host_spills,
                          host_restores=c.host_restores,
                          host_restore_failures=c.host_restore_failures)

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

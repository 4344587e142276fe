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

Telemetry (``telemetry=True`` or ``DS_TELEMETRY=on``, or a shared
``telemetry.Telemetry``): the request tracer records every lifecycle
event at the JAX engine's sites, the registry holds the latency, batch,
speculation, horizon, KV-pool and host-tier histograms and gauges beside
the stats, and the breakdown times sampled steps behind a device barrier.
Cost accounting (on with telemetry, or ``cost_accounting=True`` /
``DS_COST_ACCOUNTING=on`` alone) charges analytic FLOPs, HBM bytes and KV
block-seconds to every dispatch, request and tenant (``srv.costs``,
``srv.cost_registry``). Off, both are no-op twins. ``stats`` is a
read-only view over registry counters and gauges (``_STAT_FIELDS``, the
JAX engine's keys in its order); the keys of features still to port read
0.

Graceful degradation, the JAX engine's chaos contract:

- **shedding**: with ``max_queue``, a submit into a full queue retires the
  newest request as ``shed`` (``stats["backpressure"]`` is the queue's
  fullness in [0, 1]);
- **deadlines**: a request past its ``deadline`` (on the scheduler clock
  of ``submit`` and ``step``) retires as ``timeout``, keeping its tokens,
  whether it holds a slot or waits in the queue;
- **retries**: a ``TransientDeviceError`` around the prefill and decode
  dispatches (``_device_call``) retries up to ``max_retries`` times after
  a pause of ``retry_backoff_s``, doubled each time, plus the injector's
  seeded jitter, at most 0.5 s and never past the tightest deadline of a
  slot holder;
- **the watchdog**: with ``step_time_budget_s``, ``watchdog_grace``
  decode dispatches over budget in a row (a horizon answers to N budgets)
  make ``step`` raise :class:`DegradedError` after its bookkeeping; the
  error carries every finished result, a snapshot of the work in flight
  (``pending_snapshot``, which ``ServeRequest.from_snapshot`` resumes in a
  fresh engine) and the stats, and the engine can keep stepping;
- **degrade branches**: a faulted draft or verify degrades the step to
  plain decode (``stats["spec_fallbacks"]``), a faulted horizon to one
  token (``stats["horizon_fallbacks"]``); the cache serves a faulted
  prefix match as a cold miss, retries a faulted copy-on-write at the next
  admission and re-prefills what a faulted restore or a corrupted host
  block would have restored.

The faults come from ``faults`` (default the ambient injector of
``utils/faults.py``, ``DS_FAULTS``) at ``serving.prefill``,
``serving.decode``, ``serving.spec_draft`` and ``serving.horizon``, from
the cache at its ``cache.*`` sites and from the engine's slot programs at
``engine.*`` and ``cache.quantize``. Each fires before the pools, which
the port writes in place, are touched, so a retry replays the step on
intact pools. With the flight recorder (``flight_recorder=True`` or
``DS_FLIGHT_RECORDER=on``) a DegradedError first writes a CRC-stamped
postmortem artifact into ``flight_dir`` (``telemetry/flight.py``;
``python -m deepspeed_tpu_torch.tools.postmortem`` reads it).

Multi-tenant LoRA (``lora_serve=True`` or ``DS_LORA_SERVE=on``; the pool
knobs ``lora_pool_mb``, ``lora_pool_blocks``, ``lora_max_rank``,
``lora_rank_block``): ``register_adapter`` stages a ``runtime/lora.py``
export, and a request that names it in ``adapter_id`` pins it in the
paged adapter pool (``inference/adapters.py``) at admission, loading it
on a miss. Every slot program then takes the pools and each slot's
adapter-table row; a base-only slot's row is all zeros and gathers the
pool's zero block, so its stream is the LoRA-off one. A load that fails
(unregistered, pool pinned full, an injected fault), or an ``adapter_id``
while ``lora_serve`` is off, retires the request with state ``error``
(``stats["adapter_load_errors"]``); every path that frees a slot drops
its pin. Adapter-carrying requests neither match nor publish prefix-cache
blocks (their K/V holds the adapter's weights), so they never reach the
host tier.

The prefill-only role (``prefill_only=True``, which the replica router
sets on its ``prefill`` replicas, ``inference/router.py``): a finished
prefill emits its first token (TTFT is stamped where the prefill ran)
and parks its request in state ``handoff`` (:meth:`ServingEngine.
ready_handoffs`) instead of decoding it; the router migrates its KV chain
to a decode replica and frees the slot (:meth:`ServingEngine.
release_handoff`). There, admission adopts the landed chain (the cache's
``adopt_parked``) with no re-prefill of the prompt, skips admission
control, and may take a parked request past a blocked head of the queue:
the one break from FIFO, since the blocks the head waits for may be held
by the parked chains behind it. A parked chain that cannot grow to cover
the emitted tokens is freed and the request re-prefills cold.

Every knob above, and ``kv_quant``, left at None is read from the
environment as the JAX engine reads it (``utils/env.py``).
"""

import json
import math
import time
import weakref
from collections import deque
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.inference import sampling
from deepspeed_tpu_torch.inference.adapters import (AdapterLoadError,
                                                    AdapterPool,
                                                    resolve_lora_serve)
from deepspeed_tpu_torch.inference.host_tier import resolve_host_tier
from deepspeed_tpu_torch.inference.paged_cache import (CacheExhausted,
                                                       PagedKVCache,
                                                       resolve_prefix_cache)
from deepspeed_tpu_torch.inference.spec_decode import (make_draft,
                                                       resolve_spec_decode,
                                                       resolve_spec_k)
from deepspeed_tpu_torch.ops.quantizer import resolve_kv_quant
from deepspeed_tpu_torch.telemetry import (NOOP, MetricsRegistry,
                                           NoopTelemetry, RATE_BUCKETS,
                                           TEMP_BUCKETS, Telemetry,
                                           resolve_telemetry)
from deepspeed_tpu_torch.telemetry.costs import (CostAccountant, NOOP_COSTS,
                                                 ProgramCostRegistry,
                                                 new_footprint)
from deepspeed_tpu_torch.telemetry.flight import FlightRecorder, NOOP_FLIGHT
from deepspeed_tpu_torch.utils import faults as faults_lib
from deepspeed_tpu_torch.utils import trace
from deepspeed_tpu_torch.utils.env import (flag_names,
                                           resolve_decode_horizon,
                                           resolve_flag)
from deepspeed_tpu_torch.utils.faults import TransientDeviceError
from deepspeed_tpu_torch.utils.logging import logger

TERMINAL_STATES = ("done", "timeout", "shed", "error")

# stop sequences the horizon checks on the device: a stop longer than
# HORIZON_STOP_WIDTH tokens, or past the first HORIZON_MAX_STOPS, leaves
# its lane running to its budget, and the host's _emit cuts the stream at
# the true hit (only the early freeze is lost)
HORIZON_STOP_WIDTH = 8
HORIZON_MAX_STOPS = 4

# the longest pause between two attempts of a failed dispatch, seconds
MAX_BACKOFF_S = 0.5

# the stats: the JAX engine's keys in its order, each a registry counter
# ("c") or gauge ("g") with the JAX help text, read through _StatsView
_STAT_FIELDS = (
    ("steps", "c", "scheduler iterations"),
    ("occupancy_sum", "c", "sum of per-step decode occupancy"),
    ("peak_occupancy", "g", "max decode occupancy seen"),
    ("evictions", "c", "preemptions (recompute-on-resume requeues)"),
    ("admitted", "c", "requests admitted to a slot"),
    ("completed", "c", "requests finished with state=done"),
    ("prefill_chunks", "c", "prefill chunk dispatches"),
    ("decode_steps", "c", "batched decode dispatches"),
    ("timeouts", "c", "requests retired at their deadline"),
    ("shed", "c", "requests rejected by the bounded queue"),
    ("retries", "c", "transient-device-error retries"),
    ("evict_capped", "c", "evictions refused by the storm guard"),
    ("watchdog_trips", "c", "over-budget decode dispatches"),
    ("backpressure", "g", "queue fullness in [0, 1]"),
    ("prefix_hits", "c", "admissions that matched a cached prefix"),
    ("prefix_tokens_saved", "c", "prompt tokens served from shared blocks"),
    ("spec_steps", "c", "speculative verify dispatches"),
    ("spec_slot_steps", "c", "per-slot verify participations"),
    ("spec_proposed", "c", "draft tokens offered for verification"),
    ("spec_accepted", "c", "draft tokens accepted by the target"),
    ("spec_emitted", "c", "tokens emitted by speculative steps"),
    ("spec_fallbacks", "c", "spec steps degraded to plain decode"),
    ("horizon_fallbacks", "c", "horizon dispatches degraded to "
                               "single-step decode"),
    ("sampled_tokens", "c", "tokens emitted by sampled (temperature>0) lanes"),
    ("stop_hits", "c", "requests finished by a stop sequence"),
    ("spec_k_capped", "c", "verify participations depth-capped by low "
                           "acceptance"),
    ("adapter_hits", "c", "adapter acquisitions served pool-resident"),
    ("adapter_loads", "c", "adapter loads into the device pool"),
    ("adapter_evictions", "c", "refcount-zero adapters evicted (LRU)"),
    ("adapter_load_errors", "c", "requests retired state=error by a "
                                 "failed adapter load"),
    ("host_blocks", "g", "KV blocks resident on the host-DRAM tier"),
    ("host_bytes", "g", "host-DRAM bytes held by spilled KV blocks"),
    ("host_spills", "g", "blocks spilled device->host (total)"),
    ("host_restores", "g", "blocks restored host->device (total)"),
    ("host_restore_failures", "g", "restores degraded to re-prefill "
                                   "(faults, corruption, dry free list)"),
)


class _StatsView(Mapping):
    """Read-only mapping over the registry-backed stats: the scheduler
    writes through the registry (``srv.metrics``), never through the view,
    so no caller can skew its bookkeeping."""

    def __init__(self, metrics: Dict[str, Any]):
        self._metrics = metrics

    def __getitem__(self, key):
        return self._metrics[key].value

    def __iter__(self):
        return iter(self._metrics)

    def __len__(self):
        return len(self._metrics)

    def __repr__(self):
        return repr(dict(self))


# ServeRequest fields a snapshot entry does not carry: each is derived on
# resubmission or means nothing in a fresh engine
SNAPSHOT_EPHEMERAL = frozenset({
    "n",                # expanded at submit: a resumed piece has n = 1
    "state",            # in the entry for postmortems; a resumed request
                        # re-enters as "queued"
    "token_times",      # stamps of the old engine's clock
    "submitted_at",     # re-stamped at resubmission
    "first_token_at",   # ditto
    "finished_at",      # pending requests never finished
    "_admit_seq",       # the old engine's admission order
    "_work",            # rebuilt from prompt + out at the re-prefill
})


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
    :func:`sampling.candidate_seed`. ``priority`` is an advisory class
    tag (``"interactive"``, ``"batch"``) the engine ignores, as the JAX
    engine does. ``deadline`` is an instant on the scheduler clock of
    ``submit`` and ``step``: from then on the request retires as
    ``timeout``, keeping what it generated. ``adapter_id`` names the
    registered LoRA adapter that serves the request (None: the base model;
    it needs ``lora_serve`` on the engine, else the request retires with
    state ``error``). ``cost`` is the request's cost footprint
    (``telemetry/costs.py``), filled while cost accounting is on."""
    rid: Any
    prompt: np.ndarray
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    deadline: Optional[float] = None
    priority: Optional[str] = None
    adapter_id: Optional[str] = None
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
    state: str = "queued"      # queued | prefill | decode | handoff |
    #                            done | timeout | shed | error (handoff: a
    #                            finished prefill parked on a prefill-only
    #                            engine for the router's migration)
    token_times: List[float] = field(default_factory=list)
    submitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    evictions: int = 0
    cost: Dict = field(default_factory=new_footprint)
    _admit_seq: int = -1                 # eviction picks the youngest
    _work: Optional[np.ndarray] = None   # prompt (+generated, on resume)

    @property
    def tokens(self) -> np.ndarray:
        """prompt + generated, the generate()-shaped result row."""
        return np.concatenate([np.asarray(self.prompt, np.int32),
                               np.asarray(self.out, np.int32)])

    @classmethod
    def from_snapshot(cls, entry: Dict) -> "ServeRequest":
        """Rebuild a request from a :meth:`ServingEngine.pending_snapshot`
        entry. Submitted to a fresh engine it re-prefills prompt + the
        tokens already emitted and decodes on from there: a greedy stream
        is the undisturbed one, and a sampled one resumes its draws (they
        are keyed by the seed and the tokens emitted). ``n`` is 1: the
        candidates were expanded at the original submit."""
        return cls(
            rid=entry["rid"],
            prompt=np.asarray(entry["prompt"], np.int32),
            max_new_tokens=int(entry["max_new_tokens"]),
            eos_id=entry.get("eos_id"),
            deadline=entry.get("deadline"),
            priority=entry.get("priority"),
            adapter_id=entry.get("adapter_id"),
            temperature=entry.get("temperature"),
            top_k=entry.get("top_k"),
            top_p=entry.get("top_p"),
            seed=entry.get("seed"),
            repetition_penalty=entry.get("repetition_penalty"),
            stop=[list(s) for s in entry["stop"]]
            if entry.get("stop") else None,
            logprobs=bool(entry.get("logprobs", False)),
            n=1,
            out=[int(t) for t in entry.get("out", ())],
            out_logprobs=[float(x) for x in entry.get("out_logprobs", ())],
            evictions=int(entry.get("evictions", 0)),
            cost=(dict(entry["cost"]) if entry.get("cost")
                  else new_footprint()))


class DegradedError(RuntimeError):
    """The engine cannot keep its contract (a step over budget too often,
    a run that did not drain), but what it finished is intact:
    ``results`` maps rid -> prompt + generated for every retired request,
    ``finished`` holds those requests, ``pending`` is a snapshot of the
    work in flight (:func:`snapshot_entry` rows), ``stats`` the counters
    when it was raised. The scheduler stays consistent: a caller may
    resubmit ``pending`` or keep stepping."""

    def __init__(self, message: str, results: Optional[Dict] = None,
                 finished: Optional[List[ServeRequest]] = None,
                 pending: Optional[List[Dict]] = None,
                 stats: Optional[Dict] = None):
        super().__init__(message)
        self.results = results or {}
        self.finished = finished or []
        self.pending = pending or []
        self.stats = stats or {}


def snapshot_entry(req: ServeRequest, **extra) -> Dict:
    """One snapshot row for ``req``: everything
    :meth:`ServeRequest.from_snapshot` needs (the sampling knobs and the
    tokens emitted are the state of its draws), the cost footprint, and
    the tags the caller adds (``slot``, ``queue_pos``, or the router's
    ``kv_handle`` of a migrated chain, which ``from_snapshot`` ignores).
    The lists are copies: the live request moving on cannot change a
    raised DegradedError."""
    entry = {"rid": req.rid, "state": req.state,
             "generated": len(req.out),
             "evictions": req.evictions,
             "prompt": [int(t) for t in req.prompt],
             "out": [int(t) for t in req.out],
             "max_new_tokens": req.max_new_tokens,
             "eos_id": req.eos_id,
             "deadline": req.deadline,
             "priority": req.priority,
             "adapter_id": req.adapter_id,
             "temperature": req.temperature,
             "top_k": req.top_k,
             "top_p": req.top_p,
             "seed": req.seed,
             "repetition_penalty": req.repetition_penalty,
             "stop": [[int(t) for t in s] for s in req.stop]
             if req.stop else None,
             "logprobs": req.logprobs,
             "out_logprobs": [float(x) for x in req.out_logprobs],
             "cost": json.loads(json.dumps(req.cost))}
    entry.update(extra)
    return entry


def _fault_recorder(srv: "ServingEngine"):
    """A fault listener that records into ``srv``'s tracer while ``srv``
    lives. The injector is often the process's ambient one, which
    outlives every engine: holding ``srv`` weakly there keeps a dropped
    engine (and its pools) from living on as a listener."""
    ref = weakref.ref(srv)

    def listener(site: str, kind: str, visit: int) -> None:
        live = ref()
        if live is not None:
            live._on_fault(site, kind, visit)
    return listener


def _tp_features(**on) -> None:
    """Raise for a serving feature a tensor-parallel engine does not run
    yet (each waits for its ROADMAP item)."""
    from deepspeed_tpu_torch.parallel.tensor import TP_SERVING_FEATURES
    named = [k for k, v in on.items() if v]
    if named:
        raise NotImplementedError(
            f"ServingEngine over an engine with mp_size > 1: {named[0]} "
            f"waits for {TP_SERVING_FEATURES}")


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
    the host-DRAM KV tier, inert without the prefix cache. ``telemetry``:
    True, False, None or a ``telemetry.Telemetry`` to use as it is;
    ``cost_accounting``: the cost plane without the rest of telemetry.
    ``max_queue`` (None: unbounded), ``step_time_budget_s`` (None: no
    watchdog), ``watchdog_grace``, ``max_retries`` and
    ``retry_backoff_s``: the degradation knobs of the module docstring;
    ``faults``: a ``utils/faults.FaultInjector`` (None: the ambient one);
    ``flight_recorder`` and ``flight_dir``: postmortem artifacts on a
    DegradedError (the directory defaults to ``ds_flight`` under the
    temporary directory). ``lora_serve``, ``lora_pool_mb``,
    ``lora_pool_blocks``, ``lora_max_rank`` and ``lora_rank_block``:
    multi-tenant LoRA and its adapter pool (``inference/adapters.py``).
    ``prefill_only``: park finished prefills in ``handoff`` for the
    router's migration (the module docstring).
    Each of ``kv_quant``, ``prefix_cache``, ``spec_decode``, ``spec_k``,
    ``spec_draft``, ``decode_horizon``, ``host_tier``,
    ``host_budget_bytes``, ``telemetry``, ``cost_accounting``,
    ``flight_recorder``, ``flight_dir``, ``lora_serve`` and the pool knobs
    left at None is read from its ``DS_*`` environment flag, else off
    (``spec_k`` 4, ``spec_draft`` ngram, ``decode_horizon`` 1, a 16 MiB
    pool of rank blocks of 8 up to rank 16). ``decode_impl`` must stay
    None: the port picks the decode attention by device, not by a
    switch."""

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
                 spill_watermark: Optional[int] = None, telemetry=None,
                 cost_accounting: Optional[bool] = None,
                 max_queue: Optional[int] = None,
                 step_time_budget_s: Optional[float] = None,
                 watchdog_grace: int = 2, max_retries: int = 3,
                 retry_backoff_s: float = 0.02,
                 faults: Optional[faults_lib.FaultInjector] = None,
                 flight_recorder: Optional[bool] = None,
                 flight_dir: Optional[str] = None,
                 lora_serve: Optional[bool] = None,
                 lora_pool_mb: Optional[float] = None,
                 lora_pool_blocks: Optional[int] = None,
                 lora_max_rank: Optional[int] = None,
                 lora_rank_block: Optional[int] = None,
                 prefill_only: bool = False):
        if decode_impl is not None:
            raise ValueError(
                f"ServingEngine(decode_impl={decode_impl!r}): the port "
                f"dispatches by device (the K3 kernel on the card, its "
                f"plain version on the host) and has no implementation "
                f"switch; leave decode_impl at None")
        self.engine = engine
        self.last_trace: Optional[str] = None   # capture_profile's file
        if isinstance(telemetry, (Telemetry, NoopTelemetry)):
            self.telemetry = telemetry
        elif resolve_telemetry(telemetry):
            self.telemetry = Telemetry()
        else:
            self.telemetry = NOOP
        self.faults = faults if faults is not None else faults_lib.active()
        self.kv_quant = resolve_kv_quant(kv_quant)
        self.prefix_cache = resolve_prefix_cache(prefix_cache)
        # resolved once: a run serves with the adapter pool or without it
        self.lora_serve = resolve_lora_serve(lora_serve)
        mp = getattr(engine, "mp_size", 1)
        if mp > 1:
            _tp_features(lora_serve=self.lora_serve,
                         host_tier=resolve_host_tier(host_tier),
                         decode_horizon=resolve_decode_horizon(
                             decode_horizon) > 1,
                         faults=bool(self.faults.faults),
                         prefill_only=prefill_only)
        self.cache = PagedKVCache(
            engine.cfg, num_slots=num_slots, block_size=block_size,
            num_blocks=num_blocks, hbm_budget_bytes=hbm_budget_bytes,
            dtype=engine.dtype, max_seq_len=engine.max_seq_len,
            device=engine.device, kv_quant=self.kv_quant,
            prefix_cache=self.prefix_cache,
            host_tier=resolve_host_tier(host_tier),
            host_budget_bytes=host_budget_bytes,
            spill_watermark=spill_watermark,
            tracer=self.telemetry.tracer if self.telemetry.enabled
            else None, faults=self.faults, model_parallel=mp)
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
        # the prefill-only role: a plain flag the router sets per replica;
        # the slot programs are the same either way
        self.prefill_only = bool(prefill_only)
        self.num_slots = num_slots
        self.prefill_chunk = int(prefill_chunk)
        self.temperature = temperature
        self.top_k = top_k
        self.seed = int(seed)
        self.max_evictions = int(max_evictions)
        self.max_queue = max_queue
        self.step_time_budget_s = step_time_budget_s
        self.watchdog_grace = max(1, int(watchdog_grace))
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self._over_budget = 0            # over-budget dispatches in a row
        self._watchdog_msg: Optional[str] = None
        # host seconds inside the device dispatches and their harvests,
        # each dispatch waited for: the host/device split of a token
        self.device_time_s = 0.0
        self.sampler = sampling.SlotSamplerState(num_slots,
                                                 engine.cfg.vocab_size)
        self.queue: deque = deque()
        self.slots: List[Optional[ServeRequest]] = [None] * num_slots
        self.finished: List[ServeRequest] = []
        self._progress = np.zeros((num_slots,), np.int64)  # prefilled toks
        self._admit_counter = 0
        self._step_clock = 0
        # the stats live in a registry: the telemetry's when it is on, a
        # private one otherwise
        self.metrics = (self.telemetry.registry if self.telemetry.enabled
                        else MetricsRegistry())
        self._stat = {
            key: (self.metrics.counter if kind == "c"
                  else self.metrics.gauge)(f"serving_{key}", help_)
            for key, kind, help_ in _STAT_FIELDS}
        self.stats = _StatsView(self._stat)
        self._h_ttft = self._h_tpot = self._h_qwait = self._h_occ = None
        self._h_accept = self._h_tps = self._h_temp = None
        self._h_horizon = self._h_kv_err = None
        self._g_host_bytes = self._h_host_restore = None
        self._g_lora_active = self._g_lora_pool = None
        if self.telemetry.enabled:
            self._register_telemetry()
            self.faults.add_listener(_fault_recorder(self))
        # the paged adapter pool and each slot's adapter-table row (all
        # zeros: a base-only slot, which gathers the pool's zero block)
        self.adapters = None
        self._slot_arows = None
        if self.lora_serve:
            self.adapters = AdapterPool(
                engine, pool_mb=lora_pool_mb, pool_blocks=lora_pool_blocks,
                max_rank=lora_max_rank, rank_block=lora_rank_block,
                faults=self.faults,
                tracer=(self.telemetry.tracer if self.telemetry.enabled
                        else None),
                hooks={"on_hit": self._stat["adapter_hits"].inc,
                       "on_load": self._on_adapter_load,
                       "on_evict": self._on_adapter_evict})
            self._slot_arows = np.zeros(
                (num_slots, self.adapters.blocks_per_adapter), np.int32)
            if self._g_lora_pool is not None:
                self._g_lora_pool.set(self.adapters.pool_bytes)
        # cost accounting: on with telemetry, or alone
        if self.telemetry.enabled \
                or resolve_flag("DS_COST_ACCOUNTING", cost_accounting):
            kv_tok = int(self.cache.bytes_per_token)
            self.costs = CostAccountant(
                engine.cfg, kv_tok,
                kv_tok * self.cache.block_size
                + int(self.cache.scale_bytes_per_block),
                int(engine.dtype.itemsize), registry=self.metrics)
            self.cost_registry = ProgramCostRegistry()
            self.cost_registry.populate(engine, cache=self.cache)
            if self.telemetry.enabled:
                self.cost_registry.export_gauges(self.metrics)
        else:
            self.costs = NOOP_COSTS
            self.cost_registry = None
        # the flight recorder: armed, it costs nothing until a
        # DegradedError, which writes one artifact first
        if resolve_flag("DS_FLIGHT_RECORDER", flight_recorder):
            self.flight = FlightRecorder(
                outdir=flight_dir or (resolve_flag("DS_FLIGHT_DIR") or None),
                sections=self._flight_sections(), label="serving",
                device=engine.device)
        else:
            self.flight = NOOP_FLIGHT

    def _on_fault(self, site: str, kind: str, visit: int) -> None:
        """A fired fault as a tracer record at the scheduler step, so a
        chaos run replays as one timeline."""
        self.telemetry.tracer.event("fault", step=self._step_clock,
                                    site=site, kind=kind, visit=visit)

    def _flight_sections(self) -> Dict:
        """The postmortem's section providers, called at dump time only
        (the router's fleet recorder adds the autoscaler's decisions)."""
        return {
            "tracer": lambda: [list(r)
                               for r in self.telemetry.tracer.records()],
            "metrics": lambda: self.metrics.snapshot(),
            "windows": lambda: {n: h.window_summary()
                                for n, h in
                                self.metrics._histograms.items()},
            "stats": lambda: dict(self.stats),
            "faults": lambda: [list(f) for f in self.faults.fired],
            "flags": lambda: {n: resolve_flag(n) for n in flag_names()},
            "programs": lambda: (self.cost_registry.to_json()
                                 if self.cost_registry else {}),
            "costs": lambda: self.costs.snapshot(),
            "requests": self._flight_requests,
        }

    def _flight_requests(self) -> List[Dict]:
        """A postmortem row per request, finished, in a slot or queued:
        its state, tokens generated, evictions and cost footprint."""
        def row(req, **where):
            return dict({"rid": req.rid, "state": req.state}, **where,
                        generated=len(req.out), adapter_id=req.adapter_id,
                        evictions=req.evictions, cost=req.cost)
        return ([row(r) for r in self.finished]
                + [row(r, slot=i) for i, r in enumerate(self.slots)
                   if r is not None]
                + [row(r, queue_pos=i) for i, r in enumerate(self.queue)])

    def _register_telemetry(self) -> None:
        """The histograms and gauges of the telemetry plane, with the JAX
        engine's names, help texts, buckets and registration order."""
        reg = self.metrics
        self._h_ttft = reg.histogram(
            "serving_ttft", "time to first token (scheduler clock "
            "units: seconds under wall_clock, steps otherwise)")
        self._h_tpot = reg.histogram(
            "serving_tpot",
            "per-output-token latency (scheduler clock units)")
        self._h_qwait = reg.histogram(
            "serving_queue_wait",
            "enqueue-to-admit wait (scheduler clock units)")
        self._h_occ = reg.histogram(
            "serving_batch_occupancy", "decoding slots per step",
            buckets=tuple(float(i) for i in range(self.num_slots + 1)))
        self._g_held = reg.gauge(
            "serving_hbm_blocks_held", "pool blocks with refcount > 0")
        self._g_cached = reg.gauge(
            "serving_hbm_blocks_cached",
            "refcount-0 blocks kept by the prefix index")
        self._g_free = reg.gauge(
            "serving_hbm_blocks_free", "free-list blocks")
        self._g_hit_rate = reg.gauge(
            "serving_prefix_hit_rate", "prefix hits / admissions")
        self._h_accept = reg.histogram(
            "serving_spec_accept_rate",
            "per-verify-step draft acceptance rate", buckets=RATE_BUCKETS)
        self._h_tps = reg.histogram(
            "serving_spec_tokens_per_step",
            "tokens emitted per live slot per verify step",
            buckets=tuple(float(i) for i in range(1, self.spec_k + 2)))
        if self.decode_horizon > 1:
            self._h_horizon = reg.histogram(
                "serving_horizon_tokens",
                "tokens emitted per slot per fused multi-step decode "
                "dispatch",
                buckets=tuple(float(i)
                              for i in range(1, self.decode_horizon + 2)))
        reg.gauge("decode_horizon",
                  "fused decode iterations per dispatch (static per run; "
                  "1 = single-step bit-reference)").set(
            float(self.decode_horizon))
        self._h_temp = reg.histogram(
            "serving_request_temperature",
            "resolved per-request sampling temperature at admission "
            "(0 = greedy)", buckets=TEMP_BUCKETS)
        c = self.cache
        reg.gauge("kv_cache_bytes_per_token",
                  "KV pool bytes per cached token (all layers, K+V, "
                  "including per-block scale overhead when quantized)").set(
            c.bytes_per_token + c.scale_bytes_per_block / c.block_size)
        reg.gauge("kv_pool_dtype", "KV pool element width in bits "
                  "(8 = int8 quantized, 16 = bf16, 32 = f32)").set(
            c.pool_dtype.itemsize * 8)
        if c.quantized:
            self._h_kv_err = reg.histogram(
                "serving_kv_quant_error",
                "sampled upper bound on the max-abs KV dequantization "
                "error (half the hottest block's quantization step)",
                buckets=(1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
                         1e-2, 2.5e-2, 5e-2, 1e-1, 2.5e-1))
        if self.host_tier:
            self._g_host_bytes = reg.gauge(
                "kv_host_tier_bytes",
                "host-DRAM bytes held by spilled KV blocks")
            self._h_host_restore = reg.histogram(
                "kv_host_restore_ms",
                "per-block host->device restore wall time (CRC verify "
                "+ H2D copy + scatter dispatch, ms)",
                buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                         25.0, 50.0, 100.0))
        if self.lora_serve:
            self._g_lora_active = reg.gauge(
                "lora_active_adapters",
                "LoRA adapters resident in the device pool")
            self._g_lora_pool = reg.gauge(
                "lora_pool_bytes",
                "device bytes reserved by the paged adapter pool")

    def _on_adapter_load(self) -> None:
        self._stat["adapter_loads"].inc()
        if self._g_lora_active is not None:
            self._g_lora_active.set(self.adapters.active_adapters)

    def _on_adapter_evict(self) -> None:
        self._stat["adapter_evictions"].inc()
        if self._g_lora_active is not None:
            self._g_lora_active.set(self.adapters.active_adapters)

    def register_adapter(self, adapter_id: str, source) -> None:
        """Stage a ``runtime/lora.py`` adapter export (an ``.npz`` path or
        an ``adapter_state_dict`` mapping) for serving under
        ``adapter_id``; it loads into the device pool at the first
        admission that names it. Needs ``lora_serve``."""
        if self.adapters is None:
            raise ValueError("register_adapter requires lora_serve=True "
                             "(DS_LORA_SERVE=on)")
        self.adapters.register(adapter_id, source)

    def _lora_args(self, slot: Optional[int] = None):
        """The engine's ``lora=`` operand for the whole batch (or one
        prefill slot); None with ``lora_serve`` off, which runs the
        base-only slot programs."""
        if self.adapters is None:
            return None
        rows = self._slot_arows if slot is None else self._slot_arows[slot]
        return self.adapters.lora_args(rows)

    def submit(self, req: ServeRequest, now: float = 0.0) -> bool:
        """Enqueue ``req`` (and, with ``n > 1``, its candidates). Returns
        False when the bounded queue was full and the request was shed
        (``state="shed"``, in ``finished``: every request gets exactly one
        terminal state). Malformed requests raise ValueError."""
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
                    deadline=req.deadline, adapter_id=req.adapter_id,
                    temperature=req.temperature,
                    top_k=req.top_k,
                    top_p=req.top_p,
                    seed=sampling.candidate_seed(params.seed, i),
                    repetition_penalty=req.repetition_penalty,
                    stop=req.stop, logprobs=req.logprobs, n=1)
                ok = self.submit(clone, now=now) and ok
            return ok
        req.submitted_at = now
        req._work = np.asarray(req.tokens if req.out else req.prompt,
                               np.int32)
        self.telemetry.tracer.event("enqueue", rid=req.rid,
                                    step=self._step_clock,
                                    queue_len=len(self.queue))
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            # reject the newest: accepted work keeps its latency, the
            # newcomer gets its answer at once
            req.state = "shed"
            req.finished_at = now
            self.finished.append(req)
            self._stat["shed"].inc()
            self.telemetry.tracer.event("finish", rid=req.rid,
                                        step=self._step_clock,
                                        state="shed", generated=0)
            self._update_backpressure()
            logger.warning(f"serving: shed request {req.rid} "
                           f"(queue full at {self.max_queue})")
            return False
        self.queue.append(req)
        self._update_backpressure()
        return True

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def step(self, now: Optional[float] = None) -> int:
        """One scheduler iteration: expire, admit, prefill chunks, decode
        (one token, a horizon or a verify), then the host tier's spill
        tick. Returns the number of decoding slots this iteration. Raises
        :class:`DegradedError` when the watchdog ran out of grace, after
        the step's bookkeeping (every token of the step is recorded)."""
        if now is None:
            now = float(self._step_clock)
            self._token_tick = 1.0
        else:
            self._token_tick = float(self.token_time_unit)
        self._horizon_ticks = 1
        bd = self.telemetry.breakdown
        sampled = bd.begin(self._step_clock, sync=self._sync_devices)
        self._expire(now)
        self._admit(now)
        bd.lap("admission")
        self._prefill_step(now)
        bd.lap("prefill")
        occ = self._decode_step(now)
        self._spill_step()
        bd.lap("decode")
        self._step_clock += self._horizon_ticks
        self.last_step_span = float(self._horizon_ticks)
        if self.costs.enabled:
            # KV residency at the horizon's boundary: every slot holder
            # pays its blocks times the ticks this step took
            for i, r in enumerate(self.slots):
                if r is not None:
                    self.costs.charge_block_seconds(
                        r, self.cache.blocks_for(int(self.cache.lengths[i])),
                        self._horizon_ticks)
        self._stat["steps"].inc()
        self._stat["occupancy_sum"].inc(occ)
        peak = self._stat["peak_occupancy"]
        peak.set(max(peak.value, occ))
        self._update_backpressure()
        if self._h_occ is not None:
            self._h_occ.observe(occ)
            if sampled:
                self._sample_gauges()
        bd.finish(occupancy=occ)
        if self._watchdog_msg is not None:
            msg, self._watchdog_msg = self._watchdog_msg, None
            self._over_budget = 0
            self.telemetry.tracer.event("degraded", step=self._step_clock,
                                        message=msg)
            raise self._degraded(msg)
        return occ

    def run(self, requests=None, max_steps: int = 1_000_000,
            wall_clock: bool = False) -> Dict[Any, np.ndarray]:
        """Submit ``requests`` (if given) and step until idle. Returns
        {rid: prompt+generated} for every retired request (its terminal
        state is on the request). Submissions are stamped with the clock
        the steps use. A run that does not drain in ``max_steps`` raises
        :class:`DegradedError` with everything finished so far."""
        for r in (requests or []):
            self.submit(r, now=time.perf_counter() if wall_clock else 0.0)
        steps = 0
        while self.busy:
            self.step(time.perf_counter() if wall_clock else None)
            steps += 1
            if steps > max_steps:
                raise self._degraded(
                    f"serving did not drain in {max_steps} steps "
                    f"(queue {len(self.queue)})")
        return {r.rid: r.tokens for r in self.finished}

    def pending_snapshot(self, release: bool = False) -> List[Dict]:
        """The work in flight, one :func:`snapshot_entry` per slot holder
        (tagged ``slot``) and queued request (``queue_pos``), enough for
        :meth:`ServeRequest.from_snapshot` to resume it in a fresh engine.
        By default the engine keeps its slots and queue. ``release=True``
        declares it dead: the pending spill settles first, then every
        slot's blocks go back to the pool and the queue empties, so the
        snapshot is the work's only owner."""
        snap = [snapshot_entry(r, slot=i) for i, r in enumerate(self.slots)
                if r is not None]
        snap += [snapshot_entry(r, queue_pos=i)
                 for i, r in enumerate(self.queue)]
        if release:
            # the spills and the landed migrations settle before any slot
            # is released: a parked request re-prefills cold on a survivor
            self.cache.abort_transfers()
            self.cache.abort_parked()
            for slot, r in enumerate(self.slots):
                if r is not None:
                    self._release_slot(slot)
            self.queue.clear()
            self._update_backpressure()
        return snap

    # -- the disaggregated handoff ----------------------------------------
    def ready_handoffs(self) -> List:
        """Finished prefills parked for migration: ``(slot, request)`` for
        every slot in state ``handoff`` (only a ``prefill_only`` engine
        parks). The router harvests these every step."""
        return [(slot, r) for slot, r in enumerate(self.slots)
                if r is not None and r.state == "handoff"]

    def release_handoff(self, rid) -> bool:
        """Free ``rid``'s handoff slot once the router owns the request
        (its KV migrated, or it fell back to a cold resume): blocks back
        to the pool, slot reopened, the request not retired (its terminal
        state lands on the destination). False when ``rid`` holds no
        handoff slot."""
        for slot, r in enumerate(self.slots):
            if r is not None and r.rid == rid and r.state == "handoff":
                self._release_slot(slot)
                return True
        return False

    # -- phases ----------------------------------------------------------
    def _expire(self, now: float) -> None:
        """Retire every request whose deadline has come: a slot holder
        frees its blocks at once, a queued request never takes a slot."""
        for slot, req in enumerate(self.slots):
            if req is not None and req.deadline is not None \
                    and now >= req.deadline:
                logger.warning(
                    f"serving: request {req.rid} passed its deadline "
                    f"({req.deadline}) with {len(req.out)} of "
                    f"{req.max_new_tokens} tokens; timing out")
                self._finish(slot, req, now, state="timeout")
        keep = deque()
        for req in self.queue:
            if req.deadline is not None and now >= req.deadline:
                req.state = "timeout"
                req.finished_at = now
                # a migrated-in request returns its landed chain
                self.cache.drop_parked(req.rid)
                self.finished.append(req)
                self._stat["timeouts"].inc()
                self.telemetry.tracer.event(
                    "finish", rid=req.rid, step=self._step_clock,
                    state="timeout", generated=len(req.out))
            else:
                keep.append(req)
        self.queue = keep

    def _unqueue(self, req: ServeRequest) -> None:
        """Remove ``req`` from the queue by identity (a parked request
        admitted out of line is not the head)."""
        for i, r in enumerate(self.queue):
            if r is req:
                del self.queue[i]
                return

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
            # cache can share blocks). An adapter-carrying request matches
            # no cached prefix: those blocks hold the base model's (or
            # another adapter's) K/V
            tok_key = None if req.adapter_id is not None else req._work
            # a migrated-in request's chain is already landed: adopting it
            # takes no fresh blocks, so admission control is skipped
            parked = self.cache.has_parked(req.rid)
            if not parked and not self.cache.can_admit(
                    len(req._work), tokens=tok_key,
                    watermark=None if occupied else 0):
                # the blocks a cold head waits for may be held by parked
                # chains queued behind it, which free only by being
                # served: a parked request may jump a blocked head
                req = next((r for r in list(self.queue)[1:]
                            if self.cache.has_parked(r.rid)), None)
                if req is None:
                    break
                parked = True
                tok_key = None if req.adapter_id is not None else req._work
            cow0 = self.cache.cow_copies
            res0 = self.cache.host_restores
            try:
                if parked:
                    # prefill covers only the emitted tail
                    matched = self.cache.adopt_parked(slot, req.rid)
                    try:
                        # the chain covers the prompt; grow it over the
                        # tail before the tail's prefill writes there
                        self.cache.ensure_capacity(slot, len(req._work))
                    except CacheExhausted:
                        # degrade to a cold re-prefill at a later
                        # admission
                        self.cache.free(slot)
                        break
                else:
                    matched = self.cache.allocate(slot, len(req._work),
                                                  tokens=tok_key)
            except CacheExhausted:
                break
            if self.costs.enabled:
                # the COW copies and host-tier restores of the allocation
                # are this request's bytes
                self.costs.charge_cow(req, self.cache.cow_copies - cow0)
                self.costs.charge_spill(self.cache.host_restores - res0,
                                        req=req)
            arow = None
            if req.adapter_id is not None:
                try:
                    if self.adapters is None:
                        raise AdapterLoadError(
                            f"request {req.rid} names adapter "
                            f"{req.adapter_id!r} but lora_serve is off")
                    arow = self.adapters.acquire(req.adapter_id)
                except (AdapterLoadError, TransientDeviceError) as e:
                    # the request retires: a slot never decodes with the
                    # base (or a stale) adapter in place of its own
                    self.cache.free(slot)
                    self._unqueue(req)
                    req.state = "error"
                    req.finished_at = now
                    self.finished.append(req)
                    self._stat["adapter_load_errors"].inc()
                    logger.warning(
                        f"serving: adapter {req.adapter_id!r} failed to "
                        f"load for request {req.rid} ({e}); retiring "
                        f"state=error")
                    self.telemetry.tracer.event(
                        "finish", rid=req.rid, step=self._step_clock,
                        state="error", generated=len(req.out))
                    continue
            self._unqueue(req)
            self.slots[slot] = req
            if arow is not None:
                self._slot_arows[slot] = arow
            # prefill resumes at the matched boundary: the shared blocks'
            # K/V is resident
            self._progress[slot] = matched
            if matched > 0 and not parked:
                self._stat["prefix_hits"].inc()
                self._stat["prefix_tokens_saved"].inc(matched)
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
            if self._h_temp is not None:
                self._h_temp.observe(params.temperature)
            self._stat["admitted"].inc()
            if self._h_qwait is not None and req.submitted_at is not None:
                self._h_qwait.observe(max(0.0, now - req.submitted_at),
                                      at=now)
            self.telemetry.tracer.event(
                "admit", rid=req.rid, step=self._step_clock, slot=slot,
                matched=int(matched), evictions=req.evictions)

    def _prefill_step(self, now: float) -> None:
        for slot, req in enumerate(self.slots):
            if req is None or req.state != "prefill":
                continue
            done = int(self._progress[slot])
            n = min(self.prefill_chunk, len(req._work) - done)
            chunk = np.zeros((self.prefill_chunk,), np.int32)
            chunk[:n] = req._work[done:done + n]
            lane = self.sampler.lane(slot, len(req.out))
            out = self._device_call(
                "serving.prefill", self.engine.prefill_into_slot,
                self.cache.k, self.cache.v, self.cache.tables[slot], chunk,
                done, n, k_scale=self.cache.k_scale,
                v_scale=self.cache.v_scale, sample_state=lane,
                lora=self._lora_args(slot), now=now)
            tok, lp = out[1], out[2]
            self._store_pools(out[3:])
            self.cache.advance(slot, n)
            self._progress[slot] = done + n
            self._stat["prefill_chunks"].inc()
            # n new tokens over `done` cached ones, all this request's
            self.costs.charge_prefill(req, n, done)
            self.telemetry.tracer.event(
                "prefill_chunk", rid=req.rid, step=self._step_clock,
                slot=slot, start=done, n=n)
            if self._progress[slot] == len(req._work):
                # prompt resident: publish its full blocks for the next
                # request sharing the prefix (before _emit, which may free
                # the slot), unless an adapter computed them
                if req.adapter_id is None:
                    self.cache.register_prefix(slot, req._work)
                self.telemetry.tracer.event(
                    "prefill_done", rid=req.rid, step=self._step_clock,
                    slot=slot)
                # final chunk: its last position yields the next token (on
                # resume, exactly the pre-eviction one)
                self._emit(slot, req, int(tok[0]), float(lp[0]), now)
                if req.state not in TERMINAL_STATES:
                    # the prefill-only role parks it for the migration
                    req.state = "handoff" if self.prefill_only \
                        else "decode"

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
            cow0 = self.cache.cow_copies
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
                        self._stat["evict_capped"].inc()
                        self._finish(slot, req, now)
                    break
            if self.costs.enabled:
                # a divergence copy mid-decode is this request's bytes
                self.costs.charge_cow(req, self.cache.cow_copies - cow0)
        live = [i for i, r in enumerate(self.slots)
                if r is not None and r.state == "decode"]
        if not live:
            return 0
        # a draft, verify or horizon fault returns None before any slot
        # moved: the step degrades to the one-token decode below
        if self.spec_decode:
            occ = self._spec_decode_step(live, now)
            if occ is not None:
                return occ
        elif self.decode_horizon > 1:
            occ = self._horizon_decode_step(live, now)
            if occ is not None:
                return occ
        tokens = np.zeros((self.num_slots,), np.int32)
        active = np.zeros((self.num_slots,), bool)
        gen_counts = np.zeros((self.num_slots,), np.int64)
        for i in live:
            tokens[i] = self.slots[i].out[-1]
            active[i] = True
            gen_counts[i] = len(self.slots[i].out)
        t0 = time.perf_counter()
        out = self._device_call(
            "serving.decode", self.engine.decode_slots,
            self.cache.k, self.cache.v, self.cache.tables, self.cache.lengths,
            tokens, active, k_scale=self.cache.k_scale,
            v_scale=self.cache.v_scale,
            sample_state=self.sampler.lanes(gen_counts),
            lora=self._lora_args(), now=now)
        if self.step_time_budget_s is not None:
            self._watchdog_note(time.perf_counter() - t0)
        toks, lps = out[1], out[2]
        self._store_pools(out[3:])
        self._stat["decode_steps"].inc()
        self.decode_iterations += 1
        if self.costs.enabled:
            # each live slot decoded one token over its own context; the
            # weight read is shared exactly
            self.costs.charge_batched(
                "decode", [(self.slots[i], 1, int(self.cache.lengths[i]))
                           for i in live])
        # one host transfer for every slot's token and logprob
        t_dev = time.perf_counter()
        toks = toks.cpu().numpy()
        lps = lps.cpu().numpy()
        self.device_time_s += time.perf_counter() - t_dev
        for i in live:
            self.cache.advance(i, 1)
            self._emit(i, self.slots[i], int(toks[i]), float(lps[i]), now)
        return len(live)

    def _horizon_decode_step(self, live: List[int],
                             now: float) -> Optional[int]:
        """Up to ``decode_horizon`` decode iterations over the decoding
        slots in one ``decode_horizon`` call, each slot's budget, eos and
        stop sequences freezing its lane on the device, then one host
        transfer and the replay of each slot's tokens through ``_emit``
        (which stays the authority on stops the device does not model).
        Capacity is opportunistic: a slot that cannot grow by N tokens
        runs a shorter horizon; the plain preamble already secured its
        first token. A slot with a deadline emits no more tokens than
        ticks remain to it. Returns the occupancy, or None when a
        ``serving.horizon`` fault degrades the step to one token (it fires
        before any capacity or slot state moves)."""
        N = self.decode_horizon
        try:
            self.faults.fire("serving.horizon")
        except TransientDeviceError:
            self._stat["horizon_fallbacks"].inc()
            logger.warning("serving: horizon fault; degrading this step "
                           "to single-step decode")
            return None
        B, W = self.num_slots, HORIZON_STOP_WIDTH
        tokens = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        gen_counts = np.zeros((B,), np.int64)
        budgets = np.zeros((B,), np.int32)
        eos_ids = np.full((B,), -1, np.int32)
        stop_ids = np.zeros((B, HORIZON_MAX_STOPS, W), np.int32)
        stop_lens = np.zeros((B, HORIZON_MAX_STOPS), np.int32)
        tail = np.full((B, W), -1, np.int32)
        tick = self._token_tick
        for i in live:
            req = self.slots[i]
            tokens[i] = req.out[-1]
            active[i] = True
            gen_counts[i] = len(req.out)
            length = int(self.cache.lengths[i])
            granted = self.cache.horizon_budget(
                i, min(length + N, self.cache.tokens_per_slot))
            # >= 1: the preamble secured one token of room, a request with
            # nothing left to emit has finished already, and _expire
            # retired whatever is past its deadline
            b = min(N, granted - length, req.max_new_tokens - len(req.out))
            if req.deadline is not None and tick > 0.0:
                b = min(b, max(1, int(math.ceil((req.deadline - now)
                                                / tick))))
            budgets[i] = max(1, b)
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
        t0 = time.perf_counter()
        out = self._device_call(
            "serving.decode", self.engine.decode_horizon,
            self.cache.k, self.cache.v, self.cache.tables, self.cache.lengths,
            tokens, active, n_steps, budgets, eos_ids, stop_ids, stop_lens,
            tail, k_scale=self.cache.k_scale, v_scale=self.cache.v_scale,
            sample_state=self.sampler.lanes(gen_counts),
            lora=self._lora_args(), now=now)
        if self.step_time_budget_s is not None:
            # a horizon answers to one budget per iteration it may run
            self._watchdog_note(time.perf_counter() - t0, scale=n_steps)
        self._store_pools(out[4:])
        self._stat["decode_steps"].inc()
        self.decode_iterations += n_steps
        # one host transfer harvests the whole horizon
        t_dev = time.perf_counter()
        produced = out[2].cpu().numpy()
        toks = out[0].cpu().numpy()
        lps = out[1].cpu().numpy()
        self.device_time_s += time.perf_counter() - t_dev
        if self.costs.enabled:
            # each live slot produced its own count over its own context
            self.costs.charge_batched(
                "decode", [(self.slots[i], int(produced[i]),
                            int(self.cache.lengths[i])) for i in live])
        ticks = 1
        prod_by_slot = {}
        for i in live:
            req = self.slots[i]
            p = int(produced[i])
            prod_by_slot[i] = p
            # one advance covers the horizon (p is within the grant); a
            # finish below frees the slot with any surplus writes
            self.cache.advance(i, p)
            if self._h_horizon is not None:
                self._h_horizon.observe(p)
            for j in range(p):
                self._emit(i, req, int(toks[j, i]), float(lps[j, i]),
                           now + j * tick)
                if req.state in TERMINAL_STATES:
                    # a stop the device does not model hit first: the
                    # surplus tokens go with the freed slot
                    break
            ticks = max(ticks, p)
        self._horizon_ticks = ticks
        self.telemetry.tracer.event(
            "horizon_step", step=self._step_clock, n=N,
            produced=prod_by_slot)
        return len(live)

    def _spec_decode_step(self, live: List[int],
                          now: float) -> Optional[int]:
        """One speculative iteration over the decoding slots: draft
        ``spec_k`` tokens per slot, verify all ``spec_k + 1`` positions in
        one ``verify_slots`` call, accept each slot's draft prefix, emit
        the accepted tokens and the target's correction, and roll the
        cache back past the first reject. Capacity is opportunistic: a
        slot that cannot grow to the whole chunk speculates shallower
        (eviction is never triggered for draft tokens, only for the
        committed token the plain preamble guaranteed). Returns the
        occupancy, or None when a draft or verify fault (both fire before
        the pools are touched) degrades the step to plain decode."""
        G = self.spec_k + 1
        try:
            self.faults.fire("serving.spec_draft")
            proposals = {i: np.asarray(self.draft.propose(
                self.slots[i].tokens, self.spec_k), np.int32).ravel()
                for i in live}
        except TransientDeviceError:
            self._stat["spec_fallbacks"].inc()
            logger.warning("serving: draft fault; degrading this step "
                           "to plain decode")
            return None
        caps = {}
        for i in live:
            length = int(self.cache.lengths[i])
            want = min(length + G, self.cache.tokens_per_slot)
            if want > self.cache.capacity_tokens(i):
                cow0 = self.cache.cow_copies
                try:
                    self.cache.ensure_capacity(i, want)
                except CacheExhausted:
                    pass          # speculate into whatever room exists
                if self.costs.enabled:
                    self.costs.charge_cow(self.slots[i],
                                          self.cache.cow_copies - cow0)
            caps[i] = min(self.cache.capacity_tokens(i),
                          self.cache.tokens_per_slot) - length
        tokens = np.zeros((self.num_slots, G), np.int32)
        active = np.zeros((self.num_slots,), bool)
        for i in live:
            tokens[i, 0] = self.slots[i].out[-1]   # the pending token
            tokens[i, 1:] = proposals[i][:self.spec_k]
            active[i] = True
        t0 = time.perf_counter()
        try:
            # not retried: the plain decode it degrades to retries
            out = self.engine.verify_slots(
                self.cache.k, self.cache.v, self.cache.tables,
                self.cache.lengths, tokens, active,
                k_scale=self.cache.k_scale, v_scale=self.cache.v_scale,
                lora=self._lora_args())
        except TransientDeviceError:
            self._stat["spec_fallbacks"].inc()
            logger.warning("serving: verify fault; degrading this step "
                           "to plain decode")
            return None
        if self.step_time_budget_s is not None:
            self._watchdog_note(time.perf_counter() - t0)
        logits = out[0]
        self._store_pools(out[1:])
        self._stat["decode_steps"].inc()
        self._stat["spec_steps"].inc()
        if self.costs.enabled:
            # the verify scores all G positions of every live slot,
            # whatever is accepted
            self.costs.charge_batched(
                "verify", [(self.slots[i], G, int(self.cache.lengths[i]))
                           for i in live])
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
        accept_by_slot = {}
        for i in live:
            req = self.slots[i]
            params = self.sampler.params[i]
            # caps >= 1: the preamble guaranteed the committed token
            k_live = max(0, min(self.spec_k, caps[i] - 1))
            if (self.spec_accept_floor > 0.0 and k_live > 1
                    and self._spec_obs[i] >= self.spec_adapt_warmup
                    and self._accept_ewma[i] < self.spec_accept_floor):
                self._stat["spec_k_capped"].inc()
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
            accept_by_slot[i] = acc
            # commit the pending token and the accepted drafts, then drop
            # the tail blocks only the rejected suffix used
            new_len = int(self.cache.lengths[i]) + acc + 1
            self.cache.advance(i, acc + 1)
            self.cache.rollback(i, new_len)
            self._stat["spec_slot_steps"].inc()
            for tok, lp in zip(toks, lps):
                emitted += 1
                self._emit(i, req, int(tok), lp, now)
                if req.state in TERMINAL_STATES:
                    break
        self._stat["spec_proposed"].inc(proposed)
        self._stat["spec_accepted"].inc(accepted)
        self._stat["spec_emitted"].inc(emitted)
        if self._h_accept is not None:
            if proposed:
                self._h_accept.observe(accepted / proposed)
            self._h_tps.observe(emitted / len(live))
        self.telemetry.tracer.event(
            "spec_verify", step=self._step_clock, k=self.spec_k,
            accepted=accept_by_slot, emitted=emitted)
        return len(live)

    def _store_pools(self, pools) -> None:
        """The pools (and, with int8 pools, the scale pools) a slot
        program returned."""
        self.cache.k, self.cache.v = pools[:2]
        if self.cache.quantized:
            self.cache.k_scale, self.cache.v_scale = pools[2:]

    def _release_slot(self, slot: int) -> None:
        """Blocks back to the pool (shared ones lose a reference), the
        adapter pin dropped, slot and sampling lane reopened."""
        self._release_adapter(slot, self.slots[slot])
        self.cache.free(slot)
        self.slots[slot] = None
        self.sampler.release(slot)

    def _release_adapter(self, slot: int, req: ServeRequest) -> None:
        """Drop the slot's adapter pin, if it holds one, and zero its table
        row. The nonzero row is the pin's mark: a request whose load
        failed never set it, so the releases stay balanced."""
        if self.adapters is None or req.adapter_id is None:
            return
        if not self._slot_arows[slot].any():
            return
        self.adapters.release(req.adapter_id)
        self._slot_arows[slot] = 0

    def _finish(self, slot: int, req: ServeRequest, now: float,
                state: str = "done") -> None:
        """Retire a slot holder in ``state`` (``done`` or ``timeout``)."""
        req.state = state
        req.finished_at = now
        self._release_slot(slot)
        self.finished.append(req)
        self._stat["timeouts" if state == "timeout" else "completed"].inc()
        self.telemetry.tracer.event(
            "finish", rid=req.rid, step=self._step_clock, slot=slot,
            state=state, generated=len(req.out))

    def _emit(self, slot: int, req: ServeRequest, tok: int,
              lp: Optional[float], now: float) -> None:
        """Record one token the sampler (or the speculative verify) chose:
        output, logprob, latency stamps and histograms, then the
        stop-sequence, max_new_tokens and eos checks."""
        self.sampler.observe(slot, tok)
        if req.logprobs and lp is not None:
            req.out_logprobs.append(lp)
        if self.sampler.temps[slot] > 0.0:
            self._stat["sampled_tokens"].inc()
        prev = req.token_times[-1] if req.token_times else None
        req.out.append(tok)
        req.token_times.append(now)
        if req.first_token_at is None:
            req.first_token_at = now
            if self._h_ttft is not None and req.submitted_at is not None:
                self._h_ttft.observe(max(0.0, now - req.submitted_at),
                                     at=now)
            self.telemetry.tracer.event(
                "first_token", rid=req.rid, step=self._step_clock, slot=slot)
        elif self._h_tpot is not None and prev is not None:
            self._h_tpot.observe(max(0.0, now - prev), at=now)
        for stop in (req.stop or ()):
            n = len(stop)
            if n and len(req.out) >= n and \
                    req.out[-n:] == [int(t) for t in stop]:
                # the matched stop tokens stay in out
                self._stat["stop_hits"].inc()
                self._finish(slot, req, now)
                return
        if (len(req.out) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)):
            self._finish(slot, req, now)

    def _spill_step(self) -> None:
        """The host tier's daemon tick, right after the decode dispatch:
        the spill it starts overlaps the next step, and the previous
        tick's is harvested here. The tick answers to the watchdog, but
        only an over-budget tick strikes: one within budget must not
        clear the decode dispatch's strikes."""
        if not self.host_tier:
            return
        t0 = time.perf_counter()
        sp0 = self.cache.host_spills
        self.cache.spill_tick()
        # spills of idle cached blocks have no owning request
        self.costs.charge_spill(self.cache.host_spills - sp0)
        self._sync_host_stats()
        if self.step_time_budget_s is not None:
            elapsed = time.perf_counter() - t0
            if elapsed > self.step_time_budget_s:
                self._watchdog_note(elapsed)

    def _sync_host_stats(self) -> None:
        """Mirror the cache's host-tier counters into the stats (the
        cache keeps the counts) and feed the restore-time histogram."""
        c = self.cache
        for key in ("host_blocks", "host_bytes", "host_spills",
                    "host_restores", "host_restore_failures"):
            self._stat[key].set(getattr(c, key))
        samples = c.drain_restore_ms()
        if self._g_host_bytes is not None:
            self._g_host_bytes.set(c.host_bytes)
        if self._h_host_restore is not None:
            for ms in samples:
                self._h_host_restore.observe(ms)

    def _watchdog_note(self, elapsed: float, scale: int = 1) -> None:
        """Score one decode, horizon or verify dispatch (or spill tick)
        against the step budget, ``scale`` budgets for a horizon that may
        run that many iterations. ``watchdog_grace`` over-budget scores in
        a row arm the DegradedError that ``step`` raises after its
        bookkeeping; one within budget clears the strikes."""
        budget = self.step_time_budget_s * max(1, int(scale))
        if elapsed > budget:
            self._over_budget += 1
            self._stat["watchdog_trips"].inc()
            self.telemetry.tracer.event(
                "watchdog", step=self._step_clock,
                elapsed_s=round(elapsed, 6), strikes=self._over_budget)
            if self._over_budget >= self.watchdog_grace:
                self._watchdog_msg = (
                    f"decode step over budget ({elapsed * 1e3:.1f}ms > "
                    f"{budget * 1e3:.1f}ms) {self._over_budget} "
                    f"consecutive times — degraded")
        else:
            self._over_budget = 0

    def _deadline_slack(self, now: Optional[float]) -> Optional[float]:
        """The tightest remaining deadline among the slot holders (the
        requests a retry pause stalls), at least 0; None when none has a
        deadline."""
        if now is None:
            return None
        slack = None
        for req in self.slots:
            if req is None or req.deadline is None:
                continue
            remain = max(0.0, req.deadline - now)
            slack = remain if slack is None else min(slack, remain)
        return slack

    def _device_call(self, site: str, fn, *args, now: Optional[float] = None,
                     **kwargs):
        """Run a slot program behind the ``site`` fault and retry a
        :class:`TransientDeviceError` up to ``max_retries`` times. Every
        fault fires before ``fn`` writes the pools, so a retry runs on
        intact pools. The pause doubles each attempt, plus the injector's
        seeded jitter, at most :data:`MAX_BACKOFF_S`, and never past the
        tightest deadline of a slot holder (``now`` is the step's clock
        instant): with no margin left a retry follows at once and expiry
        decides at the next step. The call is waited for inside its timed
        window, so ``device_time_s`` and the watchdog see the execution,
        not the enqueue."""
        delay = self.retry_backoff_s
        attempt = 0
        while True:
            try:
                self.faults.fire(site)
                t_dev = time.perf_counter()
                out = fn(*args, **kwargs)
                self._sync_devices()
                self.device_time_s += time.perf_counter() - t_dev
                return out
            except TransientDeviceError:
                if attempt >= self.max_retries:
                    raise
                attempt += 1
                self._stat["retries"].inc()
                pause = min(delay + self.faults.jitter(delay * 0.5),
                            MAX_BACKOFF_S)
                slack = self._deadline_slack(now)
                if slack is not None:
                    pause = min(pause, slack)
                logger.warning(
                    f"serving: transient device error at {site} (attempt "
                    f"{attempt}/{self.max_retries}); retrying in "
                    f"{pause * 1e3:.1f}ms")
                time.sleep(pause)
                delay *= 2

    def device_time_snapshot(self) -> float:
        """``device_time_s`` now: it accumulates over the engine's life,
        so time one drive among many by the difference of two
        snapshots."""
        return float(self.device_time_s)

    def capture_profile(self, steps: int, outdir: str,
                        now: Optional[float] = None) -> str:
        """Trace exactly ``steps`` scheduler iterations (fewer when the
        engine goes idle first; each a horizon boundary, so a window never
        splits a fused dispatch) into a Chrome trace in ``outdir``
        (``utils/trace.py``: the host's operations and, on the card, the
        kernels); the JAX engine's ``capture_profile``. The window closes
        on the card's finished work. Returns ``outdir``; the file's path
        is ``last_trace``. It opens on a card with no queued work, as
        ``DeepSpeedEngine.start_trace`` does."""
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)
        cap = trace.Capture(outdir).start()
        try:
            for _ in range(max(1, int(steps))):
                if not self.busy:
                    break
                self.step(now)
        finally:
            if self.engine.device.type == "cuda":
                torch.cuda.synchronize(self.engine.device)
            self.last_trace = cap.stop()
        return outdir

    def _update_backpressure(self) -> None:
        self._stat["backpressure"].set(
            round(len(self.queue) / self.max_queue, 4) if self.max_queue
            else 0.0)

    def _degraded(self, message: str) -> DegradedError:
        """The DegradedError of ``message``, the flight recorder's artifact
        written first (whatever the caller does with the error)."""
        self.flight.dump(f"degraded: {message}")
        return DegradedError(
            message, results={r.rid: r.tokens for r in self.finished},
            finished=list(self.finished), pending=self.pending_snapshot(),
            stats=dict(self.stats))

    def _sync_devices(self) -> None:
        """Wait for the card's queue (nothing on the host): the barrier of
        the breakdown's sampled steps, so that a lap bills the kernels a
        phase launched to that phase, and of every device dispatch."""
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)

    def _sample_gauges(self) -> None:
        """Gauges refreshed on sampled steps: the pool's block states, the
        prefix hit rate and, with int8 pools, half the largest
        quantization step (one device read)."""
        self._g_held.set(int(self.cache.held_blocks))
        self._g_cached.set(int(self.cache.cached_blocks))
        self._g_free.set(int(self.cache.free_blocks))
        admitted = self._stat["admitted"].value
        self._g_hit_rate.set(
            round(self._stat["prefix_hits"].value / admitted, 4)
            if admitted else 0.0)
        if self._h_kv_err is not None:
            step = torch.maximum(self.cache.k_scale.max(),
                                 self.cache.v_scale.max())
            self._h_kv_err.observe(float(step) / 2.0)

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
            self._stat["evict_capped"].inc(capped)
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
        self._stat["evictions"].inc()
        self.telemetry.tracer.event(
            "evict", rid=req.rid, step=self._step_clock, slot=slot,
            generated=len(req.out))
        self._release_slot(slot)
        self.queue.appendleft(req)

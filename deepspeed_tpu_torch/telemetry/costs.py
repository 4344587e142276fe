"""Cost accounting: the analytic cost model, the serving programs' cost
cards and the per-dispatch accountant.

Port of ``deepspeed_tpu/telemetry/costs.py``. The telemetry plane says how
long a request took; this module says what it cost, in FLOPs, HBM bytes
and KV block-seconds, per program, per request and per tenant:

- the analytic model: integer formulas over ``models/gpt.py``'s parameter
  counts and KV bytes per token, which the flops profiler
  (``profiling/flops_profiler``) reads too, and the card's dense peak;
- :class:`ProgramCostRegistry`: a cost card per serving program of
  :data:`ENGINE_PROGRAMS`, from the analytic formulas at a reference
  shape (the JAX registry's ``"analytic"`` cards; the port has no
  compiled executables whose analyses it could read);
- :class:`CostAccountant`: exact integer charges per dispatch, added to
  the request's footprint and to the same class's totals from the same
  integers, so the footprints of all requests plus the system footprint
  equal the totals, class by class.

All of it is host arithmetic on Python ints: no tensor, no device sync.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import torch

# dense bf16/fp16 tensor-core peak per card (NVIDIA's data sheet, SXM part,
# without sparsity), matched against torch.cuda.get_device_name
PEAK_FLOPS = {
    "H100": 989e12,
}


def device_peak_flops(device=None) -> Optional[float]:
    """Dense peak FLOP/s of ``device`` (default: the current CUDA card),
    by the longest key of :data:`PEAK_FLOPS` found in its name; None for
    the host and for cards the table does not know."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    best, best_len = None, -1
    for key, peak in PEAK_FLOPS.items():
        if key in name and len(key) > best_len:
            best, best_len = peak, len(key)
    return best


def matmul_params(cfg, include_head: bool = True) -> int:
    """Parameters in a matmul per token: ``num_params`` without the wte
    lookup, the logit projection counted when ``include_head`` (with tied
    embeddings it is real compute though its weight is wte's)."""
    from deepspeed_tpu_torch.models.gpt import num_params
    n = num_params(cfg) - cfg.vocab_size * cfg.d_model
    if include_head and cfg.tie_embeddings:
        n += cfg.d_model * cfg.vocab_size
    return int(n)


def model_flops_per_token(cfg, include_head: bool = True) -> int:
    """Forward matmul FLOPs per token, attention excluded."""
    return 2 * matmul_params(cfg, include_head)


def attn_flops(cfg, n_tokens: int, start_pos: int) -> int:
    """Forward attention-score FLOPs of ``n_tokens`` consecutive tokens
    from position ``start_pos``: a token at position p attends p + 1 keys,
    QK^T and PV each ``2 * d_model`` FLOPs a pair and layer."""
    n, s = int(n_tokens), int(start_pos)
    ctx_sum = n * s + (n * (n + 1)) // 2
    return 4 * cfg.n_layers * cfg.d_model * ctx_sum


def infer_flops(cfg, n_tokens: int, start_pos: int,
                include_head: bool = True) -> int:
    """Forward FLOPs of ``n_tokens`` new tokens after ``start_pos`` cached
    ones: the weight matmuls plus causal attention."""
    return (int(n_tokens) * model_flops_per_token(cfg, include_head)
            + attn_flops(cfg, n_tokens, start_pos))


def weight_bytes(cfg, param_itemsize: int = 2) -> int:
    """Bytes of the model's weights (every dispatch reads them once)."""
    from deepspeed_tpu_torch.models.gpt import num_params
    return int(num_params(cfg)) * int(param_itemsize)


def infer_hbm_bytes(cfg, n_tokens: int, start_pos: int, kv_bytes_tok: int,
                    param_itemsize: int = 2,
                    include_weights: bool = True) -> int:
    """Analytic HBM traffic of one sequence's share of a dispatch: each new
    token reads the cache up to its position, the new tokens' K/V are
    written, and, with ``include_weights``, the weights are read once
    (a batched dispatch splits that read across its slots,
    :func:`split_even`)."""
    n, s = int(n_tokens), int(start_pos)
    ctx_sum = n * s + (n * (n + 1)) // 2
    kv = int(kv_bytes_tok) * (ctx_sum + n)
    return kv + (weight_bytes(cfg, param_itemsize) if include_weights
                 else 0)


def split_even(total: int, n: int) -> List[int]:
    """``total`` in ``n`` integer shares that sum to it exactly:
    ``total // n`` each, the remainder one unit at a time to the first
    ``total % n`` shares."""
    if n <= 0:
        return []
    q, r = divmod(int(total), n)
    return [q + 1 if i < r else q for i in range(n)]


# --------------------------------------------------------------------------
# the serving programs
# --------------------------------------------------------------------------

DISPATCH_CLASSES: Tuple[str, ...] = (
    "prefill", "decode", "verify", "cow", "spill")

# (program id, the port's callable that runs it, dispatch class). The ids
# are the JAX package's (``utils/jit_registry.py engine_programs``), in its
# order: a "_q" id is the int8-pool mode of the same callable, "_l" its
# ``lora=`` mode and "_ql" both; the block copies have no LoRA mode
ENGINE_PROGRAMS: Tuple[Tuple[str, str, str], ...] = tuple(
    (stem + suffix, attr, cls)
    for stem, attr, cls, suffixes in (
        ("prefill_slot", "InferenceEngine.prefill_into_slot", "prefill",
         ("", "_q", "_l", "_ql")),
        ("decode_slots", "InferenceEngine.decode_slots", "decode",
         ("", "_q", "_l", "_ql")),
        ("decode_horizon", "InferenceEngine.decode_horizon", "decode",
         ("", "_q", "_l", "_ql")),
        ("verify_slots", "InferenceEngine.verify_slots", "verify",
         ("", "_q", "_l", "_ql")),
        ("cow_blocks", "InferenceEngine.cow_blocks", "cow", ("", "_q")),
        ("gather_blocks", "paged_cache.gather_blocks", "spill", ("", "_q")),
        ("scatter_block", "paged_cache.scatter_block", "spill", ("", "_q")))
    for suffix in suffixes)


# --------------------------------------------------------------------------
# per-request footprints
# --------------------------------------------------------------------------

def new_footprint() -> Dict:
    """An empty footprint: per dispatch class its dispatches, FLOPs and
    HBM bytes, and the KV block-seconds."""
    fp = {cls: {"dispatches": 0, "flops": 0, "hbm_bytes": 0}
          for cls in DISPATCH_CLASSES}
    fp["block_seconds"] = 0
    return fp


def merge_footprints(fps: Sequence[Dict]) -> Dict:
    """The sum of footprints (a tenant's or a fleet's)."""
    out = new_footprint()
    for fp in fps:
        if not fp:
            continue
        for cls in DISPATCH_CLASSES:
            for k in ("dispatches", "flops", "hbm_bytes"):
                out[cls][k] += fp.get(cls, {}).get(k, 0)
        out["block_seconds"] += fp.get("block_seconds", 0)
    return out


def footprint_totals(fp: Dict) -> Dict[str, int]:
    """A footprint's totals across the classes."""
    return {
        "flops": sum(fp[c]["flops"] for c in DISPATCH_CLASSES),
        "hbm_bytes": sum(fp[c]["hbm_bytes"] for c in DISPATCH_CLASSES),
        "dispatches": sum(fp[c]["dispatches"] for c in DISPATCH_CLASSES),
        "block_seconds": fp["block_seconds"],
    }


# --------------------------------------------------------------------------
# program cost registry
# --------------------------------------------------------------------------

class ProgramCostRegistry:
    """A cost card per serving program of :data:`ENGINE_PROGRAMS`, from
    the analytic formulas at a reference shape: one token at half the
    model's context for prefill, decode and verify, one block for COW and
    the host tier's transfers. Entries are plain dicts."""

    def __init__(self):
        self.entries: Dict[str, Dict] = {}

    def populate(self, engine, cache=None) -> None:
        """One entry per program for ``engine`` (an ``InferenceEngine``).
        ``cache`` (a ``PagedKVCache``) gives the KV bytes per token and the
        block size; without it, the engine dtype's and 16."""
        from deepspeed_tpu_torch.models.gpt import kv_bytes_per_token
        cfg = engine.cfg
        param_itemsize = int(engine.dtype.itemsize)
        if cache is not None:
            kv_tok = int(cache.bytes_per_token)
        else:
            kv_tok = int(kv_bytes_per_token(cfg, engine.dtype))
        block = int(getattr(cache, "block_size", 16) or 16)
        ref_ctx = max(1, int(cfg.max_seq_len) // 2)
        for pid, attr, cls in ENGINE_PROGRAMS:
            entry = {"program": pid, "attr": attr, "dispatch_class": cls,
                     "source": "analytic"}
            entry.update(self._analytic(cfg, cls, kv_tok, kv_tok * block,
                                        param_itemsize, ref_ctx))
            self.entries[pid] = entry

    @staticmethod
    def _analytic(cfg, cls: str, kv_tok: int, block_bytes: int,
                  param_itemsize: int, ref_ctx: int) -> Dict:
        if cls in ("prefill", "decode", "verify"):
            return {
                "flops": infer_flops(cfg, 1, ref_ctx),
                "bytes_accessed": infer_hbm_bytes(
                    cfg, 1, ref_ctx, kv_tok, param_itemsize),
                "flops_per_token": model_flops_per_token(cfg),
                "attn_flops_per_ctx_token": 4 * cfg.n_layers * cfg.d_model,
                "kv_bytes_per_token": kv_tok,
                "weight_bytes": weight_bytes(cfg, param_itemsize),
                "ref_context": ref_ctx,
            }
        # COW reads and writes a block; a spill or restore moves it once
        moved = 2 * block_bytes if cls == "cow" else block_bytes
        return {"flops": 0, "bytes_accessed": moved,
                "block_bytes": block_bytes}

    def export_gauges(self, registry) -> None:
        """Each entry's FLOPs and bytes as the gauges
        ``program_flops_<pid>`` and ``program_hbm_bytes_<pid>``."""
        for pid, e in sorted(self.entries.items()):
            registry.gauge(f"program_flops_{pid}").set(e.get("flops", 0))
            registry.gauge(f"program_hbm_bytes_{pid}").set(
                e.get("bytes_accessed", 0))

    def to_json(self) -> Dict:
        return {"programs": {pid: dict(e)
                             for pid, e in sorted(self.entries.items())}}


# --------------------------------------------------------------------------
# per-dispatch accountant
# --------------------------------------------------------------------------

class CostAccountant:
    """Exact integer attribution of dispatch costs, one per serving engine.

    Every charge computes each live slot's cost from its own token count
    and context, adds it to that request's footprint (``req.cost``) and
    the same integers to the class totals, so

        sum(request footprints) + system footprint == totals

    holds per class with no rounding (:func:`split_even` shares the one
    weight read of a batched dispatch). A cost without an owning request
    (the spill of an idle cached block) goes to ``self.system``. Tenants
    are keyed by the request's ``adapter_id`` ("base" without one,
    "system" for the system footprint). With a ``registry`` the totals
    also feed the counters ``serving_flops_total``,
    ``serving_hbm_bytes_total`` and ``serving_kv_block_seconds``."""

    enabled = True

    def __init__(self, cfg, kv_bytes_tok: int, block_bytes: int,
                 param_itemsize: int = 2, registry=None):
        self.cfg = cfg
        self.kv_bytes_tok = int(kv_bytes_tok)
        self.block_bytes = int(block_bytes)
        self.param_itemsize = int(param_itemsize)
        self._weight_bytes = weight_bytes(cfg, param_itemsize)
        self.totals = {cls: {"dispatches": 0, "flops": 0, "hbm_bytes": 0}
                       for cls in DISPATCH_CLASSES}
        self.block_seconds_total = 0
        self.system = new_footprint()
        self.tenants: Dict[str, Dict] = {}
        self._c_flops = self._c_bytes = self._c_blocks = None
        if registry is not None:
            self._c_flops = registry.counter(
                "serving_flops_total",
                "analytic model FLOPs dispatched, all classes")
            self._c_bytes = registry.counter(
                "serving_hbm_bytes_total",
                "analytic HBM bytes moved, all classes")
            self._c_blocks = registry.counter(
                "serving_kv_block_seconds",
                "KV block residency integrated at horizon boundaries "
                "(scheduler-clock units)")

    def _tenant(self, req) -> Dict:
        key = getattr(req, "adapter_id", None) or "base"
        t = self.tenants.get(key)
        if t is None:
            t = self.tenants[key] = new_footprint()
        return t

    def _add(self, cls: str, req, flops: int, nbytes: int,
             dispatches: int = 0) -> None:
        tenant = self._tenant(req) if req is not None else \
            self.tenants.setdefault("system", new_footprint())
        for fp in ((req.cost if req is not None else self.system),
                   self.totals, tenant):
            slot = fp[cls]
            slot["flops"] += flops
            slot["hbm_bytes"] += nbytes
            slot["dispatches"] += dispatches
        if self._c_flops is not None:
            self._c_flops.inc(flops)
            self._c_bytes.inc(nbytes)

    def charge_prefill(self, req, n_tokens: int, start_pos: int) -> None:
        """One prefill chunk: its slot owns the whole cost, the weight read
        included."""
        flops = infer_flops(self.cfg, n_tokens, start_pos)
        nbytes = infer_hbm_bytes(self.cfg, n_tokens, start_pos,
                                 self.kv_bytes_tok, self.param_itemsize)
        self._add("prefill", req, flops, nbytes, dispatches=1)

    def charge_batched(self, cls: str, items) -> None:
        """One batched dispatch (decode, horizon or verify): ``items`` is
        ``(req, n_tokens, start_pos)`` per live slot; each slot pays its
        own attention and KV cost and an exact share of the weight
        read."""
        items = list(items)
        if not items:
            return
        shares = split_even(self._weight_bytes, len(items))
        for (req, n, s), wshare in zip(items, shares):
            flops = infer_flops(self.cfg, n, s)
            nbytes = infer_hbm_bytes(self.cfg, n, s, self.kv_bytes_tok,
                                     self.param_itemsize,
                                     include_weights=False) + wshare
            self._add(cls, req, flops, nbytes, dispatches=1)

    def charge_cow(self, req, n_blocks: int) -> None:
        """Copy-on-write copies ``req`` caused: a block read and written
        each, no FLOPs."""
        if n_blocks <= 0:
            return
        self._add("cow", req, 0, 2 * self.block_bytes * int(n_blocks),
                  dispatches=int(n_blocks))

    def charge_spill(self, n_blocks: int, req=None) -> None:
        """Host-tier block transfers, spills or restores: a block's bytes
        once each. A spill of idle cached blocks has no owner and goes to
        the system footprint; a restore is the admitted request's."""
        if n_blocks <= 0:
            return
        self._add("spill", req, 0, self.block_bytes * int(n_blocks),
                  dispatches=int(n_blocks))

    def charge_block_seconds(self, req, blocks: int, ticks: int) -> None:
        """KV residency at a horizon boundary: ``blocks`` held for
        ``ticks`` scheduler-clock units."""
        bs = int(blocks) * int(ticks)
        if bs <= 0:
            return
        req.cost["block_seconds"] += bs
        self._tenant(req)["block_seconds"] += bs
        self.block_seconds_total += bs
        if self._c_blocks is not None:
            self._c_blocks.inc(bs)

    def snapshot(self) -> Dict:
        """Plain data: class totals, grand totals, the system footprint
        and each tenant's."""
        return {
            "totals": {cls: dict(v) for cls, v in self.totals.items()},
            "flops_total": sum(v["flops"] for v in self.totals.values()),
            "hbm_bytes_total": sum(v["hbm_bytes"]
                                   for v in self.totals.values()),
            "block_seconds_total": self.block_seconds_total,
            "system": {cls: dict(self.system[cls])
                       for cls in DISPATCH_CLASSES}
            | {"block_seconds": self.system["block_seconds"]},
            "tenants": {k: merge_footprints([v])
                        for k, v in sorted(self.tenants.items())},
        }


class NoopCostAccountant:
    """The accounting-off twin: every charge is a constant-time no-op."""

    enabled = False

    def charge_prefill(self, req, n_tokens, start_pos):
        pass

    def charge_batched(self, cls, items):
        pass

    def charge_cow(self, req, n_blocks):
        pass

    def charge_spill(self, n_blocks, req=None):
        pass

    def charge_block_seconds(self, req, blocks, ticks):
        pass

    def snapshot(self) -> Dict:
        return {}


NOOP_COSTS = NoopCostAccountant()

"""Deterministic serving load generator: seeded request mixes, arrival
processes and a drive loop that records per-request timestamps.

The port's copy of the JAX package's ``tools/load_gen.py``: the same
mixes, the same numpy generator draws in the same order, so a seed gives
the byte-identical request list in both packages, and a trace saved by
either loads in the other.

- **mixes** (``MIXES``): ``chat`` (short turns behind a shared system
  prompt, mostly interactive), ``rag`` (long retrieval contexts, short
  answers), ``repetitive`` (a tiny alphabet: the speculation-friendly
  shape, mostly batch), ``heavy_tail`` (Pareto-tailed lengths),
  ``multitenant`` (a Zipf-popular LoRA tenant population plus base-only
  requests: the adapter-affinity shape) and ``mixed`` (rag and chat
  interleaved, rag prefixes Zipf-popular, per-kind SLO budgets in
  :data:`SLO_TARGETS`: the disaggregated prefill/decode workload);
- **arrivals**: an open-loop Poisson process over piecewise-constant
  rate ``phases`` (``[(duration, rate), ...]``; a spike is a high-rate
  middle phase), or a burst (every request at t=0) for closed loops;
- **trace save/replay**: :func:`save_trace` / :func:`load_trace`;
- **drive loop** (:func:`drive`): submits against anything with the
  ``submit(req, now)`` / ``step(now)`` / ``busy`` surface (a
  ``ServingEngine`` or a ``ReplicaRouter``), open- or closed-loop, in
  scheduler clock units, and returns per-request
  ``submitted/first_token/finished`` stamps and SLO attainment.

Everything is a pure function of the explicit ``seed``.

CLI: ``python -m deepspeed_tpu_torch.tools.load_gen --seed 0 --mix chat
--phases 20:0.5,10:2,20:0.5 --out trace.json`` writes a replayable
trace; ``--summary`` prints the population digest.
"""

import json
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# terminal request states the drive loop treats as "finished"
_TERMINAL = ("done", "timeout", "shed", "error")

# mix parameters: prompt/output length ranges are inclusive uniform
# unless pareto=True (heavy tail: lo + Pareto(alpha) * scale, clipped);
# shared_prefix tokens are common to every request in the population
# (the prefix-cache / affinity-routing shape); alphabet restricts token
# ids to a tiny range (highly predictable text, the speculative-decode
# friendly regime); batch_frac is the probability a request carries
# priority="batch" instead of "interactive"
MIXES: Dict[str, Dict[str, Any]] = {
    "chat": dict(plen=(4, 12), new=(4, 16), shared_prefix=4,
                 alphabet=None, batch_frac=0.1, pareto=False),
    "rag": dict(plen=(20, 40), new=(2, 8), shared_prefix=12,
                alphabet=None, batch_frac=0.5, pareto=False),
    "repetitive": dict(plen=(8, 24), new=(8, 24), shared_prefix=0,
                       alphabet=8, batch_frac=0.7, pareto=False),
    "heavy_tail": dict(plen=(3, 40), new=(2, 24), shared_prefix=0,
                       alphabet=None, batch_frac=0.5, pareto=True),
    # adapters: tenant population size; zipf_a: popularity skew (a few
    # hot tenants, a long warm tail — the pool-hit/eviction shape);
    # base_frac: requests that name no adapter at all. shared_prefix
    # stays 0: adapter requests bypass prefix sharing by design
    "multitenant": dict(plen=(6, 16), new=(4, 12), shared_prefix=0,
                        alphabet=None, batch_frac=0.2, pareto=False,
                        adapters=6, zipf_a=1.5, base_frac=0.25),
    # mixed (the disaggregation workload): the rag
    # and chat populations interleaved — long batch-heavy prefills
    # fighting short interactive decodes for the same slots is exactly
    # the contention the prefill/decode split resolves. Each request
    # keeps its component's kind/priority/SLO budget; rag requests
    # draw their document prefix from a Zipf-popular family (a few hot
    # contexts, a long warm tail). Composite: per-request parameters
    # come from the named component mixes.
    # Overrides reshape the components for disaggregation stress: rag
    # prompts grow to real document length (40-64 tokens, 5-8 prefill
    # chunks — the head-of-line block a mixed fleet suffers) and its
    # answers become grounded spans rather than 2-token acks (a
    # 2-token stream's "mean inter-token gap" is ONE gap, so TPOT
    # would be meaningless); chat answers lengthen so its decode
    # stream is long enough for inter-token stalls to register.
    "mixed": dict(components=("chat", "rag"), rag_frac=0.6,
                  prefix_families=4, zipf_a=1.4,
                  overrides={"rag": {"plen": (40, 64), "new": (4, 8)},
                             "chat": {"new": (6, 16)}}),
}

# per-kind SLO budgets in scheduler token-time units (one unit ≈ one
# decode iteration): ``ttft`` bounds submit -> first token, ``tpot``
# bounds the mean inter-token gap of the decode stream. These are the
# targets a disaggregated fleet must hold for both kinds at once;
# drive() records the raw per-request numbers so attainment is
# offline-recomputable.
SLO_TARGETS: Dict[str, Dict[str, float]] = {
    "chat": {"ttft": 12.0, "tpot": 2.5},
    "rag": {"ttft": 14.0, "tpot": 8.0},
    "repetitive": {"ttft": 16.0, "tpot": 3.0},
    "heavy_tail": {"ttft": 30.0, "tpot": 4.0},
    "multitenant": {"ttft": 16.0, "tpot": 3.0},
}

TRACE_VERSION = 1


def poisson_arrivals(phases: Sequence[Tuple[float, float]],
                     seed: int) -> List[float]:
    """Arrival instants of a Poisson process with piecewise-constant
    rate: for each ``(duration, rate)`` phase, exponential inter-
    arrival gaps at that rate until the phase's time is spent. Rate 0
    phases contribute silence. Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    out: List[float] = []
    t0 = 0.0
    for duration, rate in phases:
        duration = float(duration)
        if rate > 0:
            t = t0 + float(rng.exponential(1.0 / rate))
            while t < t0 + duration:
                out.append(t)
                t += float(rng.exponential(1.0 / rate))
        t0 += duration
    return out


def make_requests(*, seed: int, mix: str = "chat", n: Optional[int] = None,
                  phases: Optional[Sequence[Tuple[float, float]]] = None,
                  vocab_size: int = 128,
                  max_prompt_len: int = 48) -> List[Dict]:
    """Generate a deterministic request population. With ``phases`` the
    arrival instants come from the Poisson process (``n`` then caps the
    count if given); without, ``n`` requests all arrive at t=0 (a burst
    — the closed-loop shape). Each entry is JSON-plain:
    ``{rid, at, kind, priority, prompt, max_new_tokens}``."""
    if mix not in MIXES:
        raise ValueError(f"unknown mix {mix!r}; have {sorted(MIXES)}")
    if phases is None and n is None:
        raise ValueError("need n= (burst) or phases= (poisson)")
    params = MIXES[mix]
    if phases is not None:
        ats = poisson_arrivals(phases, seed)
        if n is not None:
            ats = ats[:n]
    else:
        ats = [0.0] * int(n)
    rng = np.random.default_rng(seed + 1)     # independent of arrivals
    if "components" in params:
        return _composite_requests(mix, params, ats, rng,
                                   vocab_size=vocab_size,
                                   max_prompt_len=max_prompt_len)
    lo_tok, hi_tok = 1, vocab_size            # 0 reserved (pad/eos)
    if params["alphabet"]:
        hi_tok = min(vocab_size, lo_tok + params["alphabet"])
    shared = rng.integers(
        lo_tok, hi_tok, params["shared_prefix"]).tolist() \
        if params["shared_prefix"] else []

    def length(lo: int, hi: int) -> int:
        if params["pareto"]:
            v = lo + rng.pareto(1.5) * (hi - lo) / 4.0
            return int(min(max(v, lo), hi))
        return int(rng.integers(lo, hi + 1))

    def adapter() -> Optional[str]:
        n_adapters = params.get("adapters")
        if not n_adapters or rng.random() < params.get("base_frac", 0.0):
            return None
        # Zipf draw folded onto the tenant population: tenant-0 is the
        # hot adapter, the tail stays warm (the LRU-pool shape)
        return f"tenant-{(int(rng.zipf(params['zipf_a'])) - 1) % n_adapters}"

    out: List[Dict] = []
    for i, at in enumerate(ats):
        plen = min(length(*params["plen"]), max_prompt_len)
        tail = max(1, plen - len(shared))
        prompt = shared + rng.integers(lo_tok, hi_tok, tail).tolist()
        out.append({
            "rid": f"{mix}-{i}",
            "at": float(at),
            "kind": mix,
            "priority": ("batch" if rng.random() < params["batch_frac"]
                         else "interactive"),
            "adapter_id": adapter(),
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": length(*params["new"]),
        })
    return out


def _composite_requests(mix: str, params: Dict, ats: List[float],
                        rng: np.random.Generator, *, vocab_size: int,
                        max_prompt_len: int) -> List[Dict]:
    """Composite-mix population (``components`` in MIXES): each request
    draws its component by ``rag_frac`` and keeps that component's
    ``kind`` (so per-kind SLO budgets in :data:`SLO_TARGETS` apply
    per request). Chat requests share one system prefix; rag requests
    pick their document prefix from a Zipf-popular family. Pure in the
    passed ``rng`` — same seed, byte-identical trace."""
    comp = {name: dict(MIXES[name], **params.get("overrides", {})
                       .get(name, {}))
            for name in params["components"]}
    lo_tok = 1
    chat_shared = rng.integers(
        lo_tok, vocab_size, comp["chat"]["shared_prefix"]).tolist()
    families = [rng.integers(lo_tok, vocab_size,
                             comp["rag"]["shared_prefix"]).tolist()
                for _ in range(int(params["prefix_families"]))]
    out: List[Dict] = []
    for i, at in enumerate(ats):
        kind = "rag" if rng.random() < params["rag_frac"] else "chat"
        p = comp[kind]
        plen = min(int(rng.integers(p["plen"][0], p["plen"][1] + 1)),
                   max_prompt_len)
        if kind == "rag":
            fam = (int(rng.zipf(params["zipf_a"])) - 1) % len(families)
            shared = families[fam]
        else:
            shared = chat_shared
        tail = max(1, plen - len(shared))
        prompt = shared + rng.integers(lo_tok, vocab_size, tail).tolist()
        out.append({
            "rid": f"{mix}-{i}",
            "at": float(at),
            "kind": kind,
            "priority": ("batch" if rng.random() < p["batch_frac"]
                         else "interactive"),
            "adapter_id": None,
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(rng.integers(p["new"][0],
                                               p["new"][1] + 1)),
        })
    return out


def save_trace(path: str, requests: List[Dict], *, seed: int,
               mix: str = "", meta: Optional[Dict] = None) -> str:
    """Persist a request population as a replayable JSON trace."""
    body = {"version": TRACE_VERSION, "seed": seed, "mix": mix,
            "meta": meta or {}, "requests": requests}
    with open(path, "w") as f:
        json.dump(body, f)
    return path


def load_trace(path: str) -> List[Dict]:
    """Load a trace written by :func:`save_trace`; returns the request
    list (arrival order preserved)."""
    with open(path) as f:
        body = json.load(f)
    if body.get("version") != TRACE_VERSION:
        raise ValueError(
            f"{path}: trace version {body.get('version')!r}, "
            f"expected {TRACE_VERSION}")
    return body["requests"]


def _mk_serve_requests(entries: List[Dict]) -> List:
    from deepspeed_tpu_torch.inference.serving import ServeRequest
    return [ServeRequest(rid=e["rid"],
                         prompt=np.asarray(e["prompt"], np.int32),
                         max_new_tokens=int(e["max_new_tokens"]),
                         priority=e.get("priority"),
                         adapter_id=e.get("adapter_id"))
            for e in entries]


def drive(target, entries: List[Dict], *, mode: str = "open",
          concurrency: int = 8, slo_ttft: Optional[float] = None,
          max_steps: int = 100_000, include_tokens: bool = False) -> Dict:
    """Run a generated population against ``target`` (ServingEngine or
    ReplicaRouter — anything with ``submit(req, now)`` / ``step(now)``
    / ``busy``), stepping the scheduler clock in token-time units —
    one unit per iteration at N=1, up to N units when a fused decode
    horizon (``DS_DECODE_HORIZON``) emits several tokens per step.

    - ``mode="open"``: requests are submitted when the clock reaches
      their ``at`` — queueing delay under a spike is real (the
      fixed-fleet SLO-violation shape).
    - ``mode="closed"``: arrival times are ignored; at most
      ``concurrency`` requests are outstanding, the next one submitted
      as soon as one finishes (throughput-probe shape).

    Returns ``{"per_request": [...], "steps", "slo_attainment",
    "ttft_p50/p95/p99", "tpot_p50/p95/p99"}`` where each per-request
    record carries ``submitted_at`` / ``first_token_at`` /
    ``finished_at`` / ``state`` / ``ttft`` / ``tpot`` — the offline-
    recomputable SLO record (``tpot`` is the mean inter-token gap of
    the decode stream, None for < 2 generated tokens).
    ``slo_attainment`` (when ``slo_ttft`` is given) counts a request
    attained iff it got its first token within the budget; requests
    that never produced one (shed, still queued at exhaustion) count
    as misses. ``include_tokens=True`` embeds each request's final
    ``tokens`` so two runs can assert token-identical output."""
    if mode not in ("open", "closed"):
        raise ValueError(f"mode must be open|closed, got {mode!r}")
    if hasattr(target, "token_time_unit"):
        # the drive loop's clock is in token-time units (one unit ≈ one
        # decode iteration); telling the engine so makes a fused
        # horizon stamp its i-th in-horizon token at ``clock + i``
        # — the exact instants the N=1 loop would have used, keeping
        # ttft/tpot records and deadline enforcement bit-identical
        # at any DS_DECODE_HORIZON
        target.token_time_unit = 1.0
    order = sorted(range(len(entries)), key=lambda i: entries[i]["at"]) \
        if mode == "open" else list(range(len(entries)))
    reqs = _mk_serve_requests(entries)
    clock = 0.0
    steps = 0
    nxt = 0                                   # next request to submit
    live: List = []                           # submitted, maybe running
    while nxt < len(order) or target.busy:
        if mode == "open":
            while nxt < len(order) \
                    and entries[order[nxt]]["at"] <= clock:
                r = reqs[order[nxt]]
                target.submit(r, now=clock)
                live.append(r)
                nxt += 1
            if not target.busy and nxt < len(order):
                # idle gap before the next arrival: fast-forward the
                # clock instead of spinning empty steps
                clock = max(clock, entries[order[nxt]]["at"])
                continue
        else:
            inflight = sum(1 for r in live if r.state not in _TERMINAL)
            while nxt < len(order) and inflight < concurrency:
                r = reqs[order[nxt]]
                target.submit(r, now=clock)
                live.append(r)
                nxt += 1
                if r.state not in _TERMINAL:
                    inflight += 1
        target.step(clock)
        # a fused multi-step horizon emits up to N tokens per step;
        # advance by the tokens actually produced so the next arrivals
        # land at the same token-time they would under N=1
        clock += max(1.0, float(getattr(target, "last_step_span", 1.0)))
        steps += 1
        if steps > max_steps:
            raise RuntimeError(f"load did not drain in {max_steps} steps")

    per_request: List[Dict] = []
    ttfts: List[float] = []
    tpots: List[float] = []
    attained = 0
    for e, r in zip(entries, reqs):
        ttft = (r.first_token_at - r.submitted_at
                if r.first_token_at is not None
                and r.submitted_at is not None else None)
        if ttft is not None:
            ttfts.append(ttft)
            if slo_ttft is not None and ttft <= slo_ttft:
                attained += 1
        tpot = ((r.finished_at - r.first_token_at) / (len(r.out) - 1)
                if r.first_token_at is not None
                and r.finished_at is not None and len(r.out) > 1
                else None)
        if tpot is not None:
            tpots.append(tpot)
        rec = {
            "rid": e["rid"], "kind": e["kind"],
            "priority": e.get("priority"), "arrival": e["at"],
            "submitted_at": r.submitted_at,
            "first_token_at": r.first_token_at,
            "finished_at": r.finished_at,
            "state": r.state, "ttft": ttft, "tpot": tpot,
            "generated": len(r.out),
        }
        if include_tokens:
            rec["tokens"] = [int(t) for t in r.tokens]
        per_request.append(rec)
    arr = np.asarray(ttfts) if ttfts else np.asarray([0.0])
    tarr = np.asarray(tpots) if tpots else np.asarray([0.0])
    return {
        "per_request": per_request,
        "steps": steps,
        "requests": len(entries),
        "slo_attainment": (attained / len(entries)
                           if slo_ttft is not None and entries else None),
        "ttft_p50": float(np.percentile(arr, 50)),
        "ttft_p95": float(np.percentile(arr, 95)),
        "ttft_p99": float(np.percentile(arr, 99)),
        "tpot_p50": float(np.percentile(tarr, 50)),
        "tpot_p95": float(np.percentile(tarr, 95)),
        "tpot_p99": float(np.percentile(tarr, 99)),
    }


def _parse_phases(spec: str) -> List[Tuple[float, float]]:
    """``"20:0.5,10:2,20:0.5"`` -> [(20, 0.5), (10, 2), (20, 0.5)]."""
    out = []
    for part in spec.split(","):
        dur, rate = part.split(":")
        out.append((float(dur), float(rate)))
    return out


def main(argv: List[str]) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="generate a replayable serving load trace")
    ap.add_argument("--seed", type=int, required=True,
                    help="explicit seed (no ambient randomness)")
    ap.add_argument("--mix", default="chat", choices=sorted(MIXES))
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--phases", default=None,
                    help="piecewise Poisson rates, e.g. 20:0.5,10:2")
    ap.add_argument("--vocab-size", type=int, default=128)
    ap.add_argument("--max-prompt-len", type=int, default=48)
    ap.add_argument("--out", default=None, help="trace JSON path")
    ap.add_argument("--summary", action="store_true")
    args = ap.parse_args(argv)
    reqs = make_requests(
        seed=args.seed, mix=args.mix, n=args.n,
        phases=_parse_phases(args.phases) if args.phases else None,
        vocab_size=args.vocab_size, max_prompt_len=args.max_prompt_len)
    if args.out:
        save_trace(args.out, reqs, seed=args.seed, mix=args.mix)
        print(f"wrote {len(reqs)} requests to {args.out}")
    if args.summary or not args.out:
        lens = [len(r["prompt"]) for r in reqs]
        print(json.dumps({
            "mix": args.mix, "seed": args.seed, "requests": len(reqs),
            "batch_frac": (sum(r["priority"] == "batch" for r in reqs)
                           / len(reqs)) if reqs else 0.0,
            "prompt_len_mean": float(np.mean(lens)) if lens else 0.0,
            "span": reqs[-1]["at"] - reqs[0]["at"] if reqs else 0.0,
        }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

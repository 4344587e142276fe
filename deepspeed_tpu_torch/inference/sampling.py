"""Per-request sampling for the continuous-batching slots.

Port of ``deepspeed_tpu/inference/sampling.py`` (the request knobs, the
slot-vectorized sampler and the host slot state). Greedy lanes
(temperature 0) take ``argmax`` of the fp32 logits, exactly as in JAX
(``torch.argmax`` also returns the first maximum), so greedy streams
match the JAX package token for token.

Sampled lanes run the same truncation pipeline as JAX: repetition
penalty -> temperature -> one descending argsort serving top-k and top-p
-> keep mask scattered back. The draw is the Gumbel-max form of a
categorical, with uniforms from a ``torch.Generator`` on the host seeded
as a pure function of (request seed, tokens generated so far): there is
no sequential generator state, so a stream survives eviction and requeue
exactly, and the host draw makes it the same on the CPU and on the card.
The bits cannot equal JAX's threefry ``fold_in`` chain, so a sampled
stream differs from the JAX package's; its distribution is the same.
:class:`HorizonDraws` draws a multi-step decode horizon's noise before
its loop and samples each step with the same operations as
:func:`sample_tokens`, so a horizon's streams are the one-step streams.
:func:`candidate_seed` (the seeds of an ``n > 1`` request's candidates)
is host numpy, bit for bit the JAX package's.

The fp64 Leviathan primitives (:func:`fp64_dist`, :func:`inverse_cdf`,
:func:`accept_prob`, :func:`residual_dist`, :func:`point_mass_residual`,
:func:`position_uniforms`, :func:`spec_verify_tokens`) are host numpy, a
copy of the JAX package's: the same inputs give the same bits. They hold
the accept/resample math of speculative decoding, static
(``inference/speculative.py``) and in serving (``inference/serving.py``).
"""

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

NEG_INF = -1e30
_U64 = (1 << 64) - 1


@dataclass(frozen=True)
class SamplingParams:
    """Resolved per-request sampling knobs. temperature=0 means greedy,
    and then every other knob is inert."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    repetition_penalty: float = 1.0

    def validate(self) -> "SamplingParams":
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), "
                             f"got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1] (1 = off), "
                             f"got {self.top_p}")
        if self.repetition_penalty <= 0.0:
            raise ValueError(f"repetition_penalty must be > 0, "
                             f"got {self.repetition_penalty}")
        return self

    @property
    def sampled(self) -> bool:
        return self.temperature > 0.0


def resolve_params(req, default_temperature: float = 0.0,
                   default_top_k: int = 0,
                   default_seed: int = 0) -> SamplingParams:
    """Per-request knobs win; engine-wide defaults fill the gaps (a
    request field of None means "engine default")."""
    def pick(v, d):
        return d if v is None else v
    return SamplingParams(
        temperature=float(pick(getattr(req, "temperature", None),
                               default_temperature)),
        top_k=int(pick(getattr(req, "top_k", None), default_top_k)),
        top_p=float(pick(getattr(req, "top_p", None), 1.0)),
        seed=int(pick(getattr(req, "seed", None), default_seed)),
        repetition_penalty=float(pick(
            getattr(req, "repetition_penalty", None), 1.0)),
    ).validate()


def candidate_seed(seed: int, index: int) -> int:
    """The seed of candidate ``index`` of an ``n > 1`` request:
    SeedSequence-mixed, so adjacent user seeds do not collide with
    adjacent candidate indices; candidate 0 keeps ``seed``."""
    if index == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed) & _U64, int(index)])
               .generate_state(1)[0])


def draw_seed(seed: int, position: int) -> int:
    """Generator seed for the token at generation index ``position`` of a
    request seeded ``seed``: SeedSequence-mixed, so neighbouring seeds and
    positions do not give related streams."""
    state = np.random.SeedSequence([int(seed) & _U64, int(position) & _U64])
    return int(state.generate_state(1, np.uint64)[0])


def gumbel_noise(seed: int, position: int, shape) -> torch.Tensor:
    """fp32 Gumbel noise of ``shape`` for one draw, made on the host."""
    gen = torch.Generator().manual_seed(draw_seed(seed, position))
    u = torch.rand(shape, generator=gen, dtype=torch.float64)
    return (-torch.log(-torch.log(u))).float()


def truncate(logits, temps, top_ks, top_ps, rep_pens, seen):
    """Masked, temperature-scaled logits of sampled lanes: repetition
    penalty on ``seen`` tokens, temperature, then top-k and top-p through
    one descending (stable) argsort; excluded tokens take NEG_INF.
    logits [n, V] fp32; the knobs are [n] tensors, seen [n, V] bool."""
    V = logits.shape[-1]
    pen = rep_pens[:, None]
    z = torch.where(seen, torch.where(logits > 0, logits / pen, logits * pen),
                    logits)
    z = z / temps[:, None]
    order = torch.argsort(-z, dim=-1, stable=True)
    z_sorted = torch.gather(z, -1, order)
    rank = torch.arange(V, device=z.device)[None, :]
    k = top_ks[:, None]
    keep = (k <= 0) | (rank < k)
    probs_sorted = torch.softmax(torch.where(keep, z_sorted, NEG_INF), dim=-1)
    csum = torch.cumsum(probs_sorted, dim=-1)
    # nucleus: keep ranks whose exclusive prefix mass is still under
    # top_p (the most probable token always survives)
    tp = torch.where(top_ps >= 1.0, torch.inf, top_ps)[:, None]
    keep = keep & ((csum - probs_sorted) < tp)
    keep[:, 0] = True
    keep = torch.gather(keep, -1, torch.argsort(order, dim=-1))
    return torch.where(keep, z, NEG_INF)


def sample_tokens(logits, seeds, positions, temps, top_ks, top_ps, rep_pens,
                  seen):
    """One token per slot from last-position ``logits`` [B, V].

    The knobs are slot-indexed host arrays: seeds [B] request seeds,
    positions [B] tokens generated so far, temps/top_ps/rep_pens [B]
    float, top_ks [B] int, seen [B, V] bool (tokens the repetition
    penalty applies to). Returns ``(tokens [B] int32, logprobs [B] fp32)``
    on the logits' device: the chosen token's log-probability under the
    truncated distribution, or under softmax(logits) for greedy lanes.
    Only the sampled lanes run the truncation and the draw."""
    lane = np.nonzero(np.asarray(temps) > 0.0)[0]
    if not len(lane):
        return _draw(logits, None, None, None)
    dev = logits.device

    def knob(a, dtype):
        return torch.as_tensor(np.asarray(a)[lane], dtype=dtype, device=dev)
    knobs = (knob(temps, torch.float32), knob(top_ks, torch.int64),
             knob(top_ps, torch.float32), knob(rep_pens, torch.float32))
    noise = torch.stack([gumbel_noise(int(seeds[i]), int(positions[i]),
                                      logits.shape[-1]) for i in lane])
    return _draw(logits, torch.as_tensor(lane, device=dev), knobs,
                 knob(seen, torch.bool), noise.to(dev))


def _draw(logits, idx, knobs, seen, noise=None):
    """Greedy argmax for every lane, then the truncated Gumbel-max draw
    for the sampled lanes ``idx`` (a device index, or None for none):
    ``knobs`` their (temps, top_ks, top_ps, rep_pens), ``seen`` their
    [n, V] penalty mask, ``noise`` their [n, V] Gumbel noise."""
    logits = logits.float()
    tokens = torch.argmax(logits, dim=-1)
    logprobs = torch.gather(torch.log_softmax(logits, dim=-1), -1,
                            tokens[:, None])[:, 0]
    if idx is not None:
        z = truncate(logits[idx], *knobs, seen)
        drawn = torch.argmax(z + noise, dim=-1)
        drawn_lp = torch.gather(torch.log_softmax(z, dim=-1), -1,
                                drawn[:, None])[:, 0]
        tokens[idx] = drawn
        logprobs[idx] = drawn_lp
    return tokens.to(torch.int32), logprobs


class HorizonDraws:
    """The sampling state of one decode horizon, on the device: the
    sampled lanes (fixed for the horizon), their knobs, the [B, V]
    repetition-penalty mask (``seen``, which the horizon marks as it
    emits) and the Gumbel noise of every step, drawn on the host before
    the loop for positions ``gen_count .. gen_count + budget - 1`` of
    each sampled lane (a lane's draws past its budget are dead and stay
    zero). :meth:`sample` then reads nothing back from the device.
    ``sample_state`` is :meth:`SlotSamplerState.lanes`."""

    def __init__(self, sample_state, n_steps: int, budgets, device):
        seeds, positions, temps, top_ks, top_ps, rep_pens, seen = \
            sample_state
        # a copy: the horizon marks it, the host state stays as it was
        self.seen = torch.tensor(np.asarray(seen, bool), device=device)
        lane = np.nonzero(np.asarray(temps) > 0.0)[0]
        self.idx = None
        if not len(lane):
            return
        V = self.seen.shape[1]

        def knob(a, dtype):
            return torch.as_tensor(np.asarray(a)[lane], dtype=dtype,
                                   device=device)
        self.idx = torch.as_tensor(lane, device=device)
        self.knobs = (knob(temps, torch.float32), knob(top_ks, torch.int64),
                      knob(top_ps, torch.float32),
                      knob(rep_pens, torch.float32))
        noise = torch.zeros((n_steps, len(lane), V), dtype=torch.float32)
        for j, b in enumerate(lane):
            for i in range(min(n_steps, int(budgets[b]))):
                noise[i, j] = gumbel_noise(int(seeds[b]),
                                           int(positions[b]) + i, V)
        self.noise = noise.to(device)

    def sample(self, logits, step: int, seen):
        """One token per slot from ``logits`` [B, V] at horizon step
        ``step``, under the penalty mask ``seen`` [B, V]: the operations
        of :func:`sample_tokens`."""
        if self.idx is None:
            return _draw(logits, None, None, None)
        return _draw(logits, self.idx, self.knobs, seen[self.idx],
                     self.noise[step])


class SlotSamplerState:
    """Slot-indexed host arrays of the sampling knobs. The scheduler owns
    one; rows are written at admission and cleared at release.
    ``lanes()`` packages them as the ``sample_state`` tuple the engine's
    slot programs take; ``params`` keeps each slot's ``SamplingParams``
    for the host-side (fp64) speculative verify."""

    def __init__(self, num_slots: int, vocab_size: int):
        self.num_slots = num_slots
        self.vocab_size = vocab_size
        self.seeds = np.zeros(num_slots, np.uint64)
        self.temps = np.zeros(num_slots, np.float32)
        self.top_ks = np.zeros(num_slots, np.int32)
        self.top_ps = np.ones(num_slots, np.float32)
        self.rep_pens = np.ones(num_slots, np.float32)
        self.seen = np.zeros((num_slots, vocab_size), bool)
        self.params: List[Optional[SamplingParams]] = [None] * num_slots

    def admit(self, slot: int, params: SamplingParams,
              tokens: Optional[Sequence[int]] = None) -> None:
        self.params[slot] = params
        self.seeds[slot] = int(params.seed) & _U64
        self.temps[slot] = params.temperature
        self.top_ks[slot] = params.top_k
        self.top_ps[slot] = params.top_p
        self.rep_pens[slot] = params.repetition_penalty
        self.seen[slot] = False
        if tokens is not None and params.repetition_penalty != 1.0:
            self.seen[slot, np.asarray(tokens, np.int64) % self.vocab_size] \
                = True

    def release(self, slot: int) -> None:
        self.params[slot] = None
        self.seeds[slot] = 0
        self.temps[slot] = 0.0
        self.top_ks[slot] = 0
        self.top_ps[slot] = 1.0
        self.rep_pens[slot] = 1.0
        self.seen[slot] = False

    def observe(self, slot: int, token: int) -> None:
        if self.rep_pens[slot] != 1.0:
            self.seen[slot, int(token) % self.vocab_size] = True

    def lanes(self, gen_counts) -> Tuple:
        """The slot-batched ``sample_state``: gen_counts [B] is each slot's
        tokens generated so far."""
        return (self.seeds, np.asarray(gen_counts, np.int64), self.temps,
                self.top_ks, self.top_ps, self.rep_pens, self.seen)

    def lane(self, slot: int, gen_count: int) -> Tuple:
        """Single-slot ``sample_state`` (the prefill path), each knob a
        length-1 array."""
        s = slice(slot, slot + 1)
        return (self.seeds[s], np.array([gen_count], np.int64),
                self.temps[s], self.top_ks[s], self.top_ps[s],
                self.rep_pens[s], self.seen[s])


def greedy_state(batch: int, vocab_size: int) -> Tuple:
    """All-greedy ``sample_state`` for callers that only want logits."""
    return (np.zeros(batch, np.uint64), np.zeros(batch, np.int64),
            np.zeros(batch, np.float32), np.zeros(batch, np.int32),
            np.ones(batch, np.float32), np.ones(batch, np.float32),
            np.zeros((batch, vocab_size), bool))


# ---------------------------------------------------------------------
# fp64 Leviathan primitives (host numpy, bit for bit the JAX package's)
# ---------------------------------------------------------------------
def fp64_dist(logits, temperature: float, top_k: int = 0,
              top_p: float = 1.0) -> np.ndarray:
    """[..., V] logits -> fp64 probabilities at ``temperature``,
    optionally top_k/top_p-truncated."""
    z = np.asarray(logits, np.float64) / temperature
    if top_k > 0:
        k_eff = min(top_k, z.shape[-1])
        kth = np.sort(z, axis=-1)[..., -k_eff, None]
        z = np.where(z < kth, -np.inf, z)
    z = z - z.max(-1, keepdims=True)
    e = np.exp(z)
    p = e / e.sum(-1, keepdims=True)
    if top_p < 1.0:
        p = nucleus_truncate(p, top_p)
    return p


def nucleus_truncate(p: np.ndarray, top_p: float) -> np.ndarray:
    """Zero everything outside the smallest probability-sorted prefix
    with cumulative mass >= top_p (the most probable token always
    survives), then renormalize."""
    order = np.argsort(-p, axis=-1, kind="stable")
    p_sorted = np.take_along_axis(p, order, axis=-1)
    csum = np.cumsum(p_sorted, axis=-1)
    keep_sorted = (csum - p_sorted) < top_p
    keep_sorted[..., 0] = True
    keep = np.take_along_axis(keep_sorted, np.argsort(order, axis=-1),
                              axis=-1)
    out = np.where(keep, p, 0.0)
    return out / out.sum(-1, keepdims=True)


def inverse_cdf(p, u):
    """Inverse-CDF draw from probabilities ``p`` [..., V] with uniform
    ``u`` (scalar or [...]): the first cumsum bin above ``u``, clamped to
    the last (rounding can leave cumsum[-1] < 1 below u)."""
    c = np.cumsum(np.asarray(p, np.float64), axis=-1)
    u = np.asarray(u, np.float64)
    while u.ndim < c.ndim:
        u = u[..., None]
    return np.minimum((u > c).sum(-1), c.shape[-1] - 1)


def accept_prob(px, qx):
    """Leviathan acceptance probability min(1, p(x)/q(x))."""
    return np.minimum(1.0, px / np.maximum(qx, 1e-300))


def residual_dist(p, q) -> np.ndarray:
    """Resample distribution after a rejection, norm(max(0, p - q)); p
    itself when the residual has no mass (p == q)."""
    res = np.maximum(0.0, np.asarray(p, np.float64)
                     - np.asarray(q, np.float64))
    tot = res.sum()
    return res / tot if tot > 0 else np.asarray(p, np.float64)


def point_mass_residual(p: np.ndarray, x: int) -> np.ndarray:
    """:func:`residual_dist` against a point mass at ``x`` (a
    deterministic drafter's q): p with x zeroed, renormalized."""
    res = np.asarray(p, np.float64).copy()
    res[x] = 0.0
    tot = res.sum()
    return res / tot if tot > 0 else np.asarray(p, np.float64)


def position_uniforms(seed: int, pos: int, n: int = 2) -> np.ndarray:
    """Counter-based uniforms for the token at generation index ``pos``
    of a request seeded ``seed`` (numpy Philox keyed by (seed, pos)): no
    sequential state, so eviction and requeue replay the same draws."""
    bits = np.random.Philox(key=[np.uint64(int(seed) & _U64),
                                 np.uint64(int(pos) & _U64)])
    return np.random.Generator(bits).random(n)


def spec_verify_tokens(p_rows, proposal, seed: int, pos0: int):
    """Leviathan verify of one slot's draft chunk from a deterministic
    drafter (q a point mass, so the acceptance probability is p(x)).
    p_rows: [k+1, V] fp64 target distributions, row j for generation
    index ``pos0 + j``; proposal: [k] draft tokens. Returns ``(tokens,
    logprobs, n_accepted)``: the accepted prefix plus one correction
    token (resampled from the residual at the first rejection) or bonus
    token (drawn from the row past the chunk); logprobs are log p of
    each token under its row."""
    toks, lps = [], []
    k = len(proposal)
    for j in range(k):
        x = int(proposal[j])
        u = position_uniforms(seed, pos0 + j, 2)
        px = float(p_rows[j][x])
        if u[0] < px:
            toks.append(x)
            lps.append(math.log(max(px, 1e-300)))
            continue
        res = point_mass_residual(p_rows[j], x)
        t = int(inverse_cdf(res, u[1]))
        toks.append(t)
        lps.append(math.log(max(float(p_rows[j][t]), 1e-300)))
        return toks, lps, j
    u = position_uniforms(seed, pos0 + k, 2)
    t = int(inverse_cdf(p_rows[k], u[0]))
    toks.append(t)
    lps.append(math.log(max(float(p_rows[k][t]), 1e-300)))
    return toks, lps, k

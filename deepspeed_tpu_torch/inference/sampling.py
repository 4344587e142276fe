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
"""

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

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
    logits = logits.float()
    tokens = torch.argmax(logits, dim=-1)
    logprobs = torch.gather(torch.log_softmax(logits, dim=-1), -1,
                            tokens[:, None])[:, 0]
    lane = np.nonzero(np.asarray(temps) > 0.0)[0]
    if len(lane):
        dev = logits.device

        def knob(a, dtype):
            return torch.as_tensor(np.asarray(a)[lane], dtype=dtype,
                                   device=dev)
        z = truncate(logits[lane], knob(temps, torch.float32),
                     knob(top_ks, torch.int64), knob(top_ps, torch.float32),
                     knob(rep_pens, torch.float32), knob(seen, torch.bool))
        noise = torch.stack([gumbel_noise(int(seeds[i]), int(positions[i]),
                                          logits.shape[-1]) for i in lane])
        drawn = torch.argmax(z + noise.to(dev), dim=-1)
        drawn_lp = torch.gather(torch.log_softmax(z, dim=-1), -1,
                                drawn[:, None])[:, 0]
        idx = torch.as_tensor(lane, device=dev)
        tokens[idx] = drawn
        logprobs[idx] = drawn_lp
    return tokens.to(torch.int32), logprobs


class SlotSamplerState:
    """Slot-indexed host arrays of the sampling knobs. The scheduler owns
    one; rows are written at admission and cleared at release.
    ``lanes()`` packages them as the ``sample_state`` tuple the engine's
    slot programs take."""

    def __init__(self, num_slots: int, vocab_size: int):
        self.num_slots = num_slots
        self.vocab_size = vocab_size
        self.seeds = np.zeros(num_slots, np.uint64)
        self.temps = np.zeros(num_slots, np.float32)
        self.top_ks = np.zeros(num_slots, np.int32)
        self.top_ps = np.ones(num_slots, np.float32)
        self.rep_pens = np.ones(num_slots, np.float32)
        self.seen = np.zeros((num_slots, vocab_size), bool)

    def admit(self, slot: int, params: SamplingParams,
              tokens: Optional[Sequence[int]] = None) -> None:
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

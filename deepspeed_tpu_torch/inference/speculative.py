"""Speculative decoding on the static cache: a small draft model
proposes, the target verifies a whole chunk in one step.

Port of ``deepspeed_tpu/inference/speculative.py`` (Leviathan et al.,
ICML 2023). Greedy (temperature 0): the output equals
``target.generate`` exactly. Sampled: draft token x is accepted with
probability min(1, p(x)/q(x)) and a rejection resamples from
norm(max(0, p - q)), so the output distribution equals sampling the
target alone; the draws come from ``np.random.default_rng(seed)``, as in
the JAX package, through the shared fp64 primitives of
``inference/sampling.py``.

The chunk verify is the engine's ``_extend_fn`` (``_block_extend``): the
static decode block for G query tokens. Cache positions past a partial
acceptance hold stale K/V; the next round writes them before any query
reads them.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.inference.sampling import (accept_prob, fp64_dist,
                                                    inverse_cdf,
                                                    residual_dist)


def _host(logits) -> np.ndarray:
    return logits.float().cpu().numpy()


def generate_speculative(target, draft, tokens, max_new_tokens: int = 32,
                         gamma: int = 4, temperature: float = 0.0,
                         top_k: int = 0, seed: int = 0,
                         return_stats: bool = False):
    """Speculative generation over two ``InferenceEngine``s of one
    vocabulary. tokens: [B, S] prompt (no padding mask). Returns [B,
    S + max_new_tokens] int32, and with ``return_stats`` a dict of
    ``rounds``, ``accepted_per_round``, ``target_steps`` and ``tokens``.
    The batch accepts in lockstep: each round takes the shortest accepted
    prefix of its rows. ``top_k`` truncates both p and q."""
    if target.cfg.vocab_size != draft.cfg.vocab_size:
        raise ValueError("speculative decoding needs a shared vocabulary: "
                         f"target {target.cfg.vocab_size}, draft "
                         f"{draft.cfg.vocab_size}")
    tokens = np.asarray(tokens, np.int32)
    B, S = tokens.shape
    if S + max_new_tokens + gamma + 1 > min(target.max_seq_len,
                                            draft.max_seq_len):
        raise ValueError("prompt + new tokens (+ a gamma-sized verify "
                         "margin) must fit both engines' caches")
    sampled = temperature > 0.0
    rng = np.random.default_rng(seed)
    V = target.cfg.vocab_size

    def dist(logits):
        return fp64_dist(logits, temperature, top_k=top_k)

    def draw(p):
        return inverse_cdf(p, rng.random((p.shape[0], 1))).astype(np.int32)

    def draw1(p):
        return int(inverse_cdf(p, rng.random()))

    def ids(engine, a):
        return torch.as_tensor(np.asarray(a, np.int64), device=engine.device)

    t_logits, t_cache = target._prefill_fn(ids(target, tokens))
    d_logits, d_cache = draft._prefill_fn(ids(draft, tokens))

    out = [tokens]
    first = _host(t_logits[:, -1])
    cur = draw(dist(first)) if sampled else first.argmax(-1).astype(np.int32)
    n_emitted = 1
    n_rounds = 0
    n_accepted_total = 0
    pos = S                       # next unwritten cache index, both caches

    while n_emitted <= max_new_tokens:
        g = int(min(gamma, max_new_tokens - n_emitted + 1))
        if g == 0:
            break
        # the draft proposes g tokens autoregressively
        proposal = np.zeros((B, g), np.int32)
        q_dists = np.zeros((g, B, V), np.float64) if sampled else None
        d_tok = cur
        for i in range(g):
            dl, d_cache = draft._decode_fn(d_cache, ids(draft, d_tok[:, None]),
                                           pos + i)
            if sampled:
                q_dists[i] = dist(_host(dl[:, -1]))
                d_tok = draw(q_dists[i])
            else:
                d_tok = _host(dl[:, -1]).argmax(-1).astype(np.int32)
            proposal[:, i] = d_tok
        # the target verifies [cur, d_1..d_g] in one step
        chunk = np.concatenate([cur[:, None], proposal], axis=1)
        tl, t_cache = target._extend_fn(t_cache, ids(target, chunk), pos)
        if sampled:
            p_dists = dist(_host(tl))
            rows = np.arange(B)
            accept = np.ones((B, g), bool)
            for i in range(g):
                px = p_dists[rows, i, proposal[:, i]]
                qx = q_dists[i][rows, proposal[:, i]]
                accept[:, i] = rng.random(B) < accept_prob(px, qx)
            first_bad = np.argmin(
                np.concatenate([accept, np.zeros((B, 1), bool)], axis=1),
                axis=1)
            n_acc = int(first_bad.min())
            nxt = np.zeros(B, np.int32)
            for b in range(B):
                if n_acc == g:
                    # full acceptance: the bonus token from p past the chunk
                    nxt[b] = draw1(p_dists[b, g])
                elif first_bad[b] == n_acc:
                    # a rejection here: resample from the residual
                    nxt[b] = draw1(residual_dist(p_dists[b, n_acc],
                                                 q_dists[n_acc][b]))
                else:
                    # this row accepted the draft token at the lockstep
                    # cut: emit it as it is (a fresh draw would bias)
                    nxt[b] = proposal[b, n_acc]
            cur_next = nxt
        else:
            greedy = _host(tl).argmax(-1).astype(np.int32)
            agree = greedy[:, :-1] == proposal
            first_bad = np.argmin(
                np.concatenate([agree, np.zeros((B, 1), bool)], axis=1),
                axis=1)
            n_acc = int(first_bad.min())
            cur_next = greedy[:, n_acc]   # the correction (or bonus) token
        emit = [cur[:, None]] + [proposal[:, i][:, None]
                                 for i in range(n_acc)]
        out.append(np.concatenate(emit, axis=1))
        cur = cur_next
        n_emitted += n_acc + 1
        pos += n_acc + 1
        n_rounds += 1
        n_accepted_total += n_acc
        if n_acc == g:
            # the draft proposed d_g but never consumed it: write its K/V
            # at pos - 1 so later proposals see no hole
            _, d_cache = draft._decode_fn(
                d_cache, ids(draft, proposal[:, g - 1][:, None]), pos - 1)
    result = np.concatenate(out + [cur[:, None]], axis=1)
    result = result[:, :S + max_new_tokens]
    if return_stats:
        return result, {"rounds": n_rounds,
                        "accepted_per_round": (n_accepted_total /
                                               max(1, n_rounds)),
                        "target_steps": n_rounds + 1,
                        "tokens": int(result.shape[1] - S)}
    return result

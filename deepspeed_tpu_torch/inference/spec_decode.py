"""Draft proposers for speculative decoding inside continuous batching.

Port of ``deepspeed_tpu/inference/spec_decode.py``. The serving
scheduler (``ServingEngine(spec_decode=True)`` or ``DS_SPEC_DECODE=on``)
asks a drafter for ``k`` candidate tokens per decoding slot each step,
verifies all ``k + 1`` positions in one ``InferenceEngine.verify_slots``
call and accepts the longest surviving prefix, so the drafter changes
latency only, never the output distribution.

The interface is one method::

    propose(context: np.ndarray[int], k: int) -> np.ndarray[int32, (k,)]

``context`` is the slot's prompt and everything generated so far (the
pending token included). Two drafters ship: :class:`NGramDraft`
(prompt lookup, the default, host numpy only) and :class:`ModelDraft`
(a second, smaller ``InferenceEngine`` whose static ``generate`` runs a
left-padded window; its prefill is the flash kernel K1-fwd on the card).
"""

from typing import Any, Optional

import numpy as np

from deepspeed_tpu_torch.utils.env import resolve_flag


def resolve_spec_decode(flag: Optional[bool] = None) -> bool:
    """The speculative-serving switch: an explicit argument wins, else
    ``DS_SPEC_DECODE``, else off."""
    return resolve_flag("DS_SPEC_DECODE", flag)


def resolve_spec_draft(spec: Optional[str] = None) -> str:
    """The drafter name: an explicit argument, else ``DS_SPEC_DRAFT``,
    else ``"ngram"``, the only named drafter."""
    if spec is None:
        spec = str(resolve_flag("DS_SPEC_DRAFT")).strip().lower()
    if spec != "ngram":
        raise ValueError(
            f"DS_SPEC_DRAFT={spec!r}: 'ngram' is the only named drafter "
            f"(pass a draft InferenceEngine or a propose()-bearing "
            f"object as spec_draft= for the model path)")
    return spec


def resolve_spec_k(k: Optional[int] = None) -> int:
    """Draft chunk length: an explicit argument, else ``DS_SPEC_K``, else
    4."""
    k = int(resolve_flag("DS_SPEC_K", k))
    if k < 1:
        raise ValueError(f"spec_k={k}: need at least one draft token")
    return k


class NGramDraft:
    """Prompt-lookup drafter: propose the continuation of the most recent
    earlier occurrence of the context's trailing n-gram, longest ``n``
    first (``max_ngram`` down to ``min_ngram``). Without a match it
    repeats the last token."""

    name = "ngram"

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"({min_ngram}, {max_ngram})")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, context, k: int) -> np.ndarray:
        ctx = np.asarray(context, np.int64).ravel()
        if ctx.size == 0:
            return np.zeros((k,), np.int32)
        for n in range(min(self.max_ngram, ctx.size - 1),
                       self.min_ngram - 1, -1):
            # candidate starts leave out the trailing n-gram itself
            L = ctx.size - n
            if L <= 0:
                continue
            pat = ctx[-n:]
            win = np.lib.stride_tricks.sliding_window_view(ctx, n)[:L]
            hits = np.flatnonzero((win == pat).all(axis=1))
            if hits.size:
                s = int(hits[-1])            # most recent occurrence
                cont = ctx[s + n:s + n + k]
                out = np.empty((k,), np.int64)
                out[:cont.size] = cont
                out[cont.size:] = cont[-1] if cont.size else ctx[-1]
                return out.astype(np.int32)
        return np.full((k,), ctx[-1], np.int32)


class ModelDraft:
    """Draft-model proposer over a second ``InferenceEngine``: the greedy
    k-token continuation of a fixed-width, left-padded window of the
    context, through the draft's static ``generate`` with its
    ``attention_mask``."""

    name = "model"

    def __init__(self, engine, window: int = 64):
        self.engine = engine
        self.window = int(window)

    def propose(self, context, k: int) -> np.ndarray:
        ctx = np.asarray(context, np.int32).ravel()[-self.window:]
        W = self.window
        if W + k > self.engine.max_seq_len:
            raise ValueError(
                f"draft window {W} + k {k} exceeds the draft engine's "
                f"max_seq_len {self.engine.max_seq_len}")
        toks = np.zeros((1, W), np.int32)
        toks[0, W - ctx.size:] = ctx
        mask = np.zeros((1, W), np.float32)
        mask[0, W - ctx.size:] = 1.0
        out = self.engine.generate(toks, max_new_tokens=k,
                                   attention_mask=mask)
        return np.asarray(out[0, W:W + k], np.int32)


def make_draft(spec: Any = None) -> Any:
    """The drafter for ``ServingEngine(spec_draft=)``: None or a name
    resolves by name (``DS_SPEC_DRAFT``), an object with ``propose`` is
    used as it is, an engine (anything with ``generate``) is wrapped in
    :class:`ModelDraft`."""
    if spec is None or isinstance(spec, str):
        resolve_spec_draft(spec)
        return NGramDraft()
    if hasattr(spec, "propose"):
        return spec
    if hasattr(spec, "generate"):
        return ModelDraft(spec)
    raise ValueError(
        f"spec_draft={spec!r}: expected 'ngram', a draft "
        f"InferenceEngine, or an object with propose(context, k)")

"""Chunked softmax cross-entropy: the vocabulary projection and the loss in
one op that never holds the ``[N, V]`` logits.

Port of ``deepspeed_tpu/ops/cross_entropy.py``. The forward walks the
tokens in chunks and keeps, per token, only the log-sum-exp and the gold
logit; the backward recomputes each chunk's logits and accumulates the
vocabulary-weight gradient in fp32. The products contract in the input
dtype (a bf16 product's result is rounded to bf16 before it is widened,
as the dense loss path's logits are); the statistics and the ``dw``/``db``
accumulators are fp32; ``dlogits`` is cast to the weight dtype for the two
backward products. The JAX package leaves these products to XLA, so they are plain
``torch.matmul`` here: no kernel of the port's own.
"""

from typing import Optional

import torch

__all__ = ["softmax_xent_ll", "chunked_softmax_xent"]


def _chunk_logits(xc, w, b):
    """[C, H] @ [V, H]^T (+ b) -> fp32 [C, V]."""
    logits = (xc @ w.t()).float()
    if b is not None:
        logits = logits + b.float()
    return logits


class _XentLL(torch.autograd.Function):
    """Per-token log-likelihood over ``N = k * chunk`` rows; keeps x, w, b,
    the targets and the per-row log-sum-exp for the backward."""

    @staticmethod
    def forward(ctx, x, w, b, t, chunk):
        N = x.shape[0]
        ll = torch.empty(N, dtype=torch.float32, device=x.device)
        lse = torch.empty(N, dtype=torch.float32, device=x.device)
        for lo in range(0, N, chunk):
            logits = _chunk_logits(x[lo:lo + chunk], w, b)
            lse_c = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(1, t[lo:lo + chunk, None])[:, 0]
            ll[lo:lo + chunk] = gold - lse_c
            lse[lo:lo + chunk] = lse_c
        ctx.save_for_backward(x, w, b, t, lse)
        ctx.chunk = chunk
        return ll

    @staticmethod
    def backward(ctx, g):
        x, w, b, t, lse = ctx.saved_tensors
        chunk = ctx.chunk
        N = x.shape[0]
        g = g.float()
        dx = torch.empty_like(x)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=x.device)
        db = None if b is None else torch.zeros(
            b.shape, dtype=torch.float32, device=x.device)
        for lo in range(0, N, chunk):
            xc = x[lo:lo + chunk]
            logits = _chunk_logits(xc, w, b)
            # d loss / d logits = g * (onehot - softmax), in place on p
            dlog = torch.exp(logits - lse[lo:lo + chunk, None]).neg_()
            dlog.scatter_add_(1, t[lo:lo + chunk, None],
                              torch.ones_like(dlog[:, :1]))
            dlog.mul_(g[lo:lo + chunk, None])
            dlb = dlog.to(w.dtype)
            dx[lo:lo + chunk] = (dlb @ w).to(x.dtype)       # [C, V] @ [V, H]
            dw += (dlb.t() @ xc).float()                    # [V, C] @ [C, H]
            if db is not None:
                db += dlog.sum(0)
        return (dx, dw.to(w.dtype), None if b is None else db.to(b.dtype),
                None, None)


def softmax_xent_ll(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    chunk: int = 2048) -> torch.Tensor:
    """Per-token log-likelihood without the logits matrix:
    ``ll[i] = logits[i, targets[i]] - logsumexp(logits[i])`` with
    ``logits = x @ w.T (+ bias)``.

    x: ``[..., H]`` activations; w: ``[V, H]`` (the ``wte`` layout; pass
    ``kernel.T`` for an ``[H, V]`` head); targets: ``[...]`` integer ids;
    chunk: tokens per step, so the extra memory is about ``chunk * V``
    fp32. A divisor of N at least half the requested chunk is preferred;
    otherwise N is padded with zero rows, whose gradient is zero. Returns
    fp32 with the shape of ``targets``."""
    lead = targets.shape
    H = x.shape[-1]
    x2 = x.reshape(-1, H)
    t2 = targets.reshape(-1).long()
    N = x2.shape[0]
    c = int(min(chunk, N))
    div = next((d for d in range(c, 0, -1) if N % d == 0), 1)
    if div >= c // 2:
        c = div
    pad = (-N) % c
    if pad:
        x2 = torch.cat([x2, x2.new_zeros((pad, H))])
        t2 = torch.cat([t2, t2.new_zeros((pad,))])
    ll = _XentLL.apply(x2, w, bias, t2, c)
    return ll[:N].reshape(lead)


def chunked_softmax_xent(x, w, targets, bias=None, chunk: int = 2048,
                         loss_mask=None) -> torch.Tensor:
    """Masked-mean negative log-likelihood over ``targets`` (fp32 scalar)."""
    ll = softmax_xent_ll(x, w, targets, bias=bias, chunk=chunk)
    if loss_mask is not None:
        return -(ll * loss_mask).sum() / loss_mask.sum().clamp_min(1.0)
    return -ll.mean()

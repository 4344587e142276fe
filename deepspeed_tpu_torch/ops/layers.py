"""Building blocks shared by the models (``models.gpt``, ``models.bert``)
and the encoder layer (``ops.transformer.encoder_layer``): layernorm,
dense projections (float or weight-only int8), dropout, and the
per-layer activation checkpointing that keeps what a remat policy names.

A checkpointed layer runs under a :class:`Tape`: its forward records the
tensors the policy keeps (the ``qkv`` and ``mlp_pre`` projections, the
flash output and log-sum-exp), and the backward's rerun replays them
(:class:`RematBlock`).
"""

from typing import Callable, Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.int8_matmul import int8_matmul
from deepspeed_tpu_torch.parallel.tensor import (TP_SERVING_FEATURES,
                                                 reduce_from_model)
from deepspeed_tpu_torch.tree import tree_unflatten

REMAT_POLICIES = ("selective", "flash_only", "full")


def layernorm(x, scale, bias, eps=1e-5):
    """Layernorm over the last axis with population variance and
    ``rsqrt``; statistics in fp32, the result in x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


class Tape:
    """What one checkpointed layer keeps between its forward and its
    backward, by name. The forward records the named tensors of ``keep``;
    the backward's rerun of the layer replays them: a kept projection is
    not multiplied again and a kept flash output does not rerun the
    forward kernel, while gradients still flow through both."""

    def __init__(self, keep, saved: Optional[Dict] = None):
        self.keep = keep             # of "qkv", "mlp_pre", "flash"
        self.replay = saved is not None
        self.saved = saved if saved is not None else {}


class _KnownDense(torch.autograd.Function):
    """``h @ kernel + bias`` whose value ``y`` is already known: the
    forward returns it, the backward is the projection's own."""

    @staticmethod
    def forward(ctx, h, kernel, bias, y):
        ctx.save_for_backward(h, kernel)
        ctx.has_bias = bias is not None
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        h, kernel = ctx.saved_tensors
        g2, h2 = g.reshape(-1, g.shape[-1]), h.reshape(-1, h.shape[-1])
        return (g @ kernel.t(), h2.t() @ g2,
                g2.sum(0) if ctx.has_bias else None, None)


def kernel_of(p, dtype):
    """The weight of a dense entry in ``dtype``: ``{"kernel"}``, or a
    weight-only int8 entry ``{"q": int8, "scale": fp32 per output
    channel}`` (``inference/engine.py quantize_weights_int8``)
    dequantized."""
    if "q" in p:
        return p["q"].to(dtype) * p["scale"].to(dtype)
    return p["kernel"].to(dtype)


def dense(h, p, tape: Optional[Tape] = None, name: Optional[str] = None,
          lora=None, reduce=None):
    """h @ kernel (+ bias when the entry has one). An int8 entry
    (``{"q", "scale"}``, serving only) goes through :func:`int8_matmul`:
    the K4 kernel on the card, the dequantize-then-multiply on the host.
    As in the JAX package's ``gpt._dense``, the LoRA terms come between
    the base product and the bias:

    - an entry adapted by ``runtime/lora.py`` (``lora_a``, ``lora_b``,
      ``lora_scale``) adds ``(h @ A) @ B * scale``, the delta never formed;
    - ``lora``, the serving hook (``inference/adapters.py``): each slot's
      gathered adapter factors ``(a [B, in, K], b [B, K, out])``, the JAX
      hook's ``(a_blk [B, NBa, in, rb], b_blk [B, NBa, rb, out])`` with the
      rank-block axis folded into ``K = NBa * rb`` by the engine's gather
      (the sum over blocks and ranks is one contraction) and the scale
      folded into ``b``; a base-only slot's factors are zeros, so it adds
      exactly +0.0.

    Under a checkpointed layer's tape the projection called ``name`` is
    recorded or replayed (the tape knows no LoRA term: adapter training
    waits for its slice).

    Tensor parallelism (``parallel/tensor.py``): a column-parallel entry is
    this rank's columns (an int8 entry's scale split with them) and needs
    nothing here; ``reduce``, the model group of a row-parallel entry
    (this rank's rows, an int8 entry's scale whole), sums the partial
    products over the group before the bias is added once. The product of
    a row piece by the whole per-column scale is the partial sum scaled,
    so the int8 form sums as the float one does."""
    b = p.get("bias")
    kept = False
    if "q" in p:
        y = int8_matmul(h.reshape(-1, h.shape[-1]), p["q"], p["scale"])
        y = y.reshape(*h.shape[:-1], y.shape[-1])
    else:
        kept = tape is not None and name in tape.keep
        if kept and tape.replay:
            return _KnownDense.apply(h, p["kernel"], b, tape.saved[name])
        y = h @ p["kernel"]
    if reduce is not None:
        if "lora_a" in p or lora is not None:
                raise NotImplementedError(
                f"LoRA terms on a row-parallel layer wait for "
                f"{TP_SERVING_FEATURES}")
        y = reduce_from_model(y, reduce)
    if "lora_a" in p:
        y = y + (h @ p["lora_a"].to(h.dtype)) @ p["lora_b"].to(h.dtype) \
            * p["lora_scale"].to(h.dtype)
    if lora is not None:
        # two batched products, the second adding into y (a fresh tensor,
        # so in place): no other call
        y = y.baddbmm_(torch.bmm(h, lora[0]), lora[1])
    y = y if b is None else y + b
    if kept:
        tape.saved[name] = y
    return y


def dropout(x, rate: float, seed: int):
    """Inverted dropout from a ``torch.Generator`` seeded with ``seed`` on
    x's device: the kept entries are scaled by ``1 / (1 - rate)``. The
    generator's bits are not the JAX package's, so only the keep rate and
    the scaling carry over."""
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def rank_seed(seed: int, rank: int) -> int:
    """A dropout seed drawn alike on every data-parallel rank, made this
    rank's own (rank 0 keeps it), so that the ranks' masks differ while
    the generator they drew it from stays in step."""
    if not rank:
        return int(seed)
    return (int(seed) * 6364136223846793005
            + int(rank) * 1442695040888963407) % (1 << 62)


def remat_keep(policy: str, flash: bool) -> Tuple[str, ...]:
    """Names a checkpointed layer keeps beside its input under ``policy``
    (the JAX package's ``remat_policy(name, flash)``); ``flash``: whether
    the layer's attention runs the flash kernels, whose output and
    log-sum-exp ``"flash"`` then names."""
    if policy == "offload_flash":
        raise NotImplementedError(
            "remat_policy='offload_flash' (flash residuals in pinned host "
            "memory) waits for the memory-tier slice")
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r} "
                         f"(expected one of {REMAT_POLICIES} or "
                         f"'offload_flash')")
    if policy == "full":
        return ()
    return (("flash",) if flash else ()) + \
        (("qkv", "mlp_pre") if policy == "selective" else ())


class RematBlock(torch.autograd.Function):
    """A layer that keeps only its input, its weights and what the tape's
    policy names; the backward reruns the layer with the kept tensors
    replayed and differentiates the rerun. ``run(x, params, tape)`` is the
    layer; ``like`` is the tree ``leaves`` unflatten into."""

    @staticmethod
    def forward(ctx, run: Callable, keep, like, x, *leaves):
        tape = Tape(keep)
        with torch.no_grad():
            y = run(x, tree_unflatten(like, leaves), tape)
        names = sorted(tape.saved)
        ctx.save_for_backward(x, *leaves, *(tape.saved[n] for n in names))
        ctx.run, ctx.keep, ctx.like, ctx.names = run, keep, like, names
        ctx.n_leaves = len(leaves)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, *rest = ctx.saved_tensors
        leaves, kept = rest[:ctx.n_leaves], rest[ctx.n_leaves:]
        saved = dict(zip(ctx.names, kept))
        x = x.detach().requires_grad_()
        leaves = [t.detach().requires_grad_() for t in leaves]
        with torch.enable_grad():
            y = ctx.run(x, tree_unflatten(ctx.like, leaves),
                        Tape(ctx.keep, saved))
        grads = torch.autograd.grad(y, [x, *leaves], gy)
        return (None, None, None) + tuple(grads)

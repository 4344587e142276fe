"""Adam / AdamW over the parameter dict.

Port of ``deepspeed_tpu/ops/adam.py``: the JAX package's optax-style
transforms become plain functions that update a nested dict of tensors in
place (PyTorch's idiom; nothing here is a ``torch.optim`` class). Kept from
the JAX package: the Adam arithmetic in fp32 with the moments stored in
``state_dtype`` (bf16 moments are the memory-efficient mode), AdamW's
decoupled decay after the Adam scaling and L2 decay before it, a schedule
or a float learning rate, and the stochastic-rounding update of bf16
master weights. A handful of elementwise passes bound by bytes: the JAX
package has no Pallas kernel here, so the port has none. Adam and Adagrad
work element by element, so across data-parallel ranks (ZeRO >= 1) each
rank steps its slices of the leaves with its slices of the state, and
the result is the whole leaves' step.

The stochastic-rounding noise comes from a ``torch.Generator``; its bits
are not those of ``jax.random``, so the tests hand both packages the same
explicit bits.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import torch

from deepspeed_tpu_torch.tree import tree_leaves, tree_map

ScheduleOrFloat = Union[float, Callable[[int], float]]
STEP_CHUNK = 1 << 24       # elements of a leaf updated at a time


def init_adam_state(params: Dict, state_dtype: Optional[torch.dtype] = None
                    ) -> Dict:
    """``{"count": 0, "mu": zeros, "nu": zeros}``; the moments take
    ``state_dtype`` or each parameter's own dtype."""
    def zeros(p):
        return torch.zeros_like(p, dtype=state_dtype or p.dtype)
    return {"count": 0, "mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params)}


def scale_by_adam(grad: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                  count: int, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8, eps_root: float = 0.0) -> torch.Tensor:
    """One leaf of the Adam scaling. ``count`` is the step being taken
    (1 for the first). The moments are advanced in fp32 and written back
    to ``mu``/``nu`` in their storage dtype; the returned fp32 update
    ``(m / bc1) / (sqrt(v / bc2 + eps_root) + eps)`` uses the unrounded
    fp32 moments."""
    g = grad.float()
    m = (mu.float() * b1).add_(g, alpha=1 - b1)
    v = (nu.float() * b2).addcmul_(g, g, value=1 - b2)
    mu.copy_(m)
    nu.copy_(v)
    bc1 = 1 - b1 ** count
    bc2 = 1 - b2 ** count
    denom = v.div_(bc2).add_(eps_root).sqrt_().add_(eps)
    return m.div_(bc1).div_(denom)


def stochastic_round_bf16(x: torch.Tensor,
                          noise: Union[torch.Generator, torch.Tensor]
                          ) -> torch.Tensor:
    """fp32 -> bf16 by adding 16 uniform random low bits and truncating:
    unbiased in expectation, so an update smaller than one bf16 ulp still
    lands with probability update/ulp. ``noise`` is a ``torch.Generator``
    on x's device, or an integer tensor of x's shape whose low 16 bits are
    used (the tests' way to feed the JAX function's bits)."""
    bits = x.float().contiguous().view(torch.int32)
    if isinstance(noise, torch.Generator):
        low = torch.randint(0, 1 << 16, bits.shape, generator=noise,
                            device=bits.device, dtype=torch.int32)
    else:
        low = (noise.to(torch.int64) & 0xFFFF).to(torch.int32)
    # two's-complement addition wraps as the unsigned one does; with the
    # low half cleared the fp32 -> bf16 conversion is exact
    summed = (bits + low) & -65536
    return summed.view(torch.float32).to(torch.bfloat16)


def sr_apply_updates(params: Dict, updates: Dict, gen: torch.Generator
                     ) -> None:
    """``params += updates`` in place: stochastic rounding into bf16
    leaves, the plain fp32 add (cast to the leaf's dtype) elsewhere."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        s = p.float() + u.float()
        p.copy_(stochastic_round_bf16(s, gen) if p.dtype == torch.bfloat16
                else s)


@dataclass
class FusedAdam:
    """What :func:`fused_adam` returns: the hyperparameters, with ``init``
    for the state and ``step`` for one in-place update."""
    learning_rate: ScheduleOrFloat
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    adam_w_mode: bool = True
    state_dtype: Optional[torch.dtype] = None

    def init(self, params: Dict) -> Dict:
        return init_adam_state(params, self.state_dtype)

    def lr(self, count: int) -> float:
        """Learning rate of the update that follows ``count`` updates."""
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def step(self, params: Dict, grads: Dict, state: Dict,
             sr_gen: Optional[torch.Generator] = None) -> None:
        """One update of ``params`` and ``state`` in place. With ``sr_gen``
        the sum is rounded stochastically into bf16 leaves
        (:func:`sr_apply_updates`); without, it is cast to each leaf's
        dtype. A leaf is updated ``STEP_CHUNK`` elements at a time, so the
        fp32 temporaries stay small beside the stacked ``[L, ...]`` leaves
        of a deep model."""
        lr = self.lr(state["count"])
        state["count"] += 1
        wd = self.weight_decay
        for leaf in zip(*(tree_leaves(t) for t in (
                params, grads, state["mu"], state["nu"]))):
            p_, g_, mu_, nu_ = leaf
            # in-place targets must be views of their leaves
            flat = (p_.view(-1), g_.reshape(-1), mu_.view(-1), nu_.view(-1))
            for p, g, mu, nu in zip(*(t.split(STEP_CHUNK) for t in flat)):
                if wd > 0.0 and not self.adam_w_mode:
                    g = g + p * wd                  # L2: decay joins the gradient
                u = scale_by_adam(g, mu, nu, state["count"], self.b1,
                                  self.b2, self.eps)
                if wd > 0.0 and self.adam_w_mode:
                    u = u.add_(p * wd)              # AdamW: after the scaling
                s = u.mul_(-lr).add_(p)
                p.copy_(stochastic_round_bf16(s, sr_gen)
                        if sr_gen is not None and p.dtype == torch.bfloat16
                        else s)


def fused_adam(learning_rate: ScheduleOrFloat, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
               adam_w_mode: bool = True,
               state_dtype: Optional[torch.dtype] = None) -> FusedAdam:
    """FusedAdam equivalent. ``adam_w_mode=True``: decoupled weight decay
    (AdamW); ``False``: L2 decay added to the gradient.
    ``state_dtype=torch.bfloat16``: memory-efficient moments."""
    return FusedAdam(learning_rate, b1, b2, eps, weight_decay, adam_w_mode,
                     state_dtype)


@dataclass
class Adagrad:
    """What :func:`adagrad` returns: the hyperparameters, with ``init``
    for the state (the running sum of squared gradients) and ``step`` for
    one in-place update."""
    learning_rate: ScheduleOrFloat
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params: Dict) -> Dict:
        return {"count": 0, "sum_of_squares": tree_map(torch.zeros_like,
                                                       params)}

    def lr(self, count: int) -> float:
        """Learning rate of the update that follows ``count`` updates."""
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def step(self, params: Dict, grads: Dict, state: Dict,
             sr_gen: Optional[torch.Generator] = None) -> None:
        """``g += wd * p``; ``s += g * g``; ``p -= lr * g / sqrt(s + eps)``
        where ``s > 0`` (no step where it is 0), in place. Adagrad keeps
        fp32 masters, so ``sr_gen`` must be None."""
        if sr_gen is not None:
            raise ValueError("Adagrad has no stochastic-rounding bf16 update")
        lr = self.lr(state["count"])
        state["count"] += 1
        wd = self.weight_decay
        for p_, g_, s_ in zip(*(tree_leaves(t) for t in (
                params, grads, state["sum_of_squares"]))):
            flat = (p_.view(-1), g_.reshape(-1), s_.view(-1))
            for p, g, s in zip(*(t.split(STEP_CHUNK) for t in flat)):
                g = g.float()
                if wd > 0.0:
                    g = g + p * wd
                s.addcmul_(g, g)
                inv = torch.where(s > 0, torch.rsqrt(s + self.eps),
                                  torch.zeros_like(s))
                p.copy_(p - lr * (inv * g))


def adagrad(learning_rate: ScheduleOrFloat, eps: float = 1e-8,
            weight_decay: float = 0.0) -> Adagrad:
    """Adagrad as the JAX package composes it (``deepspeed_tpu/ops/
    adam.py adagrad``): decayed weights added to the gradient, optax's
    ``scale_by_rss`` with a zero initial accumulator, then the learning
    rate."""
    return Adagrad(learning_rate, eps, weight_decay)

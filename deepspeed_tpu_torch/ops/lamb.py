"""LAMB over the parameter dict.

Port of ``deepspeed_tpu/ops/lamb.py`` (``scale_by_lamb_trust_ratio`` and
``fused_lamb``, the reference's fused LAMB): Adam moments in fp32 with
bias correction, the weight decay added to the update inside the trust
ratio, and one trust ratio ``||w|| / ||update||`` per leaf, clamped to
``[min_coeff, max_coeff]`` (1.0 where either norm is 0), then the
learning rate. A leaf is one tensor of the tree: a stacked ``block`` leaf
holds every layer, so its norms run over all layers at once, as in the
JAX package (a ratio per layer would be another optimizer). The update is
applied in place. The JAX package has no Pallas kernel here, so the port
has none: a few reductions and elementwise passes bound by bytes.
"""

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from deepspeed_tpu_torch.ops.adam import ScheduleOrFloat, init_adam_state
from deepspeed_tpu_torch.tree import tree_leaves


def scale_by_lamb_trust_ratio(grad: torch.Tensor, param: torch.Tensor,
                              mu: torch.Tensor, nu: torch.Tensor, count: int,
                              b1: float = 0.9, b2: float = 0.999,
                              eps: float = 1e-6, weight_decay: float = 0.0,
                              max_coeff: float = 10.0,
                              min_coeff: float = 0.01) -> torch.Tensor:
    """One leaf of the LAMB scaling: advances ``mu``/``nu`` in place
    (``count`` is the step being taken, 1 for the first) and returns the
    fp32 update ``trust * ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p)``,
    before the learning rate."""
    g = grad.float()
    mu.mul_(b1).add_(g, alpha=1 - b1)
    nu.mul_(b2).addcmul_(g, g, value=1 - b2)
    bc1 = 1 - b1 ** count
    bc2 = 1 - b2 ** count
    update = (mu / bc1) / ((nu / bc2).sqrt_().add_(eps))
    p = param.float()
    if weight_decay > 0.0:
        update.add_(p, alpha=weight_decay)
    w_norm = torch.linalg.vector_norm(p)
    u_norm = torch.linalg.vector_norm(update)
    trust = torch.where((w_norm > 0) & (u_norm > 0),
                        (w_norm / u_norm).clamp(min_coeff, max_coeff),
                        torch.ones_like(w_norm))
    return update.mul_(trust)


@dataclass
class FusedLamb:
    """What :func:`fused_lamb` returns: the hyperparameters, with ``init``
    for the state (fp32 moments) and ``step`` for one in-place update."""
    learning_rate: ScheduleOrFloat
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-6
    weight_decay: float = 0.0
    max_coeff: float = 10.0
    min_coeff: float = 0.01

    def init(self, params: Dict) -> Dict:
        return init_adam_state(params, torch.float32)

    def lr(self, count: int) -> float:
        """Learning rate of the update that follows ``count`` updates."""
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def step(self, params: Dict, grads: Dict, state: Dict,
             sr_gen: Optional[torch.Generator] = None) -> None:
        """One update of ``params`` and ``state`` in place. LAMB keeps
        fp32 masters (the engine refuses ``bf16.memory_efficient`` with
        it), so ``sr_gen`` must be None."""
        if sr_gen is not None:
            raise ValueError("LAMB has no stochastic-rounding bf16 update")
        lr = self.lr(state["count"])
        state["count"] += 1
        for p, g, mu, nu in zip(*(tree_leaves(t) for t in (
                params, grads, state["mu"], state["nu"]))):
            u = scale_by_lamb_trust_ratio(
                g, p, mu, nu, state["count"], self.b1, self.b2, self.eps,
                self.weight_decay, self.max_coeff, self.min_coeff)
            p.copy_(u.mul_(-lr).add_(p))


def fused_lamb(learning_rate: ScheduleOrFloat, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-6,
               weight_decay: float = 0.0, max_coeff: float = 10.0,
               min_coeff: float = 0.01) -> FusedLamb:
    """FusedLamb equivalent: the LAMB scaling, then the learning rate."""
    return FusedLamb(learning_rate, b1, b2, eps, weight_decay, max_coeff,
                     min_coeff)

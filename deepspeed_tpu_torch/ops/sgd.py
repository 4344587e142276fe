"""SGD with momentum and Nesterov momentum over the parameter dict.

Port of the JAX engine's ``sgd`` (``deepspeed_tpu/runtime/engine.py
_configure_basic_optimizer``: ``optax.trace(momentum, nesterov)`` then the
scheduled learning rate): ``t = g + momentum * t``; the update is ``t``,
or ``g + momentum * t`` with Nesterov; ``p -= lr * update``. The trace is
kept in the parameters' dtype (fp32 masters), also at momentum 0, as
optax keeps it. Elementwise passes bound by bytes: the JAX package has no
Pallas kernel here, so the port has none.
"""

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from deepspeed_tpu_torch.ops.adam import STEP_CHUNK, ScheduleOrFloat
from deepspeed_tpu_torch.tree import tree_leaves, tree_map


@dataclass
class SGD:
    """What :func:`sgd` returns: the hyperparameters, with ``init`` for
    the state (the momentum trace) and ``step`` for one in-place
    update."""
    learning_rate: ScheduleOrFloat
    momentum: float = 0.0
    nesterov: bool = False

    def init(self, params: Dict) -> Dict:
        return {"count": 0, "trace": tree_map(torch.zeros_like, params)}

    def lr(self, count: int) -> float:
        """Learning rate of the update that follows ``count`` updates."""
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def step(self, params: Dict, grads: Dict, state: Dict,
             sr_gen: Optional[torch.Generator] = None) -> None:
        """One update of ``params`` and ``state`` in place. SGD keeps fp32
        masters, so ``sr_gen`` must be None."""
        if sr_gen is not None:
            raise ValueError("SGD has no stochastic-rounding bf16 update")
        lr = self.lr(state["count"])
        state["count"] += 1
        mom = self.momentum
        for p_, g_, t_ in zip(*(tree_leaves(t) for t in (
                params, grads, state["trace"]))):
            flat = (p_.view(-1), g_.reshape(-1), t_.view(-1))
            for p, g, t in zip(*(x.split(STEP_CHUNK) for x in flat)):
                g = g.to(t.dtype)
                t.mul_(mom).add_(g)
                u = g + mom * t if self.nesterov else t
                p.copy_(p - lr * u)


def sgd(learning_rate: ScheduleOrFloat, momentum: float = 0.0,
        nesterov: bool = False) -> SGD:
    """SGD equivalent of the JAX engine's ``sgd`` optimizer."""
    return SGD(learning_rate, momentum, nesterov)

"""Progressive layer drop (PLD, arXiv:2010.13369).

Port of ``deepspeed_tpu/runtime/progressive_layer_drop.py``: the global
keep probability ``theta(t) = (1 - theta) * exp(-gamma * t) + theta``
decays from 1 toward ``theta`` with the applied-step counter ``t``; the
model keeps layer ``l`` of ``L`` with probability
``1 - (l / L) * (1 - theta(t))`` (``models/gpt.py forward``). The engine
puts ``theta(t)`` into each micro batch under :data:`PLD_THETA_KEY` and
keeps a host mirror here for reporting.
"""

import math

from deepspeed_tpu_torch.utils.logging import logger

PLD_THETA_KEY = "pld_theta"


def theta_schedule(global_step: int, theta: float, gamma: float) -> float:
    """``theta(t) = (1 - theta) * exp(-gamma * t) + theta``."""
    return (1.0 - theta) * math.exp(-gamma * float(global_step)) + theta


class ProgressiveLayerDrop:
    """Host mirror of the schedule, for reporting and checkpoints."""

    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0
        logger.info(f"Enabled progressive layer dropping (theta = {theta})")

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self) -> float:
        return self.current_theta

    def update_state(self, global_step: int) -> None:
        self.current_theta = theta_schedule(global_step, self.theta,
                                            self.gamma)

"""Static and dynamic loss scaling. Port of
``deepspeed_tpu/runtime/loss_scaler.py``: the same state machine
(hysteresis before a cut, growth after a window of good steps, a floor), as
plain functions of a small state object, which the engine keeps on the
host. Across data-parallel ranks the engine's overflow flag is every
rank's (one all-reduce, ``runtime/zero/partition.py step_metrics``): an
overflow on any rank's rows skips the step on every rank, and each rank
moves the same state through :func:`update`, so the scale stays equal
across ranks."""

from dataclasses import dataclass, replace
from typing import Dict

import torch

from deepspeed_tpu_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class LossScaleState:
    loss_scale: float
    good_steps: int          # consecutive steps without overflow
    hysteresis: int          # overflows still tolerated before a cut
    overflow: bool           # the last step overflowed


def init_state(static_scale: float = 0.0, initial_scale_power: int = 16,
               hysteresis: int = 2) -> LossScaleState:
    scale = static_scale if static_scale > 0 else 2.0 ** initial_scale_power
    return LossScaleState(float(scale), 0, int(hysteresis), False)


def has_overflow(grads: Dict) -> torch.Tensor:
    """Whether any leaf holds an inf or a nan (a 0-dim bool tensor)."""
    flags = [~torch.isfinite(t).all() for t in tree_leaves(grads)]
    if not flags:
        return torch.zeros((), dtype=torch.bool)
    return torch.stack(flags).any()


def update(state: LossScaleState, overflow: bool, *, dynamic: bool,
           scale_window: int = 1000, scale_factor: float = 2.0,
           min_scale: float = 1.0, max_hysteresis: int = 2) -> LossScaleState:
    """The state after a step that did or did not overflow."""
    overflow = bool(overflow)
    if not dynamic:
        return replace(state, overflow=overflow,
                       good_steps=state.good_steps + 1)
    if overflow:
        hys = state.hysteresis - 1
        scale = max(state.loss_scale / scale_factor, min_scale) \
            if hys <= 0 else state.loss_scale
        return LossScaleState(scale, 0, max(hys, 0), True)
    good = state.good_steps + 1
    scale = state.loss_scale * scale_factor if good % scale_window == 0 \
        else state.loss_scale
    return LossScaleState(scale, good, int(max_hysteresis), False)


def scale_loss(loss: torch.Tensor, state: LossScaleState) -> torch.Tensor:
    return loss * state.loss_scale


def unscale_grads(grads: Dict, state: LossScaleState) -> Dict:
    """fp32 gradients divided by the loss scale."""
    inv = 1.0 / state.loss_scale
    return tree_map(lambda g: g.float() * inv, grads)

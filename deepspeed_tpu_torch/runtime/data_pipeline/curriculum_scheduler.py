"""Curriculum learning: a difficulty (the sequence length) that grows with
the step.

The port's own copy of ``deepspeed_tpu/runtime/data_pipeline/
curriculum_scheduler.py`` (plain Python): the schedules ``fixed_discrete``,
``fixed_linear`` and ``fixed_root`` and the state dict that checkpoints
carry. The engine truncates the batch's sequence axis to the difficulty
(``DeepSpeedEngine._apply_curriculum``); every distinct length is another
set of kernel shapes, and ``difficulty_step`` keeps the lengths on a
grid.
"""

import math
from typing import Any, Dict

from deepspeed_tpu_torch.utils.logging import logger

FIXED_DISCRETE = "fixed_discrete"
FIXED_LINEAR = "fixed_linear"
FIXED_ROOT = "fixed_root"


class CurriculumScheduler:
    def __init__(self, config: Dict[str, Any]):
        self.state: Dict[str, Any] = {}
        for key in ("curriculum_type", "min_difficulty", "max_difficulty",
                    "schedule_type"):
            if key not in config:
                raise ValueError(
                    f"Curriculum learning requires the config '{key}'")
        self.state["min_difficulty"] = config["min_difficulty"]
        self.state["max_difficulty"] = config["max_difficulty"]
        self.state["current_difficulty"] = config["min_difficulty"]
        self.state["schedule_type"] = config["schedule_type"]
        schedule_config = config.get("schedule_config", {})
        stype = config["schedule_type"]
        if stype == FIXED_DISCRETE:
            # a difficulty list one longer than the max_step list: the last
            # difficulty holds for every later step
            for key in ("difficulty", "max_step"):
                if key not in schedule_config:
                    raise ValueError(f"fixed_discrete needs '{key}'")
            if not schedule_config["max_step"] or \
                    len(schedule_config["difficulty"]) != \
                    len(schedule_config["max_step"]) + 1:
                raise ValueError("fixed_discrete needs one more difficulty "
                                 "than max_step entries")
        elif stype in (FIXED_ROOT, FIXED_LINEAR):
            for key in ("total_curriculum_step", "difficulty_step") + (
                    ("root_degree",) if stype == FIXED_ROOT else ()):
                if key not in schedule_config:
                    raise ValueError(f"{stype} needs '{key}'")
            if schedule_config["difficulty_step"] % 8 != 0:
                logger.warning(
                    "a difficulty_step that is a multiple of 8 keeps the "
                    "sequence length on the tensor cores' tile grid")
        else:
            raise RuntimeError("Unsupported curriculum schedule type")
        self.state["schedule"] = schedule_config

    def get_current_difficulty(self) -> int:
        return self.state["current_difficulty"]

    def set_current_difficulty(self, difficulty: int) -> None:
        self.state["current_difficulty"] = difficulty

    def get_state(self) -> Dict[str, Any]:
        return self.state

    def set_state(self, state: Dict[str, Any]) -> None:
        self.state = state

    def _fixed_discrete(self, global_steps: int) -> int:
        s = self.state["schedule"]
        if global_steps > s["max_step"][-1]:
            return s["difficulty"][-1]
        for i, mstep in enumerate(s["max_step"]):
            if global_steps <= mstep:
                return s["difficulty"][i]
        return s["difficulty"][-1]

    def _fixed_root(self, global_steps: int, root_degree=None) -> int:
        s = self.state["schedule"]
        if root_degree is None:
            root_degree = s["root_degree"]
        frac = (float(global_steps) / s["total_curriculum_step"]) \
            ** (1.0 / root_degree)
        next_difficulty = math.floor(
            frac * (self.state["max_difficulty"]
                    - self.state["min_difficulty"])
            + self.state["min_difficulty"])
        next_difficulty -= next_difficulty % s["difficulty_step"]
        return min(next_difficulty, self.state["max_difficulty"])

    def get_difficulty(self, global_steps: int) -> int:
        stype = self.state["schedule_type"]
        if stype == FIXED_DISCRETE:
            return self._fixed_discrete(global_steps)
        if stype == FIXED_LINEAR:
            return self._fixed_root(global_steps, 1)
        if stype == FIXED_ROOT:
            return self._fixed_root(global_steps)
        raise RuntimeError("Unsupported curriculum schedule type")

    def update_difficulty(self, global_steps: int) -> int:
        if self.state["current_difficulty"] < self.state["max_difficulty"]:
            self.state["current_difficulty"] = self.get_difficulty(
                global_steps)
        return self.state["current_difficulty"]

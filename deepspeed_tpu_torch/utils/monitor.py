"""Training metrics monitor: scalars to CSV, JSONL and, where it imports,
TensorBoard.

Port of ``deepspeed_tpu/utils/monitor.py``. The CSV (``scalars.csv``)
and JSONL (``scalars.jsonl``) files under ``output_path/job_name`` are
always written, in the JAX package's format, with one CSV row per step; a
``torch.utils.tensorboard.SummaryWriter`` is added only where that module
imports (it needs the ``tensorboard`` package), as an optional third
writer. A monitor that finds an existing CSV adopts its header, so a
resumed run appends rows without a second header.
"""

import csv
import json
import os
from collections.abc import Mapping
from typing import Dict, List, Tuple

from deepspeed_tpu_torch.utils.logging import logger


def _tensorboard_writer(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir=log_dir)


class Monitor:
    """Scalar sink: ``write_scalars([(tag, value, step), ...])``."""

    def __init__(self, output_path: str = "runs",
                 job_name: str = "deepspeed_tpu", enabled: bool = True,
                 rank: int = 0):
        self.enabled = enabled and rank == 0
        self.log_dir = os.path.join(os.path.expanduser(output_path),
                                    job_name)
        self._tb = None
        self._csv_path = os.path.join(self.log_dir, "scalars.csv")
        self._jsonl_path = os.path.join(self.log_dir, "scalars.jsonl")
        self._csv_known_tags: List[str] = []
        if not self.enabled:
            return
        os.makedirs(self.log_dir, exist_ok=True)
        self._tb = _tensorboard_writer(self.log_dir)
        if self._tb is None:
            logger.info("torch.utils.tensorboard does not import; scalars "
                        "go to csv/jsonl only")
        if os.path.exists(self._csv_path):
            with open(self._csv_path) as f:
                first = f.readline().strip()
            if first.startswith("step,"):
                self._csv_known_tags = first.split(",")[1:]

    @classmethod
    def from_config(cls, tb_config) -> "Monitor":
        """tb_config: ``runtime.config.TensorboardConfig``."""
        return cls(output_path=tb_config.output_path or "runs",
                   job_name=tb_config.job_name, enabled=tb_config.enabled)

    def write_scalars(self, scalars: List[Tuple[str, float, int]]) -> None:
        """``(tag, value, step)`` tuples; a mapping value (a histogram
        summary) expands into ``tag/key`` scalars."""
        if not self.enabled or not scalars:
            return
        scalars = self._expand_summaries(scalars)
        if not scalars:
            return
        if self._tb is not None:
            for tag, value, step in scalars:
                self._tb.add_scalar(tag, float(value), int(step))
        with open(self._jsonl_path, "a") as f:
            for tag, value, step in scalars:
                f.write(json.dumps({"tag": tag, "value": float(value),
                                    "step": int(step)}) + "\n")
        self._write_csv_rows(scalars)

    @staticmethod
    def _expand_summaries(scalars) -> List[Tuple[str, float, int]]:
        flat: List[Tuple[str, float, int]] = []
        for tag, value, step in scalars:
            if isinstance(value, Mapping):
                flat.extend((f"{tag}/{k}", float(v), step)
                            for k, v in value.items())
            else:
                flat.append((tag, float(value), step))
        return flat

    def _write_csv_rows(self, scalars) -> None:
        """One row per step, in the order the steps first appear; a header
        wherever the tags change. (The JAX package writes one row per
        call, so a call that carries several steps, as the engine's
        buffered flush does, gives one wide row under repeated tags.)"""
        by_step: Dict[int, List[Tuple[str, float]]] = {}
        for tag, value, step in scalars:
            by_step.setdefault(int(step), []).append((tag, float(value)))
        if not os.path.exists(self._csv_path):
            self._csv_known_tags = []
        with open(self._csv_path, "a", newline="") as f:
            w = csv.writer(f)
            for step, row in by_step.items():
                tags = [t for t, _ in row]
                if tags != self._csv_known_tags:
                    w.writerow(["step"] + tags)
                    self._csv_known_tags = tags
                w.writerow([step] + [v for _, v in row])

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None


class NoopMonitor:
    enabled = False

    def write_scalars(self, scalars) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

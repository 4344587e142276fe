"""The port's logger: ``deepspeed_tpu_torch``, INFO and above to stdout,
and :func:`log_dist`, which logs on chosen process ranks only.

It propagates to the root logger as well, so an application's own
handlers (and pytest's ``caplog``) see its records."""

import logging
import sys
from typing import List, Optional

import torch

logger = logging.getLogger("deepspeed_tpu_torch")
if not logger.handlers:
    _handler = logging.StreamHandler(stream=sys.stdout)
    _handler.setFormatter(logging.Formatter(
        "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"))
    logger.addHandler(_handler)
    logger.setLevel(logging.INFO)


def _rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks: Optional[List[int]] = None,
             level=logging.INFO) -> None:
    """Log ``message`` on the given process ranks only (None, empty or -1:
    every rank), prefixed with the rank, as ``deepspeed_tpu.log_dist``
    does; the rank is ``torch.distributed``'s, 0 without a process
    group."""
    rank = _rank()
    if not ranks or -1 in ranks or rank in ranks:
        logger.log(level, f"[Rank {rank}] {message}")

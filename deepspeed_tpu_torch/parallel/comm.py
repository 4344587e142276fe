"""The collectives of the data-parallel step, over a mesh axis group.

Each call takes a ``parallel.mesh.AxisGroup`` and does nothing when the
group has no process group (one rank without ``torch.distributed``). Every
call is counted in :data:`STATS` by name: calls, bytes (all_reduce: the
tensor; reduce_scatter: its input; all_gather: its output) and seconds
of the host's wall clock inside the call (with ``timed(True)`` the device
is synchronised before and after, so that the seconds hold the
collective's own time).

The backends take the tensors as they are. NCCL takes CUDA tensors, one
card per rank. ``gloo`` takes CPU tensors, and CUDA tensors for every
collective the step uses (``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, and ``barrier``: checked on an H100 with torch
2.11, two ranks on one card), copying them through the host itself; so
nothing is staged here. The names are the ones torch 2.11 and
2.13 both have (2.13 marks the ``*_tensor`` forms deprecated; the
warning is silenced).
"""

import time
import warnings
from typing import Dict

import torch
import torch.distributed as dist

COLLECTIVES = ("all_reduce", "reduce_scatter", "all_gather")
STATS: Dict[str, Dict[str, float]] = {
    name: {"calls": 0, "bytes": 0, "seconds": 0.0} for name in COLLECTIVES}
_TIMED = False


def reset_stats() -> None:
    for s in STATS.values():
        s.update(calls=0, bytes=0, seconds=0.0)


def stats() -> Dict[str, Dict[str, float]]:
    """A copy of the counters."""
    return {k: dict(v) for k, v in STATS.items()}


def timed(on: bool) -> None:
    """Synchronise the device around each collective (for measurements;
    off by default)."""
    global _TIMED
    _TIMED = bool(on)


def _sync(t: torch.Tensor) -> None:
    if _TIMED and t.is_cuda:
        torch.cuda.synchronize(t.device)


def _run(name: str, nbytes: int, probe: torch.Tensor, fn) -> None:
    _sync(probe)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=FutureWarning)
        warnings.simplefilter("ignore", category=DeprecationWarning)
        warnings.simplefilter("ignore", category=UserWarning)
        fn()
    _sync(probe)
    s = STATS[name]
    s["calls"] += 1
    s["bytes"] += int(nbytes)
    s["seconds"] += time.perf_counter() - t0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced in place over ``group`` (``op`` sum or max)."""
    if group.pg is None:
        return t
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    _run("all_reduce", _nbytes(t), t,
         lambda: dist.all_reduce(t, op=rop, group=group.pg))
    return t


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group
                   ) -> torch.Tensor:
    """``out`` = the sum over ``group`` of piece ``group.index`` of
    ``inp`` (``group.size`` equal pieces, flat). One rank: a copy."""
    if group.pg is None:
        return out.copy_(inp.view(out.shape))
    _run("reduce_scatter", _nbytes(inp), inp,
         lambda: dist.reduce_scatter_tensor(out, inp, group=group.pg))
    return out


def all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> torch.Tensor:
    """``out`` (flat, ``group.size`` pieces) = every member's ``inp`` in
    group order. One rank: a copy."""
    if group.pg is None:
        return out.copy_(inp.reshape(out.shape))
    _run("all_gather", _nbytes(out), out,
         lambda: dist.all_gather_into_tensor(out, inp, group=group.pg))
    return out

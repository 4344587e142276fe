"""The collectives of the data-parallel step and of sequence parallelism,
over a mesh axis group.

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
nothing is staged for those.

Tensor parallelism's all-reduces (``parallel/tensor.py``) are counted
apart, under ``tp_all_reduce``.

Sequence parallelism adds three: :func:`rotate` (ring attention's
neighbour exchange: every member sends to the next one in group order and
receives from the previous one, or the other way round), :func:`all_to_all`
(Ulysses' sequence/head exchange) and :func:`all_gather_dim` (an
all-gather along a tensor dimension, counted as ``all_gather``). gloo's
point-to-point ``send``/``recv`` read a tensor's memory from the host, so
under gloo a CUDA tensor's rotation goes through pinned host buffers (one
copy out, one message each way, one copy in); that choice is made by the
backend alone, and such calls are counted under ``staged`` beside
``calls``. NCCL takes CUDA tensors as they are. The names are the ones
torch 2.11 and 2.13 both have (2.13 marks the ``*_tensor`` forms
deprecated; the warning is silenced).

Pipeline parallelism adds :func:`exchange`: one tick's point-to-point
messages between the stages of a ``pipe`` group (activations to the next
stage, cotangents to the previous one), every send and receive of the
tick posted together (``batch_isend_irecv``: a blocking send from two
neighbours at once would deadlock), staged through pinned host buffers
for a CUDA tensor under gloo as :func:`rotate` is. Counted per message
under ``pipe_send`` and ``pipe_recv`` (calls and bytes); a tick's seconds
go to ``pipe_recv`` when it receives (the time the stage waits for its
neighbours: transfer and bubble) and to ``pipe_send`` when it only sends.
The pipeline's sum of the replicated leaves' gradients and of the loss
over the stages is an :func:`all_reduce` counted as ``tied_all_reduce``.
"""

import time
import warnings
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

COLLECTIVES = ("all_reduce", "reduce_scatter", "all_gather", "rotate",
               "all_to_all", "tp_all_reduce", "pipe_send", "pipe_recv",
               "tied_all_reduce")
STATS: Dict[str, Dict[str, float]] = {
    name: {"calls": 0, "bytes": 0, "seconds": 0.0, "staged": 0}
    for name in COLLECTIVES}
_TIMED = False


def reset_stats() -> None:
    for s in STATS.values():
        s.update(calls=0, bytes=0, seconds=0.0, staged=0)


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


def _run(name: str, nbytes: int, probe: torch.Tensor, fn,
         staged: bool = False) -> None:
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
    s["staged"] += int(staged)
    s["bytes"] += int(nbytes)
    s["seconds"] += time.perf_counter() - t0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group, op: str = "sum",
               name: str = "all_reduce") -> torch.Tensor:
    """``t`` reduced in place over ``group`` (``op`` sum or max), counted
    under ``name`` (``tp_all_reduce``: tensor parallelism's, in
    ``parallel/tensor.py``; ``tied_all_reduce``: the pipeline's, in
    ``runtime/pipe/engine.py``)."""
    if group.pg is None:
        return t
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    _run(name, _nbytes(t), t,
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


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a point-to-point exchange of ``t`` goes through host
    buffers: a CUDA tensor over gloo."""
    return t.is_cuda and dist.get_backend(group.pg) == "gloo"


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes, one after another, as one flat uint8 tensor."""
    return torch.cat([t.contiguous().view(-1).view(torch.uint8)
                      for t in tensors])


def _unpack(flat: torch.Tensor, like: Sequence[torch.Tensor]
            ) -> List[torch.Tensor]:
    out, at = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(flat[at:at + n].view(t.dtype).view(t.shape))
        at += n
    return out


def rotate(tensors: Sequence[torch.Tensor], group, shift: int = 1
           ) -> List[torch.Tensor]:
    """Every member's ``tensors`` (same shapes and dtypes on every member)
    handed ``shift`` places along the group (``shift`` 1 or -1): member
    ``i`` sends to ``(i + shift) % n`` and returns what member
    ``(i - shift) % n`` sent, as new tensors. One message each way,
    posted together (``isend``/``irecv``), so that no two members wait on
    each other. One member: the tensors as they are."""
    tensors = list(tensors)
    if group.pg is None or group.size == 1:
        return tensors
    n, i = group.size, group.index
    dst = group.ranks[(i + shift) % n]
    src = group.ranks[(i - shift) % n]
    flat = _pack(tensors)
    staged = _staged(flat, group)
    out = torch.empty_like(flat)

    def exchange():
        send, recv = flat, out
        if staged:
            send = torch.empty(flat.shape, dtype=flat.dtype,
                               pin_memory=True)
            send.copy_(flat)
            recv = torch.empty(flat.shape, dtype=flat.dtype,
                               pin_memory=True)
        ops = [dist.P2POp(dist.isend, send, dst, group=group.pg),
               dist.P2POp(dist.irecv, recv, src, group=group.pg)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        if staged:
            out.copy_(recv)
    _run("rotate", flat.numel(), flat, exchange, staged)
    return _unpack(out, tensors)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` [n, ...] (``n`` the group's size): piece ``j`` goes to member
    ``j``; returns [n, ...] whose piece ``j`` came from member ``j``. One
    member: ``x``."""
    if group.pg is None or group.size == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    _run("all_to_all", _nbytes(x), x,
         lambda: dist.all_to_all_single(out, x, group=group.pg))
    return out


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every member's ``x`` concatenated along ``dim`` in group order
    (counted as ``all_gather``). One member: ``x``."""
    if group.pg is None or group.size == 1:
        return x
    x = x.contiguous()
    out = torch.empty((group.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    all_gather(out, x, group)
    return torch.cat(out.view((group.size,) + tuple(x.shape)).unbind(0),
                     dim=dim)


def exchange(sends: Sequence, recvs: Sequence, group) -> List[torch.Tensor]:
    """One tick of point-to-point messages over ``group``: ``sends`` are
    ``(tensor, member, tag)``, ``recvs`` are ``(like, member, tag)`` (a
    tensor whose shape, dtype and device the message takes). Every send
    and receive is posted at once and waited for; returns the received
    tensors in the order of ``recvs``. Both sides of a message name it
    with the same tag (two messages may go one way in one tick)."""
    if not sends and not recvs:
        return []
    probe = sends[0][0] if sends else recvs[0][0]
    staged = _staged(probe, group)
    out: List[torch.Tensor] = []

    def run():
        ops, bufs = [], []
        for t, j, tag in sends:
            buf = t.detach().contiguous()
            if staged:
                host = torch.empty(buf.shape, dtype=buf.dtype,
                                   pin_memory=True)
                host.copy_(buf)
                buf = host
            ops.append(dist.P2POp(dist.isend, buf, group.ranks[j],
                                  group=group.pg, tag=tag))
        for like, j, tag in recvs:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              pin_memory=True) if staged \
                else torch.empty_like(like)
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, group.ranks[j],
                                  group=group.pg, tag=tag))
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        out.extend(b.to(like.device) if staged else b
                   for b, (like, _, _) in zip(bufs, recvs))

    _sync(probe)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=UserWarning)
        run()
    _sync(probe)
    secs = time.perf_counter() - t0
    for name, msgs in (("pipe_send", [m[0] for m in sends]),
                       ("pipe_recv", [m[0] for m in recvs])):
        s = STATS[name]
        s["calls"] += len(msgs)
        s["staged"] += len(msgs) if staged else 0
        s["bytes"] += sum(_nbytes(m) for m in msgs)
    STATS["pipe_recv" if recvs else "pipe_send"]["seconds"] += secs
    return out

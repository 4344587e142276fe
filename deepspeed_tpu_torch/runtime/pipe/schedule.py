"""Pipeline instruction schedules: pure Python, no devices.

A copy of ``deepspeed_tpu/runtime/pipe/schedule.py`` (the reference's
``deepspeed/runtime/pipe/schedule.py``: ``PipeSchedule`` :24,
``TrainSchedule`` :182, ``InferenceSchedule`` :129,
``DataParallelSchedule`` :292; the instruction set :317-463), whose output
it gives bit for bit. The port's pipeline executor
(``runtime/pipe/engine.py``) runs every schedule as per-tick tables of
forward and backward work; the interleaved 1F1B tables are
:func:`interleaved_1f1b_tables`, and the instruction streams document and
test the 1F1B ordering as the reference's
``tests/unit/test_pipe_schedule.py`` does.
"""

from typing import Iterator, List


# ---------------------------------------------------------------------------
# instructions
# ---------------------------------------------------------------------------

class PipeInstruction:
    """One step of work (ref: schedule.py:317)."""

    def __init__(self, **kwargs):
        self.name = self.__class__.__name__
        self.kwargs = kwargs
        for key, val in kwargs.items():
            setattr(self, key, val)

    def __repr__(self):
        if not self.kwargs:
            return self.name
        args = ", ".join(f"{k}={v}" for k, v in sorted(self.kwargs.items()))
        return f"{self.name}({args})"

    def __eq__(self, other):
        return (self.__class__ is other.__class__ and
                self.kwargs == other.kwargs)

    def __hash__(self):
        return hash((self.__class__, tuple(sorted(self.kwargs.items()))))


class OptimizerStep(PipeInstruction):
    """Step the optimizer (all stages, after all microbatches)."""


class ReduceGrads(PipeInstruction):
    """Data-parallel gradient reduction."""


class ReduceTiedGrads(PipeInstruction):
    """Reduce gradients of tied modules across their tie group."""


class BufferOpInstruction(PipeInstruction):
    """Instruction operating on a pipe buffer slot
    (ref: schedule.py:355 — carries buffer_id)."""

    def __init__(self, buffer_id: int, **kwargs):
        super().__init__(buffer_id=buffer_id, **kwargs)


class LoadMicroBatch(BufferOpInstruction):
    pass


class ForwardPass(BufferOpInstruction):
    pass


class BackwardPass(BufferOpInstruction):
    pass


class SendActivation(BufferOpInstruction):
    pass


class RecvActivation(BufferOpInstruction):
    pass


class SendGrad(BufferOpInstruction):
    pass


class RecvGrad(BufferOpInstruction):
    pass


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

class PipeSchedule:
    """Yields lists of PipeInstructions per "clock step" for one stage
    (ref: schedule.py:24)."""

    def __init__(self, micro_batches: int, stages: int, stage_id: int):
        assert 0 <= stage_id < stages
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = stage_id - 1
        self.next_stage = stage_id + 1

    def steps(self) -> Iterator[List[PipeInstruction]]:
        raise NotImplementedError

    def num_pipe_buffers(self) -> int:
        return self.micro_batches

    @property
    def is_first_stage(self) -> bool:
        return self.stage_id == 0

    @property
    def is_last_stage(self) -> bool:
        return self.stage_id == self.stages - 1

    def _buffer_idx(self, micro_batch_id: int) -> int:
        return micro_batch_id % self.num_pipe_buffers()

    def __iter__(self):
        return iter(self.steps())


class InferenceSchedule(PipeSchedule):
    """Forward-only pipelining (ref: schedule.py:129)."""

    def num_pipe_buffers(self) -> int:
        return 2

    def steps(self):
        total_steps = self.micro_batches + self.stages - 1
        for step_id in range(total_steps):
            micro_batch_id = step_id - self.stage_id
            cmds: List[PipeInstruction] = []
            valid = 0 <= micro_batch_id < self.micro_batches
            buf = self._buffer_idx(max(micro_batch_id, 0))
            if valid:
                if self.is_first_stage:
                    cmds.append(LoadMicroBatch(buf))
                else:
                    cmds.append(RecvActivation(buf))
                cmds.append(ForwardPass(buf))
                if not self.is_last_stage:
                    cmds.append(SendActivation(buf))
            yield cmds


class TrainSchedule(PipeSchedule):
    """1F1B: warmup forwards, steady-state interleave, cooldown backwards
    (ref: schedule.py:182 TrainSchedule.steps).

    Per-stage sequence for stage s of P with M microbatches:
      warmup   = min(P - 1 - s, M) forwards
      steady   = interleaved 1F1B
      cooldown = remaining backwards
    Peak live activations on stage s = warmup + 1 (the 1F1B memory win
    over GPipe's M).
    """

    def num_pipe_buffers(self) -> int:
        buffers = min(self.stages - self.stage_id, self.micro_batches)
        return max(2, buffers)

    def steps(self):
        M, P, s = self.micro_batches, self.stages, self.stage_id
        warmup = min(P - 1 - s, M)
        fwd_id = 0
        bwd_id = 0
        cmds_seq: List[List[PipeInstruction]] = []

        # warmup forwards
        for _ in range(warmup):
            cmds_seq.append(self._fwd_cmds(fwd_id))
            fwd_id += 1
        # steady state: 1F1B
        while fwd_id < M:
            cmds_seq.append(self._fwd_cmds(fwd_id))
            fwd_id += 1
            cmds_seq.append(self._bwd_cmds(bwd_id))
            bwd_id += 1
        # cooldown backwards
        while bwd_id < M:
            cmds_seq.append(self._bwd_cmds(bwd_id))
            bwd_id += 1
        # epilogue: grad reduction + optimizer step
        cmds_seq.append([ReduceTiedGrads(), ReduceGrads(), OptimizerStep()])
        yield from cmds_seq

    def _fwd_cmds(self, micro_batch_id: int) -> List[PipeInstruction]:
        buf = self._buffer_idx(micro_batch_id)
        cmds: List[PipeInstruction] = []
        if self.is_first_stage:
            cmds.append(LoadMicroBatch(buf))
        else:
            cmds.append(RecvActivation(buf))
        cmds.append(ForwardPass(buf))
        if not self.is_last_stage:
            cmds.append(SendActivation(buf))
        return cmds

    def _bwd_cmds(self, micro_batch_id: int) -> List[PipeInstruction]:
        buf = self._buffer_idx(micro_batch_id)
        cmds: List[PipeInstruction] = []
        if not self.is_last_stage:
            cmds.append(RecvGrad(buf))
        cmds.append(BackwardPass(buf))
        if not self.is_first_stage:
            cmds.append(SendGrad(buf))
        return cmds


class DataParallelSchedule(PipeSchedule):
    """Degenerate schedule for pure DP (ref: schedule.py:292)."""

    def num_pipe_buffers(self) -> int:
        return 1

    def steps(self):
        for micro_batch_id in range(self.micro_batches):
            cmds: List[PipeInstruction] = [
                LoadMicroBatch(0), ForwardPass(0), BackwardPass(0)]
            if micro_batch_id == self.micro_batches - 1:
                cmds.extend([ReduceGrads(), OptimizerStep()])
            yield cmds


# ---------------------------------------------------------------------------
# interleaved 1F1B (virtual pipeline stages)
# ---------------------------------------------------------------------------

def _interleaved_rank_order(P: int, v: int, M: int, d: int):
    """Device d's op sequence for the interleaved 1F1B schedule
    (Megatron-style: warmup forwards, then chunk-granular 1F1B pairs,
    then cooldown backwards). Each op is ('F'|'B', chunk, microbatch).

    Virtual stage c*P + d holds the d-th slice of layer-chunk c; the
    k-th forward on any device cycles chunks every P microbatch slots:
    chunk = (k %% (P*v)) // P, mb = (k // (P*v))*P + k %% P. Backwards
    walk the same slots with chunks reversed. M must be a multiple of P
    (the cycling assumes full groups).
    """
    if M % P:
        raise ValueError(
            f"interleaved schedule needs num_micro divisible by the "
            f"stage count (chunk cycling assumes full groups), got "
            f"{M} microbatches over {P} stages")
    total = M * v

    def fwd_slot(k):
        return ((k % (P * v)) // P,
                (k // (P * v)) * P + (k % P))

    def bwd_slot(k):
        c, m = fwd_slot(k)
        return v - 1 - c, m

    warmup = min((P - d - 1) * 2 + (v - 1) * P, total)
    ops = [("F",) + fwd_slot(k) for k in range(warmup)]
    for j in range(total - warmup):
        ops.append(("F",) + fwd_slot(warmup + j))
        ops.append(("B",) + bwd_slot(j))
    for j in range(total - warmup, total):
        ops.append(("B",) + bwd_slot(j))
    return ops


def interleaved_1f1b_tables(P: int, v: int, M: int):
    """Lockstep tick tables for interleaved 1F1B over P devices with v
    layer chunks per device (virtual stages V = v*P, chunk c of device d
    is virtual stage c*P + d).

    The per-device op order (_interleaved_rank_order) is scheduled
    greedily into synchronous ticks: a tick holds at most one F and one
    B per device, in the device's own order, and an op waits until its
    producer ran at an EARLIER tick (cross-device messages arrive the
    tick after they are sent; the last virtual stage's F->B handoff is
    local and may share a tick). This compiles the reference's
    interpreted instruction stream (ref: deepspeed/runtime/pipe/
    schedule.py:182, megatron interleaving) into static arrays: each
    rank of the port's executor reads its own row for its work and its
    neighbours' rows for the messages it receives.

    Returns a dict of int32 numpy arrays of shape [P, T]:
      fwd_c/fwd_m/fwd_valid — chunk, microbatch, validity of the tick's F
      bwd_c/bwd_m/bwd_valid — same for the tick's B
    """
    import numpy as np

    V = v * P
    orders = [_interleaved_rank_order(P, v, M, d) for d in range(P)]
    ptr = [0] * P
    done_f = {}                      # (c, m, d) -> tick
    done_b = {}
    rows = []                        # per tick: [P] of (fop|None, bop|None)

    def vstage(c, d):
        return c * P + d

    def f_ready(c, m, d, t):
        vs = vstage(c, d)
        if vs == 0:
            return True
        pc, pd = (c, d - 1) if d > 0 else (c - 1, P - 1)
        return done_f.get((pc, m, pd), t) < t

    def b_ready(c, m, d, t):
        vs = vstage(c, d)
        if vs == V - 1:              # local head handoff: same tick ok
            return done_f.get((c, m, d), t + 1) <= t
        nc, nd = (c, d + 1) if d < P - 1 else (c + 1, 0)
        return (done_b.get((nc, m, nd), t) < t
                and done_f.get((c, m, d), t + 1) <= t)

    t = 0
    while any(ptr[d] < len(orders[d]) for d in range(P)):
        row = [[None, None] for _ in range(P)]
        for d in range(P):
            used_f = used_b = False
            # up to one F and one B, in this device's own order
            for _ in range(2):
                if ptr[d] >= len(orders[d]):
                    break
                kind, c, m = orders[d][ptr[d]]
                if kind == "F" and not used_f and f_ready(c, m, d, t):
                    done_f[(c, m, d)] = t
                    row[d][0] = (c, m)
                    used_f = True
                    ptr[d] += 1
                elif kind == "B" and not used_b and b_ready(c, m, d, t):
                    done_b[(c, m, d)] = t
                    row[d][1] = (c, m)
                    used_b = True
                    ptr[d] += 1
                else:
                    break            # in-order: blocked op stalls the rest
        rows.append(row)
        t += 1
        if t > 4 * (M * v + 2 * V):
            raise RuntimeError(
                "interleaved schedule deadlock — dependency rules and "
                "rank op order disagree (scheduler bug)")

    T = len(rows)
    out = {k: np.zeros((P, T), np.int32)
           for k in ("fwd_c", "fwd_m", "fwd_valid",
                     "bwd_c", "bwd_m", "bwd_valid")}
    for tt, row in enumerate(rows):
        for d in range(P):
            if row[d][0] is not None:
                c, m = row[d][0]
                out["fwd_c"][d, tt] = c
                out["fwd_m"][d, tt] = m
                out["fwd_valid"][d, tt] = 1
            if row[d][1] is not None:
                c, m = row[d][1]
                out["bwd_c"][d, tt] = c
                out["bwd_m"][d, tt] = m
                out["bwd_valid"][d, tt] = 1
    return out

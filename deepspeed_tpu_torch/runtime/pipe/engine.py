"""Pipelined execution over the mesh's ``pipe`` axis.

Port of ``deepspeed_tpu/runtime/pipe/engine.py`` (the reference's
``deepspeed/runtime/pipe/engine.py:46``: the instruction interpreter
``_exec_schedule`` :1364, the point-to-point sends :951/:1046, the tied
gradients' reduction :240). The JAX package runs the whole pipeline as
one ``shard_map`` program whose ``lax.scan`` ticks every stage at once and
``ppermute``s activations around the ring, garbage included on the
wrap-around and in the bubble. Here each rank of the ``pipe`` group runs
its own stage as a per-rank instruction order read from tick tables:

- a table row says which forward (virtual chunk, microbatch) and which
  backward a stage runs at each tick (``gpipe_tables``,
  ``one_f_one_b_tables``, ``schedule.interleaved_1f1b_tables``); a stage
  runs only its own valid work, and idles on the other ticks;
- a stage sends its activation to the next stage and its cotangent to the
  previous one only where the receiver will use the message; both sides
  read the same table row, so each receive is posted at the tick its
  sender posts it, all of a tick's messages together
  (``parallel.comm.exchange``);
- a stage keeps the inputs of its microbatches in flight, keyed by
  microbatch modulo its depth (``2P - 1`` under 1F1B, ``M`` under GPipe,
  ``_buffer_depths`` when interleaved); the backward reruns the stage from
  its saved input (GPipe without ``remat_stage`` keeps the graph
  instead); the last virtual stage runs its layers and the head once,
  at its backward, with the graph;
- the gradients accumulate in float32 and are multiplied by ``1/M`` at
  the end, in the JAX program's order; the loss is the mean of the
  per-microbatch means, computed on the last stage and then summed over
  the ``pipe`` group with the replicated leaves' gradients (one
  all-reduce, ``tied_all_reduce``: the JAX ``psum`` and the reference's
  ReduceTiedGrads), so that every stage returns the same loss and the
  same gradients of the leaves it does not split;
- the embedding runs on the first stage only; its gradient joins the
  head's before that sum.

The loss is a ``torch.autograd.Function`` whose forward runs the whole
schedule and keeps the gradients, and whose backward returns them times
the incoming gradient (JAX's ``_make_stashed_grad_loss``): the training
engine calls ``torch.autograd.grad`` on every rank, a stage but the last
has no graph to the head, and the incoming factor is the fp16 loss scale
and the data-parallel weight. Called without gradients (``eval_fn``, or
with no leaf requiring one) the loss runs the forward-only GPipe program.
"""

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.parallel import comm
from deepspeed_tpu_torch.runtime.pipe.schedule import interleaved_1f1b_tables
from deepspeed_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any
SCHEDULES = ("gpipe", "1f1b", "interleaved")
ACT, COT = 0, 1                      # the two messages' tags
_TABLE_KEYS = ("fwd_c", "fwd_m", "fwd_valid", "bwd_c", "bwd_m", "bwd_valid")


# ---------------------------------------------------------------------------
# tick tables
# ---------------------------------------------------------------------------

def _empty_tables(P: int, T: int) -> Dict[str, np.ndarray]:
    return {k: np.zeros((P, T), np.int32) for k in _TABLE_KEYS}


def _put(tab, kind: str, s: int, t: int, c: int, m: int) -> None:
    tab[f"{kind}_c"][s, t] = c
    tab[f"{kind}_m"][s, t] = m
    tab[f"{kind}_valid"][s, t] = 1


def one_f_one_b_tables(P: int, M: int) -> Dict[str, np.ndarray]:
    """The JAX 1F1B program's ticks (``_one_f_one_b_program``): at tick
    ``t`` stage ``s`` runs forward microbatch ``t - s`` and backward
    microbatch ``t - (2P - 2 - s)``, ``M + 2P - 2`` ticks; the tables of
    :func:`schedule.interleaved_1f1b_tables` with one chunk."""
    T = M + 2 * P - 2
    tab = _empty_tables(P, T)
    for s in range(P):
        for t in range(T):
            if 0 <= t - s < M:
                _put(tab, "fwd", s, t, 0, t - s)
            if 0 <= t - (2 * P - 2 - s) < M:
                _put(tab, "bwd", s, t, 0, t - (2 * P - 2 - s))
    return tab


def gpipe_tables(P: int, M: int, backward: bool = True
                 ) -> Dict[str, np.ndarray]:
    """Fill-drain (``pipeline_apply``): ``M + P - 1`` forward ticks, stage
    ``s`` running microbatch ``t - s`` at tick ``t``, then (``backward``)
    the same ticks in reverse order, as JAX's autodiff transposes its
    scan: backward tick ``u``, stage ``s``, microbatch ``M + P - 2 - u -
    s``."""
    T1 = M + P - 1
    tab = _empty_tables(P, 2 * T1 if backward else T1)
    for s in range(P):
        for t in range(T1):
            if 0 <= t - s < M:
                _put(tab, "fwd", s, t, 0, t - s)
            if backward and 0 <= M + P - 2 - t - s < M:
                _put(tab, "bwd", s, T1 + t, 0, M + P - 2 - t - s)
    return tab


def interleave_layer_perm(L: int, P_: int, v: int):
    """Row permutation putting a [L]-stacked layer pytree into virtual-
    stage order: device d's contiguous 'pipe' slab then holds its v
    chunks (virtual stages c*P+d) back to back. Applied INSIDE the
    loss, so optimizer state and checkpoints keep the natural layer
    layout (JAX's ``interleave_layer_perm``)."""
    Lv = L // (v * P_)
    rows = []
    for d in range(P_):
        for c in range(v):
            base = (c * P_ + d) * Lv
            rows.extend(range(base, base + Lv))
    return np.asarray(rows)


def _buffer_depths(tab, P_: int, v: int, M: int):
    """Max in-flight (received-not-yet-consumed) microbatches per (device,
    chunk), for the activation and cotangent ring buffers. Consumption
    order per chunk is increasing microbatch id, so slot = m %% K is
    collision-free for K = max window (JAX's ``_buffer_depths``)."""
    T = tab["fwd_c"].shape[1]
    V = v * P_
    k_act = 1
    k_cot = 1
    for d in range(P_):
        for c in range(v):
            vs = c * P_ + d
            # activation for F(c, m) arrives at the producer's F tick
            # (prev virtual stage) or is read straight from x_micro
            # (vs == 0); consumed by B(c, m)
            if vs > 0:
                pd, pc = (d - 1, c) if d > 0 else (P_ - 1, c - 1)
                recv = {tab["fwd_m"][pd, t]: t for t in range(T)
                        if tab["fwd_valid"][pd, t]
                        and tab["fwd_c"][pd, t] == pc}
            else:
                recv = {tab["fwd_m"][d, t]: t for t in range(T)
                        if tab["fwd_valid"][d, t]
                        and tab["fwd_c"][d, t] == c}
            cons = {tab["bwd_m"][d, t]: t for t in range(T)
                    if tab["bwd_valid"][d, t] and tab["bwd_c"][d, t] == c}
            for t in range(T):
                live = [m for m in recv
                        if recv[m] <= t and cons.get(m, T + 1) > t]
                if live:
                    k_act = max(k_act, max(live) - min(live) + 1)
            # cotangent for B(c, m): produced by the next virtual
            # stage's B (or the local head F when vs == V-1)
            if vs == V - 1:
                crecv = {tab["fwd_m"][d, t]: t for t in range(T)
                         if tab["fwd_valid"][d, t]
                         and tab["fwd_c"][d, t] == c}
            else:
                nd, nc = (d + 1, c) if d < P_ - 1 else (0, c + 1)
                crecv = {tab["bwd_m"][nd, t]: t for t in range(T)
                         if tab["bwd_valid"][nd, t]
                         and tab["bwd_c"][nd, t] == nc}
            for t in range(T):
                live = [m for m in crecv
                        if crecv[m] <= t and cons.get(m, T + 1) > t]
                if live:
                    k_cot = max(k_cot, max(live) - min(live) + 1)
    return k_act, k_cot


def messages(tab, P: int, v: int, d: int, t: int):
    """(sends, receives) of device ``d`` at tick ``t``, each a list of
    ``(tag, peer device, peer's chunk, microbatch)``: the activation of a
    forward goes to the next virtual stage's device (the next chunk after
    the wrap-around), the cotangent of a backward to the previous one's,
    and nothing leaves the last virtual stage forward or the first one
    backward. Both sides of a message find it in the same table row."""
    if P == 1:
        return [], []
    V = v * P
    sends, recvs = [], []
    nd, pd = (d + 1) % P, (d - 1) % P
    if tab["fwd_valid"][d, t] and tab["fwd_c"][d, t] * P + d < V - 1:
        c = int(tab["fwd_c"][d, t])
        sends.append((ACT, nd, c + 1 if d == P - 1 else c,
                      int(tab["fwd_m"][d, t])))
    if tab["bwd_valid"][d, t] and tab["bwd_c"][d, t] * P + d > 0:
        c = int(tab["bwd_c"][d, t])
        sends.append((COT, pd, c - 1 if d == 0 else c,
                      int(tab["bwd_m"][d, t])))
    if tab["fwd_valid"][pd, t] and tab["fwd_c"][pd, t] * P + pd < V - 1:
        c = int(tab["fwd_c"][pd, t])
        recvs.append((ACT, pd, c + 1 if d == 0 else c,
                      int(tab["fwd_m"][pd, t])))
    if tab["bwd_valid"][nd, t] and tab["bwd_c"][nd, t] * P + nd > 0:
        c = int(tab["bwd_c"][nd, t])
        recvs.append((COT, nd, c - 1 if d == P - 1 else c,
                      int(tab["bwd_m"][nd, t])))
    return sends, recvs


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

class _Ring:
    """Tensors keyed by (chunk, microbatch), held in ``depth`` slots per
    chunk (slot ``m % depth``); a store into a live slot raises. ``peak``:
    the most tensors held at once."""

    def __init__(self, depth: int):
        self.depth, self.slots, self.peak = depth, {}, 0

    def put(self, c: int, m: int, value) -> None:
        key = (c, m % self.depth)
        if key in self.slots:
            raise RuntimeError(f"pipeline buffer slot {key} still holds "
                               f"microbatch {self.slots[key][0]}, "
                               f"needed for {m} (scheduler bug)")
        self.slots[key] = (m, value)
        self.peak = max(self.peak, len(self.slots))

    def get(self, c: int, m: int, pop: bool = False):
        key = (c, m % self.depth)
        held, value = self.slots.pop(key) if pop else self.slots[key]
        if held != m:
            raise RuntimeError(f"pipeline buffer slot {key} holds "
                               f"microbatch {held}, not {m}")
        return value


def _grads(out, wrt, cot):
    got = torch.autograd.grad(out, wrt, cot, allow_unused=True)
    return [torch.zeros_like(w) if g is None else g for g, w in zip(got, wrt)]


def _accumulate(acc: List, grads) -> List:
    """Float32 sums: ``acc`` (None on first use) plus ``grads``."""
    if acc is None:
        return [g.detach().float().clone() for g in grads]
    for a, g in zip(acc, grads):
        a.add_(g.detach().float())
    return acc


def run_tables(tab, group, stage_fn: Callable, head_loss_fn: Callable,
               chunks: Sequence[PyTree], other: PyTree, x_micro,
               targets: Sequence, like: torch.Tensor, *, depth: int,
               cot_depth: int, train: bool = True, keep_graph: bool = False,
               x_grad: bool = False) -> Dict[str, Any]:
    """Run device ``group.index``'s row of ``tab`` (one stage of the
    pipeline over ``group``, ``len(chunks)`` virtual chunks of it).

    chunks: this rank's chunk trees (leaves requiring gradients when
    ``train``); other: the replicated tree the head reads; x_micro: the
    [M, ...] first-stage input (read on virtual stage 0 only); targets:
    per microbatch, read by the head; like: a tensor of an activation's
    shape, dtype and device (the receive buffers'). depth / cot_depth:
    the activation and cotangent buffers' slots per chunk. keep_graph:
    keep each forward's graph for its backward instead of rerunning the
    stage (GPipe without ``remat_stage``); x_grad: the gradient of
    x_micro is wanted (the embedding's).

    Returns ``loss`` (the sum of the head's per-microbatch losses,
    float32, 0 on a stage without the head), ``dchunks`` (per chunk its
    leaves' float32 gradient sums, or None), ``dother`` (the head's
    float32 sums, or None), ``dx`` ({microbatch: gradient of x_micro[m]})
    and ``peak`` (the most stage inputs held at once)."""
    P, d = group.size, group.index
    v = len(chunks)
    V = v * P
    T = tab["fwd_c"].shape[1]
    leaves = [list(tree_leaves(c)) for c in chunks]
    other_leaves = list(tree_leaves(other))
    act, cot, graphs = _Ring(depth), _Ring(cot_depth), {}
    loss = torch.zeros((), dtype=torch.float32, device=like.device)
    dchunks: List[Optional[List]] = [None] * v
    dother, dx = None, {}

    def forward(c, m):
        nonlocal loss
        vs = c * P + d
        if vs == 0:
            act.put(c, m, x_micro[m])
        inp = act.get(c, m, pop=not train)
        if train and vs == V - 1:
            return None        # the head's layers run at its backward
        if train and keep_graph:
            with torch.enable_grad():
                inp_g = inp.detach().requires_grad_(vs > 0 or x_grad)
                out = stage_fn(chunks[c], inp_g)
            graphs[(c, m)] = (inp_g, out)
            return out.detach()
        with torch.no_grad():
            out = stage_fn(chunks[c], inp)
            if vs == V - 1:
                loss += head_loss_fn(other, out, targets[m]).float()
                return None
        return out

    def backward(c, m):
        nonlocal loss, dother
        vs = c * P + d
        inp = act.get(c, m, pop=True)
        want_dx = vs > 0 or x_grad
        with torch.enable_grad():
            if (c, m) in graphs:
                inp_g, out = graphs.pop((c, m))
            else:
                inp_g = inp.detach().requires_grad_(want_dx)
                out = stage_fn(chunks[c], inp_g)
            wrt = leaves[c] + ([inp_g] if want_dx else [])
            if vs == V - 1:
                loss_m = head_loss_fn(other, out, targets[m])
                grads = _grads(loss_m, wrt + other_leaves, None)
                loss += loss_m.detach().float()
                dother = _accumulate(dother, grads[len(wrt):])
                grads = grads[:len(wrt)]
            else:
                grads = _grads(out, wrt, cot.get(c, m, pop=True))
        dchunks[c] = _accumulate(dchunks[c], grads[:len(leaves[c])])
        if not want_dx:
            return None
        g = grads[-1].detach()
        if vs == 0:
            dx[m] = g
            return None
        return g

    for t in range(T):
        out = back = None
        if tab["fwd_valid"][d, t]:
            out = forward(int(tab["fwd_c"][d, t]), int(tab["fwd_m"][d, t]))
        if train and tab["bwd_valid"][d, t]:
            back = backward(int(tab["bwd_c"][d, t]),
                            int(tab["bwd_m"][d, t]))
        sends, recvs = messages(tab, P, v, d, t)
        payload = {ACT: out, COT: back}
        got = comm.exchange([(payload[tag], peer, tag)
                             for tag, peer, _, _ in sends],
                            [(like, peer, tag) for tag, peer, _, _ in recvs],
                            group)
        for (tag, _, c, m), x in zip(recvs, got):
            (act if tag == ACT else cot).put(c, m, x)
    return dict(loss=loss, dchunks=dchunks, dother=dother, dx=dx,
                peak=act.peak)


# ---------------------------------------------------------------------------
# the stashed-gradient loss
# ---------------------------------------------------------------------------

class _Stashed(torch.autograd.Function):
    """Forward: ``run(*inputs) -> (loss, gradients)``, the gradients kept;
    backward: each gradient times the incoming one, in its input's dtype
    (JAX's ``_make_stashed_grad_loss``)."""

    @staticmethod
    def forward(ctx, run, *inputs):
        loss, grads = run(*inputs)
        ctx.grads = grads
        ctx.dtypes = [t.dtype for t in inputs]
        return loss

    @staticmethod
    def backward(ctx, g):
        out = [None if d is None else (d * g.to(d.dtype)).to(dt)
               for d, dt in zip(ctx.grads, ctx.dtypes)]
        ctx.grads = None
        return (None, *out)


# ---------------------------------------------------------------------------
# the pipeline group and the stage's rows
# ---------------------------------------------------------------------------

def pipe_group(mesh, num_stages: int, axis: str = "pipe"):
    """The ``parallel.mesh.AxisGroup`` of ``axis`` on ``mesh`` (None: the
    registered mesh, ``utils.groups``), which must have ``num_stages``
    ranks and, above one, a process group."""
    from deepspeed_tpu_torch.parallel.mesh import AxisGroup
    if mesh is None:
        from deepspeed_tpu_torch.utils import groups
        mesh = groups._MESH
    group = AxisGroup((axis,), (0,), 0, None) if mesh is None \
        else mesh.group(axis)
    if group.size != num_stages:
        raise ValueError(f"a pipeline of {num_stages} stages over a mesh "
                         f"'{axis}' axis of {group.size}")
    if group.size > 1 and group.pg is None:
        raise ValueError(f"a '{axis}' axis of {group.size} ranks needs a "
                         f"process group: build the mesh after "
                         f"deepspeed_tpu_torch.init_distributed")
    return group


def stage_rows(stage_params: PyTree, group, num_layers: Optional[int]
               ) -> PyTree:
    """This stage's rows of the stacked leaves: the leaves as they are
    when they hold one stage's rows (the engine's pieces), the stage's
    slice of them when they hold all ``num_layers``."""
    rows = next(iter(tree_leaves(stage_params))).shape[0]
    if group.size == 1 or num_layers is None or rows != num_layers:
        return stage_params
    n = rows // group.size
    return tree_map(lambda p: p[group.index * n:(group.index + 1) * n],
                    stage_params)


def _permute_slab(leaves: List[torch.Tensor], group, v: int,
                  to_virtual: bool) -> List[torch.Tensor]:
    """Between a stage's natural rows (stage ``d`` holds layers ``[d*R,
    (d+1)*R)``) and its virtual chunks (chunk ``c`` of device ``d`` is
    virtual stage ``c*P + d``): block ``k`` of the natural order is
    virtual stage ``k``, on device ``k % P`` as chunk ``k // P``; its
    home is rank ``k // v``. One exchange over ``group``, the blocks
    that move packed one message each (tagged with their virtual
    stage)."""
    P, d = group.size, group.index
    R = leaves[0].shape[0]
    Lv = R // v

    def block(i):
        return [t[i * Lv:(i + 1) * Lv] for t in leaves]

    # which block of mine goes where, and which I receive
    if to_virtual:       # I hold natural blocks d*v + i; I want c*P + d
        have = {d * v + i: i for i in range(v)}
        want = {c * P + d: c for c in range(v)}
        owner = lambda k: k // v                              # noqa: E731
        dest = lambda k: k % P                                # noqa: E731
    else:                # I hold chunks c*P + d; I want d*v + i
        have = {c * P + d: c for c in range(v)}
        want = {d * v + i: i for i in range(v)}
        owner = lambda k: k % P                               # noqa: E731
        dest = lambda k: k // v                               # noqa: E731
    out: List[Optional[List[torch.Tensor]]] = [None] * v
    sends, recvs, into = [], [], []
    for k, i in have.items():
        if dest(k) == d:
            out[want[k]] = block(i)
        else:
            sends.append((torch.cat([b.reshape(-1) for b in block(i)]),
                          dest(k), k))
    like = block(0)
    flat_like = torch.empty(sum(b.numel() for b in like),
                            dtype=leaves[0].dtype, device=leaves[0].device)
    for k, j in want.items():
        if out[j] is None:
            recvs.append((flat_like, owner(k), k))
            into.append(j)
    for j, flat in zip(into, comm.exchange(sends, recvs, group)):
        parts, at = [], 0
        for b in like:
            parts.append(flat[at:at + b.numel()].view(b.shape))
            at += b.numel()
        out[j] = parts
    return [torch.cat([out[j][n] for j in range(v)]) for n in
            range(len(leaves))]


# ---------------------------------------------------------------------------
# loss functions
# ---------------------------------------------------------------------------

def _tables(schedule: str, P: int, v: int, M: int, train: bool):
    """(tables, activation depth, cotangent depth) of a schedule."""
    if not train:
        return gpipe_tables(P, M, backward=False), M, 1
    if schedule == "gpipe":
        return gpipe_tables(P, M), M, M
    if schedule == "1f1b":
        K = max(2 * P - 1, 1)
        return one_f_one_b_tables(P, M), K, K
    if P == 1:
        raise ValueError("the interleaved schedule needs 2 or more stages "
                         "(its chunks' messages go between devices)")
    tab = interleaved_1f1b_tables(P, v, M)
    return (tab,) + _buffer_depths(tab, P, v, M)


def _pipeline(stage_fn, head_loss_fn, group, schedule: str, v: int,
              keep_graph: bool, stage_tree: PyTree, other: PyTree, x,
              targets: List, like: torch.Tensor, train: bool,
              stats: Dict):
    """Run the schedule on this stage; returns (loss, stage gradients,
    other gradients, x gradient) as JAX's programs do, each gradient
    float32 and times ``1/M``, the loss and the other gradients summed
    over the pipe group in one all-reduce (every stage returns them).
    ``x``: the [M, ...] input on the first stage (None elsewhere); where
    it has a graph to ``other`` (the embedding, run on the first stage),
    its gradient joins the other gradients before the sum and no x
    gradient is returned."""
    P, d = group.size, group.index
    M = len(targets)
    tab, depth, cot_depth = _tables(schedule, P, v, M, train)
    other_leaves = list(tree_leaves(other))
    stage_leaves = list(tree_leaves(stage_tree))
    if v > 1:
        stage_leaves = _permute_slab(stage_leaves, group, v, True)
    Lv = stage_leaves[0].shape[0] // v
    chunk_leaves = [[t[c * Lv:(c + 1) * Lv].detach().requires_grad_(train)
                     for t in stage_leaves] for c in range(v)]
    chunks = [tree_unflatten(stage_tree, ls) for ls in chunk_leaves]
    head_other = tree_unflatten(other, [t.detach().requires_grad_(train)
                                        for t in other_leaves])
    x_grad = train and x is not None and x.requires_grad
    res = run_tables(tab, group, stage_fn, head_loss_fn, chunks, head_other,
                     None if x is None else x.detach(), targets, like,
                     depth=depth, cot_depth=cot_depth, train=train,
                     keep_graph=keep_graph, x_grad=x_grad)
    stats.update(peak_inputs=res["peak"], ticks=int(tab["fwd_c"].shape[1]))
    inv_m = 1.0 / M
    if not train:
        loss = (res["loss"] * inv_m).reshape(1)
        comm.all_reduce(loss, group, name="tied_all_reduce")
        return loss[0], None, None, None
    dx = torch.stack([res["dx"][m] for m in range(M)]) * inv_m \
        if x_grad else None
    dother = res["dother"] or [torch.zeros(t.shape, dtype=torch.float32,
                                           device=t.device)
                               for t in other_leaves]
    dother = [g * inv_m for g in dother]
    if x_grad and x.grad_fn is not None:
        # the embedding's gradient (first stage) joins the head's (last)
        emb = torch.autograd.grad(x, other_leaves, dx.to(x.dtype),
                                  allow_unused=True)
        dother = [a if e is None else a + e.float()
                  for a, e in zip(dother, emb)]
        dx = None
    # the loss and the replicated leaves' gradients summed over the stages
    flat = torch.cat([(res["loss"] * inv_m).reshape(1)]
                     + [g.reshape(-1) for g in dother])
    comm.all_reduce(flat, group, name="tied_all_reduce")
    loss, at, summed = flat[0].clone(), 1, []
    for g in dother:
        summed.append(flat[at:at + g.numel()].view(g.shape))
        at += g.numel()
    dstage = [torch.cat([dchunks[n] for dchunks in res["dchunks"]]) * inv_m
              for n in range(len(stage_leaves))]
    if v > 1:
        dstage = _permute_slab(dstage, group, v, False)
    return loss, dstage, summed, dx


def make_1f1b_loss_fn(stage_fn: Callable, head_loss_fn: Callable,
                      num_stages: int, mesh, stage_params_specs=None, *,
                      axis: str = "pipe") -> Callable:
    """``(stage_params, other_params, x_micro, target_micro) -> loss``
    under the 1F1B schedule, differentiable in the stage's rows, the
    other parameters and ``x_micro`` (the last summed over the stages, as
    JAX's ``psum``). ``stage_params_specs``: taken for the JAX signature
    (the stage's rows are the ones given)."""
    del stage_params_specs
    return _explicit_loss_fn(stage_fn, head_loss_fn, num_stages, mesh,
                             "1f1b", 1, axis)


def make_interleaved_loss_fn(stage_fn, head_loss_fn, num_stages, v,
                             num_micro, mesh, stage_params_specs=None, *,
                             axis: str = "pipe"):
    """As :func:`make_1f1b_loss_fn` under the interleaved 1F1B schedule
    over ``v`` chunks a device; the stage's rows are its natural ones
    (moved into virtual-stage order inside)."""
    del stage_params_specs, num_micro
    return _explicit_loss_fn(stage_fn, head_loss_fn, num_stages, mesh,
                             "interleaved", v, axis)


def _explicit_loss_fn(stage_fn, head_loss_fn, num_stages, mesh, schedule,
                      v, axis):
    def loss_fn(stage_params, other_params, x_micro, target_micro):
        group = pipe_group(mesh, num_stages, axis)
        s_leaves = list(tree_leaves(stage_params))
        o_leaves = list(tree_leaves(other_params))
        n_s, n_o = len(s_leaves), len(o_leaves)
        targets = list(target_micro)
        like = x_micro[0]

        def run(*inputs):
            st = tree_unflatten(stage_params, inputs[:n_s])
            ot = tree_unflatten(other_params, inputs[n_s:n_s + n_o])
            x = inputs[n_s + n_o]
            loss, dstage, dother, dx = _pipeline(
                stage_fn, head_loss_fn, group, schedule, v, False, st, ot,
                x if group.index == 0 else None, targets, like, True,
                loss_fn.stats)
            if dx is None:
                dx = torch.zeros(x.shape, dtype=torch.float32,
                                 device=x.device)
            comm.all_reduce(dx, group, name="tied_all_reduce")
            return loss, list(dstage) + list(dother) + [dx]
        if not torch.is_grad_enabled():
            return _pipeline(stage_fn, head_loss_fn, group, "gpipe", 1,
                             False, stage_params, other_params,
                             x_micro if group.index == 0 else None, targets,
                             like, False, loss_fn.stats)[0]
        return _Stashed.apply(run, *s_leaves, *o_leaves, x_micro)
    loss_fn.stats = {}
    return loss_fn


def make_pipelined_loss_fn(embed_fn: Callable,
                           stage_fn: Callable,
                           head_loss_fn: Callable,
                           split_params: Callable,
                           num_stages: int,
                           num_micro: int,
                           mesh,
                           stage_params_specs=None,
                           *,
                           remat_stage: bool = True,
                           schedule: str = "1f1b",
                           virtual_chunks: int = 1,
                           axis: str = "pipe",
                           num_layers: Optional[int] = None) -> Callable:
    """An engine-contract loss ``(params, batch, rng) -> loss`` running
    the pipeline over the ``pipe`` axis of ``mesh`` (None: the registered
    one).

    - ``embed_fn(other_params, batch) -> (x [B, ...], targets [B, ...])``
      runs with gradients on the first stage only (the others read its
      targets and the activation's shape);
    - ``split_params(params) -> (stacked stage params, other params)``:
      the stacked leaves hold this stage's rows (the engine gives a loss
      with ``pipe_stages`` its ``pipe`` pieces), or all ``num_layers``
      rows, of which the stage takes its own;
    - ``stage_fn(stage_rows, x) -> y`` runs layers in order;
      ``head_loss_fn(other, y, targets) -> scalar`` one microbatch's mean
      loss, on the last stage;
    - ``schedule``: ``"1f1b"`` (the default: at most ``2(P - 1 - s) + 1``
      stage inputs held on stage ``s``; its loss carries ``eval_fn``, the
      forward-only GPipe, which the engine's ``eval_batch`` takes),
      ``"gpipe"`` (fill-drain; ``remat_stage`` False keeps each
      microbatch's graph instead of rerunning the stage) or
      ``"interleaved"`` (``virtual_chunks`` chunks a device, Megatron's
      interleaving; ``num_micro`` a multiple of the stage count; the
      rows' permutation into virtual-stage order happens inside, so the
      optimizer state and checkpoints keep the natural layer order).

    ``B`` (the rows this rank computes) must split into ``num_micro``
    microbatches (JAX's assertion). The loss carries ``pipe_stages``
    (the engine's marker) and ``stats`` (the last call's ``peak_inputs``
    and ``ticks``). ``stage_params_specs``: taken for the JAX signature."""
    del stage_params_specs
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    if schedule == "interleaved" and virtual_chunks < 2:
        raise ValueError("schedule='interleaved' needs virtual_chunks >= 2"
                         " (with 1 chunk it IS plain 1f1b)")
    v = virtual_chunks if schedule == "interleaved" else 1
    keep_graph = schedule == "gpipe" and not remat_stage

    def _inputs(other, batch, group, train):
        """(x [M, mb, ...] on the first stage, with a graph to ``other``
        when training, else None; the targets per microbatch on the last
        stage, else Nones; an activation-shaped tensor)."""
        first = group.index == 0
        with torch.set_grad_enabled(train and first):
            x, targets = embed_fn(other, batch)
            B = x.shape[0]
            if B % num_micro:
                raise AssertionError((B, num_micro))      # JAX's assertion
            mb = B // num_micro

            def micro(t):
                return t.reshape((num_micro, mb) + tuple(t.shape[1:]))
            x = micro(x)
        targets = list(micro(targets)) if group.index == group.size - 1 \
            else [None] * num_micro
        return (x if first else None), targets, x[0] if first \
            else x[0].clone()

    def _run(params, batch, train):
        group = pipe_group(mesh, num_stages, axis)
        stage_params, other_params = split_params(params)
        stage_params = stage_rows(stage_params, group, num_layers)
        if v > 1:
            L = next(iter(tree_leaves(stage_params))).shape[0] * group.size
            if L % (group.size * v):
                # a non-dividing L would silently truncate the model
                raise ValueError(
                    f"interleaved schedule needs stacked layers "
                    f"({L}) divisible by stages*chunks "
                    f"({num_stages}*{virtual_chunks})")
        if not train:
            x, targets, like = _inputs(other_params, batch, group, False)
            return _pipeline(stage_fn, head_loss_fn, group, "gpipe", 1,
                             False, stage_params, other_params, x, targets,
                             like, False, loss_fn.stats)[0]
        s_leaves = list(tree_leaves(stage_params))
        o_leaves = list(tree_leaves(other_params))

        def run(*inputs):
            st = tree_unflatten(stage_params, inputs[:len(s_leaves)])
            ot = tree_unflatten(other_params, inputs[len(s_leaves):])
            x, targets, like = _inputs(ot, batch, group, True)
            loss, dstage, dother, _ = _pipeline(
                stage_fn, head_loss_fn, group, schedule, v, keep_graph, st,
                ot, x, targets, like, True, loss_fn.stats)
            return loss, list(dstage) + list(dother)
        return _Stashed.apply(run, *s_leaves, *o_leaves)

    def loss_fn(params, batch, rng):
        del rng
        leaves = tree_leaves(params)
        train = torch.is_grad_enabled() and any(t.requires_grad
                                                for t in leaves)
        return _run(params, batch, train)

    def eval_fn(params, batch, rng):
        del rng
        return _run(params, batch, False)

    loss_fn.pipe_stages = num_stages
    loss_fn.stats = {}
    if schedule != "gpipe":
        loss_fn.eval_fn = eval_fn
    return loss_fn

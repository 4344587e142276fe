"""ZeRO's sharded state across data-parallel ranks.

The JAX package realises ZeRO as shardings (``deepspeed_tpu/runtime/
config.py:156-165``) and lets XLA insert the collectives. The port runs
the same stages by hand over the mesh's process groups, leaf by leaf,
from the specs of ``parallel/sharding.py``:

- every rank computes the gradient of its rows of each micro batch over
  the whole parameter tree in the compute dtype;
- stage 0: gradients are all-reduced, every rank updates every leaf;
- stage 1: optimizer state sharded over ``data`` (x ``fsdp``): gradients
  are all-reduced, each rank updates its slice of the parameters with
  its slice of the state, and the slices are all-gathered;
- stage 2: as stage 1, with the gradients reduce-scattered into the
  slice;
- stage 3: master parameters sharded over ``fsdp`` too: the compute-dtype
  tree is all-gathered at the step's start (one gather per leaf), used
  for the forward and backward, and freed after; the update runs on the
  slice, whose pieces are gathered back into the rank's master shard
  when the state is also split over ``data`` (``replica_parallel_size``).

Under sequence parallelism every sequence rank of a dp rank holds the
same shards (no spec names ``sequence``): the gradients are summed over
the dp x sequence ranks (one all-reduce where the update is not split;
over ``sequence`` first, then the dp reduce-scatter, where it is), and
the step's metrics are reduced over dp x sequence with each gradient
square counted once.

A leaf's *store* box is the part of it a rank keeps as master parameter
(the whole leaf at stages 0-2); its *update* box the part whose optimizer
state it keeps and updates (the ``opt_state_specs`` spec). Both are
slices of the global shape; the update box lies inside the store box.

Tensor parallelism (a ``model`` axis above 1, specs from partition
rules): the store box of a split leaf is its model piece (cut further
over ``fsdp`` at stage 3), and its *compute* box the part the loss
function is given: the model piece for a loss that runs Megatron's
layers (one with a ``tp_columns`` attribute, ``models.gpt``'s and
``models.bert``'s, whose fused qkv pieces hold head-aligned columns:
``columns``, the stored order of a leaf's last dim), the whole leaf for
any other loss (gathered over ``model`` before the call, as stage 3
gathers ``fsdp``: a difference in memory, not in results). The step's
loss, gradient squares and overflow flag are reduced over the dp x
sequence x model ranks, each replicated leaf's squares counted once.
Where JAX's optimizer-state spec does not refine the parameter spec (it
is keyed by shape, and two leaves of one shape may be split
differently), the update box is the parameter spec's own refinement
(``data`` added as ``opt_state_specs`` adds it): the update is
elementwise, so only the memory differs.

Pipeline parallelism (a ``pipe`` axis above 1, specs from
``gpt_pipeline_partition_rules``): the store box of a stacked layer leaf
is its stage's rows (cut further over ``fsdp`` at stage 3 and over
``model`` under TP), and so is its compute box for a pipeline loss (one
with a ``pipe_stages`` attribute, ``runtime/pipe/engine.py``'s); any
other loss gets the whole leaf, gathered over ``pipe``. The pipeline loss
sums the replicated leaves' gradients over the stages itself, so the
engine sums every gradient over dp x sequence only, and reduces the
step's loss, squares and overflow flag over dp x sequence x model x pipe,
each pipe piece's squares counted once on its owner and each replicated
leaf's once overall.
"""

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.parallel import comm
from deepspeed_tpu_torch.parallel.mesh import (BATCH_AXES, GRAD_AXES,
                                              METRIC_AXES, SPLIT_AXES, Mesh)
from deepspeed_tpu_torch.parallel.sharding import (NamedSharding, _add_axis,
                                                   opt_state_specs,
                                                   param_specs, spec_axes)
from deepspeed_tpu_torch.parallel.tensor import cut as cut_columns
from deepspeed_tpu_torch.runtime.utils import sum_of_squares
from deepspeed_tpu_torch.tree import (tree_leaves, tree_map, tree_paths,
                                      tree_unflatten)

Box = Tuple[slice, ...]


def box_shape(box: Box) -> Tuple[int, ...]:
    return tuple(s.stop - s.start for s in box)


def full_box(shape: Sequence[int]) -> Box:
    return tuple(slice(0, d) for d in shape)


def relative(inner: Box, outer: Box) -> Box:
    """``inner`` in the coordinates of ``outer`` (which holds it)."""
    return tuple(slice(i.start - o.start, i.stop - o.start)
                 for i, o in zip(inner, outer))


def contains(outer: Box, inner: Box) -> bool:
    return all(o.start <= i.start and i.stop <= o.stop
               for i, o in zip(inner, outer))


def _row_pieces(boxes: Sequence[Box], shape: Sequence[int]) -> bool:
    """Whether ``boxes`` are equal consecutive pieces of dim 0 in order
    (the members' pieces then concatenate to the whole, flat)."""
    if not shape or any(b[1:] != full_box(shape)[1:] for b in boxes):
        return False
    step = shape[0] // len(boxes)
    return all(b[0] == slice(i * step, (i + 1) * step)
               for i, b in enumerate(boxes))


def gather_boxes(out: torch.Tensor, mine: torch.Tensor, group,
                 boxes: Sequence[Box]) -> torch.Tensor:
    """``out[boxes[j]]`` = member ``j``'s ``mine``, for every member of
    ``group`` (an all-gather; ``out`` contiguous)."""
    n = group.size
    if _row_pieces(boxes, out.shape):
        comm.all_gather(out.view(-1), mine.reshape(-1), group)
        return out
    flat = torch.empty(n * mine.numel(), dtype=out.dtype, device=out.device)
    comm.all_gather(flat, mine.reshape(-1), group)
    for j, (piece, b) in enumerate(zip(flat.view(n, -1), boxes)):
        out[b].copy_(piece.view(box_shape(b)))
    return out


def reduce_scatter_boxes(full: torch.Tensor, group, boxes: Sequence[Box],
                         mine: Box) -> torch.Tensor:
    """The sum over ``group`` of each member's ``full[mine]``: member
    ``j`` gets its ``boxes[j]`` (a reduce-scatter)."""
    out = torch.empty(box_shape(mine), dtype=full.dtype, device=full.device)
    if _row_pieces(boxes, full.shape) and full.is_contiguous():
        inp = full.view(-1)
    else:
        inp = torch.cat([full[b].reshape(-1) for b in boxes])
    comm.reduce_scatter(out.view(-1), inp, group)
    return out


@dataclass
class LeafLayout:
    """Where one leaf lives on this rank (see the module docstring)."""
    path: str
    shape: Tuple[int, ...]
    store_spec: Tuple
    update_spec: Tuple
    store_box: Box
    update_box: Box
    compute_box: Box               # what the loss function is given
    dp_boxes: Tuple[Box, ...]      # every dp member's update box, in the
                                   # compute box's coordinates
    replicas: int                  # dp x model x pipe members holding
                                   # this update box
    split_boxes: Tuple[Box, ...]   # every dp x model x pipe member's
                                   # update box
    split_store_boxes: Tuple[Box, ...]   # and store box
    gather: Any                    # AxisGroup of the store spec's axes
                                   # the compute box spans
    gather_boxes: Tuple[Box, ...]  # its members' store boxes, in compute
    whole: Any                     # AxisGroup of every store spec axis
    whole_boxes: Tuple[Box, ...]   # its members' store boxes
    sync: Any                      # AxisGroup of the update's extra axes
    sync_boxes: Tuple[Box, ...]    # its members' update boxes, in store
    columns: Optional[torch.Tensor] = None   # the stored column order

    @property
    def store_shape(self) -> Tuple[int, ...]:
        return box_shape(self.store_box)

    @property
    def update_shape(self) -> Tuple[int, ...]:
        return box_shape(self.update_box)

    @property
    def store_is_full(self) -> bool:
        return self.store_box == full_box(self.shape)

    @property
    def stored_columns(self) -> Optional[torch.Tensor]:
        """The column map of the leaf as this rank stores it (None: JAX's
        order; a leaf kept whole is kept in JAX's order)."""
        return None if self.store_is_full else self.columns

    @property
    def store_is_compute(self) -> bool:
        return self.store_box == self.compute_box

    @property
    def update_is_store(self) -> bool:
        return self.update_box == self.store_box

    @property
    def update_split(self) -> bool:
        """Whether the ranks split the leaf's update (its optimizer
        state) between them."""
        return self.update_box != full_box(self.shape)

    @property
    def dp_split(self) -> bool:
        """Whether the dp ranks split the update of the compute box."""
        return len(set(self.dp_boxes)) > 1

    @property
    def update_in_compute(self) -> Box:
        return relative(self.update_box, self.compute_box)


def _dp_axes(spec) -> Tuple[str, ...]:
    return tuple(a for a in BATCH_AXES if a in spec_axes(spec))


def _only(spec, axes) -> Tuple:
    """A spec with every axis but ``axes`` dropped."""
    def keep(e):
        left = tuple(a for a in (e if isinstance(e, tuple) else (e,))
                     if a in axes)
        return None if not left else left[0] if len(left) == 1 else left
    return tuple(keep(e) for e in spec)


class ZeroPartition:
    """The layouts of a parameter tree over a mesh at a ZeRO stage, and
    the collectives of the sharded step. ``shapes``: a nested dict whose
    leaves have the global shapes (tensors or fake tensors). ``columns``:
    ``{path: stored column order}`` of the leaves whose model pieces hold
    reordered columns (a TP loss's ``tp_columns``, given with
    ``model_pieces``); ``model_pieces``: whether the loss function is
    given the model pieces (else whole leaves); ``pipe_pieces``: whether
    it is given each stage's rows (a pipeline loss; else whole leaves)."""

    def __init__(self, shapes: Dict, mesh: Mesh, stage: int,
                 rules: Optional[Sequence] = None,
                 min_shard_size: int = 1024,
                 columns: Optional[Dict[str, torch.Tensor]] = None,
                 model_pieces: bool = False, pipe_pieces: bool = False):
        self.mesh, self.stage = mesh, int(stage)
        self.columns = dict(columns or {})
        self.model_pieces = bool(model_pieces)
        # the axes whose pieces the loss function takes as they are
        self.pieces = (("model",) if model_pieces else ()) \
            + (("pipe",) if pipe_pieces else ())
        self.param_specs = param_specs(shapes, mesh, zero_stage=stage,
                                       rules=list(rules or []),
                                       min_shard_size=min_shard_size)
        # a moment leaf is shaped like its parameter: its spec is the one
        # opt_state_specs gives the parameter's shape (the JAX package's)
        self.update_specs = opt_state_specs(
            shapes, self.param_specs, shapes, mesh, zero_stage=stage,
            min_shard_size=min_shard_size)
        self.dp = mesh.group(BATCH_AXES)
        # the sequence ranks of this dp rank (replicas of its state), and
        # the dp x sequence ranks the gradients are summed over
        self.seq = mesh.group("sequence")
        self.grad_group = mesh.group(GRAD_AXES)
        # the model and pipe ranks of this rank; the ranks the step's
        # metrics are reduced over, and those that may split one leaf's
        # state
        self.model = mesh.group("model")
        self.pipe = mesh.group("pipe")
        self.metric_group = mesh.group(METRIC_AXES)
        self.split_group = mesh.group(SPLIT_AXES)
        dp_coords = [mesh.coord_of(r) for r in self.dp.ranks]
        split_coords = [mesh.coord_of(r) for r in self.split_group.ranks]
        me = mesh.coord
        data_size = mesh.shape.get("data", 1)

        def layout(path, leaf, pspec, uspec):
            shape = tuple(leaf.shape)
            store_of = NamedSharding(mesh, pspec).index
            store = store_of(shape, me)
            if not contains(store, NamedSharding(mesh, uspec).index(shape,
                                                                    me)):
                uspec = _add_axis(pspec, shape, "data", data_size,
                                  min_shard_size, mesh_shape=mesh.shape) \
                    if self.stage >= 1 else pspec
            update_of = NamedSharding(mesh, uspec).index
            update = update_of(shape, me)
            compute = NamedSharding(mesh, _only(pspec, self.pieces)).index(
                shape, me)
            gather = mesh.group(tuple(a for a in spec_axes(pspec)
                                      if a not in self.pieces))
            whole = mesh.group(spec_axes(pspec))
            sync_axes = tuple(a for a in _dp_axes(uspec)
                              if a not in _dp_axes(pspec))
            sync = mesh.group(sync_axes)
            split_boxes = tuple(update_of(shape, c) for c in split_coords)
            return LeafLayout(
                path=path, shape=shape, store_spec=pspec, update_spec=uspec,
                store_box=store, update_box=update, compute_box=compute,
                dp_boxes=tuple(relative(update_of(shape, c), compute)
                               for c in dp_coords),
                replicas=sum(b == update for b in split_boxes),
                split_boxes=split_boxes,
                split_store_boxes=tuple(store_of(shape, c)
                                        for c in split_coords),
                gather=gather,
                gather_boxes=tuple(relative(store_of(shape,
                                                     mesh.coord_of(r)),
                                            compute) for r in gather.ranks),
                whole=whole,
                whole_boxes=tuple(store_of(shape, mesh.coord_of(r))
                                  for r in whole.ranks),
                sync=sync,
                sync_boxes=tuple(relative(update_of(shape, mesh.coord_of(r)),
                                          store) for r in sync.ranks),
                columns=self.columns.get(path))

        specs = tree_map(lambda p, u: (p, u), self.param_specs,
                         self.update_specs)
        flat = []
        for (path, leaf), (ps, us) in zip(tree_paths(shapes),
                                          tree_leaves(specs)):
            flat.append(layout(path, leaf, ps, us))
        self.layouts = tree_unflatten(shapes, flat)
        self.flat = flat
        # whether this rank keeps every master leaf whole, and whether it
        # keeps every leaf as the loss function takes it
        self.store_is_full = all(lay.store_is_full for lay in flat)
        self.store_is_compute = all(lay.store_is_compute for lay in flat)

    # ------------------------------------------------------------------
    @staticmethod
    def cut(t: torch.Tensor, lay: LeafLayout, box: Optional[Box] = None
            ) -> torch.Tensor:
        """``box`` (default the store box) of a whole JAX-order leaf, in
        the stored order: a view where no column map applies."""
        box = lay.store_box if box is None else box
        return cut_columns(t, box, lay.stored_columns)

    def shard(self, tree: Dict) -> Dict:
        """A full tree cut to this rank's store boxes; a leaf whose box is
        the whole keeps its tensor."""
        return tree_map(lambda t, lay: t if lay.store_is_full
                        else self.cut(t, lay).clone(), tree, self.layouts)

    def update_slices(self, store: Dict) -> Dict:
        """The update box of each store leaf: the leaf itself where the
        two boxes agree (updated in place), else a contiguous copy, which
        :meth:`write_back` returns to the store."""
        def part(t, lay):
            if lay.update_is_store:
                return t
            return t[relative(lay.update_box, lay.store_box)].contiguous()
        return tree_map(part, store, self.layouts)

    @torch.no_grad()
    def write_back(self, store: Dict, updated: Dict) -> None:
        """The updated slices into the store leaves: gathered over the
        ranks that split the rank's store box between them."""
        for t, u, lay in zip(tree_leaves(store), tree_leaves(updated),
                             self.flat):
            if lay.update_is_store:
                continue
            if lay.sync.size > 1:
                gather_boxes(t, u, lay.sync, lay.sync_boxes)
            else:
                t[relative(lay.update_box, lay.store_box)].copy_(u)

    @torch.no_grad()
    def full(self, store: Dict, dtype: Optional[torch.dtype] = None) -> Dict:
        """Every leaf whole in JAX's column order (its floats in ``dtype``,
        or as stored): the store leaves gathered over the ranks that shard
        them (stage 3, the model axis); the store itself where it is whole
        and ``dtype`` None."""
        if dtype is None and self.store_is_full:
            return store

        def whole(t, lay):
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            return self.whole_leaf(t, lay)
        return tree_map(whole, store, self.layouts)

    @staticmethod
    @torch.no_grad()
    def whole_leaf(t: torch.Tensor, lay: LeafLayout) -> torch.Tensor:
        """One store leaf whole in JAX's column order (a collective of the
        ranks that split it)."""
        if lay.store_is_full:
            return t
        out = torch.empty(lay.shape, dtype=t.dtype, device=t.device)
        gather_boxes(out, t, lay.whole, lay.whole_boxes)
        if lay.stored_columns is not None:
            out = out.index_select(-1, torch.argsort(lay.columns)
                                   .to(out.device))
        return out

    @torch.no_grad()
    def compute(self, store: Dict, dtype: Optional[torch.dtype] = None
                ) -> Dict:
        """Every leaf's compute box (the loss function's operand; its
        floats in ``dtype``, or as stored): gathered over the ranks that
        split it inside that box; the store itself where it is the
        compute tree and ``dtype`` None."""
        if dtype is None and self.store_is_compute:
            return store

        def piece(t, lay):
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            if lay.store_is_compute:
                return t
            out = torch.empty(box_shape(lay.compute_box), dtype=t.dtype,
                              device=t.device)
            return gather_boxes(out, t, lay.gather, lay.gather_boxes)
        return tree_map(piece, store, self.layouts)

    @torch.no_grad()
    def reduce_grads(self, grads: Dict) -> Dict:
        """Each rank's full gradients summed over the dp ranks, cut to its
        update boxes: all-reduced then cut at stages 0-1, reduce-scattered
        at stages 2-3 where the update is split."""
        def reduce(g, lay):
            if self.stage >= 2 and lay.dp_split:
                if self.seq.size > 1:
                    comm.all_reduce(g, self.seq)
                return reduce_scatter_boxes(g.contiguous(), self.dp,
                                            lay.dp_boxes,
                                            lay.update_in_compute)
            comm.all_reduce(g, self.grad_group)
            if lay.update_box != lay.compute_box:
                return g[lay.update_in_compute].contiguous()
            return g
        return tree_map(reduce, grads, self.layouts)

    @torch.no_grad()
    def step_metrics(self, grads: Dict, loss: torch.Tensor,
                     check_overflow: bool):
        """(global loss, global gradient norm, overflow flag tensor) in
        one all-reduce over the dp x sequence (x model x pipe) ranks: the
        weighted loss contributions summed (each model and pipe rank
        holds the same loss), the gradients' squares counted once per
        element (each rank's update boxes over their replicas), and
        whether any rank saw a non-finite gradient."""
        leaves = list(tree_leaves(grads))
        dev = loss.device
        sq = sum_of_squares(grads, [1.0 / (lay.replicas * self.seq.size)
                                    for lay in self.flat])
        flag = torch.zeros((), dtype=torch.float64, device=dev)
        if check_overflow:
            flag = torch.stack([(~torch.isfinite(g).all()) for g in leaves]
                               ).any().to(torch.float64)
        packed = torch.stack([loss.detach().to(torch.float64)
                              / (self.model.size * self.pipe.size), sq,
                              flag])
        comm.all_reduce(packed, self.metric_group)
        return packed[0].float(), packed[1].sqrt().float(), packed[2] > 0

    def leaf_norm_sums(self) -> List[Optional[Any]]:
        """Per leaf (tree order): None where this rank updates the whole
        leaf, else a callable summing a float64 tensor of the slice's sums
        of squares over the ranks that split the leaf (LAMB's norms)."""
        def summer(lay):
            def total(local: torch.Tensor) -> torch.Tensor:
                local = local / lay.replicas
                return comm.all_reduce(local, self.split_group)
            return total
        return [summer(lay) if lay.update_split else None
                for lay in self.flat]

    def owners(self, kind: str) -> List[bool]:
        """Per leaf: whether this rank is the lowest dp x model x pipe rank
        holding its store (``kind`` "store") or update box (the one that
        writes it to a checkpoint); a sequence rank after the first of its
        dp rank owns nothing (it holds replicas)."""
        if self.seq.index > 0:
            return [False] * len(self.flat)
        out = []
        me = self.split_group.index
        for lay in self.flat:
            boxes = lay.split_store_boxes if kind == "store" \
                else lay.split_boxes
            out.append(next(j for j, b in enumerate(boxes) if b == boxes[me])
                       == me)
        return out


"""Tensor parallelism: Megatron's column- and row-parallel layers over the
mesh's ``model`` group, written out.

The JAX package shards the weights by its partition rules
(``models/gpt.py gpt_partition_rules``) and lets GSPMD insert the two
all-reduces per layer that Megatron places by hand. The port places them
by hand:

- :func:`copy_to_model` (identity forward, all-reduce backward) on the
  input of a column-parallel region (qkv, ``mlp_in``, ``mlp_gate``: each
  rank holds its heads' and its ``d_ff`` slice's columns);
- :func:`reduce_from_model` (all-reduce forward, identity backward) on the
  partial sum of a row-parallel layer (``attn_out``, ``mlp_out``: each
  rank holds the matching rows), before its bias.

So the residual stream, the norms, the embeddings and the head are
replicated and identical on every model rank, and their gradients come out
identical without a reduction. Both all-reduces go through
``parallel/comm.py``, counted under ``tp_all_reduce``.

The fused qkv projection ``[q H*Dh | k Hkv*Dh | v Hkv*Dh]`` is not
head-aligned under a contiguous cut: the JAX spec ``P(None, None,
"model")`` gives rank 0 the first ``qkv_dim / n`` columns, q and k mixed,
and GSPMD reshards. The port keeps JAX's shard shape and gives piece ``r``
the head-aligned columns ``[q heads r*H/n.. | k heads r*Hkv/n.. | v heads
r*Hkv/n..]`` (:func:`qkv_columns`): a rank's piece is then the fused qkv
of a model with ``H / n`` heads. :func:`shard` cuts a tree by its specs
with those column maps, and every export puts the columns back in JAX's
order (:func:`unshard`, ``runtime/zero/partition.py``). Head counts that
``n`` does not divide raise ``NotImplementedError``
(:data:`UNEVEN_HEADS`).
"""

from typing import Dict, Optional, Sequence

import torch

from deepspeed_tpu_torch.parallel import comm
from deepspeed_tpu_torch.parallel.sharding import (NamedSharding,
                                                   PartitionRule,
                                                   param_specs)
from deepspeed_tpu_torch.tree import tree_paths

# the ROADMAP items the refusals of this slice name
UNEVEN_HEADS = ("ROADMAP §1.3.2a (head counts the model degree does not "
                "divide)")
TP_WITH_SEQUENCE = "ROADMAP §1.3.2b (tensor x sequence parallelism)"
VOCAB_PARALLEL = "ROADMAP §1.3.2c (the vocabulary-parallel embedding)"
TP_SERVING_FEATURES = "ROADMAP §1.3.2d (TP serving features)"


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        return comm.all_reduce(g, ctx.group, name="tp_all_reduce"), None


class _ReduceFromModel(torch.autograd.Function):
    """The partial sums all-reduced over the model group; identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        return comm.all_reduce(x.contiguous().clone(), group,
                               name="tp_all_reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel region: ``x`` as it is; under
    autograd its gradient is summed over ``group`` (None: one rank)."""
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel layer's partial sum summed over ``group`` (None: one
    rank, ``x`` as it is); the gradient passes through unchanged."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, group)
    return comm.all_reduce(x.contiguous(), group, name="tp_all_reduce")


# ---------------------------------------------------------------------------
# the layout of the pieces
# ---------------------------------------------------------------------------

def check_heads(n_heads: int, kv_heads: int, n: int) -> None:
    """Raise where the model degree ``n`` does not divide the head counts
    (the JAX package reshards those; the port waits for their item)."""
    if n > 1 and (n_heads % n or kv_heads % n):
        raise NotImplementedError(
            f"tensor parallelism over {n} ranks needs n_heads ({n_heads}) "
            f"and kv heads ({kv_heads}) that {n} divides; other head counts "
            f"wait for {UNEVEN_HEADS}")


def qkv_columns(n_heads: int, kv_heads: int, head_dim: int, n: int
                ) -> torch.Tensor:
    """The fused qkv's columns in the order the ``n`` model pieces hold
    them: entry ``j`` is the JAX-order column at stored position ``j``,
    piece ``r`` (positions ``[r*w, (r+1)*w)``, ``w = qkv_dim / n``) being
    ``[q heads r*H/n.. | k heads r*Hkv/n.. | v heads r*Hkv/n..]``."""
    check_heads(n_heads, kv_heads, n)
    q = torch.arange(n_heads * head_dim).view(n, -1)
    k = n_heads * head_dim + torch.arange(kv_heads * head_dim).view(n, -1)
    v = (n_heads + kv_heads) * head_dim \
        + torch.arange(kv_heads * head_dim).view(n, -1)
    return torch.cat([q, k, v], dim=1).reshape(-1)


def qkv_leaf_columns(prefix: str, n_heads: int, kv_heads: int,
                     head_dim: int, n: int) -> Dict[str, torch.Tensor]:
    """``{path: columns}`` of every leaf of the fused qkv entry at
    ``prefix`` whose last dim is its columns: the kernel, the bias and an
    int8 entry's codes and scales (one at ``n`` = 1: nothing)."""
    if n == 1:
        return {}
    cols = qkv_columns(n_heads, kv_heads, head_dim, n)
    return {f"{prefix}/{leaf}": cols
            for leaf in ("kernel", "bias", "q", "scale")}


def split_of(full_width: int, entry: Dict) -> int:
    """The model degree a column-parallel dense entry (``kernel``, or an
    int8 entry's ``q``) is split by: its full output width over its
    piece's."""
    w = (entry["q"] if "q" in entry else entry["kernel"]).shape[-1]
    if full_width % w:
        raise ValueError(f"a projection piece {w} wide is no piece of "
                         f"{full_width} columns")
    return full_width // w


def model_group(mesh, n: int):
    """The ``parallel.mesh.AxisGroup`` of the ``model`` axis of ``mesh``
    (None: the registered one, ``utils.groups``) for weights split ``n``
    ways; None when ``n`` is 1."""
    if n == 1:
        return None
    if mesh is None:
        from deepspeed_tpu_torch.utils import groups
        mesh = groups._MESH
    if mesh is None or mesh.shape.get("model", 1) != n:
        raise ValueError(
            f"the weights are split over {n} model ranks, and the mesh "
            f"{None if mesh is None else mesh.shape} has no 'model' axis "
            f"of {n}")
    group = mesh.group("model")
    if group.pg is None:
        raise ValueError("a 'model' axis above 1 needs a process group: "
                         "build the mesh after "
                         "deepspeed_tpu_torch.init_distributed")
    return group


def int8_rules(rules: Sequence[PartitionRule]) -> list:
    """``rules`` plus, for every kernel rule, the rules of an int8 entry
    (``inference/engine.py`` of the JAX package): ``q`` split as the
    kernel, the ``[..., 1, out]`` scale with its axis -2 whole (a column
    layer's scale is split with its columns, a row layer's stays
    whole)."""
    extra = []
    for r in rules:
        pat = r.pattern.pattern
        if "/kernel" in pat:
            extra.append(PartitionRule(pat.replace("/kernel", "/q"), r.spec))
            sc = list(r.spec)
            if len(sc) >= 2:
                sc[-2] = None
            extra.append(PartitionRule(pat.replace("/kernel", "/scale"),
                                       tuple(sc)))
    return list(rules) + extra


def same_columns(a: Optional[torch.Tensor], b: Optional[torch.Tensor]
                 ) -> bool:
    """Whether two column maps (None: JAX's order) are the same order."""
    if a is None or b is None:
        return a is None and b is None
    return torch.equal(a, b)


def cut(t: torch.Tensor, box, columns: Optional[torch.Tensor] = None
        ) -> torch.Tensor:
    """``box`` (slices in the stored order) of a JAX-order leaf: its last
    dim read through ``columns`` where the leaf has a column map."""
    if columns is None:
        return t[box]
    idx = columns[box[-1]].to(t.device)
    return t[box[:-1]].index_select(t.dim() - 1, idx)


def shard(tree: Dict, mesh, rules: Sequence[PartitionRule],
          columns: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """This rank's pieces of a whole JAX-order tree under ``rules`` over
    ``mesh`` (a ``parallel.mesh.Mesh``): each leaf cut at the mesh's
    coordinate by its spec, through its column map (``columns``, by
    path)."""
    columns = columns or {}
    specs = dict(tree_paths(param_specs(tree, mesh, zero_stage=0,
                                        rules=list(rules))))

    def piece(path, t):
        box = NamedSharding(mesh, specs[path]).index(tuple(t.shape),
                                                     mesh.coord)
        return cut(t, box, columns.get(path)).contiguous()
    return _map_paths(piece, tree)


def unshard(tree: Dict, mesh, shapes: Dict, rules: Sequence[PartitionRule],
            columns: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """The whole JAX-order tree from every model rank's pieces (``tree``,
    this rank's): each split leaf all-gathered over the ``model`` group
    and its columns put back in JAX's order (``shapes``: the whole tree's
    leaves or their shapes). A collective every model rank calls."""
    columns = columns or {}
    specs = dict(tree_paths(param_specs(shapes, mesh, zero_stage=0,
                                        rules=list(rules))))
    group = mesh.group("model")

    def whole(path, t):
        dims = [i for i, e in enumerate(specs[path]) if e == "model"]
        if not dims:
            return t
        dim = dims[0]
        out = comm.all_gather_dim(t, group, dim) if group.pg is not None \
            else t
        cols = columns.get(path)
        if cols is not None:
            out = out.index_select(-1, torch.argsort(cols).to(out.device))
        return out
    return _map_paths(whole, tree)


def _map_paths(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    return fn(prefix[:-1], tree)

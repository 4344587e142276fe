"""Sharding specs: ZeRO stages and tensor-parallel rules as per-leaf specs.

Port of ``deepspeed_tpu/parallel/sharding.py``, as pure functions from a
tree of shapes and the mesh's axis sizes to a spec per leaf: a tuple with
one entry per dim, each ``None``, an axis name, or a tuple of axis names
(major first). ``tuple(jax_partition_spec)`` of the JAX package's
``param_specs`` / ``opt_state_specs`` for the same tree, mesh shape and
``min_shard_size`` is the port's spec, entry for entry:

- stage 3 shards the largest free dim divisible by the ``fsdp`` size and
  at least ``min_shard_size`` over ``fsdp`` (a leaf with none stays
  replicated: a persistent parameter);
- stage >= 1 shards optimizer state over ``data`` as well: the largest
  free divisible dim, else stacked onto an already sharded dim that stays
  divisible by the combined size (``('fsdp', 'data')``);
- partition rules (``megatron_rules``, ``models.gpt.gpt_partition_rules``)
  place ``model`` first; a rank's pieces of a split leaf are what tensor
  parallelism runs (``parallel/tensor.py``).

The port's engine reads its layouts from these specs
(``runtime/zero/partition.py``); :class:`NamedSharding` (``to_named``)
gives a spec's shard shape and the slice a rank holds.
"""

import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

PyTree = Any
Spec = Tuple          # one entry per dim: None, an axis, or a tuple of axes


def _mesh_shape(mesh) -> Dict[str, int]:
    """Axis sizes of a ``parallel.mesh.Mesh`` or a dict of them."""
    return dict(getattr(mesh, "shape", mesh))


def _shape_of(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict, paths joined by ``/``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], f"{prefix}{k}/")
                for k in sorted(tree)}
    return fn(prefix[:-1], tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def entry_axes(entry) -> Tuple[str, ...]:
    """The axes of one spec entry, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis a spec names."""
    return tuple(a for e in spec for a in entry_axes(e))


# ---------------------------------------------------------------------------
# tensor-parallel partition rules
# ---------------------------------------------------------------------------

class PartitionRule:
    """(regex over a parameter's path) -> spec template, e.g.
    ``PartitionRule("attn/qkv/kernel", (None, "model"))`` column-shards a
    QKV projection. The template's entries name mesh axes or None."""

    def __init__(self, pattern: str, spec: Sequence):
        self.pattern = re.compile(pattern)
        self.spec = tuple(spec)

    def matches(self, path: str) -> bool:
        return self.pattern.search(path) is not None


def _rule_spec_for(path: str, shape: Tuple[int, ...],
                   rules: Sequence[PartitionRule]) -> Optional[Spec]:
    for rule in rules:
        if rule.matches(path):
            spec = list(rule.spec)
            # pad/truncate to rank
            if len(spec) < len(shape):
                spec = [None] * (len(shape) - len(spec)) + spec
            return tuple(spec[:len(shape)])
    return None


# ---------------------------------------------------------------------------
# ZeRO-3 fsdp sharding
# ---------------------------------------------------------------------------

def _add_fsdp_axis(spec: Spec, shape: Tuple[int, ...], fsdp_size: int,
                   min_size: int) -> Spec:
    """Shard the largest free, divisible dim over 'fsdp' (FSDP-style)."""
    if fsdp_size <= 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if "fsdp" in spec_axes(tuple(entries)):
        return tuple(entries)
    # pick largest divisible unused dim
    best, best_dim = -1, -1
    for i, d in enumerate(shape):
        if entries[i] is None and d % fsdp_size == 0 and d >= min_size \
                and d > best_dim:
            best, best_dim = i, d
    if best < 0:
        return tuple(entries)  # too small / indivisible: stays replicated
    entries[best] = "fsdp"
    return tuple(entries)


def _add_axis(spec: Spec, shape: Tuple[int, ...], axis: str, axis_size: int,
              min_size: int, mesh_shape: Optional[Dict[str, int]] = None
              ) -> Spec:
    if axis_size <= 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if axis in spec_axes(tuple(entries)):
        return tuple(entries)
    best, best_dim = -1, -1
    for i, d in enumerate(shape):
        if entries[i] is not None:
            continue
        if d % axis_size == 0 and d >= min_size and d > best_dim:
            best, best_dim = i, d
    if best < 0:
        # try stacking onto an existing sharded dim: only if the dim stays
        # divisible by the combined shard product
        mesh_shape = mesh_shape or {}
        for i, d in enumerate(shape):
            e = entries[i]
            if e is None:
                continue
            cur = entry_axes(e)
            existing = 1
            for a in cur:
                existing *= mesh_shape.get(a, 1)
            if d % (existing * axis_size) == 0:
                entries[i] = tuple(cur) + (axis,)
                return tuple(entries)
        return tuple(entries)
    entries[best] = axis
    return tuple(entries)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def param_specs(params: PyTree, mesh, zero_stage: int = 0,
                rules: Optional[Sequence[PartitionRule]] = None,
                min_shard_size: int = 1024) -> PyTree:
    """Spec tree for the parameters: partition rules first, then, at ZeRO
    stage 3, the ``fsdp`` axis. ``params``: a nested dict whose leaves
    have a ``shape`` (tensors, fake tensors, arrays)."""
    rules = rules or []
    fsdp_size = _mesh_shape(mesh).get("fsdp", 1)

    def spec_for(path, leaf):
        shape = _shape_of(leaf)
        if len(shape) == 0:
            return ()
        spec = _rule_spec_for(path, shape, rules) or (None,) * len(shape)
        if zero_stage == 3:
            spec = _add_fsdp_axis(spec, shape, fsdp_size, min_shard_size)
        return spec

    return _map_with_path(spec_for, params)


def opt_state_specs(opt_state: PyTree, params_spec_tree: PyTree,
                    params: PyTree, mesh, zero_stage: int = 0,
                    min_shard_size: int = 1024) -> PyTree:
    """Spec tree for optimizer state. At ZeRO stage >= 1 a leaf shaped
    like a parameter takes the spec of the first parameter of its shape
    (in tree order) plus the ``data`` axis; scalar leaves (step counts)
    and leaves of no parameter's shape stay replicated."""
    shape_to_spec: Dict[Tuple[int, ...], Spec] = {}
    for leaf, spec in zip(_leaves(params), _leaves(params_spec_tree)):
        shape_to_spec.setdefault(_shape_of(leaf), spec)
    mesh_shape = _mesh_shape(mesh)
    data_size = mesh_shape.get("data", 1)

    def spec_for(_path, leaf):
        shape = _shape_of(leaf)
        if len(shape) == 0:
            return ()
        base = shape_to_spec.get(shape)
        if base is None:
            return (None,) * len(shape)
        if zero_stage >= 1:
            return _add_axis(base, shape, "data", data_size, min_shard_size,
                             mesh_shape=mesh_shape)
        return base

    return _map_with_path(spec_for, opt_state)


class NamedSharding:
    """A spec over a mesh: the shard shape of a global shape, and the
    slice of it a rank holds. A dim whose entry names axes ``(a, b)`` is
    cut into ``size(a) * size(b)`` equal pieces, the piece index row-major
    over the entry's axes (the JAX package's ``NamedSharding`` layout)."""

    def __init__(self, mesh, spec: Spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self):
        return f"NamedSharding({_mesh_shape(self.mesh)}, {self.spec})"

    def _entries(self, ndim: int):
        return list(self.spec) + [None] * (ndim - len(self.spec))

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        sizes = _mesh_shape(self.mesh)
        out = []
        for d, e in zip(global_shape, self._entries(len(global_shape))):
            n = math.prod(sizes.get(a, 1) for a in entry_axes(e))
            if d % n:
                raise ValueError(f"dim {d} does not split into {n} pieces "
                                 f"({self.spec})")
            out.append(d // n)
        return tuple(out)

    def index(self, global_shape: Sequence[int],
              coord: Dict[str, int]) -> Tuple[slice, ...]:
        """The slices of ``global_shape`` held at mesh coordinate
        ``coord``."""
        sizes = _mesh_shape(self.mesh)
        piece = self.shard_shape(global_shape)
        out = []
        for p, e in zip(piece, self._entries(len(global_shape))):
            i = 0
            for a in entry_axes(e):
                i = i * sizes.get(a, 1) + coord.get(a, 0)
            out.append(slice(i * p, (i + 1) * p))
        return tuple(out)


def to_named(specs: PyTree, mesh) -> PyTree:
    """A NamedSharding per spec of a spec tree."""
    return _map_with_path(lambda _p, s: NamedSharding(mesh, s), specs)


# common TP rule sets -------------------------------------------------------

def megatron_rules() -> List[PartitionRule]:
    """Megatron-style TP rules for the models in deepspeed_tpu_torch.models:
    column-parallel QKV & MLP-in, row-parallel attn-out & MLP-out,
    vocab-parallel embedding.
    """
    return [
        PartitionRule(r"(qkv|query|key|value|wqkv)/kernel", (None, "model")),
        PartitionRule(r"(attn_out|out_proj|wo)/kernel", ("model", None)),
        PartitionRule(r"(mlp_in|mlp_gate|fc_in|wi|up_proj|gate_proj)/kernel",
                      (None, "model")),
        PartitionRule(r"(mlp_out|fc_out|wo_mlp|down_proj)/kernel",
                      ("model", None)),
        PartitionRule(r"(embed|wte|word_embeddings)/embedding",
                      ("model", None)),
        PartitionRule(r"(qkv|query|key|value|wqkv|mlp_in|mlp_gate|fc_in|wi)"
                      r"/bias", ("model",)),
    ]

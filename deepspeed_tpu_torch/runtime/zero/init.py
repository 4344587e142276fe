"""zero.Init: parameters that come into existence sharded.

Port of ``deepspeed_tpu/runtime/zero/init.py`` (the reference's
``deepspeed.zero.Init``, ``partition_parameters.py:548``: no rank ever
holds the whole model). The JAX package jits the init function with
sharded outputs; the port traces ``init_fn`` on fake tensors for the
shapes (meta tensors), derives the specs (``parallel/sharding.py``),
then runs ``init_fn`` for real and keeps, leaf by leaf, this rank's
slice, freeing each whole leaf as soon as its slice is cut.

``init_fn(rng)`` returns the tree, or yields its leaves one at a time as
``(path, tensor)`` pairs (``models.gpt.init_leaves``). Leaves yielded
one at a time may be built on the card: it then holds this rank's slices
and one whole leaf at most. A whole tree must be built on the host
wherever a leaf is split (one built on the card is refused before it is
made: the card would hold all of it). Under tensor parallelism each rank
keeps its model pieces the same way, cut as JAX cuts them.
"""

from typing import Any, Callable, Optional, Sequence

import torch

from deepspeed_tpu_torch.runtime.zero.partition import ZeroPartition
from deepspeed_tpu_torch.tree import tree_from_paths, tree_paths

PyTree = Any


class ShardedParams(dict):
    """A parameter tree of this rank's shards. ``shapes``: the global
    shapes as a tree of meta tensors; ``partition``: the ZeroPartition
    that cut it (its ``param_specs``, its mesh). ``initialize`` takes it
    as it is when its layout is the engine's."""

    def __init__(self, tree, shapes, partition: ZeroPartition):
        super().__init__(tree)
        self.shapes = shapes
        self.partition = partition


def _leaves_of(made):
    """``(path, leaf)`` of ``init_fn``'s result: its pairs as they come,
    or a tree's leaves, each dropped from the tree once handed out."""
    if not isinstance(made, dict):
        yield from made
        return
    for path, _ in list(tree_paths(made)):
        *head, last = path.split("/")
        node = made
        for k in head:
            node = node[k]
        yield path, node.pop(last)


def abstract_shapes(init_fn: Callable[[Any], PyTree], rng):
    """(``init_fn(rng)``'s tree as meta tensors: the shapes and dtypes,
    nothing computed; whether ``init_fn`` yields its leaves one at a
    time; the device types it builds them on)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        made = init_fn(rng)
        lazy = not isinstance(made, dict)
        seen = [(path, tuple(t.shape), t.dtype, t.device.type)
                for path, t in _leaves_of(made)]
    shapes = tree_from_paths(
        (path, torch.empty(shape, dtype=dtype, device="meta"))
        for path, shape, dtype, _ in seen)
    return shapes, lazy, {dev for *_, dev in seen}


def materialize_sharded(init_fn: Callable[[Any], PyTree], rng, mesh,
                        zero_stage: int = 3,
                        rules: Optional[Sequence] = None,
                        min_shard_size: int = 1024,
                        device=None) -> ShardedParams:
    """This rank's shards of ``init_fn(rng)`` under the ZeRO (and rule)
    specs of ``mesh``: a :class:`ShardedParams` whose leaves are the
    slices of the whole tree's (``rng``: what ``init_fn`` takes, a seed
    for the port's models; ``init_fn``: see the module docstring).
    device: where the slices go (None: the card, ``cuda:{local_rank}``
    under ranks). A ``model`` split is cut as the JAX package cuts it,
    contiguous; an engine whose loss takes head-aligned qkv pieces
    (``models.gpt.tp_columns``) gathers those leaves and cuts them again
    (a difference in memory, not in results)."""
    from deepspeed_tpu_torch.device import resolve_device
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    shapes, lazy, built_on = abstract_shapes(init_fn, rng)
    part = ZeroPartition(shapes, mesh, zero_stage, rules, min_shard_size)
    lays = {lay.path: lay for lay in part.flat}
    if not lazy and "cuda" in built_on \
            and not all(lay.store_is_full for lay in part.flat):
        raise ValueError(
            "zero.Init: init_fn builds the whole tree on the card, which "
            "would then hold every leaf of it; build it on the host "
            "(device='cpu') or yield the leaves one at a time "
            "(models.gpt.init_leaves)")
    kept = []
    for path, leaf in _leaves_of(init_fn(rng)):
        lay = lays[path]
        if lay.store_is_full:
            kept.append((path, leaf.to(device)))
        else:
            kept.append((path, part.cut(leaf, lay).to(device, copy=True)))
        del leaf                    # the whole leaf is freed here
    if len(kept) != len(lays):
        raise ValueError(f"zero.Init: init_fn gave {len(kept)} leaves, its "
                         f"trace {len(lays)}")
    return ShardedParams(tree_from_paths(kept), shapes, part)

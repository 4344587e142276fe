"""The device mesh over ``torch.distributed`` ranks.

Port of ``deepspeed_tpu/parallel/mesh.py``. The JAX package folds every
process group into one ``jax.sharding.Mesh`` with named axes; the port
keeps the axes and their sizes (the same arithmetic, a pure function of
the world size) and holds one process group per axis, and per group of
axes, over the ranks that share every other coordinate. Ranks are laid
out row-major over ``MESH_AXES``, as ``parallel/topology.py`` numbers
them.

Axis layout (major to minor): ``('pipe', 'data', 'fsdp', 'sequence',
'model')``: ``data`` replicated-parameter data parallelism (ZeRO 0-2),
``fsdp`` parameter-sharding data parallelism (ZeRO 3; the dp degree is
data x fsdp), ``sequence`` (sequence parallelism: ring attention or
Ulysses), ``model`` (tensor parallelism: Megatron's column and row
layers, ``parallel/tensor.py``), ``pipe``. The ``model`` group of a rank
is the ranks that share every other coordinate; they hold the same rows
and the same replicated leaves, and each its own pieces of the split
ones.

A global batch is split over ``BATCH_AXES``: the rank at data-parallel
index ``i`` (row-major over data x fsdp) holds rows ``[i*b, (i+1)*b)`` of
every micro batch, ``b`` the micro batch's rows over the dp degree
(:func:`batch_rows`), as the JAX package's ``batch_sharding`` places
them. The ranks of one sequence group hold the same rows, and each keeps
its ``S / n`` token columns of them (the model cuts them: the JAX
package's sharding of dim 1 over ``sequence``, where the ``+1``-shifted
input stays whole and the model's slice is split).

Pipeline parallelism (a ``pipe`` axis above 1): the ranks of a pipe
group hold the same rows; each stage keeps its rows of the stacked layer
leaves (``models.gpt.gpt_pipeline_partition_rules``) and every stage the
leaves the pipeline replicates (the embeddings, the final norm, the
head). A pipe-split leaf's gradient is summed over the dp x sequence
ranks only; a replicated leaf's is summed over ``pipe`` by the pipeline
loss itself (``runtime/pipe/engine.py``, the reference's
ReduceTiedGrads), so that it is equal on every stage before the engine
sums it over dp x sequence. The step's loss, gradient squares and
overflow flag are reduced over ``pipe`` too (``METRIC_AXES``).
"""

import itertools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from deepspeed_tpu_torch.parallel.sharding import NamedSharding
from deepspeed_tpu_torch.parallel.topology import ProcessTopology
from deepspeed_tpu_torch.utils import distributed as dist_lib
from deepspeed_tpu_torch.utils.logging import logger

# canonical axis order, major -> minor
MESH_AXES = ("pipe", "data", "fsdp", "sequence", "model")

# axes over which a batch is split
BATCH_AXES = ("data", "fsdp")

# the ranks over which a step's gradients are summed and its loss, norm
# and overflow flag reduced: the data-parallel ranks and the sequence
# ranks of each (the parameters are replicated over 'sequence')
GRAD_AXES = BATCH_AXES + ("sequence",)

# the ranks over which a step's loss, gradient squares and overflow flag
# are reduced under tensor and pipeline parallelism (each split leaf's
# squares on its model and pipe rank, each replicated one counted once),
# and the ranks that may split one leaf's optimizer state between them
# (LAMB's norms)
METRIC_AXES = GRAD_AXES + ("model", "pipe")
SPLIT_AXES = BATCH_AXES + ("model", "pipe")

# the batch key under which the engine hands a loss function with
# ``normalizers`` its DataParallelContext
DP_CONTEXT_KEY = "ds_data_parallel"


@dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism degrees; -1 data means 'use remaining devices'.
    A shape that does not fit raises AssertionError, the JAX package's
    error type."""
    pipe: int = 1
    data: int = -1
    fsdp: int = 1
    sequence: int = 1
    model: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, ...]:
        fixed = self.pipe * self.fsdp * self.sequence * self.model
        data = self.data
        if data == -1:
            if n_devices % fixed:
                raise AssertionError(
                    f"devices {n_devices} not divisible by "
                    f"pipe*fsdp*seq*model={fixed}")
            data = n_devices // fixed
        total = fixed * data
        if total != n_devices:
            raise AssertionError(
                f"mesh {self} requires {total} devices, have {n_devices}")
        return (self.pipe, data, self.fsdp, self.sequence, self.model)


@dataclass(frozen=True)
class AxisGroup:
    """The ranks that differ from this one only along ``axes``, in
    row-major order over those axes, and their process group (None when
    there is nothing to communicate: one rank, or a mesh without process
    groups)."""
    axes: Tuple[str, ...]
    ranks: Tuple[int, ...]
    index: int              # this rank's position in ``ranks``
    pg: Any = None

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclass(frozen=True)
class DataParallelContext:
    """What a loss function with a ``normalizers`` attribute finds under
    ``DP_CONTEXT_KEY`` in its micro batch when the engine runs it on one
    rank's rows: the rank's index over the data-parallel and sequence
    ranks (row-major over ``GRAD_AXES``: its dropout seeds' mix) and the
    loss's normalisers over the whole global micro batch (its
    ``normalizers(global_micro_batch)``)."""
    rank: int
    normalizers: Dict[str, Any]


class Mesh:
    """Axis sizes over ``MESH_AXES``, this process's rank and coordinate,
    and the process group of each axis group (``group(axes)``).

    ``ranked``: whether the mesh was built over a ``torch.distributed``
    process group; the engine runs its collectives then, also at world
    size 1, and never without one."""

    def __init__(self, dims: Sequence[int], rank: int = 0,
                 ranked: bool = False):
        self.dims = tuple(int(d) for d in dims)
        assert len(self.dims) == len(MESH_AXES)
        self.shape = dict(zip(MESH_AXES, self.dims))
        self.size = math.prod(self.dims)
        self.rank = int(rank)
        self.ranked = bool(ranked)
        self.topology = ProcessTopology(list(MESH_AXES), list(self.dims))
        self.coord = self.topology.get_coord(self.rank)._asdict()
        self._groups: Dict[Tuple[str, ...], AxisGroup] = {}
        if self.ranked:
            self._form_groups()

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"ranked={self.ranked})")

    def coord_of(self, rank: int) -> Dict[str, int]:
        return self.topology.get_coord(rank)._asdict()

    def peer_lists(self, axes: Sequence[str]):
        """Every group of ranks that differ only along ``axes``: one list
        per coordinate of the other axes, each row-major over ``axes``."""
        axes = tuple(a for a in MESH_AXES if a in axes)
        others = [a for a in MESH_AXES if a not in axes]
        out = []
        for oc in itertools.product(*(range(self.shape[a]) for a in others)):
            fixed = dict(zip(others, oc))
            out.append([self.topology.get_rank(**fixed, **dict(zip(axes, c)))
                        for c in itertools.product(
                            *(range(self.shape[a]) for a in axes))])
        return out

    def _live_axes(self, axes) -> Tuple[str, ...]:
        """``axes`` in ``MESH_AXES`` order, less those of size 1 (which
        add no peer)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in MESH_AXES if a in axes and self.shape[a] > 1)

    def _form_groups(self) -> None:
        """One process group per peer list of every combination of the
        axes above 1 (a combination's peers are those of the same axes
        less the size-1 ones), one ``new_group`` per distinct list; every
        rank takes part in every ``new_group`` call, in the same order, as
        ``torch.distributed`` requires."""
        import torch.distributed as dist
        world = dist_lib.get_world_size()
        if world != self.size:
            raise ValueError(f"a mesh of {self.size} ranks over a process "
                             f"group of {world}")
        live = [a for a in MESH_AXES if self.shape[a] > 1]
        made = {}
        for n in range(1, len(live) + 1):
            for axes in itertools.combinations(live, n):
                for peers in self.peer_lists(axes):
                    key = tuple(peers)
                    if key not in made:
                        made[key] = dist.group.WORLD if len(peers) == world \
                            else dist.new_group(peers)
                    if self.rank in peers:
                        self._groups[axes] = AxisGroup(
                            axes, key, peers.index(self.rank), made[key])
        # a world of one rank still runs its collectives over the world
        if world == 1:
            self._groups[()] = AxisGroup((), (0,), 0, dist.group.WORLD)

    def group(self, axes: Union[str, Sequence[str]]) -> AxisGroup:
        """The group of ranks that differ from this one only along
        ``axes`` (an axis name or a sequence of them). The group of one
        rank has no process group, but in a ranked world of one, whose
        collectives run over the world."""
        axes = self._live_axes(axes)
        if axes in self._groups:
            return self._groups[axes]
        peers = next(p for p in self.peer_lists(axes) if self.rank in p)
        return AxisGroup(axes, tuple(peers), peers.index(self.rank), None)

    def axis_index(self, axes: Union[str, Sequence[str]]) -> int:
        """This rank's row-major index over ``axes``."""
        return self.group(axes).index


def _world_and_rank(world_size: Optional[int], rank: Optional[int]):
    ranked = dist_lib.is_initialized() and world_size is None
    if world_size is None:
        world_size = dist_lib.get_world_size()
    if rank is None:
        rank = dist_lib.get_rank() if ranked else 0
    return int(world_size), int(rank), ranked


def make_mesh(spec: Optional[MeshSpec] = None,
              world_size: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """The framework mesh over the process group's ranks (one rank without
    one). An explicit ``world_size`` builds the shape alone, without
    process groups (``rank`` places this process in it)."""
    spec = spec or MeshSpec()
    world_size, rank, ranked = _world_and_rank(world_size, rank)
    return Mesh(spec.resolve(world_size), rank=rank, ranked=ranked)


def mesh_spec_from_config(cfg, n: int) -> MeshSpec:
    """The MeshSpec of a DeepSpeedConfig at ``n`` ranks: ZeRO stage 3
    moves the data-parallel degree onto the ``fsdp`` axis, split into
    ``replica_parallel_size`` outer ``data`` replicas; stages 0-2 keep it
    on ``data`` and refuse ``replica_parallel_size`` above 1."""
    m = cfg.mesh
    fixed = (m.pipeline_parallel_size * m.tensor_parallel_size *
             m.sequence_parallel_size)
    if n % fixed:
        raise AssertionError(f"{n} devices not divisible by "
                             f"pp*tp*sp={fixed}")
    dp_total = n // fixed
    if cfg.zero.stage == 3:
        rep = m.replica_parallel_size
        if dp_total % rep:
            raise AssertionError(
                f"replica_parallel_size={rep} does not divide the dp "
                f"degree {dp_total}")
        return MeshSpec(pipe=m.pipeline_parallel_size, data=rep,
                        fsdp=dp_total // rep,
                        sequence=m.sequence_parallel_size,
                        model=m.tensor_parallel_size)
    if m.replica_parallel_size > 1:
        raise ValueError(
            f"replica_parallel_size={m.replica_parallel_size} requires "
            f"zero.stage=3 (it splits dp into data replicas x fsdp "
            f"shards); stage {cfg.zero.stage} has no fsdp axis and "
            f"would silently ignore it")
    return MeshSpec(pipe=m.pipeline_parallel_size, data=dp_total, fsdp=1,
                    sequence=m.sequence_parallel_size,
                    model=m.tensor_parallel_size)


def mesh_from_config(cfg, world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> Mesh:
    """The mesh of a DeepSpeedConfig's MeshConfig over the process group
    (or over ``world_size`` ranks, shape only: :func:`make_mesh`)."""
    world, _, _ = _world_and_rank(world_size, rank)
    mesh = make_mesh(mesh_spec_from_config(cfg, world), world_size, rank)
    logger.info(f"mesh axes {mesh.shape}")
    return mesh


def _shape_of(mesh) -> Dict[str, int]:
    if isinstance(mesh, Mesh):
        return mesh.shape
    return dict(mesh)


def dp_world_size(mesh) -> int:
    """Total data-parallel degree (data x fsdp axes); ``mesh`` a Mesh or a
    dict of axis sizes."""
    shape = _shape_of(mesh)
    return shape.get("data", 1) * shape.get("fsdp", 1)


def axis_size(mesh, axis: str) -> int:
    return _shape_of(mesh).get(axis, 1)


def batch_sharding(mesh: Mesh):
    """Sharding fn for batch trees: the leading dim over the dp axes and,
    under sequence parallelism, dim 1 (the tokens) over ``sequence`` when
    it divides (the ``+1``-shifted input of a next-token batch stays
    whole: the model cuts its columns after the shift), as in the JAX
    package."""
    seq = axis_size(mesh, "sequence")

    def shard_leaf(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if seq > 1 and len(shape) >= 2 and shape[1] % seq == 0:
            return NamedSharding(mesh, (BATCH_AXES, "sequence"))
        return NamedSharding(mesh, (BATCH_AXES,))

    return shard_leaf


def batch_pspec() -> Tuple:
    return (BATCH_AXES,)


def batch_rows(mesh: Mesh, n_rows: int) -> slice:
    """The rows of an ``n_rows`` micro batch this rank holds."""
    dp = dp_world_size(mesh)
    if n_rows % dp:
        raise ValueError(f"a micro batch of {n_rows} rows does not split "
                         f"over {dp} data-parallel ranks")
    b = n_rows // dp
    i = mesh.axis_index(BATCH_AXES)
    return slice(i * b, (i + 1) * b)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def global_share(mean, batch, name: str, local_count):
    """A loss term's share of the global micro batch's mean: ``mean`` (the
    masked mean over this rank's rows, its denominator ``local_count``
    clamped at 1) times ``local_count`` over the global normaliser
    ``name`` (clamped at 1), when the batch holds a DataParallelContext;
    ``mean`` itself otherwise. Summed over the ranks, the shares are the
    global batch's masked mean (a rank with no counted element adds 0)."""
    import torch
    ctx = batch.get(DP_CONTEXT_KEY) if isinstance(batch, dict) else None
    if ctx is None:
        return mean
    total = torch.as_tensor(ctx.normalizers[name], dtype=torch.float32,
                            device=mean.device).clamp_min(1.0)
    local = torch.as_tensor(local_count, dtype=torch.float32,
                            device=mean.device)
    return mean * (local / total)


def data_parallel_rank(batch) -> int:
    """The dp rank a model mixes into its dropout seeds (0 without a
    DataParallelContext)."""
    ctx = batch.get(DP_CONTEXT_KEY) if isinstance(batch, dict) else None
    return 0 if ctx is None else ctx.rank

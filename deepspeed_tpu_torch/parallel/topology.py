"""Cartesian process topology: pure math, no devices required.

A copy of ``deepspeed_tpu/parallel/topology.py`` (the reference's
``deepspeed/runtime/pipe/topology.py``: ``ProcessTopology`` :12,
``PipeDataParallelTopology`` :235, ``PipeModelDataParallelTopology`` :246,
``PipelineParallelGrid`` :252). The coordinate math (rank <-> axis
coordinates, peer lists along an axis) is the JAX package's line for line;
the port's mesh (``parallel/mesh.py``) builds its process groups from
these peer lists. ``PipelineParallelGrid`` answers for the calling
process of the ``torch.distributed`` process group when no rank is given
(the JAX one answers for rank 0 unless told).
"""

from collections import namedtuple
from itertools import product
from typing import Dict, List, Optional


class ProcessTopology:
    """Maps n-dimensional cartesian coordinates to linear indices.

    Axis order is major to minor: the LAST axis varies fastest
    (ref: topology.py:12-24).
    """

    def __init__(self, axes: List[str], dims: List[int]):
        self.axes = list(axes)
        self.dims = list(dims)
        assert len(self.axes) == len(self.dims)
        self.ProcessCoord = namedtuple("ProcessCoord", self.axes)
        self.mapping: Dict = {}
        ranges = [range(d) for d in self.dims]
        for global_rank, coord in enumerate(product(*ranges)):
            key = dict(zip(self.axes, coord))
            self.mapping[self.ProcessCoord(**key)] = global_rank

    def get_rank(self, **coord_kwargs) -> int:
        if len(coord_kwargs) != len(self.axes):
            raise ValueError("get_rank() does not support slices, use filter_match()")
        key = self.ProcessCoord(**coord_kwargs)
        assert key in self.mapping, f"key {coord_kwargs} invalid"
        return self.mapping[key]

    def get_axis_names(self) -> List[str]:
        return self.axes

    def get_rank_repr(self, rank: int, omit_axes=("data",), inner_sep="_",
                      outer_sep="-") -> str:
        """Canonical checkpoint-path name for a rank (ref: topology.py:80)."""
        omit_axes = list(omit_axes)
        axes = [a for a in self.get_axis_names() if a not in omit_axes]
        names = []
        for ax in axes:
            ax_rank = getattr(self.get_coord(rank=rank), ax)
            names.append(f"{ax}{inner_sep}{ax_rank:02d}")
        return outer_sep.join(names)

    def get_dim(self, axis: str) -> int:
        if axis not in self.axes:
            return 0
        return self.dims[self.axes.index(axis)]

    def get_coord(self, rank: int):
        for coord, idx in self.mapping.items():
            if idx == rank:
                return coord
        raise ValueError(f"rank {rank} not found in topology")

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """All peer groups along ``axis`` (ref: topology.py:137)."""
        if axis not in self.axes:
            return []
        other_axes = [a for a in self.axes if a != axis]
        lists = []
        ranges = [range(self.get_dim(a)) for a in other_axes]
        for coord in product(*ranges):
            other_keys = dict(zip(other_axes, coord))
            sub = [self.get_rank(**other_keys, **{axis: i})
                   for i in range(self.get_dim(axis))]
            lists.append(sub)
        return lists

    def filter_match(self, **filter_kwargs) -> List[int]:
        """Ranks whose coordinates match all filters (ref: topology.py:169)."""
        def _filter_helper(x):
            for key, val in filter_kwargs.items():
                if getattr(x, key) != val:
                    return False
            return True
        coords = filter(_filter_helper, self.mapping.keys())
        return [self.mapping[coord] for coord in coords]

    def get_axis_list(self, axis: str, idx: int) -> List[int]:
        return [self.mapping[k] for k in self.mapping
                if getattr(k, axis) == idx]

    def world_size(self) -> int:
        size = 1
        for d in self.dims:
            size *= d
        return size

    def __str__(self):
        return str(self.mapping)


class PipeDataParallelTopology(ProcessTopology):
    """Hybrid pipeline+data topology; pipe-adjacent ranks are mapped close
    together (ref: topology.py:235)."""

    def __init__(self, num_pp: int, num_dp: int):
        super().__init__(axes=["pipe", "data"], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """3D pipe/data/model topology (ref: topology.py:246)."""

    def __init__(self, num_pp: int, num_mp: int, num_dp: int):
        super().__init__(axes=["pipe", "data", "model"], dims=[num_pp, num_dp, num_mp])


class PipelineParallelGrid:
    """Axis-rank bookkeeping for one process in a topology
    (ref: topology.py:252 PipelineParallelGrid). Device-free: it answers
    "who am I / who are my peers" for the scheduler and the checkpoint
    layer. ``global_rank`` None: the rank of this process in the
    ``torch.distributed`` process group (0 without one).
    """

    def __init__(self, topology: ProcessTopology,
                 global_rank: Optional[int] = None):
        if global_rank is None:
            from deepspeed_tpu_torch.utils.distributed import get_rank
            global_rank = get_rank()
        self._topo = topology
        self.global_rank = global_rank
        self.world_size = topology.world_size()

        self.data_parallel_size = max(1, topology.get_dim("data"))
        self.pipe_parallel_size = max(1, topology.get_dim("pipe"))
        self.model_parallel_size = max(1, topology.get_dim("model"))
        self.slice_parallel_size = self.model_parallel_size
        assert self.world_size == (self.data_parallel_size * self.pipe_parallel_size *
                                   self.model_parallel_size)

        coord = topology.get_coord(global_rank)
        self.stage_id = getattr(coord, "pipe", 0) if "pipe" in topology.axes else 0
        self.data_parallel_id = getattr(coord, "data", 0) if "data" in topology.axes else 0
        self.model_parallel_id = getattr(coord, "model", 0) if "model" in topology.axes else 0

        if "pipe" in topology.axes:
            self.p2p_groups = self._build_p2p_groups()
        else:
            self.p2p_groups = []

    def _build_p2p_groups(self) -> List[List[int]]:
        """Ring groups of pipe-adjacent ranks (ref: topology.py:301)."""
        comm_lists = self._topo.get_axis_comm_lists("pipe")
        groups = []
        for l in comm_lists:
            assert len(l) >= 1
            for idx in range(len(l)):
                groups.append(sorted([l[idx], l[(idx + 1) % len(l)]]))
        return [list(g) for g in groups]

    def get_stage_id(self) -> int:
        return self.stage_id

    def get_data_parallel_id(self) -> int:
        return self.data_parallel_id

    def get_pipe_parallel_rank(self) -> int:
        return self.stage_id

    def get_data_parallel_rank(self) -> int:
        return self.data_parallel_id

    def get_model_parallel_rank(self) -> int:
        return self.model_parallel_id

    def get_global_rank(self) -> int:
        return self.global_rank

    def get_data_parallel_world_size(self) -> int:
        return self.data_parallel_size

    def get_pipe_parallel_world_size(self) -> int:
        return self.pipe_parallel_size

    def get_model_parallel_world_size(self) -> int:
        return self.model_parallel_size

    def is_first_stage(self) -> bool:
        return self.stage_id == 0

    def is_last_stage(self) -> bool:
        return self.stage_id == self.pipe_parallel_size - 1

    def stage_to_global(self, stage_id: int, **kwargs) -> int:
        """Global rank of ``stage_id`` with my other coordinates
        (ref: topology.py:432)."""
        me = self._topo.get_coord(self.global_rank)
        transform = me._replace(pipe=stage_id, **kwargs)._asdict()
        return self._topo.get_rank(**transform)

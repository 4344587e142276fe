"""Mesh-axis accessors: the query surface of the reference's process
groups.

Port of ``deepspeed_tpu/utils/groups.py`` (the reference's
``deepspeed/utils/groups.py``: ``_clone_world_group`` :305,
``_get_data_parallel_group`` :321, the expert groups :107/:160/:206). The
sizes per parallel dimension are read from the registered mesh
(``deepspeed_tpu_torch.initialize`` registers the engine's). Where the
JAX package returns axis names for a "group", the port returns the
``torch.distributed`` process group of those axes
(``parallel.mesh.AxisGroup.pg``; None when the group is one rank).
"""

from typing import Optional

from deepspeed_tpu_torch.parallel import mesh as mesh_lib
from deepspeed_tpu_torch.utils import distributed as dist_lib

_MESH: Optional[mesh_lib.Mesh] = None


def set_mesh(mesh: mesh_lib.Mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> mesh_lib.Mesh:
    assert _MESH is not None, \
        "no mesh registered — deepspeed_tpu_torch.initialize() does this"
    return _MESH


def _axis(axis: str) -> int:
    return mesh_lib.axis_size(get_mesh(), axis)


# --- world ---------------------------------------------------------------

def get_world_size() -> int:
    return int(get_mesh().size)


def get_global_rank() -> int:
    return dist_lib.get_rank()


# --- data parallel (ref :321) -------------------------------------------

def get_data_parallel_world_size() -> int:
    return mesh_lib.dp_world_size(get_mesh())


def get_data_parallel_group():
    """The process group over the data x fsdp axes (the JAX package
    returns the axis names ``("data", "fsdp")``)."""
    return get_mesh().group(mesh_lib.BATCH_AXES).pg


# --- model parallel ------------------------------------------------------

def get_model_parallel_world_size() -> int:
    return _axis("model")


def get_model_parallel_group():
    """The process group over the ``model`` axis (JAX: ``("model",)``):
    the ranks whose pieces of each split leaf make the whole
    (``parallel/tensor.py``)."""
    return get_mesh().group("model").pg


# --- pipeline ------------------------------------------------------------

def get_pipe_parallel_world_size() -> int:
    return _axis("pipe")


def get_pipe_parallel_rank() -> int:
    """This rank's stage: its index in its pipe group
    (``PipelineParallelGrid.get_stage_id`` over the mesh's topology)."""
    return get_mesh().axis_index("pipe")


def get_pipe_parallel_ranks():
    """The global ranks of this rank's pipe group, stage by stage
    (``PipelineParallelGrid.stage_to_global`` of each stage)."""
    return get_mesh().group("pipe").ranks


def get_pipe_parallel_group():
    """The process group over the ``pipe`` axis: the stages' point-to-
    point messages and the tied gradients' sum
    (``runtime/pipe/engine.py``)."""
    return get_mesh().group("pipe").pg


# --- sequence ------------------------------------------------------------

def get_sequence_parallel_world_size() -> int:
    return _axis("sequence")


def get_sequence_parallel_rank() -> int:
    """This rank's index in its sequence group (its token columns:
    ``ops/attention/ring.py``)."""
    return get_mesh().axis_index("sequence")


def get_sequence_parallel_group():
    """The process group over the ``sequence`` axis (ring attention's
    rotations, Ulysses' all-to-alls)."""
    return get_mesh().group("sequence").pg


# --- expert parallel (ref :107/:160/:206) --------------------------------

def get_expert_parallel_world_size(num_experts: Optional[int] = None) -> int:
    """Experts shard over the dp axes; the EP degree is min(dp, experts)."""
    dp = get_data_parallel_world_size()
    if num_experts is None:
        return dp
    return min(dp, num_experts)


def get_expert_data_parallel_world_size(num_experts: int) -> int:
    dp = get_data_parallel_world_size()
    ep = get_expert_parallel_world_size(num_experts)
    return max(1, dp // ep)

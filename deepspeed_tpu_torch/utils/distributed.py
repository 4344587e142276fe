"""Process bootstrap over ``torch.distributed``.

Port of ``deepspeed_tpu/utils/distributed.py`` (the reference's
``deepspeed/utils/distributed.py:12 init_distributed``, ``:56
mpi_discovery``). Where the JAX package joins the multi-host JAX runtime,
the port forms one ``torch.distributed`` process group; the mesh
(``parallel/mesh.py``) then builds its axis groups inside it.

The backend: ``dist_backend`` when given, else ``nccl`` for the card and
``gloo`` when the caller's device is the CPU. NCCL takes one card per
rank; several ranks on one card (a test of the sharded step on a machine
with one card) take ``gloo``, whose collectives accept CUDA tensors.
"""
# dslint: disable-file=DS005 — process bootstrap IS the env layer here:
# rendezvous variables (MPI vars, MASTER_ADDR, DSTPU_*, torchrun's RANK /
# WORLD_SIZE) are set by the launcher and are this module's input contract.

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.utils.logging import logger

DEFAULT_PORT = "29500"


def _resolve(coordinator_address: Optional[str],
             num_processes: Optional[int], process_id: Optional[int],
             auto_mpi_discovery: bool, init_method: Optional[str]
             ) -> Tuple[Optional[str], Optional[int], Optional[int]]:
    """(init method, world size, rank) by the JAX package's order:
    explicit arguments; ``OMPI_COMM_WORLD_*`` with ``MASTER_ADDR`` /
    ``MASTER_PORT``; ``DSTPU_COORDINATOR`` / ``DSTPU_NUM_PROCESSES`` /
    ``DSTPU_PROCESS_ID``, then torchrun's ``RANK`` / ``WORLD_SIZE``;
    else (None, None, None): one process."""
    env = os.environ
    if init_method is None and coordinator_address is None:
        if "OMPI_COMM_WORLD_SIZE" in env and auto_mpi_discovery:
            num_processes = int(env["OMPI_COMM_WORLD_SIZE"])
            process_id = int(env["OMPI_COMM_WORLD_RANK"])
            coordinator_address = env.get("MASTER_ADDR", "127.0.0.1") + \
                ":" + env.get("MASTER_PORT", DEFAULT_PORT)
        elif "DSTPU_COORDINATOR" in env:
            coordinator_address = env["DSTPU_COORDINATOR"]
            num_processes = int(env.get("DSTPU_NUM_PROCESSES", "1"))
            process_id = int(env.get("DSTPU_PROCESS_ID", "0"))
        elif "RANK" in env and "WORLD_SIZE" in env:
            num_processes = int(env["WORLD_SIZE"])
            process_id = int(env["RANK"])
            coordinator_address = env.get("MASTER_ADDR", "127.0.0.1") + \
                ":" + env.get("MASTER_PORT", DEFAULT_PORT)
    if init_method is None and coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    if init_method is None:
        return None, None, None
    if num_processes is None or process_id is None:
        raise ValueError(
            f"init_distributed: {init_method} needs num_processes and "
            f"process_id (got {num_processes}, {process_id})")
    return init_method, int(num_processes), int(process_id)


def default_backend(device=None) -> str:
    """``nccl`` for the card (``device`` None or a CUDA device), ``gloo``
    for the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    return "nccl"


def init_distributed(dist_backend: Optional[str] = None,
                     coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     auto_mpi_discovery: bool = True,
                     timeout: Optional[int] = None,
                     init_method: Optional[str] = None,
                     device=None) -> bool:
    """Join the process group. Safe to call more than once.

    Resolution order, the JAX package's: explicit arguments
    (``init_method`` such as ``file:///path/store`` or ``tcp://host:port``,
    or ``coordinator_address`` ``host:port``, each with ``num_processes``
    and ``process_id``); ``OMPI_*`` (MPI launches); ``DSTPU_*`` and
    torchrun's ``RANK``/``WORLD_SIZE``; else one process, a no-op.

    dist_backend: ``nccl``, ``gloo`` or None (:func:`default_backend` of
    ``device``: None means the card). On a CUDA backend the process takes
    the card ``local_rank % device_count``. timeout: seconds. A group that
    fails to form raises; nothing falls back to one process."""
    if dist.is_initialized():
        return True
    method, world, rank = _resolve(coordinator_address, num_processes,
                                   process_id, auto_mpi_discovery,
                                   init_method)
    if method is None:
        logger.info("single-process mode (no coordinator configured)")
        return True
    backend = dist_backend or default_backend(device)
    on_card = device is None or torch.device(device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError(
            f"init_distributed: ranks on the card need a CUDA card and "
            f"torch.cuda.is_available() is False; pass dist_backend='gloo' "
            f"and device='cpu' for ranks on the host (backend {backend!r})")
    if on_card:
        torch.cuda.set_device(get_local_rank(rank)
                              % torch.cuda.device_count())
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=method, world_size=world,
                            rank=rank, **kw)
    logger.info(f"process group up: rank {rank}/{world}, backend {backend}")
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    """This process's rank in the process group; 0 without one."""
    return dist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    """Processes in the process group; 1 without one."""
    return dist.get_world_size() if is_initialized() else 1


def get_local_rank(rank: Optional[int] = None) -> int:
    """This process's rank on its host: ``LOCAL_RANK`` (torchrun),
    ``OMPI_COMM_WORLD_LOCAL_RANK``, ``DSTPU_LOCAL_RANK``, else the global
    rank (one host)."""
    for key in ("LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK",
                "DSTPU_LOCAL_RANK"):
        if key in os.environ:
            return int(os.environ[key])
    return get_rank() if rank is None else int(rank)


def barrier(group=None) -> None:
    """Wait for every process of ``group`` (the world by default); a
    no-op in one process."""
    if is_initialized():
        dist.barrier(group=group)


def destroy() -> None:
    """Leave the process group (a no-op without one)."""
    if is_initialized():
        dist.destroy_process_group()

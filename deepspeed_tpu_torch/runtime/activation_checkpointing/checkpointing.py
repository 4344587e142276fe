"""Activation checkpointing (rematerialization) API.

Port of ``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``,
itself the functional form of the reference DeepSpeed module:
``configure`` the options (explicit arguments over the config's
``activation_checkpointing`` section), then ``checkpoint(fn, *args)``
runs ``fn`` keeping only its inputs and recomputes its activations in the
backward. The JAX package applies ``jax.checkpoint`` with a policy; here
it is ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``:

- default: save nothing, recompute everything (``"nothing_saveable"``);
- ``partition_activations``, ``contiguous_checkpointing``,
  ``synchronize``, ``profile`` and ``number_checkpoints`` are taken and
  recorded, and change nothing on one card (as in the JAX package);
- ``checkpoint_in_cpu`` (the JAX package's offload of tagged activations
  to pinned host memory) waits for the memory-tier slice and raises.

Random draws inside ``fn`` replay in the recomputation (torch's
checkpoint stashes and restores the RNG state), so dropout sees the same
mask twice.
"""

from typing import Any, Callable, Optional

import torch.utils.checkpoint

from deepspeed_tpu_torch.utils.logging import log_dist

_config = None

NOTHING_SAVEABLE = "nothing_saveable"


class _ActCkptState:
    def __init__(self, partition_activations=False, number_checkpoints=None,
                 contiguous_checkpointing=False, checkpoint_in_cpu=False,
                 synchronize=False, profile=False,
                 offload_names=("act",)):
        self.partition_activations = partition_activations
        self.number_checkpoints = number_checkpoints
        self.contiguous_checkpointing = contiguous_checkpointing
        self.checkpoint_in_cpu = checkpoint_in_cpu
        self.synchronize = synchronize
        self.profile = profile
        self.offload_names = tuple(offload_names)


def configure(mpu_=None, deepspeed_config=None,
              partition_activations: Optional[bool] = None,
              contiguous_checkpointing: Optional[bool] = None,
              checkpoint_in_cpu: Optional[bool] = None,
              synchronize: Optional[bool] = None,
              profile: Optional[bool] = None,
              num_checkpoints: Optional[int] = None,
              offload_names=("act",)) -> None:
    """Set the options: the ``activation_checkpointing`` section of
    ``deepspeed_config`` (a ``DeepSpeedConfig`` or a dict), then every
    explicit argument that is not None over it. ``mpu_`` is taken for the
    reference API and unused. Raises NotImplementedError when the result
    asks for ``checkpoint_in_cpu``."""
    global _config
    del mpu_
    base = _ActCkptState(offload_names=offload_names)
    if deepspeed_config is not None:
        ac = deepspeed_config
        if hasattr(ac, "activation_checkpointing"):
            ac = ac.activation_checkpointing
        elif isinstance(ac, dict):
            from deepspeed_tpu_torch.runtime.config import \
                ActivationCheckpointingConfig
            ac = ActivationCheckpointingConfig.from_dict(
                ac.get("activation_checkpointing"))
        base.partition_activations = ac.partition_activations
        base.number_checkpoints = ac.number_checkpoints
        base.contiguous_checkpointing = ac.contiguous_memory_optimization
        base.checkpoint_in_cpu = ac.cpu_checkpointing
        base.synchronize = ac.synchronize_checkpoint_boundary
        base.profile = ac.profile
    for name, val in (("partition_activations", partition_activations),
                      ("contiguous_checkpointing", contiguous_checkpointing),
                      ("checkpoint_in_cpu", checkpoint_in_cpu),
                      ("synchronize", synchronize),
                      ("profile", profile),
                      ("number_checkpoints", num_checkpoints)):
        if val is not None:
            setattr(base, name, val)
    if base.checkpoint_in_cpu:
        raise NotImplementedError(
            "activation checkpointing with checkpoint_in_cpu (cpu_"
            "checkpointing: activations offloaded to host memory) waits "
            "for the memory-tier slice of the port")
    _config = base
    log_dist(
        f"activation checkpointing configured: cpu_offload="
        f"{base.checkpoint_in_cpu}, partition={base.partition_activations}",
        ranks=[0])


def is_configured() -> bool:
    return _config is not None


def reset() -> None:
    """Forget the configuration."""
    global _config
    _config = None


def current_policy() -> str:
    """What ``checkpoint`` keeps for the backward: ``"nothing_saveable"``
    (only the inputs; every activation is recomputed), the one policy a
    configuration can select here."""
    return NOTHING_SAVEABLE


def checkpoint(function: Callable, *args) -> Any:
    """``function(*args)``, only its inputs kept: its activations are
    recomputed in the backward (:func:`current_policy`)."""
    return torch.utils.checkpoint.checkpoint(function, *args,
                                             use_reentrant=False)


def checkpoint_wrapper(function: Callable) -> Callable:
    """The decorator form of :func:`checkpoint`, applied at each call."""
    def wrapped(*args, **kwargs):
        return torch.utils.checkpoint.checkpoint(
            function, *args, use_reentrant=False, **kwargs)
    return wrapped


# the reference's autograd.Function name, as the JAX package aliases it
CheckpointFunction = checkpoint

"""The ``zero`` namespace of the package's API.

``zero.Init`` (``materialize_sharded``) creates the parameters already
sharded over the ranks of a mesh, as the JAX package's does over its
devices (``runtime/zero/init.py``); ``initialize`` takes the sharded tree
as it is. The ZeRO stages themselves run in the engine
(``runtime/zero/partition.py``). The offload tiers wait for the
memory-tier slice (ROADMAP §1.4; ``zero_optimization.offload_*`` raises).
Tensor-parallel rules over a ``model`` axis cut each rank's pieces too.
"""

from deepspeed_tpu_torch.runtime.zero.init import (ShardedParams,
                                                   materialize_sharded)

# the functional form of the reference's zero.Init context manager
# (partition_parameters.py:548): parameters come into existence sharded
Init = materialize_sharded

"""Serving: the inference engine's slot programs, the paged KV cache, the
continuous-batching scheduler, the replica router and the SLO autoscaler,
with the names the JAX package's ``deepspeed_tpu.inference`` exports."""

from deepspeed_tpu_torch.inference.autoscale import SLOController
from deepspeed_tpu_torch.inference.paged_cache import (CacheExhausted,
                                                       PagedKVCache)
from deepspeed_tpu_torch.inference.router import ReplicaRouter
from deepspeed_tpu_torch.inference.serving import (DegradedError,
                                                   ServeRequest,
                                                   ServingEngine)

__all__ = ["CacheExhausted", "DegradedError", "PagedKVCache",
           "ReplicaRouter", "SLOController", "ServeRequest",
           "ServingEngine"]

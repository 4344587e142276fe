"""Serving: the inference engine's slot programs, the paged KV cache and
the continuous-batching scheduler, with the names the JAX package's
``deepspeed_tpu.inference`` exports. The replica router and the SLO
autoscaler wait for the router's slice: naming them raises
NotImplementedError."""

from deepspeed_tpu_torch.inference.paged_cache import (CacheExhausted,
                                                       PagedKVCache)
from deepspeed_tpu_torch.inference.serving import (DegradedError,
                                                   ServeRequest,
                                                   ServingEngine)

__all__ = ["CacheExhausted", "DegradedError", "PagedKVCache",
           "ServeRequest", "ServingEngine"]


def __getattr__(name):
    if name in ("ReplicaRouter", "SLOController"):
        raise NotImplementedError(
            f"deepspeed_tpu_torch.inference.{name} waits for the router "
            f"slice of the port (the replica router and the autoscaler)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

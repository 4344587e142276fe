"""The ``zero`` namespace of the package's API.

In the JAX package ``zero.Init`` (``materialize_sharded``) creates the
parameters already sharded across a device mesh. The port runs ZeRO
stages 0-3 at world size 1 through ``initialize``; parameters sharded
across cards wait for the multi-GPU slice, so these entry points raise
NotImplementedError naming it.
"""


def materialize_sharded(*args, **kwargs):
    """Create parameters sharded across devices: waits for the multi-GPU
    slice."""
    raise NotImplementedError(
        "zero.Init / materialize_sharded (parameters created sharded across "
        "devices) waits for the multi-GPU slice of the port")


Init = materialize_sharded

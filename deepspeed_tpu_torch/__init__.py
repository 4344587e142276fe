"""deepspeed_tpu_torch: the PyTorch and CUDA port of deepspeed_tpu.

Nine slices so far, all on one NVIDIA H100. Serving: a GPT/llama-layout
decoder behind a continuous-batching scheduler over a paged KV cache, with
hand-written CUDA kernels for the flash-attention prefill and the paged
decode (``init_inference``, float32, bfloat16 or float16). Training: the
single-device training step, ``initialize(...)`` then
``engine.train_batch(batch)``, whose attention runs the flash forward
kernel (with segment ids for packed rows) and the hand-written dq and
dk/dv backward kernels. Int8 serving: weight-only int8
(``init_inference(dtype=torch.int8)``, the int8 dequant-matmul kernel) and
int8 paged KV blocks (``ServingEngine(kv_quant="int8")``, the paged decode
kernel's int8-pool mode). Block-sparse attention and BERT pretraining:
``ops.sparse_attention`` (the sparsity layouts, ``SparseSelfAttention``
built from the config's ``sparse_attention`` section) over the
hand-written block-sparse forward kernel, and ``models.bert`` (MLM + NSP
and SQuAD losses over the encoder layer, whose attention runs the flash
kernels non-causally with the padding mask), trained through
``initialize`` with AdamW or LAMB. The rest of the training engine on one
device: crash-safe checkpoints and resume (``engine.save_checkpoint``,
``load_checkpoint``, ``init_inference(checkpoint=)``), the loaders
(``initialize(training_data=)``), SGD, Adagrad and client optimizers,
progressive layer drop, the seqlen curriculum, the monitor, the timers
and the flops profiler, and the activation-checkpointing API
(``checkpointing``). The serving extensions: the shared-prefix cache
(``ServingEngine(prefix_cache=True)``), speculative decode
(``spec_decode=True``, whose verify step runs the paged kernel's verify
mode; the static ``inference.speculative``), the host-DRAM KV tier
(``host_tier=True``), the multi-step decode horizon (``decode_horizon=``)
the telemetry plane (``telemetry=True``: metrics registry, request
tracer, step breakdown, cost accounting; ``telemetry/``) and fault
tolerance (``utils/faults.py`` injection, deadlines, shedding, retries,
the step watchdog, ``inference.DegradedError`` with its snapshot, the
flight recorder and ``tools.postmortem``), with the
``DS_*`` environment flags read as the JAX package reads them. The
top-level names are the JAX package's: ``__version__``,
``DeepSpeedConfig``, ``DeepSpeedEngine``, ``logger``, ``log_dist``,
``add_config_arguments``, ``argparse_suppress``, ``checkpointing`` and
``zero``, and ``init_distributed``. Data parallelism with ZeRO stages 0-3
across ranks (``init_distributed``, ``parallel/``: the mesh, its
topology and sharding specs; ``utils/groups.py``; ``zero.Init``;
``initialize(mesh=, partition_rules=)``; checkpoints of every rank's
pieces); sequence parallelism; tensor parallelism (Megatron's column and
row layers over the mesh's ``model`` axis, ``parallel/tensor.py``:
``initialize`` with ``mesh.tensor_parallel_size``,
``init_inference(mp_size=)`` and the ``ServingEngine`` over it). It
imports torch, numpy and the standard library, never jax nor
deepspeed_tpu.
"""

import argparse
from typing import Any, Callable, Dict, Optional, Sequence, Union

from deepspeed_tpu_torch.version import __version__
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.parallel import mesh as _mesh_lib
from deepspeed_tpu_torch.utils.distributed import init_distributed
from deepspeed_tpu_torch.utils.logging import log_dist, logger


def _infer_world_size(mesh=None, config_dict=None) -> int:
    """The data-parallel degree the batch sizes are reconciled with: the
    mesh's, else the process group's ranks over the config's tp * pp *
    sp (the JAX package's, over ranks where it counts devices)."""
    from deepspeed_tpu_torch.utils.distributed import get_world_size
    if mesh is not None:
        return _mesh_lib.dp_world_size(mesh)
    n = get_world_size()
    if config_dict:
        mc = (config_dict.get("mesh") or {})
        fixed = (mc.get("tensor_parallel_size", 1) *
                 mc.get("pipeline_parallel_size", 1) *
                 mc.get("sequence_parallel_size", 1))
        return max(1, n // fixed)
    return n


def initialize(args=None, model: Optional[Callable] = None, optimizer=None,
               model_parameters: Optional[Any] = None, training_data=None,
               lr_scheduler=None, mesh=None,
               partition_rules: Optional[Sequence] = None,
               config: Optional[Union[str, Dict]] = None,
               config_params: Optional[Union[str, Dict]] = None,
               has_aux: bool = False, collate_fn=None, device=None):
    """Initialize the training engine, mirroring
    ``deepspeed_tpu.initialize`` (its parameters in its order, then the
    port's ``device``).

    model: ``callable(params, batch, rng) -> loss | (loss, aux)``, for
    example ``models.gpt.make_loss_fn(cfg)`` or
    ``models.bert.make_loss_fn(cfg)``. model_parameters: the
    parameter dict, or ``zero.Init``'s sharded one. config: path to a JSON
    config or a dict (the JAX package's schema). optimizer: a client
    optimizer with the port's protocol (``DeepSpeedEngine``).
    training_data: an indexable dataset, batched by
    ``runtime.dataloader.DeepSpeedDataLoader`` into ``train_batch_size``
    rows (``collate_fn`` overrides the stacking). mesh: a
    ``parallel.mesh.Mesh`` (default: the config's ``mesh`` section over
    the process group of ``init_distributed``, one rank without one):
    the data-parallel axes (``data``, ``fsdp``, ``replica_parallel_size``
    at ZeRO 3), ``sequence`` and ``model`` (``tensor_parallel_size``:
    Megatron's column and row layers, ``parallel/tensor.py``) run across
    ranks; a ``pipe`` axis above 1, and ``model`` with ``sequence``, raise
    naming their ROADMAP §1.3 items. partition_rules:
    ``parallel.sharding.PartitionRule``s (``models.gpt.gpt_partition_rules``,
    ``models.bert.bert_partition_rules``: what the ``model`` axis
    splits). device: None means the CUDA
    card (``cuda:{local_rank}`` under ranks).

    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``;
    optimizer and lr_scheduler are the engine-owned objects, the loader
    None without ``training_data`` (every rank iterates the same global
    batches)."""
    config = config if config is not None else config_params
    if config is None:
        raise ValueError("deepspeed_tpu_torch.initialize requires a config")
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize requires a loss "
                         "function")
    if model_parameters is None:
        raise ValueError("model_parameters (the parameter dict) required")
    config_dict = config if isinstance(config, dict) else None
    ds_config = DeepSpeedConfig(config, world_size=_infer_world_size(
        mesh, config_dict))
    engine = DeepSpeedEngine(
        loss_fn=model, params=model_parameters, config=ds_config,
        mesh=mesh, partition_rules=partition_rules, optimizer=optimizer,
        lr_schedule=lr_scheduler if callable(lr_scheduler) else None,
        has_aux=has_aux, device=device)
    dataloader = None
    if training_data is not None:
        from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
        dataloader = DeepSpeedDataLoader(
            training_data, batch_size=ds_config.train_batch_size,
            collate_fn=collate_fn)
    return engine, engine.optimizer, dataloader, engine.lr_schedule


def init_inference(model=None, **kwargs):
    """Inference engine entry, mirroring ``deepspeed_tpu.init_inference``:
    ``model`` is ``(GPTConfig, params)``, or ``config=GPTConfig`` with
    ``checkpoint=`` a training checkpoint directory (its ``latest`` tag's
    parameters); ``dtype`` is float32, bfloat16, float16 or
    ``torch.int8`` (weight-only int8); ``device=None`` means the CUDA card."""
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    return InferenceEngine(model, **kwargs)


# the activation-checkpointing API, as deepspeed_tpu.checkpointing
from deepspeed_tpu_torch.runtime.activation_checkpointing import (  # noqa: E402
    checkpointing)


def add_config_arguments(parser):
    """Add the ``--deepspeed`` / ``--deepspeed_config`` command-line
    flags (and the hidden ``--deepscale``) to an argparse parser, as
    ``deepspeed_tpu.add_config_arguments`` does."""
    group = parser.add_argument_group("DeepSpeed-TPU",
                                      "DeepSpeed-TPU configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed-TPU (helper flag to wire "
                            "configs)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="Path to the DeepSpeed-TPU json configuration "
                            "file")
    group.add_argument("--deepscale", default=False, action="store_true",
                       help=argparse_suppress())
    return parser


def argparse_suppress():
    return argparse.SUPPRESS


# the zero namespace, as deepspeed_tpu.zero
from deepspeed_tpu_torch.runtime import zero  # noqa: E402

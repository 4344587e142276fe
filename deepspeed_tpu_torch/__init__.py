"""deepspeed_tpu_torch: the PyTorch and CUDA port of deepspeed_tpu.

Four slices so far, all on one NVIDIA H100. Serving: a GPT/llama-layout
decoder behind a continuous-batching scheduler over a paged KV cache, with
hand-written CUDA kernels for the flash-attention prefill and the paged
decode (``init_inference``). Training: the single-device training step,
``initialize(...)`` then ``engine.train_batch(batch)``, whose attention
runs the flash forward kernel (with segment ids for packed rows) and the
hand-written dq and dk/dv backward kernels. Int8 serving: weight-only int8
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
and the flops profiler. It imports torch, numpy and the standard library,
never jax nor deepspeed_tpu.
"""

from typing import Any, Callable, Dict, Optional, Union


def initialize(args=None, model: Optional[Callable] = None, optimizer=None,
               model_parameters: Optional[Any] = None, training_data=None,
               lr_scheduler=None, config: Optional[Union[str, Dict]] = None,
               config_params: Optional[Union[str, Dict]] = None,
               has_aux: bool = False, collate_fn=None, device=None):
    """Initialize the training engine, mirroring
    ``deepspeed_tpu.initialize``.

    model: ``callable(params, batch, rng) -> loss | (loss, aux)``, for
    example ``models.gpt.make_loss_fn(cfg)`` or
    ``models.bert.make_loss_fn(cfg)``. model_parameters: the
    parameter dict. config: path to a JSON config or a dict (the JAX
    package's schema). optimizer: a client optimizer with the port's
    protocol (``DeepSpeedEngine``). training_data: an indexable dataset,
    batched by ``runtime.dataloader.DeepSpeedDataLoader`` into
    ``train_batch_size`` rows (``collate_fn`` overrides the stacking).
    device: None means the CUDA card.

    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``;
    optimizer and lr_scheduler are the engine-owned objects, the loader
    None without ``training_data``. A mesh waits for the multi-GPU
    slice."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    config = config if config is not None else config_params
    if config is None:
        raise ValueError("deepspeed_tpu_torch.initialize requires a config")
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize requires a loss "
                         "function")
    if model_parameters is None:
        raise ValueError("model_parameters (the parameter dict) required")
    ds_config = DeepSpeedConfig(config, world_size=1)
    engine = DeepSpeedEngine(
        loss_fn=model, params=model_parameters, config=ds_config,
        optimizer=optimizer,
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
    parameters); ``dtype`` is float32, bfloat16 or ``torch.int8``
    (weight-only int8); ``device=None`` means the CUDA card."""
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    return InferenceEngine(model, **kwargs)

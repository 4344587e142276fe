"""The BERT encoder layer: port of ``deepspeed_tpu/ops/transformer/``."""

from deepspeed_tpu_torch.ops.transformer.encoder_layer import (
    DeepSpeedTransformerConfig, init_layer_params, layer_forward,
    layer_forward_reference)

__all__ = ["DeepSpeedTransformerConfig", "init_layer_params",
           "layer_forward", "layer_forward_reference"]

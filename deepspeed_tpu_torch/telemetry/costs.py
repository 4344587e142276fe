"""Peak rates and the analytic flop formulas the flops profiler reads.

The port's copy of the part of ``deepspeed_tpu/telemetry/costs.py`` that
``profiling/flops_profiler`` uses: the dense peak of the card, and the
per-token formulas over ``models/gpt.py``'s parameter counts. The serving
cost accounting that shares them in the JAX package waits for the serving
slice.
"""

from typing import Optional

import torch

# dense bf16/fp16 tensor-core peak per card (NVIDIA's data sheet, SXM part,
# without sparsity), matched against torch.cuda.get_device_name
PEAK_FLOPS = {
    "H100": 989e12,
}


def device_peak_flops(device=None) -> Optional[float]:
    """Dense peak FLOP/s of ``device`` (default: the current CUDA card),
    by the longest key of :data:`PEAK_FLOPS` found in its name; None for
    the host and for cards the table does not know."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    best, best_len = None, -1
    for key, peak in PEAK_FLOPS.items():
        if key in name and len(key) > best_len:
            best, best_len = peak, len(key)
    return best


def matmul_params(cfg, include_head: bool = True) -> int:
    """Parameters in a matmul per token: ``num_params`` without the wte
    lookup, the logit projection counted when ``include_head`` (with tied
    embeddings it is real compute though its weight is wte's)."""
    from deepspeed_tpu_torch.models.gpt import num_params
    n = num_params(cfg) - cfg.vocab_size * cfg.d_model
    if include_head and cfg.tie_embeddings:
        n += cfg.d_model * cfg.vocab_size
    return int(n)


def model_flops_per_token(cfg, include_head: bool = True) -> int:
    """Forward matmul FLOPs per token, attention excluded."""
    return 2 * matmul_params(cfg, include_head)


def attn_flops(cfg, n_tokens: int, start_pos: int) -> int:
    """Forward attention-score FLOPs of ``n_tokens`` consecutive tokens
    from position ``start_pos``: a token at position p attends p + 1 keys,
    QK^T and PV each ``2 * d_model`` FLOPs a pair and layer."""
    n, s = int(n_tokens), int(start_pos)
    ctx_sum = n * s + (n * (n + 1)) // 2
    return 4 * cfg.n_layers * cfg.d_model * ctx_sum


def infer_flops(cfg, n_tokens: int, start_pos: int,
                include_head: bool = True) -> int:
    """Forward FLOPs of ``n_tokens`` new tokens after ``start_pos`` cached
    ones: the weight matmuls plus causal attention."""
    return (int(n_tokens) * model_flops_per_token(cfg, include_head)
            + attn_flops(cfg, n_tokens, start_pos))


def weight_bytes(cfg, param_itemsize: int = 2) -> int:
    """Bytes of the model's weights."""
    from deepspeed_tpu_torch.models.gpt import num_params
    return int(num_params(cfg)) * int(param_itemsize)

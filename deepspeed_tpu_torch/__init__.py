"""deepspeed_tpu_torch: the PyTorch and CUDA port of deepspeed_tpu.

This slice serves a GPT/llama-layout decoder through a continuous-batching
scheduler over a paged KV cache on one NVIDIA H100, with hand-written CUDA
kernels for the flash-attention prefill and the paged decode. It imports
torch, numpy and the standard library, never jax nor deepspeed_tpu.
"""


def init_inference(model=None, **kwargs):
    """Inference engine entry, mirroring ``deepspeed_tpu.init_inference``:
    ``model`` is ``(GPTConfig, params)``; ``device=None`` means the CUDA
    card."""
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    return InferenceEngine(model, **kwargs)

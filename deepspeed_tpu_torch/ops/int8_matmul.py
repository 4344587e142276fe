"""Weight-only int8 dequant-matmul: the CUDA kernel ``csrc/int8_matmul.cu``
(K4) and its plain PyTorch version.

Port of ``deepspeed_tpu/ops/int8_matmul.py``: ``x [M, K] @ dequant(q [K,
N] int8, scale [1, N] fp32) -> [M, N]`` in x's dtype, with the weight read
from device memory as int8 and the per-output-channel scale applied once
to the fp32 sum. The TPU kernel's tile arguments (``block_m``, ``block_n``,
``block_k``) are not ported: the CUDA kernel's tiles are fixed in its
source.

There is no implementation switch: a CPU tensor goes through
:func:`int8_matmul_reference` (the dequantize-then-multiply of the JAX
package's ``gpt._kernel_of``), a CUDA tensor launches the kernel or
raises.
"""

import torch

from deepspeed_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def int8_matmul_reference(x, q, scale):
    """``x @ (q * scale)`` with the weight dequantized to x's dtype first,
    as ``deepspeed_tpu/ops/int8_matmul.py int8_matmul_reference``."""
    return x @ (q.to(x.dtype) * scale.to(x.dtype))


def int8_matmul(x, q, scale):
    """x [M, K] float32 or bfloat16, q [K, N] int8, scale [1, N] (or [N])
    float32 -> [M, N] in x's dtype."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: no kernel for device {x.device}")
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"int8_matmul takes x [M, K] and q [K, N], got "
                         f"{tuple(x.shape)} and {tuple(q.shape)}")
    M, K = x.shape
    N = q.shape[1]
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"int8_matmul takes float32 or bfloat16 x, got "
                         f"{x.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32 \
            or scale.numel() != N:
        raise ValueError(f"int8_matmul takes an int8 weight and {N} float32 "
                         f"scales, got {q.dtype} and {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if not (q.device == x.device == scale.device):
        raise ValueError("int8_matmul: x, q and scale must share a device")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8_matmul takes a contiguous weight and scale")
    if K < 1 or N < 1:
        raise ValueError(f"int8_matmul needs K, N >= 1, got {K}, {N}")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    x = x.contiguous()
    code = _DTYPE_CODE[x.dtype]
    # 16-byte loads need 16-byte aligned rows and base pointers
    vec_x = int(x.data_ptr() % 16 == 0 and (K * x.element_size()) % 16 == 0)
    vec_q = int(q.data_ptr() % 16 == 0 and N % 16 == 0)
    lib = _build.load("int8_matmul")
    splits = lib.ds_int8_matmul_splits(code, M, N, K)
    part = torch.empty((splits, M, N) if splits > 1 else (0,),
                       dtype=torch.float32, device=x.device)
    err = lib.ds_int8_matmul(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        part.data_ptr(), code, M, N, K, vec_x, vec_q,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return out


# launches of the CUDA kernel since the last reset
int8_matmul.launches = 0

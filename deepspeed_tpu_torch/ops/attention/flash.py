"""Flash-attention forward: the CUDA kernel ``csrc/flash_fwd.cu`` and its
plain PyTorch version.

Port of the forward half of ``deepspeed_tpu/ops/attention/flash.py``
(``flash_attention`` over ``_flash_fwd`` / ``_fwd_kernel``). Inputs keep
the JAX package's public layout ``[B, S, H, D]``; k/v may carry fewer
heads (grouped-query attention). The result is ``(o, lse)``: the output
in q's dtype and the per-row log-sum-exp ``[B, H, S]`` in fp32 (the
training slice and ring attention will need the LSE).

A CPU tensor goes through :func:`mha_reference`; a CUDA tensor launches
the kernel or raises. Segment ids and the ring offset ``q_off`` wait for
the training slice; the backward kernels with them.
"""

import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops import _build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)


def mha_reference(q, k, v, causal: bool = True, scale: Optional[float] = None,
                  kv_mask=None, window: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention over [B, S, H, D] tensors: the JAX package's
    ``mha_reference`` (flash.py), returning the log-sum-exp beside the
    output. Causal masking keeps column <= row; the window keeps
    row - column < window; ``kv_mask`` [B, Skv] drops keys at <= 0."""
    B, S, H, D = q.shape
    Skv = k.shape[1]
    if k.shape[2] != H:              # GQA: repeat kv heads per group
        k = torch.repeat_interleave(k, H // k.shape[2], dim=2)
        v = torch.repeat_interleave(v, H // v.shape[2], dim=2)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        mask = torch.ones(S, Skv, dtype=torch.bool, device=q.device).tril()
        if window is not None:
            mask &= ~torch.ones(S, Skv, dtype=torch.bool,
                                device=q.device).tril(-window)
        logits = torch.where(mask[None, None], logits, NEG_INF)
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, :] > 0, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v), lse


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None, kv_mask=None,
                    window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over [B, S, H, D] q and [B, Skv, Hkv, D] k/v; returns
    ``(o [B, S, H, D], lse [B, H, S])``. ``window`` (causal only): token i
    attends (i - window, i]. Rows with no valid key are garbage by
    contract, as on the TPU."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if H % Hkv != 0 or v.shape[2] != Hkv:
        raise ValueError(f"q has {H} heads, k {Hkv}, v {v.shape[2]}: kv "
                         f"head counts must match and divide {H}")
    if window is not None and (not causal or window < 1):
        raise ValueError("a sliding window needs causal=True and window >= 1")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, scale=scale,
                             kv_mask=kv_mask, window=window)
    return _flash_cuda(q, k, v, causal, float(scale), kv_mask, window)


def _flash_cuda(q, k, v, causal, scale, kv_mask, window):
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 "
                         f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims {HEAD_DIMS}, "
                         f"got {D}")
    if k.shape[0] != B or v.shape[:2] != k.shape[:2] or v.shape[-1] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the kernel grid's limit")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (B, Skv):
            raise ValueError(f"kv_mask must be [B, Skv] = {(B, Skv)}, "
                             f"got {tuple(kv_mask.shape)}")
        kv_mask = kv_mask.to(device=q.device, dtype=torch.float32).contiguous()
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_fwd")
    err = lib.ds_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if kv_mask is None else kv_mask.data_ptr(),
        o.data_ptr(), lse.data_ptr(), _DTYPE_CODE[q.dtype], B, S, Skv, H, Hkv,
        D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], scale,
        int(causal), 0 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd")
    flash_attention.launches += 1
    return o, lse


# launches of the CUDA kernel since the last reset (plain-version calls on
# CPU tensors do not count)
flash_attention.launches = 0

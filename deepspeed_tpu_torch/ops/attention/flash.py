"""Flash attention: the CUDA kernels ``csrc/flash_fwd.cu`` (forward) and
``csrc/flash_bwd.cu`` (dq and dk/dv), their plain PyTorch versions, and the
``torch.autograd.Function`` that ties them together.

Port of ``deepspeed_tpu/ops/attention/flash.py`` (``flash_attention`` over
``_flash_fwd`` / ``_fwd_kernel`` and ``_flash_bwd`` / ``_bwd_dq_kernel`` /
``_bwd_dkv_kernel``). Inputs keep the JAX package's public layout
``[B, S, H, D]``; k/v may carry fewer heads (grouped-query attention).
The result is ``(o, lse)``: the output in q's dtype and the per-row
log-sum-exp ``[B, H, S]`` in fp32 (not differentiable; ring attention
will need it). ``segment_ids`` ``[B, S]`` keep the attention of packed
rows inside each document.

A CPU tensor goes through the plain versions (:func:`mha_reference` forward,
:func:`flash_attention_bwd_reference` backward: the kernels' own
formulas, not autograd of the forward); a CUDA tensor launches the kernels
or raises. The ring offset ``q_off`` waits for the ring-attention slice.
"""

import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops import _build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (64, 128)
# the design each kernel runs for each dtype, as the C entry points choose
# it (`ds_flash_fwd`, `dispatch` in flash_bwd.cu): K1-fwd, K2-dq and K2-dkv
# on the tensor cores ("mma") in bfloat16 and float16, on the CUDA cores in
# fp32 FMA ("fma") in float32, where TF32 would miss the float32 tolerance
DESIGN = {(kernel, dtype): "fma" if dtype == torch.float32 else "mma"
          for kernel in ("K1-fwd", "K2-dq", "K2-dkv")
          for dtype in (torch.float32, torch.bfloat16, torch.float16)}


def _allowed(S: int, Skv: int, device, causal: bool, window: Optional[int],
             kv_mask, segment_ids):
    """Boolean [B or 1, 1, S, Skv] mask of the (query, key) pairs that
    attend, or None when every pair does."""
    ok = None
    if causal:
        ok = torch.ones(S, Skv, dtype=torch.bool, device=device).tril()
        if window is not None:
            ok &= ~torch.ones(S, Skv, dtype=torch.bool,
                              device=device).tril(-window)
        ok = ok[None, None]
    if kv_mask is not None:
        m = (kv_mask > 0)[:, None, None, :]
        ok = m if ok is None else ok & m
    if segment_ids is not None:
        same = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
        ok = same if ok is None else ok & same
    return ok


def _masked_logits(q, k, scale, ok):
    """fp32 scores [B, H, S, Skv] with -1e30 where ``ok`` is False; k
    already carries H heads."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if ok is not None:
        logits = torch.where(ok, logits, NEG_INF)
    return logits


def _default_scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _repeat_kv(t, H: int):
    """GQA: kv head = q head // group."""
    return t if t.shape[2] == H else \
        torch.repeat_interleave(t, H // t.shape[2], dim=2)


def mha_reference(q, k, v, causal: bool = True, scale: Optional[float] = None,
                  kv_mask=None, window: Optional[int] = None,
                  segment_ids=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention over [B, S, H, D] tensors: the JAX package's
    ``mha_reference`` (flash.py), returning the log-sum-exp beside the
    output. Causal masking keeps column <= row; the window keeps
    row - column < window; ``kv_mask`` [B, Skv] drops keys at <= 0;
    ``segment_ids`` [B, S] keep a query on the keys of its own segment."""
    B, S, H, D = q.shape
    ok = _allowed(S, k.shape[1], q.device, causal, window, kv_mask,
                  segment_ids)
    logits = _masked_logits(q, _repeat_kv(k, H), _default_scale(q, scale), ok)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, _repeat_kv(v, H)), lse


def attention_delta(o, do) -> torch.Tensor:
    """``rowsum(do * o)`` in fp32 as [B, H, S]: the backward kernels' fourth
    operand, computed outside the TPU kernels as well (a row-wise
    reduction, bound by bytes)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_reference(q, k, v, lse, delta, do, causal, scale, kv_mask, window,
                   segment_ids):
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    ok = _allowed(S, k.shape[1], q.device, causal, window, kv_mask,
                  segment_ids)
    kh, vh = _repeat_kv(k, H), _repeat_kv(v, H)
    p = torch.exp(_masked_logits(q, kh, scale, ok) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vh).float()
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    if Hkv != H:
        dk = dk.reshape(B, -1, Hkv, H // Hkv, D).sum(3)
        dv = dv.reshape(B, -1, Hkv, H // Hkv, D).sum(3)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal: bool = True,
                                  scale: Optional[float] = None, kv_mask=None,
                                  window: Optional[int] = None,
                                  segment_ids=None):
    """Plain ``(dq, dk, dv)`` by the backward kernels' own formulas:
    ``delta = rowsum(do * o)`` in fp32, ``p = exp(s - lse)`` with s
    recomputed under the forward's masks, ``dv = p^T do``,
    ``ds = p * (do v^T - delta) * scale``, ``dq = ds k``, ``dk = ds^T q``;
    p is rounded to do's dtype and ds to q's before the products, and under
    GQA the per-q-head dk/dv are summed over each group in fp32."""
    return _bwd_reference(q, k, v, lse, attention_delta(o, do), do, causal,
                          _default_scale(q, scale), kv_mask, window,
                          segment_ids)


class FlashAttention(torch.autograd.Function):
    """``(o, lse)`` of :func:`flash_attention` with the backward of the TPU
    kernels. ``known`` is an ``(o, lse)`` pair kept from an earlier forward
    of the same inputs (activation checkpointing): the forward then returns
    it without launching anything."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, segment_ids, causal, scale, window,
                known_o=None, known_lse=None):
        if known_o is not None:
            o, lse = known_o, known_lse
        elif q.device.type == "cpu":
            o, lse = mha_reference(q, k, v, causal=causal, scale=scale,
                                   kv_mask=kv_mask, window=window,
                                   segment_ids=segment_ids)
        else:
            o, lse = _flash_fwd_cuda(q, k, v, causal, scale, kv_mask, window,
                                     segment_ids)
        ctx.save_for_backward(q, k, v, o, lse, kv_mask, segment_ids)
        ctx.args = (causal, scale, window)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, kv_mask, segment_ids = ctx.saved_tensors
        causal, scale, window = ctx.args
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal, scale=scale, kv_mask=kv_mask,
            window=window, segment_ids=segment_ids)
        return (dq, dk, dv) + (None,) * 7


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None, kv_mask=None,
                    window: Optional[int] = None, segment_ids=None,
                    known=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over [B, S, H, D] q and [B, Skv, Hkv, D] k/v; returns
    ``(o [B, S, H, D], lse [B, H, S])``, differentiable in q, k and v.
    ``window`` (causal only): token i attends (i - window, i].
    ``segment_ids`` [B, S] (self-attention only): token i attends token j
    only where the ids match. Rows with no valid key are garbage by
    contract, as on the TPU, and their gradient is zero once the loss masks
    them. ``known``: see :class:`FlashAttention`."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if H % Hkv != 0 or v.shape[2] != Hkv:
        raise ValueError(f"q has {H} heads, k {Hkv}, v {v.shape[2]}: kv "
                         f"head counts must match and divide {H}")
    if window is not None and (not causal or window < 1):
        raise ValueError("a sliding window needs causal=True and window >= 1")
    if segment_ids is not None:
        if k.shape[1] != S:
            raise ValueError("segment_ids requires self-attention "
                             f"(Skv == S), got S={S}, Skv={k.shape[1]}")
        if tuple(segment_ids.shape) != (B, S):
            raise ValueError(f"segment_ids must be [B, S] = {(B, S)}, "
                             f"got {tuple(segment_ids.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    known_o, known_lse = known if known is not None else (None, None)
    return FlashAttention.apply(q, k, v, kv_mask, segment_ids, bool(causal),
                                float(_default_scale(q, scale)), window,
                                known_o, known_lse)


def kernel_layout(t):
    """``t`` as the kernels read it: last dimension contiguous, and the
    base pointer and the batch, sequence and head strides 16-byte aligned
    (the tensor-core kernels copy rows with 16-byte ``cp.async``, which must
    never read misaligned). A view that is not so, e.g. q/k/v cut from a
    fused projection at an odd offset, is copied here to a contiguous
    tensor of its own (``clone``: ``contiguous`` would return a contiguous
    view at a misaligned offset as it is); an aligned view (the fused qkv
    split of ``models/gpt.py`` at head dims 64 and 128) is passed on."""
    esz = t.element_size()
    aligned = t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        s * esz % 16 == 0 for s in t.stride()[:-1])
    return t if aligned else t.clone(memory_format=torch.contiguous_format)


def _kernel_args(q, k, v, kv_mask, segment_ids):
    """Check what the kernels take and return (q, k, v, mask, segs) ready
    for them: q/k/v in :func:`kernel_layout`, mask fp32, segment ids
    int32."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the flash kernels take float32, bfloat16 or "
                         f"float16 q/k/v of one dtype, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the flash kernels take head dims {HEAD_DIMS}, "
                         f"got {D}")
    if k.shape[0] != B or v.shape[:2] != k.shape[:2] or v.shape[-1] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the kernel grid's limit")
    q, k, v = (kernel_layout(t) for t in (q, k, v))
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (B, Skv):
            raise ValueError(f"kv_mask must be [B, Skv] = {(B, Skv)}, "
                             f"got {tuple(kv_mask.shape)}")
        kv_mask = kv_mask.to(device=q.device, dtype=torch.float32).contiguous()
    if segment_ids is not None:
        segment_ids = segment_ids.to(device=q.device,
                                     dtype=torch.int32).contiguous()
    return q, k, v, kv_mask, segment_ids


def _ptr(t):
    return None if t is None else t.data_ptr()


def _flash_fwd_cuda(q, k, v, causal, scale, kv_mask, window, segment_ids):
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    q, k, v, kv_mask, segment_ids = _kernel_args(q, k, v, kv_mask,
                                                 segment_ids)
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_fwd")
    err = lib.ds_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
        _ptr(segment_ids), o.data_ptr(), lse.data_ptr(),
        _DTYPE_CODE[q.dtype], B, S, Skv, H, Hkv, D, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], scale, int(causal),
        0 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd")
    flash_attention.launches += 1
    return o, lse


def _bwd_kernel_args(q, k, v, do, lse, delta, kv_mask, segment_ids, causal,
                     scale, window):
    """The argument lists the two backward entry points share: (pointers
    of the inputs, dtype code .. stream), and the tensors kept alive."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    q, k, v, kv_mask, segment_ids = _kernel_args(q, k, v, kv_mask,
                                                 segment_ids)
    if do.dtype != q.dtype or tuple(do.shape) != (B, S, H, D):
        raise ValueError(f"do must be {q.dtype} {(B, S, H, D)}, got "
                         f"{do.dtype} {tuple(do.shape)}")
    do = kernel_layout(do)
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, S):
            raise ValueError(f"{name} must be float32 {(B, H, S)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    lse, delta = lse.contiguous(), delta.contiguous()
    keep = (q, k, v, do, lse, delta, kv_mask, segment_ids)
    inputs = tuple(_ptr(t) for t in keep)
    geometry = (_DTYPE_CODE[q.dtype], B, S, Skv, H, Hkv, D, *q.stride()[:3],
                *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
                float(scale), int(causal),
                0 if window is None else int(window),
                torch.cuda.current_stream(q.device).cuda_stream)
    return inputs, geometry, keep


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                 scale: Optional[float] = None, kv_mask=None,
                 window: Optional[int] = None, segment_ids=None):
    """``dq [B, S, H, D]`` from ``lse`` and ``delta`` ([B, H, S] fp32): the
    dq kernel on CUDA tensors, the plain formulas on CPU tensors."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return _bwd_reference(q, k, v, lse, delta, do, causal, scale, kv_mask,
                              window, segment_ids)[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq: no kernel for device {q.device}")
    inputs, geometry, _alive = _bwd_kernel_args(
        q, k, v, do, lse, delta, kv_mask, segment_ids, causal, scale, window)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _build.load("flash_bwd").ds_flash_bwd_dq(*inputs, dq.data_ptr(),
                                                   *geometry)
    _build.check(err, "flash_bwd_dq")
    flash_attention.bwd_dq_launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                  scale: Optional[float] = None, kv_mask=None,
                  window: Optional[int] = None, segment_ids=None):
    """``(dk, dv)`` [B, Skv, Hkv, D] from ``lse`` and ``delta``: the dk/dv
    kernel on CUDA tensors, the plain formulas on CPU tensors."""
    scale = _default_scale(q, scale)
    if q.device.type == "cpu":
        return _bwd_reference(q, k, v, lse, delta, do, causal, scale, kv_mask,
                              window, segment_ids)[1:]
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv: no kernel for device {q.device}")
    inputs, geometry, _alive = _bwd_kernel_args(
        q, k, v, do, lse, delta, kv_mask, segment_ids, causal, scale, window)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    err = _build.load("flash_bwd").ds_flash_bwd_dkv(
        *inputs, dk.data_ptr(), dv.data_ptr(), *geometry)
    _build.check(err, "flash_bwd_dkv")
    flash_attention.bwd_dkv_launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        scale: Optional[float] = None, kv_mask=None,
                        window: Optional[int] = None, segment_ids=None):
    """``(dq, dk, dv)`` of :func:`flash_attention` given its output, its
    log-sum-exp and the output's gradient: the dq and dk/dv kernels on
    CUDA tensors, :func:`flash_attention_bwd_reference` on CPU tensors."""
    kw = dict(causal=causal, scale=_default_scale(q, scale), kv_mask=kv_mask,
              window=window, segment_ids=segment_ids)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
    delta = attention_delta(o, do)
    return (flash_bwd_dq(q, k, v, do, lse, delta, **kw),
            *flash_bwd_dkv(q, k, v, do, lse, delta, **kw))


# launches of each CUDA kernel since the last reset (plain-version calls on
# CPU tensors do not count): forward, backward dq, backward dk/dv
flash_attention.launches = 0
flash_attention.bwd_dq_launches = 0
flash_attention.bwd_dkv_launches = 0

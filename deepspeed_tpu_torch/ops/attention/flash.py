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
or raises. The kernels take every head dim up to 128: each width of
:data:`HEAD_DIMS` has its own build, and a multiple of 8 between two of
them runs in a build of the wider one that takes its head dim at run time
(``_build.head_dim_build``). The wrappers zero-pad only a head dim that
is not a multiple of 8, to the next multiple (as the JAX package's
``_pad_heads`` does), with the softmax scale of the true head dim, and
slice the outputs back.

Ring attention's local block (``ops/attention/ring.py``) runs the same
kernels in their ring modes, a build of their own (``-DDS_RING``):
:func:`flash_block_fwd` and :func:`flash_block_bwd`, the JAX package's
``flash_block_fwd``/``flash_block_bwd``. Their q rows sit ``q_off`` tokens
after the held keys, the keys carry segment ids of their own
(``kv_segs`` [B, Skv], which rotate with their block while the q rows'
``q_segs`` stay), and the backward takes the global ``delta`` and returns
fp32 gradients (the ring sums them over its hops before rounding). Their
launches are counted apart from :func:`flash_attention`'s. The JAX
package's kernel-layout forms (``flash_block_fwd_t``/``_bwd_t``) are not
ported: these kernels read q, k and v through their strides in the
public layout, so there is no layout change to hoist out of the ring.
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops import _build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the head dims each kernel is built for (one library each); the multiples
# of 8 between them run in the next width's run-time head dim build
HEAD_DIMS = _build.HEAD_DIMS
# the design each kernel runs for each dtype, as the C entry points choose
# it (`ds_flash_fwd`, `dispatch` in flash_bwd.cu): K1-fwd, K2-dq and K2-dkv
# on the tensor cores ("mma") in bfloat16 and float16, on the CUDA cores in
# fp32 FMA ("fma") in float32, where TF32 would miss the float32 tolerance
DESIGN = {(kernel, dtype): "fma" if dtype == torch.float32 else "mma"
          for kernel in ("K1-fwd", "K2-dq", "K2-dkv")
          for dtype in (torch.float32, torch.bfloat16, torch.float16)}


def _allowed(S: int, Skv: int, device, causal: bool, window: Optional[int],
             kv_mask, segment_ids, q_off: int = 0, kv_segs=None):
    """Boolean [B or 1, 1, S, Skv] mask of the (query, key) pairs that
    attend, or None when every pair does. Query row r stands at position
    ``r + q_off`` against the keys; ``kv_segs`` are the keys' segment ids
    (``segment_ids``, the rows', when None)."""
    ok = None
    if causal:
        rows = torch.arange(S, device=device)[:, None] + q_off
        cols = torch.arange(Skv, device=device)[None, :]
        ok = cols <= rows
        if window is not None:
            ok &= rows - cols < window
        ok = ok[None, None]
    if kv_mask is not None:
        m = (kv_mask > 0)[:, None, None, :]
        ok = m if ok is None else ok & m
    if segment_ids is not None:
        keys = segment_ids if kv_segs is None else kv_segs
        same = (segment_ids[:, :, None] == keys[:, None, :])[:, None]
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
                  segment_ids=None, q_off: int = 0, kv_segs=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention over [B, S, H, D] tensors: the JAX package's
    ``mha_reference`` (flash.py), returning the log-sum-exp beside the
    output. Causal masking keeps column <= row; the window keeps
    row - column < window; ``kv_mask`` [B, Skv] drops keys at <= 0;
    ``segment_ids`` [B, S] keep a query on the keys of its own segment.
    Ring modes: row r stands at ``r + q_off`` against the keys, and
    ``kv_segs`` [B, Skv] are the keys' segment ids (the rows' when
    None)."""
    B, S, H, D = q.shape
    ok = _allowed(S, k.shape[1], q.device, causal, window, kv_mask,
                  segment_ids, q_off, kv_segs)
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
                   segment_ids, q_off: int = 0, kv_segs=None,
                   out_fp32: bool = False):
    """Plain (dq, dk, dv) by the kernels' formulas; ``out_fp32``: the ring
    modes' fp32 gradients (the same products, not rounded to the input
    dtype at the end)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    ok = _allowed(S, k.shape[1], q.device, causal, window, kv_mask,
                  segment_ids, q_off, kv_segs)
    kh, vh = _repeat_kv(k, H), _repeat_kv(v, H)
    p = torch.exp(_masked_logits(q, kh, scale, ok) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vh).float()
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
    if out_fp32:
        dq = torch.einsum("bhqk,bkhd->bqhd", ds.float(), kh.float())
    else:
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    if Hkv != H:
        dk = dk.reshape(B, -1, Hkv, H // Hkv, D).sum(3)
        dv = dv.reshape(B, -1, Hkv, H // Hkv, D).sum(3)
    if out_fp32:
        return dq, dk, dv
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


def pad_head_dim(t, width: int):
    """``t`` [..., D] with its head dim zero-padded to ``width`` (the
    multiple of 8 at or above D: ``_build.head_dim_build``): zero columns
    of q and k add nothing to a score, zero columns of v give zero output
    columns, sliced off after the kernel."""
    D = t.shape[-1]
    return t if D == width else F.pad(t, (0, width - D))


def _unpad(t, D: int):
    return t if t.shape[-1] == D else t[..., :D].contiguous()


def kernel_layout(t):
    """``t`` as the kernels read it: last dimension contiguous, and the
    base pointer and the batch, sequence and head strides 16-byte aligned
    (the tensor-core kernels copy rows with 16-byte ``cp.async``, which must
    never read misaligned). A view that is not so, e.g. q/k/v cut from a
    fused projection at an odd offset, is copied here to a contiguous
    tensor of its own (``clone``: ``contiguous`` would return a contiguous
    view at a misaligned offset as it is); an aligned view (the fused qkv
    split of ``models/gpt.py`` at every head dim that is a multiple of 8)
    is passed on."""
    esz = t.element_size()
    aligned = t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        s * esz % 16 == 0 for s in t.stride()[:-1])
    return t if aligned else t.clone(memory_format=torch.contiguous_format)


def _kernel_args(q, k, v, kv_mask, segment_ids):
    """Check what the kernels take and return (q, k, v, mask, segs, W)
    ready for them: q/k/v padded to W, the multiple of 8 at or above the
    head dim (:func:`pad_head_dim`), in :func:`kernel_layout`, mask fp32,
    segment ids int32."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the flash kernels take float32, bfloat16 or "
                         f"float16 q/k/v of one dtype, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    W = _build.head_dim_build(D)[0]
    if k.shape[0] != B or v.shape[:2] != k.shape[:2] or v.shape[-1] != D \
            or k.shape[-1] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the kernel grid's limit")
    q, k, v = (kernel_layout(pad_head_dim(t, W)) for t in (q, k, v))
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (B, Skv):
            raise ValueError(f"kv_mask must be [B, Skv] = {(B, Skv)}, "
                             f"got {tuple(kv_mask.shape)}")
        kv_mask = kv_mask.to(device=q.device, dtype=torch.float32).contiguous()
    if segment_ids is not None:
        segment_ids = segment_ids.to(device=q.device,
                                     dtype=torch.int32).contiguous()
    return q, k, v, kv_mask, segment_ids, W


def _ptr(t):
    return None if t is None else t.data_ptr()


def _flash_fwd_cuda(q, k, v, causal, scale, kv_mask, window, segment_ids):
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    q, k, v, kv_mask, segment_ids, W = _kernel_args(q, k, v, kv_mask,
                                                    segment_ids)
    o = torch.empty((B, S, H, W), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_fwd", W)
    err = lib.ds_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
        _ptr(segment_ids), o.data_ptr(), lse.data_ptr(),
        _DTYPE_CODE[q.dtype], B, S, Skv, H, Hkv, W, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], scale, int(causal),
        0 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd")
    flash_attention.launches += 1
    return _unpad(o, D), lse


def _bwd_kernel_args(q, k, v, do, lse, delta, kv_mask, segment_ids, causal,
                     scale, window):
    """The argument lists the two backward entry points share: (pointers
    of the inputs, dtype code .. stream), the tensors kept alive and the
    head dim W the kernels run (the gradients are W wide)."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    q, k, v, kv_mask, segment_ids, W = _kernel_args(q, k, v, kv_mask,
                                                    segment_ids)
    if do.dtype != q.dtype or tuple(do.shape) != (B, S, H, D):
        raise ValueError(f"do must be {q.dtype} {(B, S, H, D)}, got "
                         f"{do.dtype} {tuple(do.shape)}")
    do = kernel_layout(pad_head_dim(do, W))
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, S):
            raise ValueError(f"{name} must be float32 {(B, H, S)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    lse, delta = lse.contiguous(), delta.contiguous()
    keep = (q, k, v, do, lse, delta, kv_mask, segment_ids)
    inputs = tuple(_ptr(t) for t in keep)
    geometry = (_DTYPE_CODE[q.dtype], B, S, Skv, H, Hkv, W, *q.stride()[:3],
                *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
                float(scale), int(causal),
                0 if window is None else int(window),
                torch.cuda.current_stream(q.device).cuda_stream)
    return inputs, geometry, keep, W


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
    inputs, geometry, _alive, W = _bwd_kernel_args(
        q, k, v, do, lse, delta, kv_mask, segment_ids, causal, scale, window)
    dq = torch.empty((*q.shape[:3], W), dtype=q.dtype, device=q.device)
    err = _build.load("flash_bwd", W).ds_flash_bwd_dq(*inputs, dq.data_ptr(),
                                                      *geometry)
    _build.check(err, "flash_bwd_dq")
    flash_attention.bwd_dq_launches += 1
    return _unpad(dq, q.shape[-1])


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
    inputs, geometry, _alive, W = _bwd_kernel_args(
        q, k, v, do, lse, delta, kv_mask, segment_ids, causal, scale, window)
    dk = torch.empty((*k.shape[:3], W), dtype=k.dtype, device=q.device)
    dv = torch.empty((*v.shape[:3], W), dtype=v.dtype, device=q.device)
    err = _build.load("flash_bwd", W).ds_flash_bwd_dkv(
        *inputs, dk.data_ptr(), dv.data_ptr(), *geometry)
    _build.check(err, "flash_bwd_dkv")
    flash_attention.bwd_dkv_launches += 1
    D = q.shape[-1]
    return _unpad(dk, D), _unpad(dv, D)


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


def resolve_window_impl(window, window_impl=None):
    """``window`` after the JAX package's ``resolve_window_impl`` check:
    ``window_impl`` (else ``DS_FLASH_WINDOW_IMPL``, default "banded") must
    be "banded" or "masked", else ``ValueError`` with the JAX package's
    text. Both choices give ``window`` itself here: "masked" is the JAX
    package's fallback that spells the window as an in-body mask over the
    plain causal tiles (a TPU compiler workaround, the same numbers);
    these kernels have one windowed design, which skips the tiles outside
    the band."""
    if window is None:
        return None
    from deepspeed_tpu_torch.utils.env import resolve_flag
    impl = window_impl or resolve_flag("DS_FLASH_WINDOW_IMPL")
    if impl not in ("banded", "masked"):
        raise ValueError(f"unknown window impl {impl!r}: "
                         f"expected 'banded' or 'masked'")
    return int(window)


def _block_checks(q, k, v, kv_mask, q_segs, kv_segs, window, causal, q_off):
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if H % Hkv != 0 or v.shape[2] != Hkv:
        raise ValueError(f"q has {H} heads, k {Hkv}, v {v.shape[2]}: kv "
                         f"head counts must match and divide {H}")
    if window is not None and (not causal or window < 1):
        raise ValueError("a sliding window needs causal=True and window >= 1")
    if (q_segs is None) != (kv_segs is None):
        raise ValueError("q_segs and kv_segs come together (both or "
                         "neither)")
    if q_segs is not None and (tuple(q_segs.shape) != (B, S)
                               or tuple(kv_segs.shape) != (B, Skv)):
        raise ValueError(f"q_segs must be [B, S] = {(B, S)} and kv_segs "
                         f"[B, Skv] = {(B, Skv)}, got "
                         f"{tuple(q_segs.shape)}, {tuple(kv_segs.shape)}")
    if int(q_off) < 0:
        raise ValueError(f"q_off must be >= 0, got {q_off}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_block: no kernel for device {q.device}")


def _segs_arg(t, device):
    return None if t is None else t.to(device=device,
                                       dtype=torch.int32).contiguous()


def flash_block_fwd(q, k, v, kv_mask=None, q_segs=None, kv_segs=None, *,
                    causal: bool = True, scale: Optional[float] = None,
                    window: Optional[int] = None, q_off: int = 0,
                    block_q=None, block_kv=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One attention block of ring attention: q [B, S, H, D] against the
    held k/v [B, Skv, Hkv, D], the q rows ``q_off`` tokens after the
    block's first key; ``q_segs`` [B, S] and ``kv_segs`` [B, Skv] the rows'
    and the keys' segment ids (both or neither). Returns ``(o [B, S, H, D]
    in q's dtype, lse [B, H, S] fp32)``; a row with no visible key has
    lse -1e30. Not differentiable (the ring owns the backward). K1-fwd's
    ring mode on CUDA tensors, :func:`mha_reference` on CPU tensors.
    ``block_q``/``block_kv``: the TPU kernel's tiling, accepted and
    ignored."""
    _block_checks(q, k, v, kv_mask, q_segs, kv_segs, window, causal, q_off)
    scale = float(_default_scale(q, scale))
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, scale=scale,
                             kv_mask=kv_mask, window=window,
                             segment_ids=q_segs, q_off=int(q_off),
                             kv_segs=kv_segs)
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    q, k, v, kv_mask, q_segs, W = _kernel_args(q, k, v, kv_mask, q_segs)
    kv_segs = _segs_arg(kv_segs, q.device)
    o = torch.empty((B, S, H, W), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = _build.load("flash_fwd", W, ring=True).ds_flash_fwd_ring(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
        _ptr(q_segs), _ptr(kv_segs), o.data_ptr(), lse.data_ptr(),
        _DTYPE_CODE[q.dtype], B, S, Skv, H, Hkv, W, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], scale, int(causal),
        0 if window is None else int(window), int(q_off),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_block_fwd")
    flash_block_fwd.launches += 1
    flash_block_fwd.offset_launches += int(q_off) > 0
    return _unpad(o, D), lse


def _block_bwd_args(q, k, v, do, lse, delta, kv_mask, q_segs, kv_segs, causal,
                    scale, window, q_off):
    """The ring-mode entry points' shared arguments: (pointers of the
    inputs, dtype code .. stream), the tensors kept alive and the head
    dim W."""
    inputs, geometry, keep, W = _bwd_kernel_args(
        q, k, v, do, lse, delta, kv_mask, q_segs, causal, scale, window)
    kv_segs = _segs_arg(kv_segs, q.device)
    inputs = inputs + (_ptr(kv_segs),)          # after the rows' ids
    geometry = geometry[:-1] + (int(q_off), geometry[-1])
    return inputs, geometry, keep + (kv_segs,), W


def flash_block_bwd_dq(q, k, v, do, lse, delta, kv_mask=None, q_segs=None,
                       kv_segs=None, *, causal: bool = True,
                       scale: Optional[float] = None,
                       window: Optional[int] = None, q_off: int = 0):
    """This block's fp32 ``dq`` [B, S, H, D] (see :func:`flash_block_bwd`):
    K2-dq's ring mode on CUDA tensors, the plain formulas on CPU
    tensors."""
    _block_checks(q, k, v, kv_mask, q_segs, kv_segs, window, causal, q_off)
    scale = float(_default_scale(q, scale))
    if q.device.type == "cpu":
        return _bwd_reference(q, k, v, lse, delta, do, causal, scale,
                              kv_mask, window, q_segs, int(q_off), kv_segs,
                              out_fp32=True)[0]
    inputs, geometry, _alive, W = _block_bwd_args(
        q, k, v, do, lse, delta, kv_mask, q_segs, kv_segs, causal, scale,
        window, q_off)
    dq = torch.empty((*q.shape[:3], W), dtype=torch.float32, device=q.device)
    err = _build.load("flash_bwd", W, ring=True).ds_flash_bwd_dq_ring(
        *inputs, dq.data_ptr(), *geometry)
    _build.check(err, "flash_block_bwd_dq")
    flash_block_bwd.dq_launches += 1
    flash_block_bwd.offset_launches += int(q_off) > 0
    return _unpad(dq, q.shape[-1])


def flash_block_bwd_dkv(q, k, v, do, lse, delta, kv_mask=None, q_segs=None,
                        kv_segs=None, *, causal: bool = True,
                        scale: Optional[float] = None,
                        window: Optional[int] = None, q_off: int = 0):
    """This block's fp32 ``(dk, dv)`` [B, Skv, Hkv, D] (see
    :func:`flash_block_bwd`): K2-dkv's ring mode on CUDA tensors, the plain
    formulas on CPU tensors."""
    _block_checks(q, k, v, kv_mask, q_segs, kv_segs, window, causal, q_off)
    scale = float(_default_scale(q, scale))
    if q.device.type == "cpu":
        return _bwd_reference(q, k, v, lse, delta, do, causal, scale,
                              kv_mask, window, q_segs, int(q_off), kv_segs,
                              out_fp32=True)[1:]
    inputs, geometry, _alive, W = _block_bwd_args(
        q, k, v, do, lse, delta, kv_mask, q_segs, kv_segs, causal, scale,
        window, q_off)
    f32 = torch.float32
    dk = torch.empty((*k.shape[:3], W), dtype=f32, device=q.device)
    dv = torch.empty((*v.shape[:3], W), dtype=f32, device=q.device)
    err = _build.load("flash_bwd", W, ring=True).ds_flash_bwd_dkv_ring(
        *inputs, dk.data_ptr(), dv.data_ptr(), *geometry)
    _build.check(err, "flash_block_bwd_dkv")
    flash_block_bwd.dkv_launches += 1
    D = q.shape[-1]
    return _unpad(dk, D), _unpad(dv, D)


def flash_block_bwd(q, k, v, do, o=None, lse=None, kv_mask=None,
                    q_segs=None, kv_segs=None, *, causal: bool = True,
                    scale: Optional[float] = None,
                    window: Optional[int] = None, q_off: int = 0,
                    delta=None, block_q=None, block_kv=None):
    """This block's additive ``(dq [B, S, H, D], dk, dv [B, Skv, Hkv, D])``
    in fp32, given the global ``lse`` [B, H, S] (combined over the ring's
    blocks) and ``delta`` = rowsum(do * o) [B, H, S] fp32, or the global
    output ``o`` to compute it from. The geometry is
    :func:`flash_block_fwd`'s. K2-dq's and K2-dkv's ring modes on CUDA
    tensors (:func:`flash_block_bwd_dq`, :func:`flash_block_bwd_dkv`),
    their plain formulas on CPU tensors."""
    if lse is None or (delta is None and o is None):
        raise ValueError("flash_block_bwd needs lse and one of delta, o")
    if delta is None:
        delta = attention_delta(o, do)
    kw = dict(causal=causal, scale=scale, window=window, q_off=q_off)
    args = (q, k, v, do, lse, delta, kv_mask, q_segs, kv_segs)
    if q.device.type == "cpu":
        _block_checks(q, k, v, kv_mask, q_segs, kv_segs, window, causal,
                      q_off)
        return _bwd_reference(q, k, v, lse, delta, do, causal,
                              float(_default_scale(q, scale)), kv_mask,
                              window, q_segs, int(q_off), kv_segs,
                              out_fp32=True)
    return (flash_block_bwd_dq(*args, **kw), *flash_block_bwd_dkv(*args,
                                                                  **kw))


# launches of each CUDA kernel since the last reset (plain-version calls on
# CPU tensors do not count): forward, backward dq, backward dk/dv; the
# ring modes apart, with the launches at q_off > 0 among them (the
# backward's counted at its dq launch)
flash_attention.launches = 0
flash_attention.bwd_dq_launches = 0
flash_attention.bwd_dkv_launches = 0
flash_block_fwd.launches = 0
flash_block_fwd.offset_launches = 0
flash_block_bwd.dq_launches = 0
flash_block_bwd.dkv_launches = 0
flash_block_bwd.offset_launches = 0

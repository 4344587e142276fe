"""Paged flash-decode and verify: the CUDA kernel ``csrc/paged_decode.cu``
and its plain PyTorch versions.

Port of ``deepspeed_tpu/ops/attention/paged.py``. Each serving slot's
queries attend through its block table: pools ``[N, block, Hkv, Dh]``
(block 0 is the trash block), tables ``[B, NB]`` int32, lengths ``[B]``
int32. The new tokens' K/V must already be written at positions
``lengths[b] ..``. With ``k_scale``/``v_scale`` (one layer's ``[N, Hkv]``
fp32 scale pools) the pools are int8 and each block is dequantized with
its (block, kv head) scale: in registers by the kernel, through
``ops/quantizer.py kv_dequantize_blocks`` by the plain versions.

There is no implementation switch: a CPU tensor goes through the gather
reference, a CUDA tensor launches the kernel or raises.
"""

from typing import Optional

import torch

from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.quantizer import kv_dequantize_blocks

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
_MAX_SMEM = 232448          # bytes of shared memory one H100 block may use
SPLIT_TOKENS = 64           # cache positions one CTA of the kernel walks


def paged_hbm_bytes_per_token(cfg, num_slots: int, mean_len: float,
                              dtype=torch.bfloat16,
                              block_size: Optional[int] = None,
                              scale_bytes_per_block: int = 0) -> int:
    """Bytes of K and V the kernel reads per decoded token, over all
    layers: the occupied cache of every slot, once. ``dtype`` is the pool's
    (int8 under KV quantization); ``scale_bytes_per_block`` and
    ``block_size`` add the int8 pools' scales, read with every block."""
    per_tok = 2.0 * cfg.n_layers * cfg.kv_heads * cfg.head_dim * dtype.itemsize
    if scale_bytes_per_block and block_size:
        per_tok += scale_bytes_per_block / float(block_size)
    return int(int(num_slots * mean_len) * per_tok)


def _gather(pool, scale_pool, idx, dtype):
    """[B, nb * bs, Hkv, Dh] cache of every slot through its table,
    dequantized to ``dtype`` when the pool is int8."""
    g = pool[idx]
    if scale_pool is not None:
        g = kv_dequantize_blocks(g, scale_pool[idx], dtype=dtype)
    B, nb, bs = g.shape[:3]
    return g.reshape(B, nb * bs, *g.shape[3:])


def paged_decode_reference(q, k_pool, v_pool, tables, lengths, *, scale,
                           window: Optional[int] = None, k_scale=None,
                           v_scale=None):
    """Dense gather version of :func:`paged_decode_attention`: gather
    every slot's whole virtual cache through its table (dequantized to q's
    dtype with int8 pools), mask by position. q: [B, Hkv, group, Dh]."""
    idx = tables.long()
    kc = _gather(k_pool, k_scale, idx, q.dtype)
    vc = _gather(v_pool, v_scale, idx, q.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", q, kc).float() * scale
    col = torch.arange(kc.shape[1], device=q.device)
    pos = lengths.long()[:, None, None, None]
    s = torch.where(col <= pos, s, NEG_INF)
    if window is not None:
        s = torch.where(col > pos - window, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgs,bskd->bkgd", p, vc)


def paged_verify_reference(q, k_pool, v_pool, tables, lengths, *, scale,
                           window: Optional[int] = None, k_scale=None,
                           v_scale=None):
    """Dense gather version of :func:`paged_verify_attention`; chunk row i
    of slot b is causal at position ``lengths[b] + i``.
    q: [B, G, Hkv, group, Dh]."""
    G = q.shape[1]
    idx = tables.long()
    kc = _gather(k_pool, k_scale, idx, q.dtype)
    vc = _gather(v_pool, v_scale, idx, q.dtype)
    s = torch.einsum("bqkgd,bskd->bkgqs", q, kc).float() * scale
    col = torch.arange(kc.shape[1], device=q.device)
    qpos = (lengths.long()[:, None, None, None, None]
            + torch.arange(G, device=q.device)[None, None, None, :, None])
    s = torch.where(col <= qpos, s, NEG_INF)
    if window is not None:
        s = torch.where(col > qpos - window, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", p, vc)


def paged_decode_attention(q, k_pool, v_pool, tables, lengths, *,
                           scale: float, window: Optional[int] = None,
                           k_scale=None, v_scale=None):
    """Flash-decode one new token per slot through the block table.
    q: [B, Hkv, group, Dh] post-rotary queries; returns the same shape in
    q's dtype. Slot b attends positions <= lengths[b], banded by
    ``window``. ``k_scale``/``v_scale`` [N, Hkv] fp32: int8 pools."""
    kw = dict(scale=scale, window=window, k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pool, v_pool, tables, lengths,
                                      **kw)
    return paged_attention(q[:, None], k_pool, v_pool, tables, lengths,
                           **kw)[:, 0]


def paged_verify_attention(q, k_pool, v_pool, tables, lengths, *,
                           scale: float, window: Optional[int] = None,
                           k_scale=None, v_scale=None):
    """Flash-verify a G-token chunk per slot through the block table.
    q: [B, G, Hkv, group, Dh]; returns the same shape in q's dtype."""
    kw = dict(scale=scale, window=window, k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cpu":
        return paged_verify_reference(q, k_pool, v_pool, tables, lengths,
                                      **kw)
    return paged_attention(q, k_pool, v_pool, tables, lengths, **kw)


def paged_attention(q, k_pool, v_pool, tables, lengths, *, scale: float,
                    window: Optional[int] = None, k_scale=None, v_scale=None):
    """Launch the CUDA kernel on q [B, q_len, Hkv, group, Dh] (CUDA tensors
    only); returns the same shape. ``k_scale``/``v_scale`` [N, Hkv] fp32
    switch the int8-pool mode on."""
    B, q_len, Hkv, group, D = q.shape
    N, bs, Hkv_p, D_p = k_pool.shape
    quant = k_scale is not None
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    pool_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != pool_dtype \
            or v_pool.dtype != pool_dtype:
        raise ValueError(f"paged kernel takes float32 or bfloat16 q and pools "
                         f"of q's dtype, or int8 pools with scales; got "
                         f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}"
                         f"{' with scales' if quant else ''}")
    if quant:
        for s_pool in (k_scale, v_scale):
            if s_pool is None or s_pool.dtype != torch.float32 \
                    or tuple(s_pool.shape) != (N, Hkv) \
                    or not s_pool.is_contiguous():
                raise ValueError(f"int8 pools take contiguous float32 scale "
                                 f"pools [{N}, {Hkv}] for K and V")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged kernel takes head dims {HEAD_DIMS}, got {D}")
    if (Hkv_p, D_p) != (Hkv, D) or v_pool.shape != k_pool.shape:
        raise ValueError(f"q {tuple(q.shape)} does not match pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged kernel takes contiguous pools [N, bs, Hkv, Dh]")
    if tables.shape[0] != B or tuple(lengths.shape) != (B,):
        raise ValueError(f"tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match {B} slots")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    R = group * q_len
    smem = 4 * (2 * R * D + R * bs + 3 * R)
    if smem > _MAX_SMEM or B > 65535:
        raise ValueError(f"{R} query rows per kv head with block {bs} need "
                         f"{smem} bytes of shared memory, over the card's "
                         f"{_MAX_SMEM}")
    q = q.contiguous()
    tables = tables.to(device=q.device, dtype=torch.int32).contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    NB = tables.shape[1]
    # each CTA walks at most SPLIT_TOKENS of a slot's cache; a second
    # kernel combines the per-range softmax partials
    split_blocks = max(1, SPLIT_TOKENS // bs)
    nsplit = -(-NB // split_blocks)
    out = torch.empty_like(q)
    part_acc = torch.empty((B, Hkv, nsplit, R, D), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, Hkv, nsplit, 2, R), dtype=torch.float32,
                          device=q.device)
    lib = _build.load("paged_decode")
    err = lib.ds_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), _DTYPE_CODE[q.dtype], int(quant), B, q_len, Hkv,
        group, D, bs, NB, split_blocks, nsplit, float(scale),
        0 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode")
    if quant:
        paged_attention.int8_launches += 1
    else:
        paged_attention.launches += 1
    return out


# launches of the CUDA kernel since the last reset: float pools, int8 pools
paged_attention.launches = 0
paged_attention.int8_launches = 0

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

The kernel's work plan (:func:`plan`) is chosen here from the shapes
alone, never from the lengths, which stay on the device: a slot's cache
positions are cut into units of :data:`UNIT`, and each CTA takes
``chunk`` of them; :func:`slot_ranges` is the host's copy of the range
arithmetic every CTA does on the device.

The kernel has two designs (:data:`DESIGN`), chosen by the C entry
point from the mode, q's dtype and the pool, never at run time by the
wrapper: the verify mode (q_len > 1) in bfloat16 and float16 on the tensor
cores (``paged_verify_mma_kernel``: ``mma.sync`` over m16 tiles of
:data:`MMA_ROWS` rows at most a pass), everything else on the CUDA cores
(``paged_split_kernel``: float32 q, the exactness tier, and the decode
mode in every dtype), over float pools and int8 pools alike (a float16 q
over int8 pools too). There is no implementation switch: a CPU tensor goes
through the gather reference, a CUDA tensor launches the designed kernel
or raises. The kernel takes every head dim up to 128: each width of
:data:`HEAD_DIMS` has its own build, and a multiple of 8 between two of
them runs in a build of the wider one that takes its head dim at run time
(``_build.head_dim_build``), reading the pools as they are. Only a head
dim that is not a multiple of 8 is zero-padded by
:func:`paged_attention`, q and the pools with it (a copy of the pools per
call, in plain sight: no preset has such a head dim).
"""

import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.quantizer import kv_dequantize_blocks

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the head dims the kernel is built for (one library each; the multiples
# of 8 between them run in the next width's run-time head dim build)
HEAD_DIMS = _build.HEAD_DIMS
UNIT = 16                   # cache positions of one unit of kernel work
CTA_WARPS = 4               # warps per CTA; each takes every 4th unit
ROW_CAPACITY = (1, 4, 16)   # the CUDA-core row tiers; more rows: passes of 16


def _tile_width(d: int) -> int:
    """The tensor-core tile's columns at head dim ``d`` (flash_mma.cuh
    ``tile_width``): the next multiple of 16."""
    return -(-d // 16) * 16


# the tensor-core design's m16 tiles a pass, by head dim, and so its rows a
# pass at most: the accumulators of R rows take R * tile width / 32 fp32
# registers a lane, held at 128 (`mma_max_tiles` in csrc/paged_decode.cu;
# ptxas: no spill at any width)
MMA_TILES = {d: tuple(t for t in (1, 2, 4) if 16 * t * _tile_width(d) // 32
                      <= 128) for d in HEAD_DIMS}
MMA_ROWS = {d: 16 * t[-1] for d, t in MMA_TILES.items()}
# the design of each (mode, q dtype, pool), as `dispatch` in
# csrc/paged_decode.cu chooses it: "mma" (tensor cores) for the verify
# mode in bfloat16 and float16, over float and int8 pools, "fma" (CUDA
# cores) for the decode mode and for float32 q
DESIGN = {(mode, dtype, pool): "mma" if mode == "verify"
          and dtype != torch.float32 else "fma"
          for mode in ("decode", "verify")
          for dtype in (torch.float32, torch.bfloat16, torch.float16)
          for pool in ("float", "int8")}
WAVES = 8                   # CTAs per SM slot the plan aims at, full tables
CTAS_PER_SM = 2             # resident CTAs the plan assumes
# at least 4 units per warp (on an NVIDIA H100 80GB HBM3 at 700.00 W, 16
# units per CTA beat 4 and 8 at the decode, GQA and verify shapes of
# chip_smoke.py, and 32 lost at all but one)
MIN_CHUNK, MAX_CHUNK = 4 * CTA_WARPS, 64
# the tensor-core design: at least 8 units per warp, which amortize its
# CTA's fixed work (q's rows, the table lookups, 16 rows a tile to merge);
# on an NVIDIA H100 80GB HBM3 at 700.00 W, 32 units per CTA beat 16 at the
# llama-7b and GQA verify shapes of chip_smoke.py in both pool modes, and
# 64 or 128 lost in bf16
MIN_CHUNK_MMA = 8 * CTA_WARPS


class PagedPlan(NamedTuple):
    rt: int         # row capacity of the kernel instance (>= rows of a pass)
    npass: int      # passes per (slot, kv head): of <= 16 rows (CUDA
                    # cores) or of rt rows (tensor cores)
    chunk: int      # units per CTA
    nsplit: int     # CTAs (splits) per slot and pass: the partial buffers


@functools.lru_cache(maxsize=None)
def plan(B: int, Hkv: int, R: int, NB: int, bs: int, sms: int = 132,
         design: str = "fma", D: int = 128) -> PagedPlan:
    """The kernel's work plan for B slots of NB blocks of ``bs`` positions,
    ``Hkv`` kv heads and R = group * q_len query rows per kv head, on a
    card of ``sms`` SMs, for the ``design`` (:data:`DESIGN`) at head dim
    ``D``. It sees the shapes only: ``chunk`` is sized so that full tables
    give about ``WAVES`` waves of ``CTAS_PER_SM`` CTAs per SM (a few waves
    at the decode step's half-full tables), and ``nsplit`` is what a full
    table needs. The tensor-core design takes the fewest m16 tiles that
    hold R rows, up to :data:`MMA_ROWS`; more rows run in passes."""
    if design == "mma":
        tiles = MMA_TILES[D]
        rt = 16 * next((t for t in tiles if 16 * t >= R), tiles[-1])
        npass = -(-R // rt)
    else:
        rt = next(c for c in ROW_CAPACITY if c >= min(R, ROW_CAPACITY[-1]))
        npass = -(-R // ROW_CAPACITY[-1])
    units = -(-(NB * bs) // UNIT)
    total = B * Hkv * npass * units
    chunk = -(-total // (WAVES * CTAS_PER_SM * sms))
    chunk = max(MIN_CHUNK_MMA if design == "mma" else MIN_CHUNK,
                min(MAX_CHUNK, chunk))
    return PagedPlan(rt, npass, chunk, -(-units // chunk))


def slot_ranges(p: PagedPlan, length: int, q_len: int, window: Optional[int],
                NB: int, bs: int) -> List[Tuple[int, int]]:
    """The cache positions ``(first, last)`` each split of one slot reads
    (``work_of`` and the unit walk of ``csrc/paged_decode.cu``): the
    positions from the first row's window band up to ``length + q_len -
    1``, capped at the table, cut into units of ``UNIT`` and split
    ``chunk`` units at a time. An empty range gives no split."""
    hi = min(length + q_len - 1, NB * bs - 1)
    lo = max(length - window + 1, 0) if window else 0
    if hi < lo:
        return []
    ulo, uhi = lo // UNIT, hi // UNIT
    out = []
    for u0 in range(ulo, uhi + 1, p.chunk):
        u1 = min(u0 + p.chunk, uhi + 1)
        out.append((max(u0 * UNIT, lo), min(u1 * UNIT - 1, hi)))
    return out


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    switch the int8-pool mode on. ``scale`` is the caller's (1/sqrt of the
    true Dh where a head dim that is not a multiple of 8 runs padded)."""
    B, q_len, Hkv, group, D = q.shape
    N, bs, Hkv_p, D_p = k_pool.shape
    quant = k_scale is not None
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    pool_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != pool_dtype \
            or v_pool.dtype != pool_dtype:
        raise ValueError(f"paged kernel takes float32, bfloat16 or float16 q "
                         f"with pools of q's dtype, or with int8 pools and "
                         f"scales; got {q.dtype}/{k_pool.dtype}/"
                         f"{v_pool.dtype}{' with scales' if quant else ''}")
    if quant:
        for s_pool in (k_scale, v_scale):
            if s_pool is None or s_pool.dtype != torch.float32 \
                    or tuple(s_pool.shape) != (N, Hkv) \
                    or not s_pool.is_contiguous():
                raise ValueError(f"int8 pools take contiguous float32 scale "
                                 f"pools [{N}, {Hkv}] for K and V")
    Dk, W, _ = _build.head_dim_build(D)
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
    if Dk != D:   # zero columns: nothing added to a score, zero outputs
        q, k_pool, v_pool = (F.pad(t, (0, Dk - D))
                             for t in (q, k_pool, v_pool))
    q = q.contiguous()
    tables = tables.to(device=q.device, dtype=torch.int32).contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    NB = tables.shape[1]
    R = group * q_len
    design = DESIGN[("verify" if q_len > 1 else "decode", q.dtype,
                     "int8" if quant else "float")]
    pl = plan(B, Hkv, R, NB, bs, _sms(q.device.index or 0), design, W)
    out = torch.empty_like(q)
    # partials only where a slot's work may take more than one split
    n = pl.nsplit if pl.nsplit > 1 else 0
    part_acc = torch.empty((B, Hkv, n, R, Dk), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, Hkv, n, 2, R), dtype=torch.float32,
                          device=q.device)
    lib = _build.load("paged_decode", Dk)
    err = lib.ds_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), _DTYPE_CODE[q.dtype], int(quant), B, q_len, Hkv,
        group, Dk, bs, NB, pl.rt, pl.npass, pl.chunk, pl.nsplit, float(scale),
        0 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode")
    if q_len > 1 and quant:
        paged_attention.int8_verify_launches += 1
    elif q_len > 1:
        paged_attention.verify_launches += 1
    elif quant:
        paged_attention.int8_launches += 1
    else:
        paged_attention.launches += 1
    return out if Dk == D else out[..., :D].contiguous()


# launches of the CUDA kernel since the last reset, by mode: decode
# (q_len 1) and verify (q_len > 1), each over float and int8 pools (the
# int8 counters take every q dtype over int8 pools, float16 too)
paged_attention.launches = 0
paged_attention.int8_launches = 0
paged_attention.verify_launches = 0
paged_attention.int8_verify_launches = 0

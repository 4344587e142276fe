"""Block-sparse attention: the CUDA kernel ``csrc/blocksparse_fwd.cu``
(K5), its plain PyTorch versions, and the routing between them.

Port of ``deepspeed_tpu/ops/sparse_attention/blocksparse.py``. The host
compiles a [H, nb, nb] block layout into a table of the active key blocks
of every (head, query-block row), padded to the longest row
(:func:`make_lut`). Two versions compute attention over it:

- :func:`blocksparse_attention_gather`, the plain version: it gathers the
  active K/V blocks and runs the softmax over them. It takes the element
  masks (``key_padding_mask``, ``attn_mask``, each ``add`` or ``mul``) and
  ``rpe``, and it is differentiable under autograd.
- :func:`blocksparse_attention_kernel`, a ``torch.autograd.Function``: on
  a CUDA tensor the forward launches K5, on a CPU tensor it runs the
  gather version; the backward recomputes through the gather version, as
  the JAX package's ``custom_vjp`` does (the TPU kernel has no backward).

:func:`blocksparse_attention` routes as the JAX package does: the kernel on
the card when no mask and no ``rpe`` are given and ``block % 8 == 0``,
the gather version otherwise. :func:`blocksparse_reference` is the dense
O(S^2) oracle. Neither version materializes the [S, S] score matrix.
Tensors are [B, S, H, D].
"""

import math
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops import _build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
KERNEL_BLOCKS = (16, 32, 64, 128)


def make_lut(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Compile a [H, nb, nb] 0/1 layout into (lut, valid).

    lut   : int32 [H, nb, L]: active key-block index per slot (0-padded)
    valid : bool  [H, nb, L]: slot validity

    L = max active blocks in any (head, row)."""
    layout = np.asarray(layout)
    H, nb, _ = layout.shape
    counts = layout.sum(-1)
    L = max(1, int(counts.max()))
    lut = np.zeros((H, nb, L), dtype=np.int32)
    valid = np.zeros((H, nb, L), dtype=bool)
    for h in range(H):
        for r in range(nb):
            cols = np.nonzero(layout[h, r])[0]
            lut[h, r, :len(cols)] = cols
            valid[h, r, :len(cols)] = True
    return lut, valid


class BlockTable:
    """A :func:`make_lut` result with its device copies: ``on(device)``
    gives ``(lut int32, valid bool, nnz int32)`` there, uploaded once per
    device (the kernel reads ``lut`` and ``nnz``, the gather version
    ``lut`` and ``valid``). Get one through :func:`block_table`."""

    def __init__(self, lut, valid):
        self.source = (lut, valid)       # what block_table keys on
        self.lut = np.ascontiguousarray(lut, dtype=np.int32)
        self.valid = np.asarray(valid, dtype=bool)
        if self.lut.ndim != 3 or self.valid.shape != self.lut.shape:
            raise ValueError(f"lut and valid must be [H, nb, L] of one shape,"
                             f" got {self.lut.shape} and {self.valid.shape}")
        self._on = {}

    def on(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        device = torch.device(device)
        key = str(device)
        if key not in self._on:
            lut = torch.from_numpy(self.lut).to(device)
            valid = torch.from_numpy(self.valid).to(device)
            nnz = torch.from_numpy(
                self.valid.sum(-1).astype(np.int32)).to(device)
            self._on[key] = (lut, valid, nnz)
        return self._on[key]


# one BlockTable per make_lut result, as the JAX package keeps one kernel
# function per layout: repeated calls with the same (lut, valid) arrays
# reuse its device copies. The least recently used table goes past
# TABLE_CACHE entries.
TABLE_CACHE = 16
_TABLE_CACHE: "OrderedDict[Tuple[int, int], BlockTable]" = OrderedDict()


def block_table(lut, valid) -> BlockTable:
    """The cached :class:`BlockTable` of a ``(lut, valid)`` pair, found by
    the identity of the two arrays: a lookup reads none of their contents
    (hashing the table of a 4096-token layout takes ~0.5 ms of host time,
    more than K5 itself at S = 2048). The cached table holds the arrays,
    so their ids stay theirs, and numpy arrays are made read-only here, so
    that the table cannot go stale."""
    key = (id(lut), id(valid))
    table = _TABLE_CACHE.pop(key, None)
    if table is None:
        for a in (lut, valid):
            if isinstance(a, np.ndarray):
                a.flags.writeable = False
        table = BlockTable(lut, valid)
    _TABLE_CACHE[key] = table
    while len(_TABLE_CACHE) > TABLE_CACHE:
        _TABLE_CACHE.popitem(last=False)
    return table


def _default_scale(D: int, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(D) if scale is None else float(scale)


# ---------------------------------------------------------------------------
# the plain gather version (differentiable; takes masks)
# ---------------------------------------------------------------------------

def _gather_blocks(xb: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """xb [B, H, nb, bk, D], lut [H, nq, L] -> [B, H, nq, L, bk, D]."""
    heads = torch.arange(lut.shape[0], device=lut.device)[:, None, None]
    return xb[:, heads, lut]


def blocksparse_attention_gather(q, k, v, lut, valid, block: int,
                                 causal: bool = False,
                                 scale: Optional[float] = None,
                                 key_padding_mask=None,
                                 key_padding_mask_mode: str = "add",
                                 attn_mask=None,
                                 attn_mask_mode: str = "mul",
                                 rpe=None):
    """Gather-based block-sparse attention over [B, S, H, D] tensors: the
    JAX package's ``blocksparse_attention_jnp``. ``lut``/``valid`` are
    :func:`make_lut`'s arrays. Scores are fp32 (q and k widened before
    the product, as ``preferred_element_type=float32`` keeps them), p is
    rounded to q's dtype before P.V, and a row with no active key gives
    zeros."""
    return _gather(q, k, v, block_table(lut, valid), block, causal, scale,
                   key_padding_mask, key_padding_mask_mode, attn_mask,
                   attn_mask_mode, rpe)


def _gather(q, k, v, table: BlockTable, block: int, causal: bool,
            scale: Optional[float], key_padding_mask=None,
            key_padding_mask_mode: str = "add", attn_mask=None,
            attn_mask_mode: str = "mul", rpe=None):
    """:func:`blocksparse_attention_gather` over a :class:`BlockTable`."""
    B, S, H, D = q.shape
    scale = _default_scale(D, scale)
    dev = q.device
    lut, valid, _ = table.on(dev)
    lut = lut.long()
    nb = S // block
    L = lut.shape[-1]
    qb, kb, vb = (t.transpose(1, 2).reshape(B, H, nb, block, D)
                  for t in (q, k, v))
    kg = _gather_blocks(kb.float(), lut)             # [B,H,nb,L,bk,D]
    vg = _gather_blocks(vb, lut)

    s = torch.einsum("bhqid,bhqlkd->bhqilk", qb.float(), kg) * scale
    # global row/col token ids for masking
    row_ids = (torch.arange(nb, device=dev)[:, None] * block
               + torch.arange(block, device=dev)[None, :])   # [nb, bq]
    col_ids = lut[..., None] * block + torch.arange(block, device=dev)
    rows = row_ids[None, :, :, None, None]                   # vs [H,nb,L,bk]
    cols = col_ids[:, :, None, :, :]

    keep = valid[None, :, :, None, :, None].expand(s.shape)
    if causal:
        keep = keep & (rows >= cols)[None]
    if attn_mask is not None:
        am = torch.as_tensor(attn_mask, device=dev)
        amg = am[rows, cols]                                 # [H,nb,bq,L,bk]
        if attn_mask_mode == "mul":
            keep = keep & (amg[None] != 0)
        else:
            s = s + amg[None].float()
    if rpe is not None:
        # relative-position bias [S, S], always additive
        s = s + torch.as_tensor(rpe, device=dev)[rows, cols][None].float()
    if key_padding_mask is not None:
        kp = torch.as_tensor(key_padding_mask, device=dev)   # [B, S]
        kpg = kp[:, col_ids]                                 # [B,H,nb,L,bk]
        if key_padding_mask_mode == "mul":
            keep = keep & (kpg[:, :, :, None] != 0)
        else:
            s = s + kpg[:, :, :, None].float()

    s = torch.where(keep, s, NEG_INF)
    sf = s.reshape(B, H, nb, block, L * block)
    keepf = keep.reshape(sf.shape)
    m = sf.amax(-1, keepdim=True)
    # rows with no active key produce all-NEG_INF: emit zeros
    p = torch.exp(sf - m.detach()) * keepf
    denom = p.sum(-1, keepdim=True)
    p = p / torch.where(denom == 0.0, 1.0, denom)
    p = p.reshape(B, H, nb, block, L, block).to(q.dtype)
    out = torch.einsum("bhqilk,bhqlkd->bhqid", p, vg)
    return out.reshape(B, H, S, D).transpose(1, 2)


# ---------------------------------------------------------------------------
# the CUDA kernel (K5)
# ---------------------------------------------------------------------------

def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t with its last dimension contiguous and every row 16 bytes aligned
    (what the kernel's vector loads need), copied only if it is not."""
    per16 = 16 // t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 \
            and all(s % per16 == 0 for s in t.stride()[:3]):
        return t
    return t.contiguous()


def _bs_fwd_cuda(q, k, v, table: BlockTable, block: int, causal: bool,
                 scale: float) -> torch.Tensor:
    """Launch K5 on CUDA tensors [B, S, H, D]; returns o [B, S, H, D]."""
    B, S, H, D = q.shape
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the block-sparse kernel takes float32, bfloat16 or"
                         f" float16 q/k/v of one dtype, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if block not in KERNEL_BLOCKS:
        raise ValueError(f"the block-sparse kernel takes blocks "
                         f"{KERNEL_BLOCKS}, got {block}")
    if D % 8 != 0 or not 0 < D <= 128:
        raise ValueError(f"the block-sparse kernel takes head dims that are "
                         f"multiples of 8 up to 128, got {D}")
    nb = S // block
    if S % block or table.lut.shape[:2] != (H, nb):
        raise ValueError(f"layout table {table.lut.shape} does not fit "
                         f"H={H}, S={S}, block={block}")
    if B > 65535 or H > 65535:
        raise ValueError(f"B={B}, H={H}: beyond the kernel grid's limit")
    lut, _, nnz = table.on(q.device)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    err = _build.load("blocksparse_fwd").ds_blocksparse_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lut.data_ptr(),
        nnz.data_ptr(), o.data_ptr(), _DTYPE_CODE[q.dtype], B, S, H, D,
        block, lut.shape[-1], *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], float(scale), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "blocksparse_fwd")
    blocksparse_attention_kernel.launches += 1
    return o


class _BlockSparseAttention(torch.autograd.Function):
    """K5 forward (the gather version on CPU tensors); the backward
    differentiates the gather version recomputed on the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, table, block, causal, scale):
        if q.device.type == "cpu":
            o = _gather(q, k, v, table, block, causal, scale)
        else:
            o = _bs_fwd_cuda(q, k, v, table, block, causal, scale)
        ctx.save_for_backward(q, k, v)
        ctx.args = (table, block, causal, scale)
        return o

    @staticmethod
    def backward(ctx, g):
        table, block, causal, scale = ctx.args
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            o = _gather(*inputs, table, block, causal, scale)
        return torch.autograd.grad(o, inputs, g) + (None,) * 4


def blocksparse_attention_kernel(q, k, v, lut, valid, block: int,
                                 causal: bool = False,
                                 scale: Optional[float] = None):
    """Block-sparse attention over [B, S, H, D] through K5 (CUDA tensors)
    or the gather version (CPU tensors); gradients recompute through the
    gather version (same math, exact VJP)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"blocksparse_attention_kernel: no kernel for "
                         f"device {q.device}")
    return _BlockSparseAttention.apply(q, k, v, block_table(lut, valid),
                                       block, bool(causal),
                                       _default_scale(q.shape[-1], scale))


# launches of K5 since the last reset (the gather version on CPU tensors
# does not count)
blocksparse_attention_kernel.launches = 0


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def blocksparse_attention(q, k, v, layout, causal: bool = False,
                          scale: Optional[float] = None,
                          key_padding_mask=None,
                          key_padding_mask_mode: str = "add",
                          attn_mask=None, attn_mask_mode: str = "mul",
                          rpe=None,
                          use_kernel: Optional[bool] = None,
                          lut_valid: Optional[Tuple] = None):
    """Block-sparse attention over [B, S, H, D] with a [H, nb, nb] layout.

    The kernel runs on the card when no element-wise mask and no ``rpe``
    are given and ``block % 8 == 0``; otherwise the gather version (same
    complexity) runs. ``use_kernel=True`` with a mask or ``rpe`` raises:
    the kernel cannot apply them (the JAX package drops them silently).
    ``lut_valid`` lets callers pass a pre-compiled ``make_lut`` result,
    whose device copies are then reused from call to call (as
    ``SparseSelfAttention`` passes its cached one); without it the table
    is built and uploaded on every call."""
    B, S, H, D = q.shape
    layout = np.asarray(layout)
    nb = layout.shape[1]
    if S % nb != 0:
        raise ValueError(f"seq len {S} not divisible by layout blocks {nb}")
    block = S // nb
    lut, valid = lut_valid if lut_valid is not None else make_lut(layout)
    masked = (key_padding_mask is not None or attn_mask is not None
              or rpe is not None)
    if use_kernel is None:
        use_kernel = q.device.type == "cuda" and not masked \
            and block % 8 == 0
    if use_kernel:
        if masked:
            raise ValueError(
                "use_kernel=True cannot apply key_padding_mask, attn_mask "
                "or rpe: the block-sparse kernel takes none of them")
        return blocksparse_attention_kernel(q, k, v, lut, valid, block,
                                            causal=causal, scale=scale)
    return blocksparse_attention_gather(
        q, k, v, lut, valid, block, causal=causal, scale=scale,
        key_padding_mask=key_padding_mask,
        key_padding_mask_mode=key_padding_mask_mode,
        attn_mask=attn_mask, attn_mask_mode=attn_mask_mode, rpe=rpe)


def blocksparse_reference(q, k, v, layout, causal: bool = False,
                          scale: Optional[float] = None,
                          key_padding_mask=None,
                          key_padding_mask_mode: str = "add",
                          attn_mask=None, attn_mask_mode: str = "mul",
                          rpe=None):
    """Dense O(S^2) reference with the layout expanded to an element mask
    (the parity oracle). A row with no active key averages v uniformly
    here, as in the JAX package's reference."""
    B, S, H, D = q.shape
    scale = _default_scale(D, scale)
    dev = q.device
    nb = np.asarray(layout).shape[1]
    block = S // nb
    mask = np.kron(np.asarray(layout), np.ones((block, block)))  # [H,S,S]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    keep = torch.as_tensor(mask != 0, device=dev)[None]
    if causal:
        keep = keep & torch.ones(S, S, dtype=torch.bool,
                                 device=dev).tril()[None, None]
    if attn_mask is not None:
        am = torch.as_tensor(attn_mask, device=dev)
        if attn_mask_mode == "mul":
            keep = keep & (am != 0)[None, None]
        else:
            logits = logits + am[None, None].float()
    if key_padding_mask is not None:
        kp = torch.as_tensor(key_padding_mask, device=dev)
        if key_padding_mask_mode == "mul":
            keep = keep & (kp != 0)[:, None, None, :]
        else:
            logits = logits + kp[:, None, None, :].float()
    if rpe is not None:
        logits = logits + torch.as_tensor(rpe, device=dev)[None, None].float()
    logits = torch.where(keep, logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = p.sum(-1, keepdim=True)
    p = (p / torch.where(denom == 0.0, 1.0, denom)).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)

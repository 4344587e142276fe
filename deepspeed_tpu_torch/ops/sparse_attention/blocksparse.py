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
# the design K5 runs for each dtype, as ``ds_blocksparse_fwd`` chooses it:
# the tensor cores ("mma", the union walk over row groups) in bfloat16 and
# float16, the CUDA cores in fp32 FMA ("fma", one query block's list per
# CTA) in float32, where TF32 would miss the float32 tolerance
DESIGN = {torch.float32: "fma", torch.bfloat16: "mma", torch.float16: "mma"}
# query rows of one row group: the 4 warps x 16 rows of a tensor-core CTA
GROUP_ROWS = 64


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


def union_table(lut: np.ndarray, valid: np.ndarray, block: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The active key blocks of each row group of ``GROUP_ROWS`` query
    rows, for the tensor-core K5, which loads each of them once for the
    whole group: ``(ulut [H, G, U], unnz [H, G], umask [H, G, U])`` with
    G = ceil(S / 64). ``ulut`` lists the union of the group's query blocks'
    active key blocks, ascending (zero-padded to the longest union, U);
    ``unnz`` its length; bit w of ``umask`` says whether the query block of
    warp w (rows 64 g + 16 w ..) uses that slot. A group holds 64 / block
    whole query blocks at block <= 64, and half of one at block 128."""
    H, nb, _ = lut.shape
    G = -(-nb * block // GROUP_ROWS)
    # bits[h, g, j]: the warps of group g whose query block lists key block
    # j (the query block of warp w holds rows 64 g + 16 w ..)
    bits = np.zeros((H, G, nb), np.int32)
    for w in range(4):
        qb = (np.arange(G) * GROUP_ROWS + 16 * w) // block
        live = qb < nb                       # a short last group
        rows = np.minimum(qb, nb - 1)
        h, g, slot = np.nonzero(valid[:, rows] & live[None, :, None])
        bits[h, g, lut[:, rows][h, g, slot]] |= 1 << w
    union = bits != 0
    unnz = union.sum(-1).astype(np.int32)
    U = max(1, int(unnz.max()))
    # each union block's place in its group's list: nonzero walks j upwards
    h, g, j = np.nonzero(union)
    at = (np.cumsum(union, -1) - 1)[h, g, j]
    ulut = np.zeros((H, G, U), np.int32)
    umask = np.zeros((H, G, U), np.int32)
    ulut[h, g, at] = j
    umask[h, g, at] = bits[h, g, j]
    return ulut, unnz, umask


def work_list(unnz: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """The CTAs of the tensor-core K5 for a union table's lengths
    ``unnz [H, G]``: ``(work [n, 5], combine [m, 4], n_part)``. A group
    whose union is longer than twice the table's median length is cut
    into pieces of about the median's length, each its own CTA, as K3
    splits a long block walk. ``work`` rows are (head, group, first slot,
    end slot, partial index), ordered by head and group so that the CTAs
    of one (batch, head) run side by side and share its K/V in L2; the
    partial index is -1 for a group of one piece (its CTA writes o) and
    otherwise the piece's place in the fp32 scratch of partial results.
    ``combine`` rows are (head, group, first partial index, pieces) of each
    split group, whose pieces the combine pass merges in piece order.
    ``n_part`` is the number of partial results."""
    med = max(1, int(np.ceil(np.median(unnz))))
    work, combine, n_part = [], [], 0
    H, G = unnz.shape
    for h in range(H):
        for g in range(G):
            n = int(unnz[h, g])
            if n <= 2 * med:
                work.append((h, g, 0, n, -1))
                continue
            pieces = -(-n // med)
            cuts = [i * n // pieces for i in range(pieces + 1)]
            combine.append((h, g, n_part, pieces))
            work += [(h, g, cuts[i], cuts[i + 1], n_part + i)
                     for i in range(pieces)]
            n_part += pieces
    return (np.asarray(work, np.int32).reshape(-1, 5),
            np.asarray(combine, np.int32).reshape(-1, 4), n_part)


class KernelPlan:
    """What the tensor-core K5 reads besides q, k, v for one layout table
    and block size: :func:`union_table` and :func:`work_list`, as numpy
    arrays, and ``on(device)``, one int32 device tensor that holds
    ``ulut``, ``umask``, ``work`` and ``combine`` one after the other,
    uploaded once per device."""

    def __init__(self, lut, valid, block: int):
        self.ulut, self.unnz, self.umask = union_table(lut, valid, block)
        self.work, self.combine, self.n_part = work_list(self.unnz)
        self.groups, self.slots = self.ulut.shape[1:]
        self._on = {}

    @property
    def split_groups(self) -> int:
        return len(self.combine)

    def on(self, device) -> torch.Tensor:
        key = str(torch.device(device))
        if key not in self._on:
            flat = np.concatenate([a.ravel() for a in (
                self.ulut, self.umask, self.work, self.combine)])
            self._on[key] = torch.from_numpy(flat).to(device)
        return self._on[key]


class BlockTable:
    """A :func:`make_lut` result with its device copies: ``on(device)``
    gives ``(lut int32, valid bool, nnz int32)`` there, uploaded once per
    device (the CUDA-core kernel reads ``lut`` and ``nnz``, the gather
    version ``lut`` and ``valid``); ``plan(block)`` the
    :class:`KernelPlan` of the tensor-core kernel, built once per block
    size. Get one through :func:`block_table`."""

    def __init__(self, lut, valid):
        self.source = (lut, valid)       # what block_table keys on
        self.lut = np.ascontiguousarray(lut, dtype=np.int32)
        self.valid = np.asarray(valid, dtype=bool)
        if self.lut.ndim != 3 or self.valid.shape != self.lut.shape:
            raise ValueError(f"lut and valid must be [H, nb, L] of one shape,"
                             f" got {self.lut.shape} and {self.valid.shape}")
        self._on = {}
        self._plans = {}

    def plan(self, block: int) -> KernelPlan:
        if block not in self._plans:
            self._plans[block] = KernelPlan(self.lut, self.valid, block)
        return self._plans[block]

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
    (what the kernels' 16-byte vector loads and cp.async copies need),
    copied only if it is not."""
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
    ptrs, sizes, scratch = [None] * 5, [0] * 5, None
    if DESIGN[q.dtype] == "mma":
        plan = table.plan(block)
        flat = plan.on(q.device)
        at, ptrs = 0, []
        for a in (plan.ulut, plan.umask, plan.work, plan.combine):
            ptrs.append(flat.data_ptr() + 4 * at)
            at += a.size
        if plan.n_part:
            # per partial result: 64 rows of D fp32 sums, then m and l
            scratch = torch.empty(plan.n_part * B * GROUP_ROWS * (D + 2),
                                  dtype=torch.float32, device=q.device)
        ptrs.append(None if scratch is None else scratch.data_ptr())
        sizes = [plan.groups, plan.slots, len(plan.work), len(plan.combine),
                 plan.n_part]
    err = _build.load("blocksparse_fwd").ds_blocksparse_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lut.data_ptr(),
        nnz.data_ptr(), o.data_ptr(), _DTYPE_CODE[q.dtype], B, S, H, D,
        block, lut.shape[-1], *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], float(scale), int(causal), *ptrs, *sizes,
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

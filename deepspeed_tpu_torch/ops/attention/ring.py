"""Ring attention: sequence parallelism across ranks.

Port of ``deepspeed_tpu/ops/attention/ring.py``. The JAX package shards
the sequence of global arrays over the ``sequence`` mesh axis inside a
``shard_map`` and rotates K/V with ``lax.ppermute``; here every rank of
the sequence group holds its own shard ``[B, S_loc, H, D]`` (the tokens
``[r * S_loc, (r + 1) * S_loc)`` of the sequence, or its zigzag chunks)
and the K/V blocks travel between ranks with ``parallel.comm.rotate``
(send to the next rank of the group, receive from the previous one).

- Each rank attends its q block to the K/V block it holds, then passes
  the block on; the per-block ``(o, lse)`` pairs are merged with an online
  softmax across the hops, so after the hops every q block has seen every
  K/V block it may see. Hop 0 is ordinary causal attention; hop i >= 1
  holds keys exactly ``i * S_loc`` tokens behind every query, so it is
  mask-free unless a sliding window cuts a band through it (then the
  block runs with ``q_off = i * S_loc``). Hops whose band is empty for
  every rank are dropped (:func:`_num_steps`): causal sliding-window
  attention does ``ceil((w + S_loc - 1) / S_loc)`` hops, not n. Under the
  contiguous layout a rank skips the blocks that lie wholly in its future.
- The local block is the flash kernels' ring mode on CUDA tensors
  (``flash.flash_block_fwd``/``flash_block_bwd``: K1-fwd, K2-dq and
  K2-dkv built with ``-DDS_RING``) and a chunked online softmax in plain
  PyTorch on CPU tensors (:func:`_plain_block_fwd`, ``chunk`` keys at a
  time, the JAX package's ``_jnp_block_fwd``). The JAX package gates its
  Pallas kernel on ``S_loc >= 128``; these kernels take any length, so
  the device alone decides.
- A ``torch.autograd.Function`` replays the rotation in the backward:
  delta = rowsum(do * o) is computed once, each hop's gradients come
  back in fp32 and are summed unrounded, the dk/dv accumulators travel
  with their K/V block and are delivered home over whichever direction
  takes fewer hops.
- Causal masking uses global token positions, so the result is exactly
  causal attention over the whole sequence; segment ids and the key
  validity mask rotate with their block; under grouped-query attention
  the grouped (smaller) k/v rotate.

Rows with no valid visible key anywhere return exact 0 (the JAX
package's contract; the dense path returns a uniform average of v, both
garbage by contract, zeroed by any masked loss).

Zigzag layout (``layout="zigzag"``): rank d holds chunks d and 2n-1-d of
the sequence cut into 2n, pre-permuted with :func:`zigzag_perm`, so every
rank does the same work at every hop: hop 0 is local causal attention;
at hop i > 0 the block from rank src = (d - i) mod n is seen whole by the
low half of its keys when src < d (all local rows against src's low
chunk) and only by the local high chunk when src > d. Causal only, no
window, as in JAX.
"""

from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.attention.flash import (NEG_INF,
                                                     attention_delta,
                                                     flash_block_bwd,
                                                     flash_block_fwd,
                                                     resolve_window_impl)
from deepspeed_tpu_torch.parallel import comm


def _largest_divisor(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= cap (cap >= 1)."""
    for c in range(min(cap, n), 0, -1):
        if n % c == 0:
            return c
    return 1


def zigzag_perm(S: int, n: int) -> np.ndarray:
    """Token permutation of the zigzag layout: the sequence cut into 2n
    chunks, rank d's shard is [chunk d, chunk 2n-1-d]. Apply to tokens,
    targets, positions and segment metadata on the host (``x[:, p]``)
    before each rank takes its contiguous shard."""
    assert S % (2 * n) == 0, (S, n)
    C = S // (2 * n)
    out = np.empty(S, np.int64)
    for d in range(n):
        base = d * 2 * C
        out[base:base + C] = np.arange(d * C, (d + 1) * C)
        out[base + C:base + 2 * C] = np.arange((2 * n - 1 - d) * C,
                                               (2 * n - d) * C)
    return out


def zigzag_unperm(S: int, n: int) -> np.ndarray:
    """Inverse of :func:`zigzag_perm` (restores the global order)."""
    return np.argsort(zigzag_perm(S, n))


def _num_steps(n: int, S_loc: int, causal: bool, window) -> int:
    """Hops that can meet the attention band. Under a causal sliding
    window, hop i's closest key is i*S_loc - (S_loc-1) tokens behind the
    query; once that is >= window the hop is dead for every rank and the
    rotation stops."""
    if causal and window is not None:
        return min(n, -(-(int(window) + S_loc - 1) // S_loc))
    return n


def _step_cfg(i: int, S_loc: int, causal: bool, window):
    """(causal, q_off, window) of hop i's block: hop 0 is self-attention;
    hop i >= 1 sees keys i*S_loc tokens behind every query, mask-free
    unless a window cuts a band through the block."""
    if not causal:
        return False, 0, None
    if i == 0:
        return True, 0, window
    off = i * S_loc
    if window is None or off + S_loc - 1 < window:
        return False, 0, None       # wholly inside the band
    return True, off, window


# ---------------------------------------------------------------------------
# the local block on CPU tensors: chunked online softmax
# ---------------------------------------------------------------------------

def _chunk_scores(qf, k, v, qsegs, ksegs, kvm, j, c, rows, group,
                  blk_causal, window, scale):
    """Masked fp32 scores [B, H, Sq, c] of chunk j of the held block, and
    its k, v [B, c, H, D] (GQA groups repeated)."""
    kj, vj = k[:, j * c:(j + 1) * c], v[:, j * c:(j + 1) * c]
    if group > 1:
        kj = torch.repeat_interleave(kj, group, dim=2)
        vj = torch.repeat_interleave(vj, group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kj.float()) * scale
    cols = j * c + torch.arange(c, device=qf.device)
    if blk_causal:
        m = rows[:, None] >= cols[None, :]
        if window is not None:
            m &= rows[:, None] - cols[None, :] < window
        s = torch.where(m[None, None], s, NEG_INF)
    if qsegs is not None:
        same = qsegs[:, None, :, None] == ksegs[:, None, None,
                                                j * c:(j + 1) * c]
        s = torch.where(same, s, NEG_INF)
    if kvm is not None:
        s = torch.where(kvm[:, None, None, j * c:(j + 1) * c] > 0, s,
                        NEG_INF)
    return s, kj, vj


def _plain_block_fwd(q, k, v, qsegs, ksegs, kvm, *, blk_causal, window,
                     q_off, scale, chunk):
    """Chunked online-softmax attention of q [B, S, H, D] against one held
    K/V block (the JAX package's ``_jnp_block_fwd``): peak memory
    O(B*H*S*chunk). Returns (o [B, S, H, D] in q's dtype, lse [B, H, S]
    fp32)."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    c = _largest_divisor(Skv, chunk)
    qf = q.float()
    rows = q_off + torch.arange(S, device=q.device)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    for j in range(Skv // c):
        s, _, vj = _chunk_scores(qf, k, v, qsegs, ksegs, kvm, j, c, rows,
                                 H // Hkv, blk_causal, window, scale)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                    vj.float())
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (acc / l_safe[..., None]).transpose(1, 2).to(q.dtype)
    return o, m + torch.log(l_safe)


def _plain_block_bwd(q, k, v, do, lse, delta, qsegs, ksegs, kvm, *,
                     blk_causal, window, q_off, scale, chunk):
    """This block's additive fp32 (dq [B, S, H, D], dk, dv [B, Skv, Hkv,
    D]) given the global lse and delta [B, H, S], chunked like the
    forward (the JAX package's ``_jnp_block_bwd``)."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    c = _largest_divisor(Skv, chunk)
    qf, dof = q.float(), do.float()
    rows = q_off + torch.arange(S, device=q.device)
    dq = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for j in range(Skv // c):
        s, kj, vj = _chunk_scores(qf, k, v, qsegs, ksegs, kvm, j, c, rows,
                                  group, blk_causal, window, scale)
        p = torch.exp(s - lse[..., None])
        dv_j = torch.einsum("bhqk,bqhd->bkhd", p, dof)
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vj.float())
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.einsum("bhqk,bkhd->bqhd", ds, kj.float())
        dk_j = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
        if group > 1:
            dk_j = dk_j.reshape(B, c, Hkv, group, D).sum(3)
            dv_j = dv_j.reshape(B, c, Hkv, group, D).sum(3)
        dks.append(dk_j)
        dvs.append(dv_j)
    return dq, torch.cat(dks, 1), torch.cat(dvs, 1)


def _block_fwd(q, k, v, qsg, ksg, kvm, bc, off, w, scale, chunk):
    """One local block: the flash kernel's ring mode on the card, the
    chunked plain block on the host."""
    if q.is_cuda:
        return flash_block_fwd(q, k, v, kvm, qsg, ksg, causal=bc,
                               scale=scale, window=w, q_off=off)
    return _plain_block_fwd(q, k, v, qsg, ksg, kvm, blk_causal=bc,
                            window=w, q_off=off, scale=scale, chunk=chunk)


def _block_bwd(q, do, lse, delta, k, v, qsg, ksg, kvm, bc, off, w, scale,
               chunk):
    if q.is_cuda:
        return flash_block_bwd(q, k, v, do, None, lse, kvm, qsg, ksg,
                               causal=bc, scale=scale, window=w, q_off=off,
                               delta=delta)
    return _plain_block_bwd(q, k, v, do, lse, delta, qsg, ksg, kvm,
                            blk_causal=bc, window=w, q_off=off, scale=scale,
                            chunk=chunk)


def _cut(t, a, b):
    """t[:, a:b] (the sequence dimension), None passing through."""
    return None if t is None else t[:, a:b]


def _rotate(items, group, shift=1):
    """The tensors of ``items`` (None kept in place) handed along the
    group in one message."""
    live = [t for t in items if t is not None]
    moved = iter(comm.rotate(live, group, shift))
    return [None if t is None else next(moved) for t in items]


def _merge(m, l, acc, o_i, lse_i, r0):
    """Online-softmax merge of a block's (o [B, Sq, H, D], lse [B, H, Sq])
    into the running state at rows r0..; a row whose block lse is -1e30
    (no valid key there) adds no mass."""
    sl = slice(r0, r0 + lse_i.shape[-1])
    mr = m[:, :, sl]
    m_new = torch.maximum(mr, lse_i)
    alpha = torch.exp(mr - m_new)
    coef = torch.where(lse_i > NEG_INF / 2, torch.exp(lse_i - m_new),
                       torch.zeros_like(lse_i))
    l[:, :, sl] = l[:, :, sl] * alpha + coef
    acc[:, sl] = acc[:, sl] * alpha.transpose(1, 2)[..., None] \
        + coef.transpose(1, 2)[..., None] * o_i.float()
    m[:, :, sl] = m_new


def _ring_fwd(q, k, v, segs, kvm, group, causal, scale, window, chunk,
              layout):
    n, idx = group.size, group.index
    B, S_loc, H, D = q.shape
    zig = layout == "zigzag"
    steps = n if zig else _num_steps(n, S_loc, causal, window)
    C = S_loc // 2
    dev = q.device
    m = torch.full((B, H, S_loc), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S_loc), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, S_loc, H, D), dtype=torch.float32, device=dev)
    k_cur, v_cur, segs_cur, kvm_cur = k, v, segs, kvm
    for i in range(steps):
        if zig and i > 0:
            src = (idx - i) % n
            if src < idx:     # every local row against src's low chunk
                o_i, lse_i = _block_fwd(
                    q, _cut(k_cur, 0, C), _cut(v_cur, 0, C), segs,
                    _cut(segs_cur, 0, C), _cut(kvm_cur, 0, C), False, 0,
                    None, scale, chunk)
                _merge(m, l, acc, o_i, lse_i, 0)
            else:             # the local high chunk against src's block
                o_i, lse_i = _block_fwd(
                    _cut(q, C, S_loc), k_cur, v_cur, _cut(segs, C, S_loc),
                    segs_cur, kvm_cur, False, 0, None, scale, chunk)
                _merge(m, l, acc, o_i, lse_i, C)
        else:
            bc, off, w = (causal, 0, window) if zig \
                else _step_cfg(i, S_loc, causal, window)
            # contiguous: a block wholly in this rank's future is skipped
            if not (causal and i > 0 and idx < i):
                o_i, lse_i = _block_fwd(q, k_cur, v_cur, segs, segs_cur,
                                        kvm_cur, bc, off, w, scale, chunk)
                _merge(m, l, acc, o_i, lse_i, 0)
        if i < steps - 1:
            k_cur, v_cur, segs_cur, kvm_cur = _rotate(
                [k_cur, v_cur, segs_cur, kvm_cur], group)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = acc / l_safe.transpose(1, 2)[..., None]
    return out.to(q.dtype), m + torch.log(l_safe)


def _ring_bwd(q, k, v, segs, kvm, o, lse, do, group, causal, scale,
              window, chunk, layout):
    n, idx = group.size, group.index
    B, S_loc, H, D = q.shape
    Hkv = k.shape[2]
    zig = layout == "zigzag"
    steps = n if zig else _num_steps(n, S_loc, causal, window)
    C = S_loc // 2
    dev = q.device
    # the global rows' delta, once for every hop (FA2's identity)
    delta = attention_delta(o, do)
    dq = torch.zeros((B, S_loc, H, D), dtype=torch.float32, device=dev)
    dk_acc = torch.zeros((B, S_loc, Hkv, D), dtype=torch.float32,
                         device=dev)
    dv_acc = torch.zeros_like(dk_acc)
    k_cur, v_cur, segs_cur, kvm_cur = k, v, segs, kvm
    for i in range(steps):
        if zig and i > 0:
            src = (idx - i) % n
            if src < idx:
                dq_i, dk_i, dv_i = _block_bwd(
                    q, do, lse, delta, _cut(k_cur, 0, C),
                    _cut(v_cur, 0, C), segs, _cut(segs_cur, 0, C),
                    _cut(kvm_cur, 0, C), False, 0, None, scale, chunk)
                dq += dq_i
                dk_acc[:, :C] += dk_i
                dv_acc[:, :C] += dv_i
            else:
                dq_i, dk_i, dv_i = _block_bwd(
                    _cut(q, C, S_loc), _cut(do, C, S_loc),
                    lse[:, :, C:], delta[:, :, C:], k_cur, v_cur,
                    _cut(segs, C, S_loc), segs_cur, kvm_cur, False, 0, None,
                    scale, chunk)
                dq[:, C:] += dq_i
                dk_acc += dk_i
                dv_acc += dv_i
        else:
            bc, off, w = (causal, 0, window) if zig \
                else _step_cfg(i, S_loc, causal, window)
            if not (causal and i > 0 and idx < i):
                dq_i, dk_i, dv_i = _block_bwd(
                    q, do, lse, delta, k_cur, v_cur, segs, segs_cur,
                    kvm_cur, bc, off, w, scale, chunk)
                dq += dq_i
                dk_acc += dk_i
                dv_acc += dv_i
        if i < steps - 1:
            k_cur, v_cur, segs_cur, kvm_cur, dk_acc, dv_acc = _rotate(
                [k_cur, v_cur, segs_cur, kvm_cur, dk_acc, dv_acc], group)
    # block b's accumulator sits at rank (b + steps - 1) % n: go on round
    # the ring or come back, whichever takes fewer hops
    fwd_hops, bwd_hops = (n - steps + 1) % n, steps - 1
    for _ in range(min(fwd_hops, bwd_hops)):
        dk_acc, dv_acc = _rotate([dk_acc, dv_acc], group,
                                 1 if fwd_hops <= bwd_hops else -1)
    return dq.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype)


class RingAttention(torch.autograd.Function):
    """``(o, lse)`` of the ring over this rank's shards, with the ring
    backward. ``known_o``/``known_lse``: a pair kept from an earlier
    forward of the same inputs (activation checkpointing), returned
    without a rotation."""

    @staticmethod
    def forward(ctx, q, k, v, segs, kvm, group, causal, scale, window,
                chunk, layout, known_o=None, known_lse=None):
        if known_o is not None:
            o, lse = known_o, known_lse
        else:
            o, lse = _ring_fwd(q, k, v, segs, kvm, group, causal, scale,
                               window, chunk, layout)
        ctx.save_for_backward(q, k, v, segs, kvm, o, lse)
        ctx.args = (group, causal, scale, window, chunk, layout)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, segs, kvm, o, lse = ctx.saved_tensors
        group, causal, scale, window, chunk, layout = ctx.args
        dq, dk, dv = _ring_bwd(q, k, v, segs, kvm, o, lse, do.contiguous(),
                               group, causal, scale, window, chunk, layout)
        return (dq, dk, dv) + (None,) * 10


def sequence_group(mesh=None, axis: str = "sequence"):
    """The ``parallel.mesh.AxisGroup`` of ``axis`` on ``mesh`` (default:
    the registered mesh, ``utils.groups``; one rank without one)."""
    from deepspeed_tpu_torch.parallel.mesh import AxisGroup
    from deepspeed_tpu_torch.utils import groups
    if mesh is None:
        mesh = groups._MESH
    if mesh is None:
        return AxisGroup((axis,), (0,), 0, None)
    group = mesh.group(axis)
    if group.size > 1 and group.pg is None:
        raise ValueError(f"a '{axis}' axis of {group.size} ranks needs a "
                         f"process group: build the mesh after "
                         f"deepspeed_tpu_torch.init_distributed")
    return group


def ring_attention(q, k, v, mesh=None, *, causal: bool = True,
                   scale: Optional[float] = None, axis: str = "sequence",
                   segment_ids=None, kv_mask=None,
                   window: Optional[int] = None, chunk: int = 1024,
                   layout: str = "contiguous",
                   window_impl: Optional[str] = None, known=None,
                   return_kept: bool = False):
    """Exact (causal) attention with the sequence split over the ranks of
    ``axis`` on ``mesh`` (a ``parallel.mesh.Mesh``; default the registered
    one). q [B, S_loc, H, D] and k, v [B, S_loc, Hkv, D] (grouped-query
    attention: Hkv divides H) are this rank's shards, in group order (or
    zigzag-permuted with :func:`zigzag_perm` under ``layout="zigzag"``);
    ``segment_ids``/``kv_mask`` [B, S_loc] its tokens' packed-document ids
    and key validity. Returns this rank's output [B, S_loc, H, D],
    differentiable in q, k and v. ``window``: causal sliding window
    (``window_impl``: see ``flash.resolve_window_impl``). ``chunk``: keys
    per step of the plain block on the host. ``known``/``return_kept``:
    the ``(o, lse)`` pair activation checkpointing keeps
    (:class:`RingAttention`); with ``return_kept`` the result is
    ``(out, (o, lse))``."""
    if scale is None:
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
    if window is not None:
        if not causal:
            raise ValueError("sliding window requires causal attention")
        window = resolve_window_impl(window, window_impl)
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring layout {layout!r}")
    if layout == "zigzag" and (not causal or window is not None):
        raise ValueError(
            "zigzag layout balances the CAUSAL triangle; use the "
            "contiguous layout for non-causal or windowed attention")
    H, Hkv = q.shape[2], k.shape[2]
    if H % Hkv or v.shape[2] != Hkv:
        raise ValueError(f"q has {H} heads, k {Hkv}, v {v.shape[2]}: kv "
                         f"head counts must match and divide {H}")
    if layout == "zigzag" and q.shape[1] % 2:
        raise ValueError(f"zigzag needs an even local shard, got "
                         f"S_loc={q.shape[1]}")
    group = sequence_group(mesh, axis)
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32).contiguous()
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.float32).contiguous()
    known_o, known_lse = known if known is not None else (None, None)
    o, lse = RingAttention.apply(q, k, v, segment_ids, kv_mask, group,
                                 bool(causal), float(scale), window,
                                 int(chunk), layout, known_o, known_lse)
    return (o, (o, lse)) if return_kept else o

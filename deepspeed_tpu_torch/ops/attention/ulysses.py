"""Ulysses sequence parallelism: attention over all-to-all re-sharded
heads.

Port of ``deepspeed_tpu/ops/attention/ulysses.py``. Where ring attention
(``ops/attention/ring.py``) rotates K/V blocks, Ulysses re-shards with
two all-to-alls so that every rank runs one attention over the WHOLE
sequence for a slice of the heads:

- q, k, v arrive as this rank's sequence shard [B, S/sp, H, D];
- all-to-all #1 (seq -> heads) gives every rank the whole sequence for
  H/sp heads (and Hkv/sp kv heads);
- the segment ids and key-validity mask are all-gathered to the whole
  sequence ([B, S] integers, small next to q, k, v);
- local attention: the port's ``flash_attention`` (K1-fwd and K2 on the
  card, their plain versions on the host), unchanged, since it sees the
  whole rows;
- all-to-all #2 (heads -> seq) brings the output back to the sequence
  shard.

Each all-to-all is a ``torch.autograd.Function`` whose backward is the
other one. The sp degree must divide both head counts (the local kernel
keeps the global q/kv group ratio).
"""

from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.attention.flash import (flash_attention,
                                                     resolve_window_impl)
from deepspeed_tpu_torch.ops.attention.ring import sequence_group
from deepspeed_tpu_torch.parallel import comm


def _seq_to_head(x, group):
    """[B, S_loc, H, D] -> [B, S, H/n, D]: head slice j goes to rank j,
    and the received sequence shards are concatenated in rank order."""
    n = group.size
    B, S_loc, H, D = x.shape
    pieces = x.reshape(B, S_loc, n, H // n, D).permute(2, 0, 1, 3, 4)
    got = comm.all_to_all(pieces, group)          # [n, B, S_loc, H/n, D]
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * S_loc, H // n, D)


def _head_to_seq(x, group):
    """[B, S, H/n, D] -> [B, S_loc, H, D], the inverse of
    :func:`_seq_to_head`."""
    n = group.size
    B, S, Hn, D = x.shape
    pieces = x.reshape(B, n, S // n, Hn, D).permute(1, 0, 2, 3, 4)
    got = comm.all_to_all(pieces, group)          # [n, B, S_loc, H/n, D]
    return got.permute(1, 2, 0, 3, 4).reshape(B, S // n, n * Hn, D)


class SeqToHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_head(x, group)

    @staticmethod
    def backward(ctx, g):
        return _head_to_seq(g.contiguous(), ctx.group), None


class HeadToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _head_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_head(g.contiguous(), ctx.group), None


def ulysses_attention(q, k, v, mesh=None, *, causal: bool = True,
                      scale: Optional[float] = None, axis: str = "sequence",
                      segment_ids=None, kv_mask=None,
                      window: Optional[int] = None,
                      window_impl: Optional[str] = None, known=None,
                      return_kept: bool = False):
    """Exact (causal) attention with the sequence split over the ranks of
    ``axis`` on ``mesh`` (default the registered mesh) by head <-> sequence
    all-to-alls. q [B, S_loc, H, D], k, v [B, S_loc, Hkv, D] and
    ``segment_ids``/``kv_mask`` [B, S_loc] are this rank's shards in group
    order; returns its output [B, S_loc, H, D], differentiable in q, k and
    v. ``known``/``return_kept``: the local attention's ``(o, lse)`` (over
    the whole sequence and this rank's heads) that activation
    checkpointing keeps; with ``return_kept`` the result is ``(out, (o,
    lse))``."""
    group = sequence_group(mesh, axis)
    sp = group.size
    H, Hkv = q.shape[2], k.shape[2]
    if H % sp:
        raise ValueError(f"n_heads {H} not divisible by sp degree {sp}")
    if Hkv % sp:
        raise ValueError(f"kv heads {Hkv} not divisible by sp degree {sp} "
                         "(GQA + Ulysses needs both head counts divisible)")
    if scale is None:
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
    window = resolve_window_impl(window, window_impl)
    qh, kh, vh = (SeqToHead.apply(t, group) for t in (q, k, v))
    full_segs = None if segment_ids is None else comm.all_gather_dim(
        segment_ids.to(torch.int32), group, 1)
    full_mask = None if kv_mask is None else comm.all_gather_dim(
        kv_mask.to(torch.float32), group, 1)
    o, lse = flash_attention(qh, kh, vh, causal=causal, scale=scale,
                             kv_mask=full_mask, window=window,
                             segment_ids=full_segs, known=known)
    out = HeadToSeq.apply(o, group)
    return (out, (o, lse)) if return_kept else out

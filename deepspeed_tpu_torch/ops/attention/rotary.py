"""Rotary position embeddings, GPT-J interleaved convention.

Port of ``deepspeed_tpu/ops/attention/rotary.py``: the "rotate every two"
layout on the first ``rotary_dim`` channels of each head (not the NeoX
half-split); the remaining channels pass through. A few elementwise ops,
bound by bytes, so no kernel of its own.
"""

from typing import Optional, Tuple

import torch


def _rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    x1 = x[..., ::2]
    x2 = x[..., 1::2]
    return torch.stack((-x2, x1), dim=-1).reshape(x.shape)


def rotary_sin_cos(positions: torch.Tensor, rotary_dim: int,
                   base: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [S] or [B, S] -> (sin, cos), each
    ``positions.shape + (rotary_dim,)`` (interleaved pairs), fp32."""
    exps = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                        device=positions.device) / rotary_dim
    inv_freq = 1.0 / (base ** exps)
    ang = positions.to(torch.float32)[..., None] * inv_freq
    sin = torch.repeat_interleave(torch.sin(ang), 2, dim=-1)
    cos = torch.repeat_interleave(torch.cos(ang), 2, dim=-1)
    return sin, cos


def apply_rotary(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                 rotary_dim: Optional[int] = None, base: float = 10000.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q, k ([B, S, H, D]) by position; positions is [S] absolute,
    or [B, S] for per-row positions (left-padded batches, paged slots)."""
    D = q.shape[-1]
    rd = D if rotary_dim is None else rotary_dim
    sin, cos = rotary_sin_cos(positions, rd, base)
    if positions.dim() == 1:            # [S, rd] -> [1, S, 1, rd]
        sin, cos = sin[None], cos[None]
    sin = sin[:, :, None, :].to(q.dtype)
    cos = cos[:, :, None, :].to(q.dtype)

    def rot(t):
        t_rot = t[..., :rd] * cos + _rotate_every_two(t[..., :rd]) * sin
        if rd == D:
            return t_rot
        return torch.cat([t_rot, t[..., rd:]], dim=-1)

    return rot(q), rot(k)

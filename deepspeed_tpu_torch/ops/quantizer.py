"""KV-cache block quantization: int8 codes with one fp32 scale per
(block, kv head).

Port of the KV helpers of ``deepspeed_tpu/ops/quantizer.py``. A block is
one paged-cache block ``[..., block_size, kv_heads, head_dim]``; its scale
is reduced over the token and head-dim axes::

    scale = absmax / 127,   q = round(x / scale) in [-127, 127],
    x ~= q * scale

``torch.round`` rounds half to even, as ``jnp.round`` does, so the same
float32 input gives the JAX package's codes and scales bit for bit. The
paged decode kernel dequantizes a block in registers right after loading
it (``csrc/paged_decode.cu``, int8 mode).

The ``DS_KV_QUANT`` environment variable is not read: the mode comes from
the caller only.
"""

from typing import Optional, Tuple

import torch

KV_QMAX = 127.0

_OFF = {"off", "0", "false", "no", "none", ""}
_INT8 = {"int8", "on", "1", "true", "yes"}


def resolve_kv_quant(mode=None) -> str:
    """The KV-cache quantization mode, ``"off"`` or ``"int8"``, from the
    JAX package's spellings: None, False and ``"off"`` (``"0"``,
    ``"false"``, ``"no"``, ``"none"``) mean off; True, ``"on"`` and
    ``"int8"`` (``"1"``, ``"true"``, ``"yes"``) mean int8."""
    if mode is None or mode is False:
        return "off"
    if mode is True:
        return "int8"
    v = str(mode).strip().lower()
    if v in _OFF:
        return "off"
    if v in _INT8:
        return "int8"
    raise ValueError(f"kv_quant={mode!r}: expected one of 'off', 'int8'")


def kv_block_scales(x: torch.Tensor) -> torch.Tensor:
    """Symmetric per-(block, kv head) scales of ``x``
    ``[..., block_size, kv_heads, head_dim]`` -> ``[..., kv_heads]``
    float32. An all-zero block gets scale 0 (quantize guards the divide,
    dequantize multiplies by 0)."""
    absmax = x.float().abs().amax(dim=(-3, -1))
    return absmax / KV_QMAX


def kv_quantize_blocks(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize ``x`` ``[..., bs, Hkv, Dh]`` to int8 with the per-(block,
    kv head) ``scale`` ``[..., Hkv]`` (multiply convention)."""
    safe = torch.where(scale > 0, scale, 1.0)[..., None, :, None]
    q = torch.round(x.float() / safe)
    return q.clamp(-KV_QMAX, KV_QMAX).to(torch.int8)


def kv_requantize_blocks(x: torch.Tensor,
                         live: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize blocks ``x`` ``[..., bs, Hkv, Dh]``, zeroing the token
    rows that ``live`` ``[..., bs]`` marks stale first, so a previous
    owner's values never inflate the absmax. Returns ``(q, scale)``."""
    x = x.float()
    if live is not None:
        x = torch.where(live[..., None, None], x, 0.0)
    scale = kv_block_scales(x)
    return kv_quantize_blocks(x, scale), scale


def kv_dequantize_blocks(q: torch.Tensor, scale: torch.Tensor,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`kv_quantize_blocks`: ``q * scale`` broadcast over
    ``[..., bs, Hkv, Dh]``, computed in float32 and cast to ``dtype``."""
    out = q.float() * scale[..., None, :, None]
    return out.to(dtype)

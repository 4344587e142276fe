"""BERT-style transformer encoder layer.

Port of ``deepspeed_tpu/ops/transformer/encoder_layer.py`` (the
reference's fused ``DeepSpeedTransformerLayer``): QKV projection,
attention, output projection, GELU MLP, layernorms and dropout, with the
residual before (pre-LN) or after (post-LN) the layernorm. The attention
core is the flash kernels, non-causal with the padding mask as their
``kv_mask``, under the JAX package's gate (S >= 128, D % 8 == 0, no
attention dropout); otherwise the masked softmax with an additive -1e9
bias. Where the JAX package catches a failure of the flash path and falls
back to the softmax, the port lets it raise: on the card a flash failure
is an error, not a slower path.

Layernorm statistics are fp32 and the result takes x's dtype (the JAX
layer keeps x's dtype throughout; the two agree in float32). Dropout draws
from a ``torch.Generator`` seeded per call: its bits are not JAX's
threefry bits, so only the rate and the unbiased scaling carry over.
"""

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.attention.flash import flash_attention
from deepspeed_tpu_torch.ops.layers import dense, dropout, layernorm
from deepspeed_tpu_torch.tree import tree_map


@dataclass
class DeepSpeedTransformerConfig:
    """The knobs of the JAX package's config that affect the math; the
    kernel-scheduling knobs of the reference's CUDA layer
    (stochastic_mode, attn_dropout_checkpoint, ...) have no counterpart."""
    batch_size: int = -1          # unused: shapes come from the inputs
    hidden_size: int = 256
    intermediate_size: int = -1   # defaults to 4*hidden
    heads: int = 4
    attn_dropout_ratio: float = 0.1
    hidden_dropout_ratio: float = 0.1
    num_hidden_layers: int = -1
    layer_norm_eps: float = 1e-12
    pre_layer_norm: bool = True
    fp16: bool = False            # API parity; dtype follows inputs

    def __post_init__(self):
        if self.intermediate_size <= 0:
            self.intermediate_size = 4 * self.hidden_size
        if self.hidden_size % self.heads:
            raise ValueError(f"hidden_size {self.hidden_size} is not a "
                             f"multiple of heads {self.heads}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.heads


def init_layer_params(gen: torch.Generator, cfg: DeepSpeedTransformerConfig,
                      dtype: torch.dtype = torch.float32) -> Dict:
    """One layer's parameters (normal(0.02) kernels, zero biases, unit
    layernorm scales) drawn from ``gen`` on its device. The values differ
    from the JAX package's: tests hand both the same numpy parameters."""
    h, ff = cfg.hidden_size, cfg.intermediate_size
    dev = gen.device

    def normal(shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dtype)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def dense(n_in, n_out):
        return {"kernel": normal((n_in, n_out)), "bias": const((n_out,), 0.0)}

    return {
        "qkv": dense(h, 3 * h),
        "attn_out": dense(h, h),
        "mlp_in": dense(h, ff),
        "mlp_out": dense(ff, h),
        "ln1": {"scale": const((h,), 1.0), "bias": const((h,), 0.0)},
        "ln2": {"scale": const((h,), 1.0), "bias": const((h,), 0.0)},
    }


def flash_gate(cfg: DeepSpeedTransformerConfig, S: int, deterministic: bool,
               allow_flash: bool = True) -> bool:
    """Whether :func:`_attention_core` takes the flash kernels."""
    return (allow_flash
            and (deterministic or cfg.attn_dropout_ratio == 0.0)
            and S >= 128 and cfg.head_dim % 8 == 0)


def _attention_core(q, k, v, attn_mask, cfg: DeepSpeedTransformerConfig,
                    dropout_seed, deterministic: bool,
                    allow_flash: bool = True, tape=None):
    """[B, S, H, D] attention: the flash kernels (``attn_mask`` [B, S] as
    their key mask) when :func:`flash_gate` allows, else the masked
    softmax. Under a checkpointed layer's tape with ``"flash"`` kept, the
    flash output and log-sum-exp are recorded or replayed."""
    B, S, H, D = q.shape
    if flash_gate(cfg, S, deterministic, allow_flash):
        kept = tape is not None and "flash" in tape.keep
        known = (tape.saved["flash_o"], tape.saved["flash_lse"]) \
            if kept and tape.replay else None
        o, lse = flash_attention(q, k, v, causal=False, kv_mask=attn_mask,
                                 known=known)
        if kept and not tape.replay:
            tape.saved["flash_o"], tape.saved["flash_lse"] = o, lse
        return o
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() \
        * (1.0 / math.sqrt(D))
    if attn_mask is not None:
        # attn_mask [B, S]: 1 = attend, 0 = padding
        logits = logits + torch.where(attn_mask[:, None, None, :] > 0,
                                      0.0, -1e9)
    probs = torch.softmax(logits, dim=-1)
    if not deterministic and cfg.attn_dropout_ratio > 0:
        probs = dropout(probs, cfg.attn_dropout_ratio, dropout_seed)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def layer_seeds(seed: int):
    """The three dropout seeds of one layer (output of attention, the
    attention probabilities, output of the MLP), derived from ``seed``, so
    that a checkpointed layer's rerun draws the same masks."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, 2 ** 62, (3,), generator=gen).tolist()


def layer_forward(params: Dict, x: torch.Tensor,
                  cfg: DeepSpeedTransformerConfig,
                  attn_mask: Optional[torch.Tensor] = None,
                  rng: Optional[int] = None,
                  deterministic: bool = True,
                  allow_flash: bool = True, tape=None) -> torch.Tensor:
    """One encoder block. x: [B, S, hidden]; attn_mask: [B, S] (1 = token);
    rng: an integer dropout seed (None: no dropout).

    Pre-LN:  x + Attn(LN(x));  x + MLP(LN(x))
    Post-LN: LN(x + Attn(x));  LN(x + MLP(x))

    ``tape``: what a checkpointed layer records or replays (the
    ``ops.layers`` remat machinery): the ``qkv`` and ``mlp_pre``
    projections and the flash output."""
    B, S, h = x.shape
    H, D = cfg.heads, cfg.head_dim
    dt = x.dtype
    p = tree_map(lambda t: t.to(dt), params)
    if rng is not None:
        r_attn, r_probs, r_mlp = layer_seeds(rng)
    else:
        r_attn = r_probs = r_mlp = None
        deterministic = True
    hidden_drop = not deterministic and cfg.hidden_dropout_ratio > 0

    def attn_block(inp):
        qkv = dense(inp, p["qkv"], tape, "qkv")
        q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(h, dim=-1))
        ctx = _attention_core(q, k, v, attn_mask, cfg, r_probs,
                              deterministic, allow_flash=allow_flash,
                              tape=tape).reshape(B, S, h)
        out = dense(ctx, p["attn_out"])
        return dropout(out, cfg.hidden_dropout_ratio, r_attn) \
            if hidden_drop else out

    def mlp_block(inp):
        mid = F.gelu(dense(inp, p["mlp_in"], tape, "mlp_pre"),
                     approximate="tanh")
        out = dense(mid, p["mlp_out"])
        return dropout(out, cfg.hidden_dropout_ratio, r_mlp) \
            if hidden_drop else out

    eps = cfg.layer_norm_eps
    ln1, ln2 = p["ln1"], p["ln2"]
    if cfg.pre_layer_norm:
        x = x + attn_block(layernorm(x, ln1["scale"], ln1["bias"], eps))
        x = x + mlp_block(layernorm(x, ln2["scale"], ln2["bias"], eps))
    else:
        x = layernorm(x + attn_block(x), ln1["scale"], ln1["bias"], eps)
        x = layernorm(x + mlp_block(x), ln2["scale"], ln2["bias"], eps)
    return x.to(dt)


def layer_forward_reference(params, x, cfg, attn_mask=None):
    """Plain fp32 reference of the same math for parity tests: it forces
    the masked softmax, so it stays an oracle independent of the flash
    kernels."""
    p32 = tree_map(lambda t: t.float(), params)
    return layer_forward(p32, x.float(), cfg, attn_mask=attn_mask,
                         deterministic=True, allow_flash=False)

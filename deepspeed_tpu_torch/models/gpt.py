"""GPT-family decoder: configuration, parameters and the per-block pieces
the inference engine runs.

Port of the inference side of ``deepspeed_tpu/models/gpt.py``. Parameters
keep the JAX package's pytree layout as nested dicts of tensors: every
layer's weights stacked on a leading axis (``params["block"]["qkv"]
["kernel"]`` is ``[L, d, qkv_dim]``), dense kernels ``[in, out]``, so a
layer is a view ``t[l]`` and the parity tests compare like with like.
Training fields (remat, dropout, flash block sizes, sequence parallelism,
the chunked loss) wait for the training slice.
"""

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.ops.attention.rotary import apply_rotary


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    n_layers: int = 12
    n_heads: int = 12
    d_model: int = 768
    d_ff: Optional[int] = None         # default 4*d_model
    max_seq_len: int = 1024
    dtype: torch.dtype = torch.bfloat16
    attn_scale: Optional[float] = None  # None -> 1/sqrt(head_dim)
    rotary_dim: Optional[int] = None    # GPT-J rotary channels (0/None = off)
    parallel_residual: bool = False     # x + attn(h) + mlp(h), h = ln1(x)
    use_wpe: bool = True                # learned absolute positions
    n_kv_heads: Optional[int] = None    # grouped-query attention (None = MHA)
    attn_window: Optional[int] = None   # token i attends (i - window, i]
    norm: str = "layernorm"             # or "rmsnorm"
    norm_eps: float = 1e-5
    activation: str = "gelu"            # or "swiglu"
    use_bias: bool = True
    rope_theta: float = 10000.0
    tie_embeddings: bool = True

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        h = self.n_kv_heads or self.n_heads
        if self.n_heads % h:
            raise ValueError(f"n_heads {self.n_heads} is not a multiple of "
                             f"n_kv_heads {h}")
        return h

    @property
    def qkv_dim(self) -> int:
        """Fused qkv projection width: H*Dh + 2*Hkv*Dh."""
        return (self.n_heads + 2 * self.kv_heads) * self.head_dim

    @property
    def ffn_dim(self) -> int:
        return self.d_ff if self.d_ff is not None else 4 * self.d_model


PRESETS = {
    "gpt2-small": dict(n_layers=12, n_heads=12, d_model=768),
    "gpt2-medium": dict(n_layers=24, n_heads=16, d_model=1024),
    "gpt2-large": dict(n_layers=36, n_heads=20, d_model=1280),
    "gpt2-xl": dict(n_layers=48, n_heads=25, d_model=1600),
    "gpt2-1.5b": dict(n_layers=48, n_heads=25, d_model=1600),
    "gpt2-4b": dict(n_layers=64, n_heads=32, d_model=2304),
    "gpt2-8b": dict(n_layers=72, n_heads=32, d_model=3072),
}

# llama-family architecture: rmsnorm + swiglu + rotary + no biases,
# untied head, no learned positions
_LLAMA_ARCH = dict(norm="rmsnorm", activation="swiglu", use_bias=False,
                   use_wpe=False, tie_embeddings=False,
                   parallel_residual=False, norm_eps=1e-6)
PRESETS.update({
    "llama-tiny": dict(n_layers=4, n_heads=8, n_kv_heads=4, d_model=256,
                       d_ff=688, rotary_dim=32, vocab_size=512,
                       max_seq_len=256, **_LLAMA_ARCH),
    "llama-7b": dict(n_layers=32, n_heads=32, d_model=4096, d_ff=11008,
                     rotary_dim=128, vocab_size=32000, max_seq_len=2048,
                     **_LLAMA_ARCH),
    "llama-13b": dict(n_layers=40, n_heads=40, d_model=5120, d_ff=13824,
                      rotary_dim=128, vocab_size=32000, max_seq_len=2048,
                      **_LLAMA_ARCH),
})


def preset(name: str, **overrides) -> GPTConfig:
    cfg = dict(PRESETS[name])
    cfg.update(overrides)
    return GPTConfig(**cfg)


def init_params(cfg: GPTConfig, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32) -> Dict:
    """Random parameters with the JAX package's shapes and init scales
    (normal(0.02); the residual-branch projections normal(0.02/sqrt(2L));
    norms at scale 1, bias 0), drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device``. The values differ from JAX's: tests hand
    both packages the same numpy parameters through
    :func:`deepspeed_tpu_torch.models.convert.params_from_numpy`.

    Layers are drawn one at a time in fp32 and stored in ``dtype``, so a
    full-width model is built on the card without an fp32 copy of it."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    d, L, ff = cfg.d_model, cfg.n_layers, cfg.ffn_dim
    resid = 0.02 / math.sqrt(2.0 * L)

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=device)
                .mul_(std).to(dtype))

    def stacked(shape, std=0.02):
        out = torch.empty((L,) + shape, dtype=dtype, device=device)
        for i in range(L):
            out[i] = normal(shape, std)
        return out

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    def norm_p(lead=()):
        p = {"scale": const(lead + (d,), 1.0)}
        if cfg.norm != "rmsnorm":
            p["bias"] = const(lead + (d,), 0.0)
        return p

    def dense(shape, std=0.02):
        entry = {"kernel": stacked(shape, std)}
        if cfg.use_bias:
            entry["bias"] = const((L, shape[-1]), 0.0)
        return entry

    params = {
        "wte": {"embedding": normal((cfg.vocab_size, d), 0.02)},
        "block": {
            "ln1": norm_p((L,)),
            "qkv": dense((d, cfg.qkv_dim)),
            "attn_out": dense((d, d), resid),
            "ln2": norm_p((L,)),
            "mlp_in": dense((d, ff)),
            "mlp_out": dense((ff, d), resid),
        },
        "ln_f": norm_p(),
    }
    if cfg.activation == "swiglu":
        params["block"]["mlp_gate"] = dense((d, ff))
    if cfg.use_wpe:
        params["wpe"] = {"embedding": normal((cfg.max_seq_len, d), 0.02)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": normal((d, cfg.vocab_size), 0.02)}
    return params


def layer(params: Dict, i: int) -> Dict:
    """Layer ``i``'s weights as views into the stacked block tree."""
    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return tree[i]
    return pick(params["block"])


def _layernorm(x, scale, bias, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _norm(x, p, cfg: GPTConfig):
    """GPT-2 layernorm or llama rmsnorm (scale only, no mean subtraction),
    statistics in fp32."""
    if cfg.norm == "rmsnorm":
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True)
                             + cfg.norm_eps)
        return (y * p["scale"].float()).to(x.dtype)
    return _layernorm(x, p["scale"], p["bias"], eps=cfg.norm_eps)


def _dense(h, p):
    """h @ kernel (+ bias when the config kept biases). Int8 weights and
    LoRA wait for their slices."""
    y = h @ p["kernel"]
    b = p.get("bias")
    return y if b is None else y + b


def _qkv_split_rotary(qkv, cfg: GPTConfig, positions, B: int, S: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split a fused qkv projection into per-head q/k/v [B, S, heads, Dh]
    and apply rotary at ``positions`` ([S] or [B, S]; None = arange(S))."""
    H, Dh, Hkv = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    q, k, v = torch.split(qkv, [H * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, Hkv, Dh)
    v = v.reshape(B, S, Hkv, Dh)
    if cfg.rotary_dim:
        if positions is None:
            positions = torch.arange(S, device=qkv.device)
        q, k = apply_rotary(q, k, positions, cfg.rotary_dim,
                            base=cfg.rope_theta)
    return q, k, v


def _mlp(h, p, cfg: GPTConfig):
    m = _dense(h, p["mlp_in"])
    if cfg.activation == "swiglu":
        m = F.silu(_dense(h, p["mlp_gate"])) * m
    else:
        m = F.gelu(m, approximate="tanh")
    return _dense(m, p["mlp_out"])


def kv_bytes_per_token(cfg: GPTConfig, dtype=torch.bfloat16) -> int:
    """Bytes of K+V cache one token occupies across all layers."""
    return int(2 * cfg.n_layers * cfg.kv_heads * cfg.head_dim
               * dtype.itemsize)


def decode_geometry(cfg: GPTConfig, block_size: int,
                    max_seq_len: Optional[int] = None) -> Tuple[int, int]:
    """(blocks_per_slot, tokens_per_slot) of a block-paged cache: the
    per-request table covers the model's maximum sequence in whole
    blocks."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    s = max_seq_len or cfg.max_seq_len
    nb = -(-s // block_size)
    return nb, nb * block_size


def num_params(cfg: GPTConfig) -> int:
    d, L, ff, V = cfg.d_model, cfg.n_layers, cfg.ffn_dim, cfg.vocab_size
    nb = 1 if cfg.use_bias else 0
    n_norm = 2 if cfg.norm == "layernorm" else 1
    per_layer = (d * cfg.qkv_dim + nb * cfg.qkv_dim + d * d + nb * d
                 + 2 * d * ff + nb * (ff + d) + n_norm * 2 * d)
    if cfg.activation == "swiglu":
        per_layer += d * ff + nb * ff
    n = V * d + L * per_layer + n_norm * d
    if cfg.use_wpe:
        n += cfg.max_seq_len * d
    if not cfg.tie_embeddings:
        n += d * V
    return n

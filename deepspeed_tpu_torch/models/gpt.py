"""GPT-family decoder: configuration, parameters, the per-block pieces the
inference engine runs, and the training forward and loss.

Port of ``deepspeed_tpu/models/gpt.py``. Parameters keep the JAX package's
pytree layout as nested dicts of tensors: every layer's weights stacked on
a leading axis (``params["block"]["qkv"]["kernel"]`` is
``[L, d, qkv_dim]``), dense kernels ``[in, out]``, so a layer is a view
``t[l]`` and the parity tests compare like with like. The training side
(``forward``, ``loss_fn``) is differentiated by autograd; attention goes
through :func:`flash_attention`, whose backward is the dq and dk/dv
kernels, and the per-layer activation checkpointing keeps what the
``remat_policy`` names; progressive layer drop skips the layers it drops.
Sequence parallelism and the MoE block wait for their slices.
"""

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.ops.attention.flash import (flash_attention,
                                                     mha_reference)
from deepspeed_tpu_torch.ops.attention.rotary import apply_rotary
from deepspeed_tpu_torch.ops.cross_entropy import chunked_softmax_xent
from deepspeed_tpu_torch.ops.layers import (RematBlock, Tape, dense, dropout,
                                            layernorm, remat_keep)
from deepspeed_tpu_torch.tree import tree_leaves, tree_unflatten



@dataclass
class GPTConfig:
    """Model and training fields of the JAX package's ``GPTConfig``.

    ``remat`` checkpoints each layer; ``remat_policy`` says what a layer
    keeps between its forward and its backward: ``"full"`` the layer's
    input only, ``"flash_only"`` that and the flash ``o`` and ``lse`` (the
    backward does not rerun the forward kernel), ``"selective"`` (the
    default) those and the ``qkv`` and ``mlp_pre`` projections. With
    ``use_flash_attention=False`` attention is the plain version under
    autograd and there is no flash output to keep. ``"offload_flash"``
    waits for the memory-tier slice. The ``flash_block_*`` fields are the
    TPU kernels' tiling: accepted so that a JAX config carries over, and
    ignored (the CUDA kernels' tiles are fixed in their sources)."""
    vocab_size: int = 50304
    n_layers: int = 12
    n_heads: int = 12
    d_model: int = 768
    d_ff: Optional[int] = None         # default 4*d_model
    max_seq_len: int = 1024
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True                  # activation checkpointing per layer
    remat_policy: str = "selective"
    use_flash_attention: bool = True
    flash_block_q: int = 1024           # TPU tiling, ignored
    flash_block_kv: int = 1024
    flash_block_bwd_q: Optional[int] = None
    flash_block_bwd_kv: Optional[int] = None
    loss_chunk: int = 0                 # tokens per chunk of the fused loss
    sequence_parallel: bool = False     # waits for the multi-GPU slice
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


def _norm(x, p, cfg: GPTConfig):
    """GPT-2 layernorm or llama rmsnorm (scale only, no mean subtraction),
    statistics in fp32."""
    if cfg.norm == "rmsnorm":
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True)
                             + cfg.norm_eps)
        return (y * p["scale"].float()).to(x.dtype)
    return layernorm(x, p["scale"], p["bias"], eps=cfg.norm_eps)


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


def _mlp(h, p, cfg: GPTConfig, tape: Optional[Tape] = None):
    m = dense(h, p["mlp_in"], tape, "mlp_pre")
    if cfg.activation == "swiglu":
        m = F.silu(dense(h, p["mlp_gate"])) * m
    else:
        m = F.gelu(m, approximate="tanh")
    return dense(m, p["mlp_out"])


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

def _attention(q, k, v, cfg: GPTConfig, segment_ids=None, kv_mask=None,
               tape: Optional[Tape] = None):
    """Causal multi-head attention over [B, S, H, Dh] q, k, v.

    segment_ids: optional [B, S] ids of packed rows (attention stays inside
    each segment). kv_mask: optional [B, S] key validity (left-padded
    rows). With ``use_flash_attention`` a CUDA tensor goes through the
    flash kernels for every S (ragged S is masked in the kernel) and a CPU
    tensor through their plain versions; without it, through the plain
    attention under autograd."""
    if cfg.sequence_parallel:
        raise NotImplementedError(
            "sequence_parallel (ring / Ulysses attention) waits for the "
            "multi-GPU slice")
    kw = dict(causal=True, scale=cfg.attn_scale, kv_mask=kv_mask,
              window=cfg.attn_window, segment_ids=segment_ids)
    if not cfg.use_flash_attention:
        return mha_reference(q, k, v, **kw)[0]
    kept = tape is not None and "flash" in tape.keep
    known = (tape.saved["flash_o"], tape.saved["flash_lse"]) \
        if kept and tape.replay else None
    o, lse = flash_attention(q, k, v, known=known, **kw)
    if kept and not tape.replay:
        tape.saved["flash_o"], tape.saved["flash_lse"] = o, lse
    return o


def _block(x, p, cfg: GPTConfig, dropout_seeds=None, segment_ids=None,
           positions=None, tape: Optional[Tape] = None):
    """One transformer block over x [B, S, D]. positions: optional [B, S]
    per-row positions (packed rows restart per document). dropout_seeds:
    (attention, mlp) generator seeds, or None for no dropout."""
    B, S, D = x.shape
    h = _norm(x, p["ln1"], cfg)
    qkv = dense(h, p["qkv"], tape, "qkv")
    q, k, v = _qkv_split_rotary(qkv, cfg, positions, B, S)
    attn = _attention(q, k, v, cfg, segment_ids=segment_ids,
                      tape=tape).reshape(B, S, D)
    attn = dense(attn, p["attn_out"])
    if dropout_seeds is not None:
        attn = dropout(attn, cfg.dropout, dropout_seeds[0])
    # GPT-J style parallel residual: the MLP reads the same ln1 output and
    # both branches add to x
    if cfg.parallel_residual:
        mlp_src = h
    else:
        x = x + attn
        mlp_src = _norm(x, p["ln2"], cfg)
    m = _mlp(mlp_src, p, cfg, tape)
    if dropout_seeds is not None:
        m = dropout(m, cfg.dropout, dropout_seeds[1])
    if cfg.parallel_residual:
        return x + attn + m
    return x + m


def pld_keep(theta: float, n_layers: int, rng: torch.Generator
             ) -> List[bool]:
    """Which layers one progressive-layer-drop step keeps: layer ``l``
    with probability ``1 - (l / L) * (1 - theta)`` (the JAX package's
    rule, ``deepspeed_tpu/models/gpt.py forward``), one uniform draw per
    layer from ``rng``. Layer 0 is always kept."""
    u = torch.rand(n_layers, generator=rng, device=rng.device,
                   dtype=torch.float64).tolist()
    return [u[i] < 1.0 - (i / n_layers) * (1.0 - float(theta))
            for i in range(n_layers)]


def forward(params: Dict, tokens: torch.Tensor, cfg: GPTConfig,
            rng: Optional[torch.Generator] = None, deterministic: bool = True,
            pld_theta=None, hidden_only: bool = False, segment_ids=None,
            positions=None, layers_run: Optional[List[int]] = None
            ) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] in the compute dtype (or the
    post-``ln_f`` hidden states with ``hidden_only``).

    segment_ids / positions: [B, S] ids keep the attention of packed rows
    inside each document, [B, S] positions restart the positional encoding
    at each document's start. rng: the ``torch.Generator`` (on any device)
    that seeds the layers' dropout when ``deterministic`` is False and
    ``cfg.dropout > 0``, and draws the progressive-layer-drop decisions
    when ``pld_theta`` is given and ``deterministic`` is False
    (:func:`pld_keep`, after the dropout seeds and before the first layer,
    so a checkpointed layer's recompute never draws). A dropped layer is
    not computed: its input passes through, and its weights get zero
    gradients. Every layer's weights are one ``unbind`` of the stacked
    tree, so their gradients come back stacked. layers_run: a list to
    which the call appends the number of layers it computes."""
    B, S = tokens.shape
    dtype, L = cfg.dtype, cfg.n_layers
    wte = params["wte"]["embedding"].to(dtype)
    x = F.embedding(tokens, wte)
    if cfg.use_wpe:
        wpe = params["wpe"]["embedding"].to(dtype)
        x = x + (F.embedding(positions, wpe) if positions is not None
                 else wpe[:S][None])

    seeds = None
    if not deterministic and cfg.dropout > 0:
        if rng is None:
            raise ValueError("dropout needs a torch.Generator (rng)")
        seeds = torch.randint(0, 2 ** 62, (L, 2), generator=rng,
                              device=rng.device).tolist()
    kept = None
    if pld_theta is not None and not deterministic:
        if rng is None:
            raise ValueError("progressive layer drop needs a "
                             "torch.Generator (rng)")
        kept = pld_keep(pld_theta, L, rng)
    if layers_run is not None:
        layers_run.append(L if kept is None else sum(kept))
    block = params["block"]      # its structure is each layer's too
    per_layer = list(zip(*(t.unbind(0) for t in tree_leaves(block))))
    keep = remat_keep(cfg.remat_policy, cfg.use_flash_attention) \
        if cfg.remat else None
    for i in range(L):
        if kept is not None and not kept[i]:
            continue

        def run(x, p, tape, seed=None if seeds is None else seeds[i]):
            return _block(x, p, cfg, dropout_seeds=seed,
                          segment_ids=segment_ids, positions=positions,
                          tape=tape)
        if keep is None:
            x = run(x, tree_unflatten(block, per_layer[i]), None)
        else:
            x = RematBlock.apply(run, keep, block, x, *per_layer[i])

    x = _norm(x, params["ln_f"], cfg)
    if hidden_only:
        return x
    if cfg.tie_embeddings:
        return x @ wte.t()
    head = params["lm_head"]
    logits = x @ head["kernel"].to(dtype)
    if "bias" in head:
        logits = logits + head["bias"].to(dtype)
    return logits


def _vocab_proj(params: Dict, cfg: GPTConfig):
    """(w [V, H], bias [V] or None) of the vocabulary projection."""
    if cfg.tie_embeddings:
        return params["wte"]["embedding"].to(cfg.dtype), None
    head = params["lm_head"]
    b = head.get("bias")
    return (head["kernel"].to(cfg.dtype).t(),
            None if b is None else b.to(cfg.dtype))


def _masked_mean_nll(ll, loss_mask):
    if loss_mask is not None:
        return -(ll * loss_mask).sum() / loss_mask.sum().clamp_min(1.0)
    return -ll.mean()


def _head_nll(other: Dict, y: torch.Tensor, targets: torch.Tensor,
              cfg: GPTConfig, loss_mask=None) -> torch.Tensor:
    """Mean next-token NLL from post-``ln_f`` hidden states; honours
    ``cfg.loss_chunk`` and an optional [..., S] loss mask."""
    w, b = _vocab_proj(other, cfg)
    if cfg.loss_chunk:
        # fused vocabulary projection and loss: never holds [B, S, V]
        return chunked_softmax_xent(y, w, targets, bias=b,
                                    chunk=cfg.loss_chunk, loss_mask=loss_mask)
    logits = (y @ w.t()).float()
    if b is not None:
        logits = logits + b.float()
    logp = F.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, targets.long()[..., None]).squeeze(-1)
    return _masked_mean_nll(ll, loss_mask)


def loss_fn(params: Dict, batch: Dict, rng: Optional[torch.Generator],
            cfg: GPTConfig, deterministic: bool = False,
            layers_run: Optional[List[int]] = None) -> torch.Tensor:
    """Causal LM cross-entropy (fp32 scalar). batch: ``{"tokens": [B, S]}``
    (next-token pairs are sliced here) or ``{"tokens", "targets"}``.

    Packed batches add ``segment_ids`` / ``positions`` [B, S] and a
    ``loss_mask`` that zeroes each segment's last token, as
    :func:`deepspeed_tpu_torch.runtime.dataloader.pack_documents` emits.
    layers_run: as :func:`forward`'s."""
    tokens = batch["tokens"]
    targets = batch.get("targets")
    segs = batch.get("segment_ids")
    poss = batch.get("positions")
    if targets is None:
        targets = tokens[:, 1:]
        tokens = tokens[:, :-1]
        segs = None if segs is None else segs[:, :-1]
        poss = None if poss is None else poss[:, :-1]
    mask = batch.get("loss_mask")
    if mask is not None and mask.shape[-1] != targets.shape[-1]:
        raise ValueError(
            f"loss_mask width {mask.shape[-1]} != target width "
            f"{targets.shape[-1]}: a pack_documents batch keeps implicit "
            f"targets (no 'targets' key; loss_fn slices the next-token "
            f"pairs), so that mask, segments and targets stay aligned")
    x = forward(params, tokens, cfg, rng, deterministic=deterministic,
                pld_theta=batch.get("pld_theta"), hidden_only=True,
                segment_ids=segs, positions=poss, layers_run=layers_run)
    return _head_nll(params, x, targets, cfg, mask)


def make_loss_fn(cfg: GPTConfig):
    """Engine-contract loss: ``(params, batch, rng) -> loss``. Its
    ``flops_per_batch(batch, layers_run=None)`` is the analytic count the
    engine's flops profile uses (:func:`train_flops_per_batch`); while its
    ``layers_run`` attribute is a list, each call appends the number of
    layers it computed (fewer than ``n_layers`` under progressive layer
    drop)."""
    def _loss(params, batch, rng):
        return loss_fn(params, batch, rng, cfg, layers_run=_loss.layers_run)
    _loss.layers_run = None
    _loss.flops_per_batch = functools.partial(train_flops_per_batch, cfg)
    return _loss


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


def train_flops_per_token(cfg: GPTConfig, seq_len: int,
                          include_head: bool = True) -> float:
    """Model flops per token, forward and backward, in the Megatron-LM
    accounting: ``6 * N_matmul + attention``, where N_matmul counts every
    matmul parameter including the logit projection (with tied embeddings
    the ``d * V`` head product is real compute though the weight is
    shared with ``wte``)."""
    N = num_params(cfg) - cfg.vocab_size * cfg.d_model  # drop the wte lookup
    if cfg.tie_embeddings and include_head:
        N += cfg.d_model * cfg.vocab_size
    attn = 12 * cfg.n_layers * cfg.d_model * seq_len
    return 6.0 * N + attn


def train_flops_per_batch(cfg: GPTConfig, batch: Dict,
                          layers_run: Optional[List[int]] = None) -> float:
    """:func:`train_flops_per_token` times the batch's tokens, at the
    sequence length :func:`loss_fn` runs (the tokens less the one that is
    only a target, unless the batch carries ``targets``). layers_run: the
    layers that each of the step's micro batches (equal shares of the
    batch) computed, as :func:`forward` records them; without it every
    layer is counted."""
    B, width = batch["tokens"].shape
    S = width if "targets" in batch else width - 1
    if not layers_run:
        return train_flops_per_token(cfg, S) * B * S
    tokens_per_micro = B * S / len(layers_run)
    return sum(train_flops_per_token(dataclasses.replace(cfg, n_layers=n), S)
               for n in layers_run) * tokens_per_micro

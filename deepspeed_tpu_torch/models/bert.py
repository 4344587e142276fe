"""BERT: masked-language-model (+ next-sentence) pretraining and the SQuAD
span head.

Port of ``deepspeed_tpu/models/bert.py``. Parameters keep the JAX
package's pytree as nested dicts of tensors: the encoder layers stacked
on a leading axis under ``"block"`` (``params["block"]["qkv"]["kernel"]``
is ``[L, d, 3d]``), dense kernels ``[in, out]``, the MLM decoder tied to
the word embedding. Each layer is :func:`ops.transformer.encoder_layer.
layer_forward`; with ``remat`` it is checkpointed by
``ops.layers.RematBlock``, as GPT's layers are, keeping what the policy
names.
Tensor-parallel partition rules wait for the multi-GPU slice.
"""

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.ops.cross_entropy import chunked_softmax_xent
from deepspeed_tpu_torch.ops.layers import (RematBlock, dense, layernorm,
                                            remat_keep)
from deepspeed_tpu_torch.ops.transformer.encoder_layer import (
    DeepSpeedTransformerConfig, flash_gate, init_layer_params, layer_forward)
from deepspeed_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclass
class BertConfig:
    vocab_size: int = 30522
    n_layers: int = 12
    n_heads: int = 12
    d_model: int = 768
    max_seq_len: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    pre_layer_norm: bool = True
    dtype: torch.dtype = torch.bfloat16
    # per-layer activation checkpointing; pretraining batch sizes need it
    remat: bool = False
    remat_policy: str = "selective"   # see ops.layers.remat_keep
    # fused chunked MLM cross-entropy (0 = dense log_softmax): at seq 512 x
    # batch 32 the dense path holds a 2 GB fp32 [B, S, V] logits tensor
    loss_chunk: int = 0

    @property
    def layer_config(self) -> DeepSpeedTransformerConfig:
        return DeepSpeedTransformerConfig(
            hidden_size=self.d_model, heads=self.n_heads,
            attn_dropout_ratio=self.dropout,
            hidden_dropout_ratio=self.dropout,
            num_hidden_layers=self.n_layers,
            layer_norm_eps=self.layer_norm_eps,
            pre_layer_norm=self.pre_layer_norm)


PRESETS = {
    "bert-base": dict(n_layers=12, n_heads=12, d_model=768),
    "bert-large": dict(n_layers=24, n_heads=16, d_model=1024),
    "bert-tiny": dict(n_layers=2, n_heads=2, d_model=128),
}


def preset(name: str, **overrides) -> BertConfig:
    return BertConfig(**{**PRESETS[name], **overrides})


def init_params(cfg: BertConfig, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32) -> Dict:
    """Random parameters with the JAX package's shapes and init scales
    (normal(0.02) weights, zero biases, unit layernorm scales), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``. The values
    differ from JAX's: tests hand both packages the same numpy parameters
    through :func:`deepspeed_tpu_torch.models.convert.params_from_numpy`."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    d = cfg.d_model

    def normal(shape):
        return (torch.randn(shape, generator=gen, device=device)
                * 0.02).to(dtype)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    def ln():
        return {"scale": const((d,), 1.0), "bias": const((d,), 0.0)}

    layers = [init_layer_params(gen, cfg.layer_config, dtype)
              for _ in range(cfg.n_layers)]
    block = {name: {k: torch.stack([lay[name][k] for lay in layers])
                    for k in layers[0][name]} for name in layers[0]}
    del layers
    return {
        "embeddings": {
            "word": normal((cfg.vocab_size, d)),
            "position": normal((cfg.max_seq_len, d)),
            "token_type": normal((cfg.type_vocab_size, d)),
            "ln": ln(),
        },
        "block": block,
        "pooler": {"kernel": normal((d, d)), "bias": const((d,), 0.0)},
        "mlm": {  # transform + tied-embedding decoder bias
            "kernel": normal((d, d)), "bias": const((d,), 0.0), "ln": ln(),
            "decoder_bias": const((cfg.vocab_size,), 0.0),
        },
        "nsp": {"kernel": normal((d, 2)), "bias": const((2,), 0.0)},
    }


def encode(params: Dict, tokens: torch.Tensor, cfg: BertConfig,
           token_type_ids: Optional[torch.Tensor] = None,
           attention_mask: Optional[torch.Tensor] = None,
           rng: Optional[torch.Generator] = None,
           deterministic: bool = True) -> torch.Tensor:
    """tokens [B, S] -> hidden states [B, S, d] in the compute dtype.
    attention_mask [B, S]: 1 = token, 0 = padding. rng: the
    ``torch.Generator`` that seeds each layer's dropout when
    ``deterministic`` is False and ``cfg.dropout > 0``."""
    B, S = tokens.shape
    dtype, L = cfg.dtype, cfg.n_layers
    emb = params["embeddings"]
    x = F.embedding(tokens, emb["word"].to(dtype)) \
        + emb["position"].to(dtype)[:S][None]
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(tokens)
    x = x + F.embedding(token_type_ids, emb["token_type"].to(dtype))
    x = layernorm(x, emb["ln"]["scale"].to(dtype),
                  emb["ln"]["bias"].to(dtype), cfg.layer_norm_eps)

    lcfg = cfg.layer_config
    seeds = None
    if not deterministic and cfg.dropout > 0:
        if rng is None:
            raise ValueError("training mode (deterministic=False) needs a "
                             "torch.Generator (rng) for dropout")
        seeds = torch.randint(0, 2 ** 62, (L,), generator=rng,
                              device=rng.device).tolist()
    keep = None
    if cfg.remat:
        # the flash flag mirrors the attention core's gate, on the card,
        # so that the selective policy keeps the flash output when the
        # layer runs the kernels
        flash_used = tokens.device.type == "cuda" and flash_gate(
            lcfg, S, deterministic or cfg.dropout == 0.0)
        keep = remat_keep(cfg.remat_policy, flash_used)
    block = params["block"]
    per_layer = list(zip(*(t.unbind(0) for t in tree_leaves(block))))
    for i in range(L):
        def run(x, p, tape, seed=None if seeds is None else seeds[i]):
            return layer_forward(p, x, lcfg, attn_mask=attention_mask,
                                 rng=seed, deterministic=deterministic,
                                 tape=tape)
        if keep is None:
            x = run(x, tree_unflatten(block, per_layer[i]), None)
        else:
            x = RematBlock.apply(run, keep, block, x, *per_layer[i])
    return x


def _cast(tree: Dict, dtype: torch.dtype) -> Dict:
    """A head's parameters in the compute dtype of its input."""
    return tree_map(lambda t: t.to(dtype), tree)


def _mlm_hidden(params: Dict, x: torch.Tensor, cfg: BertConfig):
    """MLM head transform: encoder states -> pre-decode hidden [B, S, d]."""
    mlm = _cast(params["mlm"], x.dtype)
    h = F.gelu(dense(x, mlm), approximate="tanh")
    return layernorm(h, mlm["ln"]["scale"], mlm["ln"]["bias"],
                     cfg.layer_norm_eps)


def _nsp_logits(params: Dict, x: torch.Tensor):
    pooled = torch.tanh(dense(x[:, 0], _cast(params["pooler"], x.dtype)))
    return dense(pooled, _cast(params["nsp"], x.dtype))


def forward(params: Dict, tokens: torch.Tensor, cfg: BertConfig,
            token_type_ids=None, attention_mask=None,
            rng: Optional[torch.Generator] = None,
            deterministic: bool = True):
    """Returns (mlm_logits [B, S, V], nsp_logits [B, 2])."""
    x = encode(params, tokens, cfg, token_type_ids, attention_mask, rng,
               deterministic)
    h = _mlm_hidden(params, x, cfg)
    mlm_logits = h @ params["embeddings"]["word"].to(x.dtype).t() \
        + params["mlm"]["decoder_bias"].to(x.dtype)
    return mlm_logits, _nsp_logits(params, x)


def loss_fn(params: Dict, batch: Dict, rng: Optional[torch.Generator],
            cfg: BertConfig, deterministic: bool = False) -> torch.Tensor:
    """MLM (+ optional NSP) loss, an fp32 scalar. batch: tokens [B, S];
    mlm_labels [B, S] with -1 = not masked; optional token_type_ids,
    attention_mask, nsp_labels [B]."""
    labels = batch["mlm_labels"]
    mask = (labels >= 0).float()
    targets = labels.clamp_min(0).long()
    if cfg.loss_chunk:
        x = encode(params, batch["tokens"], cfg,
                   batch.get("token_type_ids"), batch.get("attention_mask"),
                   rng, deterministic)
        h = _mlm_hidden(params, x, cfg)
        loss = chunked_softmax_xent(
            h, params["embeddings"]["word"].to(h.dtype), targets,
            bias=params["mlm"]["decoder_bias"].to(h.dtype),
            chunk=cfg.loss_chunk, loss_mask=mask)
        nsp_logits = _nsp_logits(params, x)
    else:
        mlm_logits, nsp_logits = forward(
            params, batch["tokens"], cfg,
            token_type_ids=batch.get("token_type_ids"),
            attention_mask=batch.get("attention_mask"),
            rng=rng, deterministic=deterministic)
        logp = F.log_softmax(mlm_logits.float(), dim=-1)
        picked = logp.gather(-1, targets[..., None]).squeeze(-1)
        loss = -(picked * mask).sum() / mask.sum().clamp_min(1.0)
    if "nsp_labels" in batch:
        nsp_logp = F.log_softmax(nsp_logits.float(), dim=-1)
        loss = loss - nsp_logp.gather(
            -1, batch["nsp_labels"].long()[:, None]).mean()
    return loss


def make_loss_fn(cfg: BertConfig):
    """Engine-contract loss: ``(params, batch, rng) -> loss``."""
    def _loss(params, batch, rng):
        return loss_fn(params, batch, rng, cfg)
    return _loss


# ---------------------------------------------------------------------------
# SQuAD fine-tuning head: a start/end span classifier on the encoder
# ---------------------------------------------------------------------------

def init_squad_head(cfg: BertConfig, seed: int = 0, device=None,
                    dtype: torch.dtype = torch.float32) -> Dict:
    """Span-prediction head parameters: add under ``params["qa"]``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return {"kernel": (torch.randn((cfg.d_model, 2), generator=gen,
                                   device=device) * 0.02).to(dtype),
            "bias": torch.zeros((2,), dtype=dtype, device=device)}


def squad_logits(params: Dict, tokens: torch.Tensor, cfg: BertConfig,
                 token_type_ids=None, attention_mask=None,
                 rng: Optional[torch.Generator] = None,
                 deterministic: bool = True):
    """-> (start_logits [B, S], end_logits [B, S]) fp32."""
    x = encode(params, tokens, cfg, token_type_ids, attention_mask, rng,
               deterministic)
    logits = dense(x, _cast(params["qa"], x.dtype)).float()
    return logits[..., 0], logits[..., 1]


def squad_loss_fn(params: Dict, batch: Dict, rng: Optional[torch.Generator],
                  cfg: BertConfig, deterministic: bool = False):
    """Mean of the start/end-position cross-entropies. batch: tokens
    [B, S], start_positions [B], end_positions [B], optional
    token_type_ids / attention_mask. Positions outside [0, S) (an
    unanswerable example marked with S, or -1) are left out of the loss."""
    s_logits, e_logits = squad_logits(
        params, batch["tokens"], cfg, batch.get("token_type_ids"),
        batch.get("attention_mask"), rng, deterministic)
    S = s_logits.shape[1]

    def xent(logits, pos):
        valid = ((pos >= 0) & (pos < S)).float()
        logp = F.log_softmax(logits, dim=-1)
        picked = logp.gather(-1, pos.clamp(0, S - 1).long()[:, None])[:, 0]
        return -(picked * valid).sum() / valid.sum().clamp_min(1.0)

    return 0.5 * (xent(s_logits, batch["start_positions"])
                  + xent(e_logits, batch["end_positions"]))


def make_squad_loss_fn(cfg: BertConfig):
    def _loss(params, batch, rng):
        return squad_loss_fn(params, batch, rng, cfg)
    return _loss


def num_params(cfg: BertConfig) -> int:
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    per_layer = 12 * d * d + 13 * d
    emb = (V + cfg.max_seq_len + cfg.type_vocab_size) * d + 2 * d
    heads = 2 * d * d + 6 * d + V + 2  # pooler + mlm transform/ln + nsp
    return L * per_layer + emb + heads


def train_flops_per_sample(cfg: BertConfig, seq: int) -> float:
    """Megatron-style forward + backward matmul flops of one MLM sample at
    ``seq`` tokens (the JAX package's ``tools/bert_bench.py``
    ``flops_per_sample``)."""
    d, L, ff, V = cfg.d_model, cfg.n_layers, 4 * cfg.d_model, cfg.vocab_size
    per_layer = 4 * d * d + 2 * d * ff          # qkv+proj + mlp
    attn = 2 * L * d * seq                      # scores + weighted sum
    head = d * V + d * d                        # mlm decoder + transform
    return 6.0 * seq * (L * per_layer + head) + 6.0 * seq * attn

"""Inference engine: static KV-cache generation and the paged slot
programs the serving scheduler drives.

Port of ``deepspeed_tpu/inference/engine.py`` for one device:

- the static path (``_prefill_fn``, ``_decode_fn``, ``generate``): the
  prompt runs once through ``_block_prefill``, whose attention is the
  flash-attention kernel (``ops/attention/flash.py``, kernel K1-fwd),
  into a ``[L, B, S_max, Hkv, Dh]`` cache; each new token runs through
  ``_block_decode`` over that cache;
- the paged path (``prefill_into_slot``, ``decode_slots``): prompt chunks
  go through ``_block_prefill_paged`` (plain gather attention, as in JAX)
  and every decoding slot advances one token per step through
  ``_block_decode_paged``, whose attention is the paged flash-decode
  kernel (``ops/attention/paged.py``, kernel K3). With int8 pools
  (``k_scale``/``v_scale`` given) each write is a read-modify-requantize
  of the blocks it touches and K3 runs in its int8-pool mode.

``dtype=torch.int8`` serves weight-only int8 (``quantize_weights_int8``):
every block projection runs the int8 dequant-matmul kernel
(``ops/int8_matmul.py``, K4) on bfloat16 activations on the card (float32
on the host), and the untied ``lm_head`` is dequantized and multiplied.

PyTorch runs eagerly, so there is no jit-twin family and no compiled
program cache. The caches and pools are updated in place (the JAX
programs donate them instead); the paged methods return the pools they
were given so the call sites read like JAX's. ``checkpoint=`` takes the
parameters of a training checkpoint (``runtime/checkpointing.py``).
Tensor parallelism, MoE blocks and encoder inference raise
``NotImplementedError`` naming the slice they wait for.
"""

import math
from typing import Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.inference import sampling
from deepspeed_tpu_torch.models.gpt import (GPTConfig, _mlp, _norm,
                                            _qkv_split_rotary, layer)
from deepspeed_tpu_torch.ops.attention.flash import flash_attention
from deepspeed_tpu_torch.ops.attention.paged import paged_decode_attention
from deepspeed_tpu_torch.ops.attention.rotary import apply_rotary
from deepspeed_tpu_torch.ops.layers import dense, kernel_of
from deepspeed_tpu_torch.ops.quantizer import (kv_dequantize_blocks,
                                               kv_requantize_blocks)

NEG_INF = -1e30


def quantize_weights_int8(params: Dict) -> Dict:
    """Weight-only int8, as ``deepspeed_tpu/inference/engine.py
    quantize_weights_int8``: every ``kernel`` of ndim >= 2 under ``block``
    and ``lm_head`` becomes ``{"q": int8, "scale": fp32 [..., 1, out]}``
    with ``scale = absmax over the input axis / 127 + 1e-12`` and ``q =
    round(w / scale)`` (half to even, clipped to +-127); embeddings, norms
    and biases stay float. A stacked ``[L, in, out]`` kernel is quantized
    one layer at a time (the same bits as the whole stack at once, without
    its fp32 temporaries)."""
    def quant(w):
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        scale = torch.empty(w.shape[:-2] + (1, w.shape[-1]),
                            dtype=torch.float32, device=w.device)
        ws, qs = w.reshape(-1, *w.shape[-2:]), q.view(-1, *w.shape[-2:])
        ss = scale.view(-1, 1, w.shape[-1])
        for i in range(ws.shape[0]):
            a = ws[i].abs().amax(dim=-2, keepdim=True)
            ss[i] = a.float() / 127.0 + 1e-12
            qs[i] = torch.round(ws[i] / ss[i]).clamp_(-127, 127).to(torch.int8)
        return {"q": q, "scale": scale}

    def walk(tree):
        if "kernel" in tree and tree["kernel"].dim() >= 2:
            out = {k: v for k, v in tree.items() if k != "kernel"}
            out.update(quant(tree["kernel"]))
            return out
        return {k: walk(v) if isinstance(v, dict) else v
                for k, v in tree.items()}

    out = dict(params)
    for key in ("block", "lm_head"):
        if key in out:
            out[key] = walk(out[key])
    return out


def _scale(cfg: GPTConfig) -> float:
    return cfg.attn_scale if cfg.attn_scale is not None \
        else 1.0 / math.sqrt(cfg.head_dim)


def _residual(x, attn, h, p, cfg: GPTConfig):
    """Add the attention branch and the MLP: GPT-J parallel residual
    (MLP reads the same ln1 output) or the sequential GPT-2/llama one."""
    if cfg.parallel_residual:
        return x + attn + _mlp(h, p, cfg)
    x = x + attn
    return x + _mlp(_norm(x, p["ln2"], cfg), p, cfg)


def _block_prefill(x, p, cfg: GPTConfig, kv_mask=None, positions=None):
    """One block over the whole prompt, returning (y, k, v); k/v are
    post-rotary so decode never rotates history again. kv_mask: [B, S]
    prompt validity (left-padded prompts); positions: [B, S] rotary
    positions."""
    B, S, D = x.shape
    h = _norm(x, p["ln1"], cfg)
    q, k, v = _qkv_split_rotary(dense(h, p["qkv"]), cfg, positions, B, S)
    attn, _ = flash_attention(q, k, v, causal=True, scale=cfg.attn_scale,
                              kv_mask=kv_mask, window=cfg.attn_window)
    attn = dense(attn.reshape(B, S, D), p["attn_out"])
    return _residual(x, attn, h, p, cfg), k, v


def _block_decode(x, k_cache, v_cache, pos: int, p, cfg: GPTConfig,
                  cache_mask=None, row_pos=None):
    """One block for one new token over the static cache. x: [B, 1, D];
    caches [B, S_max, Hkv, Dh], written in place at ``pos``. cache_mask:
    [B, S_max] validity (0 = left padding); row_pos: [B] logical
    positions for rotary."""
    B, _, D = x.shape
    H, Dh, Hkv = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    S_max = k_cache.shape[1]
    h = _norm(x, p["ln1"], cfg)
    if row_pos is None:
        positions = torch.tensor([pos], device=x.device)
    else:
        positions = row_pos[:, None]
    q, k, v = _qkv_split_rotary(dense(h, p["qkv"]), cfg, positions, B, 1)
    q = q.reshape(B, Hkv, H // Hkv, Dh)
    k_cache[:, pos] = k[:, 0]
    v_cache[:, pos] = v[:, 0]
    scores = torch.einsum("bkgd,bskd->bkgs", q, k_cache).float() * _scale(cfg)
    idx = torch.arange(S_max, device=x.device)
    scores = torch.where(idx <= pos, scores, NEG_INF)
    if cfg.attn_window is not None:
        scores = torch.where(idx > pos - cfg.attn_window, scores, NEG_INF)
    if cache_mask is not None:
        scores = torch.where(cache_mask[:, None, None, :] > 0, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    attn = torch.einsum("bkgs,bskd->bkgd", probs, v_cache).reshape(B, 1, D)
    return _residual(x, dense(attn, p["attn_out"]), h, p, cfg)


def _decode_requant(pool, scale_pool, blk, off, new):
    """Write one token per slot into int8 blocks: dequantize block
    ``blk[b]``, put ``new[b]`` at lane ``off[b]``, zero the lanes past it
    (a previous owner's values) and requantize; pool and scales are
    updated in place."""
    rows = torch.arange(blk.shape[0], device=blk.device)
    xb = kv_dequantize_blocks(pool[blk], scale_pool[blk])
    xb[rows, off] = new.float()
    live = torch.arange(pool.shape[1], device=blk.device)[None] <= off[:, None]
    pool[blk], scale_pool[blk] = kv_requantize_blocks(xb, live)


def _prefill_requant(pool, scale_pool, table_row, positions, valid, n_valid,
                     new, dtype):
    """Write a prompt chunk into one slot's int8 blocks, as JAX's
    ``_block_prefill_paged``: dequantize the slot's whole row, insert the
    valid lanes, zero the lanes past the new end, requantize, and write
    back only the blocks the chunk touched (the rest keep their bytes).
    Returns the row as the pool now holds it, dequantized to ``dtype``
    [NB * bs, Hkv, Dh]."""
    NB, bs = table_row.shape[0], pool.shape[1]
    cap = NB * bs
    old_q, old_s = pool[table_row], scale_pool[table_row]
    xb = kv_dequantize_blocks(old_q, old_s)
    flat = torch.cat([xb.reshape(cap, *xb.shape[2:]),
                      xb.new_zeros((1,) + xb.shape[2:])])
    # lanes that are padding or past the table land in the dropped row
    flat[torch.where(valid & (positions < cap), positions, cap)] = new.float()
    xb = flat[:cap].reshape(xb.shape)
    start = positions[0]
    glob = torch.arange(cap, device=positions.device).reshape(NB, bs)
    q, s = kv_requantize_blocks(xb, glob < start + n_valid)
    j = torch.arange(NB, device=positions.device)
    last = torch.maximum(start + n_valid - 1, start) // bs
    touched = (j >= start // bs) & (j <= last)
    q = torch.where(touched[:, None, None, None], q, old_q)
    s = torch.where(touched[:, None], s, old_s)
    pool[table_row], scale_pool[table_row] = q, s
    return kv_dequantize_blocks(q, s, dtype=dtype).reshape(cap, *q.shape[2:])


def _block_decode_paged(x, k_pool, v_pool, tables, lengths, active, p,
                        cfg: GPTConfig, k_scale=None, v_scale=None):
    """One block for one new token per slot, K/V addressed through block
    tables. x: [B, 1, D]; pools [N, block, Hkv, Dh] (one layer's view,
    written in place); tables [B, NB] int32; lengths [B] int32 per-slot
    cache positions; active [B] bool (inactive slots write to the trash
    block and their logits are ignored). ``k_scale``/``v_scale`` [N, Hkv]
    fp32: the pools are int8 and the write is a read-modify-requantize of
    each slot's current block."""
    B, _, D = x.shape
    H, Dh, Hkv = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    bs, NB = k_pool.shape[1], tables.shape[1]
    pos = lengths.long()
    h = _norm(x, p["ln1"], cfg)
    qkv = dense(h, p["qkv"])
    q, k, v = torch.split(qkv, [H * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
    if cfg.rotary_dim:
        q, k = apply_rotary(q.reshape(B, 1, H, Dh), k.reshape(B, 1, Hkv, Dh),
                            pos[:, None], cfg.rotary_dim, base=cfg.rope_theta)
    q = q.reshape(B, Hkv, H // Hkv, Dh)
    # a slot at its block budget (lengths == NB*bs) would clamp into its
    # last live block: route its write, and inactive slots', to trash
    in_cap = pos < NB * bs
    blk = torch.gather(tables, 1, (pos // bs).clamp(0, NB - 1)[:, None])[:, 0]
    blk = torch.where(active & in_cap, blk, 0).long()
    if k_scale is None:
        k_pool[blk, pos % bs] = k.reshape(B, Hkv, Dh)
        v_pool[blk, pos % bs] = v.reshape(B, Hkv, Dh)
    else:
        _decode_requant(k_pool, k_scale, blk, pos % bs, k.reshape(B, Hkv, Dh))
        _decode_requant(v_pool, v_scale, blk, pos % bs, v.reshape(B, Hkv, Dh))
    attn = paged_decode_attention(q, k_pool, v_pool, tables, lengths,
                                  scale=_scale(cfg), window=cfg.attn_window,
                                  k_scale=k_scale, v_scale=v_scale)
    attn = dense(attn.reshape(B, 1, D), p["attn_out"])
    return _residual(x, attn, h, p, cfg)


def _block_prefill_paged(x, k_pool, v_pool, table_row, positions, n_valid,
                         p, cfg: GPTConfig, k_scale=None, v_scale=None):
    """One block over a prompt chunk of one slot: write the chunk's K/V
    through the slot's table, then attend over the slot's whole cache so
    far. x: [1, C, D]; positions: [C] cache positions of the chunk; only
    the first ``n_valid`` lanes are real (padding writes to trash, or is
    dropped with int8 pools). ``k_scale``/``v_scale`` [N, Hkv] fp32: the
    pools are int8 (:func:`_prefill_requant`)."""
    B, C, D = x.shape
    H, Dh, Hkv = cfg.n_heads, cfg.head_dim, cfg.kv_heads
    bs, NB = k_pool.shape[1], table_row.shape[0]
    h = _norm(x, p["ln1"], cfg)
    q, k, v = _qkv_split_rotary(dense(h, p["qkv"]), cfg, positions[None],
                                B, C)
    valid = torch.arange(C, device=x.device) < n_valid
    if k_scale is None:
        blk = torch.where(valid,
                          table_row[(positions // bs).clamp(0, NB - 1)], 0)
        k_pool[blk, positions % bs] = k[0]
        v_pool[blk, positions % bs] = v[0]
        kc = k_pool[table_row].reshape(NB * bs, Hkv, Dh)
        vc = v_pool[table_row].reshape(NB * bs, Hkv, Dh)
    else:
        kc = _prefill_requant(k_pool, k_scale, table_row, positions, valid,
                              n_valid, k[0], x.dtype)
        vc = _prefill_requant(v_pool, v_scale, table_row, positions, valid,
                              n_valid, v[0], x.dtype)
    qg = q[0].reshape(C, Hkv, H // Hkv, Dh)
    scores = torch.einsum("ckgd,skd->ckgs", qg, kc).float() * _scale(cfg)
    sidx = torch.arange(NB * bs, device=x.device)
    qpos = positions[:, None, None, None]
    scores = torch.where(sidx <= qpos, scores, NEG_INF)
    if cfg.attn_window is not None:
        scores = torch.where(sidx > qpos - cfg.attn_window, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    attn = torch.einsum("ckgs,skd->ckgd", probs, vc).reshape(1, C, D)
    return _residual(x, dense(attn, p["attn_out"]), h, p, cfg)


class InferenceEngine:
    """Generation engine over a GPT-layout parameter tree on one device.

    Construct through ``deepspeed_tpu_torch.init_inference(model=(cfg,
    params))``. ``device=None`` means the CUDA card; the tests pass
    ``device="cpu"``, where every kernel is replaced by its plain
    version. ``replace_with_kernel_inject`` is taken at any value for the
    JAX engine's API and changes nothing: the port's model code always
    runs its kernels on the card. ``decode_impl`` must stay None (the port
    has no implementation switch: it dispatches by device)."""

    def __init__(self, model=None, *, config: Optional[GPTConfig] = None,
                 params: Optional[Dict] = None, mp_size: int = 1,
                 dtype: torch.dtype = torch.bfloat16,
                 max_seq_len: Optional[int] = None, device=None,
                 replace_with_kernel_inject: bool = True,
                 checkpoint: Optional[str] = None,
                 decode_impl: Optional[str] = None):
        if model is not None:
            if not (isinstance(model, tuple) and len(model) == 2):
                raise NotImplementedError(
                    "converting a foreign model through a policy waits for "
                    "the policy slice; pass model=(GPTConfig, params)")
            config, params = model
        if decode_impl is not None:
            raise ValueError(
                f"decode_impl={decode_impl!r}: the port dispatches by device "
                f"(each kernel on the card, its plain version on the host) "
                f"and has no implementation switch; leave decode_impl at "
                f"None")
        if checkpoint is not None:
            # a training checkpoint's weights override whatever the model
            # supplied, as in the JAX engine
            from deepspeed_tpu_torch.runtime.checkpointing import \
                load_fp32_state_dict_from_zero_checkpoint
            params = load_fp32_state_dict_from_zero_checkpoint(checkpoint)
        if config is None or params is None:
            raise ValueError("need a model: pass (GPTConfig, params), or "
                             "config=GPTConfig with checkpoint= (which "
                             "supplies the weights only)")
        if not isinstance(config, GPTConfig):
            raise NotImplementedError(
                f"{type(config).__name__}: encoder inference (the JAX "
                f"engine's encoder forward) waits for a later serving "
                f"slice; this engine serves GPT/llama decoders (BERT "
                f"trains through initialize)")
        if mp_size != 1:
            raise NotImplementedError(
                "mp_size > 1 (tensor parallelism) waits for the multi-GPU "
                "slice")
        if "moe" in params.get("block", {}):
            raise NotImplementedError("MoE blocks wait for the MoE slice")
        self.device = resolve_device(device)
        # dtype=int8 is weight-only int8: the float leaves are cast to the
        # compute dtype (bf16 on the card, fp32 on the host, as JAX's bf16
        # on a TPU and f32 elsewhere), then the kernels are quantized
        self.quantized = dtype == torch.int8
        if self.quantized:
            dtype = torch.bfloat16 if self.device.type == "cuda" \
                else torch.float32
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"engine dtype must be float32, bfloat16 or "
                             f"int8 (weight-only), got {dtype}")
        self.cfg = config
        self.dtype = dtype
        self.max_seq_len = max_seq_len or config.max_seq_len

        def cast(tree, keep=False):
            if isinstance(tree, dict):   # an int8 entry's scales stay fp32
                return {k: cast(v, k == "scale" and "q" in tree)
                        for k, v in tree.items()}
            t = torch.as_tensor(tree)
            return t.to(self.device, dtype if t.is_floating_point()
                        and not keep else t.dtype)
        self.params = cast(params)
        if self.quantized:
            self.params = quantize_weights_int8(self.params)
        self.layers = [layer(self.params, i) for i in range(config.n_layers)]

    # ------------------------------------------------------------------
    def _tensor(self, a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _embed(self, tokens, positions=None):
        """Token (+ learned position) embeddings; positions default to
        arange(S)."""
        x = self.params["wte"]["embedding"][tokens]
        if self.cfg.use_wpe:
            wpe = self.params["wpe"]["embedding"]
            x = x + (wpe[:tokens.shape[1]][None] if positions is None
                     else wpe[positions])
        return x

    def _logits(self, x):
        x = _norm(x, self.params["ln_f"], self.cfg)
        if self.cfg.tie_embeddings:
            return x @ self.params["wte"]["embedding"].T
        head = self.params["lm_head"]
        logits = x @ kernel_of(head, x.dtype)
        return logits + head["bias"] if "bias" in head else logits

    # -- static path -----------------------------------------------------
    @torch.inference_mode()
    def _prefill_fn(self, tokens, attn_mask=None):
        """Run the prompt, build the static cache, return last-position
        logits [B, 1, V] and the cache. attn_mask: [B, S] validity of
        LEFT-padded prompts (1 = real token); positions restart per row
        and padded keys never receive attention."""
        cfg = self.cfg
        B, S = tokens.shape
        positions = None
        if attn_mask is not None:
            positions = (torch.cumsum(attn_mask.to(torch.int64), dim=1)
                         - 1).clamp(min=0)
        x = self._embed(tokens, positions)
        shape = (cfg.n_layers, B, self.max_seq_len, cfg.kv_heads, cfg.head_dim)
        cache = {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=self.dtype, device=self.device)}
        for i, lp in enumerate(self.layers):
            x, k, v = _block_prefill(x, lp, cfg, kv_mask=attn_mask,
                                     positions=positions)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
        if attn_mask is not None:
            # decode slots (>= S) are always valid once written
            cache["mask"] = torch.cat(
                [attn_mask.float(),
                 torch.ones(B, self.max_seq_len - S, device=self.device)], 1)
        return self._logits(x[:, -1:]), cache

    @torch.inference_mode()
    def _decode_fn(self, cache, token, pos: int, row_pos=None):
        """One token step over the static cache. token: [B, 1]; pos: the
        cache index; row_pos: [B] logical positions of left-padded rows."""
        x = self.params["wte"]["embedding"][token]
        if self.cfg.use_wpe:
            wpe = self.params["wpe"]["embedding"]
            x = x + (wpe[row_pos][:, None] if row_pos is not None
                     else wpe[pos:pos + 1][None])
        for i, lp in enumerate(self.layers):
            x = _block_decode(x, cache["k"][i], cache["v"][i], pos, lp,
                              self.cfg, cache_mask=cache.get("mask"),
                              row_pos=row_pos)
        return self._logits(x), cache

    def _sample(self, logits, temperature: float, top_k: int, seed: int,
                step: int):
        logits = logits[:, -1].float()
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        z = logits / temperature
        if top_k > 0:
            kth = torch.topk(z, min(top_k, z.shape[-1]), dim=-1)[0][:, -1:]
            z = torch.where(z < kth, NEG_INF, z)
        noise = sampling.gumbel_noise(seed, step, tuple(z.shape))
        return torch.argmax(z + noise.to(z.device), dim=-1)

    @torch.inference_mode()
    def generate(self, tokens, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 attention_mask=None) -> np.ndarray:
        """Greedy (temperature=0) or sampled generation; returns the
        prompt followed by the new tokens, [B, S + max_new_tokens] int32.

        attention_mask: [B, S] for LEFT-padded prompts of different
        lengths (1 = real token): rows generate as if run unpadded.
        Sampled draws come from this package's generator, not JAX's."""
        tokens = self._tensor(tokens, torch.int64)
        B, S = tokens.shape
        if S + max_new_tokens > self.max_seq_len:
            raise ValueError(f"prompt {S} + {max_new_tokens} new tokens "
                             f"exceed max_seq_len {self.max_seq_len}")
        mask = row_len = None
        if attention_mask is not None:
            mask = self._tensor(attention_mask, torch.float32)
            if tuple(mask.shape) != (B, S):
                raise ValueError(f"attention_mask must be {(B, S)}")
            row_len = mask.sum(dim=1).to(torch.int64)
        logits, cache = self._prefill_fn(tokens, mask)
        token = self._sample(logits, temperature, top_k, seed, 0)
        out = [token]
        for i in range(max_new_tokens - 1):
            logits, cache = self._decode_fn(
                cache, token[:, None], S + i,
                None if row_len is None else row_len + i)
            token = self._sample(logits, temperature, top_k, seed, i + 1)
            out.append(token)
        new = torch.stack(out, dim=1).cpu().numpy()
        return np.concatenate([tokens.cpu().numpy(), new],
                              axis=1).astype(np.int32)

    # -- paged slot programs ----------------------------------------------
    @torch.inference_mode()
    def prefill_into_slot(self, k_pool, v_pool, table_row, tokens, start: int,
                          n_valid: int, k_scale=None, v_scale=None,
                          sample_state=None):
        """Prefill one fixed-width prompt chunk into one slot's paged
        cache. tokens: [C] (the first ``n_valid`` real); start: tokens
        already cached for the slot; table_row: [NB] the slot's block
        table. Returns ``(logits, k_pool, v_pool)``, or with
        ``sample_state`` (one slot's lane, sampling.SlotSamplerState
        .lane) ``(logits, token [1], logprob [1], k_pool, v_pool)``: the
        token the last valid position yields, meaningful once the final
        chunk lands. ``k_scale``/``v_scale`` ([L, N, Hkv] fp32, with int8
        pools) are updated too and returned after the pools."""
        cfg = self.cfg
        table_row = self._tensor(table_row, torch.int64)
        tokens = self._tensor(tokens, torch.int64)
        C = tokens.shape[0]
        positions = int(start) + torch.arange(C, device=self.device)
        x = self._embed(tokens[None],
                        positions.clamp(0, self.max_seq_len - 1)[None])
        quant = k_scale is not None
        for i, lp in enumerate(self.layers):
            x = _block_prefill_paged(
                x, k_pool[i], v_pool[i], table_row, positions, int(n_valid),
                lp, cfg, k_scale=k_scale[i] if quant else None,
                v_scale=v_scale[i] if quant else None)
        last = min(max(int(n_valid) - 1, 0), C - 1)
        logits = self._logits(x[:, last:last + 1])
        pools = (k_pool, v_pool) + ((k_scale, v_scale) if quant else ())
        if sample_state is None:
            return (logits,) + pools
        tok, lp = sampling.sample_tokens(logits[:, -1], *sample_state)
        return (logits, tok, lp) + pools

    @torch.inference_mode()
    def decode_slots(self, k_pool, v_pool, tables, lengths, tokens, active,
                     k_scale=None, v_scale=None, sample_state=None):
        """One decode step for every serving slot at once. tokens: [B]
        each slot's pending token; lengths: [B] per-slot cache positions;
        active: [B]. Returns ``(logits [B, 1, V], k_pool, v_pool)``, or
        with ``sample_state`` (sampling.SlotSamplerState.lanes)
        ``(logits, tokens [B], logprobs [B], k_pool, v_pool)``; with int8
        pools ``k_scale``/``v_scale`` follow the pools."""
        tables = self._tensor(tables, torch.int32)
        lengths = self._tensor(lengths, torch.int32)
        active = self._tensor(active, torch.bool)
        tokens = self._tensor(tokens, torch.int64)
        pos = lengths.long().clamp(0, self.max_seq_len - 1)
        x = self._embed(tokens[:, None], pos[:, None])
        quant = k_scale is not None
        for i, lp in enumerate(self.layers):
            x = _block_decode_paged(
                x, k_pool[i], v_pool[i], tables, lengths, active, lp,
                self.cfg, k_scale=k_scale[i] if quant else None,
                v_scale=v_scale[i] if quant else None)
        logits = self._logits(x)
        pools = (k_pool, v_pool) + ((k_scale, v_scale) if quant else ())
        if sample_state is None:
            return (logits,) + pools
        toks, lps = sampling.sample_tokens(logits[:, -1], *sample_state)
        return (logits, toks, lps) + pools

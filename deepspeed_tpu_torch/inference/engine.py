"""Inference engine: static KV-cache generation and the paged slot
programs the serving scheduler drives.

Port of ``deepspeed_tpu/inference/engine.py`` for one device:

- the static path (``_prefill_fn``, ``_decode_fn``, ``generate``): the
  prompt runs once through ``_block_prefill``, whose attention is the
  flash-attention kernel (``ops/attention/flash.py``, kernel K1-fwd),
  into a ``[L, B, S_max, Hkv, Dh]`` cache; each new token runs through
  ``_block_decode`` over that cache. ``forward`` (and ``__call__``) gives
  full-sequence logits through the same prefill stack;
  ``generate_fused`` gives ``generate``'s tokens with the decode loop as
  one program: on the card its ``max_new_tokens - 1`` steps are captured
  once into a CUDA graph (cached under the JAX engine's key: batch,
  cache shape, steps, temperature, top_k, mask or not) and replayed as
  one launch, over static buffers (the cache, the first token, the start
  position, the rows' lengths and every step's sampling noise, drawn on
  the host before the replay); on the host the same loop runs eagerly.
  ``latency_ms`` holds the JAX engine's timings;
- the paged path (``prefill_into_slot``, ``decode_slots``): prompt chunks
  go through ``_block_prefill_paged`` (plain gather attention, as in JAX)
  and every decoding slot advances one token per step through
  ``_block_decode_paged``, whose attention is the paged flash-decode
  kernel (``ops/attention/paged.py``, kernel K3). With int8 pools
  (``k_scale``/``v_scale`` given) each write is a read-modify-requantize
  of the blocks it touches and K3 runs in its int8-pool mode;
- the multi-step decode horizon: ``decode_horizon`` runs ``n_steps``
  iterations of the ``decode_slots`` body in one call, with the slots'
  tokens, lengths, live mask, produced counts, repetition-penalty mask
  and stop tails kept on the device and the stop predicates evaluated
  there, so the loop makes no host decision (``docs/MULTISTEP.md`` of
  the JAX package);
- speculative decoding: ``verify_slots`` scores a G-token chunk per slot
  through ``_block_verify_paged`` (K3 in its verify mode, both pool
  modes), ``_extend_fn`` a G-token chunk over the static cache
  (``inference/speculative.py``), and ``cow_blocks``/``cow_blocks_q``
  copy one block for the prefix cache's copy-on-write.

``dtype=torch.int8`` serves weight-only int8 (``quantize_weights_int8``):
every block projection runs the int8 dequant-matmul kernel
(``ops/int8_matmul.py``, K4) on bfloat16 activations on the card (float32
on the host), and the untied ``lm_head`` is dequantized and multiplied.

LoRA: a tree adapted by ``runtime/lora.py`` (unmerged ``lora_a``/
``lora_b``/``lora_scale`` entries, float even over an int8 base) runs its
low-rank terms in every path. Multi-tenant serving passes ``lora=`` (the
adapter pools and the slots' adapter-table rows, ``inference/adapters.py``)
to the four slot programs, the counterparts of the JAX engine's ``_l`` and
``_ql`` twins; ``lora=None`` runs the base-only body unchanged. The delta
is a torch product, as the JAX package computes it outside Pallas.

PyTorch runs eagerly, so there is no jit-twin family and no compiled
program cache. The caches and pools are updated in place (the JAX
programs donate them instead); the paged methods return the pools they
were given so the call sites read like JAX's. The fault sites of the
slot programs (``engine.prefill``, ``engine.decode``, ``engine.verify``
and, with int8 pools, ``cache.quantize``; ``utils/faults.py``) fire
against the ambient injector before the first write into the pools or
their scales and before any kernel launch, so the serving engine's retry
of a failed call never writes a token's K/V twice. ``checkpoint=`` takes the
parameters of a training checkpoint (``runtime/checkpointing.py``). MoE
blocks raise ``NotImplementedError`` naming the slice they wait for.

Tensor parallelism (``mp_size > 1``, every rank of a process group of a
multiple of ``mp_size`` ranks; ``model = mp_size``, ``data = world //
mp_size``, as in the JAX engine): each rank holds its pieces of the tree
by the JAX engine's rules (``_shard_params``) and runs every path on its
``n_heads / mp_size`` heads and ``kv_heads / mp_size`` kv heads (its
static cache, and the serving engine's pools, hold those), the two
row-parallel products of each block summed over the ``model`` group
(``parallel/tensor.py``); the logits are replicated, so every rank picks
the same tokens. On the card ``generate_fused`` refuses a gloo group,
whose host-staged all-reduce a CUDA graph cannot hold.

Encoder inference: a ``(BertConfig, params)`` model builds an encoder
engine, as the JAX engine does (``is_encoder``; the config's dtype
replaced by the engine's; weight-only int8 refused). Its ``forward`` runs
``models/bert.py encode`` deterministically and unmasked, and returns the
MLM logits through the tied word embedding when the tree has ``mlm``,
else the hidden states; on the card attention takes K1-fwd, non-causal,
at S >= 128 (``flash_gate``). ``generate``, ``generate_fused`` and the
slot programs need a causal decoder and raise.
"""

import dataclasses
import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.inference import sampling
from deepspeed_tpu_torch.inference.paged_cache import copy_block
from deepspeed_tpu_torch.models import bert as bert_lib
from deepspeed_tpu_torch.models.gpt import (GPTConfig, _mlp, _norm,
                                            _qkv_split_rotary, layer,
                                            lora_of, tp_of)
from deepspeed_tpu_torch.ops.attention.flash import flash_attention
from deepspeed_tpu_torch.ops.attention.paged import (paged_decode_attention,
                                                     paged_verify_attention)
from deepspeed_tpu_torch.ops.attention.rotary import apply_rotary
from deepspeed_tpu_torch.ops.layers import dense, kernel_of
from deepspeed_tpu_torch.ops.quantizer import (kv_dequantize_blocks,
                                               kv_requantize_blocks)
from deepspeed_tpu_torch.utils.faults import maybe_fire

NEG_INF = -1e30


def quantize_weights_int8(params: Dict) -> Dict:
    """Weight-only int8, as ``deepspeed_tpu/inference/engine.py
    quantize_weights_int8``: every ``kernel`` of ndim >= 2 under ``block``
    and ``lm_head`` becomes ``{"q": int8, "scale": fp32 [..., 1, out]}``
    with ``scale = absmax over the input axis / 127 + 1e-12`` and ``q =
    round(w / scale)`` (half to even, clipped to +-127); embeddings, norms,
    biases and LoRA leaves stay float. A stacked ``[L, in, out]`` kernel
    is quantized one layer at a time (the same bits as the whole stack at
    once, without its fp32 temporaries)."""
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


def _residual(x, attn, h, p, cfg: GPTConfig, lora=None, tp=None):
    """Add the attention branch and the MLP: GPT-J parallel residual
    (MLP reads the same ln1 output) or the sequential GPT-2/llama one.
    ``lora``: the layer's gathered adapter factors by target, or None;
    ``tp``: the model group of a rank's pieces, or None."""
    if cfg.parallel_residual:
        return x + attn + _mlp(h, p, cfg, lora=lora, tp=tp)
    x = x + attn
    return x + _mlp(_norm(x, p["ln2"], cfg), p, cfg, lora=lora, tp=tp)



def _block_prefill(x, p, cfg: GPTConfig, kv_mask=None, positions=None):
    """One block over the whole prompt, returning (y, k, v); k/v are
    post-rotary so decode never rotates history again. kv_mask: [B, S]
    prompt validity (left-padded prompts); positions: [B, S] rotary
    positions."""
    B, S, D = x.shape
    tp, H, Hkv = tp_of(cfg, p)
    h = _norm(x, p["ln1"], cfg)
    q, k, v = _qkv_split_rotary(dense(h, p["qkv"]), cfg, positions, B, S,
                                (H, Hkv))
    attn, _ = flash_attention(q, k, v, causal=True, scale=cfg.attn_scale,
                              kv_mask=kv_mask, window=cfg.attn_window)
    attn = dense(attn.reshape(B, S, -1), p["attn_out"], reduce=tp)
    return _residual(x, attn, h, p, cfg, tp=tp), k, v


def _block_decode(x, k_cache, v_cache, pos, p, cfg: GPTConfig,
                  cache_mask=None, row_pos=None):
    """One block for one new token over the static cache. x: [B, 1, D];
    caches [B, S_max, Hkv, Dh], written in place at ``pos`` (a [1] int64
    tensor on the cache's device, so that a CUDA graph can capture the
    step). cache_mask: [B, S_max] validity (0 = left padding); row_pos:
    [B] logical positions for rotary."""
    B, _, D = x.shape
    tp, H, Hkv = tp_of(cfg, p)
    Dh = cfg.head_dim
    S_max = k_cache.shape[1]
    h = _norm(x, p["ln1"], cfg)
    positions = pos if row_pos is None else row_pos[:, None]
    q, k, v = _qkv_split_rotary(dense(h, p["qkv"]), cfg, positions, B, 1,
                                (H, Hkv))
    q = q.reshape(B, Hkv, H // Hkv, Dh)
    k_cache.index_copy_(1, pos, k)
    v_cache.index_copy_(1, pos, v)
    scores = torch.einsum("bkgd,bskd->bkgs", q, k_cache).float() * _scale(cfg)
    idx = torch.arange(S_max, device=x.device)
    scores = torch.where(idx <= pos, scores, NEG_INF)
    if cfg.attn_window is not None:
        scores = torch.where(idx > pos - cfg.attn_window, scores, NEG_INF)
    if cache_mask is not None:
        scores = torch.where(cache_mask[:, None, None, :] > 0, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    attn = torch.einsum("bkgs,bskd->bkgd", probs, v_cache).reshape(B, 1, -1)
    return _residual(x, dense(attn, p["attn_out"], reduce=tp), h, p, cfg,
                     tp=tp)


def _block_extend(x, k_cache, v_cache, pos: int, p, cfg: GPTConfig):
    """One block for G new tokens at static cache positions [pos, pos+G),
    the chunk verify of ``generate_speculative``. x: [B, G, D]; caches
    [B, S_max, Hkv, Dh], written in place; query i sees cache positions
    <= pos + i."""
    B, G, D = x.shape
    tp, H, Hkv = tp_of(cfg, p)
    Dh = cfg.head_dim
    S_max = k_cache.shape[1]
    h = _norm(x, p["ln1"], cfg)
    positions = pos + torch.arange(G, device=x.device)
    q, k, v = _qkv_split_rotary(dense(h, p["qkv"]), cfg, positions, B, G,
                                (H, Hkv))
    k_cache[:, pos:pos + G] = k
    v_cache[:, pos:pos + G] = v
    qg = q.reshape(B, G, Hkv, H // Hkv, Dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg,
                          k_cache).float() * _scale(cfg)
    idx = torch.arange(S_max, device=x.device)
    qpos = positions[:, None]
    scores = torch.where(idx <= qpos, scores, NEG_INF)
    if cfg.attn_window is not None:
        scores = torch.where(idx > qpos - cfg.attn_window, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    attn = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache).reshape(B, G, -1)
    return _residual(x, dense(attn, p["attn_out"], reduce=tp), h, p, cfg,
                     tp=tp)


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
                        cfg: GPTConfig, k_scale=None, v_scale=None,
                        lora=None):
    """One block for one new token per slot, K/V addressed through block
    tables. x: [B, 1, D]; pools [N, block, Hkv, Dh] (one layer's view,
    written in place); tables [B, NB] int32; lengths [B] int32 per-slot
    cache positions; active [B] bool (inactive slots write to the trash
    block and their logits are ignored). ``k_scale``/``v_scale`` [N, Hkv]
    fp32: the pools are int8 and the write is a read-modify-requantize of
    each slot's current block. ``lora``: this layer's gathered adapter
    factors by target (``InferenceEngine._gather_lora``), or None."""
    B, _, D = x.shape
    tp, H, Hkv = tp_of(cfg, p)
    Dh = cfg.head_dim
    bs, NB = k_pool.shape[1], tables.shape[1]
    pos = lengths.long()
    lr = lora_of(lora)
    h = _norm(x, p["ln1"], cfg)
    qkv = dense(h, p["qkv"], lora=lr("qkv"))
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
    attn = dense(attn.reshape(B, 1, -1), p["attn_out"], lora=lr("attn_out"),
                 reduce=tp)
    return _residual(x, attn, h, p, cfg, lora, tp)


def _verify_requant(pool, scale_pool, tables, lengths, pos, active, new):
    """Write a G-token chunk per slot into int8 blocks, as JAX's
    ``_block_verify_paged``: dequantize the W = 1 + ceil((G-1)/bs) table
    entries the chunk can straddle from the block holding ``lengths[b]``,
    put the writable lanes in, zero the lanes past the chunk's end,
    requantize, and write back the blocks the chunk touched (the others,
    and every block of an inactive slot, go to the trash block). pool,
    scales updated in place; pos [B, G] positions, active [B]."""
    B, G = pos.shape
    bs, NB = pool.shape[1], tables.shape[1]
    writable = active[:, None] & (pos < NB * bs)
    W = 1 + (G + bs - 2) // bs
    j0 = lengths.long() // bs
    wj = j0[:, None] + torch.arange(W, device=pos.device)[None]
    blkw = torch.gather(tables, 1, wj.clamp(0, NB - 1)).long()
    xb = kv_dequantize_blocks(pool[blkw], scale_pool[blkw])
    flat = torch.cat([xb.reshape(B, W * bs, *xb.shape[3:]),
                      xb.new_zeros((B, 1) + xb.shape[3:])], dim=1)
    # masked lanes land in the dropped row W * bs
    tgt = torch.where(writable, (pos // bs - j0[:, None]) * bs + pos % bs,
                      W * bs)
    rows = torch.arange(B, device=pos.device)[:, None]
    flat[rows, tgt] = new.float()
    xb = flat[:, :W * bs].reshape(xb.shape)
    glob = wj[:, :, None] * bs + torch.arange(bs, device=pos.device)
    new_len = torch.clamp(lengths.long() + G, max=NB * bs)
    q, s = kv_requantize_blocks(xb, glob < new_len[:, None, None])
    jhi = torch.clamp((lengths.long() + G - 1) // bs, max=NB - 1)
    blkw = torch.where((wj <= jhi[:, None]) & active[:, None], blkw, 0)
    pool[blkw], scale_pool[blkw] = q, s


def _block_verify_paged(x, k_pool, v_pool, tables, lengths, active, p,
                        cfg: GPTConfig, k_scale=None, v_scale=None,
                        lora=None):
    """One block for a G-token speculative chunk per slot, K/V addressed
    through block tables: the q_len > 1 form of
    :func:`_block_decode_paged`. x: [B, G, D]; chunk token i of slot b
    sits at cache position lengths[b] + i. The chunk's K/V are written
    into the slot's blocks before attention (causality inside the chunk
    is the position mask). Writes past the table's capacity, and every
    write of an inactive slot, go to the trash block. ``k_scale``/
    ``v_scale`` [N, Hkv] fp32: int8 pools, written by
    :func:`_verify_requant`. Attention is the paged kernel's verify mode
    (K3) on the card, its plain version on the host. ``lora`` as in
    :func:`_block_decode_paged`."""
    B, G, D = x.shape
    tp, H, Hkv = tp_of(cfg, p)
    Dh = cfg.head_dim
    bs, NB = k_pool.shape[1], tables.shape[1]
    pos = lengths.long()[:, None] + torch.arange(G, device=x.device)[None]
    lr = lora_of(lora)
    h = _norm(x, p["ln1"], cfg)
    q, k, v = _qkv_split_rotary(dense(h, p["qkv"], lora=lr("qkv")), cfg,
                                pos, B, G, (H, Hkv))
    if k_scale is None:
        blk = torch.gather(tables, 1, (pos // bs).clamp(0, NB - 1)).long()
        blk = torch.where(active[:, None] & (pos < NB * bs), blk, 0)
        k_pool[blk, pos % bs] = k
        v_pool[blk, pos % bs] = v
    else:
        _verify_requant(k_pool, k_scale, tables, lengths, pos, active, k)
        _verify_requant(v_pool, v_scale, tables, lengths, pos, active, v)
    attn = paged_verify_attention(
        q.reshape(B, G, Hkv, H // Hkv, Dh), k_pool, v_pool, tables, lengths,
        scale=_scale(cfg), window=cfg.attn_window, k_scale=k_scale,
        v_scale=v_scale)
    attn = dense(attn.reshape(B, G, -1), p["attn_out"], lora=lr("attn_out"),
                 reduce=tp)
    return _residual(x, attn, h, p, cfg, lora, tp)


def _block_prefill_paged(x, k_pool, v_pool, table_row, positions, n_valid,
                         p, cfg: GPTConfig, k_scale=None, v_scale=None,
                         lora=None):
    """One block over a prompt chunk of one slot: write the chunk's K/V
    through the slot's table, then attend over the slot's whole cache so
    far. x: [1, C, D]; positions: [C] cache positions of the chunk; only
    the first ``n_valid`` lanes are real (padding writes to trash, or is
    dropped with int8 pools). ``k_scale``/``v_scale`` [N, Hkv] fp32: the
    pools are int8 (:func:`_prefill_requant`). ``lora`` as in
    :func:`_block_decode_paged`, for the one slot."""
    B, C, D = x.shape
    tp, H, Hkv = tp_of(cfg, p)
    Dh = cfg.head_dim
    bs, NB = k_pool.shape[1], table_row.shape[0]
    lr = lora_of(lora)
    h = _norm(x, p["ln1"], cfg)
    q, k, v = _qkv_split_rotary(dense(h, p["qkv"], lora=lr("qkv")), cfg,
                                positions[None], B, C, (H, Hkv))
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
    attn = torch.einsum("ckgs,skd->ckgd", probs, vc).reshape(1, C, -1)
    return _residual(x, dense(attn, p["attn_out"], lora=lr("attn_out"),
                              reduce=tp), h, p, cfg, lora, tp)


# the JAX engine's refusal, for an encoder's decoding entry points
ENCODER_FORWARD_ONLY = ("generate() needs a causal decoder; BERT-family "
                        "models support forward() only")


class InferenceEngine:
    """Generation engine over a GPT-layout parameter tree on one device,
    or the forward of a BERT-layout one (``is_encoder``).

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
                    "the policy slice; pass model=(GPTConfig, params) or "
                    "(BertConfig, params)")
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
        self.is_encoder = isinstance(config, bert_lib.BertConfig)
        if not (self.is_encoder or isinstance(config, GPTConfig)):
            raise NotImplementedError(
                f"{type(config).__name__}: this engine takes a GPTConfig "
                f"(GPT/llama decoders) or a BertConfig (encoders)")
        self.mp_size = int(mp_size)
        self.mesh = self._model_mesh(self.mp_size)
        if "moe" in params.get("block", {}):
            raise NotImplementedError("MoE blocks wait for the MoE slice")
        self.device = resolve_device(device)
        if self.mesh is not None and self.device.type == "cuda" \
                and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        # dtype=int8 is weight-only int8: the float leaves are cast to the
        # compute dtype (bf16 on the card, fp32 on the host, as JAX's bf16
        # on a TPU and f32 elsewhere), then the kernels are quantized
        self.quantized = dtype == torch.int8
        if self.quantized:
            if self.is_encoder:
                raise ValueError("weight-only int8 currently covers the "
                                 "decoder path (GPT/llama/MoE layouts)")
            dtype = torch.bfloat16 if self.device.type == "cuda" \
                else torch.float32
        if dtype not in (torch.float32, torch.bfloat16, torch.float16):
            raise ValueError(f"engine dtype must be float32, bfloat16, "
                             f"float16 or int8 (weight-only), got {dtype}")
        if self.is_encoder and config.dtype != dtype:
            # bert.encode computes in cfg.dtype: keep it the engine's
            config = dataclasses.replace(config, dtype=dtype)
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
        if self.mesh is not None:
            self._shard_params()
        # the kv heads this rank's caches and pools hold
        self.kv_heads = (config.n_heads if self.is_encoder
                         else config.kv_heads) // self.mp_size
        self.layers = [] if self.is_encoder else \
            [layer(self.params, i) for i in range(config.n_layers)]
        self.latency_ms: Dict[str, float] = {}
        self._fused: Dict[tuple, Dict] = {}   # generate_fused's captures

    @staticmethod
    def _model_mesh(mp: int):
        """The mesh of ``mp_size`` (``model = mp``, ``data = world //
        mp``, as the JAX engine's) over the process group; None at 1."""
        if mp < 1:
            raise ValueError(f"mp_size must be >= 1, got {mp}")
        if mp == 1:
            return None
        from deepspeed_tpu_torch.parallel import mesh as mesh_lib
        from deepspeed_tpu_torch.utils import distributed as dist_lib
        world = dist_lib.get_world_size() if dist_lib.is_initialized() \
            else 1
        if world % mp:
            raise ValueError(
                f"mp_size={mp} needs a process group of a multiple of {mp} "
                f"ranks (have {world}): call "
                f"deepspeed_tpu_torch.init_distributed on every rank first")
        return mesh_lib.make_mesh(mesh_lib.MeshSpec(data=world // mp,
                                                    model=mp))

    def _shard_params(self) -> None:
        """This rank's pieces of the tree, by the JAX engine's rules
        (``models.convert.model_pieces``); a decoder's config then carries
        the mesh, whose ``model`` group the blocks sum over."""
        from deepspeed_tpu_torch.models.convert import model_pieces
        self.params = model_pieces(self.params, self.cfg, self.mesh)
        if not self.is_encoder:
            self.cfg = dataclasses.replace(self.cfg, mesh=self.mesh)

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
    def sync(self, *values) -> None:
        """Wait for the values (tensors, or dicts, lists and tuples of
        them) to be computed: a no-op for host tensors; for a CUDA tensor
        the current stream of its device is synchronised."""
        devices = set()

        def walk(v):
            if isinstance(v, torch.Tensor):
                if v.device.type == "cuda":
                    devices.add(v.device)
            elif isinstance(v, dict):
                for x in v.values():
                    walk(x)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    walk(x)
        walk(values)
        for d in devices:
            torch.cuda.current_stream(d).synchronize()

    @torch.inference_mode()
    def forward(self, tokens) -> torch.Tensor:
        """Full-sequence logits [B, S, V] of a batch of prompts, through
        the prefill block stack (K1-fwd on the card); an encoder's MLM
        logits, or its hidden states [B, S, d] when the tree has no
        ``mlm`` head (:meth:`_encoder_forward`). The time, the result
        waited for, goes to ``latency_ms["forward"]``."""
        t0 = time.perf_counter()
        tokens = self._tensor(tokens, torch.int64)
        if self.is_encoder:
            out = self._encoder_forward(tokens)
        else:
            x = self._embed(tokens)
            for lp in self.layers:
                x = _block_prefill(x, lp, self.cfg)[0]
            out = self._logits(x)
        self.sync(out)
        self.latency_ms["forward"] = (time.perf_counter() - t0) * 1e3
        return out

    def __call__(self, tokens):
        return self.forward(tokens)

    def _encoder_forward(self, tokens):
        """The JAX engine's ``_encoder_forward_fn``: ``bert.encode``
        deterministic and unmasked (no token types, no attention mask),
        then the MLM head and the tied word embedding with the decoder
        bias when the tree has ``mlm``."""
        p = self.params
        x = bert_lib.encode(p, tokens, self.cfg, deterministic=True,
                            mesh=self.mesh)
        if "mlm" not in p:
            return x
        h = bert_lib._mlm_hidden(p, x, self.cfg)
        return h @ p["embeddings"]["word"].to(x.dtype).t() \
            + p["mlm"]["decoder_bias"].to(x.dtype)

    def _decoder_only(self) -> None:
        if self.is_encoder:
            raise NotImplementedError(ENCODER_FORWARD_ONLY)

    @torch.inference_mode()
    def _prefill_fn(self, tokens, attn_mask=None, cache=None):
        """Run the prompt, build the static cache, return last-position
        logits [B, 1, V] and the cache. attn_mask: [B, S] validity of
        LEFT-padded prompts (1 = real token); positions restart per row
        and padded keys never receive attention. ``cache``: buffers of the
        right shapes to build it in (``generate_fused``'s static ones),
        else new ones."""
        cfg = self.cfg
        B, S = tokens.shape
        positions = None
        if attn_mask is not None:
            positions = (torch.cumsum(attn_mask.to(torch.int64), dim=1)
                         - 1).clamp(min=0)
        x = self._embed(tokens, positions)
        shape = (cfg.n_layers, B, self.max_seq_len, self.kv_heads,
                 cfg.head_dim)
        if cache is None:
            cache = {"k": torch.zeros(shape, dtype=self.dtype,
                                      device=self.device),
                     "v": torch.zeros(shape, dtype=self.dtype,
                                      device=self.device)}
        else:
            cache["k"].zero_()
            cache["v"].zero_()
        for i, lp in enumerate(self.layers):
            x, k, v = _block_prefill(x, lp, cfg, kv_mask=attn_mask,
                                     positions=positions)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
        if attn_mask is not None:
            # decode slots (>= S) are always valid once written
            mask = torch.cat(
                [attn_mask.float(),
                 torch.ones(B, self.max_seq_len - S, device=self.device)], 1)
            if "mask" in cache:
                cache["mask"].copy_(mask)
            else:
                cache["mask"] = mask
        return self._logits(x[:, -1:]), cache

    @torch.inference_mode()
    def _decode_fn(self, cache, token, pos, row_pos=None):
        """One token step over the static cache. token: [B, 1]; pos: the
        cache index (an int, or a 0-dim or [1] int64 tensor on the card for
        a captured step); row_pos: [B] logical positions of left-padded
        rows."""
        pos = pos.reshape(1) if isinstance(pos, torch.Tensor) \
            else torch.tensor([pos], device=self.device)
        x = self.params["wte"]["embedding"][token]
        if self.cfg.use_wpe:
            wpe = self.params["wpe"]["embedding"]
            x = x + (wpe[row_pos][:, None] if row_pos is not None
                     else wpe[pos][None])
        for i, lp in enumerate(self.layers):
            x = _block_decode(x, cache["k"][i], cache["v"][i], pos, lp,
                              self.cfg, cache_mask=cache.get("mask"),
                              row_pos=row_pos)
        return self._logits(x), cache

    @torch.inference_mode()
    def _extend_fn(self, cache, tokens, pos: int):
        """G-token chunk verify over the static cache (the
        ``generate_speculative`` path): tokens [B, G] at cache positions
        [pos, pos+G). Returns logits [B, G, V] and the cache, written in
        place."""
        G = tokens.shape[1]
        x = self.params["wte"]["embedding"][tokens]
        if self.cfg.use_wpe:
            x = x + self.params["wpe"]["embedding"][pos:pos + G][None]
        for i, lp in enumerate(self.layers):
            x = _block_extend(x, cache["k"][i], cache["v"][i], pos, lp,
                              self.cfg)
        return self._logits(x), cache

    def _pick(self, logits, temperature: float, top_k: int, noise=None):
        """The next token [B] of last-position logits: greedy at
        temperature 0, else the Gumbel-max draw of the top-k-truncated
        tempered logits with ``noise`` [B, V] on their device."""
        logits = logits[:, -1].float()
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        z = logits / temperature
        if top_k > 0:
            kth = torch.topk(z, min(top_k, z.shape[-1]), dim=-1)[0][:, -1:]
            z = torch.where(z < kth, NEG_INF, z)
        return torch.argmax(z + noise, dim=-1)

    @staticmethod
    def _noise(temperature: float, seed: int, step: int, shape):
        """``step``'s sampling noise of ``shape`` ([B, V]), drawn on the
        host (None when greedy)."""
        if temperature <= 0.0:
            return None
        return sampling.gumbel_noise(seed, step, tuple(shape))

    def _sample(self, logits, temperature: float, top_k: int, seed: int,
                step: int):
        noise = self._noise(temperature, seed, step,
                            (logits.shape[0], logits.shape[-1]))
        return self._pick(logits, temperature, top_k,
                          None if noise is None else noise.to(logits.device))

    @torch.inference_mode()
    def generate(self, tokens, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 attention_mask=None) -> np.ndarray:
        """Greedy (temperature=0) or sampled generation; returns the
        prompt followed by the new tokens, [B, S + max_new_tokens] int32.

        attention_mask: [B, S] for LEFT-padded prompts of different
        lengths (1 = real token): rows generate as if run unpadded.
        Sampled draws come from this package's generator, not JAX's.
        ``latency_ms``: ``prefill`` and ``decode_per_token``."""
        tokens, mask, row_len = self._gen_inputs(tokens, max_new_tokens,
                                                 attention_mask)
        S = tokens.shape[1]
        logits, cache = self._timed_prefill(tokens, mask)
        t0 = time.perf_counter()
        token = self._sample(logits, temperature, top_k, seed, 0)
        out = [token]
        for i in range(max_new_tokens - 1):
            logits, cache = self._decode_fn(
                cache, token[:, None], S + i,
                None if row_len is None else row_len + i)
            token = self._sample(logits, temperature, top_k, seed, i + 1)
            out.append(token)
        new = torch.stack(out, dim=1).cpu().numpy()
        self.latency_ms["decode_per_token"] = \
            (time.perf_counter() - t0) * 1e3 / max(1, max_new_tokens - 1)
        return np.concatenate([tokens.cpu().numpy(), new],
                              axis=1).astype(np.int32)

    def _gen_inputs(self, tokens, max_new_tokens: int, attention_mask):
        """(tokens [B, S] int64, mask [B, S] fp32 or None, each row's
        real length [B] or None) on the engine's device, checked."""
        self._decoder_only()
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
        return tokens, mask, row_len

    def _timed_prefill(self, tokens, mask, cache=None):
        t0 = time.perf_counter()
        logits, cache = self._prefill_fn(tokens, mask, cache)
        self.sync(logits)
        self.latency_ms["prefill"] = (time.perf_counter() - t0) * 1e3
        return logits, cache

    def _decode_loop(self, cache, token, start, row_len, n_steps: int,
                     temperature: float, top_k: int, noise, out):
        """``n_steps`` decode steps from ``token`` [B] at cache position
        ``start`` (a 0-dim int64 tensor), step i's token into ``out[i]``;
        ``noise`` [n_steps, B, V] (None when greedy). Every operand lives on
        the device and no value goes to the host, so the loop can be
        captured."""
        for i in range(n_steps):
            logits, cache = self._decode_fn(
                cache, token[:, None], start + i,
                None if row_len is None else row_len + i)
            token = self._pick(logits, temperature, top_k,
                               None if noise is None else noise[i])
            out[i].copy_(token)
        return out

    @torch.inference_mode()
    def generate_fused(self, tokens, max_new_tokens: int = 32,
                       temperature: float = 0.0, top_k: int = 0,
                       seed: int = 0, attention_mask=None) -> np.ndarray:
        """``generate``'s tokens (the same draws when sampled), with the
        decode loop as one program: on the card a CUDA graph of its
        ``max_new_tokens - 1`` steps, captured once per key (batch, cache
        shape, steps, temperature, top_k, mask or not) and replayed; on
        the host the same loop, eagerly. ``latency_ms``: ``prefill``,
        ``fused_generate_compile`` (the capture, on a key's first call; on
        the host the set-up) and ``decode_per_token_fused``."""
        tokens, mask, row_len = self._gen_inputs(tokens, max_new_tokens,
                                                 attention_mask)
        B, S = tokens.shape
        n_steps = max_new_tokens - 1
        shape = (self.cfg.n_layers, B, self.max_seq_len, self.kv_heads,
                 self.cfg.head_dim)
        key = ("gen", B, shape, n_steps, temperature, top_k, mask is not None)
        st = self._fused.get(key) if n_steps > 0 else None
        logits, cache = self._timed_prefill(
            tokens, mask, None if st is None else st["cache"])
        first = self._sample(logits, temperature, top_k, seed, 0)
        if n_steps <= 0:
            return np.concatenate([tokens.cpu().numpy(),
                                   first.cpu().numpy()[:, None]],
                                  axis=1).astype(np.int32)
        host_noise = None if temperature <= 0.0 else torch.stack(
            [self._noise(temperature, seed, i + 1, (B, logits.shape[-1]))
             for i in range(n_steps)])
        t0 = time.perf_counter()
        fresh = st is None
        if fresh:
            st = self._fused_buffers(cache, row_len is not None, B, n_steps,
                                     host_noise)
        st["first"].copy_(first)
        st["start"].fill_(S)
        if row_len is not None:
            st["row_len"].copy_(row_len)
        if host_noise is not None:
            st["noise"].copy_(host_noise)
        if fresh:
            if self.device.type == "cuda":
                self._graph_capturable()
                self._capture(st, n_steps, temperature, top_k)
            self._fused[key] = st
            self.latency_ms["fused_generate_compile"] = \
                (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
        if st["graph"] is not None:
            st["graph"].replay()
        else:
            self._decode_loop(st["cache"], st["first"], st["start"],
                              st["row_len"], n_steps, temperature, top_k,
                              st["noise"], st["out"])
        toks = st["out"].cpu().numpy()
        self.latency_ms["decode_per_token_fused"] = \
            (time.perf_counter() - t0) * 1e3 / n_steps
        return np.concatenate([tokens.cpu().numpy(),
                               first.cpu().numpy()[:, None], toks.T],
                              axis=1).astype(np.int32)

    def _fused_buffers(self, cache, masked: bool, B: int, n_steps: int,
                       noise) -> Dict:
        """The static buffers of one ``generate_fused`` key; ``cache`` is
        the first call's, kept as the static cache; ``noise``: the draws'
        host noise (its shape), or None when greedy."""
        dev = self.device
        return {"cache": cache,
                "first": torch.zeros(B, dtype=torch.int64, device=dev),
                "start": torch.zeros((), dtype=torch.int64, device=dev),
                "row_len": (torch.zeros(B, dtype=torch.int64, device=dev)
                            if masked else None),
                "noise": (None if noise is None else
                          torch.zeros(noise.shape, device=dev)),
                "out": torch.zeros(n_steps, B, dtype=torch.int64,
                                   device=dev),
                "graph": None}

    def _graph_capturable(self) -> None:
        """Raise where the decode loop's collectives cannot be captured: a
        CUDA graph holds kernels, and gloo's all-reduce of a CUDA tensor
        is staged through the host."""
        if self.mesh is None:
            return
        import torch.distributed as dist
        pg = self.mesh.group("model").pg
        if dist.get_backend(pg) == "gloo":
            raise ValueError(
                "generate_fused captures its decode loop into a CUDA graph, "
                "which cannot hold gloo's host-staged all-reduce: under "
                "mp_size > 1 on the card use a NCCL process group, or "
                "generate()")

    def _capture(self, st: Dict, n_steps: int, temperature: float,
                 top_k: int) -> None:
        """The CUDA graph of the decode loop over the filled static buffers
        ``st``: its first step runs once on a side stream (writing what
        the graph's first step writes: the kernels are built and cuBLAS
        set up outside the capture), then the loop is captured."""
        dev = self.device
        args = (st["cache"], st["first"], st["start"], st["row_len"])
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._decode_loop(*args, 1, temperature, top_k, st["noise"],
                              st["out"])
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._decode_loop(*args, n_steps, temperature, top_k,
                              st["noise"], st["out"])
        st["graph"] = graph

    # -- paged slot programs ----------------------------------------------
    def _gather_lora(self, lora):
        """The serving engine's ``lora=`` operand (``AdapterPool.lora_args``:
        per-target pools ``a[t] [L, NB, in, rb]``, ``b[t] [L, NB, rb, out]``
        and the slots' adapter-table rows ``[B, NBa]``, or ``[NBa]`` for one
        prefill slot) -> each layer's factors by target, ``(a [B, in, K],
        b [B, K, out])`` with ``K = NBa * rb``. One gather per target and
        factor covers every layer of the dispatch (the JAX programs gather
        per layer inside their scan): a base-only row (all zeros) gathers
        the pool's all-zeros trash block 0. None stays None."""
        if lora is None:
            return None
        a_pool, b_pool, rows = lora
        rows = self._tensor(rows, torch.int64)
        if rows.dim() == 1:
            rows = rows[None]
        B, nba = rows.shape
        layers = [{} for _ in range(self.cfg.n_layers)]
        for t, pool in a_pool.items():
            L, _, din, rb = pool.shape
            a = pool[:, rows].permute(0, 1, 3, 2, 4).reshape(
                L, B, din, nba * rb)
            b = b_pool[t][:, rows].reshape(L, B, nba * rb, -1)
            for i, ab in enumerate(zip(a.unbind(0), b.unbind(0))):
                layers[i][t] = ab
        return layers

    @staticmethod
    def _fire_sites(site: str, k_scale) -> None:
        """A slot program's fault sites, before it touches the pools:
        ``site``, then ``cache.quantize`` with int8 pools."""
        maybe_fire(site)
        if k_scale is not None:
            maybe_fire("cache.quantize")

    @torch.inference_mode()
    def prefill_into_slot(self, k_pool, v_pool, table_row, tokens, start: int,
                          n_valid: int, k_scale=None, v_scale=None,
                          sample_state=None, lora=None):
        """Prefill one fixed-width prompt chunk into one slot's paged
        cache. tokens: [C] (the first ``n_valid`` real); start: tokens
        already cached for the slot; table_row: [NB] the slot's block
        table. Returns ``(logits, k_pool, v_pool)``, or with
        ``sample_state`` (one slot's lane, sampling.SlotSamplerState
        .lane) ``(logits, token [1], logprob [1], k_pool, v_pool)``: the
        token the last valid position yields, meaningful once the final
        chunk lands. ``k_scale``/``v_scale`` ([L, N, Hkv] fp32, with int8
        pools) are updated too and returned after the pools. ``lora``: the
        adapter pools and the slot's adapter-table row
        (``AdapterPool.lora_args``), the counterpart of the JAX engine's
        ``_prefill_slot_l``/``_ql``; None runs the base-only body."""
        self._decoder_only()
        self._fire_sites("engine.prefill", k_scale)
        cfg = self.cfg
        lora = self._gather_lora(lora)
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
                v_scale=v_scale[i] if quant else None,
                lora=None if lora is None else lora[i])
        last = min(max(int(n_valid) - 1, 0), C - 1)
        logits = self._logits(x[:, last:last + 1])
        pools = (k_pool, v_pool) + ((k_scale, v_scale) if quant else ())
        if sample_state is None:
            return (logits,) + pools
        tok, lp = sampling.sample_tokens(logits[:, -1], *sample_state)
        return (logits, tok, lp) + pools

    def _decode_logits(self, k_pool, v_pool, tables, lengths, tokens,
                       active, k_scale, v_scale, lora=None):
        """The body of one decode step over device tensors: every slot's
        token through the layers at its own position (writes of inactive
        slots go to the trash block). ``lora``: each layer's gathered
        adapter factors (:meth:`_gather_lora`), or None. Returns logits
        [B, 1, V]."""
        pos = lengths.long().clamp(0, self.max_seq_len - 1)
        x = self._embed(tokens[:, None], pos[:, None])
        quant = k_scale is not None
        for i, lp in enumerate(self.layers):
            x = _block_decode_paged(
                x, k_pool[i], v_pool[i], tables, lengths, active, lp,
                self.cfg, k_scale=k_scale[i] if quant else None,
                v_scale=v_scale[i] if quant else None,
                lora=None if lora is None else lora[i])
        return self._logits(x)

    @torch.inference_mode()
    def decode_slots(self, k_pool, v_pool, tables, lengths, tokens, active,
                     k_scale=None, v_scale=None, sample_state=None,
                     lora=None):
        """One decode step for every serving slot at once. tokens: [B]
        each slot's pending token; lengths: [B] per-slot cache positions;
        active: [B]. Returns ``(logits [B, 1, V], k_pool, v_pool)``, or
        with ``sample_state`` (sampling.SlotSamplerState.lanes)
        ``(logits, tokens [B], logprobs [B], k_pool, v_pool)``; with int8
        pools ``k_scale``/``v_scale`` follow the pools. ``lora``: the
        adapter pools and every slot's adapter-table row (the JAX
        ``_decode_slots_l``/``_ql``)."""
        self._decoder_only()
        self._fire_sites("engine.decode", k_scale)
        logits = self._decode_logits(
            k_pool, v_pool, self._tensor(tables, torch.int32),
            self._tensor(lengths, torch.int32), self._tensor(tokens,
                                                             torch.int64),
            self._tensor(active, torch.bool), k_scale, v_scale,
            self._gather_lora(lora))
        pools = (k_pool, v_pool) + ((k_scale, v_scale) if k_scale
                                    is not None else ())
        if sample_state is None:
            return (logits,) + pools
        toks, lps = sampling.sample_tokens(logits[:, -1], *sample_state)
        return (logits, toks, lps) + pools

    @torch.inference_mode()
    def decode_horizon(self, k_pool, v_pool, tables, lengths, tokens,
                       active, n_steps, budgets, eos_ids, stop_ids,
                       stop_lens, tail, k_scale=None, v_scale=None,
                       sample_state=None, lora=None):
        """``n_steps`` decode iterations for every serving slot in one
        call, as ``_decode_horizon_core`` of the JAX engine. Iteration 0
        is :meth:`decode_slots`, and each later one sees the state the
        next ``decode_slots`` call would: a lane that emits advances its
        token and length; a lane that is done freezes (its length stops,
        so its writes go to the trash block through the active mask, and
        its later outputs are dead). A lane is done when it has emitted
        ``budgets[b]`` tokens, emitted ``eos_ids[b]`` (-1: none), or its
        last tokens end with a stop row: ``stop_ids`` [B, S, W]
        right-aligned with ``stop_lens`` [B, S] (0: unused row) against
        ``tail`` [B, W], the slot's last W emitted tokens, -1 padded. The
        sampling noise of every (lane, step) is drawn on the host before
        the loop, and the repetition-penalty mask is marked on the
        device, so the loop reads nothing back. Returns ``(tokens
        [n_steps, B], logprobs [n_steps, B], produced [B], done [B],
        k_pool, v_pool)``, the scale pools after the pools with int8.
        ``lora`` as in :meth:`decode_slots` (the JAX
        ``_decode_horizon_l``/``_ql``): the rows are fixed for the call, so
        the factors are gathered once for every iteration."""
        self._decoder_only()
        self._fire_sites("engine.decode", k_scale)
        lora = self._gather_lora(lora)
        dev = self.device
        B = len(tokens)
        if sample_state is None:
            sample_state = sampling.greedy_state(B, self.cfg.vocab_size)
        budgets = np.asarray(budgets, np.int64)
        draws = sampling.HorizonDraws(sample_state, int(n_steps),
                                      np.where(np.asarray(active, bool),
                                               budgets, 0), dev)
        tables = self._tensor(tables, torch.int32)
        lens = self._tensor(lengths, torch.int32)
        active = self._tensor(active, torch.bool)
        tok = self._tensor(tokens, torch.int64)
        gen_counts = self._tensor(sample_state[1], torch.int64)
        budgets = self._tensor(budgets, torch.int64)
        eos_ids = self._tensor(eos_ids, torch.int64)
        stop_ids = self._tensor(stop_ids, torch.int64)
        stop_lens = self._tensor(stop_lens, torch.int64)
        tail = self._tensor(tail, torch.int64)
        W = tail.shape[1]
        # right-aligned suffix compare; the -1 padding of a short stream
        # never meets a real stop token
        valid = torch.arange(W, device=dev)[None, None, :] >= \
            (W - stop_lens)[:, :, None]
        rows = torch.arange(B, device=dev)
        live = active.clone()
        produced = torch.zeros(B, dtype=torch.int64, device=dev)
        seen = draws.seen
        toks_out, lps_out = [], []
        for i in range(int(n_steps)):
            lane_active = active & live
            logits = self._decode_logits(k_pool, v_pool, tables, lens, tok,
                                         lane_active, k_scale, v_scale, lora)
            toks_i, lps_i = draws.sample(logits[:, -1], i, seen)
            toks_out.append(toks_i)
            lps_out.append(lps_i)
            emit = lane_active
            t64 = toks_i.long()
            tok = torch.where(emit, t64, tok)
            lens = lens + emit.int()
            produced = produced + emit.long()
            # the host marks penalized lanes only; marking every emitting
            # lane is inert at a penalty of 1.0 (x / 1.0 == x)
            seen[rows, t64] = seen[rows, t64] | emit
            tail = torch.where(emit[:, None],
                               torch.cat([tail[:, 1:], t64[:, None]], 1),
                               tail)
            hit = torch.all(~valid | (tail[:, None, :] == stop_ids), dim=-1)
            hit = hit & (stop_lens > 0) & \
                ((gen_counts + produced)[:, None] >= stop_lens)
            done_now = emit & ((produced >= budgets)
                               | ((eos_ids >= 0) & (t64 == eos_ids))
                               | hit.any(dim=-1))
            live = live & ~done_now
        pools = (k_pool, v_pool) + ((k_scale, v_scale) if k_scale
                                    is not None else ())
        return (torch.stack(toks_out), torch.stack(lps_out), produced,
                ~live) + pools

    @torch.inference_mode()
    def verify_slots(self, k_pool, v_pool, tables, lengths, tokens, active,
                     k_scale=None, v_scale=None, lora=None):
        """Speculative chunk verify for every serving slot at once.
        tokens: [B, G], each slot's pending token followed by its draft
        tokens, chunk token i of slot b at cache position lengths[b] + i.
        Returns ``(logits [B, G, V], k_pool, v_pool)``; with int8 pools
        ``k_scale``/``v_scale`` follow the pools. ``lora`` as in
        :meth:`decode_slots` (the JAX ``_verify_slots_l``/``_ql``): every
        slot's chunk is scored under its own adapter."""
        self._decoder_only()
        self._fire_sites("engine.verify", k_scale)
        lora = self._gather_lora(lora)
        tables = self._tensor(tables, torch.int32)
        lengths = self._tensor(lengths, torch.int32)
        active = self._tensor(active, torch.bool)
        tokens = self._tensor(tokens, torch.int64)
        G = tokens.shape[1]
        pos = lengths.long()[:, None] + torch.arange(G, device=self.device)
        x = self._embed(tokens, pos.clamp(0, self.max_seq_len - 1))
        quant = k_scale is not None
        for i, lp in enumerate(self.layers):
            x = _block_verify_paged(
                x, k_pool[i], v_pool[i], tables, lengths, active, lp,
                self.cfg, k_scale=k_scale[i] if quant else None,
                v_scale=v_scale[i] if quant else None,
                lora=None if lora is None else lora[i])
        pools = (k_pool, v_pool) + ((k_scale, v_scale) if quant else ())
        return (self._logits(x),) + pools

    def cow_blocks(self, k_pool, v_pool, src: int, dst: int):
        """Copy pool block ``src`` to ``dst`` in every layer, in place:
        the prefix cache's copy-on-write (``paged_cache.copy_block``)."""
        copy_block((k_pool, v_pool), int(src), int(dst))
        return k_pool, v_pool

    def cow_blocks_q(self, k_pool, v_pool, k_scale, v_scale, src: int,
                     dst: int):
        """:meth:`cow_blocks` for int8 pools: the block's scales travel
        with its codes."""
        copy_block((k_pool, v_pool, k_scale, v_scale), int(src), int(dst))
        return k_pool, v_pool, k_scale, v_scale

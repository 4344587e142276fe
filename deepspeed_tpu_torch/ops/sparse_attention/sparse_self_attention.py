"""SparseSelfAttention module and the sequence pad/unpad helpers.

Port of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``.
Tensors are [B, S, H, D]; masks follow the reference's modes:
key_padding_mask is [B, S] ('add' = additive float, 'mul' = multiplicative
0/1), attn_mask is [S, S].
"""

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import (
    blocksparse_attention, make_lut)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
    FixedSparsityConfig, SparsityConfig, VariableSparsityConfig)


class SparseSelfAttention(torch.nn.Module):
    """Scaled-dot-product attention restricted to a block-sparse layout.

    The layout and its table of active blocks are built on the host once
    per sequence length and cached; the table's device copies come from
    ``blocksparse.block_table``, uploaded once per device. The card only
    ever runs the sparse kernel. The module holds no parameters."""

    def __init__(self, sparsity_config: Optional[SparsityConfig] = None,
                 key_padding_mask_mode: str = "add",
                 attn_mask_mode: str = "mul",
                 max_seq_length: int = 2048):
        super().__init__()
        self.sparsity_config = sparsity_config or FixedSparsityConfig(
            num_heads=4)
        if key_padding_mask_mode not in ("add", "mul"):
            raise ValueError("key_padding_mask_mode must be 'add' or 'mul'")
        if attn_mask_mode not in ("add", "mul"):
            raise ValueError("attn_mask_mode must be 'add' or 'mul'")
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.max_seq_length = max_seq_length
        self._cache = {}

    def layout_for(self, seq_len: int):
        """(layout, lut, valid) for this sequence length, cached."""
        if seq_len not in self._cache:
            layout = self.sparsity_config.make_layout(seq_len)
            self._cache[seq_len] = (layout, *make_lut(layout))
        return self._cache[seq_len]

    def forward(self, query, key, value, rpe=None, key_padding_mask=None,
                attn_mask=None):
        B, S, H, D = query.shape
        if H != self.sparsity_config.num_heads:
            raise ValueError(
                f"input has {H} heads, config expects "
                f"{self.sparsity_config.num_heads}")
        if S > self.max_seq_length:
            raise ValueError(
                f"sequence length {S} exceeds max_seq_length "
                f"{self.max_seq_length}")
        layout, lut, valid = self.layout_for(S)
        causal = getattr(self.sparsity_config, "attention",
                         "bidirectional") == "unidirectional"
        return blocksparse_attention(
            query, key, value, layout, causal=causal,
            key_padding_mask=key_padding_mask,
            key_padding_mask_mode=self.key_padding_mask_mode,
            attn_mask=attn_mask, attn_mask_mode=self.attn_mask_mode,
            rpe=rpe, lut_valid=(lut, valid))


class SparseAttentionUtils:
    """Sequence pad/unpad helpers so arbitrary-length inputs can run
    through block-aligned sparse kernels (the reference's
    ``sparse_attention_utils.pad_to_block_size``)."""

    @staticmethod
    def pad_to_block_size(block: int, input_ids=None, attention_mask=None,
                          token_type_ids=None, position_ids=None,
                          inputs_embeds=None, pad_token_id: int = 0):
        """Right-pad sequence-major tensors to a multiple of ``block``.

        Returns (pad_len, input_ids, attention_mask, token_type_ids,
        position_ids, inputs_embeds); None entries pass through."""
        ref = input_ids if input_ids is not None else inputs_embeds
        if ref is None:
            raise ValueError("need input_ids or inputs_embeds")
        S = ref.shape[1]
        pad_len = (-S) % block
        if pad_len == 0:
            return (0, input_ids, attention_mask, token_type_ids,
                    position_ids, inputs_embeds)

        def pad1(x, value=0):
            if x is None:
                return None
            # F.pad lists widths from the last dimension backwards
            widths = [0, 0] * (x.dim() - 2) + [0, pad_len]
            return F.pad(x, widths, value=value)

        return (pad_len,
                pad1(input_ids, pad_token_id),
                pad1(attention_mask, 0),
                pad1(token_type_ids, 0),
                pad1(position_ids, 0),
                pad1(inputs_embeds, 0))

    @staticmethod
    def unpad_sequence_output(pad_len: int, sequence_output):
        """Strip the padding added by pad_to_block_size."""
        if pad_len == 0:
            return sequence_output
        return sequence_output[:, :-pad_len]


def sparse_density(layout: np.ndarray) -> float:
    """Fraction of active blocks: the advertised compute saving."""
    layout = np.asarray(layout)
    return float(layout.sum()) / layout.size


def build_sparsity_config(sa_cfg, num_heads: int) -> SparsityConfig:
    """Instantiate a SparsityConfig from the engine's ``sparse_attention``
    config section (``DeepSpeedConfig.sparse_attention``)."""
    mode = sa_cfg.mode
    common = dict(num_heads=num_heads, block=sa_cfg.block,
                  different_layout_per_head=sa_cfg.different_layout_per_head)
    if mode == "dense":
        return DenseSparsityConfig(**common)
    if mode == "fixed":
        return FixedSparsityConfig(
            num_local_blocks=sa_cfg.num_local_blocks,
            num_global_blocks=sa_cfg.num_global_blocks,
            attention=sa_cfg.attention,
            horizontal_global_attention=sa_cfg.horizontal_global_attention,
            num_different_global_patterns=(
                sa_cfg.num_different_global_patterns),
            **common)
    if mode == "variable":
        return VariableSparsityConfig(
            num_random_blocks=sa_cfg.num_random_blocks,
            local_window_blocks=sa_cfg.local_window_blocks,
            global_block_indices=sa_cfg.global_block_indices,
            global_block_end_indices=sa_cfg.global_block_end_indices,
            attention=sa_cfg.attention,
            horizontal_global_attention=sa_cfg.horizontal_global_attention,
            **common)
    if mode == "bigbird":
        return BigBirdSparsityConfig(
            num_random_blocks=sa_cfg.num_random_blocks,
            num_sliding_window_blocks=sa_cfg.num_sliding_window_blocks,
            num_global_blocks=sa_cfg.num_global_blocks,
            **common)
    if mode == "bslongformer":
        return BSLongformerSparsityConfig(
            num_sliding_window_blocks=sa_cfg.num_sliding_window_blocks,
            global_block_indices=sa_cfg.global_block_indices,
            global_block_end_indices=sa_cfg.global_block_end_indices,
            **common)
    raise ValueError(f"unknown sparse attention mode: {mode}")

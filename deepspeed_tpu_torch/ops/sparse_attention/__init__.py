"""Block-sparse attention: port of ``deepspeed_tpu/ops/sparse_attention/``.

The names are the JAX package's, except that its gather version
``blocksparse_attention_jnp`` is ``blocksparse_attention_gather`` here."""

from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    SparsityConfig, DenseSparsityConfig, FixedSparsityConfig,
    VariableSparsityConfig, BigBirdSparsityConfig,
    BSLongformerSparsityConfig)
from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import (
    blocksparse_attention, blocksparse_attention_gather,
    blocksparse_attention_kernel, blocksparse_reference, make_lut)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    SparseSelfAttention, SparseAttentionUtils, sparse_density,
    build_sparsity_config)

__all__ = [
    "SparsityConfig", "DenseSparsityConfig", "FixedSparsityConfig",
    "VariableSparsityConfig", "BigBirdSparsityConfig",
    "BSLongformerSparsityConfig", "blocksparse_attention",
    "blocksparse_attention_gather", "blocksparse_attention_kernel",
    "blocksparse_reference", "make_lut", "SparseSelfAttention",
    "SparseAttentionUtils", "sparse_density",
]

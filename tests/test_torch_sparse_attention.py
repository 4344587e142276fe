"""Parity of the port's block-sparse attention
(deepspeed_tpu_torch.ops.sparse_attention) with the JAX package on the CPU:
the five sparsity layouts and their block tables bit for bit, the gather
version against ``blocksparse_attention_jnp`` and the dense reference
(element masks in both modes, ``rpe``), the port's kernel path against the
TPU kernel run in interpret mode, its gradients against the JAX
``custom_vjp``, and the ``SparseSelfAttention`` module built from the
engine config's ``sparse_attention`` section.

Inputs are numpy arrays made from a seed. float32, rtol/atol 1e-5: the
two packages sum in another order. On a CPU tensor the port's kernel path
runs the gather version, so these tests hold the plain versions; the
CUDA kernel is held against them on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.sparse_attention import blocksparse as tbs
from deepspeed_tpu_torch.runtime import config as tconfig

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, H, D, BLOCK = 2, 128, 4, 32, 32

# (class name, keyword arguments, sequence length): every layout family,
# with the random ones (Variable, BigBird) at two lengths
LAYOUTS = [
    ("DenseSparsityConfig", dict(block=16), 64),
    ("FixedSparsityConfig", dict(block=16, num_local_blocks=4), 256),
    ("FixedSparsityConfig", dict(block=16, num_local_blocks=4,
                                 attention="unidirectional"), 272),
    ("FixedSparsityConfig", dict(block=16, num_local_blocks=4,
                                 num_global_blocks=2,
                                 different_layout_per_head=True,
                                 num_different_global_patterns=2,
                                 horizontal_global_attention=True), 256),
    ("VariableSparsityConfig", dict(block=16, num_random_blocks=2,
                                    local_window_blocks=[2, 3],
                                    global_block_indices=[1, 7],
                                    global_block_end_indices=[3, 9],
                                    different_layout_per_head=True), 512),
    ("VariableSparsityConfig", dict(block=32, num_random_blocks=1,
                                    attention="unidirectional"), 256),
    ("BigBirdSparsityConfig", dict(block=16, num_random_blocks=2,
                                   different_layout_per_head=True), 512),
    ("BigBirdSparsityConfig", dict(block=16), 128),
    ("BSLongformerSparsityConfig", dict(block=16,
                                        num_sliding_window_blocks=5,
                                        global_block_indices=[0, 10]), 384),
]


def _qkv(seed=0, s=S, h=H):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, s, h, D)).astype(np.float32)
                 for _ in range(3))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("case", LAYOUTS,
                         ids=[f"{c[0][:-14]}-{i}" for i, c in
                              enumerate(LAYOUTS)])
def test_layouts_and_tables_are_bit_identical(case):
    name, kw, seq = case
    jl = getattr(jsa, name)(num_heads=4, **kw).make_layout(seq)
    tl = getattr(tsa, name)(num_heads=4, **kw).make_layout(seq)
    assert tl.dtype == jl.dtype and np.array_equal(tl, jl)
    for got, want in zip(tsa.make_lut(tl), jsa.make_lut(jl)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert tsa.sparse_density(tl) == jsa.sparse_density(jl)


def test_layout_errors_match_jax():
    for mod in (jsa, tsa):
        with pytest.raises(ValueError, match="divisible"):
            mod.FixedSparsityConfig(num_heads=2, block=16).make_layout(100)
        with pytest.raises(ValueError, match="start"):
            mod.VariableSparsityConfig(num_heads=2, global_block_indices=[3],
                                       global_block_end_indices=[2])
        with pytest.raises(NotImplementedError):
            mod.FixedSparsityConfig(num_heads=2, attention="sideways")


def _fixed(causal, h=H, block=BLOCK, local=2):
    cfg = tsa.FixedSparsityConfig(
        num_heads=h, block=block, num_local_blocks=local,
        attention="unidirectional" if causal else "bidirectional")
    return cfg.make_layout(S)


@pytest.mark.parametrize("case", [
    dict(causal=False),
    dict(causal=True),
    dict(causal=False, kp="add", am="mul"),
    dict(causal=True, kp="mul", am="add"),
    dict(causal=False, rpe=True, am="mul"),
    dict(causal=True, kp="add", rpe=True),
], ids=["bidir", "causal", "kp-add-am-mul", "causal-kp-mul-am-add", "rpe",
        "causal-kp-rpe"])
def test_gather_matches_jax_and_dense_reference(case):
    """The gather version against ``blocksparse_attention_jnp`` and both
    dense references (port and JAX), and its q/k/v gradients against
    JAX's."""
    layout = tsa.BSLongformerSparsityConfig(
        num_heads=H, block=BLOCK, num_sliding_window_blocks=1,
        global_block_indices=[2]).make_layout(S) if case.get("rpe") \
        else _fixed(case["causal"])
    lut, valid = tsa.make_lut(layout)
    rng = np.random.default_rng(1)
    q, k, v = _qkv(2)
    kw = dict(causal=case["causal"])
    if "kp" in case:
        keep = rng.random((B, S)) > 0.2
        kp = keep.astype(np.float32) if case["kp"] == "mul" \
            else np.where(keep, 0.0, -1e4).astype(np.float32)
        kw.update(key_padding_mask=kp, key_padding_mask_mode=case["kp"])
    if "am" in case:
        am = (rng.random((S, S)) > 0.1).astype(np.float32)
        if case["am"] == "add":
            am = rng.standard_normal((S, S)).astype(np.float32)
        kw.update(attn_mask=am, attn_mask_mode=case["am"])
    if case.get("rpe"):
        kw.update(rpe=rng.standard_normal((S, S)).astype(np.float32))
    g = rng.standard_normal((B, S, H, D)).astype(np.float32)

    def jfn(q, k, v):
        o = jsa.blocksparse_attention_jnp(q, k, v, lut, valid, BLOCK, **kw)
        return (o * g).sum(), o
    (_, jo), jgrads = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    to = tsa.blocksparse_attention_gather(tq, tk, tv, lut, valid, BLOCK,
                                          **kw)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)
    tgrads = torch.autograd.grad((to * torch.from_numpy(g)).sum(),
                                 [tq, tk, tv])
    for got, want in zip(tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    def jreference(q, k, v):
        return jsa.blocksparse_reference(q, k, v, layout, **kw)
    jref = np.asarray(jax.jit(jreference)(q, k, v))
    tref = tsa.blocksparse_reference(*_t(q, k, v), layout, **kw).numpy()
    np.testing.assert_allclose(tref, jref, **TOL)
    np.testing.assert_allclose(to.detach().numpy(), tref, **TOL)
    # the public entry routes a CPU tensor to the gather version
    n0 = tsa.blocksparse_attention_kernel.launches
    out = tsa.blocksparse_attention(*_t(q, k, v), layout, **kw)
    np.testing.assert_allclose(out.numpy(), to.detach().numpy(), rtol=0,
                               atol=0)
    assert tsa.blocksparse_attention_kernel.launches == n0


@pytest.mark.parametrize("causal", [False, True],
                         ids=["bidirectional", "causal"])
def test_kernel_path_matches_pallas_interpret(pallas_interpret, causal):
    """The port's kernel entry (the gather version on a CPU tensor) against
    the TPU kernel in interpret mode, outputs and q/k/v gradients (the JAX
    ``custom_vjp`` recomputes through its gather path)."""
    layout = _fixed(causal)
    lut, valid = tsa.make_lut(layout)
    q, k, v = _qkv(3)
    g = np.random.default_rng(4).standard_normal((B, S, H, D)).astype(
        np.float32)

    def jfn(q, k, v):
        o = jsa.blocksparse_attention_kernel(q, k, v, lut, valid, BLOCK,
                                             causal=causal)
        return (o * g).sum(), o
    (_, jo), jgrads = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    to = tsa.blocksparse_attention_kernel(tq, tk, tv, lut, valid, BLOCK,
                                          causal=causal)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)
    tgrads = torch.autograd.grad((to * torch.from_numpy(g)).sum(),
                                 [tq, tk, tv])
    for got, want in zip(tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fully_masked_rows_are_zero(pallas_interpret):
    """A causal layout whose first query block attends only a block above
    the diagonal: those rows are exactly 0 (not NaN, not a uniform
    average), as the TPU kernel and the gather path give."""
    nb = 4
    layout = np.zeros((1, nb, nb), np.int64)
    layout[0, 0, 2] = 1
    layout[0, 1:, 0] = 1
    np.fill_diagonal(layout[0][1:, 1:], 1)
    lut, valid = tsa.make_lut(layout)
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, nb * BLOCK, 1, D)).astype(np.float32)
               for _ in range(3))
    jo = np.asarray(jsa.blocksparse_attention_kernel(
        *(jnp.asarray(a) for a in (q, k, v)), lut, valid, BLOCK, causal=True))
    for fn in (tsa.blocksparse_attention_kernel,
               tsa.blocksparse_attention_gather):
        to = fn(*_t(q, k, v), lut, valid, BLOCK, causal=True).numpy()
        assert np.all(np.isfinite(to))
        assert np.abs(to[0, :BLOCK]).max() == 0.0
        np.testing.assert_allclose(to, jo, **TOL)


def test_sparse_self_attention_from_engine_config():
    """``sparse_attention`` in the engine config parses to the JAX package's
    fields; ``build_sparsity_config`` and ``SparseSelfAttention`` over it
    give the JAX module's layout and output, masks included."""
    section = {"mode": "bigbird", "block": 32, "num_random_blocks": 1,
               "num_sliding_window_blocks": 3, "num_global_blocks": 1,
               "different_layout_per_head": True}
    cfg = {"train_batch_size": 8, "sparse_attention": section}
    jsec = jconfig.DeepSpeedConfig(dict(cfg)).sparse_attention
    tsec = tconfig.DeepSpeedConfig(dict(cfg)).sparse_attention
    assert dataclasses.asdict(tsec) == dataclasses.asdict(jsec)
    jmod = jsa.SparseSelfAttention(jsa.build_sparsity_config(jsec, H),
                                   key_padding_mask_mode="mul",
                                   max_seq_length=256)
    tmod = tsa.SparseSelfAttention(tsa.build_sparsity_config(tsec, H),
                                   key_padding_mask_mode="mul",
                                   max_seq_length=256)
    assert isinstance(tmod, torch.nn.Module)
    for got, want in zip(tmod.layout_for(S), jmod.layout_for(S)):
        assert np.array_equal(got, want)
    q, k, v = _qkv(6)
    kp = (np.random.default_rng(7).random((B, S)) > 0.25).astype(np.float32)
    def jcall(q, k, v, mask):
        return jmod(q, k, v, key_padding_mask=mask)
    jcall = jax.jit(jcall)
    for mask in (None, kp):
        jo = np.asarray(jcall(q, k, v, mask))
        to = tmod(*_t(q, k, v), key_padding_mask=None if mask is None
                  else torch.from_numpy(mask))
        np.testing.assert_allclose(to.numpy(), jo, **TOL)


@pytest.mark.parametrize("mode", ["dense", "fixed", "variable", "bigbird",
                                  "bslongformer"])
def test_build_sparsity_config_every_mode(mode):
    sec = {"mode": mode, "block": 16, "num_random_blocks": 1}
    jsec = jconfig.SparseAttentionConfig.from_dict(sec)
    tsec = tconfig.SparseAttentionConfig.from_dict(sec)
    jc, tc = jsa.build_sparsity_config(jsec, 2), tsa.build_sparsity_config(
        tsec, 2)
    assert type(tc).__name__ == type(jc).__name__
    assert np.array_equal(tc.make_layout(128), jc.make_layout(128))
    with pytest.raises(ValueError, match="unknown sparse attention mode"):
        tsa.build_sparsity_config(
            tconfig.SparseAttentionConfig.from_dict({"mode": "other"}), 2)


def test_module_checks_heads_and_max_seq_length():
    mod = tsa.SparseSelfAttention(
        tsa.FixedSparsityConfig(num_heads=H, block=BLOCK,
                                num_local_blocks=2), max_seq_length=96)
    q, k, v = _t(*_qkv(8))
    with pytest.raises(ValueError, match="max_seq_length"):
        mod(q, k, v)
    with pytest.raises(ValueError, match="heads"):
        mod(q[:, :64, :2], k[:, :64, :2], v[:, :64, :2])
    with pytest.raises(ValueError, match="key_padding_mask_mode"):
        tsa.SparseSelfAttention(key_padding_mask_mode="max")
    # the table is built once per length and uploaded once per device
    mod(q[:, :64], k[:, :64], v[:, :64])
    entry = mod.layout_for(64)
    mod(q[:, :64], k[:, :64], v[:, :64])
    assert mod.layout_for(64) is entry
    table = tbs.block_table(*entry[1:])
    assert table.on("cpu") is table.on("cpu")


def test_use_kernel_with_masks_raises():
    """The JAX package drops masks and ``rpe`` silently when
    ``use_kernel=True``; the port refuses."""
    layout = _fixed(False)
    q, k, v = _t(*_qkv(9))
    for kw in (dict(key_padding_mask=torch.ones(B, S)),
               dict(attn_mask=torch.ones(S, S)),
               dict(rpe=torch.zeros(S, S))):
        with pytest.raises(ValueError, match="use_kernel=True"):
            tsa.blocksparse_attention(q, k, v, layout, use_kernel=True, **kw)
    # without masks use_kernel=True on a CPU tensor is the gather version
    out = tsa.blocksparse_attention(q, k, v, layout, use_kernel=True)
    ref = tsa.blocksparse_reference(q, k, v, layout)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
    with pytest.raises(ValueError, match="divisible"):
        tsa.blocksparse_attention(q[:, :90], k[:, :90], v[:, :90], layout)
    # one table per (lut, valid) pair, whose arrays then stay as they are;
    # the cache keeps the TABLE_CACHE most recently used tables
    lut, valid = tsa.make_lut(layout)
    first = tbs.block_table(lut, valid)
    assert tbs.block_table(lut, valid) is first
    with pytest.raises(ValueError, match="read-only"):
        lut[0, 0, 0] = 1
    for col in range(1, tbs.TABLE_CACHE + 1):
        tbs.block_table(np.full((1, 1, 1), col, np.int32),
                        np.ones((1, 1, 1), bool))
    assert len(tbs._TABLE_CACHE) == tbs.TABLE_CACHE
    assert tbs.block_table(lut, valid) is not first


def test_pad_to_block_size_and_unpad():
    rng = np.random.default_rng(10)
    ids = rng.integers(1, 50, (2, 37))
    mask = np.ones((2, 37), np.int64)
    emb = rng.standard_normal((2, 37, 8)).astype(np.float32)
    jout = jsa.SparseAttentionUtils.pad_to_block_size(
        16, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        inputs_embeds=jnp.asarray(emb), pad_token_id=7)
    tout = tsa.SparseAttentionUtils.pad_to_block_size(
        16, input_ids=torch.from_numpy(ids),
        attention_mask=torch.from_numpy(mask),
        inputs_embeds=torch.from_numpy(emb), pad_token_id=7)
    assert tout[0] == jout[0] == 11
    for got, want in zip(tout[1:], jout[1:]):
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tout[1][:, 37:].eq(7).all() and tout[2][:, 37:].eq(0).all()
    seq = torch.randn(2, 48, 8)
    assert torch.equal(
        tsa.SparseAttentionUtils.unpad_sequence_output(11, seq), seq[:, :37])
    none = tsa.SparseAttentionUtils.pad_to_block_size(
        16, input_ids=torch.from_numpy(ids[:, :32]))
    assert none[0] == 0 and torch.equal(none[1],
                                        torch.from_numpy(ids[:, :32]))
    with pytest.raises(ValueError, match="input_ids or inputs_embeds"):
        tsa.SparseAttentionUtils.pad_to_block_size(16)

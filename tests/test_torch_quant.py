"""Parity of the port's int8 pieces with the JAX package on the CPU: the
KV-cache block quantizer, weight-only int8 quantization, the int8
dequant-matmul's plain version (K4) and the `_dense` branch that uses it,
the int8-pool mode of the paged decode/verify plain versions (K3), the
int8 paged cache's layout and budget, and the conversion of a quantized
JAX tree.

Inputs are seeded numpy arrays handed to both packages. The quantizers
must give the same bits; float results are held at rtol/atol 1e-5 in
float32 unless a test states otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import engine as jengine
from deepspeed_tpu.inference import paged_cache as jpaged_cache
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.ops import int8_matmul as jint8
from deepspeed_tpu.ops import quantizer as jquant
from deepspeed_tpu.ops.attention import paged as jpaged
from deepspeed_tpu_torch.inference import engine as tengine
from deepspeed_tpu_torch.inference.paged_cache import PagedKVCache
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.ops import int8_matmul as tint8
from deepspeed_tpu_torch.ops import layers as tlayers
from deepspeed_tpu_torch.ops import quantizer as tquant
from deepspeed_tpu_torch.ops.attention import paged as tpaged
from test_torch_model import numpy_params

TOL = dict(rtol=1e-5, atol=1e-5)
LLAMA = dict(jgpt.PRESETS["llama-tiny"], n_layers=2, d_model=32, n_heads=4,
             n_kv_heads=2, d_ff=48, rotary_dim=8, vocab_size=64,
             max_seq_len=64)
GPT2 = dict(vocab_size=64, n_layers=2, n_heads=4, d_model=32, max_seq_len=64)


def _blocks(rng, shape, zero_block=True):
    x = rng.standard_normal(shape).astype(np.float32)
    if zero_block:
        x[0, 1] = 0.0                      # one all-zero block
    return x


def test_kv_helpers_match_jax_bits():
    rng = np.random.default_rng(0)
    x = _blocks(rng, (2, 3, 4, 2, 8))       # [L, N, bs, Hkv, Dh]
    live = rng.random((2, 3, 4)) < 0.6
    assert tquant.KV_QMAX == jquant.KV_QMAX
    s_t = tquant.kv_block_scales(torch.from_numpy(x))
    s_j = jquant.kv_block_scales(jnp.asarray(x))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert (s_t.numpy()[0, 1] == 0).all()
    q_t = tquant.kv_quantize_blocks(torch.from_numpy(x), s_t)
    q_j = jquant.kv_quantize_blocks(jnp.asarray(x), s_j)
    assert q_t.dtype == torch.int8
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    for m in (None, live):
        qt, st = tquant.kv_requantize_blocks(
            torch.from_numpy(x), None if m is None else torch.from_numpy(m))
        qj, sj = jquant.kv_requantize_blocks(
            jnp.asarray(x), None if m is None else jnp.asarray(m))
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    # stale lanes are zeroed before the absmax
    qt, _ = tquant.kv_requantize_blocks(torch.from_numpy(x),
                                        torch.from_numpy(live))
    assert (qt.numpy()[~live] == 0).all()
    for dt_t, dt_j in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        d_t = tquant.kv_dequantize_blocks(qt, st, dtype=dt_t)
        d_j = jquant.kv_dequantize_blocks(qj, sj, dtype=dt_j)
        np.testing.assert_array_equal(d_t.float().numpy(),
                                      np.asarray(d_j, np.float32))


@pytest.mark.parametrize("mode,want", [
    (None, "off"), (False, "off"), ("off", "off"), ("none", "off"),
    ("0", "off"), (True, "int8"), ("on", "int8"), ("int8", "int8"),
    (" INT8 ", "int8"), ("yes", "int8")])
def test_resolve_kv_quant_aliases(mode, want, monkeypatch):
    monkeypatch.delenv("DS_KV_QUANT", raising=False)
    assert tquant.resolve_kv_quant(mode) == want
    assert jquant.resolve_kv_quant(mode) == want


def test_resolve_kv_quant_rejects_unknown():
    with pytest.raises(ValueError, match="kv_quant"):
        tquant.resolve_kv_quant("int4")


@pytest.mark.parametrize("name", ["llama", "gpt2"])
def test_quantize_weights_int8_matches_jax_bits(name):
    fields = LLAMA if name == "llama" else GPT2
    jcfg = jgpt.GPTConfig(**fields, dtype=jnp.float32,
                          use_flash_attention=False, remat=False)
    npp = numpy_params(jcfg, seed=3)
    jq = jax.tree_util.tree_map(
        np.asarray, jengine.quantize_weights_int8(
            jax.tree_util.tree_map(jnp.asarray, npp)))
    tq = tengine.quantize_weights_int8(
        jax.tree_util.tree_map(torch.from_numpy, npp))
    jl = jax.tree_util.tree_leaves_with_path(jq)
    tl = dict((jax.tree_util.keystr(p), v) for p, v in
              jax.tree_util.tree_leaves_with_path(
                  jax.tree_util.tree_map(lambda t: t.numpy(), tq)))
    assert len(jl) == len(tl)
    for path, want in jl:
        got = tl[jax.tree_util.keystr(path)]
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))
    assert "q" in tq["block"]["qkv"] and "kernel" not in tq["block"]["qkv"]
    assert tq["block"]["mlp_out"]["scale"].shape == (2, 1, jcfg.d_model)
    assert tq["wte"]["embedding"].dtype == torch.float32
    if name == "llama":
        assert tq["lm_head"]["q"].dtype == torch.int8
    else:
        assert tq["block"]["qkv"]["bias"].dtype == torch.float32


def _int8_weight(rng, K, N):
    w = rng.standard_normal((K, N)).astype(np.float32)
    scale = np.abs(w).max(0, keepdims=True) / 127.0 + 1e-12
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def test_int8_matmul_reference_matches_jax_kernel():
    """The plain version against JAX's Pallas kernel in interpret mode:
    float32 at 2e-5; bfloat16 at the bound of the JAX package's own test
    (the plain version rounds the dequantized weight to bf16, the kernel
    sums exact products in fp32)."""
    rng = np.random.default_rng(1)
    M, K, N = 40, 256, 256
    q, scale = _int8_weight(rng, K, N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    jout = jint8.int8_matmul(jnp.asarray(x), jnp.asarray(q),
                             jnp.asarray(scale), block_m=32, block_n=128,
                             block_k=128, interpret=True)
    tout = tint8.int8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                             torch.from_numpy(scale))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               rtol=2e-5, atol=2e-5)
    xb = jnp.asarray(x[:8], jnp.bfloat16)
    jout = jint8.int8_matmul(xb, jnp.asarray(q[:, :128]),
                             jnp.asarray(scale[:, :128]), block_m=8,
                             block_n=128, block_k=128, interpret=True)
    tout = tint8.int8_matmul(
        torch.from_numpy(np.asarray(xb, np.float32)).bfloat16(),
        torch.from_numpy(q[:, :128]), torch.from_numpy(scale[:, :128]))
    assert tout.dtype == torch.bfloat16 and tout.shape == (8, 128)
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout, np.float32),
                               rtol=5e-2, atol=0.3)
    # and the JAX package's own plain version in bf16, to bf16 rounding
    jref = jint8.int8_matmul_reference(xb, jnp.asarray(q[:, :128]),
                                       jnp.asarray(scale[:, :128]))
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jref, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_int8_dense_matches_jax():
    """``dense`` on an int8 entry (with a bias, over [B, S, K] input) and
    ``kernel_of`` against the JAX package's ``_dense`` and
    ``_kernel_of``."""
    rng = np.random.default_rng(2)
    q, scale = _int8_weight(rng, 32, 48)
    bias = rng.standard_normal(48).astype(np.float32)
    h = rng.standard_normal((2, 5, 32)).astype(np.float32)
    jp = {"q": jnp.asarray(q), "scale": jnp.asarray(scale),
          "bias": jnp.asarray(bias)}
    tp = {"q": torch.from_numpy(q), "scale": torch.from_numpy(scale),
          "bias": torch.from_numpy(bias)}
    np.testing.assert_allclose(
        tlayers.dense(torch.from_numpy(h), tp).numpy(),
        np.asarray(jgpt._dense(jnp.asarray(h), jp)), **TOL)
    np.testing.assert_array_equal(
        tlayers.kernel_of(tp, torch.float32).numpy(),
        np.asarray(jgpt._kernel_of(jp, jnp.float32)))


def _int8_pools(rng, B=3, Hkv=2, group=2, Dh=16, bs=4, NB=6, q_len=1):
    N = B * NB + 1
    scales = (0.5 + rng.random((2, N, Hkv))).astype(np.float32) / 127.0
    codes = rng.integers(-127, 128, (2, N, bs, Hkv, Dh)).astype(np.int8)
    q = rng.standard_normal((B, q_len, Hkv, group, Dh)).astype(np.float32)
    tables = rng.permutation(np.arange(1, N)).reshape(B, NB).astype(np.int32)
    lengths = np.array([1, 2 * bs + 1, bs * NB - q_len])[:B].astype(np.int32)
    return q, codes, scales, tables, lengths


@pytest.mark.parametrize("case", [dict(), dict(window=5), dict(q_len=3),
                                  dict(q_len=2, window=4, group=1, Hkv=4)])
def test_int8_paged_plain_matches_jax(case):
    """The int8-pool plain decode/verify against JAX's Pallas kernel in
    interpret mode and against JAX's gather reference, float32, 1e-5."""
    rng = np.random.default_rng(4)
    window = case.pop("window", None)
    q, codes, scales, tables, lengths = _int8_pools(rng, **case)
    scale = q.shape[-1] ** -0.5
    j = [jnp.asarray(a) for a in (codes[0], codes[1], tables, lengths)]
    t = [torch.from_numpy(a) for a in (codes[0], codes[1], tables, lengths)]
    kw = dict(scale=scale, window=window)
    jkw = dict(kw, k_scale=jnp.asarray(scales[0]),
               v_scale=jnp.asarray(scales[1]))
    tkw = dict(kw, k_scale=torch.from_numpy(scales[0]),
               v_scale=torch.from_numpy(scales[1]))
    if q.shape[1] == 1:
        got = tpaged.paged_decode_attention(torch.from_numpy(q[:, 0]), *t,
                                            **tkw).numpy()
        kern = jpaged.paged_decode_attention(jnp.asarray(q[:, 0]), *j,
                                             interpret=True, **jkw)
        ref = jpaged.paged_decode_reference(jnp.asarray(q[:, 0]), *j, **jkw)
    else:
        got = tpaged.paged_verify_attention(torch.from_numpy(q), *t,
                                            **tkw).numpy()
        kern = jpaged.paged_verify_attention(jnp.asarray(q), *j,
                                             interpret=True, **jkw)
        ref = jpaged.paged_verify_reference(jnp.asarray(q), *j, **jkw)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)


def test_paged_hbm_bytes_per_token_matches_jax():
    cfg = tgpt.preset("llama-7b")
    jcfg = jgpt.GPTConfig(**jgpt.PRESETS["llama-7b"])
    for dt_t, dt_j, sb in ((torch.bfloat16, jnp.bfloat16, 0),
                           (torch.int8, jnp.int8, 2 * 32 * 32 * 4)):
        assert tpaged.paged_hbm_bytes_per_token(
            cfg, 8, 855.75, dt_t, block_size=16, scale_bytes_per_block=sb) \
            == jpaged.paged_hbm_bytes_per_token(
                jcfg, 8, 855.75, 2048, dt_j, block_size=16,
                scale_bytes_per_block=sb)


@pytest.mark.parametrize("kw", [dict(num_blocks=7),
                                dict(hbm_budget_bytes=50_000),
                                dict()])
def test_int8_paged_cache_layout_matches_jax(kw):
    fields = dict(LLAMA)
    t = PagedKVCache(tgpt.GPTConfig(**fields, dtype=torch.float32),
                     num_slots=2, block_size=4, dtype=torch.float32,
                     device="cpu", kv_quant="int8", **kw)
    j = jpaged_cache.PagedKVCache(
        jgpt.GPTConfig(**fields, dtype=jnp.float32), num_slots=2,
        block_size=4, dtype=jnp.float32, kv_quant="int8", **kw)
    assert t.kv_quant == j.kv_quant == "int8"
    assert t.k.dtype == torch.int8 and t.v.dtype == torch.int8
    assert tuple(t.k.shape) == j.k.shape
    assert tuple(t.k_scale.shape) == j.k_scale.shape
    assert t.k_scale.dtype == torch.float32 and not t.k_scale.any()
    assert t.num_blocks == j.num_blocks
    assert t.bytes_per_token == j.bytes_per_token
    assert t.scale_bytes_per_block == j.scale_bytes_per_block
    t.allocate(0, 6)
    j.allocate(0, 6)
    assert t.used_block_bytes() == j.used_block_bytes()
    s = t.stats()
    assert s["pool_dtype"] == "int8"
    assert s["kv_bytes_per_token"] == t.bytes_per_token \
        + t.scale_bytes_per_block / 4
    off = PagedKVCache(tgpt.GPTConfig(**fields, dtype=torch.float32),
                       num_slots=2, block_size=4, dtype=torch.float32,
                       device="cpu", kv_quant="off", **kw)
    assert off.k_scale is None and off.k.dtype == torch.float32
    assert off.stats()["pool_dtype"] == "float32"


def test_params_from_numpy_carries_a_quantized_tree():
    jcfg = jgpt.GPTConfig(**LLAMA, dtype=jnp.float32,
                          use_flash_attention=False, remat=False)
    tcfg = tgpt.GPTConfig(**LLAMA, dtype=torch.float32)
    jq = jax.tree_util.tree_map(np.asarray, jengine.quantize_weights_int8(
        jax.tree_util.tree_map(jnp.asarray, numpy_params(jcfg))))
    tp = params_from_numpy(jq, tcfg, device="cpu", dtype=torch.bfloat16)
    qkv = tp["block"]["qkv"]
    assert qkv["q"].dtype == torch.int8 and qkv["scale"].dtype == torch.float32
    np.testing.assert_array_equal(qkv["q"].numpy(), jq["block"]["qkv"]["q"])
    np.testing.assert_array_equal(qkv["scale"].numpy(),
                                  jq["block"]["qkv"]["scale"])
    assert tp["lm_head"]["scale"].shape == (1, tcfg.vocab_size)
    # norm scales are not int8 scales: they take the working dtype
    assert tp["block"]["ln1"]["scale"].dtype == torch.bfloat16
    bad = jax.tree_util.tree_map(lambda a: a, jq)
    bad["block"]["qkv"]["scale"] = bad["block"]["qkv"]["scale"][:, 0]
    with pytest.raises(ValueError, match="int8 entry block/qkv/q"):
        params_from_numpy(bad, tcfg, device="cpu")

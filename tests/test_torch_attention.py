"""Parity of the port's attention ops (deepspeed_tpu_torch) with the JAX
package's Pallas kernels, on the CPU.

The same numpy inputs, made from a seed, go to the JAX kernel in
interpret mode (as the JAX package's own tests run it) and to the port's
function on CPU tensors, which is its plain PyTorch version. float32;
outputs to rtol/atol 1e-5 (the online softmax sums in another order than
the dense one), LSE to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import flash as jflash
from deepspeed_tpu.ops.attention import paged as jpaged
from deepspeed_tpu_torch.ops.attention import flash as tflash
from deepspeed_tpu_torch.ops.attention import paged as tpaged

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# flash attention forward (K1-fwd)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(),                                    # causal MHA
    dict(Hkv=2),                               # GQA
    dict(pad=True),                            # left-padded kv_mask
    dict(window=7, Hkv=1),                     # sliding window, MQA
    dict(causal=False),
])
def test_flash_matches_jax_kernel(devices, pallas_interpret, case):
    rng = np.random.default_rng(0)
    B, S, H, D = 2, 32, 4, 16
    Hkv = case.get("Hkv", H)
    causal = case.get("causal", True)
    q = rng.standard_normal((B, S, H, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    mask = None
    valid = np.ones((B, S), bool)
    if case.get("pad"):
        valid = np.arange(S)[None] >= np.array([0, 9])[:, None]
        mask = valid.astype(np.float32)
    window = case.get("window")
    o_j, lse_j = jflash.flash_block_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), causal=causal,
        block_q=16, block_kv=16, window=window)
    o_t, lse_t = tflash.flash_attention(
        _t(q), _t(k), _t(v), causal=causal,
        kv_mask=None if mask is None else _t(mask), window=window)
    assert o_t.shape == (B, S, H, D) and lse_t.shape == (B, H, S)
    # rows with no valid key are garbage by contract
    np.testing.assert_allclose(o_t.numpy()[valid], np.asarray(o_j)[valid],
                               **TOL)
    if not case:    # the public entry point, through the same kernel
        o_full = jflash.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            block_q=16, block_kv=16)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_full), **TOL)
    np.testing.assert_allclose(lse_t.numpy().transpose(0, 2, 1)[valid],
                               np.asarray(lse_j).transpose(0, 2, 1)[valid],
                               **TOL)


def test_flash_plain_matches_jax_reference(devices):
    """The port's plain version is the JAX package's mha_reference."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 12, 4, 8), np.float32)
    k = rng.standard_normal((1, 12, 2, 8), np.float32)
    v = rng.standard_normal((1, 12, 2, 8), np.float32)
    ref = jflash.mha_reference(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, window=5)
    out, _ = tflash.mha_reference(_t(q), _t(k), _t(v), causal=True, window=5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_flash_rejects_bad_arguments():
    q = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="kv head counts"):
        tflash.flash_attention(q, torch.zeros(1, 4, 3, 8),
                               torch.zeros(1, 4, 3, 8))
    with pytest.raises(ValueError, match="causal"):
        tflash.flash_attention(q, q, q, causal=False, window=2)


# ---------------------------------------------------------------------------
# paged decode / verify (K3)
# ---------------------------------------------------------------------------

def _pool_problem(seed=0, B=3, Hkv=2, group=2, Dh=32, bs=8, NB=4, G=None):
    """Random pools + distinct block tables (trash block 0 kept out) +
    lengths at a partial block, a mid block and the last slot of the last
    block (mirrors tests/test_paged_attention.py)."""
    rng = np.random.default_rng(seed)
    N = B * NB + 1
    qshape = (B, Hkv, group, Dh) if G is None else (B, G, Hkv, group, Dh)
    q = rng.standard_normal(qshape).astype(np.float32)
    kp = rng.standard_normal((N, bs, Hkv, Dh)).astype(np.float32)
    vp = rng.standard_normal((N, bs, Hkv, Dh)).astype(np.float32)
    tables = rng.permutation(np.arange(1, N)).reshape(B, NB).astype(np.int32)
    last = bs * NB - (1 if G is None else G)
    lengths = np.array([bs // 2, bs * 2 + 1, last], np.int32)
    return q, kp, vp, tables, lengths


def _jax_and_port(fn_j, fn_t, q, kp, vp, tables, lengths, **kw):
    out_j = fn_j(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                 jnp.asarray(tables), jnp.asarray(lengths), **kw)
    out_t = fn_t(_t(q), _t(kp), _t(vp), _t(tables), _t(lengths), **kw)
    return np.asarray(out_j), out_t.numpy()


@pytest.mark.parametrize("case", [
    dict(), dict(window=9), dict(Hkv=4, group=1), dict(Hkv=1, group=4),
    dict(Hkv=1, group=1, window=3)])
def test_paged_decode_matches_jax_kernel(devices, pallas_interpret, case):
    window = case.pop("window", None)
    prob = _pool_problem(**case)
    out_j, out_t = _jax_and_port(
        jpaged.paged_decode_attention, tpaged.paged_decode_attention, *prob,
        scale=prob[0].shape[-1] ** -0.5, window=window)
    assert out_t.shape == prob[0].shape
    np.testing.assert_allclose(out_t, out_j, **TOL)


@pytest.mark.parametrize("window", [None, 6])
def test_paged_verify_matches_jax_kernel(devices, pallas_interpret, window):
    prob = _pool_problem(G=3, group=2)
    out_j, out_t = _jax_and_port(
        jpaged.paged_verify_attention, tpaged.paged_verify_attention, *prob,
        scale=0.2, window=window)
    assert out_t.shape == prob[0].shape
    np.testing.assert_allclose(out_t, out_j, **TOL)


def test_paged_decode_ignores_stale_blocks():
    """Positions past lengths[b] never contribute: poisoning every pool
    slot beyond each slot's length leaves the output bit-identical."""
    q, kp, vp, tables, lengths = _pool_problem()
    out = tpaged.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                        _t(lengths), scale=0.25)
    bs = kp.shape[1]
    kp2, vp2 = kp.copy(), vp.copy()
    for b in range(tables.shape[0]):
        for j in range(tables.shape[1]):
            for s in range(bs):
                if j * bs + s > lengths[b]:
                    kp2[tables[b, j], s] = 1e4
                    vp2[tables[b, j], s] = -1e4
    out2 = tpaged.paged_decode_attention(_t(q), _t(kp2), _t(vp2), _t(tables),
                                         _t(lengths), scale=0.25)
    assert torch.equal(out, out2)


def test_paged_hbm_bytes_matches_jax(devices):
    """The kernel's bytes per decoded token are the Pallas kernel's."""
    from deepspeed_tpu.models import gpt as jgpt
    from deepspeed_tpu_torch.models import gpt as tgpt
    for name in ("llama-tiny", "llama-7b"):
        jcfg, tcfg = jgpt.preset(name), tgpt.preset(name)
        for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                         (torch.float32, jnp.float32)):
            assert tpaged.paged_hbm_bytes_per_token(tcfg, 8, 100.5, tdt) == \
                jpaged.paged_hbm_bytes_per_token(jcfg, 8, 100.5, 256, jdt,
                                                 impl="pallas")

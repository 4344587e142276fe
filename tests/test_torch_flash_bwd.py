"""Parity of the port's flash-attention backward and segment ids with the
JAX package's Pallas kernels, on the CPU.

The same numpy inputs, made from a seed, go to the JAX kernels in
interpret mode (block sizes 16, as the JAX package's own tests run them)
and to the port's functions on CPU tensors, which are the plain PyTorch
versions of the CUDA kernels. float32, rtol/atol 1e-5: the Pallas kernels
accumulate tile by tile, the plain versions in one dense product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import flash as jflash
from deepspeed_tpu_torch.ops.attention import flash as tflash

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, H, D = 2, 32, 4, 16


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _segments():
    """Two packed rows: documents of unequal lengths, the second row with
    a padding tail (segment -1), as ``pack_documents`` emits."""
    return np.stack([np.repeat([0, 1, 2], [10, 15, 7]),
                     np.repeat([0, 1, -1], [20, 9, 3])]).astype(np.int32)


CASES = {
    "causal-mha": dict(),
    "gqa2": dict(Hkv=2),
    "mqa": dict(Hkv=1),
    "left-pad": dict(pad=True),
    "window": dict(window=7),
    "segments": dict(segs=True),
    "segments-window-gqa": dict(segs=True, window=9, Hkv=2),
    "non-causal": dict(causal=False),
}


def _problem(case, seed=0):
    rng = np.random.default_rng(seed)
    Hkv = case.get("Hkv", H)
    q = rng.standard_normal((B, S, H, D), np.float32)
    k = rng.standard_normal((B, S, Hkv, D), np.float32)
    v = rng.standard_normal((B, S, Hkv, D), np.float32)
    do = rng.standard_normal((B, S, H, D), np.float32)
    valid = np.ones((B, S), bool)
    mask = None
    if case.get("pad"):
        valid = np.arange(S)[None] >= np.array([0, 9])[:, None]
        mask = valid.astype(np.float32)
        # rows with no valid key are garbage by contract; the loss masks
        # them, so their output gradient is zero
        do = do * valid[:, :, None, None]
    segs = _segments() if case.get("segs") else None
    return q, k, v, do, mask, segs, valid


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_pallas_kernels(devices, pallas_interpret,
                                               name):
    """``flash_attention_bwd_reference`` (the formulas K2-dq and K2-dkv
    implement) against the Pallas dq and dkv kernels, from the Pallas
    forward's own ``o`` and ``lse``."""
    case = CASES[name]
    q, k, v, do, mask, segs, valid = _problem(case)
    causal, window = case.get("causal", True), case.get("window")
    jkw = dict(causal=causal, block_q=16, block_kv=16, window=window)
    jmask = None if mask is None else jnp.asarray(mask)
    jsegs = None if segs is None else jnp.asarray(segs)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    o, lse = jflash.flash_block_fwd(jq, jk, jv, jmask, jsegs, jsegs, **jkw)
    want = jflash.flash_block_bwd(jq, jk, jv, jnp.asarray(do), o, lse, jmask,
                                  jsegs, jsegs, **jkw)
    got = tflash.flash_attention_bwd(
        _t(q), _t(k), _t(v), _t(o), _t(lse), _t(do), causal=causal,
        kv_mask=None if mask is None else _t(mask), window=window,
        segment_ids=None if segs is None else _t(segs))
    for g, w, shape in zip(got, want, (q.shape, k.shape, v.shape)):
        assert tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("name", ["segments", "segments-window-gqa"])
def test_forward_with_segments_matches_pallas_kernel(devices,
                                                     pallas_interpret, name):
    case = CASES[name]
    q, k, v, _, _, segs, _ = _problem(case, seed=1)
    o_j, lse_j = jflash.flash_block_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
        jnp.asarray(segs), jnp.asarray(segs), causal=True, block_q=16,
        block_kv=16, window=case.get("window"))
    o_t, lse_t = tflash.flash_attention(
        _t(q), _t(k), _t(v), window=case.get("window"),
        segment_ids=_t(segs))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)


@pytest.mark.parametrize("name", ["causal-mha", "segments-window-gqa"])
def test_autograd_matches_jax_grad(devices, pallas_interpret, name):
    """``torch.autograd.grad`` through ``FlashAttention`` (plain forward,
    plain backward formulas) against ``jax.grad`` through the JAX
    package's ``flash_attention`` (its custom VJP over the Pallas
    kernels), for a plain and a packed case."""
    case = CASES[name]
    q, k, v, w, _, segs, _ = _problem(case, seed=2)
    window = case.get("window")
    jsegs = None if segs is None else jnp.asarray(segs)

    def jloss(q, k, v):
        o = jflash.flash_attention(q, k, v, causal=True, block_q=16,
                                   block_kv=16, window=window,
                                   segment_ids=jsegs)
        return (o * jnp.asarray(w)).sum()
    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    o, lse = tflash.flash_attention(
        tq, tk, tv, window=window,
        segment_ids=None if segs is None else _t(segs))
    assert not lse.requires_grad
    got = torch.autograd.grad((o * _t(w)).sum(), (tq, tk, tv))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)


def test_known_output_skips_the_forward_and_keeps_the_gradient():
    """``known=(o, lse)`` (what a checkpointed layer keeps) returns the
    kept pair and differentiates as the fresh forward does."""
    q, k, v, w, _, segs, _ = _problem(CASES["segments"], seed=3)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    o, lse = tflash.flash_attention(tq, tk, tv, segment_ids=_t(segs))
    want = torch.autograd.grad((o * _t(w)).sum(), (tq, tk, tv))
    o2, _ = tflash.flash_attention(tq, tk, tv, segment_ids=_t(segs),
                                   known=(o.detach(), lse.detach()))
    assert torch.equal(o2, o)
    got = torch.autograd.grad((o2 * _t(w)).sum(), (tq, tk, tv))
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)


def test_segment_ids_need_self_attention():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="self-attention"):
        tflash.flash_attention(q, torch.zeros(1, 6, 2, 8),
                               torch.zeros(1, 6, 2, 8), causal=False,
                               segment_ids=torch.zeros(1, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\[B, S\]"):
        tflash.flash_attention(q, q, q,
                               segment_ids=torch.zeros(1, 5, dtype=torch.int32))

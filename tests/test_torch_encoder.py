"""Encoder inference: ``init_inference(model=(BertConfig, params))``
against the JAX package's encoder engine on the CPU.

The forward is ``bert.encode`` deterministic and unmasked, then the MLM
logits through the tied word embedding when the tree has ``mlm``, else
the hidden states; float32, rtol/atol 1e-5. The refusals (weight-only
int8, the decoding entry points) raise what JAX raises, with its text.
Parameters are seeded numpy draws (``test_torch_bert.numpy_params``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import engine as jengine
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.models.convert import params_from_numpy
from test_torch_bert import configs, numpy_params
from test_torch_model import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def trees():
    """(JAX config, port config, numpy tree with the MLM head, without);
    the port's config says bfloat16, which the float32 engine replaces."""
    jcfg, tcfg = configs()
    npp = numpy_params(jcfg, seed=2)
    return (jcfg, dataclasses.replace(tcfg, dtype=torch.bfloat16), npp,
            {k: v for k, v in npp.items() if k != "mlm"})


def _pair(trees, npp):
    """The two float32 engines over ``npp``."""
    jcfg, tcfg = trees[:2]
    jeng = jengine.InferenceEngine(
        config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, npp),
        dtype=jnp.float32)
    # converted whole (the converter checks every leaf), then cut as npp
    tp = params_from_numpy(trees[2], tcfg, device="cpu")
    teng = init_inference(model=(tcfg, {k: tp[k] for k in npp}),
                          dtype=torch.float32, device="cpu")
    return jeng, teng


@pytest.mark.parametrize("head", ["mlm", "hidden"])
def test_encoder_forward_matches_jax(trees, head):
    """MLM logits [B, S, V] with the head, hidden states [B, S, d]
    without; ``forward`` and ``__call__`` alike, the time in
    ``latency_ms``; the config's dtype replaced by the engine's."""
    npp = trees[2] if head == "mlm" else trees[3]
    jeng, teng = _pair(trees, npp)
    assert teng.is_encoder and jeng.is_encoder
    assert teng.cfg.dtype == torch.float32
    assert trees[1].dtype == torch.bfloat16          # the caller's, as given
    tokens = np.random.default_rng(3).integers(1, 97, (2, 40)).astype(
        np.int32)
    want = np.asarray(jeng.forward(tokens))
    got = teng.forward(tokens)
    assert got.shape == want.shape == ((2, 40, 97) if head == "mlm"
                                       else (2, 40, 64))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(teng(tokens).numpy(), got.numpy())
    assert teng.latency_ms["forward"] > 0


def test_encoder_refuses_int8_and_decoding_as_jax(trees):
    """Weight-only int8 raises ``ValueError`` and every decoding entry
    point ``NotImplementedError``, each with the JAX engine's text."""
    jcfg, tcfg, npp = trees[:3]
    with pytest.raises(ValueError) as jerr:
        jengine.InferenceEngine(
            config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, npp),
            dtype=jnp.int8)
    with pytest.raises(ValueError) as terr:
        init_inference(model=(tcfg, params_from_numpy(npp, tcfg,
                                                      device="cpu")),
                       dtype=torch.int8, device="cpu")
    assert str(terr.value) == str(jerr.value)
    jeng, teng = _pair(trees, npp)
    tokens = np.ones((1, 8), np.int32)
    with pytest.raises(NotImplementedError) as jerr:
        jeng.generate(tokens, max_new_tokens=2)
    for call in (lambda: teng.generate(tokens, max_new_tokens=2),
                 lambda: teng.generate_fused(tokens, max_new_tokens=2),
                 lambda: teng.decode_slots(None, None, None, None, tokens,
                                           None)):
        with pytest.raises(NotImplementedError) as terr:
            call()
        assert str(terr.value) == str(jerr.value)

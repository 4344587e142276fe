"""Head dims 72 and 96 (gpt2-4b's and gpt2-8b's widths) and K3's float16
mode over int8 pools, held to the JAX package on the CPU.

On the card these widths run in their own kernel builds (72 in 80-wide
tensor-core tiles whose last columns are zero-filled); on the CPU every
kernel takes its plain version, so these tests hold the port's model,
serving and training code at those widths to JAX: greedy serving streams
identical in float32 in both pool modes with speculation on, and a
training step's loss and every gradient leaf to rtol/atol 1e-5 at 72.
The wrappers' padding of a head dim between two built widths is held to
the plain version at the unpadded width. Float16 over int8 pools is held
in the terms of ``tests/test_torch_api.py``'s float16 test (its
``FP16_TOL`` on a parting's top-2 margin). Every JAX engine uses the
``SERVE_KW`` geometry and one ``spec_k``, so each slot program compiles
once per pool mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import engine as jengine
from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import (params_from_numpy,
                                                params_to_numpy)
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.attention import flash, paged
from deepspeed_tpu_torch.runtime import dataloader as tdata
from test_torch_api import LLAMA, _assert_streams_agree, engines
from test_torch_model import numpy_params, one_torch_thread  # noqa: F401
from test_torch_serving import SERVE_KW
from test_torch_spec_decode import repeating_prompts
from test_torch_train import _docs, _leaves, _torch_loss_and_grads

TOL = dict(rtol=1e-5, atol=1e-5)
SPEC_K = 3
# gpt2-4b's head dim (2304 / 32) and gpt2-8b's (3072 / 32), at two heads
WIDTHS = {72: dict(vocab_size=64, n_layers=1, n_heads=2, d_model=144,
                   max_seq_len=48),
          96: dict(vocab_size=64, n_layers=1, n_heads=2, d_model=192,
                   max_seq_len=48)}


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def width_pair(request):
    """(JAX engine, port engine, fields) at one head dim, float32."""
    fields = WIDTHS[request.param]
    jcfg = jgpt.GPTConfig(**fields, dtype=jnp.float32,
                          use_flash_attention=False, remat=False)
    tcfg = tgpt.GPTConfig(**fields, dtype=torch.float32)
    assert tcfg.head_dim == request.param
    npp = numpy_params(jcfg)
    jeng = jengine.InferenceEngine(
        config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, npp),
        dtype=jnp.float32)
    teng = init_inference(model=(tcfg, params_from_numpy(npp, tcfg,
                                                         device="cpu")),
                          dtype=torch.float32, device="cpu")
    return jeng, teng, fields


def _serve(mod, eng, prompts, kv_quant):
    srv = mod.ServingEngine(eng, spec_decode=True, spec_k=SPEC_K,
                            kv_quant=kv_quant, **SERVE_KW)
    out = srv.run([mod.ServeRequest(rid=i, prompt=p, max_new_tokens=10)
                   for i, p in enumerate(prompts)])
    return out, srv.stats


@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_greedy_spec_streams_match_jax(width_pair, kv_quant):
    """Speculative greedy serving at head dims 72 and 96 in both pool
    modes: every stream and the speculation counters as in JAX."""
    jeng, teng, fields = width_pair
    prompts = repeating_prompts((12, 9, 14, 7), fields["vocab_size"])
    (jout, jstats), (tout, tstats) = (
        _serve(mod, eng, prompts, kv_quant)
        for mod, eng in ((jserving, jeng), (tserving, teng)))
    assert tstats["spec_steps"] > 0
    for key in ("spec_steps", "spec_proposed", "spec_accepted",
                "decode_steps", "completed"):
        assert tstats[key] == jstats[key], key
    for i in range(len(prompts)):
        np.testing.assert_array_equal(tout[i], jout[i])


def test_training_step_matches_jax_at_72():
    """A training step's loss and every gradient leaf at head dim 72,
    float32, two layers over documents packed with segment ids and
    positions."""
    fields = dict(WIDTHS[72], n_layers=2)
    jcfg = jgpt.GPTConfig(**fields, dtype=jnp.float32, remat=False,
                          use_flash_attention=False)
    tcfg = tgpt.GPTConfig(**fields, dtype=torch.float32)
    assert tcfg.head_dim == 72
    npp = numpy_params(jcfg, seed=4)
    rng = np.random.default_rng(5)
    batch = tdata.pack_documents(_docs(rng, vocab=64), 17)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jgpt.loss_fn(p, jbatch, jax.random.PRNGKey(0), jcfg)))(npp)
    tloss, tgrads = _torch_loss_and_grads(tcfg, npp, batch)
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    want, got = _leaves(jgrads), _leaves(params_to_numpy(tgrads))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


@pytest.mark.parametrize("D", [40, 20, 136])
def test_wrappers_pad_to_the_built_widths(D):
    """A head dim between two built widths runs in the next width's
    run-time head dim build (40 in 64's), which zero-fills the columns
    past it in its tiles; one that is not a multiple of 8 is first
    zero-padded by the wrapper to the next multiple (20 to 24, in 32's),
    with the scale of the true head dim; above 128 the kernels raise. On
    the CPU the zero-filled problem's plain version, at the build's width,
    must give the unpadded one's output, which is what the card
    computes."""
    if D > _build.HEAD_DIMS[-1]:
        with pytest.raises(ValueError, match="up to 128"):
            _build.head_dim_build(D)
        return
    Dk, W, runtime = _build.head_dim_build(D)
    assert (Dk, W, runtime) == {40: (40, 64, True), 20: (24, 32, True)}[D]
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 20, h, D),
                                                    np.float32))
               for h in (4, 2, 2))
    want, lse = flash.mha_reference(q, k, v, window=7)
    got, lse_p = flash.mha_reference(
        *(flash.pad_head_dim(t, W) for t in (q, k, v)), window=7,
        scale=D ** -0.5)
    torch.testing.assert_close(got[..., :D], want, **TOL)
    assert float(got[..., D:].abs().max()) == 0.0
    torch.testing.assert_close(lse_p, lse, **TOL)
    pool = torch.from_numpy(rng.standard_normal((9, 4, 2, D), np.float32))
    tables = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    lengths = torch.tensor([5, 13], dtype=torch.int32)
    qd = q[:, :1].reshape(2, 2, 2, D)
    want = paged.paged_decode_reference(qd, pool, pool.flip(0), tables,
                                        lengths, scale=D ** -0.5)
    pad = [flash.pad_head_dim(t, W) for t in (qd, pool, pool.flip(0))]
    got = paged.paged_decode_reference(*pad, tables, lengths,
                                       scale=D ** -0.5)
    torch.testing.assert_close(got[..., :D], want, **TOL)


@pytest.fixture(scope="module")
def fp16_pair():
    return engines(LLAMA, jnp.float16, torch.float16)


def test_float16_int8_pool_streams_match_jax(fp16_pair):
    """``init_inference(dtype=float16)`` served over int8 pools (K3's
    float16 mode over int8 pools on the card): every greedy stream agrees
    with the JAX engine's, identical or parted at a near-tie of the port's
    float16 logits, and the pools hold int8 codes."""
    jeng, teng = fp16_pair
    r = np.random.default_rng(3)
    prompts = [r.integers(1, LLAMA["vocab_size"], n).astype(np.int32)
               for n in (9, 14, 5, 20)]
    outs = []
    for mod, eng in ((jserving, jeng), (tserving, teng)):
        srv = mod.ServingEngine(eng, kv_quant="int8", **SERVE_KW)
        outs.append(srv.run([mod.ServeRequest(rid=i, prompt=p,
                                              max_new_tokens=10)
                             for i, p in enumerate(prompts)]))
    assert srv.cache.k.dtype == torch.int8
    partings = [_assert_streams_agree(teng, p, outs[1][i], outs[0][i],
                                      len(p))
                for i, p in enumerate(prompts)]
    # reported, not asserted: where (if anywhere) a stream parted
    print(f"float16 over int8 pools, partings: {partings}")

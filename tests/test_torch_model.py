"""Parity of the port's model pieces (deepspeed_tpu_torch.models) with the
JAX package on the CPU: rotary, the norms, one transformer block, the
parameter shapes and the pytree conversion.

Inputs and parameters are numpy arrays made from a seed; JAX parameters
reach the port through ``params_from_numpy``. float32, rtol/atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import engine as jengine
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.ops.attention import rotary as jrotary
from deepspeed_tpu_torch.inference import engine as tengine
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.ops.attention import rotary as trotary

TOL = dict(rtol=1e-5, atol=1e-5)

# a gpt2-dialect tiny config (layernorm, gelu, learned positions, tied
# head, biases), llama-tiny (rmsnorm, swiglu, rotary, GQA, untied) with a
# sliding window, and a GPT-J-style parallel-residual rotary config
CONFIGS = {
    "gpt2": dict(vocab_size=128, n_layers=2, n_heads=4, d_model=32,
                 max_seq_len=64),
    "llama": dict(jgpt.PRESETS["llama-tiny"], n_layers=2, attn_window=6),
    "gptj": dict(vocab_size=96, n_layers=2, n_heads=4, d_model=32,
                 max_seq_len=64, rotary_dim=4, use_wpe=False,
                 parallel_residual=True, tie_embeddings=False),
}


def configs(name):
    fields = CONFIGS[name]
    jcfg = jgpt.GPTConfig(**fields, dtype=jnp.float32,
                          use_flash_attention=False, remat=False)
    return jcfg, tgpt.GPTConfig(**fields, dtype=torch.float32)


def _jax_block_fn(x, p, kv_mask, positions, *, name):
    return jengine._block_prefill(x, p, configs(name)[0], kv_mask=kv_mask,
                                  positions=positions)


# compiled once per (config, mask) instead of dispatched op by op
_jax_block = jax.jit(_jax_block_fn, static_argnames=("name",))


def numpy_params(jcfg, seed=0):
    """The JAX parameter tree's shapes (traced, not computed) filled with
    seeded numpy draws: normal(0, 0.02) leaves, norm scales around 1."""
    shapes = jax.eval_shape(lambda key: jgpt.init_params(key, jcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        base = 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else 0.0
        return (base + 0.02 * rng.standard_normal(s.shape)).astype(s.dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_rotary_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 5, 4, 16), np.float32)
    k = rng.standard_normal((2, 5, 2, 16), np.float32)
    for pos in (np.arange(3, 8), rng.integers(0, 300, (2, 5))):
        for rd in (16, 8):
            jq, jk = jrotary.apply_rotary(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(pos), rd, base=500.0)
            tq, tk = trotary.apply_rotary(torch.from_numpy(q),
                                          torch.from_numpy(k),
                                          torch.from_numpy(pos), rd,
                                          base=500.0)
            np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_norm_matches_jax(name):
    jcfg, tcfg = configs(name)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, jcfg.d_model), np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(jcfg.d_model).astype(np.float32)}
    if jcfg.norm == "layernorm":
        p["bias"] = rng.standard_normal(jcfg.d_model).astype(np.float32)
    ref = jgpt._norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                     jcfg)
    out = tgpt._norm(torch.from_numpy(x),
                     {k: torch.from_numpy(v) for k, v in p.items()}, tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name", ["gpt2", "llama", "gptj"])
def test_block_matches_jax(devices, name):
    """One prefill block (attention through the flash op's plain version,
    the MLP, both residual styles), with and without a left-pad mask."""
    jcfg, tcfg = configs(name)
    npp = numpy_params(jcfg)
    tp = params_from_numpy(npp, tcfg, device="cpu")
    rng = np.random.default_rng(2)
    B, S = 2, 12
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    mask = (np.arange(S)[None] >= np.array([0, 4])[:, None]).astype(np.float32)
    pos = np.clip(np.cumsum(mask, 1) - 1, 0, None).astype(np.int32)
    jlayer = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), npp["block"])
    for m, ps in ((None, None), (mask, pos)):
        y_j, k_j, v_j = _jax_block(
            jnp.asarray(x), jlayer, None if m is None else jnp.asarray(m),
            None if ps is None else jnp.asarray(ps), name=name)
        y_t, k_t, v_t = tengine._block_prefill(
            torch.from_numpy(x), tgpt.layer(tp, 0), tcfg,
            kv_mask=None if m is None else torch.from_numpy(m),
            positions=None if ps is None else torch.from_numpy(ps).long())
        valid = np.ones((B, S), bool) if m is None else m > 0
        np.testing.assert_allclose(y_t.numpy()[valid],
                                   np.asarray(y_j)[valid], **TOL)
        np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), **TOL)
        np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), **TOL)


@pytest.mark.parametrize("name", ["gpt2", "llama", "gptj"])
def test_init_params_shapes_and_conversion(name):
    """init_params builds the JAX tree's shapes; params_from_numpy keeps
    every leaf and checks shapes."""
    jcfg, tcfg = configs(name)
    npp = numpy_params(jcfg)
    mine = tgpt.init_params(tcfg, seed=3, device="cpu")
    flat_j = {jax.tree_util.keystr(kp): a.shape for kp, a in
              jax.tree_util.tree_flatten_with_path(npp)[0]}
    flat_t = {jax.tree_util.keystr(kp): tuple(t.shape) for kp, t in
              jax.tree_util.tree_flatten_with_path(mine)[0]}
    assert flat_t == flat_j
    assert tgpt.num_params(tcfg) == jgpt.num_params(jcfg)
    assert tgpt.kv_bytes_per_token(tcfg, torch.bfloat16) == \
        jgpt.kv_bytes_per_token(jcfg, jnp.bfloat16)
    conv = params_from_numpy(npp, tcfg, device="cpu", dtype=torch.bfloat16)
    assert conv["block"]["qkv"]["kernel"].dtype == torch.bfloat16
    bad = dict(npp, ln_f={"scale": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="ln_f/scale"):
        params_from_numpy(bad, tcfg, device="cpu")


def test_init_params_scales():
    """normal(0.02) weights and normal(0.02/sqrt(2L)) residual outputs."""
    cfg = tgpt.GPTConfig(vocab_size=256, n_layers=8, n_heads=4, d_model=128)
    p = tgpt.init_params(cfg, seed=0, device="cpu")
    assert abs(p["block"]["qkv"]["kernel"].std().item() - 0.02) < 1e-3
    resid = 0.02 / np.sqrt(16)
    assert abs(p["block"]["mlp_out"]["kernel"].std().item() - resid) < 3e-4
    assert torch.equal(p["ln_f"]["scale"], torch.ones(128))
    again = tgpt.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(p["wte"]["embedding"], again["wte"]["embedding"])


def test_entry_points_take_cpu_explicitly():
    cfg = tgpt.preset("llama-tiny", n_layers=1)
    p = tgpt.init_params(cfg, seed=0, device="cpu")
    assert p["wte"]["embedding"].device.type == "cpu"
    assert tgpt.decode_geometry(cfg, 16) == (16, 256)

"""The public entry points the port's engines share with the JAX package,
held against it on the CPU in float32: the inference engine's
whole-sequence ``forward`` (and ``__call__``), ``generate_fused`` (the
decode loop as one program: a CUDA graph on the card, the same loop
eagerly here), ``latency_ms`` and ``sync``; and the small methods
``DeepSpeedEngine.__call__``, ``zero_optimization()``,
``DeepSpeedConfig.print_config`` and ``FlightRecorder.add_section``.

The engines get the same numpy parameters (``numpy_params``); the JAX
engine runs its plain attention (no Pallas kernel on the CPU).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import engine as jengine
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.telemetry import flight as jflight
from deepspeed_tpu.utils.logging import logger as jlogger
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.telemetry import flight as tflight
from deepspeed_tpu_torch.utils.logging import logger as tlogger
from test_torch_model import numpy_params, one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
# llama-tiny cut to two layers: rotary, GQA, a sliding window
LLAMA = dict(jgpt.PRESETS["llama-tiny"], n_layers=2, attn_window=8,
             max_seq_len=48)
GPT2 = dict(vocab_size=96, n_layers=2, n_heads=4, d_model=32, max_seq_len=32)


@pytest.fixture(scope="module")
def pair(devices):
    """(JAX engine, port engine) over the same float32 parameters."""
    jcfg = jgpt.GPTConfig(**LLAMA, dtype=jnp.float32,
                          use_flash_attention=False, remat=False)
    tcfg = tgpt.GPTConfig(**LLAMA, dtype=torch.float32)
    npp = numpy_params(jcfg)
    jeng = jengine.InferenceEngine(
        config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, npp),
        dtype=jnp.float32)
    teng = init_inference(model=(tcfg, params_from_numpy(npp, tcfg,
                                                         device="cpu")),
                          dtype=torch.float32, device="cpu")
    return jeng, teng


def prompts(V, B=3, S=9, seed=5):
    return np.random.default_rng(seed).integers(1, V, (B, S)).astype(np.int32)


LEFT_PAD = (np.arange(9)[None] >= np.array([0, 3, 5])[:, None]).astype(
    np.float32)


def test_forward_logits_match_jax(pair):
    """Full-sequence logits [B, S, V] to 1e-5; ``eng(tok)`` is
    ``eng.forward(tok)``; each engine times it into ``latency_ms``."""
    jeng, teng = pair
    tok = prompts(teng.cfg.vocab_size)
    jl = np.asarray(jeng.forward(tok))
    tl = teng.forward(tok)
    assert tuple(tl.shape) == jl.shape == (3, 9, teng.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), jl, **TOL)
    assert torch.equal(teng(tok), tl)
    assert "forward" in teng.latency_ms and "forward" in jeng.latency_ms
    assert teng.latency_ms["forward"] > 0


@pytest.mark.parametrize("masked", [False, True], ids=["unpadded",
                                                       "left-padded"])
def test_generate_fused_greedy_matches_generate_and_jax(pair, masked):
    """Greedy ``generate_fused`` gives the port's ``generate`` tokens and
    JAX's ``generate_fused`` tokens, with and without a left-padding
    mask, on the first call of a key and on a second one (the kept
    buffers); after each call the engines hold the same ``latency_ms``
    keys."""
    jeng, teng = pair
    mask = LEFT_PAD if masked else None
    tok = prompts(teng.cfg.vocab_size, seed=5)
    for eng in (teng, jeng):
        eng.latency_ms.clear()
        eng.generate(tok, max_new_tokens=7, attention_mask=mask)
    assert set(teng.latency_ms) == set(jeng.latency_ms) == {
        "prefill", "decode_per_token"}
    for seed in (6, 7):
        tok = prompts(teng.cfg.vocab_size, seed=seed)
        want = teng.generate(tok, max_new_tokens=7, attention_mask=mask)
        got = teng.generate_fused(tok, max_new_tokens=7, attention_mask=mask)
        jgot = jeng.generate_fused(tok, max_new_tokens=7, attention_mask=mask)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(jgot))
        assert got.shape == (3, 16) and got.dtype == np.int32
        assert {"prefill", "fused_generate_compile",
                "decode_per_token_fused"} <= set(teng.latency_ms)
        assert set(teng.latency_ms) == set(jeng.latency_ms)
    # one new token: no decode loop, as in JAX
    one = teng.generate_fused(tok, max_new_tokens=1, attention_mask=mask)
    np.testing.assert_array_equal(one, want[:, :10])


def test_generate_fused_sampled_equals_generate(devices):
    """Sampled ``generate_fused`` draws the port's ``generate`` noise
    (``sampling.gumbel_noise`` by seed and position) into its buffer, so
    the tokens are the same, across seeds and top-k; the JAX sampler's
    bits are not the port's (no threefry in torch)."""
    cfg = tgpt.GPTConfig(**GPT2, dtype=torch.float32)
    eng = init_inference(model=(cfg, tgpt.init_params(cfg, seed=3,
                                                       device="cpu")),
                         dtype=torch.float32, device="cpu")
    tok = prompts(cfg.vocab_size, B=2, S=6, seed=8)
    for seed, top_k in ((0, 0), (1, 5), (2, 5)):
        kw = dict(max_new_tokens=9, temperature=0.9, top_k=top_k, seed=seed)
        np.testing.assert_array_equal(eng.generate_fused(tok, **kw),
                                      eng.generate(tok, **kw))
    # one key for each top_k (the temperature is the same): two sets of
    # buffers
    assert len(eng._fused) == 2


def test_sync_waits_on_device_values_only(pair):
    """``sync`` takes tensors and trees of them; on the host it has
    nothing to wait for."""
    _, teng = pair
    x = torch.ones(2)
    assert teng.sync() is None
    assert teng.sync(x, {"a": [x, (x,)]}, None, 3) is None


def test_training_engine_call_and_zero_flag_match_jax(devices):
    """``engine(batch)`` is the evaluation loss, as JAX's ``__call__``;
    ``zero_optimization()`` is whether a ZeRO stage is on, in both
    packages, at stages 0 and 1."""
    jcfg = jgpt.GPTConfig(**GPT2, dtype=jnp.float32)
    tcfg = tgpt.GPTConfig(**GPT2, dtype=torch.float32)
    npp = numpy_params(jcfg, seed=4)
    batch = {"tokens": np.random.default_rng(9).integers(
        0, 96, (16, 17)).astype(np.int32)}
    for stage in (0, 1):
        config = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
                  "zero_optimization": {"stage": stage},
                  "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
        teng = deepspeed_tpu_torch.initialize(
            model=tgpt.make_loss_fn(tcfg),
            model_parameters=params_from_numpy(npp, tcfg, device="cpu"),
            config=dict(config), device="cpu")[0]
        jeng = deepspeed_tpu.initialize(model=jgpt.make_loss_fn(jcfg),
                                        model_parameters=npp,
                                        config=dict(config))[0]
        assert teng.zero_optimization() == jeng.zero_optimization() \
            == (stage > 0)
        if stage == 0:
            np.testing.assert_allclose(float(teng(batch)), float(jeng(batch)),
                                       rtol=1e-5)
            assert float(teng(batch)) == float(teng.forward(batch))


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_print_config_logs_the_jax_lines():
    """``print_config`` logs the name and the sorted, indented config, the
    same lines in both packages, with the default name and another."""
    config = {"train_batch_size": 8, "gradient_accumulation_steps": 2,
              "bf16": {"enabled": True},
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    logged = []
    for cls, log in ((tconfig.DeepSpeedConfig, tlogger),
                     (jconfig.DeepSpeedConfig, jlogger)):
        h = _Lines()
        log.addHandler(h)
        try:
            cfg = cls(dict(config))
            cfg.print_config()
            cfg.print_config("engine")
        finally:
            log.removeHandler(h)
        logged.append(h.lines)
    assert logged[0] == logged[1]
    assert logged[0][0] == "DeepSpeedTPUConfig:" and logged[0][2] == "engine:"
    assert '"train_batch_size": 8' in logged[0][1]


def test_flight_add_section_matches_jax(tmp_path):
    """``add_section`` adds (or replaces) a section that the next dump
    reads, as in JAX; the off twin takes it and writes nothing."""
    bodies = []
    for mod in (tflight, jflight):
        rec = mod.FlightRecorder(outdir=str(tmp_path / mod.__name__[:12]),
                                 sections={"a": lambda: 1})
        rec.add_section("b", lambda: {"x": [1, 2]})
        rec.add_section("a", lambda: "replaced")
        body = mod.load_artifact(rec.dump("why"))
        bodies.append({k: body[k] for k in ("a", "b", "reason")})
        assert mod.NOOP_FLIGHT.add_section("c", lambda: 0) is None
        assert mod.NOOP_FLIGHT.sections == {} and \
            mod.NOOP_FLIGHT.dump("x") is None
    assert bodies[0] == bodies[1] == {"a": "replaced", "b": {"x": [1, 2]},
                                      "reason": "why"}

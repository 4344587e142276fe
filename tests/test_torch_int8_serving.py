"""Parity of the port's int8 serving with the JAX package on the CPU:
weight-only int8 (``init_inference(dtype=int8)``) through the static
``generate`` path, and int8 paged KV blocks (``kv_quant="int8"``) through
the slot programs and ``ServingEngine.run``.

The JAX engine quantizes seeded numpy parameters itself; its quantized
tree reaches the port through ``params_from_numpy``, so both packages
serve the same int8 codes and scales (compute in float32, as the JAX
package does off a TPU). Logits are held at rtol/atol 1e-5 and greedy
token streams must be identical. The int8 pools are compared entry by
entry: a float32 difference of ~1e-6 in a K/V value can move a code that
sits on a rounding edge by one step, so codes may differ by at most 1, in
a small share of entries, and scales agree to 1e-5. The trash block 0 is
left out: the duplicate writes of inactive lanes land there in an
unspecified order, in both packages.
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
from deepspeed_tpu_torch.models.convert import params_from_numpy
from test_torch_model import numpy_params, one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
CONFIGS = {
    # rmsnorm, swiglu, rotary, GQA, a window and an untied (int8) lm_head
    "llama": dict(jgpt.PRESETS["llama-tiny"], n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=2, d_ff=48, rotary_dim=8,
                  vocab_size=96, max_seq_len=64, attn_window=12),
    # layernorm, gelu, learned positions, biases after the int8 product
    "gpt2": dict(vocab_size=96, n_layers=2, n_heads=4, d_model=32,
                 max_seq_len=64),
}
# one pool, table and chunk geometry per JAX engine: each of its int8 slot
# programs compiles once
SERVE_KW = dict(num_slots=2, block_size=4, num_blocks=24, prefill_chunk=8)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(JAX engine, port engine) serving the same int8 weights."""
    fields = CONFIGS[request.param]
    jcfg = jgpt.GPTConfig(**fields, dtype=jnp.float32,
                          use_flash_attention=False, remat=False)
    tcfg = tgpt.GPTConfig(**fields, dtype=torch.float32)
    npp = numpy_params(jcfg, seed=7)
    jeng = jengine.InferenceEngine(
        config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, npp),
        dtype=jnp.int8)
    quantized = jax.tree_util.tree_map(np.asarray, jeng.params)
    teng = init_inference(model=(tcfg, params_from_numpy(quantized, tcfg,
                                                         device="cpu")),
                          dtype=torch.int8, device="cpu")
    return jeng, teng


def prompts_of(lengths, vocab, seed=1):
    r = np.random.default_rng(seed)
    return [r.integers(1, vocab, n).astype(np.int32) for n in lengths]


def test_int8_engine_holds_int8_weights(pair):
    jeng, teng = pair
    assert teng.quantized and jeng.quantized
    assert teng.dtype == torch.float32          # host compute dtype
    qkv = teng.params["block"]["qkv"]
    assert qkv["q"].dtype == torch.int8 and qkv["scale"].dtype == torch.float32
    np.testing.assert_array_equal(qkv["q"].numpy(),
                                  np.asarray(jeng.params["block"]["qkv"]["q"]))
    assert teng.params["wte"]["embedding"].dtype == torch.float32


def test_int8_generate_matches_jax(pair):
    """The static path with int8 weights: prefill and teacher-forced
    decode logits at 1e-5, greedy generate identical."""
    jeng, teng = pair
    tokens = np.stack(prompts_of((9, 9), jeng.cfg.vocab_size, seed=5))
    lj, cj = jeng._prefill(jeng.params, jnp.asarray(tokens), None)
    lt, ct = teng._prefill_fn(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    tok = np.asarray(lj)[:, -1].argmax(-1)
    for i in range(3):
        lj, cj = jeng._decode(jeng.params, cj,
                              jnp.asarray(tok[:, None], jnp.int32),
                              jnp.asarray(9 + i, jnp.int32), None)
        lt, ct = teng._decode_fn(ct, torch.from_numpy(tok[:, None]).long(),
                                 9 + i)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        tok = np.asarray(lj)[:, -1].argmax(-1)
    np.testing.assert_array_equal(teng.generate(tokens, 6),
                                  jeng.generate(tokens, 6))


def _assert_pools_close(tq, jq, ts, js):
    """Codes within one step, in at most 1% of the entries, and scales at
    1e-5, blocks 1.. only."""
    tq, jq = tq.numpy()[:, 1:].astype(np.int32), np.asarray(jq)[:, 1:]
    diff = np.abs(tq - jq.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= 0.01, (diff > 0).mean()
    np.testing.assert_allclose(ts.numpy()[:, 1:], np.asarray(js)[:, 1:],
                               **TOL)


def test_int8_slot_programs_match_jax(pair):
    """prefill_into_slot / decode_slots on int8 pools: chunked prefill of
    two slots, then decode steps with a slot inactive in one of them."""
    jeng, teng = pair
    cfg = jeng.cfg
    bs, C, N = SERVE_KW["block_size"], SERVE_KW["prefill_chunk"], 25
    NB = jgpt.decode_geometry(cfg, bs)[0]
    L, Hkv, Dh = cfg.n_layers, cfg.kv_heads, cfg.head_dim
    shape = (L, N, bs, Hkv, Dh)
    jp = [jnp.zeros(shape, jnp.int8), jnp.zeros(shape, jnp.int8),
          jnp.zeros((L, N, Hkv), jnp.float32),
          jnp.zeros((L, N, Hkv), jnp.float32)]
    tp = [torch.zeros(shape, dtype=torch.int8),
          torch.zeros(shape, dtype=torch.int8),
          torch.zeros((L, N, Hkv)), torch.zeros((L, N, Hkv))]
    tables = np.zeros((2, NB), np.int32)
    tables[:, :12] = np.arange(1, N).reshape(2, 12)
    prompts = prompts_of((7, 19), cfg.vocab_size, seed=6)
    nxt = np.zeros(2, np.int32)
    for slot, p in enumerate(prompts):
        for start in range(0, len(p), C):
            n = min(C, len(p) - start)
            chunk = np.zeros(C, np.int32)
            chunk[:n] = p[start:start + n]
            lj, *jp = jeng.prefill_into_slot(
                jp[0], jp[1], tables[slot], chunk, start, n,
                k_scale=jp[2], v_scale=jp[3])
            lt, *tp = teng.prefill_into_slot(
                tp[0], tp[1], tables[slot], chunk, start, n,
                k_scale=tp[2], v_scale=tp[3])
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        nxt[slot] = np.asarray(lj)[0, -1].argmax()
    lengths = np.array([len(p) for p in prompts], np.int32)
    for active in ([True, True], [False, True], [True, True], [True, True]):
        active = np.array(active)
        lj, *jp = jeng.decode_slots(jp[0], jp[1], tables, lengths, nxt,
                                    active, k_scale=jp[2], v_scale=jp[3])
        lt, *tp = teng.decode_slots(tp[0], tp[1], tables, lengths, nxt,
                                    active, k_scale=tp[2], v_scale=tp[3])
        np.testing.assert_allclose(lt.numpy()[active],
                                   np.asarray(lj)[active], **TOL)
        nxt = np.where(active, np.asarray(lj)[:, -1].argmax(-1), nxt)
        lengths = lengths + active
    _assert_pools_close(tp[0], jp[0], tp[2], jp[2])
    _assert_pools_close(tp[1], jp[1], tp[3], jp[3])


@pytest.mark.parametrize("scenario", ["mixed", "eviction"])
def test_int8_serving_streams_match_jax(pair, scenario):
    """ServingEngine(kv_quant="int8").run against JAX's: mixed prompt
    lengths (chunked prefill, two slots decoding at once), and a zero
    watermark that forces a preemption and a requantizing re-prefill."""
    jeng, teng = pair
    lengths, n_new = ((5, 11, 19, 3), 6) if scenario == "mixed" \
        else ((30, 28), 20)
    prompts = prompts_of(lengths, jeng.cfg.vocab_size, seed=9)
    js = jserving.ServingEngine(jeng, kv_quant="int8", **SERVE_KW)
    ts = tserving.ServingEngine(teng, kv_quant="int8", **SERVE_KW)
    assert ts.cache.quantized and ts.cache.k.dtype == torch.int8
    if scenario == "eviction":
        js.cache.watermark = ts.cache.watermark = 0
    jo = js.run([jserving.ServeRequest(rid=i, prompt=p, max_new_tokens=n_new)
                 for i, p in enumerate(prompts)])
    to = ts.run([tserving.ServeRequest(rid=i, prompt=p, max_new_tokens=n_new)
                 for i, p in enumerate(prompts)])
    assert sorted(to) == sorted(jo)
    for rid in jo:
        np.testing.assert_array_equal(to[rid], jo[rid])
    for key in ("completed", "evictions", "prefill_chunks", "peak_occupancy",
                "decode_steps"):
        assert ts.stats[key] == js.stats[key], key
    if scenario == "eviction":
        assert ts.stats["evictions"] >= 1
    else:
        assert ts.stats["peak_occupancy"] > 1


def test_kv_quant_with_a_waiting_knob_raises(pair):
    jeng, teng = pair
    # int8 pools with the prefix cache, speculative decode, the host tier,
    # the decode horizon and telemetry are ported:
    # tests/test_torch_prefix_cache.py, test_torch_spec_decode.py,
    # test_torch_host_tier.py, test_torch_horizon.py and
    # test_torch_telemetry.py. The prefill-only role is ported
    # (tests/test_torch_disagg.py): int8 pools take it, as in JAX, with
    # the migration's parked_* counters in the cache's stats
    roles = [mod.ServingEngine(eng, num_slots=1, kv_quant="int8",
                               prefill_only=True)
             for mod, eng in ((jserving, jeng), (tserving, teng))]
    for srv in roles:
        assert srv.prefill_only and srv.cache.quantized
    parked = [{k: v for k, v in srv.cache.stats().items()
               if k.startswith("parked_")} for srv in roles]
    assert parked[1] == parked[0] == {"parked_blocks": 0,
                                      "parked_adopted": 0,
                                      "parked_aborts": 0}
    # LoRA serving is ported (tests/test_torch_adapter_serving.py): int8
    # pools take the adapter pool, sized as the JAX engine sizes it from
    # the DS_LORA_POOL_MB default
    pools = [mod.ServingEngine(eng, num_slots=1, kv_quant="int8",
                               lora_serve=True).adapters.stats()
             for mod, eng in ((jserving, jeng), (tserving, teng))]
    assert pools[1] == pools[0] and pools[1]["pool_blocks"] > 0
    # the flight recorder and the fault-tolerance knobs are ported
    # (tests/test_torch_chaos.py, test_torch_flight.py): int8 pools take
    # them
    srv = tserving.ServingEngine(teng, num_slots=1, kv_quant="int8",
                                 flight_recorder=True, max_queue=2,
                                 step_time_budget_s=10.0)
    assert srv.cache.quantized and srv.flight.enabled
    assert tserving.ServingEngine(teng, num_slots=1, kv_quant="int8",
                                  prefix_cache=True, host_tier=True,
                                  decode_horizon=4, telemetry=True).host_tier
    with pytest.raises(ValueError, match="kv_quant"):
        tserving.ServingEngine(teng, num_slots=1, kv_quant="fp8")
    assert tserving.ServingEngine(teng, num_slots=1,
                                  kv_quant=True).cache.quantized
    assert not tserving.ServingEngine(teng, num_slots=1,
                                      kv_quant="off").cache.quantized

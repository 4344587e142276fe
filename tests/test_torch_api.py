"""The port's API against the JAX package's, on the CPU: the request
fields, the top-level names, float16 inference, and the activation-
checkpointing API.

Float16 tolerance: the first-step logits of the two engines agree to
FP16_TOL of the logits' largest magnitude (a few float16 steps; both
compute in float16 with their own rounding), and their greedy streams are
identical wherever the top-2 margin exceeds that tolerance; a stream that
parts at a near-tie is reported, not asserted.
"""

import argparse
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu import checkpointing as jckpt
from deepspeed_tpu.inference import engine as jengine
from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu_torch import checkpointing as tckpt
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import (params_from_numpy,
                                                params_to_numpy)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.tree import tree_leaves as ttree_leaves
from test_torch_adapter_serving import adapter_export
from test_torch_model import numpy_params, one_torch_thread  # noqa: F401
from test_torch_serving import SERVE_KW

FP16_TOL = 5e-3
GPT2 = dict(vocab_size=128, n_layers=2, n_heads=4, d_model=32,
            max_seq_len=64)
LLAMA = dict(jgpt.PRESETS["llama-tiny"], n_layers=2, max_seq_len=64)


def engines(fields, jdtype, tdtype):
    jcfg = jgpt.GPTConfig(**fields, dtype=jnp.float32,
                          use_flash_attention=False, remat=False)
    tcfg = tgpt.GPTConfig(**fields, dtype=torch.float32)
    npp = numpy_params(jcfg)
    jeng = jengine.InferenceEngine(
        config=jcfg, params=jax.tree_util.tree_map(jnp.asarray, npp),
        dtype=jdtype)
    teng = init_inference(model=(tcfg, params_from_numpy(npp, tcfg,
                                                         device="cpu")),
                          dtype=tdtype, device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def fp32_pair():
    return engines(GPT2, jnp.float32, torch.float32)


@pytest.fixture(scope="module")
def fp16_pair():
    return engines(LLAMA, jnp.float16, torch.float16)


def prompts_of(lengths, vocab, seed):
    r = np.random.default_rng(seed)
    return [r.integers(1, vocab, n).astype(np.int32) for n in lengths]


# ---------------------------------------------------------------------------
# ServeRequest
# ---------------------------------------------------------------------------

def test_serve_request_fields_in_jax_order():
    assert [f.name for f in dataclasses.fields(tserving.ServeRequest)] == \
        [f.name for f in dataclasses.fields(jserving.ServeRequest)]


def test_priority_is_served_as_in_jax(fp32_pair):
    """``priority`` is advisory: the port takes any value and serves the
    JAX engine's tokens."""
    jeng, teng = fp32_pair
    prompts = prompts_of((6, 11, 4), GPT2["vocab_size"], seed=21)
    outs = []
    for mod, eng in ((jserving, jeng), (tserving, teng)):
        srv = mod.ServingEngine(eng, **SERVE_KW)
        outs.append(srv.run([
            mod.ServeRequest(rid=i, prompt=p, max_new_tokens=5,
                             priority=("batch", "interactive", None)[i])
            for i, p in enumerate(prompts)]))
    assert sorted(outs[0]) == sorted(outs[1])
    for rid in outs[0]:
        np.testing.assert_array_equal(outs[1][rid], outs[0][rid])


@pytest.mark.parametrize("field,value,slice_name", [
    ("deadline", 5.0, "fault-tolerance"),
    ("adapter_id", "tenant-a", "LoRA-serving")])
def test_deadline_and_adapter_id_wait_for_their_slices(field, value,
                                                       slice_name, fp32_pair):
    """Both fields came with their slices and are served as in JAX.
    ``deadline`` (fault tolerance): the request retires as ``timeout`` at
    its deadline with the JAX engine's tokens (the other deadline cases
    are tests/test_torch_chaos.py's). ``adapter_id`` (LoRA serving): with
    ``lora_serve`` on and the adapter registered, the request is served
    with the JAX engine's tokens and load count; with it off, it retires
    as ``error``, as in JAX (the other cases are
    tests/test_torch_adapter_serving.py's)."""
    p = prompts_of((6,), GPT2["vocab_size"], seed=5)[0]
    if slice_name == "fault-tolerance":
        got = []
        for mod, eng in zip((jserving, tserving), fp32_pair):
            req = mod.ServeRequest(rid=0, prompt=p, max_new_tokens=30,
                                   **{field: value})
            srv = mod.ServingEngine(eng, **SERVE_KW)
            out = srv.run([req])
            got.append((req.state, out[0].tolist(), srv.stats["timeouts"]))
        assert got[0] == got[1] and got[1][0] == "timeout"
        assert len(p) < len(got[1][1]) < len(p) + 30
        return
    sd = adapter_export(params_to_numpy(fp32_pair[1].params), seed=6)
    got = []
    for mod, eng in zip((jserving, tserving), fp32_pair):
        for on in (True, False):
            req = mod.ServeRequest(rid=0, prompt=p, max_new_tokens=6,
                                   **{field: value})
            srv = mod.ServingEngine(eng, **SERVE_KW, lora_serve=on,
                                    lora_pool_blocks=2, lora_max_rank=4,
                                    lora_rank_block=4)
            if on:
                srv.register_adapter(value, sd)
            out = srv.run([req])
            got.append((req.state, out[0].tolist(),
                         srv.stats["adapter_loads"],
                         srv.stats["adapter_load_errors"]))
    assert got[:2] == got[2:]
    assert got[2][0] == "done" and got[2][2:] == (1, 0)
    assert got[3][0] == "error" and got[3][1] == p.tolist() and \
        got[3][2:] == (0, 1)
    req = tserving.ServeRequest(rid=0, prompt=np.ones(3, np.int32),
                                **{field: None})
    assert getattr(req, field) is None


# ---------------------------------------------------------------------------
# the top-level names
# ---------------------------------------------------------------------------

def _public_api(pkg):
    """Public names other than typing aliases and loaded subpackages
    (``checkpointing`` and ``zero`` are API names, not loaded modules)."""
    out = set()
    for n in dir(pkg):
        obj = getattr(pkg, n)
        if n.startswith("_") or getattr(obj, "__module__", None) == "typing":
            continue
        if isinstance(obj, types.ModuleType) and \
                n not in ("checkpointing", "zero"):
            continue
        out.add(n)
    return out


def test_public_names_hold_every_jax_one():
    jax_names = _public_api(deepspeed_tpu)
    assert {"DeepSpeedConfig", "DeepSpeedEngine", "logger", "log_dist",
            "add_config_arguments", "argparse_suppress", "checkpointing",
            "zero", "initialize", "init_inference"} <= jax_names
    assert jax_names <= _public_api(deepspeed_tpu_torch)
    assert deepspeed_tpu_torch.__version__ == deepspeed_tpu.__version__
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    assert deepspeed_tpu_torch.DeepSpeedEngine is DeepSpeedEngine
    assert deepspeed_tpu_torch.DeepSpeedConfig is TConfig


@pytest.mark.parametrize("argv", [
    [], ["--deepspeed"], ["--deepspeed_config", "ds.json"],
    ["--deepspeed", "--deepspeed_config", "x.json", "--deepscale"]])
def test_add_config_arguments_round_trip(argv):
    parsed = []
    for pkg in (deepspeed_tpu, deepspeed_tpu_torch):
        parser = pkg.add_config_arguments(argparse.ArgumentParser())
        assert parser is not None
        parsed.append(parser.parse_args(argv))
    assert parsed[0] == parsed[1]
    assert deepspeed_tpu_torch.argparse_suppress() == \
        deepspeed_tpu.argparse_suppress()


def test_log_dist_logs_on_rank_zero(caplog):
    with caplog.at_level("INFO", logger="deepspeed_tpu_torch"):
        deepspeed_tpu_torch.log_dist("hello", ranks=[0])
        deepspeed_tpu_torch.log_dist("not here", ranks=[3])
    msgs = [r.getMessage() for r in caplog.records]
    assert "[Rank 0] hello" in msgs
    assert not any("not here" in m for m in msgs)


def test_zero_waits_for_the_multi_gpu_slice():
    """``zero.Init`` came with the data-parallel slice: it is
    ``materialize_sharded`` with the JAX package's parameters (then the
    port's ``device``), and on one rank its tree is ``init_fn``'s, whole
    (tests/test_torch_zero_ranks.py holds the shards across ranks)."""
    import inspect
    from deepspeed_tpu.runtime.zero import init as jinit
    from deepspeed_tpu_torch.parallel.mesh import make_mesh
    zero = deepspeed_tpu_torch.zero
    assert zero.Init is zero.materialize_sharded
    assert list(inspect.signature(zero.Init).parameters) == list(
        inspect.signature(jinit.materialize_sharded).parameters) + ["device"]
    cfg = tgpt.GPTConfig(**GPT2, dtype=torch.float32)

    def init_fn(seed):
        return tgpt.init_params(cfg, seed=seed, device="cpu")
    got = zero.Init(init_fn, 3, make_mesh(), min_shard_size=1,
                    device="cpu")
    want = init_fn(3)
    assert isinstance(got, zero.ShardedParams)
    assert sorted(got) == sorted(want)
    for path in ("wte", "block"):
        for a, b in zip(ttree_leaves(got[path]), ttree_leaves(want[path])):
            assert torch.equal(a, b)


def test_initialize_takes_the_jax_parameters_in_order():
    """``initialize``: the JAX package's parameters in its order, then the
    port's ``device``; ``DeepSpeedEngine`` likewise (its ``donate_state``,
    an XLA buffer option, has no counterpart)."""
    import inspect
    from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine as TEngine
    jp = list(inspect.signature(deepspeed_tpu.initialize).parameters)
    tp = list(inspect.signature(deepspeed_tpu_torch.initialize).parameters)
    assert tp == jp + ["device"]
    assert {"mesh", "partition_rules"} <= set(jp)
    je = [p for p in inspect.signature(JEngine).parameters
          if p != "donate_state"]
    assert list(inspect.signature(TEngine).parameters) == je + ["device"]
    # on one rank the mesh and rules are taken; a mesh the port does not
    # run yet (pipe x sequence) raises naming its ROADMAP item, and a
    # model or pipe axis without a process group asks for
    # init_distributed
    from deepspeed_tpu_torch.parallel import mesh as tmesh
    from deepspeed_tpu_torch.parallel import sharding as tsharding
    cfg = tgpt.GPTConfig(**GPT2, dtype=torch.float32)
    params = tgpt.init_params(cfg, seed=0, device="cpu")
    eng = deepspeed_tpu_torch.initialize(
        model=tgpt.make_loss_fn(cfg), model_parameters=params,
        config={"train_batch_size": 2}, mesh=tmesh.make_mesh(),
        partition_rules=tsharding.megatron_rules(), device="cpu")[0]
    assert (eng.dp_world_size, eng.mp_world_size) == (1, 1)
    assert eng.param_pspecs["block"]["qkv"]["kernel"] == (None, None,
                                                           "model")
    with pytest.raises(NotImplementedError, match=r"§1\.3\.4a"):
        deepspeed_tpu_torch.initialize(
            model=tgpt.make_loss_fn(cfg), model_parameters=params,
            config={"train_batch_size": 2},
            mesh=tmesh.make_mesh(tmesh.MeshSpec(pipe=2, sequence=2),
                                 world_size=4),
            device="cpu")
    with pytest.raises(ValueError, match="init_distributed"):
        deepspeed_tpu_torch.initialize(
            model=tgpt.make_loss_fn(cfg), model_parameters=params,
            config={"train_batch_size": 2},
            mesh=tmesh.make_mesh(tmesh.MeshSpec(pipe=2), world_size=2),
            device="cpu")
    with pytest.raises(ValueError, match="init_distributed"):
        deepspeed_tpu_torch.initialize(
            model=tgpt.make_loss_fn(cfg), model_parameters=params,
            config={"train_batch_size": 2},
            mesh=tmesh.make_mesh(tmesh.MeshSpec(model=2), world_size=2),
            device="cpu")
    with pytest.raises(ValueError, match="process group"):
        deepspeed_tpu_torch.initialize(
            model=tgpt.make_loss_fn(cfg), model_parameters=params,
            config={"train_batch_size": 2},
            mesh=tmesh.make_mesh(world_size=2), device="cpu")


# ---------------------------------------------------------------------------
# float16 inference
# ---------------------------------------------------------------------------

def test_float16_casts_the_float_leaves(fp16_pair):
    _, teng = fp16_pair
    assert teng.dtype == torch.float16
    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        else:
            yield tree
    dtypes = {t.dtype for t in leaves(teng.params)}
    assert dtypes == {torch.float16}
    srv = tserving.ServingEngine(teng, **SERVE_KW)
    assert srv.cache.k.dtype == torch.float16


def test_float16_first_step_logits_match_jax(fp16_pair):
    jeng, teng = fp16_pair
    tokens = np.stack(prompts_of((9, 9), LLAMA["vocab_size"], seed=3))
    lj, _ = jeng._prefill(jeng.params, jnp.asarray(tokens), None)
    lt, _ = teng._prefill_fn(torch.from_numpy(tokens).long(), None)
    lj = np.asarray(lj, np.float32)
    assert lt.dtype == torch.float16
    scale = np.abs(lj).max()
    assert np.abs(lt.float().numpy() - lj).max() <= FP16_TOL * scale


def _assert_streams_agree(teng, prompt, got, want, n_prompt):
    """Identical, or parted at a step whose top-2 margin (the port's
    float16 logits on the shared prefix) is within the tolerance."""
    diff = np.nonzero(got != want)[0]
    if not len(diff):
        return None
    j = int(diff[0])
    assert j >= n_prompt
    logits, _ = teng._prefill_fn(torch.from_numpy(got[None, :j]).long(),
                                 None)
    last = np.sort(logits[0, -1].float().numpy())
    margin = last[-1] - last[-2]
    assert margin <= FP16_TOL * np.abs(logits.float().numpy()).max(), \
        (j, margin)
    return j


def test_float16_greedy_streams_match_jax(fp16_pair):
    jeng, teng = fp16_pair
    prompts = prompts_of((9, 14, 5, 20), LLAMA["vocab_size"], seed=3)
    partings = []
    for p in prompts:
        got = teng.generate(p[None], 12)[0]
        want = jeng.generate(p[None], 12)[0]
        partings.append(_assert_streams_agree(teng, p, got, want, len(p)))
    outs = []
    for mod, eng in ((jserving, jeng), (tserving, teng)):
        srv = mod.ServingEngine(eng, **SERVE_KW)
        outs.append(srv.run([mod.ServeRequest(rid=i, prompt=p,
                                              max_new_tokens=10)
                             for i, p in enumerate(prompts)]))
    for i, p in enumerate(prompts):
        partings.append(_assert_streams_agree(teng, p, outs[1][i],
                                              outs[0][i], len(p)))
    # reported, not asserted: where (if anywhere) a stream parted
    print(f"float16 partings (token index or None): {partings}")


# ---------------------------------------------------------------------------
# activation checkpointing
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_checkpointing():
    jckpt.reset()
    tckpt.reset()
    yield
    jckpt.reset()
    tckpt.reset()


def test_checkpoint_values_and_gradients_match_jax(fresh_checkpointing):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    w1 = rng.standard_normal((16, 32)).astype(np.float32) * 0.3
    w2 = rng.standard_normal((32, 8)).astype(np.float32) * 0.3

    def jblock(x, w1, w2):
        return jnp.tanh(jnp.tanh(x @ w1) @ w2)

    def jloss(w1, w2):
        return jnp.sum(jckpt.checkpoint(jblock, jnp.asarray(x), w1, w2) ** 2)

    def tblock(x, w1, w2):
        return torch.tanh(torch.tanh(x @ w1) @ w2)

    jckpt.configure()
    tckpt.configure()
    lj, gj = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(w1),
                                                       jnp.asarray(w2))
    tw = [torch.tensor(w, requires_grad=True) for w in (w1, w2)]
    for wrap in (lambda *a: tckpt.checkpoint(tblock, *a),
                 tckpt.checkpoint_wrapper(tblock), tckpt.CheckpointFunction):
        if wrap is tckpt.CheckpointFunction:
            out = wrap(tblock, torch.from_numpy(x), *tw)
        else:
            out = wrap(torch.from_numpy(x), *tw)
        lt = torch.sum(out ** 2)
        gt = torch.autograd.grad(lt, tw)
        np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5,
                                   atol=1e-5)
        for a, b in zip(gt, gj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)
    assert tckpt.current_policy() == "nothing_saveable"


FIELDS = ("partition_activations", "number_checkpoints",
          "contiguous_checkpointing", "checkpoint_in_cpu", "synchronize",
          "profile", "offload_names")
SECTION = {"partition_activations": True, "number_checkpoints": 3,
           "contiguous_memory_optimization": True,
           "synchronize_checkpoint_boundary": True, "profile": True}


def _state(mod):
    return {f: getattr(mod._config, f) for f in FIELDS}


@pytest.mark.parametrize("source", ["dict", "config", "explicit",
                                    "explicit_over_config"])
def test_configure_resolves_every_field_as_jax(fresh_checkpointing, source):
    base = {"train_batch_size": 4, "activation_checkpointing": SECTION}
    explicit = dict(partition_activations=False, contiguous_checkpointing=False,
                    synchronize=True, profile=False, num_checkpoints=7,
                    offload_names=("a", "b"))
    for mod, cfg_cls in ((jckpt, JConfig), (tckpt, TConfig)):
        if source == "dict":
            mod.configure(deepspeed_config=base)
        elif source == "config":
            mod.configure(deepspeed_config=cfg_cls(base))
        elif source == "explicit":
            mod.configure(**explicit)
        else:
            mod.configure(deepspeed_config=cfg_cls(base), **explicit)
    assert _state(tckpt) == _state(jckpt)
    ac_j = JConfig(base).activation_checkpointing
    ac_t = TConfig(base).activation_checkpointing
    assert dataclasses.asdict(ac_t) == dataclasses.asdict(ac_j)
    assert dataclasses.asdict(TConfig({"train_batch_size": 4})
                              .activation_checkpointing) == \
        dataclasses.asdict(JConfig({"train_batch_size": 4})
                           .activation_checkpointing)


def test_configure_reset_and_is_configured(fresh_checkpointing):
    for mod in (jckpt, tckpt):
        assert not mod.is_configured()
        mod.configure(partition_activations=True, num_checkpoints=4)
        assert mod.is_configured()
        mod.reset()
        assert not mod.is_configured()


def test_checkpoint_in_cpu_waits_for_the_memory_tier_slice(
        fresh_checkpointing):
    with pytest.raises(NotImplementedError, match="memory-tier"):
        tckpt.configure(checkpoint_in_cpu=True)
    with pytest.raises(NotImplementedError, match="memory-tier"):
        tckpt.configure(deepspeed_config={
            "activation_checkpointing": {"cpu_checkpointing": True}})
    assert not tckpt.is_configured()
    # an explicit False wins over the section, as in JAX
    tckpt.configure(deepspeed_config={"activation_checkpointing":
                                      {"cpu_checkpointing": True}},
                    checkpoint_in_cpu=False)
    assert not tckpt._config.checkpoint_in_cpu

"""The port's ``runtime/lora.py`` and the LoRA terms of its dense layer
against the JAX package on the CPU.

Both packages get the same numpy base parameters and adapters. Held
equal, float32: ``add_lora``'s tree (its A at the JAX rate, not its bits:
torch has no threefry), ``merge_lora`` (1e-6), the adapted forward and
the merged one (1e-5), ``dense`` with a bias, the runtime adapter and the
serving hook, on float and int8 entries (1e-5), the unmerged tree's
``generate`` streams (identical, K1-fwd's plain version on the host),
over an int8 base too, ``quantize_weights_int8`` of an adapted tree (int8
codes exactly, the adapters left float), ``count_trainable``,
``lora_label_tree``, ``adapter_state_dict`` and the ``.npz`` files, which
each package loads from the other. Training the adapters waits for the
LoRA-training slice: the port's refusals are checked here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.inference import engine as jengine
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.runtime import lora as jlora
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import (params_from_numpy,
                                                params_to_numpy)
from deepspeed_tpu_torch.ops.layers import dense
from deepspeed_tpu_torch.runtime import lora as tlora
from deepspeed_tpu_torch.tree import tree_map
from test_torch_adapter_serving import adapted_tree, adapter_export
from test_torch_model import numpy_params, one_torch_thread  # noqa: F401
from test_torch_serving import CONFIGS

TOL = dict(rtol=1e-5, atol=1e-5)


def configs(name, **over):
    fields = dict(CONFIGS[name], **over)
    return (jgpt.GPTConfig(**fields, dtype=jnp.float32,
                           use_flash_attention=False, remat=False),
            tgpt.GPTConfig(**fields, dtype=torch.float32, remat=False))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request, devices):
    """(name, JAX config, port config, numpy base, numpy adapted tree)."""
    jcfg, tcfg = configs(request.param)
    npp = numpy_params(jcfg)
    return (request.param, jcfg, tcfg, npp,
            adapted_tree(npp, adapter_export(npp, seed=7)))


def jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def tokens(seed, shape=(2, 9)):
    return np.random.default_rng(seed).integers(1, 128, shape).astype(
        np.int32)


def test_add_lora_starts_at_the_base_model(model):
    """B = 0: the adapted forward is the base forward exactly. The tree
    has the JAX tree's keys, shapes and scale, and A the JAX rate."""
    _, jcfg, tcfg, npp, _ = model
    base = params_from_numpy(npp, tcfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    ours = tlora.add_lora(base, gen, rank=4, alpha=8.0)
    theirs = jax.eval_shape(lambda key: jlora.add_lora(
        jtree(npp), key, rank=4, alpha=8.0), jax.random.PRNGKey(1))
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), theirs)
    assert jax.tree_util.tree_map(
        lambda x: tuple(x.shape), params_to_numpy(ours)) == shapes
    for t, e in ours["block"].items():
        if "lora_a" in e:
            assert not e["lora_b"].any()
            assert torch.equal(e["lora_scale"], torch.full_like(
                e["lora_scale"], 2.0))
            assert abs(float(e["lora_a"].std()) - 0.5) < 0.1, t
    assert "lora_a" in ours["block"]["qkv"] and \
        "lora_a" not in base["block"]["qkv"]
    x = torch.from_numpy(tokens(0)).long()
    torch.testing.assert_close(tgpt.forward(ours, x, tcfg),
                               tgpt.forward(base, x, tcfg), rtol=0, atol=0)


def test_merge_and_adapted_forward_match_jax(model):
    """``merge_lora`` folds what the adapted forward adds: merged ==
    adapted, the JAX merge's kernels, and the JAX adapted forward."""
    _, jcfg, tcfg, _, npa = model
    ours = params_from_numpy(npa, tcfg, device="cpu")
    merged = tlora.merge_lora(ours)
    jmerged = jlora.merge_lora(jtree(npa))
    assert "lora_a" not in merged["block"]["qkv"]
    for t, e in merged["block"].items():
        assert sorted(e) == sorted(jmerged["block"][t])
        for k, v in e.items():
            np.testing.assert_allclose(
                v.numpy(), np.asarray(jmerged["block"][t][k]), rtol=1e-6,
                atol=1e-6, err_msg=f"{t}/{k}")
    x = tokens(2)
    adapted = tgpt.forward(ours, torch.from_numpy(x).long(), tcfg)
    torch.testing.assert_close(
        tgpt.forward(merged, torch.from_numpy(x).long(), tcfg), adapted,
        **TOL)
    ref = jgpt.forward(jtree(npa), jnp.asarray(x), jcfg,
                       jax.random.PRNGKey(0), deterministic=True)
    np.testing.assert_allclose(adapted.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("entry", ["float", "int8"])
def test_dense_lora_terms_match_jax(model, entry):
    """``dense`` with the runtime adapter and the serving hook together:
    the JAX ``_dense`` (base product, the LoRA terms, then the bias; the
    gpt2 entries' biases make the order visible), on a float and an int8
    entry. The hook's factors are the JAX hook's with the rank-block
    axis folded."""
    name, *_, npa = model
    rng = np.random.default_rng(3)
    t = "mlp_in"
    p = {k: v[1] for k, v in npa["block"][t].items()}
    if entry == "int8":
        p = {k: v for k, v in p.items() if k != "kernel"}
        q = jengine.quantize_weights_int8({"block": {t: {
            "kernel": jnp.asarray(npa["block"][t]["kernel"][1])}}})
        p.update({k: np.asarray(v) for k, v in q["block"][t].items()})
    din, dout = npa["block"][t]["kernel"].shape[1:]
    B, S, nba, rb = 3, 5, 2, 4
    h = rng.standard_normal((B, S, din)).astype(np.float32)
    a_blk = rng.standard_normal((B, nba, din, rb)).astype(np.float32)
    b_blk = rng.standard_normal((B, nba, rb, dout)).astype(np.float32) * .1
    ref = jgpt._dense(jnp.asarray(h), jtree(p),
                      lora=(jnp.asarray(a_blk), jnp.asarray(b_blk)))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    hook = (torch.from_numpy(a_blk).permute(0, 2, 1, 3).reshape(
        B, din, nba * rb), torch.from_numpy(b_blk).reshape(B, nba * rb, dout))
    got = dense(torch.from_numpy(h), tp, lora=hook)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert ("bias" in p) == (name == "gpt2")


def test_llama_dialect_merged_int8_generate_matches_jax(devices):
    """The llama dialect (no biases, swiglu with ``mlp_gate`` adapted),
    merged and served weight-only int8: the JAX int8 engine's stream."""
    jcfg, tcfg = configs("llama")
    npa = adapted_tree(numpy_params(jcfg),
                       adapter_export(numpy_params(jcfg), seed=8))
    assert "block/mlp_gate/lora_a" in tlora.adapter_state_dict(npa)
    merged = tlora.merge_lora(params_from_numpy(npa, tcfg, device="cpu"))
    x = tokens(3, (1, 6))
    got = init_inference(model=(tcfg, merged), dtype=torch.int8,
                         device="cpu").generate(x, max_new_tokens=4)
    ref = jengine.InferenceEngine(
        config=jcfg, params=jlora.merge_lora(jtree(npa)),
        dtype=jnp.int8).generate(x, max_new_tokens=4, temperature=0.0)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_unmerged_generate_matches_merged_and_jax(model):
    """``generate`` over the unmerged tree (the prefill's flash path and
    the ``lora_a`` branch) equals the merged tree's; over an int8 base the
    adapters stay float and ``quantize_weights_int8`` leaves them as they
    were, beside JAX's int8 codes. The JAX stream is held to the float
    engine's on gpt2 and the int8 engine's on llama (one JAX engine a
    configuration)."""
    name, jcfg, tcfg, _, npa = model
    x = tokens(0, (2, 8))
    ours = params_from_numpy(npa, tcfg, device="cpu")
    raw = init_inference(model=(tcfg, ours), dtype=torch.float32,
                         device="cpu").generate(x, max_new_tokens=6)
    merged = init_inference(model=(tcfg, tlora.merge_lora(ours)),
                            dtype=torch.float32,
                            device="cpu").generate(x, max_new_tokens=6)
    np.testing.assert_array_equal(raw, merged)
    q_eng = init_inference(model=(tcfg, ours), dtype=torch.int8,
                           device="cpu")
    qkv = q_eng.params["block"]["qkv"]
    assert qkv["q"].dtype == torch.int8 and \
        qkv["lora_a"].dtype == torch.float32
    jq = jengine.quantize_weights_int8(jtree(npa))
    for t, e in q_eng.params["block"].items():
        for k, v in e.items():
            if k.startswith("lora_") or k == "q":
                np.testing.assert_array_equal(
                    v.numpy(), np.asarray(jq["block"][t][k]), err_msg=t + k)
    got = q_eng.generate(x, max_new_tokens=6)
    if name == "gpt2":
        got, dtype = raw, jnp.float32
    else:
        dtype = jnp.int8
    ref = jengine.InferenceEngine(config=jcfg, params=jtree(npa),
                                  dtype=dtype).generate(
        x, max_new_tokens=6, temperature=0.0)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_export_round_trip_across_packages(model, tmp_path):
    """``adapter_state_dict`` equals JAX's; a file saved by either package
    loads in the other to the same leaves and the adapted forward; the
    base tree is not changed; a tree without the entries raises."""
    _, jcfg, tcfg, npp, npa = model
    ours = params_from_numpy(npa, tcfg, device="cpu")
    sd, jsd = tlora.adapter_state_dict(ours), jlora.adapter_state_dict(
        jtree(npa))
    assert sorted(sd) == sorted(jsd)
    for k in sd:
        assert sd[k].dtype == np.float32
        np.testing.assert_array_equal(sd[k], jsd[k])
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tlora.save_adapter(ours, mine)
    jlora.save_adapter(jtree(npa), theirs)
    base = params_from_numpy(npp, tcfg, device="cpu")
    x = torch.from_numpy(tokens(1)).long()
    want = tgpt.forward(ours, x, tcfg)
    for path in (mine, theirs):
        restored = tlora.load_adapter(base, path)
        torch.testing.assert_close(tgpt.forward(restored, x, tcfg), want,
                                   rtol=0, atol=0)
        jrest = jlora.load_adapter(jtree(npp), path)
        for k, v in jlora.adapter_state_dict(jrest).items():
            np.testing.assert_array_equal(v, jsd[k])
    assert "lora_a" not in base["block"]["qkv"]
    with pytest.raises(KeyError):
        tlora.load_adapter({k: v for k, v in base.items() if k != "block"},
                           mine)
    assert tlora.count_trainable(ours) == jlora.count_trainable(jtree(npa))
    assert tlora.lora_label_tree(ours) == jlora.lora_label_tree(jtree(npa))


def test_mismatched_base_is_rejected(tmp_path, devices):
    """An adapter of another width fails at load with the JAX error; a
    bf16 tree saves through float32 and loads back exactly."""
    _, tcfg = configs("gpt2")
    jcfg, _ = configs("gpt2")
    npp = numpy_params(jcfg)
    ours = params_from_numpy(adapted_tree(npp, adapter_export(npp, seed=2)),
                             tcfg, device="cpu")
    bf16 = tree_map(lambda t: t.to(torch.bfloat16), ours)
    path = str(tmp_path / "a.npz")
    tlora.save_adapter(bf16, path)
    back = tlora.load_adapter(params_from_numpy(npp, tcfg, device="cpu"),
                              path)
    assert torch.equal(back["block"]["qkv"]["lora_b"],
                       bf16["block"]["qkv"]["lora_b"].float())
    jsmall, tsmall = configs("gpt2", d_model=16, n_heads=2)
    small = numpy_params(jsmall)
    msgs = []
    for load, base in ((tlora.load_adapter, params_from_numpy(
            small, tsmall, device="cpu")),
            (jlora.load_adapter, jtree(small))):
        with pytest.raises(ValueError, match="does not match") as err:
            load(base, path)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    bad = adapted_tree(npp, adapter_export(npp, seed=2))
    bad["block"]["qkv"] = dict(bad["block"]["qkv"],
                               lora_scale=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="LoRA entry block/qkv"):
        params_from_numpy(bad, tcfg, device="cpu")


def test_lora_training_waits_for_its_slice(devices):
    """The LoRA-training slice: a training step over an adapted tree, the
    ``lora`` config section and ``lora_optimizer`` raise naming it."""
    jcfg, tcfg = configs("gpt2")
    npp = numpy_params(jcfg)
    adapted = params_from_numpy(adapted_tree(npp, adapter_export(npp, 4)),
                                tcfg, device="cpu")
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt.make_loss_fn(tcfg), model_parameters=adapted,
        device="cpu", config={"train_batch_size": 2, "optimizer": {
            "type": "adamw", "params": {"lr": 1e-3}}})
    with pytest.raises(NotImplementedError, match="LoRA-training"):
        eng.train_batch({"tokens": tokens(5, (2, 9))})
    with pytest.raises(NotImplementedError, match="LoRA-training"):
        deepspeed_tpu_torch.initialize(
            model=tgpt.make_loss_fn(tcfg), device="cpu",
            model_parameters=params_from_numpy(npp, tcfg, device="cpu"),
            config={"train_batch_size": 2, "lora": {"enabled": True}})
    with pytest.raises(NotImplementedError, match="LoRA-training"):
        tlora.lora_optimizer(None, adapted)
    assert tlora.has_lora(adapted) and not tlora.has_lora(npp)

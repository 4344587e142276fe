"""Parity of the port's training step (deepspeed_tpu_torch) with the JAX
package on the CPU: the GPT loss and every gradient leaf, the chunked
cross-entropy, document packing, the activation-checkpointing policies,
and a few steps of both engines from the same parameters.

Parameters and batches are numpy arrays made from a seed and handed to
both sides (``numpy_params`` of test_torch_model.py). float32, rtol/atol
1e-5 unless a test says otherwise: on the CPU the JAX model attends
through its plain reference and the port through the plain versions of its
flash kernels, which sum in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.ops import cross_entropy as jxent
from deepspeed_tpu.runtime import dataloader as jdata
from deepspeed_tpu_torch import tree as ttree
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import (opt_state_from_numpy,
                                                opt_state_to_numpy,
                                                params_from_numpy,
                                                params_to_numpy)
from deepspeed_tpu_torch.ops import adam as tadam
from deepspeed_tpu_torch.ops import cross_entropy as txent
from deepspeed_tpu_torch.ops import lamb as tlamb
from deepspeed_tpu_torch.ops import layers as tlayers
from deepspeed_tpu_torch.runtime import dataloader as tdata
from test_torch_model import numpy_params

TOL = dict(rtol=1e-5, atol=1e-5)

GPT2 = dict(vocab_size=96, n_layers=2, n_heads=4, d_model=32, max_seq_len=32)
LLAMA = dict(jgpt.PRESETS["llama-tiny"], n_layers=2, n_heads=4, n_kv_heads=2,
             d_model=64, d_ff=96, rotary_dim=16, vocab_size=96,
             max_seq_len=32)


def configs(fields, **train):
    jcfg = jgpt.GPTConfig(**fields, dtype=jnp.float32, **train)
    return jcfg, tgpt.GPTConfig(**fields, dtype=torch.float32, **train)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _docs(rng, n=7, lo=3, hi=20, vocab=96):
    return [rng.integers(1, vocab, int(k)) for k in rng.integers(lo, hi, n)]


def _batch(kind, rng):
    if kind == "packed":
        return tdata.pack_documents(_docs(rng), 17)
    return {"tokens": rng.integers(0, 96, (4, 17)).astype(np.int32)}


def _torch_loss_and_grads(tcfg, npp, batch):
    params = params_from_numpy(npp, tcfg, device="cpu")
    leaves = list(ttree.tree_leaves(params))
    for t in leaves:
        t.requires_grad_()
    loss = tgpt.loss_fn(params, {k: torch.from_numpy(v) for k, v in
                                 batch.items()}, None, tcfg)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss, ttree.tree_map(lambda _: next(grads), params)


@pytest.mark.parametrize("case", [
    dict(fields=GPT2, batch="plain"),
    dict(fields=LLAMA, batch="plain"),
    dict(fields=GPT2, batch="packed"),
    dict(fields=LLAMA, batch="packed", remat=True),
    dict(fields=GPT2, batch="plain", loss_chunk=24),   # N = 64: 16 + pad
    dict(fields=LLAMA, batch="packed", loss_chunk=16),
], ids=["gpt2", "llama", "gpt2-packed", "llama-packed-remat", "gpt2-chunked",
        "llama-packed-chunked"])
def test_loss_and_every_gradient_match_jax(devices, case):
    train = dict(remat=case.get("remat", False),
                 loss_chunk=case.get("loss_chunk", 0))
    jcfg, tcfg = configs(case["fields"], **train)
    npp = numpy_params(jcfg, seed=3)
    batch = _batch(case["batch"], np.random.default_rng(4))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jgpt.loss_fn(p, jbatch, jax.random.PRNGKey(0), jcfg)))(npp)
    tloss, tgrads = _torch_loss_and_grads(tcfg, npp, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want, got = _leaves(jgrads), _leaves(params_to_numpy(tgrads))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


@pytest.mark.parametrize("fields", [GPT2, LLAMA], ids=["gpt2", "llama"])
def test_remat_policies_give_the_same_gradients(fields):
    """What a layer keeps changes memory, never the gradient: every ported
    policy against ``remat=False`` to 1e-6, on a packed batch."""
    batch = _batch("packed", np.random.default_rng(5))
    base_cfg = configs(fields, remat=False)
    npp = numpy_params(base_cfg[0], seed=6)
    base_loss, base = _torch_loss_and_grads(base_cfg[1], npp, batch)
    for train in (dict(remat_policy="selective"),
                  dict(remat_policy="flash_only"), dict(remat_policy="full"),
                  dict(remat_policy="selective", use_flash_attention=False)):
        _, tcfg = configs(fields, remat=True, **train)
        loss, grads = _torch_loss_and_grads(tcfg, npp, batch)
        assert abs(float(loss) - float(base_loss)) <= 1e-6 * float(base_loss)
        for g, w in zip(ttree.tree_leaves(grads), ttree.tree_leaves(base)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=str(train))


def keep_of(cfg):
    return tlayers.remat_keep(cfg.remat_policy, cfg.use_flash_attention)


def test_remat_layer_keeps_what_its_policy_names():
    """``full`` keeps nothing beside the layer's input, ``flash_only`` the
    flash output and log-sum-exp, ``selective`` those and the two tagged
    projections; a kept flash output means no forward rerun."""
    assert keep_of(tgpt.GPTConfig(remat_policy="full")) == ()
    assert keep_of(tgpt.GPTConfig(remat_policy="flash_only")) == \
        ("flash",)
    assert set(keep_of(tgpt.GPTConfig())) == \
        {"flash", "qkv", "mlp_pre"}
    assert keep_of(tgpt.GPTConfig(
        remat_policy="flash_only", use_flash_attention=False)) == ()
    with pytest.raises(NotImplementedError, match="memory-tier"):
        keep_of(tgpt.GPTConfig(remat_policy="offload_flash"))
    with pytest.raises(ValueError, match="unknown remat_policy"):
        keep_of(tgpt.GPTConfig(remat_policy="some"))
    _, tcfg = configs(GPT2, remat=True, remat_policy="selective")
    params = tgpt.init_params(tcfg, seed=0, device="cpu")
    tape = tlayers.Tape(keep_of(tcfg))
    x = torch.randn(2, 8, 32)
    tgpt._block(x, tgpt.layer(params, 0), tcfg, tape=tape)
    assert sorted(tape.saved) == ["flash_lse", "flash_o", "mlp_pre", "qkv"]
    o, lse = tape.saved["flash_o"], tape.saved["flash_lse"]
    assert o.shape == (2, 8, 4, 8) and lse.shape == (2, 4, 8)


@pytest.mark.parametrize("case", [
    dict(N=40, chunk=16, bias=True),       # divisor 10 >= 8: no padding
    dict(N=37, chunk=16, bias=True),       # prime N: padded to 48
    dict(N=30, chunk=2048, bias=False),    # one chunk
], ids=["divisor", "padded", "one-chunk"])
def test_softmax_xent_ll_matches_jax(case):
    rng = np.random.default_rng(7)
    N, Hd, V = case["N"], 24, 50
    x = rng.standard_normal((N, Hd)).astype(np.float32)
    w = (0.3 * rng.standard_normal((V, Hd))).astype(np.float32)
    b = rng.standard_normal(V).astype(np.float32) if case["bias"] else None
    t = rng.integers(0, V, N).astype(np.int32)
    g = rng.standard_normal(N).astype(np.float32)

    def jfn(x, w, b):
        ll = jxent.softmax_xent_ll(x, w, jnp.asarray(t), bias=b,
                                   chunk=case["chunk"])
        return (ll * jnp.asarray(g)).sum(), ll
    (_, jll), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2) if b is
                                          not None else (0, 1),
                                          has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    tb = None if b is None else torch.from_numpy(b).requires_grad_()
    ll = txent.softmax_xent_ll(tx, tw, torch.from_numpy(t), bias=tb,
                               chunk=case["chunk"])
    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(jll), **TOL)
    tgrads = torch.autograd.grad((ll * torch.from_numpy(g)).sum(),
                                 [tx, tw] + ([] if tb is None else [tb]))
    for got, want in zip(tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    mask = (rng.random(N) < 0.7).astype(np.float32)
    np.testing.assert_allclose(
        float(txent.chunked_softmax_xent(tx, tw, torch.from_numpy(t), bias=tb,
                                         chunk=case["chunk"],
                                         loss_mask=torch.from_numpy(mask))),
        float(jxent.chunked_softmax_xent(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(t),
            bias=None if b is None else jnp.asarray(b), chunk=case["chunk"],
            loss_mask=jnp.asarray(mask))), rtol=1e-5)


@pytest.mark.parametrize("seq_len", [16, 33])
def test_pack_documents_matches_jax(seq_len):
    rng = np.random.default_rng(8)
    docs = _docs(rng, n=25, lo=1, hi=50)      # some too short, some split
    want = jdata.pack_documents(docs, seq_len, pad_token=3)
    got = tdata.pack_documents(docs, seq_len, pad_token=3)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_flops_and_parameter_counts_match_jax():
    for name in ("gpt2-1.5b", "llama-7b", "llama-tiny"):
        jcfg, tcfg = jgpt.preset(name), tgpt.preset(name)
        assert tgpt.num_params(tcfg) == jgpt.num_params(jcfg)
        for s in (128, 1024):
            assert tgpt.train_flops_per_token(tcfg, s) == \
                jgpt.train_flops_per_token(jcfg, s)
        assert tgpt.train_flops_per_token(tcfg, 64, include_head=False) == \
            jgpt.train_flops_per_token(jcfg, 64, include_head=False)


def test_loss_fn_argument_checks():
    _, tcfg = configs(GPT2)
    params = tgpt.init_params(tcfg, seed=0, device="cpu")
    tokens = torch.zeros((2, 9), dtype=torch.long)
    with pytest.raises(ValueError, match="loss_mask width"):
        tgpt.loss_fn(params, {"tokens": tokens, "targets": tokens,
                              "loss_mask": torch.ones(2, 8)}, None, tcfg)
    with pytest.raises(ValueError, match="layer drop needs a"):
        tgpt.loss_fn(params, {"tokens": tokens,
                              "pld_theta": torch.tensor(0.5)}, None, tcfg)
    _, sp = configs(GPT2, sequence_parallel=True)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tgpt.loss_fn(params, {"tokens": tokens}, None, sp)
    _, drop = configs(GPT2, dropout=0.1)
    with pytest.raises(ValueError, match="Generator"):
        tgpt.loss_fn(params, {"tokens": tokens}, None, drop)
    # explicit targets and the hidden-state head give the same loss
    implicit = tgpt.loss_fn(params, {"tokens": tokens}, None, tcfg)
    explicit = tgpt.loss_fn(params, {"tokens": tokens[:, :-1],
                                     "targets": tokens[:, 1:]}, None, tcfg)
    hidden = tgpt.forward(params, tokens[:, :-1], tcfg, hidden_only=True)
    head = tgpt._head_nll(params, hidden, tokens[:, 1:], tcfg)
    assert torch.allclose(implicit, explicit) and torch.allclose(implicit,
                                                                 head)


def test_dropout_trains_and_checkpointing_replays_its_mask():
    """With dropout on, the checkpointed backward reruns each layer under
    the same mask: gradients equal the unchecked ones exactly in kind."""
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(9).integers(0, 96, (2, 12)))}
    grads = []
    for remat in (False, True):
        _, tcfg = configs(GPT2, dropout=0.3, remat=remat, remat_policy="full")
        params = tgpt.init_params(tcfg, seed=1, device="cpu")
        leaves = [t.requires_grad_() for t in ttree.tree_leaves(params)]
        loss = tgpt.loss_fn(params, batch, torch.Generator().manual_seed(5),
                            tcfg)
        grads.append((float(loss), torch.autograd.grad(loss, leaves)))
    assert grads[0][0] == pytest.approx(grads[1][0], rel=1e-6)
    for a, b in zip(grads[0][1], grads[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    _, det = configs(GPT2, dropout=0.3)
    plain = tgpt.loss_fn(tgpt.init_params(det, seed=1, device="cpu"), batch,
                         None, det, deterministic=True)
    assert float(plain) != pytest.approx(grads[0][0], rel=1e-4)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

ENGINE_CONFIG = {
    "train_batch_size": 16, "gradient_accumulation_steps": 2,
    "gradient_clipping": 0.5, "steps_per_print": 1000,
    "optimizer": {"type": "AdamW", "params": {"lr": 2e-3, "weight_decay": 0.1,
                                              "betas": [0.9, 0.95]}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-4,
                                                 "warmup_max_lr": 2e-3,
                                                 "warmup_num_steps": 4}},
}


def _trajectory(fields, config, steps=3, **train):
    """Both engines from the same numpy parameters over the same batches:
    per-step (loss, grad_norm, lr) of each, and the final parameters."""
    jcfg, tcfg = configs(fields, **train)
    if config.get("bf16", {}).get("enabled"):
        jcfg.dtype, tcfg.dtype = jnp.bfloat16, torch.bfloat16
    npp = numpy_params(jcfg, seed=10)
    jeng, _, _, jsched = deepspeed_tpu.initialize(
        model=jgpt.make_loss_fn(jcfg), model_parameters=npp,
        config=dict(config))
    teng, topt, loader, tsched = deepspeed_tpu_torch.initialize(
        model=tgpt.make_loss_fn(tcfg),
        model_parameters=params_from_numpy(npp, tcfg, device="cpu"),
        config=dict(config), device="cpu")
    assert loader is None and topt is teng.optimizer
    assert tsched is teng.lr_schedule
    rng = np.random.default_rng(11)
    rows = {"j": [], "t": []}
    for _ in range(steps):
        batch = {"tokens": rng.integers(0, 96, (16, 17)).astype(np.int32)}
        jm, tm = jeng.train_batch(batch), teng.train_batch(batch)
        rows["j"].append([float(jm[k]) for k in ("loss", "grad_norm", "lr")])
        rows["t"].append([float(tm[k]) for k in ("loss", "grad_norm", "lr")])
        assert not bool(tm["overflow"]) and tm["loss_scale"] == 1.0
    return jeng, teng, np.array(rows["j"]), np.array(rows["t"])


def test_engine_trajectory_matches_jax_fp32(devices):
    """Three steps (AdamW with weight decay, clipping, two microbatches, a
    warm-up schedule): loss, gradient norm and lr per step, the final
    parameters and the Adam moments."""
    jeng, teng, jrows, trows = _trajectory(GPT2, ENGINE_CONFIG,
                                           remat=True, loss_chunk=32)
    np.testing.assert_allclose(trows, jrows, rtol=1e-5)
    want = _leaves(jeng.params)
    got = _leaves(params_to_numpy(teng.params))
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    assert (teng.global_steps, teng.micro_steps, teng.global_samples,
            teng.skipped_steps) == (3, 6, 48, 0)
    assert (jeng.global_steps, jeng.micro_steps, jeng.global_samples) == \
        (3, 6, 48)
    assert teng.get_lr() == pytest.approx(jeng.get_lr(), rel=1e-6)
    assert teng.get_global_grad_norm() == pytest.approx(trows[-1, 1])
    assert teng.get_loss_scale() == 1.0
    # the optimizer state crosses the packages as (count, mu, nu)
    count, mu, nu = opt_state_to_numpy(teng.opt_state)
    adam = [s for s in jax.tree_util.tree_leaves(
        jeng.state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")][0]
    assert count == int(adam.count) == 3
    for got, want in ((mu, adam.mu), (nu, adam.nu)):
        got, want = _leaves(got), _leaves(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                       rtol=1e-4, atol=1e-8)
    again = opt_state_from_numpy(count, mu, nu, device="cpu")
    assert again["count"] == 3
    for a, b in zip(ttree.tree_leaves(again["mu"]),
                    ttree.tree_leaves(teng.opt_state["mu"])):
        assert torch.equal(a, b)
    # evaluation uses the updated parameters and changes nothing
    batch = {"tokens": np.random.default_rng(12).integers(
        0, 96, (16, 17)).astype(np.int32)}
    jloss, tloss = jeng.eval_batch(batch)[0], teng.eval_batch(batch)[0]
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert float(teng(batch)) == float(tloss)
    assert teng.global_steps == 3


def test_engine_trajectory_matches_jax_bf16_compute(devices):
    """bf16 compute with fp32 masters: the two frameworks round at other
    places (XLA keeps some bf16 products in fp32 where PyTorch rounds
    each), so the loss is held to 2e-2 and lr exactly."""
    config = dict(ENGINE_CONFIG, bf16={"enabled": True})
    jeng, teng, jrows, trows = _trajectory(LLAMA, config)
    np.testing.assert_allclose(trows[:, 0], jrows[:, 0], rtol=2e-2)
    np.testing.assert_allclose(trows[:, 2], jrows[:, 2], rtol=1e-6)
    assert all(t.dtype == torch.float32
               for t in ttree.tree_leaves(teng.params))
    assert teng.compute_dtype == torch.bfloat16


def _tiny_engine(config, **train):
    _, tcfg = configs(GPT2, **train)
    tcfg.dtype = {"fp16": torch.float16, "bf16": torch.bfloat16}.get(
        next((k for k in ("fp16", "bf16")
              if config.get(k, {}).get("enabled")), None), torch.float32)
    params = tgpt.init_params(tcfg, seed=2, device="cpu")
    return deepspeed_tpu_torch.initialize(
        model=tgpt.make_loss_fn(tcfg), model_parameters=params,
        config={"train_batch_size": 4, **config}, device="cpu")[0]


def test_memory_efficient_bf16_trains_with_bf16_state():
    """bf16 masters with stochastic-rounding updates and bf16 moments: the
    state is bf16 throughout and the loss falls on a repeated batch."""
    eng = _tiny_engine({"bf16": {"enabled": True, "memory_efficient": True},
                        "optimizer": {"type": "adamw",
                                      "params": {"lr": 1e-2}}})
    assert all(t.dtype == torch.bfloat16 for tree in (
        eng.params, eng.opt_state["mu"], eng.opt_state["nu"])
        for t in ttree.tree_leaves(tree))
    batch = {"tokens": np.random.default_rng(13).integers(0, 96, (4, 17))}
    losses = [float(eng.train_batch(batch)["loss"]) for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    with pytest.raises(ValueError, match="requires bf16.enabled"):
        _tiny_engine({"bf16": {"memory_efficient": True}})


def test_fp16_overflow_skips_the_step_and_cuts_the_scale():
    """A loss scale of 2^40 overflows fp16 gradients: the step is skipped,
    the parameters stay, and after the hysteresis the scale halves; a
    workable scale then trains."""
    eng = _tiny_engine({"fp16": {"enabled": True, "initial_scale_power": 40,
                                 "hysteresis": 2},
                        "optimizer": {"type": "adam", "params": {"lr": 1e-3}}})
    before = [t.clone() for t in ttree.tree_leaves(eng.params)]
    batch = {"tokens": np.random.default_rng(14).integers(0, 96, (4, 17))}
    m1 = eng.train_batch(batch)
    m2 = eng.train_batch(batch)
    assert m1["overflow"] and m2["overflow"]
    assert (m1["loss_scale"], m2["loss_scale"]) == (2.0 ** 40, 2.0 ** 39)
    assert (eng.skipped_steps, eng.step_count, eng.global_steps) == (2, 0, 2)
    assert all(torch.equal(a, b) for a, b in
               zip(before, ttree.tree_leaves(eng.params)))
    ok = _tiny_engine({"fp16": {"enabled": True, "loss_scale": 256.0},
                       "optimizer": {"type": "adam", "params": {"lr": 1e-3}}})
    m = ok.train_batch(batch)
    assert not m["overflow"] and ok.step_count == 1
    assert ok.get_loss_scale() == 256.0 and np.isfinite(float(m["loss"]))
    assert np.isfinite(float(m["grad_norm"]))


@pytest.mark.parametrize("name", ["lamb", "FusedLamb"])
def test_lamb_trains(name):
    """LAMB through the engine: fp32 masters and moments, the loss falls on
    a repeated batch; with bf16.memory_efficient it is refused, as in the
    JAX engine (the Adam family only)."""
    eng = _tiny_engine({"optimizer": {"type": name, "params": {
        "lr": 1e-2, "weight_decay": 0.01}}})
    assert isinstance(eng.optimizer, tlamb.FusedLamb)
    assert eng.optimizer.eps == 1e-6
    batch = {"tokens": np.random.default_rng(13).integers(
        0, 96, (4, 17)).astype(np.int32)}
    losses = [float(eng.train_batch(batch)["loss"]) for _ in range(6)]
    assert losses[-1] < losses[0], losses
    assert eng.opt_state["count"] == 6
    assert all(t.dtype == torch.float32 for tree in (
        eng.params, eng.opt_state["mu"], eng.opt_state["nu"])
        for t in ttree.tree_leaves(tree))
    with pytest.raises(ValueError, match="Adam family only"):
        _tiny_engine({"bf16": {"enabled": True, "memory_efficient": True},
                      "optimizer": {"type": name}})


def test_engine_refuses_what_waits_for_later_slices():
    eng = _tiny_engine({"prescale_gradients": True,
                        "gradient_predivide_factor": 2.0,
                        "zero_optimization": {"stage": 2}})
    assert eng.zero_optimization_stage == 2
    assert (eng.train_batch_size, eng.train_micro_batch_size_per_gpu,
            eng.gradient_accumulation_steps) == (4, 4, 1)
    with pytest.raises(RuntimeError, match="train_batch"):
        eng.backward(None)
    with pytest.raises(RuntimeError, match="train_batch"):
        eng.step()
    for name in ("OneBitAdam", "ZeroOneAdam", "OneBitLamb"):
        with pytest.raises(NotImplementedError, match="later slice"):
            _tiny_engine({"optimizer": {"type": name}})
    with pytest.raises(ValueError, match="unknown optimizer"):
        _tiny_engine({"optimizer": {"type": "adamax"}})
    _, tcfg = configs(GPT2)
    params = tgpt.init_params(tcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="requires a config"):
        deepspeed_tpu_torch.initialize(model=tgpt.make_loss_fn(tcfg),
                                       model_parameters=params, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            deepspeed_tpu_torch.initialize(
                model=tgpt.make_loss_fn(tcfg), model_parameters=params,
                config={"train_batch_size": 2})

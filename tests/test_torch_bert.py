"""Parity of the port's BERT (deepspeed_tpu_torch.models.bert and
ops.transformer.encoder_layer) and LAMB with the JAX package on the CPU:
the encoder layer (pre-LN and post-LN, flash gate on and off, with a
padding mask), the MLM+NSP loss (dense and chunked) and every gradient
leaf, the SQuAD loss, and three engine steps with AdamW and with LAMB.

Parameters and batches are numpy arrays made from a seed; JAX parameters
reach the port through ``params_from_numpy``. float32, rtol/atol 1e-5.
The JAX flash kernel runs in interpret mode (``pallas_interpret``) where
the gate sends attention to it; the port's flash path on a CPU tensor is
its plain version. Dropout bits cannot match JAX's threefry bits: dropout
is held by its rate and its unbiasedness instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.ops import lamb as jlamb
from deepspeed_tpu.ops.transformer import encoder_layer as jenc
from deepspeed_tpu_torch import tree as ttree
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models.convert import (params_from_numpy,
                                                params_to_numpy)
from deepspeed_tpu_torch.ops import lamb as tlamb
from deepspeed_tpu_torch.ops import layers as tlayers
from deepspeed_tpu_torch.ops.transformer import encoder_layer as tenc

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(vocab_size=97, n_layers=2, n_heads=2, d_model=64,
            max_seq_len=128, dropout=0.0)


def configs(**fields):
    fields = {**TINY, **fields}
    return (jbert.BertConfig(**fields, dtype=jnp.float32),
            tbert.BertConfig(**fields, dtype=torch.float32))


def _draw(shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(path, s):
        base = 1.0 if jax.tree_util.keystr(path).endswith("['scale']") \
            else 0.0
        return (base + 0.05 * rng.standard_normal(s.shape)).astype(s.dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def numpy_params(jcfg, seed=0, qa=False):
    """The JAX tree's shapes (traced, not computed) filled with seeded
    numpy draws; the SQuAD head under ``qa`` when asked."""
    def init(key):
        p = jbert.init_params(key, jcfg)
        if qa:
            p["qa"] = jbert.init_squad_head(key, jcfg)
        return p
    return _draw(jax.eval_shape(init, jax.random.PRNGKey(0)), seed)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _mlm_batch(rng, B=4, S=32, vocab=97, pad=True):
    """Seeded MLM batch: 15% labels, token types, NSP labels and, with
    ``pad``, padded tails on half the rows (every row keeps 8 tokens)."""
    tokens = rng.integers(1, vocab, (B, S)).astype(np.int32)
    labels = np.where(rng.random((B, S)) < 0.15, tokens, -1).astype(np.int32)
    types = (np.arange(S)[None] >= rng.integers(4, S, (B, 1))).astype(
        np.int32)
    mask = np.ones((B, S), np.int32)
    if pad:
        for b in range(0, B, 2):
            mask[b, rng.integers(8, S):] = 0
    labels = np.where(mask > 0, labels, -1).astype(np.int32)
    return {"tokens": tokens, "mlm_labels": labels, "token_type_ids": types,
            "attention_mask": mask,
            "nsp_labels": rng.integers(0, 2, B).astype(np.int32)}


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the encoder layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flash", [True, False], ids=["flash", "softmax"])
@pytest.mark.parametrize("pre_ln", [True, False], ids=["pre-ln", "post-ln"])
def test_encoder_layer_matches_jax(pallas_interpret, pre_ln, flash):
    """One layer at S = 128 (the flash gate's floor) with padded tails:
    the flash path (the JAX kernel in interpret mode; the port's plain
    flash version) and the masked softmax, both against JAX's layer and
    the fp32 references."""
    kw = dict(hidden_size=64, heads=2, pre_layer_norm=pre_ln,
              attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0)
    jcfg = jenc.DeepSpeedTransformerConfig(**kw)
    tcfg = tenc.DeepSpeedTransformerConfig(**kw)
    shapes = jax.eval_shape(lambda k: jenc.init_layer_params(k, jcfg),
                            jax.random.PRNGKey(0))
    npp = _draw(shapes, seed=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 128, 64)).astype(np.float32)
    mask = np.ones((2, 128), np.int32)
    mask[1, 100:] = 0
    def jlayer(p, x, m):
        return jenc.layer_forward(p, x, jcfg, attn_mask=m, allow_flash=flash)

    def jlayer_reference(p, x, m):
        return jenc.layer_forward_reference(p, x, jcfg, attn_mask=m)

    jout = jax.jit(jlayer)(npp, x, mask)
    tp = ttree.tree_map(torch.from_numpy, npp)
    tx, tmask = torch.from_numpy(x), torch.from_numpy(mask)
    tout = tenc.layer_forward(tp, tx, tcfg, attn_mask=tmask,
                              allow_flash=flash)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    jref = jax.jit(jlayer_reference)(npp, x, mask)
    tref = tenc.layer_forward_reference(tp, tx, tcfg, attn_mask=tmask)
    np.testing.assert_allclose(tref.numpy(), np.asarray(jref), **TOL)
    assert tenc.flash_gate(tcfg, 128, True, flash) == flash


def test_encoder_layer_checks_and_init():
    with pytest.raises(ValueError, match="multiple of heads"):
        tenc.DeepSpeedTransformerConfig(hidden_size=30, heads=4)
    cfg = tenc.DeepSpeedTransformerConfig(hidden_size=32, heads=4)
    assert cfg.intermediate_size == 128 and cfg.head_dim == 8
    p = tenc.init_layer_params(torch.Generator().manual_seed(0), cfg)
    jshapes = jax.eval_shape(
        lambda k: jenc.init_layer_params(
            k, jenc.DeepSpeedTransformerConfig(hidden_size=32, heads=4)),
        jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(path): s.shape for path, s in
            jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    assert {k: v.shape for k, v in _leaves(ttree.tree_map(
        lambda t: t.numpy(), p)).items()} == want
    assert abs(p["qkv"]["kernel"].std().item() - 0.02) < 0.003
    # S < 128 or attention dropout in training: the masked softmax
    assert not tenc.flash_gate(cfg, 127, True)
    drop = tenc.DeepSpeedTransformerConfig(hidden_size=32, heads=4,
                                           attn_dropout_ratio=0.1)
    assert not tenc.flash_gate(drop, 512, False)
    assert tenc.flash_gate(drop, 512, True)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _torch_loss_and_grads(tcfg, npp, batch, loss_fn=tbert.loss_fn):
    params = params_from_numpy(npp, tcfg, device="cpu")
    leaves = list(ttree.tree_leaves(params))
    for t in leaves:
        t.requires_grad_()
    loss = loss_fn(params, _to_torch(batch), None, tcfg)
    # leaves the loss does not reach (the MLM head under the SQuAD loss)
    # get zeros, as JAX gives them
    grads = iter(g if g is not None else torch.zeros_like(t) for t, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True)))
    return loss, ttree.tree_map(lambda _: next(grads), params)


def _check_grads(tgrads, jgrads):
    want, got = _leaves(jgrads), _leaves(params_to_numpy(tgrads))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


@pytest.mark.parametrize("case", [
    dict(S=32),
    dict(S=32, loss_chunk=24),
    dict(S=128, remat=True, pre_layer_norm=False),
    dict(S=128, loss_chunk=64, remat=True, remat_policy="full"),
], ids=["dense", "chunked", "flash-postln-remat", "flash-chunked-full"])
def test_loss_and_every_gradient_match_jax(pallas_interpret, case):
    """The MLM+NSP loss, dense or chunked, and every gradient leaf, with
    token types and padded tails; at S = 128 attention takes the flash
    path on both sides."""
    fields = {k: v for k, v in case.items() if k != "S"}
    jcfg, tcfg = configs(**fields)
    npp = numpy_params(jcfg, seed=3)
    batch = _mlm_batch(np.random.default_rng(4), S=case["S"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jbert.loss_fn(p, jbatch, jax.random.PRNGKey(0), jcfg)))(npp)
    tloss, tgrads = _torch_loss_and_grads(tcfg, npp, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _check_grads(tgrads, jgrads)


def test_forward_matches_jax():
    jcfg, tcfg = configs()
    npp = numpy_params(jcfg, seed=5)
    batch = _mlm_batch(np.random.default_rng(6), S=32)
    def jforward(p, tokens, types, mask):
        return jbert.forward(p, tokens, jcfg, types, mask)

    jmlm, jnsp = jax.jit(jforward)(npp, batch["tokens"],
                                   batch["token_type_ids"],
                                   batch["attention_mask"])
    params = params_from_numpy(npp, tcfg, device="cpu")
    tb = _to_torch(batch)
    tmlm, tnsp = tbert.forward(params, tb["tokens"], tcfg,
                               tb["token_type_ids"], tb["attention_mask"])
    assert tmlm.shape == (4, 32, 97) and tnsp.shape == (4, 2)
    np.testing.assert_allclose(tmlm.numpy(), np.asarray(jmlm), **TOL)
    np.testing.assert_allclose(tnsp.numpy(), np.asarray(jnsp), **TOL)


def test_squad_loss_and_gradients_match_jax():
    """The span head's loss and every gradient leaf, an unanswerable
    example (position S) and a -1 position left out as in JAX."""
    jcfg, tcfg = configs()
    npp = numpy_params(jcfg, seed=7, qa=True)
    rng = np.random.default_rng(8)
    batch = _mlm_batch(rng, S=32)
    batch = {"tokens": batch["tokens"],
             "attention_mask": batch["attention_mask"],
             "start_positions": np.array([3, 32, 2, 7], np.int32),
             "end_positions": np.array([4, -1, 3, 8], np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jbert.squad_loss_fn(p, jbatch, jax.random.PRNGKey(0),
                                      jcfg)))(npp)
    tloss, tgrads = _torch_loss_and_grads(tcfg, npp, batch,
                                          loss_fn=tbert.squad_loss_fn)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _check_grads(tgrads, jgrads)
    head = tbert.init_squad_head(tcfg, seed=1, device="cpu")
    assert head["kernel"].shape == (64, 2) and head["bias"].shape == (2,)


def test_presets_counts_and_conversion_checks():
    for name in jbert.PRESETS:
        j, t = jbert.preset(name), tbert.preset(name)
        assert (t.n_layers, t.n_heads, t.d_model) == \
            (j.n_layers, j.n_heads, j.d_model)
        assert tbert.num_params(t) == jbert.num_params(j)
    from tools.bert_bench import flops_per_sample
    assert tbert.train_flops_per_sample(tbert.preset("bert-large"), 512) == \
        flops_per_sample(jbert.preset("bert-large"), 512)
    jcfg, tcfg = configs()
    params = tbert.init_params(tcfg, seed=0, device="cpu")
    assert sum(t.numel() for t in ttree.tree_leaves(params)) == \
        tbert.num_params(tcfg)
    npp = numpy_params(jcfg, seed=0)
    npp["block"]["mlp_in"]["bias"] = npp["block"]["mlp_in"]["bias"][:, :5]
    with pytest.raises(ValueError, match="block/mlp_in/bias"):
        params_from_numpy(npp, tcfg, device="cpu")
    npp = numpy_params(jcfg, seed=0)
    del npp["nsp"]
    with pytest.raises(ValueError, match="nsp/kernel missing"):
        params_from_numpy(npp, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# dropout: rate and unbiasedness (the bits are not JAX's)
# ---------------------------------------------------------------------------

def test_dropout_rate_unbiasedness_and_replay():
    """Attention-probability dropout keeps its rate, its mean over seeds
    is the deterministic output (P.V is linear in p), one seed gives one
    mask, and a checkpointed model reruns each layer under the same
    masks."""
    cfg = tenc.DeepSpeedTransformerConfig(hidden_size=16, heads=2,
                                          attn_dropout_ratio=0.25)
    gen = torch.Generator().manual_seed(0)
    q, k = (torch.randn(1, 8, 2, 8, generator=gen) for _ in range(2))
    v = torch.ones(1, 8, 2, 8)                     # output = kept mass
    det = tenc._attention_core(q, k, v, None, cfg, None, True)
    outs = torch.stack([tenc._attention_core(q, k, v, None, cfg, s, False)
                        for s in range(400)])
    np.testing.assert_allclose(outs.mean(0).numpy(), det.numpy(), atol=0.05)
    probs = torch.ones(200, 300)
    dropped = tlayers.dropout(probs, 0.25, seed=3)
    assert abs((dropped == 0).float().mean().item() - 0.25) < 0.01
    assert torch.equal(dropped, tlayers.dropout(probs, 0.25, seed=3))
    assert tenc.layer_seeds(7) == tenc.layer_seeds(7) != tenc.layer_seeds(8)

    batch = _to_torch(_mlm_batch(np.random.default_rng(9), S=16))
    grads = []
    for remat in (False, True):
        _, tcfg = configs(dropout=0.2, remat=remat, remat_policy="full")
        params = tbert.init_params(tcfg, seed=1, device="cpu")
        leaves = [t.requires_grad_() for t in ttree.tree_leaves(params)]
        loss = tbert.loss_fn(params, batch, torch.Generator().manual_seed(5),
                             tcfg)
        grads.append((float(loss), torch.autograd.grad(loss, leaves)))
    assert grads[0][0] == pytest.approx(grads[1][0], rel=1e-6)
    for a, b in zip(grads[0][1], grads[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="Generator"):
        tbert.loss_fn(params, batch, None, tcfg)


# ---------------------------------------------------------------------------
# LAMB and the engines
# ---------------------------------------------------------------------------

def test_lamb_update_matches_jax():
    """One leaf per case of the trust ratio: ordinary, clamped at
    max_coeff, a zero parameter (ratio 1), and a stacked [L, ...] leaf
    whose norms run over every layer at once."""
    rng = np.random.default_rng(10)
    params = {"a": rng.standard_normal((6, 5)).astype(np.float32),
              "big": (50 * rng.standard_normal(7)).astype(np.float32),
              "zero": np.zeros(4, np.float32),
              "block": {"k": rng.standard_normal((3, 4, 4)).astype(
                  np.float32)}}
    grads = [ttree.tree_map(
        lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        params) for _ in range(3)]
    sched = lambda c: 1e-2 * (1 + c)            # noqa: E731
    jopt = jlamb.fused_lamb(sched, weight_decay=0.05, max_coeff=3.0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jp)
    jupdate = jax.jit(jopt.update)
    topt = tlamb.fused_lamb(sched, weight_decay=0.05, max_coeff=3.0)
    tp = ttree.tree_map(lambda a: torch.from_numpy(a.copy()), params)
    tstate = topt.init(tp)
    for g in grads:
        upd, jstate = jupdate(jax.tree_util.tree_map(jnp.asarray, g),
                              jstate, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        topt.step(tp, ttree.tree_map(torch.from_numpy, g), tstate)
    want, got = _leaves(jp), _leaves(params_to_numpy(tp))
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    assert tstate["count"] == 3
    assert all(t.dtype == torch.float32
               for t in ttree.tree_leaves(tstate["mu"]))


ENGINE = {
    "train_batch_size": 16, "gradient_accumulation_steps": 2,
    "gradient_clipping": 1.0, "steps_per_print": 1000,
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-4,
                                                 "warmup_max_lr": 2e-3,
                                                 "warmup_num_steps": 4}},
}
# Adam's eps is the BERT recipe's 1e-6: with the default 1e-8, a weight
# whose gradient is summation noise (~1e-8 against a largest entry of
# 2e-2, different in the two packages) is normalised to a full lr step
OPTIMIZERS = {
    "adamw": {"type": "AdamW", "params": {"lr": 2e-3, "weight_decay": 0.01,
                                          "eps": 1e-6}},
    "lamb": {"type": "LAMB", "params": {"lr": 2e-3, "weight_decay": 0.01,
                                        "max_coeff": 5.0}},
}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_engine_trajectory_matches_jax(opt):
    """Three steps of both engines from the same numpy parameters (two
    microbatches, clipping, a warm-up schedule): loss, gradient norm and
    lr per step, and the final parameters."""
    jcfg, tcfg = configs()
    npp = numpy_params(jcfg, seed=11)
    config = dict(ENGINE, optimizer=OPTIMIZERS[opt])
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=jbert.make_loss_fn(jcfg), model_parameters=npp,
        config=dict(config))
    # the fresh state placed as the first step leaves it, so that the
    # step compiles once (the values do not change)
    jeng.state = jax.device_put(jeng.state, jeng._state_shardings)
    teng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=tbert.make_loss_fn(tcfg),
        model_parameters=params_from_numpy(npp, tcfg, device="cpu"),
        config=dict(config), device="cpu")
    rng = np.random.default_rng(12)
    rows = {"j": [], "t": []}
    for _ in range(3):
        batch = _mlm_batch(rng, B=16, S=16)
        jm, tm = jeng.train_batch(batch), teng.train_batch(batch)
        rows["j"].append([float(jm[k]) for k in ("loss", "grad_norm", "lr")])
        rows["t"].append([float(tm[k]) for k in ("loss", "grad_norm", "lr")])
    np.testing.assert_allclose(np.array(rows["t"]), np.array(rows["j"]),
                               rtol=1e-5)
    want, got = _leaves(jeng.params), _leaves(params_to_numpy(teng.params))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)

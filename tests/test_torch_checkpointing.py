"""Checkpoints of the port (deepspeed_tpu_torch.runtime.checkpointing) on
the CPU: a resumed run against the JAX engine's uninterrupted one, resumed
against uninterrupted bit for bit in every precision and optimizer, the
crash-safety behaviours the JAX package's tests pin
(tests/test_checkpointing.py), the port's own cases, the 16-bit model
file across the two packages, and serving from a checkpoint.

Parameters and batches are seeded numpy arrays handed to both packages;
float32 to 1e-5 against JAX, exact equality between port runs.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import engine as jengine
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.runtime import checkpointing as jckpt
from deepspeed_tpu_torch import tree as ttree
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import (params_from_numpy,
                                                params_to_numpy)
from deepspeed_tpu_torch.runtime import checkpointing as tckpt
from deepspeed_tpu_torch.runtime.checkpointing import (
    CheckpointError, get_latest_tag, list_tags, validate_tag)
from deepspeed_tpu_torch.utils import faults
from deepspeed_tpu_torch.utils.faults import Fault, InjectedCrash
from test_torch_model import numpy_params, one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = dict(vocab_size=96, n_layers=2, n_heads=4, d_model=32,
              max_seq_len=32)
ADAMW = {"type": "AdamW", "params": {"lr": 2e-3, "weight_decay": 0.1,
                                     "betas": [0.9, 0.95]}}
BASE = {"train_batch_size": 4, "steps_per_print": 1000, "optimizer": ADAMW}


def _cfg(dtype=torch.float32, **train):
    return tgpt.GPTConfig(**FIELDS, dtype=dtype, **train)


def _engine(config, seed=0, dtype=torch.float32, **train):
    cfg = _cfg(dtype, **train)
    return deepspeed_tpu_torch.initialize(
        model=tgpt.make_loss_fn(cfg), config=dict(config), device="cpu",
        model_parameters=tgpt.init_params(cfg, seed=seed, device="cpu"))[0]


def _batches(n, rows=4, width=17, seed=3):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 96, (rows, width)).astype(np.int32)}
            for _ in range(n)]


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


# ---------------------------------------------------------------------------
# resumed runs
# ---------------------------------------------------------------------------

def test_resumed_port_run_matches_jax_uninterrupted(tmp_path, devices):
    """The JAX engine's three steps against the port's one step, a save,
    a fresh engine from other weights, the load and two more steps: per
    step loss, gradient norm and lr, and the final parameters, in float32
    (AdamW, clipping, two microbatches, a warm-up schedule)."""
    config = dict(BASE, train_batch_size=16, gradient_accumulation_steps=2,
                  gradient_clipping=0.5, scheduler={
                      "type": "WarmupLR", "params": {
                          "warmup_min_lr": 1e-4, "warmup_max_lr": 2e-3,
                          "warmup_num_steps": 4}})
    jcfg = jgpt.GPTConfig(**FIELDS, dtype=jnp.float32)
    npp = numpy_params(jcfg, seed=10)
    jeng = deepspeed_tpu.initialize(model=jgpt.make_loss_fn(jcfg),
                                    model_parameters=npp,
                                    config=dict(config))[0]
    # the fresh state placed as the step leaves it: the step compiles once
    jeng.state = jax.device_put(jeng.state, jeng._state_shardings)
    batches = _batches(3, rows=16)
    jrows = [[float(m[k]) for k in ("loss", "grad_norm", "lr")]
             for m in map(jeng.train_batch, batches)]

    cfg = _cfg()

    def port(params):
        return deepspeed_tpu_torch.initialize(
            model=tgpt.make_loss_fn(cfg), model_parameters=params,
            config=dict(config), device="cpu")[0]
    first = port(params_from_numpy(npp, cfg, device="cpu"))
    rows = [first.train_batch(batches[0])]
    first.save_checkpoint(str(tmp_path))
    second = port(tgpt.init_params(cfg, seed=7, device="cpu"))
    path, _ = second.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step1")
    rows += [second.train_batch(b) for b in batches[1:]]
    trows = [[float(m[k]) for k in ("loss", "grad_norm", "lr")]
             for m in rows]
    np.testing.assert_allclose(trows, jrows, rtol=1e-5)
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jeng.params)[0]}
    got = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_flatten_with_path(
               params_to_numpy(second.params))[0]}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    assert (second.global_steps, second.micro_steps,
            second.global_samples) == (3, 6, 48)


CURRICULUM = {"enabled": True, "curriculum_type": "seqlen",
              "min_difficulty": 8, "max_difficulty": 32,
              "schedule_type": "fixed_linear",
              "schedule_config": {"total_curriculum_step": 4,
                                  "difficulty_step": 8}}
RESUME_CASES = {
    "fp32": dict(config=dict(BASE, train_batch_size=8,
                             gradient_accumulation_steps=2,
                             gradient_clipping=1.0)),
    "bf16-memory-efficient": dict(
        config=dict(BASE, bf16={"enabled": True, "memory_efficient": True}),
        dtype=torch.bfloat16),
    "fp16-mid-hysteresis": dict(
        config=dict(BASE, fp16={"enabled": True, "initial_scale_power": 16,
                                "hysteresis": 2, "loss_scale_window": 1},
                    optimizer={"type": "adam", "params": {"lr": 1e-3}}),
        dtype=torch.float16, steps=6, save_at=4),
    "warmup-schedule": dict(config=dict(BASE, scheduler={
        "type": "WarmupDecayLR", "params": {
            "warmup_max_lr": 3e-3, "warmup_num_steps": 3,
            "total_num_steps": 8}})),
    "lamb": dict(config=dict(BASE, optimizer={
        "type": "lamb", "params": {"lr": 1e-2, "weight_decay": 0.01}})),
    "sgd-nesterov": dict(config=dict(BASE, optimizer={
        "type": "sgd", "params": {"lr": 0.1, "momentum": 0.9,
                                  "nesterov": True}})),
    "adagrad": dict(config=dict(BASE, optimizer={
        "type": "adagrad", "params": {"lr": 0.05, "weight_decay": 0.01}})),
    "curriculum": dict(config=dict(BASE, curriculum_learning=CURRICULUM),
                       width=33),
}


@pytest.mark.parametrize("name", sorted(RESUME_CASES))
def test_resumed_run_equals_uninterrupted_bit_for_bit(name, tmp_path):
    """An uninterrupted run against the same run saved after ``save_at``
    steps and resumed in a fresh engine built from other weights: every
    loss, every parameter and optimizer-state leaf, the step counters,
    the loss-scale state and the generator's state are equal exactly."""
    case = RESUME_CASES[name]
    steps, save_at = case.get("steps", 4), case.get("save_at", 2)
    dtype = case.get("dtype", torch.float32)
    rows = case["config"]["train_batch_size"]
    batches = _batches(steps, rows=rows, width=case.get("width", 17))
    whole = _engine(case["config"], dtype=dtype)
    want = [float(whole.train_batch(b)["loss"]) for b in batches]

    first = _engine(case["config"], dtype=dtype)
    got = [float(first.train_batch(b)["loss"]) for b in batches[:save_at]]
    saved_scale = first.scale_state
    first.save_checkpoint(str(tmp_path), tag="mid")
    resumed = _engine(case["config"], seed=9, dtype=dtype)
    resumed.load_checkpoint(str(tmp_path))
    assert resumed.scale_state == saved_scale
    got += [float(resumed.train_batch(b)["loss"])
            for b in batches[save_at:]]
    assert got == want
    _equal_trees(resumed.params, whole.params)
    _equal_trees(resumed.opt_state, whole.opt_state)
    assert torch.equal(resumed.rng.get_state(), whole.rng.get_state())
    assert resumed.scale_state == whole.scale_state
    assert (resumed.global_steps, resumed.skipped_steps, resumed.step_count,
            resumed.global_samples) == (whole.global_steps,
                                        whole.skipped_steps,
                                        whole.step_count,
                                        whole.global_samples)
    if name == "fp16-mid-hysteresis":
        assert saved_scale.hysteresis == 1 and saved_scale.overflow
        # steps 4 and 5 overflow; steps 1-3 and 6 apply
        assert (whole.skipped_steps, whole.step_count) == (2, 4)
    if name == "curriculum":
        assert resumed.curriculum_scheduler.get_state() == \
            whole.curriculum_scheduler.get_state()
        assert whole.curriculum_scheduler.get_current_difficulty() == 32


# ---------------------------------------------------------------------------
# the JAX package's checkpoint behaviours (tests/test_checkpointing.py)
# ---------------------------------------------------------------------------

def test_latest_tag_and_client_state(tmp_path):
    engine = _engine(BASE)
    engine.train_batch(_batches(1)[0])
    engine.save_checkpoint(str(tmp_path), client_state={"note": "hi",
                                                        "epoch": 3})
    assert get_latest_tag(str(tmp_path)) == "global_step1"
    assert list_tags(str(tmp_path)) == ["global_step1"]
    meta = json.loads((tmp_path / "global_step1" / "ds_meta.json")
                      .read_text())
    assert meta["global_steps"] == 1 and meta["precision"] == "fp32"
    manifest = json.loads((tmp_path / "global_step1" / "ds_manifest.json")
                          .read_text())["files"]
    assert sorted(manifest) == ["ds_meta.json", "state/engine.pt",
                                "state/optimizer.pt", "state/params.pt"]
    engine2 = _engine(BASE, seed=9)
    path, client = engine2.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step1") and engine2.global_steps == 1
    assert client == {"note": "hi", "epoch": 3}


def test_missing_checkpoint_returns_none_or_raises_under_strict(tmp_path):
    engine = _engine(BASE)
    path, client = engine.load_checkpoint(str(tmp_path))
    assert path is None and client == {}
    with pytest.raises(CheckpointError, match="latest"):
        engine.load_checkpoint(str(tmp_path), strict=True)
    with pytest.raises(CheckpointError, match="manifest"):
        engine.load_checkpoint(str(tmp_path), tag="nope", strict=True)


def test_crash_pre_commit_leaves_no_visible_tag(tmp_path):
    """A crash after the state is written and before the commit: only
    ``<tag>.building`` exists, no loader sees it, and a retried save
    commits over the leftover."""
    engine = _engine(BASE)
    engine.train_batch(_batches(1)[0])
    engine.save_checkpoint(str(tmp_path), tag="t1")
    with faults.injected(Fault("checkpoint.pre_commit", "crash")) as inj:
        with pytest.raises(InjectedCrash):
            engine.save_checkpoint(str(tmp_path), tag="t2")
    assert inj.fired == [("checkpoint.pre_commit", "crash", 0)]
    assert not os.path.isdir(tmp_path / "t2")
    assert os.path.isdir(tmp_path / "t2.building")
    assert list_tags(str(tmp_path)) == ["t1"]
    assert get_latest_tag(str(tmp_path)) == "t1"
    engine.save_checkpoint(str(tmp_path), tag="t2")
    assert get_latest_tag(str(tmp_path)) == "t2"
    assert validate_tag(str(tmp_path), "t2")
    assert not os.path.isdir(tmp_path / "t2.building")


def test_crash_between_commit_and_latest_lands_on_previous_tag(tmp_path):
    """A crash after the tag directory commits and before ``latest``
    moves: the new tag is valid on disk, ``latest`` still names the
    previous one, and a plain load lands there."""
    engine = _engine(BASE)
    batches = _batches(2)
    engine.train_batch(batches[0])
    engine.save_checkpoint(str(tmp_path), tag="t1")
    engine.train_batch(batches[1])
    with faults.injected(Fault("checkpoint.commit", "crash")):
        with pytest.raises(InjectedCrash):
            engine.save_checkpoint(str(tmp_path), tag="t2")
    assert validate_tag(str(tmp_path), "t2")
    assert get_latest_tag(str(tmp_path)) == "t1"
    engine2 = _engine(BASE, seed=5)
    path, _ = engine2.load_checkpoint(str(tmp_path))
    assert path.endswith("t1") and engine2.global_steps == 1


def test_corrupt_latest_walks_back_and_explicit_tag_is_kept(tmp_path,
                                                           caplog):
    """A corrupted newest tag fails the manifest check; a load of
    ``latest`` walks back to the newest valid tag, an explicit request
    for the corrupt tag is never substituted (warning and ``(None, {})``,
    or CheckpointError under ``strict``)."""
    engine = _engine(BASE)
    batches = _batches(2)
    engine.train_batch(batches[0])
    engine.save_checkpoint(str(tmp_path), tag="good")
    engine.train_batch(batches[1])
    engine.save_checkpoint(str(tmp_path), tag="bad")
    assert get_latest_tag(str(tmp_path)) == "bad"
    with open(tmp_path / "bad" / "ds_meta.json", "a") as f:
        f.write(" ")
    assert not validate_tag(str(tmp_path), "bad")
    engine2 = _engine(BASE, seed=7)
    with caplog.at_level(logging.WARNING, logger="deepspeed_tpu_torch"):
        path, _ = engine2.load_checkpoint(str(tmp_path))
    assert path.endswith("good") and engine2.global_steps == 1
    assert "walking back to newest valid tag good" in caplog.text
    engine3 = _engine(BASE, seed=9)
    path, client = engine3.load_checkpoint(str(tmp_path), tag="bad")
    assert path is None and client == {} and engine3.global_steps == 0
    with pytest.raises(CheckpointError, match="manifest"):
        engine3.load_checkpoint(str(tmp_path), tag="bad", strict=True)
    # a payload file torn mid-write is caught the same way
    with open(tmp_path / "good" / "state" / "params.pt", "r+b") as f:
        f.truncate(100)
    with pytest.raises(CheckpointError, match="no valid tag"):
        engine3.load_checkpoint(str(tmp_path), strict=True)


def test_overwriting_a_tag_replaces_it(tmp_path):
    engine = _engine(BASE)
    batches = _batches(2)
    engine.train_batch(batches[0])
    engine.save_checkpoint(str(tmp_path), tag="same")
    engine.train_batch(batches[1])
    engine.save_checkpoint(str(tmp_path), tag="same")
    assert sorted(os.listdir(tmp_path)) == ["latest", "same"]
    engine2 = _engine(BASE, seed=3)
    engine2.load_checkpoint(str(tmp_path))
    assert engine2.global_steps == 2
    _equal_trees(engine2.params, engine.params)


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------

def test_load_without_optimizer_states(tmp_path):
    """``load_optimizer_states=False``: parameters and counters come from
    the checkpoint, the optimizer state stays the fresh engine's."""
    engine = _engine(BASE)
    for b in _batches(2):
        engine.train_batch(b)
    engine.save_checkpoint(str(tmp_path))
    fresh = _engine(BASE, seed=4)
    fresh.load_checkpoint(str(tmp_path), load_optimizer_states=False,
                          load_lr_scheduler_states=False)
    _equal_trees(fresh.params, engine.params)
    assert fresh.global_steps == 2 and fresh.step_count == 2
    assert fresh.opt_state["count"] == 0
    assert all(not t.any() for t in ttree.tree_leaves(fresh.opt_state["mu"]))


def test_mismatched_trees_raise(tmp_path):
    """A checkpoint of another optimizer or model does not load into an
    engine whose trees differ."""
    engine = _engine(dict(BASE, optimizer={"type": "sgd",
                                           "params": {"lr": 0.1}}))
    engine.train_batch(_batches(1)[0])
    engine.save_checkpoint(str(tmp_path))
    with pytest.raises(CheckpointError, match="optimizer state"):
        _engine(BASE).load_checkpoint(str(tmp_path))
    with pytest.raises(CheckpointError, match="params/block"):
        _engine(BASE, d_ff=64).load_checkpoint(str(tmp_path))


@pytest.mark.parametrize("case", ["larger_leaf", "extra_leaf",
                                  "extra_state"])
def test_checkpoint_must_hold_the_engines_leaves(tmp_path, case):
    """A checkpoint whose leaf is larger than the engine's (vocab 96 into
    64: no top-left block is taken), which holds a parameter the engine
    lacks (an untied lm_head; optimizer state not loaded) or optimizer
    state the engine lacks (AdamW's moments into SGD) raises
    CheckpointError naming the leaf."""
    saved, loading, match = {
        "larger_leaf": ({}, {"vocab_size": 64},
                        r"params/wte/embedding.*\(96, 32\)"),
        "extra_leaf": ({"tie_embeddings": False}, {},
                       r"params: the checkpoint holds \['lm_head/kernel'\]"),
        "extra_state": ({}, {}, r"optimizer state: .*'mu/"),
    }[case]
    for fields, save in ((saved, True), (loading, False)):
        cfg = tgpt.GPTConfig(**{**FIELDS, **fields}, dtype=torch.float32)
        config = dict(BASE, optimizer={"type": "sgd", "params": {"lr": 0.1}}) \
            if case == "extra_state" and not save else dict(BASE)
        engine = deepspeed_tpu_torch.initialize(
            model=tgpt.make_loss_fn(cfg), config=config, device="cpu",
            model_parameters=tgpt.init_params(cfg, device="cpu"))[0]
        if save:
            engine.train_batch(_batches(1)[0])
            engine.save_checkpoint(str(tmp_path))
    with pytest.raises(CheckpointError, match=match):
        engine.load_checkpoint(str(tmp_path), load_optimizer_states=(
            case != "extra_leaf"))


def test_generator_state_across_device_types(tmp_path, caplog):
    """A generator state saved on another device type (here: a card's,
    written into the checkpoint as the card would write it) cannot be
    set: everything else loads, the generator is reseeded from (seed,
    global_steps), and a warning says so."""
    config = dict(BASE, bf16={"enabled": True, "memory_efficient": True})
    engine = _engine(config, dtype=torch.bfloat16)
    engine.train_batch(_batches(1)[0])
    engine.save_checkpoint(str(tmp_path), tag="card")
    path = tmp_path / "card" / "state" / "engine.pt"
    state = torch.load(path, weights_only=True)
    state.update(rng_device="cuda", rng_state=torch.zeros(16, dtype=torch.uint8))
    torch.save(state, path)
    tckpt._write_manifest(str(tmp_path / "card"), "card")
    fresh = _engine(config, seed=2, dtype=torch.bfloat16)
    with caplog.at_level(logging.WARNING, logger="deepspeed_tpu_torch"):
        fresh.load_checkpoint(str(tmp_path), strict=True)
    assert "reseeded" in caplog.text and "cuda" in caplog.text
    _equal_trees(fresh.params, engine.params)
    _equal_trees(fresh.opt_state, engine.opt_state)
    seed = int(np.random.SeedSequence([1234, 1]).generate_state(1)[0])
    assert torch.equal(fresh.rng.get_state(),
                       torch.Generator().manual_seed(seed).get_state())
    assert np.isfinite(float(fresh.train_batch(_batches(1)[0])["loss"]))


def test_fault_injector_ports_only_the_checkpoint_sites():
    """Every kind now parses and fires at every site (the serving sites
    came with the fault-tolerance slice, tests/test_torch_chaos.py); a
    crash at a checkpoint site still fires at its visit only."""
    inj = faults.FaultInjector([Fault("serving.decode", "crash")])
    with pytest.raises(InjectedCrash, match="serving.decode"):
        inj.fire("serving.decode")
    inj = faults.FaultInjector([Fault("checkpoint.commit", "slow")])
    assert inj.fire("checkpoint.commit").kind == "slow"
    assert faults.parse_spec("checkpoint.commit:slow@0~0.5") == [
        Fault("checkpoint.commit", "slow", param=0.5)]
    inj = faults.FaultInjector([Fault("checkpoint.commit", "crash", step=1)])
    assert inj.fire("checkpoint.commit") is None
    with pytest.raises(InjectedCrash, match="visit 1"):
        inj.fire("checkpoint.commit")
    assert inj.fired == [("checkpoint.commit", "crash", 1)]


def test_fp32_state_dict_without_an_engine(tmp_path):
    config = dict(BASE, bf16={"enabled": True, "memory_efficient": True})
    engine = _engine(config, dtype=torch.bfloat16)
    engine.train_batch(_batches(1)[0])
    engine.save_checkpoint(str(tmp_path))
    for fn in (tckpt.load_fp32_state_dict_from_zero_checkpoint,
               tckpt.get_fp32_state_dict_from_zero_checkpoint):
        sd = fn(str(tmp_path))
        for got, want in zip(ttree.tree_leaves(sd),
                             ttree.tree_leaves(engine.params)):
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            assert torch.equal(got, want.float())
    with pytest.raises(CheckpointError):
        tckpt.load_fp32_state_dict_from_zero_checkpoint(
            str(tmp_path / "none"))


# ---------------------------------------------------------------------------
# the 16-bit model file across the packages
# ---------------------------------------------------------------------------

def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_16bit_model_file_crosses_the_packages_bit_for_bit(tmp_path, dtype):
    """JAX ``write_16bit_model`` -> port ``load_16bit_model`` ->
    ``params_from_numpy``, and the port engine's ``save_16bit_model`` ->
    JAX ``load_16bit_model``: every leaf's bits."""
    jcfg = jgpt.GPTConfig(**FIELDS, dtype=jnp.float32)
    npp = numpy_params(jcfg, seed=1)
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), npp)
    path = jckpt.write_16bit_model(jtree, str(tmp_path / "jax"))
    loaded = tckpt.load_16bit_model(path)
    tdtype = getattr(torch, dtype)
    cfg = _cfg(tdtype)
    params = params_from_numpy(loaded, cfg, device="cpu", dtype=tdtype)
    want = {jax.tree_util.keystr(p): _bits(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jtree)[0]}
    for tree in (loaded, params):
        got = {jax.tree_util.keystr(p): v for p, v in
               jax.tree_util.tree_flatten_with_path(tree)[0]}
        assert sorted(got) == sorted(want)
        for key, t in got.items():
            assert t.dtype == tdtype, key
            np.testing.assert_array_equal(
                _bits(t.view(torch.int16).numpy() if dtype == "bfloat16"
                      else t.numpy()), want[key], err_msg=key)

    config = dict(BASE, bf16={"enabled": dtype == "bfloat16",
                              "memory_efficient": dtype == "bfloat16"})
    engine = deepspeed_tpu_torch.initialize(
        model=tgpt.make_loss_fn(cfg), model_parameters=params, device="cpu",
        config=config)[0]
    engine.train_batch(_batches(1)[0])
    assert engine.save_16bit_model(str(tmp_path / "port"), "m.npz")
    back = jckpt.load_16bit_model(str(tmp_path / "port" / "m.npz"))
    want = engine.consolidated_16bit_state_dict()
    flat = dict(tckpt._flat(want))
    got = {"/".join(str(k.key) for k in p): np.asarray(v) for p, v in
           jax.tree_util.tree_flatten_with_path(back)[0]}
    assert sorted(got) == sorted(flat)
    for key, t in flat.items():
        assert str(got[key].dtype) == dtype, key
        np.testing.assert_array_equal(
            _bits(got[key]), t.view(torch.int16).numpy().view(np.uint16)
            if dtype == "bfloat16" else t.numpy(), err_msg=key)
    assert engine.module_state_dict() is engine.params


# ---------------------------------------------------------------------------
# serving from a checkpoint
# ---------------------------------------------------------------------------

def test_init_inference_from_a_checkpoint_matches_jax_streams(tmp_path,
                                                              devices):
    """``init_inference(config=, checkpoint=)`` takes the ``latest`` tag's
    parameters: its greedy streams equal those of the ``(cfg, params)``
    path and of the JAX engine on the same weights."""
    engine = _engine(BASE)
    for b in _batches(2):
        engine.train_batch(b)
    engine.save_checkpoint(str(tmp_path))
    cfg = _cfg()
    prompts = np.random.default_rng(6).integers(1, 96, (2, 7))
    from_ckpt = deepspeed_tpu_torch.init_inference(
        config=cfg, checkpoint=str(tmp_path), dtype=torch.float32,
        device="cpu")
    direct = InferenceEngine((cfg, engine.params), dtype=torch.float32,
                             device="cpu")
    jcfg = jgpt.GPTConfig(**FIELDS, dtype=jnp.float32,
                          use_flash_attention=False, remat=False)
    jeng = jengine.InferenceEngine(
        config=jcfg, params=jax.tree_util.tree_map(
            jnp.asarray, params_to_numpy(engine.params)), dtype=jnp.float32)
    streams = from_ckpt.generate(prompts, 6)
    np.testing.assert_array_equal(streams, direct.generate(prompts, 6))
    np.testing.assert_array_equal(streams, jeng.generate(prompts, 6))
    with pytest.raises(ValueError, match="mp_size=2.*init_distributed"):
        InferenceEngine(config=cfg, checkpoint=str(tmp_path), mp_size=2,
                        device="cpu")

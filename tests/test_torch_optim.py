"""Parity of the port's optimizer and runtime pieces (Adam, stochastic
rounding, lr schedules, loss scaling, norm and clipping, the config's
batch arithmetic) with the JAX package, on the CPU.

Inputs are numpy arrays made from a seed and handed to both sides;
float32, rtol/atol 1e-5 unless a test says otherwise. Random bits cannot
match across the two frameworks' generators, so stochastic rounding is
compared on explicit bits and dropout by its rate and scaling only.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepspeed_tpu.ops import adam as jadam
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime import loss_scaler as jls
from deepspeed_tpu.runtime import lr_schedules as jsched
from deepspeed_tpu.runtime import utils as jutils
import deepspeed_tpu_torch
from deepspeed_tpu_torch import tree as ttree
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.ops import adam as tadam
from deepspeed_tpu_torch.ops import layers as tlayers
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime import loss_scaler as tls
from deepspeed_tpu_torch.runtime import lr_schedules as tsched
from deepspeed_tpu_torch.runtime import utils as tutils

TOL = dict(rtol=1e-5, atol=1e-5)


def _tree(rng, scale=1.0):
    return {"a": {"kernel": (scale * rng.standard_normal((6, 5)))
                  .astype(np.float32),
                  "bias": (scale * rng.standard_normal(5)).astype(np.float32)},
            "b": (scale * rng.standard_normal((3, 4, 2))).astype(np.float32)}


def _torch_tree(tree):
    return ttree.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("case", [
    dict(adam_w_mode=True, weight_decay=0.1),
    dict(adam_w_mode=False, weight_decay=0.05),
    dict(adam_w_mode=True, weight_decay=0.1, bf16_state=True),
    dict(adam_w_mode=True, weight_decay=0.0, schedule=True),
    dict(adam_w_mode=True, weight_decay=0.1, step_chunk=7),
], ids=["adamw", "l2", "bf16-moments", "schedule", "chunked-leaves"])
def test_fused_adam_matches_jax(case, monkeypatch):
    """Three updates through the JAX transform and the port's in-place
    step from the same parameters and gradients: parameters and both
    moments after every step. ``step_chunk``: the port updates every leaf
    in pieces of that many elements (none a multiple of it)."""
    if "step_chunk" in case:
        monkeypatch.setattr(tadam, "STEP_CHUNK", case["step_chunk"])
    rng = np.random.default_rng(0)
    params = _tree(rng)
    lr = (lambda c: 1e-2 * (c + 1.0)) if case.get("schedule") else 3e-3
    kw = dict(b1=0.9, b2=0.95, eps=1e-6, weight_decay=case["weight_decay"],
              adam_w_mode=case["adam_w_mode"])
    jopt = jadam.fused_adam(
        lr, state_dtype=jnp.bfloat16 if case.get("bf16_state") else None,
        **kw)
    topt = tadam.fused_adam(
        lr, state_dtype=torch.bfloat16 if case.get("bf16_state") else None,
        **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = _torch_tree(params)
    tstate = topt.init(tp)
    # bf16 moments: the two sides round the same fp32 moments to bf16, and
    # a last-bit difference before the rounding can flip it (one bf16 ulp,
    # 2^-8 relative); the parameters see it damped by the learning rate
    mtol = dict(rtol=2 ** -7, atol=1e-6) if case.get("bf16_state") else TOL
    for _ in range(3):
        grads = _tree(rng, scale=0.3)
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                  jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step(tp, _torch_tree(grads), tstate)
        adam_state = [s for s in jax.tree_util.tree_leaves(
            jstate, is_leaf=lambda x: isinstance(x, jadam.ScaleByAdamState))
            if isinstance(s, jadam.ScaleByAdamState)][0]
        assert tstate["count"] == int(adam_state.count)
        for got, want, tol in ((tp, jp, TOL), (tstate["mu"], adam_state.mu,
                                               mtol),
                               (tstate["nu"], adam_state.nu, mtol)):
            for g, w in zip(ttree.tree_leaves(got),
                            ttree.tree_leaves(jax.tree_util.tree_map(
                                lambda x: np.asarray(x.astype(jnp.float32)),
                                want))):
                np.testing.assert_allclose(g.float().numpy(), w, **tol)
    if case.get("bf16_state"):
        assert all(t.dtype == torch.bfloat16
                   for t in ttree.tree_leaves(tstate["mu"]))


def test_stochastic_round_bf16_matches_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((64, 33)) * 10.0 ** rng.integers(-6, 6, (64, 33))
         ).astype(np.float32)
    x[0, :4] = [0.0, -0.0, 1.0, -1.0]
    key = jax.random.PRNGKey(7)
    want = np.asarray(jadam.stochastic_round_bf16(jnp.asarray(x), key)
                      .astype(jnp.float32))
    bits = np.asarray(jax.random.bits(key, x.shape, jnp.uint32))
    got = tadam.stochastic_round_bf16(torch.from_numpy(x),
                                      torch.from_numpy(bits.astype(np.int64)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_stochastic_round_bf16_is_unbiased():
    """From a ``torch.Generator``: a value a quarter of the way between
    two bf16 neighbours rounds up a quarter of the time."""
    lo, ulp = 1.0, 2.0 ** -7
    x = torch.full((200_000,), lo + 0.25 * ulp)
    gen = torch.Generator().manual_seed(0)
    out = tadam.stochastic_round_bf16(x, gen).float()
    assert set(out.unique().tolist()) == {lo, lo + ulp}
    up = (out > lo).float().mean().item()
    assert abs(up - 0.25) < 0.01, up
    assert abs(out.mean().item() - x[0].item()) < 0.02 * ulp


def test_sr_apply_updates_rounds_only_bf16_leaves():
    gen = torch.Generator().manual_seed(0)
    params = {"h": torch.ones(1000, dtype=torch.bfloat16),
              "f": torch.ones(4, dtype=torch.float32)}
    tadam.sr_apply_updates(params, {"h": torch.full((1000,), 2.0 ** -10),
                                    "f": torch.full((4,), 2.0 ** -10)}, gen)
    assert torch.equal(params["f"], torch.full((4,), 1.0 + 2.0 ** -10))
    vals = set(params["h"].float().unique().tolist())
    assert vals == {1.0, 1.0 + 2.0 ** -7}     # an eighth of an ulp each


SCHEDULES = [
    ("WarmupLR", dict(warmup_min_lr=1e-5, warmup_max_lr=1e-3,
                      warmup_num_steps=20)),
    ("WarmupLR", dict(warmup_max_lr=2e-3, warmup_num_steps=10,
                      warmup_type="linear")),
    ("WarmupDecayLR", dict(total_num_steps=40, warmup_max_lr=1e-3,
                           warmup_num_steps=8)),
    ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-3,
                      cycle_first_step_size=10, cycle_second_step_size=15,
                      decay_step_size=5, decay_lr_rate=0.5)),
    ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-3,
                      cycle_first_step_size=12)),
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-4,
                         lr_range_test_step_rate=2.0,
                         lr_range_test_step_size=7)),
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-4,
                         lr_range_test_step_size=7,
                         lr_range_test_staircase=True)),
    (None, dict()),
]


@pytest.mark.parametrize("name,params", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(SCHEDULES)])
def test_lr_schedule_matches_jax(name, params):
    js = jsched.get_lr_schedule(name, params, base_lr=5e-4)
    ts = tsched.get_lr_schedule(name, params, base_lr=5e-4)
    for step in range(60):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-5,
                                   atol=1e-10, err_msg=f"step {step}")


def test_lr_scheduler_object_and_unknown_name():
    sched = tsched.LRScheduler(tsched.warmup_lr(0.0, 1e-3, 10, "linear"))
    assert sched.get_lr() == [0.0]
    for _ in range(5):
        sched.step()
    assert sched.get_lr() == pytest.approx([4e-4])
    other = tsched.LRScheduler(sched.schedule)
    other.load_state_dict(sched.state_dict())
    assert other.get_last_lr() == sched.get_lr()
    with pytest.raises(ValueError, match="unknown lr schedule"):
        tsched.get_lr_schedule("Cosine", {})


@pytest.mark.parametrize("dynamic", [True, False])
def test_loss_scale_state_machine_matches_jax(dynamic):
    """A fixed overflow sequence through both state machines: hysteresis
    before the first cut, growth after a window of good steps, the floor."""
    seq = [0, 1, 1, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1]
    kw = dict(dynamic=dynamic, scale_window=4, min_scale=4.0,
              max_hysteresis=2)
    js = jls.init_state(static_scale=0.0 if dynamic else 128.0,
                        initial_scale_power=5, hysteresis=2)
    ts = tls.init_state(static_scale=0.0 if dynamic else 128.0,
                        initial_scale_power=5, hysteresis=2)
    for i, ovf in enumerate(seq):
        js = jls.update(js, jnp.asarray(bool(ovf)), **kw)
        ts = tls.update(ts, bool(ovf), **kw)
        assert (ts.loss_scale, ts.good_steps, ts.hysteresis, ts.overflow) == \
            (float(js.loss_scale), int(js.good_steps), int(js.hysteresis),
             bool(js.overflow)), f"step {i}"
    if dynamic:
        assert ts.loss_scale == 4.0       # cut down to the floor


def test_loss_scale_helpers_match_jax():
    rng = np.random.default_rng(2)
    grads = _tree(rng)
    jstate, tstate = jls.init_state(static_scale=64.0), tls.init_state(64.0)
    tg = _torch_tree(grads)
    for g, w in zip(ttree.tree_leaves(tls.unscale_grads(tg, tstate)),
                    ttree.tree_leaves(jax.tree_util.tree_map(
                        np.asarray, jls.unscale_grads(grads, jstate)))):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    loss = tls.scale_loss(torch.tensor(0.5), tstate)
    assert float(loss) == float(jls.scale_loss(jnp.asarray(0.5), jstate))
    assert not bool(tls.has_overflow(tg))
    tg["b"][0, 0, 0] = float("inf")
    assert bool(tls.has_overflow(tg))
    tg["b"][0, 0, 0] = float("nan")
    assert bool(tls.has_overflow(tg))


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(3)
    grads = _tree(rng, scale=2.0)
    tg = _torch_tree(grads)
    assert tutils.count_parameters(tg) == jutils.count_parameters(grads) == 59
    np.testing.assert_allclose(float(tutils.global_norm(tg)),
                               float(jutils.global_norm(grads)), rtol=1e-6)
    for max_norm in (1.0, 1e3):            # clipping, and a no-op
        want = jutils.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, grads), max_norm)
        got = tutils.clip_by_global_norm(_torch_tree(grads), max_norm)
        for g, w in zip(ttree.tree_leaves(got), ttree.tree_leaves(
                jax.tree_util.tree_map(np.asarray, want))):
            np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_global_norm_of_a_large_leaf_is_accurate():
    """Twenty million small entries: a running fp32 sum on the host loses
    ~1e-3 of the norm (and the clipping factor with it); the norm is held
    to 1e-6 of the float64 value."""
    gen = torch.Generator().manual_seed(0)
    t = torch.randn(20_000_000, generator=gen) * 1e-3
    want = float(np.sqrt((t.double() ** 2).sum()))
    got = float(tutils.global_norm({"w": t, "b": torch.zeros(3)}))
    assert abs(got - want) <= 1e-6 * want, (got, want)


BATCH_DICTS = [
    dict(train_batch_size=32),
    dict(train_batch_size=32, train_micro_batch_size_per_gpu=4),
    dict(train_batch_size=32, gradient_accumulation_steps=4),
    dict(train_micro_batch_size_per_gpu=4),
    dict(train_micro_batch_size_per_gpu=4, gradient_accumulation_steps=3),
    dict(train_batch_size=32, train_micro_batch_size_per_gpu=4,
         gradient_accumulation_steps=2),
]


@pytest.mark.parametrize("world_size", [1, 2, 4])
@pytest.mark.parametrize("d", BATCH_DICTS,
                         ids=[str(i) for i in range(len(BATCH_DICTS))])
def test_config_batch_arithmetic_matches_jax(d, world_size):
    def resolve(mod):
        try:
            c = mod.DeepSpeedConfig(dict(d), world_size=world_size)
        except (AssertionError, mod.DeepSpeedConfigError):
            return "error"
        return (c.train_batch_size, c.train_micro_batch_size_per_gpu,
                c.gradient_accumulation_steps)
    assert resolve(tconfig) == resolve(jconfig)


def test_config_fields_match_jax():
    d = {"train_batch_size": 8, "gradient_clipping": 0.5, "seed": 7,
         "steps_per_print": 3, "prescale_gradients": True,
         "gradient_predivide_factor": 2.0,
         "bf16": {"enabled": True, "memory_efficient": True},
         "zero_optimization": {"stage": 2},
         "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
         "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 5}}}
    t, j = tconfig.DeepSpeedConfig(d), jconfig.DeepSpeedConfig(d)
    for name in ("gradient_clipping", "seed", "steps_per_print",
                 "prescale_gradients", "gradient_predivide_factor",
                 "precision_name"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.compute_dtype == torch.bfloat16
    assert (t.bf16.enabled, t.bf16.memory_efficient, t.zero.stage) == \
        (j.bf16.enabled, j.bf16.memory_efficient, j.zero.stage)
    assert (t.optimizer.type, t.optimizer.params, t.scheduler.type,
            t.scheduler.params) == (j.optimizer.type, j.optimizer.params,
                                    j.scheduler.type, j.scheduler.params)
    assert t.fp16.dynamic_loss_scale and not t.fp16.enabled
    fp16 = tconfig.DeepSpeedConfig({"train_batch_size": 2,
                                    "fp16": {"enabled": True,
                                             "loss_scale": 128}})
    assert fp16.compute_dtype == torch.float16
    assert not fp16.fp16.dynamic_loss_scale


@pytest.mark.parametrize("d", [
    dict(),
    dict(train_batch_size=0),
    dict(train_batch_size=8, train_micro_batch_size_per_gpu=3,
         gradient_accumulation_steps=2),
    dict(train_batch_size=8, fp16=dict(enabled=True), bf16=dict(enabled=True)),
    dict(train_batch_size=8, zero_optimization=dict(stage=5)),
], ids=["empty", "zero-batch", "inconsistent", "fp16+bf16", "zero-stage"])
def test_config_errors_match_jax(d):
    for mod in (jconfig, tconfig):
        with pytest.raises((AssertionError, mod.DeepSpeedConfigError)):
            mod.DeepSpeedConfig(dict(d))


@pytest.mark.parametrize("section", [
    {"zero_optimization": {"stage": 2,
                           "offload_optimizer": {"device": "cpu"}}},
    {"zero_optimization": {"stage": 3, "offload_param": {"device": "nvme"}}},
    {"lora": {"enabled": True}},
    {"quantize_training": {"enabled": True}},
    {"elasticity": {"enabled": True}},
    {"mesh": {"expert_parallel_size": 2}},
    {"comm_backend_name": "dcn_compressed"},
], ids=lambda s: "-".join(f"{k}" for k in s))
def test_unported_config_sections_raise(section):
    with pytest.raises(NotImplementedError, match="slice"):
        tconfig.DeepSpeedConfig({"train_batch_size": 8, **section})
    # the same section switched off is accepted
    off = {k: ({**v, "enabled": False} if isinstance(v, dict)
               and "enabled" in v else None) for k, v in section.items()}
    off = {k: v for k, v in off.items() if v is not None}
    tconfig.DeepSpeedConfig({"train_batch_size": 8, **off})


FEATURE_SECTIONS = {
    "progressive_layer_drop": {"enabled": True, "theta": 0.5, "gamma": 0.1},
    "curriculum_learning": {
        "enabled": True, "curriculum_type": "seqlen", "min_difficulty": 8,
        "max_difficulty": 16, "schedule_type": "fixed_linear",
        "schedule_config": {"total_curriculum_step": 4,
                            "difficulty_step": 8}},
    "flops_profiler": {"enabled": True, "profile_step": 1, "detailed": False,
                       "output_file": "PROFILE"},
    "tensorboard": {"enabled": True, "output_path": "OUT",
                    "job_name": "tiny"},
}


@pytest.mark.parametrize("key", sorted(FEATURE_SECTIONS))
def test_engine_feature_sections_parse_like_jax(key, tmp_path, monkeypatch):
    """Each engine feature section parses to the JAX package's dataclass
    field for field, and a port engine takes two steps with it on (the
    monitor without its optional TensorBoard writer, whose import takes
    seconds)."""
    from deepspeed_tpu_torch.utils import monitor as tmonitor
    monkeypatch.setattr(tmonitor, "_tensorboard_writer",
                        lambda log_dir: None)
    section = json.loads(json.dumps(FEATURE_SECTIONS[key]).replace(
        '"OUT"', json.dumps(str(tmp_path))).replace(
        '"PROFILE"', json.dumps(str(tmp_path / "profile.txt"))))
    cfg = {"train_batch_size": 4, "wall_clock_breakdown": True,
           "steps_per_print": 1, key: section}
    attr = {"progressive_layer_drop": "pld",
            "curriculum_learning": "curriculum"}.get(key, key)
    want = getattr(jconfig.DeepSpeedConfig(dict(cfg)), attr)
    tcfg = tconfig.DeepSpeedConfig(dict(cfg))
    assert dataclasses.asdict(getattr(tcfg, attr)) == dataclasses.asdict(want)
    assert tcfg.wall_clock_breakdown is True
    fields = dict(vocab_size=32, n_layers=2, n_heads=2, d_model=16,
                  max_seq_len=16, dtype=torch.float32)
    mcfg = tgpt.GPTConfig(**fields)
    eng = deepspeed_tpu_torch.initialize(
        model=tgpt.make_loss_fn(mcfg), config=cfg, device="cpu",
        model_parameters=tgpt.init_params(mcfg, seed=0, device="cpu"))[0]
    tokens = np.random.default_rng(0).integers(0, 32, (4, 17))
    losses = [float(eng.train_batch({"tokens": tokens})["loss"])
              for _ in range(2)]
    assert np.isfinite(losses).all()
    assert len(eng.timers("train_batch").elapsed_records) == 2
    if key == "tensorboard":
        rows = (tmp_path / "tiny" / "scalars.csv").read_text().splitlines()
        assert rows[0].startswith("step,") and len(rows) == 3
    if key == "flops_profiler":
        assert "analytic" in (tmp_path / "profile.txt").read_text()
    if key == "curriculum_learning":
        assert eng.curriculum_scheduler.get_current_difficulty() == 8
    if key == "progressive_layer_drop":
        assert eng.progressive_layer_drop.get_theta() == pytest.approx(
            0.5 * np.exp(-0.1) + 0.5)
    eng.destroy()


@pytest.mark.parametrize("section", [
    None,
    {},
    {"mode": "fixed"},
    {"mode": "variable", "block": 32, "num_random_blocks": 2,
     "local_window_blocks": [2, 4], "global_block_indices": [0, 5],
     "global_block_end_indices": [1, 7], "attention": "unidirectional",
     "not_a_field": 3},
    {"mode": "bslongformer", "num_sliding_window_blocks": 5,
     "different_layout_per_head": True},
], ids=["absent", "empty", "fixed", "variable", "bslongformer"])
def test_sparse_attention_section_parses_like_jax(section):
    """``sparse_attention`` parses to the JAX package's
    ``SparseAttentionConfig`` field for field (unknown keys ignored, as
    there), and is None when absent."""
    cfg = {"train_batch_size": 8}
    if section is not None:
        cfg["sparse_attention"] = section
    want = jconfig.DeepSpeedConfig(dict(cfg)).sparse_attention
    got = tconfig.DeepSpeedConfig(dict(cfg)).sparse_attention
    if section is None:
        assert got is None and want is None
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]


def test_dropout_keep_rate_and_scaling():
    """The generator's bits are not JAX's: only the rate and the scaling
    carry over. The same seed gives the same mask (the checkpointed
    backward relies on it)."""
    x = torch.ones(400, 500)
    out = tlayers.dropout(x, 0.2, seed=11)
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.005
    assert torch.allclose(out[kept], torch.tensor(1.0 / 0.8))
    assert torch.equal(out, tlayers.dropout(x, 0.2, seed=11))
    assert not torch.equal(out, tlayers.dropout(x, 0.2, seed=12))

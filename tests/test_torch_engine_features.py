"""The training engine's features in the port against the JAX package, on
the CPU: the loaders and ``initialize(training_data=)``, SGD, Adagrad and
a client optimizer, the seqlen curriculum, progressive layer drop, the
monitor, the timers and the flops profiler.

Parameters and batches are seeded numpy arrays handed to both packages;
float32, 1e-5 for trajectories and 1e-6 for optimizer updates. Random
bits cannot match across the two frameworks' generators, so layer drop is
compared by its schedule, its rule's rates and its theta = 1 trajectory.
"""

import csv
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.profiling import flops_profiler as jprof
from deepspeed_tpu.runtime import dataloader as jdata
from deepspeed_tpu.runtime import progressive_layer_drop as jpld
from deepspeed_tpu.runtime.data_pipeline import (
    CurriculumScheduler as JCurriculum)
from deepspeed_tpu.utils import monitor as jmonitor
from deepspeed_tpu.utils import timer as jtimer
from deepspeed_tpu_torch import tree as ttree
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import (params_from_numpy,
                                                params_to_numpy)
from deepspeed_tpu_torch.ops import adam as tadam
from deepspeed_tpu_torch.ops import sgd as tsgd
from deepspeed_tpu_torch.profiling import flops_profiler as tprof
from deepspeed_tpu_torch.runtime import dataloader as tdata
from deepspeed_tpu_torch.runtime import progressive_layer_drop as tpld
from deepspeed_tpu_torch.runtime.data_pipeline import (
    CurriculumScheduler as TCurriculum)
from deepspeed_tpu_torch.utils import monitor as tmonitor
from deepspeed_tpu_torch.utils import timer as ttimer
from test_torch_model import numpy_params

TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = dict(vocab_size=96, n_layers=2, n_heads=4, d_model=32,
              max_seq_len=32)
BASE = {"train_batch_size": 16, "steps_per_print": 1000,
        "optimizer": {"type": "AdamW", "params": {"lr": 2e-3}}}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(config, fields=FIELDS, seed=10, **train):
    """(JAX engine, port engine) from the same numpy parameters."""
    jcfg = jgpt.GPTConfig(**fields, dtype=jnp.float32, **train)
    tcfg = tgpt.GPTConfig(**fields, dtype=torch.float32, **train)
    npp = numpy_params(jcfg, seed=seed)
    jeng = deepspeed_tpu.initialize(model=jgpt.make_loss_fn(jcfg),
                                    model_parameters=npp,
                                    config=dict(config))[0]
    # the fresh state placed as the step leaves it: one compile per shape
    jeng.state = jax.device_put(jeng.state, jeng._state_shardings)
    teng = deepspeed_tpu_torch.initialize(
        model=tgpt.make_loss_fn(tcfg), config=dict(config), device="cpu",
        model_parameters=params_from_numpy(npp, tcfg, device="cpu"))[0]
    return jeng, teng


def _tokens(n, rows=16, width=17, seed=11):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 96, (rows, width)).astype(np.int32)}
            for _ in range(n)]


def _compare_trajectories(jeng, teng, batches, params=True):
    for b in batches:
        jm, tm = jeng.train_batch(b), teng.train_batch(b)
        np.testing.assert_allclose(
            [float(tm[k]) for k in ("loss", "grad_norm", "lr")],
            [float(jm[k]) for k in ("loss", "grad_norm", "lr")], rtol=1e-5)
    if params:
        want, got = _leaves(jeng.params), _leaves(params_to_numpy(
            teng.params))
        for key in want:
            np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                       **TOL)


# ---------------------------------------------------------------------------
# the loaders
# ---------------------------------------------------------------------------

def _dataset(kind, n=11):
    rng = np.random.default_rng(5)
    if kind == "dict":
        return [{"tokens": rng.integers(0, 96, 17).astype(np.int32),
                 "w": np.float32(i)} for i in range(n)]
    if kind == "tuple":
        return [(rng.integers(0, 96, 5), np.float32(i)) for i in range(n)]
    return [rng.standard_normal(3).astype(np.float32) for _ in range(n)]


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kind", ["dict", "tuple", "array"])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_batches_equal_jax(kind, drop_last):
    """Two passes of the shuffled loader, then a RepeatingLoader across
    its end, and the PrefetchLoader on the host: the JAX package's batches
    in its order."""
    data = _dataset(kind)
    kw = dict(batch_size=4, seed=3, drop_last=drop_last)
    jl, tl = jdata.DeepSpeedDataLoader(data, **kw), \
        tdata.DeepSpeedDataLoader(data, **kw)
    assert len(jl) == len(tl) == (2 if drop_last else 3)
    for _ in range(2):
        for a, b in zip(jl, tl, strict=True):
            _same(b, a)
    jr = jdata.RepeatingLoader(jdata.DeepSpeedDataLoader(data, **kw))
    tr = tdata.RepeatingLoader(tdata.DeepSpeedDataLoader(data, **kw))
    for _ in range(7):
        _same(next(tr), next(jr))
    fake = type("E", (), {"device": torch.device("cpu")})()
    direct = list(tdata.DeepSpeedDataLoader(data, **kw))
    for depth in (1, 2):
        got = list(tdata.PrefetchLoader(
            tdata.DeepSpeedDataLoader(data, **kw), fake, depth=depth))
        assert len(got) == len(direct)
        for a, b in zip(got, direct):
            _same(a, b)
    with pytest.raises(ValueError, match="depth"):
        tdata.PrefetchLoader(tl, fake, depth=0)


def test_initialize_training_data_trains_as_fed_batches(devices):
    """``initialize(training_data=)`` returns the JAX package's loader
    (the same batches), and training from it equals training on the same
    batches fed by hand, bit for bit."""
    data = _dataset("dict", n=40)
    cfg = tgpt.GPTConfig(**FIELDS, dtype=torch.float32)
    params = tgpt.init_params(cfg, seed=1, device="cpu")
    config = dict(BASE, train_batch_size=8)

    def collate(items):
        return {"tokens": np.stack([it["tokens"] for it in items])}
    eng, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=tgpt.make_loss_fn(cfg), model_parameters=params, device="cpu",
        training_data=data, collate_fn=collate, config=config)
    assert isinstance(loader, tdata.DeepSpeedDataLoader)
    assert loader.batch_size == 8 and len(loader) == 5
    jcfg = jgpt.GPTConfig(**FIELDS, dtype=jnp.float32)
    jloader = deepspeed_tpu.initialize(
        model=jgpt.make_loss_fn(jcfg), training_data=data, collate_fn=collate,
        model_parameters=numpy_params(jcfg), config=dict(config))[2]
    fed = deepspeed_tpu_torch.initialize(
        model=tgpt.make_loss_fn(cfg), model_parameters=params, device="cpu",
        config=config)[0]
    batches = list(jloader)
    it = iter(tdata.PrefetchLoader(tdata.RepeatingLoader(loader), eng))
    got = [float(eng.train_batch(next(it))["loss"]) for _ in range(6)]
    want = [float(fed.train_batch(b)["loss"])
            for b in batches + [next(iter(jloader))]]
    assert got == want
    for a, b in zip(ttree.tree_leaves(eng.params),
                    ttree.tree_leaves(fed.params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# SGD, Adagrad and a client optimizer
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "sgd": {"type": "sgd", "params": {"lr": 0.1}},
    "sgd-momentum": {"type": "sgd", "params": {"lr": 0.05, "momentum": 0.9}},
    "sgd-nesterov": {"type": "sgd", "params": {"lr": 0.05, "momentum": 0.9,
                                               "nesterov": True}},
    "adagrad": {"type": "adagrad", "params": {"lr": 0.05,
                                              "weight_decay": 0.01}},
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_sgd_and_adagrad_match_jax(name, devices):
    """The JAX engine's optimizer (its optax chain) and the port's on the
    same parameters and gradients for five updates under a warm-up
    schedule, to 1e-6; then, for Nesterov SGD and Adagrad, three engine
    steps each, to 1e-5."""
    config = dict(BASE, optimizer=OPTIMIZERS[name], scheduler={
        "type": "WarmupLR", "params": {"warmup_max_lr": 0.05,
                                       "warmup_num_steps": 3}},
        gradient_clipping=1.0)
    jeng, teng = _pair(config)
    rng = np.random.default_rng(0)
    p = {"a": {"kernel": rng.standard_normal((6, 5)).astype(np.float32)},
         "b": rng.standard_normal(7).astype(np.float32)}
    tp = ttree.tree_map(lambda a: torch.from_numpy(a.copy()), p)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jstate, tstate = jeng.optimizer.init(jp), teng.optimizer.init(tp)
    for _ in range(5):
        g = {"a": {"kernel": rng.standard_normal((6, 5)).astype(np.float32)},
             "b": rng.standard_normal(7).astype(np.float32)}
        upd, jstate = jeng.optimizer.update(
            jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)
        teng.optimizer.step(tp, ttree.tree_map(torch.from_numpy, g), tstate)
        for key, want in _leaves(jp).items():
            np.testing.assert_allclose(_leaves(params_to_numpy(tp))[key],
                                       want, rtol=1e-6, atol=1e-6,
                                       err_msg=key)
    assert tstate["count"] == 5
    if name in ("sgd-nesterov", "adagrad"):
        _compare_trajectories(jeng, teng, _tokens(3))


def test_client_optimizer(devices):
    """A client optimizer (any object with the port's ``init``/``step``
    protocol) trains as the config's optimizer of the same kind, bit for
    bit, its state goes through a checkpoint, and an object without the
    protocol raises TypeError."""
    cfg = tgpt.GPTConfig(**FIELDS, dtype=torch.float32)

    def engine(config, optimizer=None):
        return deepspeed_tpu_torch.initialize(
            model=tgpt.make_loss_fn(cfg), optimizer=optimizer, device="cpu",
            model_parameters=tgpt.init_params(cfg, seed=2, device="cpu"),
            config=config)[0]

    class Halving:
        """A client optimizer of its own: p -= lr * g, lr halving."""

        def init(self, params):
            return {"count": 0}

        def step(self, params, grads, state, sr_gen=None):
            lr = 0.1 * 0.5 ** state["count"]
            state["count"] += 1
            for p, g in zip(ttree.tree_leaves(params),
                            ttree.tree_leaves(grads)):
                p.sub_(lr * g)

    plain = {"train_batch_size": 4, "steps_per_print": 1000}
    client = engine(plain, tsgd.sgd(0.05, momentum=0.9))
    configured = engine(dict(plain, optimizer=OPTIMIZERS["sgd-momentum"]))
    batches = _tokens(3, rows=4)
    for b in batches:
        assert float(client.train_batch(b)["loss"]) == \
            float(configured.train_batch(b)["loss"])
    for a, b in zip(ttree.tree_leaves(client.opt_state["trace"]),
                    ttree.tree_leaves(configured.opt_state["trace"])):
        assert torch.equal(a, b)
    own = engine(plain, Halving())
    losses = [float(own.train_batch(batches[0])["loss"]) for _ in range(3)]
    assert losses[-1] < losses[0] and own.opt_state == {"count": 3}
    with pytest.raises(TypeError, match="protocol"):
        engine(plain, object())


# ---------------------------------------------------------------------------
# the seqlen curriculum
# ---------------------------------------------------------------------------

SCHEDULES = {
    "fixed_linear": {"total_curriculum_step": 50, "difficulty_step": 8},
    "fixed_root": {"total_curriculum_step": 50, "difficulty_step": 8,
                   "root_degree": 3},
    "fixed_discrete": {"difficulty": [8, 24, 40, 64],
                       "max_step": [5, 20, 33]},
}


@pytest.mark.parametrize("stype", sorted(SCHEDULES))
def test_curriculum_schedules_equal_jax(stype):
    """Every step of a range, through update_difficulty and
    get_difficulty, with a state round-trip half way."""
    config = {"curriculum_type": "seqlen", "min_difficulty": 8,
              "max_difficulty": 64, "schedule_type": stype,
              "schedule_config": SCHEDULES[stype]}
    js, ts = JCurriculum(dict(config)), TCurriculum(dict(config))
    for t in range(0, 70):
        assert ts.get_difficulty(t) == js.get_difficulty(t)
        assert ts.update_difficulty(t) == js.update_difficulty(t)
        if t == 30:
            again = TCurriculum(dict(config))
            again.set_state(ts.get_state())
            ts = again
        assert ts.get_state() == js.get_state()
    assert ts.get_current_difficulty() == 64
    with pytest.raises(RuntimeError, match="Unsupported"):
        TCurriculum(dict(config, schedule_type="nope"))
    with pytest.raises(ValueError, match="requires"):
        TCurriculum({"min_difficulty": 8})


CURRICULUM = {"enabled": True, "curriculum_type": "seqlen",
              "min_difficulty": 8, "max_difficulty": 32,
              "schedule_type": "fixed_linear",
              "schedule_config": {"total_curriculum_step": 3,
                                  "difficulty_step": 8}}


def test_curriculum_engine_trajectory_matches_jax(devices):
    """Two steps at the lengths 16 and 24 the schedule gives, through
    both engines' truncation: losses, gradient norms and the final
    parameters."""
    jeng, teng = _pair(dict(BASE, curriculum_learning=CURRICULUM),
                       remat=True)
    _compare_trajectories(jeng, teng, _tokens(2, width=33))
    assert teng.curriculum_scheduler.get_current_difficulty() == 24


def test_curriculum_truncates_packed_batches_in_step(devices):
    """A packed batch (``pack_documents``: segment ids, positions and an
    S - 1 loss mask) under the curriculum trains as the same batch cut by
    hand, bit for bit: segment ids and positions are cut with the tokens
    and the mask one shorter. The JAX engine cuts only its own keys and
    raises on the misaligned mask (ROADMAP.md, faults)."""
    rng = np.random.default_rng(4)
    docs = [rng.integers(1, 96, int(n)) for n in rng.integers(3, 20, 60)]
    batch = {k: v[:16] for k, v in tdata.pack_documents(docs, 33).items()}
    config = dict(BASE, curriculum_learning=CURRICULUM)
    cfg = tgpt.GPTConfig(**FIELDS, dtype=torch.float32)
    params = tgpt.init_params(cfg, seed=3, device="cpu")
    cut = deepspeed_tpu_torch.initialize(
        model=tgpt.make_loss_fn(cfg), model_parameters=params, device="cpu",
        config=config)[0]
    by_hand = deepspeed_tpu_torch.initialize(
        model=tgpt.make_loss_fn(cfg), model_parameters=params, device="cpu",
        config=BASE)[0]
    for d in (16, 24, 32):
        short = {k: v[:, :d - 1] if k == "loss_mask" else v[:, :d]
                 for k, v in batch.items()}
        assert float(cut.train_batch(batch)["loss"]) == \
            float(by_hand.train_batch(short)["loss"])
    jcfg = jgpt.GPTConfig(**FIELDS, dtype=jnp.float32)
    jeng = deepspeed_tpu.initialize(
        model=jgpt.make_loss_fn(jcfg), model_parameters=numpy_params(jcfg),
        config=dict(config))[0]
    with pytest.raises(ValueError, match="loss_mask width"):
        jeng.train_batch(batch)
    with pytest.raises(TypeError, match="set_curriculum_transform"):
        cut.train_batch([batch["tokens"]])
    cut.set_curriculum_transform(lambda b, d: {"tokens": b["tokens"][:, :9]})
    cut.train_batch(batch)


# ---------------------------------------------------------------------------
# progressive layer drop
# ---------------------------------------------------------------------------

def test_pld_schedule_equals_jax():
    for theta, gamma in ((0.5, 0.001), (0.3, 0.1), (1.0, 0.5)):
        jm, tm = jpld.ProgressiveLayerDrop(theta, gamma), \
            tpld.ProgressiveLayerDrop(theta, gamma)
        for t in range(0, 200, 7):
            want = float(jpld.theta_schedule(jnp.int32(t), theta, gamma))
            assert tpld.theta_schedule(t, theta, gamma) == pytest.approx(
                want, abs=1e-7)
            jm.update_state(t)
            tm.update_state(t)
            assert tm.get_theta() == pytest.approx(jm.get_theta(), abs=1e-12)
            assert tm.get_state() == pytest.approx(jm.get_state())
    assert tpld.PLD_THETA_KEY == jpld.PLD_THETA_KEY


def test_pld_theta_one_is_no_pld_and_matches_jax(devices):
    """At theta = 1 every layer is kept: the port's trajectory equals the
    JAX engine's with PLD on, and the port's without PLD bit for bit."""
    pld = {"enabled": True, "theta": 1.0, "gamma": 0.5}
    jeng, teng = _pair(dict(BASE, progressive_layer_drop=pld))
    batches = _tokens(3)
    _compare_trajectories(jeng, teng, batches)
    cfg = tgpt.GPTConfig(**FIELDS, dtype=torch.float32)
    npp = numpy_params(jgpt.GPTConfig(**FIELDS, dtype=jnp.float32), seed=10)
    plain = deepspeed_tpu_torch.initialize(
        model=tgpt.make_loss_fn(cfg), config=BASE, device="cpu",
        model_parameters=params_from_numpy(npp, cfg, device="cpu"))[0]
    for b in batches:
        plain.train_batch(b)
    for a, b in zip(ttree.tree_leaves(plain.params),
                    ttree.tree_leaves(teng.params)):
        assert torch.equal(a, b)


def test_pld_keep_rates_follow_the_jax_rule():
    """Layer l is kept with probability 1 - (l/L)(1 - theta), the JAX
    model's rule: each layer's rate over 4000 draws within 4.5 binomial
    standard deviations; layer 0 always."""
    L, theta, n = 8, 0.4, 4000
    gen = torch.Generator().manual_seed(0)
    kept = np.array([tgpt.pld_keep(theta, L, gen) for _ in range(n)])
    for layer in range(L):
        p = 1.0 - (layer / L) * (1.0 - theta)
        sd = math.sqrt(max(p * (1 - p), 1e-12) / n)
        assert abs(kept[:, layer].mean() - p) <= 4.5 * sd + 1e-12, layer
    assert kept[:, 0].all()
    # draws are independent across layers: pairs kept together at the
    # product of their rates
    both = (kept[:, 5] & kept[:, 7]).mean()
    p5, p7 = 1 - 5 / 8 * 0.6, 1 - 7 / 8 * 0.6
    assert abs(both - p5 * p7) <= 4.5 * math.sqrt(p5 * p7 / n)


def test_pld_dropped_layers_get_zero_gradients_and_remat_replays():
    """A dropped layer is not computed: its stacked gradient slices are
    zero, the kept layers' are not; under full checkpointing the
    recomputed backward sees the same decisions (the same loss and
    gradients)."""
    fields = dict(FIELDS, n_layers=6)
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(2).integers(0, 96, (2, 12)))}
    out = []
    for remat in (False, True):
        cfg = tgpt.GPTConfig(**fields, dtype=torch.float32, remat=remat,
                             remat_policy="full")
        params = tgpt.init_params(cfg, seed=1, device="cpu")
        leaves = [t.requires_grad_() for t in ttree.tree_leaves(params)]
        gen = torch.Generator().manual_seed(8)
        keep = tgpt.pld_keep(0.3, 6, torch.Generator().manual_seed(8))
        loss = tgpt.loss_fn(params, dict(batch, pld_theta=0.3), gen, cfg)
        grads = ttree.tree_unflatten(params, torch.autograd.grad(loss,
                                                                 leaves))
        out.append((float(loss.detach()), grads, keep))
    (l0, g0, keep), (l1, g1, _) = out
    assert not all(keep) and any(keep[1:])
    assert l0 == pytest.approx(l1, rel=1e-6)
    for a, b in zip(ttree.tree_leaves(g0), ttree.tree_leaves(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)
    qkv = g0["block"]["qkv"]["kernel"]
    for layer, k in enumerate(keep):
        assert bool(qkv[layer].abs().sum() > 0) == k, layer
    # deterministic (evaluation) forwards ignore the theta
    cfg = tgpt.GPTConfig(**fields, dtype=torch.float32)
    params = tgpt.init_params(cfg, seed=1, device="cpu")
    assert float(tgpt.loss_fn(params, dict(batch, pld_theta=0.3), None, cfg,
                              deterministic=True)) == \
        float(tgpt.loss_fn(params, batch, None, cfg, deterministic=True))


# ---------------------------------------------------------------------------
# the monitor and the timers
# ---------------------------------------------------------------------------

@pytest.fixture
def no_tensorboard(monkeypatch):
    """Both monitors without their optional TensorBoard writer (whose
    import takes seconds); the CSV and JSONL files are what is
    compared."""
    monkeypatch.setattr(jmonitor, "_try_tensorboard_writer",
                        lambda log_dir: None)
    monkeypatch.setattr(tmonitor, "_tensorboard_writer",
                        lambda log_dir: None)


def test_monitor_files_equal_jax(tmp_path, no_tensorboard):
    """The same scalars through both monitors (a summary mapping, a
    change of tags, then a resumed monitor on the same files): the CSV
    and JSONL files are byte for byte the JAX package's, with no second
    header on resume."""
    rounds = [
        [("Train/loss", 2.5, 4), ("Train/lr", 1e-3, 4)],
        [("Train/loss", 2.25, 8), ("Train/lr", 2e-3, 8)],
        [("Serve/ttft", {"p50": 1.5, "p99": 4.0}, 9)],
    ]
    resumed = [[("Train/loss", 2.0, 12), ("Train/lr", 3e-3, 12)]]
    for mod, name in ((jmonitor, "jax"), (tmonitor, "port")):
        m = mod.Monitor(output_path=str(tmp_path / name), job_name="job")
        for r in rounds:
            m.write_scalars(r)
        m.close()
        m = mod.Monitor(output_path=str(tmp_path / name), job_name="job")
        for r in resumed:
            m.write_scalars(r)
        m.flush()
        m.close()
    for f in ("scalars.csv", "scalars.jsonl"):
        assert (tmp_path / "port" / "job" / f).read_bytes() == \
            (tmp_path / "jax" / "job" / f).read_bytes()
    rows = list(csv.reader(open(tmp_path / "port" / "job" / "scalars.csv")))
    # one header, one for the change of tags, none for the resumed monitor
    assert sum(r[0] == "step" for r in rows) == 2 and len(rows) == 6
    off = tmonitor.Monitor(output_path=str(tmp_path / "off"), rank=1)
    off.write_scalars(rounds[0])
    assert not off.enabled and not (tmp_path / "off").exists()
    tmonitor.NoopMonitor().write_scalars(rounds[0])


def test_monitor_writes_one_csv_row_per_step(tmp_path, no_tensorboard):
    """Several steps in one ``write_scalars`` call (the engine's buffered
    flush) give the CSV and JSONL that the JAX monitor writes for one
    call per step; a change of tags within the call gets its header."""
    steps = [[("Train/loss", 2.5, 4), ("Train/lr", 1e-3, 4)],
             [("Train/loss", 2.25, 8), ("Train/lr", 2e-3, 8)],
             [("Serve/ttft", {"p50": 1.5, "p99": 4.0}, 9)],
             [("Train/loss", 2.0, 12), ("Train/lr", 3e-3, 12)]]
    jm = jmonitor.Monitor(output_path=str(tmp_path / "jax"), job_name="j")
    for step in steps:
        jm.write_scalars(step)
    jm.close()
    tm = tmonitor.Monitor(output_path=str(tmp_path / "port"), job_name="j")
    tm.write_scalars([s for step in steps[:2] for s in step])
    tm.write_scalars([s for step in steps[2:] for s in step])
    tm.close()
    for f in ("scalars.csv", "scalars.jsonl"):
        assert (tmp_path / "port" / "j" / f).read_bytes() == \
            (tmp_path / "jax" / "j" / f).read_bytes()
    rows = list(csv.reader(open(tmp_path / "port" / "j" / "scalars.csv")))
    assert [r[0] for r in rows] == ["step", "4", "8", "step", "9", "step",
                                    "12"]


def test_monitor_uses_a_tensorboard_writer_where_one_imports(tmp_path,
                                                            monkeypatch):
    calls = []

    class Writer:
        def add_scalar(self, tag, value, step):
            calls.append((tag, value, step))

        def flush(self):
            calls.append("flush")

        def close(self):
            calls.append("close")
    monkeypatch.setattr(tmonitor, "_tensorboard_writer",
                        lambda log_dir: Writer())
    m = tmonitor.Monitor(output_path=str(tmp_path), job_name="tb")
    m.write_scalars([("a", 1.5, 3), ("b", {"p50": 2.0}, 3)])
    m.flush()
    m.close()
    m.close()
    assert calls == [("a", 1.5, 3), ("b/p50", 2.0, 3), "flush", "close"]


def test_engine_monitor_rows_and_timers(tmp_path, no_tensorboard):
    """With ``tensorboard`` on, the engine writes the JAX engine's three
    scalars every ``steps_per_print`` steps: at 1 each step; at 2 the
    buffer of two steps in one write, and the tail at ``destroy``. Either
    way the CSV has one header and one row per step.
    ``wall_clock_breakdown`` records each train_batch."""
    cfg = tgpt.GPTConfig(**FIELDS, dtype=torch.float32)
    tags = ["Train/Samples/train_loss", "Train/Samples/lr",
            "Train/Samples/loss_scale"]
    for every in (1, 2):
        config = dict(BASE, train_batch_size=4, steps_per_print=every,
                      wall_clock_breakdown=True, tensorboard={
                          "enabled": True, "output_path": str(tmp_path),
                          "job_name": f"every{every}"})
        eng = deepspeed_tpu_torch.initialize(
            model=tgpt.make_loss_fn(cfg), config=config, device="cpu",
            model_parameters=tgpt.init_params(cfg, seed=0, device="cpu"))[0]
        losses = [float(eng.train_batch(b)["loss"])
                  for b in _tokens(3, rows=4)]
        job = tmp_path / f"every{every}"
        if every == 2:
            rows = list(csv.reader(open(job / "scalars.csv")))
            assert rows[0] == ["step"] + tags and len(rows) == 3
        eng.destroy()
        rows = list(csv.reader(open(job / "scalars.csv")))
        assert rows[0] == ["step"] + tags and len(rows) == 4
        assert [int(r[0]) for r in rows[1:]] == [4, 8, 12]
        np.testing.assert_allclose([float(r[1]) for r in rows[1:]],
                                   losses, rtol=1e-6)
        events = [json.loads(line) for line in open(job / "scalars.jsonl")]
        assert [e["step"] for e in events] == [4] * 3 + [8] * 3 + [12] * 3
        np.testing.assert_allclose(
            [e["value"] for e in events if e["tag"] == tags[0]], losses,
            rtol=1e-6)
        assert len(eng.timers("train_batch").elapsed_records) == 3
        assert eng.timers.means(["train_batch"])["train_batch"] > 0


def test_timers_match_jax():
    data = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0, 8.0]
    for p in (0.0, 0.1, 0.2, 0.5):
        assert ttimer.trim_mean(data, p) == jtimer.trim_mean(data, p)
    assert ttimer.trim_mean([], 0.1) == 0.0
    with pytest.raises(ValueError):
        ttimer.trim_mean(data, 1.5)
    timers = ttimer.SynchronizedWallClockTimer(torch.device("cpu"))
    t = timers("fwd")
    t.start(sync=True)
    with pytest.raises(RuntimeError, match="already been started"):
        t.start()
    t.stop(sync=True)
    with pytest.raises(RuntimeError, match="not started"):
        t.stop()
    t.start()
    t.stop(record=False)
    assert len(t.elapsed_records) == 1 and t.mean() >= 0.0
    timers.log(["fwd"], reset=False, memory_breakdown=True)
    assert timers.means(["fwd", "nope"]).keys() == {"fwd"}
    assert t.elapsed(reset=True) >= 0.0 and t.elapsed_records == []
    noop = ttimer.NoopTimer()
    noop("x").start()
    assert noop("x").elapsed() == 0.0 and noop.means(["x"]) == {}
    jt = jtimer.ThroughputTimer(batch_size=4, start_step=2,
                                steps_per_output=1000)
    tt = ttimer.ThroughputTimer(batch_size=4, start_step=2,
                                steps_per_output=1000,
                                device=torch.device("cpu"))
    for _ in range(5):
        for timer in (jt, tt):
            timer.start()
            timer.stop(global_step=True)
    assert (tt.global_step_count, tt.micro_step_count) == \
        (jt.global_step_count, jt.micro_step_count) == (5, 5)
    assert tt.avg_samples_per_sec() > 0
    assert ttimer.TRAIN_BATCH_TIMER == jtimer.TRAIN_BATCH_TIMER


# ---------------------------------------------------------------------------
# the flops profiler
# ---------------------------------------------------------------------------

def test_matmul_flop_count_is_exact_and_equals_jax(tmp_path):
    M, K, N = 64, 128, 32
    rng = np.random.default_rng(0)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)

    def tmatmul(x, y):
        return x @ y

    def jmatmul(x, y):
        return x @ y
    got = tprof.analyze_fn(tmatmul, torch.from_numpy(a), torch.from_numpy(b))
    want = jprof.analyze_fn(jmatmul, jnp.asarray(a), jnp.asarray(b))
    assert got["flops"] == want["flops"] == 2 * M * K * N
    assert got["macs"] == M * K * N and got["mfu"] is None
    assert got["bytes_accessed"] is None and got["duration_s"] > 0
    prof = tprof.FlopsProfiler(tmatmul, submodules={
        "half": (tmatmul, (torch.from_numpy(a[:, :K // 2]),
                           torch.from_numpy(b[:K // 2])))})
    prof.start_profile()
    prof.profile(torch.from_numpy(a), torch.from_numpy(b))
    assert prof.get_total_flops() == 2 * M * K * N
    assert prof.get_total_flops(as_string=True) == "524.29 KFLOPS"
    out = tmp_path / "profile.txt"
    prof.print_model_profile(output_file=str(out))
    text = out.read_text()
    assert "FlopCounterMode" in text and "half" in text
    prof.end_profile()
    assert prof.get_total_flops() == 0.0
    flops, macs, params = tprof.get_model_profile(
        tmatmul, args=(torch.from_numpy(a), torch.from_numpy(b)),
        print_profile=False, as_string=False)
    assert (flops, macs, params) == (2 * M * K * N, M * K * N, M * K)


@pytest.mark.parametrize("name", ["gpt2-small", "gpt2-1.5b", "gpt2-8b",
                                  "llama-7b"])
def test_analytic_model_profile_equals_jax(name):
    for seq in (None, 512):
        want = jprof.profiler.analytic_model_profile(
            jgpt.preset(name), seq_len=seq)
        got = tprof.analytic_model_profile(tgpt.preset(name), seq_len=seq)
        assert got == want


def test_engine_flops_profile(tmp_path):
    """The engine reports the profile step: the loss function's analytic
    count (``train_flops_per_token`` times the batch's tokens), a count
    set by ``set_flops_per_batch``, or, for a loss without an analytic
    count, FlopCounterMode's count of the step."""
    cfg = tgpt.GPTConfig(**FIELDS, dtype=torch.float32)
    out = tmp_path / "p.txt"
    config = dict(BASE, train_batch_size=4, flops_profiler={
        "enabled": True, "profile_step": 2, "output_file": str(out)})
    loss = tgpt.make_loss_fn(cfg)

    def engine(model):
        return deepspeed_tpu_torch.initialize(
            model=model, config=config, device="cpu",
            model_parameters=tgpt.init_params(cfg, seed=0, device="cpu"))[0]
    batches = _tokens(2, rows=4)
    eng = engine(loss)
    eng.train_batch(batches[0])
    assert not out.exists()
    eng.train_batch(batches[1])
    text = out.read_text()
    want = tgpt.train_flops_per_token(cfg, 16) * 4 * 16
    assert f"{want / 1e12:.3f} TF" in text and "analytic" in text
    assert "MFU" not in text            # no peak for the host
    eng = engine(loss)
    eng.set_flops_per_batch(3e12)
    for b in batches:
        eng.train_batch(b)
    assert "3.000 TF" in out.read_text()
    assert "set_flops_per_batch" in out.read_text()
    eng = engine(lambda p, b, r: tgpt.loss_fn(p, b, r, cfg))
    for b in batches:
        eng.train_batch(b)
    text = out.read_text()
    assert "FlopCounterMode" in text
    counted = float(text.split("step flops:")[1].split("(")[1]
                    .split(")")[0])
    assert 0.5 * want < counted < 2.0 * want


def test_engine_flops_profile_counts_the_layers_that_ran(tmp_path,
                                                         monkeypatch):
    """Under progressive layer drop the profile's analytic count has, for
    each micro step, only the layers its forward computed (the JAX
    package's per-token count at that depth), not every layer."""
    fields = dict(FIELDS, n_layers=6)
    # no checkpointing: one block call per layer that ran
    cfg = tgpt.GPTConfig(**fields, dtype=torch.float32, remat=False)
    out = tmp_path / "p.txt"
    config = dict(BASE, train_batch_size=4, train_micro_batch_size_per_gpu=2,
                  progressive_layer_drop={"enabled": True, "theta": 0.3,
                                          "gamma": 100.0},
                  flops_profiler={"enabled": True, "profile_step": 3,
                                  "output_file": str(out)})
    eng = deepspeed_tpu_torch.initialize(
        model=tgpt.make_loss_fn(cfg), config=config, device="cpu",
        model_parameters=tgpt.init_params(cfg, seed=0, device="cpu"))[0]
    blocks = []
    block = tgpt._block
    monkeypatch.setattr(tgpt, "_block",
                        lambda *a, **kw: blocks.append(1) or block(*a, **kw))
    batches = _tokens(3, rows=4)
    for b in batches[:2]:
        eng.train_batch(b)
    del blocks[:]
    eng.train_batch(batches[2])
    text = out.read_text()
    layers = json.loads(text.split("micro step ran: ")[1].split(")")[0])
    assert len(layers) == 2 and sum(layers) == len(blocks) < 12
    flops = float(text.split("step flops:")[1].split("(")[1].split(")")[0])
    want = sum(jgpt.train_flops_per_token(
        jgpt.GPTConfig(**dict(fields, n_layers=n)), 16) for n in layers) \
        * 2 * 16
    assert flops == pytest.approx(want, rel=1e-12)
    assert eng.loss_fn.layers_run is None
    with pytest.raises(NotImplementedError, match="module_depth"):
        deepspeed_tpu_torch.initialize(
            model=tgpt.make_loss_fn(cfg), device="cpu",
            config=dict(config, flops_profiler={"enabled": True,
                                                "module_depth": 2}),
            model_parameters=tgpt.init_params(cfg, seed=0, device="cpu"))


def test_throughput_timer_waits_only_where_it_reports(monkeypatch):
    """The meter waits for the device when its first window opens, at
    each ``steps_per_output`` report and when asked for its average; its
    windows count the steps the JAX meter counts."""
    waits = []
    monkeypatch.setattr(ttimer, "device_sync", waits.append)
    logged = []
    tt = ttimer.ThroughputTimer(batch_size=4, start_step=2,
                                steps_per_output=3, logging_fn=logged.append,
                                device=torch.device("cpu"))
    jt = jtimer.ThroughputTimer(batch_size=4, start_step=2,
                                steps_per_output=3, logging_fn=lambda m: None)
    for step in range(1, 10):
        for timer in (jt, tt):
            timer.start()
            timer.stop(global_step=True)
        assert len(waits) == {1: 0, 2: 0, 3: 2, 4: 2, 5: 2, 6: 3, 7: 3,
                              8: 3, 9: 4}[step], step
    assert [m.split(",")[0] for m in logged] == [
        f"epoch=0/micro_step={n}/global_step={n}" for n in (3, 6, 9)]
    assert (tt.global_step_count, tt.micro_step_count) == \
        (jt.global_step_count, jt.micro_step_count) == (9, 9)
    assert tt.avg_samples_per_sec() > 0 and len(waits) == 4
    tt.start()
    tt.stop(global_step=True)
    assert tt.avg_samples_per_sec() > 0 and len(waits) == 5

"""Pipeline parallelism across ranks: the port's GPipe, 1F1B and
interleaved 1F1B schedules over a ``pipe`` mesh axis, alone and with data
parallelism at ZeRO 1, fsdp at ZeRO 3 and tensor parallelism, in real
``gloo`` worlds of 2 and 4 processes on the host
(tests/torch_rank_worker.py in its ``pipe`` mode, one world per size
running every case of that size), against the JAX package's pipeline
loss and engine on the conftest's virtual devices, from the same seeded
numpy parameters and batches; and, without processes, the refusals.

The decoder is GPT-2's dialect with tied embeddings (the tied gradient is
summed over the stages). float32: losses, every gradient, gradient norms
and eval losses to rtol/atol 1e-5; the replicated leaves' gradients bit
for bit across the pipe group.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.runtime.pipe import engine as jpipe
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.parallel import mesh as tmesh
from deepspeed_tpu_torch.runtime.checkpointing import load_16bit_model
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.runtime.pipe import engine as tpipe
from test_torch_model import numpy_params, one_torch_thread  # noqa: F401
from test_torch_sequence_parallel import _spawn
from test_torch_zero_ranks import _collect, _jax_key, _shards

TOL = dict(rtol=1e-5, atol=1e-5)
GPT = dict(vocab_size=96, n_layers=4, n_heads=4, d_model=32, max_seq_len=32,
           use_flash_attention=False, remat=False)
MIN_SHARD = 16
TRAIN = {"train_batch_size": 8, "gradient_clipping": 1.0,
         "steps_per_print": 1000,
         "optimizer": {"type": "AdamW", "params": {"lr": 1e-2,
                                                   "weight_decay": 0.1}}}
# name -> (world, port mesh, JAX mesh, schedule, chunks, microbatches,
# ZeRO stage, config fields); "plain": the non-pipelined loss on the mesh
CASES = {
    "gpipe": (2, dict(pipe=2, data=1), None, "gpipe", 1, 4, 0,
              dict(remat=True)),
    "1f1b": (2, dict(pipe=2, data=1), None, "1f1b", 1, 4, 0, {}),
    "interleaved": (2, dict(pipe=2, data=1), None, "interleaved", 2, 4, 0,
                    {}),
    "chunked": (2, dict(pipe=2, data=1), None, "1f1b", 1, 2, 0,
                dict(loss_chunk=16)),
    "plain": (2, dict(pipe=2, data=1), None, "plain", 1, 1, 0, {}),
    "pipe4": (4, dict(pipe=4, data=1), None, "1f1b", 1, 8, 0, {}),
    "data2": (4, dict(pipe=2, data=2), None, "1f1b", 1, 2, 1, {}),
    "fsdp2": (4, dict(pipe=2, data=1, fsdp=2), None, "gpipe", 1, 2, 3, {}),
    "model2": (4, dict(pipe=2, data=1, model=2),
               dict(pipe=2, data=2, model=2), "1f1b", 1, 2, 1, {}),
}
# the cases whose one accumulation's gradients are held to the gradient
# of JAX's 1F1B pipeline loss over two stages (one dp rank: the gradient
# of the whole batch; every schedule computes the same function), and
# those whose eval loss is held to the JAX engine's
GRAD_CASES = ["gpipe", "1f1b", "interleaved", "chunked", "pipe4", "model2"]
EVAL_CASES = ["1f1b", "interleaved"]
# the cases held to another case's JAX engine, which computes the same
# function on the same mesh and config (the chunked loss is the loss;
# the plain loss on the pipe mesh is the pipelined one)
SAME_AS = {"chunked": "1f1b", "plain": "1f1b"}


def _config(name):
    world, mesh, _, _, _, _, stage, _ = CASES[name]
    return dict(TRAIN, mesh={"pipeline_parallel_size": mesh["pipe"],
                             "tensor_parallel_size": mesh.get("model", 1)},
                zero_optimization={"stage": stage,
                                   "stage3_min_shard_size": MIN_SHARD})


def _jax_mesh(name, devices):
    spec = CASES[name][2] or CASES[name][1]
    return jmesh.make_mesh(jmesh.MeshSpec(**spec),
                           devices[:int(np.prod(list(spec.values())))])


def _jax_loss(name, mesh, jcfg):
    _, spec, _, schedule, chunks, micro, _, fields = CASES[name]
    cfg = jgpt.GPTConfig(**{**GPT, **fields, "dtype": jnp.float32})
    if schedule == "plain":
        return jgpt.make_loss_fn(cfg)
    return jgpt.make_pipeline_loss_fn(cfg, mesh, spec["pipe"], micro,
                                      schedule=schedule,
                                      virtual_chunks=chunks)


def _jax_case(name, npp, batches, devices, jcfg):
    """JAX's engine rows (loss, grad norm), shard shapes and (EVAL_CASES)
    eval loss, and for the 1F1B case the gradients of its pipeline loss
    over the first batch."""
    mesh = _jax_mesh(name, devices)
    loss = _jax_loss(name, mesh, jcfg)
    tp = CASES[name][1].get("model", 1) > 1
    eng = deepspeed_tpu.initialize(
        model=loss, model_parameters=npp, config=_config(name), mesh=mesh,
        partition_rules=jgpt.gpt_pipeline_partition_rules(tp=tp))[0]
    eng.state = jax.device_put(eng.state, eng._state_shardings)
    out = dict(rows=[(float(m["loss"]), float(m["grad_norm"]))
                     for m in map(eng.train_batch, batches)],
               shards=_shards(eng.state.params))
    if name in EVAL_CASES:
        out["eval"] = float(eng.eval_batch(batches[-1])[0])
    if name == "1f1b":
        jp = jax.tree_util.tree_map(jnp.asarray, npp)
        b = {"tokens": jnp.asarray(batches[0]["tokens"])}
        with jax.set_mesh(mesh):
            g = jax.jit(jax.grad(lambda p: loss(p, b, jax.random.PRNGKey(0))
                                 ))(jp)
        out["grads"] = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                        jax.tree_util.tree_flatten_with_path(g)[0]}
    return out


@pytest.fixture(scope="module")
def pipe_worlds(tmp_path_factory, devices):
    """Both worlds' results and the JAX references, computed while the
    ranks run."""
    tmp = str(tmp_path_factory.mktemp("pipe"))
    jcfg = jgpt.GPTConfig(**GPT, dtype=jnp.float32)
    tcfg = tgpt.GPTConfig(**GPT, dtype=torch.float32)
    npp = numpy_params(jcfg, seed=6)
    rng = np.random.default_rng(12)
    batches = [{"tokens": rng.integers(1, 96, (8, 17))} for _ in range(3)]
    pipe = {name: dict(world=c[0], mesh=c[1], schedule=c[3], chunks=c[4],
                       micro=c[5], config=_config(name),
                       fields=dict(c[7]), plain=c[3] == "plain",
                       eval=name in EVAL_CASES)
            for name, c in CASES.items()}
    g = torch.Generator().manual_seed(4)
    explicit = dict(w=torch.randn(8, 6, 6, generator=g) / 3,
                    h=torch.randn(6, 1, generator=g),
                    x=torch.randn(4, 3, 6, generator=g),
                    t=torch.randn(4, 3, generator=g))
    inp = dict(fields=dict(GPT, dtype=torch.float32),
               params=params_from_numpy(npp, tcfg, device="cpu"),
               batches=batches, pipe=pipe, explicit=explicit,
               ckpt_dir=os.path.join(tmp, "ckpt"))
    inputs = os.path.join(tmp, "inputs.pkl")
    with open(inputs, "wb") as f:
        pickle.dump(inp, f)
    refs = {}
    worlds = {}
    for world in (2, 4):
        procs = _spawn(world, inputs, tmp, mode="pipe")
        for name in CASES:
            if CASES[name][0] == world and name not in SAME_AS:
                refs[name] = _jax_case(name, npp, batches, devices, jcfg)
        worlds[world] = _collect(world, procs, tmp)
    for name, other in SAME_AS.items():
        refs[name] = refs[other]
    return worlds, refs


def _ranks(worlds, name):
    return worlds[CASES[name][0]]


# ---------------------------------------------------------------------------
# the engine against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_training_matches_jax(pipe_worlds, name):
    """Three steps of the engine over the case's mesh: JAX's losses and
    gradient norms (clipped at 1.0) on every rank, each leaf's shard
    shape JAX's (the stacked layers' rows over ``pipe``)."""
    worlds, refs = pipe_worlds
    want = refs[name]
    for rank, r in enumerate(_ranks(worlds, name)):
        got = r[name]
        assert got["mesh"]["pipe"] == CASES[name][1]["pipe"]
        np.testing.assert_allclose(np.array([x[:2] for x in got["rows"]]),
                                   np.array(want["rows"]),
                                   err_msg=f"{name} rank {rank}", **TOL)
        for path, lay in got["layouts"].items():
            assert lay["store"] == want["shards"][_jax_key(path)], path
    qkv = _ranks(worlds, name)[0][name]["layouts"]["block/qkv/kernel"]
    assert qkv["store"][0] == GPT["n_layers"] // CASES[name][1]["pipe"]


@pytest.mark.parametrize("name", GRAD_CASES)
def test_gradients_match_jax(pipe_worlds, name):
    """One accumulation of the pipelined loss (no update): the loss (the
    JAX engine's first; also through ``eval_fn`` given the whole tree,
    of which each stage takes its rows) and the gradient of every leaf,
    each rank's compute box of it (its stage's rows, its model piece in
    the head-aligned qkv order), equal JAX's gradient of its 1F1B
    pipeline loss."""
    worlds, refs = pipe_worlds
    want = refs["1f1b"]["grads"]
    cfg = tgpt.GPTConfig(**GPT)
    tp = CASES[name][1].get("model", 1)
    cols = tgpt.tp_columns(cfg, tp) if tp > 1 else {}
    for rank, r in enumerate(_ranks(worlds, name)):
        got = r[name]
        np.testing.assert_allclose(got["loss"], refs[name]["rows"][0][0],
                                   **TOL)
        if got["whole"] is not None and tp == 1:
            np.testing.assert_allclose(got["whole"], got["loss"], **TOL)
        for path, g in got["grads"].items():
            w = want[_jax_key(path)]
            if path in cols:
                w = w[..., cols[path].numpy()]
            w = w[tuple(slice(a, b) for a, b in got["boxes"][path])]
            np.testing.assert_allclose(g, w, err_msg=f"{name} rank {rank} "
                                       f"{path}", **TOL)
        assert got["boxes"]["block/qkv/kernel"][0] == (
            got["coord"]["pipe"] * 4 // CASES[name][1]["pipe"],
            (got["coord"]["pipe"] + 1) * 4 // CASES[name][1]["pipe"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_replicated_gradients_are_bit_identical(pipe_worlds, name):
    """The leaves the pipeline replicates (the tied embedding, wpe, the
    final norm) have the same gradient bits on every stage of a pipe
    group: the tied sum over the stages, before the dp reduction."""
    worlds, _ = pipe_worlds
    groups = {}
    for r in _ranks(worlds, name):
        key = tuple(v for k, v in sorted(r[name]["coord"].items())
                    if k != "pipe")
        groups.setdefault(key, []).append(r[name]["grads"])
    for members in groups.values():
        assert len(members) == CASES[name][1]["pipe"]
        paths = [p for p in members[0] if not p.startswith("block/")]
        assert {"wte/embedding", "wpe/embedding", "ln_f/scale"} <= set(paths)
        for m in members[1:]:
            for p in paths:
                np.testing.assert_array_equal(m[p], members[0][p],
                                              err_msg=f"{name} {p}")


@pytest.mark.parametrize("name", EVAL_CASES)
def test_eval_batch_runs_eval_fn(pipe_worlds, name):
    """eval_batch of a 1F1B or interleaved loss goes through its
    ``eval_fn`` (the forward-only GPipe): JAX's eval loss after the
    steps."""
    worlds, refs = pipe_worlds
    for r in _ranks(worlds, name):
        np.testing.assert_allclose(r[name]["eval"], refs[name]["eval"],
                                   **TOL)


def test_stage_inputs_held(pipe_worlds):
    """1F1B holds at most min(M, 2(P - 1 - s) + 1) stage inputs on stage
    s (O(stages)); GPipe holds all M (O(microbatches)): the port's form
    of the JAX package's test_1f1b_activation_memory_bounded."""
    worlds, _ = pipe_worlds
    for name in ("1f1b", "pipe4", "data2", "model2", "gpipe", "fsdp2"):
        P, M = CASES[name][1]["pipe"], CASES[name][5]
        for r in _ranks(worlds, name):
            s = r[name]["coord"]["pipe"]
            peak = r[name]["stats"]["peak_inputs"]
            if CASES[name][3] == "gpipe":
                assert peak == M, (name, s, peak)
            else:
                assert peak <= min(M, 2 * (P - 1 - s) + 1), (name, s, peak)
    firsts = [r["pipe4"]["stats"]["peak_inputs"] for r in worlds[4]
              if r["pipe4"]["coord"]["pipe"] == 0]
    assert firsts == [7]      # below M = 8: the bound, not the batch


def test_sends_and_tied_sums_are_counted(pipe_worlds):
    """Each stage sends only messages its neighbour uses: per step and
    microbatch one activation forward and one cotangent back on every
    inner edge (1F1B, 2 stages: M of each a rank, none on the wrap-around),
    and one tied all-reduce per step."""
    worlds, _ = pipe_worlds
    steps, M = 3, CASES["1f1b"][5]
    for r in worlds[2]:
        c = r["1f1b"]["comm"]
        assert c["pipe_send"]["calls"] == steps * M
        assert c["pipe_recv"]["calls"] == steps * M
        assert c["pipe_send"]["bytes"] == c["pipe_recv"]["bytes"] > 0
        assert c["tied_all_reduce"]["calls"] == steps
        assert r["plain"]["comm"]["pipe_send"]["calls"] == 0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["1f1b", "interleaved"])
def test_explicit_losses_match_the_whole_composition(pipe_worlds, world,
                                                     name):
    """make_1f1b_loss_fn and make_interleaved_loss_fn over the stages (a
    stack of 8 tanh layers, a squared-error head, 4 microbatches): the
    loss, its eval (no gradients), and the gradients of each stage's rows,
    the head and x (summed over the stages, as JAX's psum), scaled by the
    incoming gradient, equal the same composition run whole."""
    worlds, _ = pipe_worlds
    for r in worlds[world]:
        e = r["explicit"]
        np.testing.assert_allclose(e[name]["loss"], e["ref"], **TOL)
        np.testing.assert_allclose(e[name]["eval"], e["ref"], **TOL)
        for got, want in zip(e[name]["grads"], e["want"]):
            np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_resumes_bit_for_bit(pipe_worlds):
    """The interleaved engine saved after two steps (every rank's pieces,
    the natural layer order) and loaded into a fresh one takes the third
    step to the same bits; a one-rank engine loads the same parameters;
    the consolidated tree holds them."""
    worlds, _ = pipe_worlds
    for r in worlds[2]:
        c = r["ckpt"]
        assert c["resumed"] == c["uninterrupted"]
        for k, v in c["live"].items():
            np.testing.assert_array_equal(c["one_loaded"][k], v, err_msg=k)
    r0 = worlds[2][0]["ckpt"]
    assert sorted(r0["consolidated"]) == sorted(r0["live"])
    for k, v in r0["live"].items():
        np.testing.assert_array_equal(r0["consolidated"][k], v, err_msg=k)


def test_16bit_export_equals_the_one_rank_file(pipe_worlds):
    """The pipeline engine's 16-bit export is whole and in JAX's layer
    order: the one-rank engine's file."""
    worlds, _ = pipe_worlds
    d = worlds[2][0]["ckpt"]["w16"]
    pp = load_16bit_model(os.path.join(d, "pp.npz"))
    with np.load(os.path.join(d, "pp.npz")) as a, \
            np.load(os.path.join(d, "one.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert pp["block"]["qkv"]["kernel"].shape[0] == GPT["n_layers"]


# ---------------------------------------------------------------------------
# refusals, without processes
# ---------------------------------------------------------------------------

def test_bad_schedules_raise_as_jax():
    for mod in (jpipe, tpipe):
        with pytest.raises(ValueError, match="virtual_chunks"):
            mod.make_pipelined_loss_fn(None, None, None, 4, 2, 4, None,
                                       None, schedule="interleaved",
                                       virtual_chunks=1)
        with pytest.raises(ValueError, match="unknown pipeline schedule"):
            mod.make_pipelined_loss_fn(None, None, None, 4, 2, 4, None,
                                       None, schedule="zigzag")


def test_layer_counts_that_do_not_split_raise_as_jax():
    """A layer count the stages (or stages x chunks) do not divide: the
    JAX package's assertion in both packages' GPT makers; the generic
    loss's ValueError where its stacked rows do not split into the
    virtual stages; and microbatches that do not divide the rows."""
    mesh = tmesh.make_mesh(tmesh.MeshSpec(data=1), world_size=1)
    for n_layers, stages, sched, v in ((6, 4, "1f1b", 1),
                                       (6, 2, "interleaved", 2)):
        jcfg = jgpt.GPTConfig(**{**GPT, "n_layers": n_layers},
                              dtype=jnp.float32)
        tcfg = tgpt.GPTConfig(**{**GPT, "n_layers": n_layers},
                              dtype=torch.float32)
        with pytest.raises(AssertionError):
            jgpt.make_pipeline_loss_fn(jcfg, None, stages, 2, schedule=sched,
                                       virtual_chunks=v)
        with pytest.raises(AssertionError):
            tgpt.make_pipeline_loss_fn(tcfg, mesh, stages, 2, schedule=sched,
                                       virtual_chunks=v)
    tcfg = tgpt.GPTConfig(**{**GPT, "n_layers": 6}, dtype=torch.float32)
    params = tgpt.init_params(tcfg, device="cpu")
    loss = tpipe.make_pipelined_loss_fn(
        lambda o, b: (b["x"], b["y"]), None, None,
        lambda p: (p["block"], {}), 1, 2, mesh, schedule="interleaved",
        virtual_chunks=4)
    with pytest.raises(ValueError, match="divisible by stages"):
        loss(params, {"x": torch.zeros(4, 3), "y": torch.zeros(4)}, None)
    loss = tgpt.make_pipeline_loss_fn(tcfg, mesh, 1, 4)
    with pytest.raises(AssertionError, match=r"\(6, 4\)"):
        loss(params, {"tokens": torch.zeros(6, 9, dtype=torch.long)}, None)


def test_pipe_with_sequence_names_its_item():
    cfg = tgpt.GPTConfig(**GPT, dtype=torch.float32)
    params = tgpt.init_params(cfg, device="cpu")
    mesh = tmesh.make_mesh(tmesh.MeshSpec(pipe=2, data=1, sequence=2),
                           world_size=4)
    with pytest.raises(NotImplementedError, match="1.3.4a"):
        DeepSpeedEngine(tgpt.make_pipeline_loss_fn(cfg, mesh, 2, 2), params,
                        DeepSpeedConfig(dict(TRAIN), world_size=1),
                        mesh=mesh, device="cpu")
    # a pipe axis without a process group
    mesh = tmesh.make_mesh(tmesh.MeshSpec(pipe=2, data=1), world_size=2)
    with pytest.raises(ValueError, match="init_distributed"):
        DeepSpeedEngine(tgpt.make_pipeline_loss_fn(cfg, mesh, 2, 2), params,
                        DeepSpeedConfig(dict(TRAIN), world_size=1),
                        mesh=mesh, device="cpu")

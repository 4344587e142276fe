"""The port's pipeline schedules and stage partitioning against the JAX
package's, without processes: every schedule's instruction stream, the
interleaved 1F1B tick tables and rank orders, the buffer depths, the
virtual-stage permutation, ``partition_uniform``/``partition_balanced``,
``PipelineModule`` with its tied groups (the cases of
tests/test_pipe_schedule.py and tests/test_pipe_interleaved.py), each
equal to the JAX module's output; the executor's tick tables and the
messages both sides of each send read from them; and the pipe group of
the mesh against ``PipelineParallelGrid`` and ``utils.groups``.
"""

import numpy as np
import pytest

from deepspeed_tpu.runtime.pipe import engine as jengine
from deepspeed_tpu.runtime.pipe import module as jmodule
from deepspeed_tpu.runtime.pipe import schedule as jschedule
from deepspeed_tpu_torch.parallel import mesh as tmesh
from deepspeed_tpu_torch.parallel import topology as ttopo
from deepspeed_tpu_torch.runtime.pipe import engine as tengine
from deepspeed_tpu_torch.runtime.pipe import module as tmodule
from deepspeed_tpu_torch.runtime.pipe import schedule as tschedule
from deepspeed_tpu_torch.utils import groups as tgroups
from test_torch_model import one_torch_thread  # noqa: F401

# (stages, chunks, microbatches): test_pipe_interleaved.py's cases
PVM = [(2, 1, 4), (4, 1, 8), (8, 1, 16), (2, 2, 4), (4, 2, 8), (4, 3, 12),
       (8, 4, 8), (2, 4, 8), (3, 2, 6)]
# (microbatches, stages): test_pipe_schedule.py's and a few more
MP = [(8, 4), (4, 2), (1, 3), (3, 4), (5, 5), (6, 1)]


def _stream(mod, cls, M, P, s):
    sched = getattr(mod, cls)(micro_batches=M, stages=P, stage_id=s)
    return ([[repr(c) for c in step] for step in sched.steps()],
            sched.num_pipe_buffers(), sched.is_first_stage,
            sched.is_last_stage)


@pytest.mark.parametrize("cls", ["TrainSchedule", "InferenceSchedule",
                                 "DataParallelSchedule"])
@pytest.mark.parametrize("M,P", MP)
def test_instruction_streams_match_jax(cls, M, P):
    for s in range(P):
        assert _stream(tschedule, cls, M, P, s) == \
            _stream(jschedule, cls, M, P, s), (cls, M, P, s)


def test_train_schedule_1f1b_shape():
    """test_pipe_schedule.py's checks on the port: M forwards and
    backwards and one epilogue per stage, P - 1 warmup forwards on the
    first stage, F/B alternation on the last, the buffer bound."""
    def flat(sched):
        return [c for step in sched.steps() for c in step]
    for stage in range(4):
        cmds = flat(tschedule.TrainSchedule(8, 4, stage))
        assert sum(isinstance(c, tschedule.ForwardPass) for c in cmds) == 8
        assert sum(isinstance(c, tschedule.BackwardPass) for c in cmds) == 8
        assert sum(isinstance(c, tschedule.OptimizerStep) for c in cmds) == 1
    kinds = [type(c).__name__ for c in flat(tschedule.TrainSchedule(8, 4, 0))
             if type(c).__name__ in ("ForwardPass", "BackwardPass")]
    assert kinds[:kinds.index("BackwardPass")].count("ForwardPass") == 4
    kinds = [type(c).__name__ for c in flat(tschedule.TrainSchedule(8, 4, 3))
             if type(c).__name__ in ("ForwardPass", "BackwardPass")]
    assert kinds[:4] == ["ForwardPass", "BackwardPass"] * 2
    assert [tschedule.TrainSchedule(8, 4, s).num_pipe_buffers()
            for s in (0, 2, 3)] == [4, 2, 2]


def test_instructions_compare_and_print_as_jax():
    for name in ("ForwardPass", "BackwardPass", "SendActivation",
                 "RecvGrad", "LoadMicroBatch"):
        t, j = getattr(tschedule, name), getattr(jschedule, name)
        assert repr(t(3)) == repr(j(3)) and t(3) == t(3) and t(3) != t(4)
        assert hash(t(3)) == hash(t(3))
    assert repr(tschedule.OptimizerStep()) == "OptimizerStep"
    assert tschedule.ForwardPass(3) != tschedule.BackwardPass(3)


@pytest.mark.parametrize("P,v,M", PVM)
def test_interleaved_tables_match_jax(P, v, M):
    """The tick tables, each rank's op order, the buffer depths and the
    virtual-stage permutation: the JAX package's, array for array."""
    got = tschedule.interleaved_1f1b_tables(P, v, M)
    want = jschedule.interleaved_1f1b_tables(P, v, M)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for d in range(P):
        assert tschedule._interleaved_rank_order(P, v, M, d) == \
            jschedule._interleaved_rank_order(P, v, M, d)
    assert tengine._buffer_depths(got, P, v, M) == \
        jengine._buffer_depths(want, P, v, M)
    for L in (P * v, 3 * P * v):
        np.testing.assert_array_equal(
            tengine.interleave_layer_perm(L, P, v),
            jengine.interleave_layer_perm(L, P, v))


def test_interleaved_needs_full_groups():
    for mod in (tschedule, jschedule):
        with pytest.raises(ValueError, match="divisible"):
            mod.interleaved_1f1b_tables(4, 2, 6)


@pytest.mark.parametrize("P,M", [(2, 4), (4, 8), (3, 6), (4, 4), (8, 16)])
def test_1f1b_tables_are_the_one_chunk_interleaved_tables(P, M):
    """The JAX 1F1B program's ticks (forward t - s, backward
    t - (2P - 2 - s)) are the interleaved tables at one chunk."""
    got = tengine.one_f_one_b_tables(P, M)
    want = jschedule.interleaved_1f1b_tables(P, 1, M)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _tables(kind, P, v, M):
    if kind == "gpipe":
        return tengine.gpipe_tables(P, M), 1
    if kind == "1f1b":
        return tengine.one_f_one_b_tables(P, M), 1
    return tschedule.interleaved_1f1b_tables(P, v, M), v


@pytest.mark.parametrize("kind,P,v,M", [
    ("gpipe", 2, 1, 4), ("gpipe", 4, 1, 3), ("1f1b", 2, 1, 4),
    ("1f1b", 4, 1, 8), ("1f1b", 3, 1, 2), ("interleaved", 2, 2, 4),
    ("interleaved", 4, 2, 8), ("interleaved", 2, 4, 8),
    ("interleaved", 3, 3, 6)])
def test_every_send_has_its_receive(kind, P, v, M):
    """The executor's protocol: at every tick, each message a device
    sends is received by its peer at the same tick, under the same tag,
    for the same chunk and microbatch; every forward but the last virtual
    stage's and every backward but the first's sends exactly one; every
    (chunk, microbatch) runs one forward and one backward on its
    device, its input having arrived at an earlier tick."""
    tab, v = _tables(kind, P, v, M)
    T = tab["fwd_c"].shape[1]
    arrived = {}
    done_f, done_b = set(), set()
    for t in range(T):
        per = [tengine.messages(tab, P, v, d, t) for d in range(P)]
        sent = sorted((d, peer, tag, c, m) for d in range(P)
                      for tag, peer, c, m in per[d][0])
        got = sorted((peer, d, tag, c, m) for d in range(P)
                     for tag, peer, c, m in per[d][1])
        assert sent == got, (kind, t)
        for d in range(P):
            if tab["fwd_valid"][d, t]:
                c, m = int(tab["fwd_c"][d, t]), int(tab["fwd_m"][d, t])
                if c * P + d > 0:
                    assert arrived.get(("act", d, c, m), T) < t
                done_f.add((d, c, m))
            if tab["bwd_valid"][d, t]:
                c, m = int(tab["bwd_c"][d, t]), int(tab["bwd_m"][d, t])
                assert (d, c, m) in done_f
                if c * P + d < v * P - 1:
                    assert arrived.get(("cot", d, c, m), T) < t
                done_b.add((d, c, m))
        for _, peer, tag, c, m in sent:
            arrived[("act" if tag == tengine.ACT else "cot", peer, c, m)] = t
    want = {(d, c, m) for d in range(P) for c in range(v) for m in range(M)}
    assert done_f == want and done_b == want
    n_send = sum(len(tengine.messages(tab, P, v, d, t)[0])
                 for d in range(P) for t in range(T))
    assert n_send == 2 * (v * P - 1) * M


def test_gpipe_tables_fill_then_drain():
    tab = tengine.gpipe_tables(3, 4)
    T1 = 4 + 3 - 1
    assert tab["fwd_c"].shape[1] == 2 * T1
    assert not tab["bwd_valid"][:, :T1].any()
    assert not tab["fwd_valid"][:, T1:].any()
    # the last stage starts the drain with the last microbatch
    assert tab["bwd_valid"][2, T1] and tab["bwd_m"][2, T1] == 3
    fwd = tengine.gpipe_tables(3, 4, backward=False)
    assert fwd["fwd_c"].shape[1] == T1 and not fwd["bwd_valid"].any()


# ---- partitioning ---------------------------------------------------------

@pytest.mark.parametrize("n,parts", [(10, 2), (10, 3), (2, 4), (7, 7),
                                     (0, 3), (48, 4)])
def test_partition_uniform_matches_jax(n, parts):
    assert tmodule.partition_uniform(n, parts) == \
        jmodule.partition_uniform(n, parts)


def _outcome(fn, *args):
    """A call's result, or the type of what it raised."""
    try:
        return fn(*args)
    except Exception as e:   # noqa: BLE001 - compared across packages
        return type(e).__name__


@pytest.mark.parametrize("seed,parts", [(0, 2), (1, 3), (2, 4), (3, 8),
                                        (4, 5)])
def test_partition_balanced_matches_jax(seed, parts):
    """The split, or the refusal where the greedy search finds none, as
    the JAX function (and the reference's) gives it."""
    w = list(np.random.default_rng(seed).integers(1, 50, 12).astype(float))
    assert _outcome(tmodule.partition_balanced, w, parts) == \
        _outcome(jmodule.partition_balanced, w, parts)
    heavy = [10, 1, 1, 1, 1, 10]
    assert tmodule.partition_balanced(heavy, 2) == \
        jmodule.partition_balanced(heavy, 2) == [0, 3, 6]


def _layers(mod):
    return [mod.TiedLayerSpec("Embed", None, lambda: 100, key="embed")] + \
        [mod.LayerSpec("Block", None, lambda: 10) for _ in range(6)] + \
        [mod.LayerSpec("Norm", None, lambda: 2)] + \
        [mod.TiedLayerSpec("Head", None, lambda: 100, key="embed")]


@pytest.mark.parametrize("method", ["uniform", "parameters", "type:Block",
                                    "type:(embed|head)"])
@pytest.mark.parametrize("stages", [2, 3, 4])
def test_pipeline_module_matches_jax(method, stages):
    """Parts, stage of each layer, layers of each stage, tied groups and
    their stages, describe()."""
    t = _outcome(tmodule.PipelineModule, _layers(tmodule), stages, method)
    j = _outcome(jmodule.PipelineModule, _layers(jmodule), stages, method)
    if isinstance(j, str):
        assert t == j
        return
    assert t.parts == j.parts and t.tied_groups == j.tied_groups
    assert [t.stage_of_layer(i) for i in range(len(t.layers))] == \
        [j.stage_of_layer(i) for i in range(len(j.layers))]
    assert [t.layers_of_stage(s) for s in range(stages)] == \
        [j.layers_of_stage(s) for s in range(stages)]
    assert t.tied_stages("embed") == j.tied_stages("embed")
    assert t.describe() == j.describe()


def test_pipeline_module_refusals_match_jax():
    for mod in (tmodule, jmodule):
        with pytest.raises(ValueError, match="no layers match"):
            mod.PipelineModule(_layers(mod), 2, "type:Conv")
        with pytest.raises(NotImplementedError):
            mod.PipelineModule(_layers(mod), 2, "random")


def test_layer_spec_builds_from_a_generator():
    import torch
    spec = tmodule.LayerSpec(
        "Dense", lambda gen: (torch.randn(2, 2, generator=gen),
                              lambda p, x, gen: x @ p), lambda: 4)
    p, apply = spec.build(torch.Generator().manual_seed(0))
    q, _ = spec.build(torch.Generator().manual_seed(0))
    assert torch.equal(p, q) and spec.param_count() == 4
    assert torch.equal(apply(p, torch.eye(2), None), p)


# ---- the pipe group -----------------------------------------------------

@pytest.mark.parametrize("pp,dp,mp", [(2, 1, 1), (4, 1, 1), (2, 2, 1),
                                      (2, 1, 2), (2, 2, 2), (4, 2, 1)])
def test_pipe_group_is_the_grid_of_the_topology(pp, dp, mp):
    """The mesh's pipe group of every rank (and ``utils.groups``' pipe
    rank and ranks) names the ranks ``PipelineParallelGrid`` gives over
    the same topology: its stage id, ``stage_to_global`` of every stage,
    and the neighbours of its ring groups."""
    topo = ttopo.PipeModelDataParallelTopology(num_pp=pp, num_mp=mp,
                                               num_dp=dp)
    n = pp * dp * mp
    registered = tgroups._MESH
    try:
        _check_ranks(topo, pp, dp, mp, n)
    finally:
        tgroups.set_mesh(registered)


def _check_ranks(topo, pp, dp, mp, n):
    for rank in range(n):
        mesh = tmesh.make_mesh(tmesh.MeshSpec(pipe=pp, data=dp, model=mp),
                               world_size=n, rank=rank)
        grid = ttopo.PipelineParallelGrid(topo, rank)
        group = mesh.group("pipe")
        assert group.ranks == tuple(grid.stage_to_global(s)
                                    for s in range(pp))
        assert group.index == grid.get_stage_id()
        assert mesh.coord["data"] == grid.get_data_parallel_id()
        assert mesh.coord["model"] == grid.get_model_parallel_rank()
        nxt = group.ranks[(group.index + 1) % pp]
        assert sorted([rank, nxt]) in grid.p2p_groups
        tgroups.set_mesh(mesh)
        assert tgroups.get_pipe_parallel_world_size() == pp
        assert tgroups.get_pipe_parallel_rank() == grid.get_stage_id()
        assert tgroups.get_pipe_parallel_ranks() == group.ranks
        assert tgroups.get_pipe_parallel_group() is None   # shape only

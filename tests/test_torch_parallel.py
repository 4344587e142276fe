"""The port's parallel layer against the JAX package's, without processes:
the topology math, the mesh shapes by ZeRO stage, the sharding specs of
GPT (stacked ``[L, ...]`` leaves) and BERT trees, the groups' queries,
and the bootstrap's environment resolution.

Specs are compared as tuples: ``tuple(jax PartitionSpec)`` against the
port's spec, leaf for leaf, on meshes of the same shape (the JAX ones over
the conftest's virtual devices, the port's a pure function of the world
size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.parallel import sharding as jsharding
from deepspeed_tpu.parallel import topology as jtopo
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.parallel import mesh as tmesh
from deepspeed_tpu_torch.parallel import sharding as tsharding
from deepspeed_tpu_torch.parallel import topology as ttopo
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.utils import distributed as tdist
from deepspeed_tpu_torch.utils import groups as tgroups
from test_torch_model import one_torch_thread  # noqa: F401

# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------

TOPOLOGIES = [
    ("ProcessTopology", dict(axes=["a", "b", "c"], dims=[2, 3, 2])),
    ("ProcessTopology", dict(axes=["pipe", "data"], dims=[4, 2])),
    ("PipeDataParallelTopology", dict(num_pp=2, num_dp=3)),
    ("PipeModelDataParallelTopology", dict(num_pp=2, num_mp=2, num_dp=2)),
]


@pytest.mark.parametrize("name,kw", TOPOLOGIES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(TOPOLOGIES)])
def test_topology_matches_jax(name, kw):
    j, t = getattr(jtopo, name)(**kw), getattr(ttopo, name)(**kw)
    assert t.get_axis_names() == j.get_axis_names()
    assert t.world_size() == j.world_size()
    assert str(t) == str(j)
    for axis in j.get_axis_names() + ["missing"]:
        assert t.get_dim(axis) == j.get_dim(axis)
        assert t.get_axis_comm_lists(axis) == j.get_axis_comm_lists(axis)
        for i in range(max(j.get_dim(axis), 1)):
            if axis != "missing":
                assert t.get_axis_list(axis, i) == j.get_axis_list(axis, i)
                assert t.filter_match(**{axis: i}) == \
                    j.filter_match(**{axis: i})
    for rank in range(j.world_size()):
        assert tuple(t.get_coord(rank)) == tuple(j.get_coord(rank))
        assert t.get_rank(**t.get_coord(rank)._asdict()) == rank
        for omit in (("data",), ()):
            assert t.get_rank_repr(rank, omit_axes=omit) == \
                j.get_rank_repr(rank, omit_axes=omit)
    with pytest.raises(ValueError):
        t.get_rank(**{t.get_axis_names()[0]: 0})
    with pytest.raises(ValueError):
        t.get_coord(j.world_size())


GRID_METHODS = ("get_stage_id", "get_data_parallel_id",
                "get_pipe_parallel_rank", "get_data_parallel_rank",
                "get_model_parallel_rank", "get_global_rank",
                "get_data_parallel_world_size",
                "get_pipe_parallel_world_size",
                "get_model_parallel_world_size", "is_first_stage",
                "is_last_stage")


@pytest.mark.parametrize("name,kw", TOPOLOGIES[1:],
                         ids=[n for n, _ in TOPOLOGIES[1:]])
def test_pipeline_grid_matches_jax(name, kw):
    for rank in range(getattr(jtopo, name)(**kw).world_size()):
        j = jtopo.PipelineParallelGrid(getattr(jtopo, name)(**kw), rank)
        t = ttopo.PipelineParallelGrid(getattr(ttopo, name)(**kw), rank)
        for m in GRID_METHODS:
            assert getattr(t, m)() == getattr(j, m)(), (rank, m)
        assert t.p2p_groups == j.p2p_groups
        for stage in range(j.get_pipe_parallel_world_size()):
            assert t.stage_to_global(stage) == j.stage_to_global(stage)
    # without a rank: this process's in the process group (0 without one)
    grid = ttopo.PipelineParallelGrid(getattr(ttopo, name)(**kw))
    assert grid.get_global_rank() == 0 == tdist.get_rank()


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,n", [
    (dict(), 8), (dict(data=2, fsdp=4), 8), (dict(model=2), 8),
    (dict(pipe=2, sequence=2), 4), (dict(data=1, fsdp=2), 2), (dict(), 1)])
def test_mesh_spec_resolves_as_jax(spec, n, devices):
    want = jmesh.MeshSpec(**spec).resolve(n)
    assert tmesh.MeshSpec(**spec).resolve(n) == want
    jm = jmesh.make_mesh(jmesh.MeshSpec(**spec), devices[:n])
    tm = tmesh.make_mesh(tmesh.MeshSpec(**spec), world_size=n)
    assert tm.shape == dict(zip(jm.axis_names, jm.devices.shape))
    assert tm.dims == want and not tm.ranked
    assert tmesh.dp_world_size(tm) == jmesh.dp_world_size(jm)
    for axis in tmesh.MESH_AXES:
        assert tmesh.axis_size(tm, axis) == jmesh.axis_size(jm, axis)
    if spec:    # an all-default spec takes any number of devices
        for mod in (jmesh, tmesh):
            with pytest.raises(AssertionError):
                mod.MeshSpec(**spec).resolve(n + 3)


MESH_CONFIGS = [
    (0, {}, 8), (1, {}, 4), (2, {}, 2), (3, {}, 8), (3, {}, 1),
    (3, {"replica_parallel_size": 2}, 8), (3, {"replica_parallel_size": 4},
                                           4),
    (1, {"tensor_parallel_size": 2}, 8),
    (3, {"pipeline_parallel_size": 2, "replica_parallel_size": 2}, 8),
    (2, {"sequence_parallel_size": 2}, 4)]


@pytest.mark.parametrize("stage,mesh,n", MESH_CONFIGS)
def test_mesh_from_config_matches_jax(stage, mesh, n, devices):
    """The axis sizes by stage: ZeRO 3 moves the dp degree onto fsdp,
    split by replica_parallel_size. The mesh is built from the port's own
    config (tp, sp and pp included) and through the shape arithmetic
    alone, which is a pure function of the world size."""
    d = {"train_batch_size": 8, "zero_optimization": {"stage": stage},
         "mesh": mesh}
    jm = jmesh.mesh_from_config(JConfig(d, world_size=n), devices[:n])
    want = dict(zip(jm.axis_names, jm.devices.shape))
    got = tmesh.mesh_spec_from_config(JConfig(d, world_size=n), n)
    assert dict(zip(tmesh.MESH_AXES, got.resolve(n))) == want
    tm = tmesh.mesh_from_config(TConfig(d, world_size=n), world_size=n)
    assert tm.shape == want


@pytest.mark.parametrize("stage,mesh,n,error", [
    (1, {"replica_parallel_size": 2}, 4, ValueError),
    (3, {"replica_parallel_size": 3}, 4, AssertionError),
    (0, {"tensor_parallel_size": 3}, 4, AssertionError)])
def test_mesh_from_config_errors_as_jax(stage, mesh, n, error, devices):
    d = {"train_batch_size": 12, "zero_optimization": {"stage": stage},
         "mesh": mesh}
    with pytest.raises(error):
        jmesh.mesh_from_config(JConfig(d, world_size=1), devices[:n])
    with pytest.raises(error):
        tmesh.mesh_spec_from_config(JConfig(d, world_size=1), n)


def test_mesh_groups_and_batch_rows():
    """Peer lists per axis group (row-major over the group's axes), a
    rank's index in them, and the rows of a micro batch a rank holds: the
    JAX package's batch sharding over (data, fsdp)."""
    topo = ttopo.ProcessTopology(list(tmesh.MESH_AXES), [1, 2, 2, 1, 1])
    for rank in range(4):
        m = tmesh.make_mesh(tmesh.MeshSpec(data=2, fsdp=2), world_size=4,
                            rank=rank)
        c = topo.get_coord(rank)
        assert m.coord == c._asdict()
        assert m.axis_index(tmesh.BATCH_AXES) == c.data * 2 + c.fsdp == rank
        assert m.group("data").ranks == (c.fsdp, c.fsdp + 2)
        assert m.group("fsdp").ranks == (2 * c.data, 2 * c.data + 1)
        assert tmesh.batch_rows(m, 8) == slice(2 * rank, 2 * rank + 2)
        assert m.group("data").pg is None   # a shape-only mesh
    assert sorted(map(sorted, m.peer_lists(("data",)))) == [[0, 2], [1, 3]]
    with pytest.raises(ValueError, match="does not split"):
        tmesh.batch_rows(m, 6)
    assert tmesh.batch_pspec() == tuple(jmesh.batch_pspec())
    assert tmesh.replicated(m).spec == ()
    assert tmesh.batch_sharding(m)(np.zeros((8, 3))).shard_shape(
        (8, 3)) == (2, 3)


@pytest.mark.parametrize("spec", [dict(data=8), dict(data=2, fsdp=2,
                                                     model=2),
                                  dict(pipe=2, fsdp=4)])
def test_groups_queries_match_jax(spec, devices):
    jgroups.set_mesh(jmesh.make_mesh(jmesh.MeshSpec(**spec), devices))
    tgroups.set_mesh(tmesh.make_mesh(tmesh.MeshSpec(**spec), world_size=8))
    for name in ("get_world_size", "get_data_parallel_world_size",
                 "get_model_parallel_world_size",
                 "get_pipe_parallel_world_size",
                 "get_sequence_parallel_world_size",
                 "get_expert_parallel_world_size"):
        assert getattr(tgroups, name)() == getattr(jgroups, name)(), name
    for experts in (1, 2, 16):
        assert tgroups.get_expert_parallel_world_size(experts) == \
            jgroups.get_expert_parallel_world_size(experts)
        assert tgroups.get_expert_data_parallel_world_size(experts) == \
            jgroups.get_expert_data_parallel_world_size(experts)
    assert tgroups.get_global_rank() == 0
    # a group is a process group in the port: none on a shape-only mesh
    assert tgroups.get_data_parallel_group() is None
    assert tgroups.get_model_parallel_group() is None


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------

def _gpt_tree():
    cfg = jgpt.GPTConfig(vocab_size=512, n_layers=3, n_heads=4, d_model=256,
                         max_seq_len=64, dtype=jnp.float32)
    return jax.eval_shape(lambda k: jgpt.init_params(k, cfg),
                          jax.random.PRNGKey(0))


def _bert_tree():
    cfg = jbert.BertConfig(vocab_size=1024, n_layers=2, n_heads=4,
                           d_model=128, max_seq_len=128, dtype=jnp.float32)
    return jax.eval_shape(lambda k: jbert.init_params(k, cfg),
                          jax.random.PRNGKey(0))


def _port_tree(shapes):
    """The same tree with meta tensors (the port's leaves)."""
    return jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), shapes)


def _flat(tree, is_spec):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=is_spec)[0]}


MESHES = [dict(fsdp=2, data=1), dict(fsdp=4, data=1), dict(fsdp=8, data=1),
          dict(data=2), dict(data=4), dict(data=2, fsdp=2),
          dict(data=2, fsdp=2, model=2), dict(data=1, fsdp=4, model=2)]


@pytest.mark.parametrize("tree", ["gpt", "bert"])
@pytest.mark.parametrize("min_shard", [1, 1024])
@pytest.mark.parametrize("rules", [False, True], ids=["no-rules",
                                                      "megatron"])
def test_param_and_opt_state_specs_equal_jax(tree, min_shard, rules,
                                             devices):
    """For every mesh shape, ZeRO stage 0-3: ``param_specs`` and
    ``opt_state_specs`` (over a ``{count, mu, nu}`` state) equal the JAX
    package's PartitionSpecs as tuples, and each spec's shard shape is
    ``NamedSharding.shard_shape``'s."""
    shapes = _gpt_tree() if tree == "gpt" else _bert_tree()
    ported = _port_tree(shapes)
    jrules = jsharding.megatron_rules() if rules else None
    trules = tsharding.megatron_rules() if rules else None
    jopt = {"count": jax.ShapeDtypeStruct((), jnp.int32), "mu": shapes,
            "nu": shapes}
    topt = {"count": torch.zeros((), dtype=torch.int32), "mu": ported,
            "nu": ported}
    is_p = (lambda x: isinstance(x, jax.sharding.PartitionSpec))
    sharded = set()
    for spec in MESHES:
        n = int(np.prod(list(spec.values())))
        jm = jmesh.make_mesh(jmesh.MeshSpec(**spec), devices[:n])
        tm = tmesh.make_mesh(tmesh.MeshSpec(**spec), world_size=n)
        for stage in range(4):
            kw = dict(zero_stage=stage, min_shard_size=min_shard)
            jp = jsharding.param_specs(shapes, jm, rules=jrules, **kw)
            tp = tsharding.param_specs(ported, tm.shape, rules=trules, **kw)
            jo = jsharding.opt_state_specs(jopt, jp, shapes, jm, **kw)
            to = tsharding.opt_state_specs(topt, tp, ported, tm, **kw)
            for jt, tt in ((jp, tp), (jo, to)):
                want = _flat(jt, is_p)
                got = _flat(tt, lambda x: isinstance(x, tuple))
                assert sorted(got) == sorted(want)
                for k in want:
                    assert got[k] == tuple(want[k]), (spec, stage, k)
                    sharded |= {a for e in got[k] if e for a in
                                (e if isinstance(e, tuple) else (e,))}
            named = tsharding.to_named(tp, tm)
            for (k, leaf), j in zip(
                    jax.tree_util.tree_flatten_with_path(shapes)[0],
                    jax.tree_util.tree_leaves(jp, is_leaf=is_p)):
                t = _flat(named, lambda x: isinstance(
                    x, tsharding.NamedSharding))[jax.tree_util.keystr(k)]
                assert t.shard_shape(leaf.shape) == \
                    jax.sharding.NamedSharding(jm, j).shard_shape(leaf.shape)
    if min_shard == 1:
        assert {"fsdp", "data"} <= sharded
    if rules:
        assert "model" in sharded


def test_add_axis_stacks_onto_a_sharded_dim():
    """``_add_axis`` (JAX ``sharding.py:186-200``): with no free divisible
    dim left, the axis stacks onto a sharded one that stays divisible."""
    sizes = {"fsdp": 2, "data": 2, "model": 2}
    for spec, shape in [((None, "fsdp"), (3, 8)), (("fsdp",), (8,)),
                        (("model", None), (8, 3)),
                        ((None, "fsdp"), (3, 6)), ((), (5,))]:
        j = jsharding._add_axis(jax.sharding.PartitionSpec(*spec), shape,
                                "data", 2, 1, mesh_shape=sizes)
        t = tsharding._add_axis(tuple(spec), shape, "data", 2, 1,
                                mesh_shape=sizes)
        assert t == tuple(j), (spec, shape)
        assert tsharding._add_fsdp_axis(tuple(spec), shape, 2, 1) == tuple(
            jsharding._add_fsdp_axis(jax.sharding.PartitionSpec(*spec),
                                     shape, 2, 1))
    assert tsharding._add_axis((None, "fsdp"), (3, 8), "data", 2, 1,
                               mesh_shape=sizes) == (None, ("fsdp", "data"))


def test_partition_rules_match_jax():
    jr, tr = jsharding.megatron_rules(), tsharding.megatron_rules()
    assert [r.pattern.pattern for r in tr] == [r.pattern.pattern for r in jr]
    assert [r.spec for r in tr] == [tuple(r.spec) for r in jr]
    for path in ("block/qkv/kernel", "block/mlp_out/kernel", "wte/embedding",
                 "ln_f/scale"):
        for shape in ((3, 8, 24), (8,)):
            j = jsharding._rule_spec_for(path, shape, jr)
            t = tsharding._rule_spec_for(path, shape, tr)
            assert t == (None if j is None else tuple(j))


# ---------------------------------------------------------------------------
# the bootstrap
# ---------------------------------------------------------------------------

ENV_KEYS = ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "MASTER_ADDR",
            "MASTER_PORT", "DSTPU_COORDINATOR", "DSTPU_NUM_PROCESSES",
            "DSTPU_PROCESS_ID", "RANK", "WORLD_SIZE", "LOCAL_RANK",
            "OMPI_COMM_WORLD_LOCAL_RANK", "DSTPU_LOCAL_RANK")


@pytest.mark.parametrize("env,args,want", [
    ({}, {}, (None, None, None)),
    ({"OMPI_COMM_WORLD_SIZE": "4", "OMPI_COMM_WORLD_RANK": "2",
      "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234"}, {},
     ("tcp://10.0.0.1:1234", 4, 2)),
    ({"OMPI_COMM_WORLD_SIZE": "4", "OMPI_COMM_WORLD_RANK": "2"}, {},
     ("tcp://127.0.0.1:29500", 4, 2)),
    ({"OMPI_COMM_WORLD_SIZE": "4", "OMPI_COMM_WORLD_RANK": "2",
      "DSTPU_COORDINATOR": "h:9", "DSTPU_NUM_PROCESSES": "2",
      "DSTPU_PROCESS_ID": "1"}, {"auto_mpi_discovery": False},
     ("tcp://h:9", 2, 1)),
    ({"DSTPU_COORDINATOR": "h:9", "DSTPU_NUM_PROCESSES": "2",
      "DSTPU_PROCESS_ID": "1", "RANK": "5", "WORLD_SIZE": "8"}, {},
     ("tcp://h:9", 2, 1)),
    ({"RANK": "5", "WORLD_SIZE": "8", "MASTER_ADDR": "m",
      "MASTER_PORT": "77"}, {}, ("tcp://m:77", 8, 5)),
    ({"RANK": "5", "WORLD_SIZE": "8"},
     {"init_method": "file:///x/store", "num_processes": 2,
      "process_id": 0}, ("file:///x/store", 2, 0)),
    ({}, {"coordinator_address": "a:1", "num_processes": 3,
          "process_id": 2}, ("tcp://a:1", 3, 2)),
], ids=["none", "mpi", "mpi-defaults", "mpi-off", "dstpu-before-torchrun",
        "torchrun", "explicit-init-method", "explicit-coordinator"])
def test_init_distributed_resolution_order(env, args, want, monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw = dict(coordinator_address=None, num_processes=None,
              process_id=None, auto_mpi_discovery=True, init_method=None)
    kw.update(args)
    assert tdist._resolve(**kw) == want
    if want[0] is None:
        # one process: a no-op that forms no group
        assert tdist.init_distributed(device="cpu") is True
        assert not tdist.is_initialized()
        assert (tdist.get_rank(), tdist.get_world_size()) == (0, 1)
        tdist.barrier()


def test_init_distributed_backend_and_local_rank(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert tdist.default_backend("cpu") == "gloo"
    assert tdist.default_backend(None) == "nccl"
    assert tdist.default_backend("cuda:1") == "nccl"
    assert tdist.get_local_rank(3) == 3
    monkeypatch.setenv("DSTPU_LOCAL_RANK", "1")
    assert tdist.get_local_rank(3) == 1
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert tdist.get_local_rank(3) == 2
    with pytest.raises(ValueError, match="num_processes"):
        tdist._resolve("a:1", None, None, True, None)
    if not torch.cuda.is_available():
        # ranks on the card without one raise; nothing falls back
        with pytest.raises(RuntimeError, match="gloo"):
            tdist.init_distributed(coordinator_address="127.0.0.1:1",
                                   num_processes=2, process_id=0)
    assert not tdist.is_initialized()

"""Data parallelism and ZeRO stages 0-3 across ranks: the port's engine
in real ``gloo`` worlds of 2 and 4 processes on the host
(tests/torch_rank_worker.py, one world per size running every case of
that size) against the JAX engine on the conftest's virtual devices
(``mesh=make_mesh(MeshSpec(...), devices[:n])``), from the same seeded
numpy parameters and global batches.

float32, rtol/atol 1e-5 for losses, gradient norms and the gathered
final parameters: the JAX stages compute one function (its own
``tests/test_engine.py test_zero_matches_ddp``), so JAX stage 0 holds the
port's stages 0-2 and JAX stage 3 the port's stage 3. The worlds
rendezvous through a ``FileStore`` in the test's temporary directory;
a rank that fails kills the others.
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.parallel import sharding as jsharding
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.runtime import dataloader as tdata
from test_torch_bert import _mlm_batch
from test_torch_bert import numpy_params as bert_numpy_params
from test_torch_model import numpy_params, one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
FP16_TOL = dict(rtol=5e-4, atol=5e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_rank_worker.py")
GPT = dict(vocab_size=96, n_layers=2, n_heads=4, d_model=32, max_seq_len=32)
BERT = dict(vocab_size=97, n_layers=2, n_heads=2, d_model=64,
            max_seq_len=128, dropout=0.0)
MIN_SHARD = 64      # [L, 32] norms stay whole, 96- and 128-wide dims shard
GPT_CONFIG = {
    "train_batch_size": 8, "gradient_accumulation_steps": 2,
    "gradient_clipping": 1.0, "steps_per_print": 1000,
    "optimizer": {"type": "AdamW", "params": {"lr": 2e-3,
                                              "weight_decay": 0.1}}}
BERT_CONFIG = {
    "train_batch_size": 8, "gradient_accumulation_steps": 2,
    "gradient_clipping": 1.0, "steps_per_print": 1000,
    "zero_optimization": {"stage": 1, "stage3_min_shard_size": MIN_SHARD},
    "optimizer": {"type": "LAMB", "params": {"lr": 2e-3,
                                             "weight_decay": 0.01}}}
FP16_CONFIG = {
    "train_batch_size": 4, "steps_per_print": 1000,
    "fp16": {"enabled": True, "initial_scale_power": 8, "hysteresis": 1},
    "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
GEN_CONFIG = {
    "train_batch_size": 4, "steps_per_print": 1000,
    "bf16": {"enabled": True, "memory_efficient": True},
    "progressive_layer_drop": {"enabled": True, "theta": 0.5, "gamma": 0.5},
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}}


def _gpt_batches(n=4):
    """Packed documents of uneven lengths, each row's loss_mask cut short
    by 0, 2, 4 or 6 tokens at its tail: the ranks' rows of a micro batch
    hold different loss_mask counts."""
    rng = np.random.default_rng(21)
    out = []
    for _ in range(n):
        docs = [rng.integers(1, 96, int(k)) for k in rng.integers(2, 14, 30)]
        b = {k: v[:8].copy() for k, v in
             tdata.pack_documents(docs, 17).items()}
        for r in range(8):
            b["loss_mask"][r, 16 - 2 * (r % 4):] = 0
        out.append(b)
        assert out[-1]["tokens"].shape == (8, 17)
    return out


def _fp16_batches():
    rng = np.random.default_rng(5)
    out = []
    for i in range(3):
        x = rng.standard_normal((4, 16)).astype(np.float32)
        if i == 0:
            x[2:] = 1e5     # rank 1's rows: inf in float16
        out.append({"x": x, "y": rng.standard_normal(4).astype(np.float32)})
    return out


def _fp16_params():
    rng = np.random.default_rng(6)
    return {"w1": (0.2 * rng.standard_normal((16, 16))).astype(np.float32),
            "w2": (0.2 * rng.standard_normal((16, 1))).astype(np.float32)}


def _spawn(world, inputs, tmp):
    store = os.path.join(tmp, f"store{world}")
    procs = []
    for r in range(world):
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(world), str(r), store, inputs,
             os.path.join(tmp, f"w{world}r{r}.pkl")], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def _collect(world, procs, tmp, timeout=300):
    errs = {}
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            errs[r] = (p.returncode, err)
            if p.returncode:
                break
    finally:
        for p in procs:   # a failed or hung rank must not orphan the rest
            if p.poll() is None:
                p.kill()
    for r, (rc, err) in errs.items():
        assert rc == 0, f"world {world} rank {r} rc={rc}\n{err[-3000:]}"
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"w{world}r{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _jax_run(loss_fn, params, config, mesh, batches):
    eng = deepspeed_tpu.initialize(model=loss_fn, model_parameters=params,
                                   config=dict(config), mesh=mesh)[0]
    # the fresh state placed as the first step leaves it: one compile
    eng.state = jax.device_put(eng.state, eng._state_shardings)
    rows = []
    for b in batches:
        m = eng.train_batch(b)
        rows.append((float(m["loss"]), float(m["grad_norm"]),
                     float(m["loss_scale"]), bool(m["overflow"])))
    return eng, rows


def _flat_jax(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_key(path):
    """``block/qkv/kernel`` -> ``['block']['qkv']['kernel']`` (the port's
    trees have the JAX package's keys)."""
    return "['" + path.replace("/", "']['") + "']"


def _port_path(jax_key):
    """``['block']['qkv']['kernel']`` -> ``block/qkv/kernel``."""
    return "/".join(jax_key[2:-2].split("']['"))


def _shards(tree):
    """{keystr: shard shape} of a tree of sharded JAX arrays."""
    return {jax.tree_util.keystr(k): tuple(v.sharding.shard_shape(v.shape))
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _stage(n):
    return dict(GPT_CONFIG, zero_optimization={
        "stage": n, "stage3_min_shard_size": MIN_SHARD})


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, devices):
    """Both worlds' results and the JAX references, the references
    computed while the ranks run."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    jcfg = jgpt.GPTConfig(**GPT, dtype=jnp.float32)
    tcfg = tgpt.GPTConfig(**GPT, dtype=torch.float32)
    npp = numpy_params(jcfg, seed=3)
    jbcfg = jbert.BertConfig(**BERT, dtype=jnp.float32)
    tbcfg = tbert.BertConfig(**BERT, dtype=torch.float32)
    bnpp = bert_numpy_params(jbcfg, seed=4)
    rng = np.random.default_rng(7)
    bert_batches = [_mlm_batch(rng, B=8, S=16) for _ in range(3)]
    gen = np.random.default_rng(9).integers(1, 96, (2, 17))
    inp = dict(
        gpt_fields=dict(GPT, dtype=torch.float32), gpt_config=GPT_CONFIG,
        gpt_params=params_from_numpy(npp, tcfg, device="cpu"),
        gpt_batches=_gpt_batches(), min_shard=MIN_SHARD,
        bert_fields=dict(BERT, dtype=torch.float32), bert_config=BERT_CONFIG,
        bert_params=params_from_numpy(bnpp, tbcfg, device="cpu"),
        bert_batches=bert_batches,
        fp16_config=FP16_CONFIG, fp16_batches=_fp16_batches(),
        fp16_params={k: torch.from_numpy(v)
                     for k, v in _fp16_params().items()},
        gen_config=GEN_CONFIG,
        # rank 1's rows repeat rank 0's: equal masks would give equal
        # per-rank losses
        gen_batches=[{"tokens": np.concatenate([gen, gen])}] * 3,
        ckpt_dir=os.path.join(tmp, "ckpt"))
    inputs = os.path.join(tmp, "inputs.pkl")
    with open(inputs, "wb") as f:
        pickle.dump(inp, f)
    procs = _spawn(2, inputs, tmp)

    refs = {"inp": inp, "npp": npp}
    batches = inp["gpt_batches"]
    mesh2 = jmesh.make_mesh(jmesh.MeshSpec(data=2), devices[:2])
    fsdp2 = jmesh.make_mesh(jmesh.MeshSpec(data=1, fsdp=2), devices[:2])
    loss = jgpt.make_loss_fn(jcfg)
    jeng0, refs["stage0"] = _jax_run(loss, npp, _stage(0), mesh2,
                                     batches[:3])
    refs["stage0_params"] = _flat_jax(jeng0.params)
    refs["stage0_eval"] = float(jeng0.eval_batch(batches[3])[0])
    jeng3, refs["stage3"] = _jax_run(loss, npp, _stage(3), fsdp2,
                                     batches[:3])
    refs["stage3_params"] = _flat_jax(jeng3.params)
    refs["stage3_shards"] = _shards(jeng3.state.params)
    refs["mesh2"] = mesh2
    jb, refs["bert"] = _jax_run(jbert.make_loss_fn(jbcfg), bnpp,
                                BERT_CONFIG, mesh2, bert_batches)
    refs["bert_params"] = _flat_jax(jb.params)

    def jfp16(p, b, rng):
        h = jnp.tanh(b["x"] @ p["w1"])
        return jnp.mean(((h @ p["w2"])[:, 0] - b["y"]) ** 2)
    jf, refs["fp16"] = _jax_run(jfp16, _fp16_params(), FP16_CONFIG, mesh2,
                                inp["fp16_batches"])
    refs["fp16_params"] = _flat_jax(jf.params)
    refs["fp16_scale"] = jf.state.scale_state
    refs["fp16_skipped"] = jf.skipped_steps
    w2 = _collect(2, procs, tmp)

    procs = _spawn(4, inputs, tmp)
    mesh4 = jmesh.make_mesh(jmesh.MeshSpec(data=2, fsdp=2), devices[:4])
    jeng4, refs["rep2"] = _jax_run(
        loss, npp, dict(_stage(3), mesh={"replica_parallel_size": 2}), mesh4,
        batches[:3])
    refs["rep2_params"] = _flat_jax(jeng4.params)
    refs["rep2_shards"] = _shards(jeng4.state.params)
    refs["rep2_opt_specs"] = jsharding.opt_state_specs(
        jeng4.state.params, jeng4.param_pspecs, jeng4.state.params, mesh4,
        zero_stage=3, min_shard_size=MIN_SHARD)
    refs["mesh4"] = mesh4
    w4 = _collect(4, procs, tmp)
    return w2, w4, refs


def _close(got_rows, want_rows, what, tol=TOL):
    got = np.array([r[:2] for r in got_rows])
    want = np.array([r[:2] for r in want_rows])
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _params_close(got, want, what, tol=TOL):
    """The worker's {path: array} against a flattened JAX tree."""
    got = {_jax_key(k): v for k, v in got.items()}
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what} {k}",
                                   **tol)


def test_packed_rows_give_the_ranks_different_mask_counts(worlds):
    """The premise of the parity cases below: in every micro batch the two
    ranks' rows hold different loss_mask counts, so a mean of the per-rank
    means would not be the global mean."""
    _, _, refs = worlds
    for b in refs["inp"]["gpt_batches"][:3]:
        for micro in (b["loss_mask"][:4], b["loss_mask"][4:]):
            assert micro[:2].sum() != micro[2:].sum()


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_stage_matches_jax_at_world_2(worlds, stage):
    """Losses and gradient norms per step, the gathered final parameters
    and the global eval loss of each stage against the JAX engine, on
    both ranks."""
    w2, _, refs = worlds
    ref = "stage3" if stage == 3 else "stage0"
    for rank, out in enumerate(w2):
        got = out[f"stage{stage}"]
        _close(got["rows"], refs[ref], f"stage {stage} rank {rank}")
        _params_close(got["params"], refs[f"{ref}_params"],
                      f"stage {stage} rank {rank}")
        np.testing.assert_allclose(got["eval"], refs["stage0_eval"], **TOL)


def test_shard_shapes_and_optimizer_bytes(worlds):
    """Each rank's master shards equal the JAX stage-3 engine's
    ``shard_shape`` leaf for leaf; at stages 1-3 the optimizer-state bytes
    of a leaf the spec splits are half of world 1's on each rank, and
    whole where it does not."""
    w2, _, refs = worlds
    for out in w2:
        lay3 = out["stage3"]["layouts"]
        for key, shard in refs["stage3_shards"].items():
            assert lay3[_port_path(key)]["store"] == shard, key
        assert any(v["store"] != v["shape"] for v in lay3.values())
        assert any(v["store"] == v["shape"] for v in lay3.values())
        for stage in (1, 2, 3):
            lay = out[f"stage{stage}"]["layouts"]
            for path, v in lay.items():
                whole = 2 * 4 * int(np.prod(v["shape"]))   # mu, nu fp32
                assert v["opt_bytes"] * (2 if v["split"] else 1) == whole, \
                    (stage, path)
            assert sum(v["split"] for v in lay.values()) >= 5
        lay0 = out["stage0"]["layouts"]
        assert not any(v["split"] for v in lay0.values())
    # the port's specs are the JAX engine's for stages 1 and 2 as well
    mesh2 = refs["mesh2"]
    npp = refs["npp"]
    for stage in (1, 2):
        jspecs = jsharding.opt_state_specs(
            npp, jsharding.param_specs(npp, mesh2, zero_stage=stage,
                                       min_shard_size=MIN_SHARD),
            npp, mesh2, zero_stage=stage, min_shard_size=MIN_SHARD)
        for (key, leaf), spec in zip(
                jax.tree_util.tree_flatten_with_path(npp)[0],
                jax.tree_util.tree_leaves(
                    jspecs, is_leaf=lambda x: isinstance(x, tuple))):
            key = jax.tree_util.keystr(key)
            shape = jax.sharding.NamedSharding(mesh2, spec).shard_shape(
                leaf.shape)
            for out in w2:
                assert out[f"stage{stage}"]["layouts"][_port_path(key)][
                    "update"] == tuple(shape), (stage, key)


def test_collectives_by_stage(worlds):
    """Stages 0-1 all-reduce every leaf, 2-3 reduce-scatter the split
    leaves, 1-3 all-gather the updated slices, 3 gathers the compute tree
    too; every collective is counted with its bytes."""
    w2, _, _ = worlds
    c = w2[0]["comm"]
    assert c["all_reduce"]["calls"] > 0 and c["reduce_scatter"]["calls"] > 0
    assert c["all_gather"]["calls"] > 0
    assert all(v["bytes"] > 0 for v in c.values() if v["calls"])


def test_bert_mlm_nsp_with_lamb_at_stage_1(worlds):
    """BERT MLM + NSP, LAMB at ZeRO 1: the masked-token count and the NSP
    rows cross ranks, the trust ratio's norms are the whole leaf's."""
    w2, _, refs = worlds
    for out in w2:
        _close(out["bert"]["rows"], refs["bert"], "bert")
        _params_close(out["bert"]["params"], refs["bert_params"], "bert")


def test_fp16_overflow_on_one_rank_skips_the_step_everywhere(worlds):
    """An overflow on rank 1's rows only: both ranks skip the first step
    and the loss-scale state is the JAX engine's, exactly; the next steps'
    losses, norms and the final parameters match to FP16_TOL (both
    engines compute in float16, each with its own rounding)."""
    w2, _, refs = worlds
    want = refs["fp16"]
    for out in w2:
        got = out["fp16"]["rows"]
        assert got[0][3] and want[0][3]
        assert not np.isfinite(got[0][0]) and not np.isfinite(want[0][0])
        assert [r[2] for r in got] == [r[2] for r in want]
        assert [r[3] for r in got] == [r[3] for r in want]
        _close(got[1:], want[1:], "fp16", FP16_TOL)
        assert out["fp16"]["skipped"] == refs["fp16_skipped"] == 1
        assert out["fp16"]["step_count"] == 2
        np.testing.assert_allclose(out["fp16"]["scale"]["loss_scale"],
                                   float(refs["fp16_scale"].loss_scale))
        _params_close(out["fp16"]["params"], refs["fp16_params"], "fp16",
                      FP16_TOL)


def test_generators_across_ranks(worlds):
    """Dropout masks differ between the ranks (their rows are equal, their
    losses are not), the layer-drop decisions agree, and memory-efficient
    bf16 stage 0 keeps the replicas bit-identical."""
    w2, _, _ = worlds
    a, b = (out["gen"] for out in w2)
    assert a["local_losses"] != b["local_losses"]
    assert a["layers_run"] == b["layers_run"] and len(a["layers_run"]) == 3
    assert a["params"].keys() == b["params"].keys()
    for k in a["params"]:
        assert a["params"][k].dtype == torch.bfloat16
        assert torch.equal(a["params"][k], b["params"][k]), k


def test_zero_init_shards_are_the_slices_and_train(worlds):
    w2, _, _ = worlds
    for out in w2:
        init = out["init"]
        assert init["equal"] and init["taken"] and init["split"] >= 5
        assert init["rows"] == init["whole"]


def test_stage3_with_two_replicas_at_world_4(worlds):
    """data 2 x fsdp 2 (replica_parallel_size 2) against the JAX engine on
    a 4-device mesh: losses, norms, parameters, the master shards, and the
    optimizer state split over fsdp x data."""
    _, w4, refs = worlds
    for rank, out in enumerate(w4):
        got = out["stage3_rep2"]
        assert got["mesh"]["data"] == 2 and got["mesh"]["fsdp"] == 2
        _close(got["rows"], refs["rep2"], f"rep2 rank {rank}")
        _params_close(got["params"], refs["rep2_params"], "rep2")
        for key, shard in refs["rep2_shards"].items():
            assert got["layouts"][_port_path(key)]["store"] == shard, key
        specs = jax.tree_util.tree_flatten_with_path(
            refs["rep2_opt_specs"],
            is_leaf=lambda x: isinstance(x, tuple))[0]
        for key, spec in specs:
            key = jax.tree_util.keystr(key)
            lay = got["layouts"][_port_path(key)]
            shape = jax.sharding.NamedSharding(refs["mesh4"], spec) \
                .shard_shape(lay["shape"])
            assert lay["update"] == tuple(shape), key
        assert any(("fsdp", "data") in s for _, s in specs)


def test_stage3_checkpoint_resumes_at_other_worlds(worlds, tmp_path):
    """A world-2 stage-3 checkpoint: its consolidation equals the live
    parameters, and it resumes at world 1 stage 0 (here, no process group)
    and at world 4 stage 1 with the uninterrupted run's next loss."""
    w2, w4, refs = worlds
    assert w2[0]["consolidated"] is True
    want = w2[0]["uninterrupted"]
    assert w2[1]["uninterrupted"] == want
    for out in w4:
        r = out["resumed"]
        assert r["path"].endswith("ranks2") and r["steps"] == 2
        np.testing.assert_allclose(r["loss"], want, **TOL)
    inp = refs["inp"]
    eng = deepspeed_tpu_torch.initialize(
        model=tgpt.make_loss_fn(tgpt.GPTConfig(**inp["gpt_fields"])),
        model_parameters=tgpt.init_params(tgpt.GPTConfig(**GPT), seed=1,
                                          device="cpu"),
        config=_stage(0), device="cpu")[0]
    path, _ = eng.load_checkpoint(inp["ckpt_dir"], tag="ranks2")
    assert path.endswith("ranks2") and eng.global_steps == 2
    loss = float(eng.train_batch(inp["gpt_batches"][2])["loss"])
    np.testing.assert_allclose(loss, want, **TOL)


def test_mismatched_checkpoint_raises_at_world_2(worlds):
    """Into a world-2 stage-3 engine, a checkpoint whose leaf is larger
    than the engine's (vocab 96 into 64: no top-left block is taken) or
    which holds a leaf the engine lacks (an untied lm_head) raises
    CheckpointError on every rank."""
    w2, _, _ = worlds
    for out in w2:
        got = out["mismatch"]
        assert got["vocab"] and "params/wte/embedding" in got["vocab"] \
            and "(96, 32)" in got["vocab"], got
        assert got["untied"] and "lm_head" in got["untied"], got

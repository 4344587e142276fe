"""Tensor parallelism: the port's Megatron column and row layers over a
``model`` axis, in real ``gloo`` worlds of 2 and 4 processes on the host
(tests/torch_rank_worker.py in its ``tp`` mode, one world per size
running every case of that size), against the JAX package on the
conftest's virtual devices at the same model degree, from the same seeded
numpy parameters and batches; and, without processes, the layout of the
pieces, the partition rules and the refusals.

The decoder is the llama dialect with GQA (8 heads, 2 kv heads, head dim
4), so that a rank of two holds 4 heads and 1 kv head. float32: tokens
identical, logits, losses and gradient norms to rtol/atol 1e-5, the
gradients of the replicated leaves bit for bit across the model group.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.inference import engine as jengine
from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.parallel.sharding import PartitionRule as JRule
from deepspeed_tpu_torch.inference import serving as tserving
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.ops.layers import dense
from deepspeed_tpu_torch.parallel import mesh as tmesh
from deepspeed_tpu_torch.parallel import tensor as ttensor
from deepspeed_tpu_torch.parallel.sharding import param_specs
from deepspeed_tpu_torch.runtime.checkpointing import load_16bit_model
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.tree import tree_paths
from test_torch_bert import _mlm_batch
from test_torch_bert import numpy_params as bert_numpy_params
from test_torch_model import numpy_params, one_torch_thread  # noqa: F401
from test_torch_sequence_parallel import _spawn
from test_torch_spec_decode import repeating_prompts
from test_torch_zero_ranks import _collect, _jax_key, _shards

TOL = dict(rtol=1e-5, atol=1e-5)
LLAMA = dict(vocab_size=96, n_layers=2, n_heads=8, n_kv_heads=2,
             d_model=32, d_ff=48, max_seq_len=64, rotary_dim=4,
             norm="rmsnorm", activation="swiglu", use_bias=False,
             use_wpe=False, tie_embeddings=False, norm_eps=1e-6,
             use_flash_attention=False, remat=False)
BERT = dict(vocab_size=97, n_layers=2, n_heads=2, d_model=32,
            max_seq_len=32, dropout=0.0)
SERVE_KW = dict(num_slots=2, block_size=4, num_blocks=24, prefill_chunk=8)
SPEC_K = 3
N_NEW = 10          # serving: long enough for the model's own repeats
MIN_SHARD = 16
TRAIN = {"train_batch_size": 4, "gradient_clipping": 0.5,
         "steps_per_print": 1000,
         "optimizer": {"type": "AdamW", "params": {"lr": 2e-3,
                                                   "weight_decay": 0.1}}}
# port case -> (world, ZeRO stage, JAX mesh spec)
TRAIN_CASES = {
    "model2": (2, 0, dict(data=4, model=2)),
    "zero1": (4, 1, dict(data=2, model=2)),
    "zero2": (4, 2, dict(data=2, model=2)),
    "zero3": (4, 3, dict(data=1, fsdp=2, model=2)),
}
MLP_HIDDEN = 32


def _train_config(stage):
    return dict(TRAIN, mesh={"tensor_parallel_size": 2},
                zero_optimization={"stage": stage,
                                   "stage3_min_shard_size": MIN_SHARD})


def _prompts():
    """A shared system prompt before prompts that repeat a seeded span
    (prompt lookup then drafts tokens the target accepts), as
    tests/test_torch_spec_decode.py's prefix scenario."""
    system = repeating_prompts((12,), 96, seed=8)[0]
    return [np.concatenate([system, p])
            for p in repeating_prompts((9, 13, 6), 96)]


def _jax_serve(eng, **kw):
    srv = jserving.ServingEngine(eng, **SERVE_KW, **kw)
    got = srv.run([jserving.ServeRequest(rid=i, prompt=p, max_new_tokens=N_NEW)
                   for i, p in enumerate(_prompts())])
    return dict(streams={k: np.asarray(v) for k, v in got.items()},
                stats=dict(srv.stats))


def _jax_train(loss_fn, params, config, mesh, batches, rules):
    eng = deepspeed_tpu.initialize(model=loss_fn, model_parameters=params,
                                   config=dict(config), mesh=mesh,
                                   partition_rules=rules)[0]
    eng.state = jax.device_put(eng.state, eng._state_shardings)
    rows = [(float(m["loss"]), float(m["grad_norm"]))
            for m in map(eng.train_batch, batches)]
    return rows, _shards(eng.state.params)


def _jax_mlp_loss(params, batch, rng=None):
    h = batch["x"]
    i = 0
    while f"layer_{i}" in params:
        p = params[f"layer_{i}"]
        h = jnp.tanh(h @ p["kernel"] + p["bias"])
        i += 1
    pred = (h @ params["head"]["kernel"] + params["head"]["bias"])[:, 0]
    return jnp.mean(jnp.square(pred - batch["y"]))


def _mlp_params():
    r = np.random.default_rng(0)
    p = {f"layer_{i}": {
        "kernel": (r.standard_normal((MLP_HIDDEN, MLP_HIDDEN))
                   / np.sqrt(MLP_HIDDEN)).astype(np.float32),
        "bias": np.zeros(MLP_HIDDEN, np.float32)} for i in range(2)}
    p["head"] = {"kernel": (r.standard_normal((MLP_HIDDEN, 1))
                            / np.sqrt(MLP_HIDDEN)).astype(np.float32),
                 "bias": np.zeros(1, np.float32)}
    return p


def _mlp_batches():
    out = []
    for i in range(3):
        r = np.random.default_rng(i)
        x = r.standard_normal((16, MLP_HIDDEN)).astype(np.float32)
        w = r.standard_normal(MLP_HIDDEN).astype(np.float32)
        out.append({"x": x, "y": np.tanh(x @ w)})
    return out


@pytest.fixture(scope="module")
def tp_worlds(tmp_path_factory, devices):
    """Both worlds' results and the JAX references, computed while the
    ranks run."""
    tmp = str(tmp_path_factory.mktemp("tp"))
    jcfg = jgpt.GPTConfig(**LLAMA, dtype=jnp.float32)
    tcfg = tgpt.GPTConfig(**LLAMA, dtype=torch.float32)
    npp = numpy_params(jcfg, seed=5)
    jbcfg = jbert.BertConfig(**BERT, dtype=jnp.float32)
    bnpp = bert_numpy_params(jbcfg, seed=4)
    rng = np.random.default_rng(11)
    toks = rng.integers(1, 96, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[1, :3] = 0
    batches = [{"tokens": rng.integers(1, 96, (4, 17))} for _ in range(3)]
    bert_batches = [_mlm_batch(rng, B=8, S=16) for _ in range(2)]
    mlp_config = dict(TRAIN, train_batch_size=16, gradient_clipping=0.0,
                      mesh={"tensor_parallel_size": 2},
                      optimizer={"type": "adamw", "params": {"lr": 1e-2}})
    bert_config = dict(TRAIN, train_batch_size=8,
                       mesh={"tensor_parallel_size": 2})
    train = {name: dict(config=_train_config(stage), batches=batches)
             for name, (_, stage, _) in TRAIN_CASES.items()}
    inp = dict(
        fields=dict(LLAMA, dtype=torch.float32),
        params=params_from_numpy(npp, tcfg, device="cpu"), toks=toks,
        mask=mask, prompts=_prompts(), serve_kw=SERVE_KW, spec_k=SPEC_K,
        n_new=N_NEW,
        train=train, ckpt_dir=os.path.join(tmp, "ckpt"),
        mlp=dict(params={k: {n: torch.from_numpy(a) for n, a in v.items()}
                         for k, v in _mlp_params().items()},
                 config=mlp_config, batches=_mlp_batches()),
        bert=dict(fields=dict(BERT, dtype=torch.float32),
                  params=params_from_numpy(bnpp, tbert.BertConfig(
                      **BERT, dtype=torch.float32), device="cpu"),
                  config=bert_config, batches=bert_batches))
    inputs = os.path.join(tmp, "inputs.pkl")
    with open(inputs, "wb") as f:
        pickle.dump(inp, f)
    # one world at a time, as the other rank tests spawn theirs: the
    # world of 2 while JAX runs its references, then the world of 4
    procs = _spawn(2, inputs, tmp, mode="tp")

    refs = {}
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    je = jengine.InferenceEngine(config=jcfg, params=jp, dtype=jnp.float32,
                                 mp_size=2)
    refs["gen"] = np.asarray(je.generate(toks, 6))
    refs["masked"] = np.asarray(je.generate(toks, 6, attention_mask=mask))
    refs["fused"] = np.asarray(je.generate_fused(toks, 6))
    refs["fused_masked"] = np.asarray(je.generate_fused(
        toks, 6, attention_mask=mask))
    refs["logits"] = np.asarray(je.forward(toks))
    for kvq in ("off", "int8"):
        refs[f"serve_{kvq}"] = _jax_serve(je, kv_quant=kvq, prefix_cache=True,
                                          spec_decode=True, spec_k=SPEC_K)
    je8 = jengine.InferenceEngine(config=jcfg, params=jp, dtype=jnp.int8,
                                  mp_size=2)
    refs["int8"] = np.asarray(je8.generate(toks, 6))
    refs["int8_serve"] = _jax_serve(je8, kv_quant="int8")

    loss = jgpt.make_loss_fn(jcfg)

    def train_refs(world):
        for name, (w, stage, spec) in TRAIN_CASES.items():
            if w != world or name == "zero2":   # JAX's stage 1 holds it
                continue
            mesh = jmesh.make_mesh(
                jmesh.MeshSpec(**spec),
                devices[:int(np.prod(list(spec.values())))])
            refs[name] = _jax_train(loss, npp, _train_config(stage), mesh,
                                    batches, jgpt.gpt_partition_rules())
    train_refs(2)
    mesh8 = jmesh.make_mesh(jmesh.MeshSpec(data=4, model=2), devices[:8])
    from jax.sharding import PartitionSpec as P
    refs["mlp"] = _jax_train(
        _jax_mlp_loss, _mlp_params(), mlp_config, mesh8, _mlp_batches(),
        [JRule(r"layer_0/kernel", P(None, "model")),
         JRule(r"layer_1/kernel", P("model", None))])
    refs["bert"] = _jax_train(jbert.make_loss_fn(jbcfg), bnpp, bert_config,
                              mesh8, bert_batches,
                              jbert.bert_partition_rules())
    worlds = {2: _collect(2, procs, tmp)}
    procs = _spawn(4, inputs, tmp, mode="tp")
    train_refs(4)
    refs["zero2"] = refs["zero1"]
    worlds[4] = _collect(4, procs, tmp)
    return worlds, refs


# ---------------------------------------------------------------------------
# the layout of the pieces, without processes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("heads", [(8, 8), (8, 4), (8, 2)])
def test_qkv_columns_are_each_ranks_heads(heads, n):
    """Piece r of the stored qkv is [q heads r*H/n.. | k heads r*Hkv/n..
    | v heads r*Hkv/n..] of JAX's [q | k | v] columns, each column once."""
    H, Hkv = heads
    D = 3
    if Hkv % n:
        with pytest.raises(NotImplementedError, match="1.3.2a"):
            ttensor.qkv_columns(H, Hkv, D, n)
        return
    cols = ttensor.qkv_columns(H, Hkv, D, n)
    assert sorted(cols.tolist()) == list(range((H + 2 * Hkv) * D))
    w = (H + 2 * Hkv) * D // n
    for r in range(n):
        piece = cols[r * w:(r + 1) * w].tolist()
        hq, hk = H // n, Hkv // n
        want = [h * D + d for h in range(r * hq, (r + 1) * hq)
                for d in range(D)]
        want += [H * D + h * D + d for h in range(r * hk, (r + 1) * hk)
                 for d in range(D)]
        want += [(H + Hkv) * D + h * D + d
                 for h in range(r * hk, (r + 1) * hk) for d in range(D)]
        assert piece == want


@pytest.mark.parametrize("model", ["gpt", "bert"])
def test_partition_rules_match_jax(model):
    got = tgpt.gpt_partition_rules() if model == "gpt" \
        else tbert.bert_partition_rules()
    want = jgpt.gpt_partition_rules() if model == "gpt" \
        else jbert.bert_partition_rules()
    assert [(r.pattern.pattern, r.spec) for r in got] == \
        [(r.pattern.pattern, tuple(r.spec)) for r in want]
    with pytest.raises(NotImplementedError, match="1.3.2c"):
        tbert.bert_partition_rules(vocab_parallel=True)


def _pieces(t, dim, n):
    return list(t.chunk(n, dim))


@pytest.mark.parametrize("int8", [False, True])
def test_column_and_row_dense_equal_the_whole(int8):
    """Each rank's column piece gives its columns of the whole product;
    the row pieces' products (an int8 entry's whole scale applied to each)
    sum to the whole, to which the bias is added once."""
    from deepspeed_tpu_torch.inference.engine import quantize_weights_int8
    g = torch.Generator().manual_seed(0)
    h = torch.randn(3, 5, 8, generator=g)
    entry = {"kernel": torch.randn(8, 12, generator=g),
             "bias": torch.randn(12, generator=g)}
    if int8:
        entry = quantize_weights_int8({"block": {"x": entry}})["block"]["x"]
    whole = dense(h, entry)
    for n in (2, 4):
        if int8:
            cols = [dict(q=q, scale=s, bias=b) for q, s, b in zip(
                _pieces(entry["q"], 1, n), _pieces(entry["scale"], 1, n),
                _pieces(entry["bias"], 0, n))]
            rows = [dict(q=q, scale=entry["scale"])
                    for q in _pieces(entry["q"], 0, n)]
        else:
            cols = [dict(kernel=k, bias=b) for k, b in zip(
                _pieces(entry["kernel"], 1, n), _pieces(entry["bias"], 0, n))]
            rows = [dict(kernel=k) for k in _pieces(entry["kernel"], 0, n)]
        got = torch.cat([dense(h, c) for c in cols], -1)
        np.testing.assert_allclose(got.numpy(), whole.numpy(), **TOL)
        parts = sum(dense(p, r) for p, r in zip(_pieces(h, -1, n), rows))
        np.testing.assert_allclose((parts + entry["bias"]).numpy(),
                                   whole.numpy(), **TOL)


@pytest.mark.parametrize("int8", [False, True])
def test_params_from_numpy_gives_each_rank_its_pieces(int8):
    """Under a mesh with a model axis of 2 the converted tree is the
    rank's pieces of JAX's (an int8 tree's codes and scales with them),
    JAX's shard shapes; the two ranks' pieces put back make the whole."""
    jcfg = jgpt.GPTConfig(**LLAMA, dtype=jnp.float32)
    tcfg = tgpt.GPTConfig(**LLAMA, dtype=torch.float32)
    npp = numpy_params(jcfg, seed=2)
    if int8:
        npp = jax.tree_util.tree_map(np.asarray, jengine.quantize_weights_int8(
            jax.tree_util.tree_map(jnp.asarray, npp)))
    whole = params_from_numpy(npp, tcfg, device="cpu")
    pieces = [params_from_numpy(npp, tcfg, device="cpu", mesh=tmesh.make_mesh(
        tmesh.MeshSpec(data=1, model=2), world_size=2, rank=r))
        for r in range(2)]
    cols = tgpt.tp_columns(tcfg, 2)
    rules = ttensor.int8_rules(tgpt.gpt_partition_rules())
    specs = dict(tree_paths(param_specs(whole, {"model": 2}, rules=rules)))
    for path, w in tree_paths(whole):
        spec = specs[path]
        got = [dict(tree_paths(p))[path] for p in pieces]
        if "model" not in spec:
            assert all(torch.equal(g, w) for g in got), path
            continue
        dim = spec.index("model")
        assert got[0].shape[dim] == w.shape[dim] // 2, path
        back = torch.cat(got, dim)
        if path in cols:
            back = back.index_select(-1, torch.argsort(cols[path]))
        assert torch.equal(back, w), path


def test_int8_rules_follow_jax():
    """int8 entries: q as the kernel, the scale's axis -2 whole."""
    rules = ttensor.int8_rules(tgpt.gpt_partition_rules())
    got = {r.pattern.pattern: r.spec for r in rules}
    assert got["block/qkv/q"] == (None, None, "model")
    assert got["block/qkv/scale"] == (None, None, "model")
    assert got["block/attn_out/scale"] == (None, None, None)
    assert got["block/mlp_out/q"] == (None, "model", None)


def test_refusals_name_their_items():
    cfg = tgpt.GPTConfig(**dict(LLAMA, n_heads=8, n_kv_heads=2),
                         dtype=torch.float32)
    params = tgpt.init_params(cfg, device="cpu")
    # a TP request without a process group of enough ranks
    with pytest.raises(ValueError, match="init_distributed"):
        InferenceEngine((cfg, params), mp_size=2, device="cpu")
    with pytest.raises(NotImplementedError, match="1.3.2a"):
        tgpt.tp_columns(cfg, 4)
    # tensor x sequence parallelism, before any process group is needed
    d = dict(TRAIN, mesh={"tensor_parallel_size": 2,
                          "sequence_parallel_size": 2})
    mesh = tmesh.make_mesh(tmesh.MeshSpec(data=1, sequence=2, model=2),
                           world_size=4)
    with pytest.raises(NotImplementedError, match="1.3.2b"):
        DeepSpeedEngine(tgpt.make_loss_fn(cfg), params,
                        DeepSpeedConfig(d, world_size=1), mesh=mesh,
                        device="cpu")
    # a model axis without a process group
    mesh = tmesh.make_mesh(tmesh.MeshSpec(data=1, model=2), world_size=2)
    with pytest.raises(ValueError, match="init_distributed"):
        DeepSpeedEngine(tgpt.make_loss_fn(cfg), params,
                        DeepSpeedConfig(dict(TRAIN), world_size=1),
                        mesh=mesh, device="cpu")
    with pytest.raises(NotImplementedError, match="1.3.2d"):
        tserving._tp_features(host_tier=False, decode_horizon=True)
    with pytest.raises(NotImplementedError, match="1.3.2d"):
        dense(torch.ones(2, 4), {"kernel": torch.ones(4, 4),
                                 "lora_a": torch.ones(4, 1),
                                 "lora_b": torch.ones(1, 4),
                                 "lora_scale": torch.ones(())},
              reduce=object())


# ---------------------------------------------------------------------------
# world 2, model 2: the conjugate functions, inference and serving
# ---------------------------------------------------------------------------

def test_conjugate_functions(tp_worlds):
    """copy_to_model: identity forward, the gradient summed over the
    group; reduce_from_model: the pieces summed, identity backward."""
    worlds, _ = tp_worlds
    for r in worlds[2]:
        c = r["conjugate"]
        np.testing.assert_allclose(c["copy_grad"], c["want_copy_grad"],
                                   **TOL)
        np.testing.assert_allclose(c["reduce_fwd"], c["want_reduce_fwd"],
                                   **TOL)
        np.testing.assert_array_equal(c["reduce_grad"],
                                      np.full((4, 2), 2.0, np.float32))
    np.testing.assert_array_equal(worlds[2][0]["conjugate"]["copy_fwd"],
                                  worlds[2][1]["conjugate"]["copy_fwd"])


@pytest.mark.parametrize("what", ["gen", "masked", "fused", "fused_masked",
                                  "int8"])
def test_generate_matches_jax_mp2(tp_worlds, what):
    """generate, left-padded generate, generate_fused and int8 weights at
    mp_size 2: JAX's mp_size=2 tokens, the one-rank engine's, on both
    ranks."""
    worlds, refs = tp_worlds
    for rank, r in enumerate(worlds[2]):
        np.testing.assert_array_equal(r["infer"][2][what], refs[what],
                                      err_msg=f"rank {rank}")
        np.testing.assert_array_equal(r["infer"][2][what],
                                      r["infer"][1][what])


def test_unshard_puts_the_pieces_back(tp_worlds):
    """The inference engine's pieces, all-gathered over the model group
    and their qkv columns put back, are the whole tree it was given."""
    worlds, _ = tp_worlds
    assert all(r["infer"][2]["unshard_equal"] for r in worlds[2])


def test_forward_logits_match_jax_mp2(tp_worlds):
    worlds, refs = tp_worlds
    for r in worlds[2]:
        np.testing.assert_allclose(r["infer"][2]["logits"], refs["logits"],
                                   **TOL)
        np.testing.assert_allclose(r["infer"][2]["logits"],
                                   r["infer"][1]["logits"], **TOL)


@pytest.mark.parametrize("what", ["serve_off", "serve_int8", "int8_serve"])
def test_serving_drain_matches_jax_mp2(tp_worlds, what):
    """The ServingEngine over an mp_size=2 engine (float and int8 pools,
    with the prefix cache and speculative decode; int8 weights over int8
    pools): JAX's streams and counters."""
    worlds, refs = tp_worlds
    want = refs[what]
    for rank, r in enumerate(worlds[2]):
        got = r["infer"][2][what]
        assert sorted(got["streams"]) == sorted(want["streams"])
        for rid, s in want["streams"].items():
            np.testing.assert_array_equal(got["streams"][rid], s,
                                          err_msg=f"rank {rank} {rid}")
        for key in ("completed", "prefill_chunks", "decode_steps",
                    "prefix_hits", "spec_accepted", "spec_proposed"):
            if key in want["stats"]:
                assert got["stats"][key] == want["stats"][key], key
        assert got["blocks"] == r["infer"][1][what]["blocks"]
    if what != "int8_serve":
        assert want["stats"]["prefix_hits"] > 0
        assert want["stats"]["spec_accepted"] > 0


def test_pools_hold_each_ranks_kv_heads(tp_worlds):
    """Each rank's pools and static cache hold kv_heads / 2 heads; the
    block counts are the one-rank engine's."""
    worlds, _ = tp_worlds
    for r in worlds[2]:
        one, two = r["infer"][1], r["infer"][2]
        assert one["kv_heads"] == 2 and two["kv_heads"] == 1
        for what in ("serve_off", "serve_int8"):
            assert one[what]["pool"][3] == 2 and two[what]["pool"][3] == 1
            assert one[what]["pool"][:3] == two[what]["pool"][:3]


def test_sampled_streams_agree_across_ranks(tp_worlds):
    worlds, _ = tp_worlds
    a, b = (r["infer"][2]["sampled"]["streams"] for r in worlds[2])
    assert sorted(a) == sorted(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])


def test_tp_all_reduces_are_counted(tp_worlds):
    """Two all-reduces per layer and step, under their own name."""
    worlds, _ = tp_worlds
    for r in worlds[2]:
        c = r["infer"][2]["comm"]["tp_all_reduce"]
        assert c["calls"] > 0 and c["bytes"] > 0
        assert c["calls"] % (2 * LLAMA["n_layers"]) == 0
        assert r["infer"][1]["comm"]["tp_all_reduce"]["calls"] == 0


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_training_matches_jax(tp_worlds, case):
    """The llama dialect (GQA) with gradient clipping over a model axis
    of 2 (world 2; world 4 with data 2 at ZeRO 1 and 2, fsdp 2 at ZeRO
    3): losses and gradient norms equal JAX's engine on the same model
    degree, on every rank; each leaf's shard shape is JAX's."""
    worlds, refs = tp_worlds
    world = TRAIN_CASES[case][0]
    want_rows, want_shards = refs[case]
    for rank, r in enumerate(worlds[world]):
        got = r[case]
        assert got["mesh"]["model"] == 2
        np.testing.assert_allclose(np.array([x[:2] for x in got["rows"]]),
                                   np.array(want_rows),
                                   err_msg=f"{case} rank {rank}", **TOL)
        for path, lay in got["layouts"].items():
            assert lay["store"] == want_shards[_jax_key(path)], path
    qkv = worlds[world][0][case]["layouts"]["block/qkv/kernel"]
    assert qkv["store"][-1] == tgpt.GPTConfig(**LLAMA).qkv_dim // 2


def test_replicated_gradients_are_bit_identical(tp_worlds):
    """The norms', the embedding's and the head's gradients come out the
    same bits on both model ranks, with no all-reduce of their own."""
    worlds, _ = tp_worlds
    a, b = (r["repl_grads"] for r in worlds[2])
    assert sorted(a) == sorted(b)
    assert {"wte/embedding", "lm_head/kernel", "ln_f/scale",
            "block/ln1/scale"} <= set(a)
    for path in a:
        np.testing.assert_array_equal(a[path], b[path], err_msg=path)


@pytest.mark.parametrize("case", ["mlp", "bert"])
def test_other_losses_match_jax(tp_worlds, case):
    """A client loss without ``tp_columns`` (tests/test_engine.py
    test_tp_engine's two-layer model and its own rules: whole leaves
    gathered before the call) and BERT MLM + NSP under
    bert_partition_rules: JAX's losses."""
    worlds, refs = tp_worlds
    want_rows, want_shards = refs[case]
    for r in worlds[2]:
        np.testing.assert_allclose(
            np.array([x[:2] for x in r[case]["rows"]]), np.array(want_rows),
            **TOL)
        for path, lay in r[case]["layouts"].items():
            assert lay["store"] == want_shards[_jax_key(path)], path


def test_checkpoint_resumes_bit_for_bit(tp_worlds):
    """A TP engine saved after two steps and loaded into a fresh one
    takes the third step to the same bits; a one-rank engine loads the
    same parameters; the consolidated tree is JAX's order."""
    worlds, _ = tp_worlds
    for r in worlds[2]:
        assert r["resumed"] == r["uninterrupted"]
        for k, v in r["live"].items():
            np.testing.assert_array_equal(r["one_loaded"][k], v, err_msg=k)
    r0 = worlds[2][0]
    assert sorted(r0["consolidated"]) == sorted(r0["live"])
    for k, v in r0["live"].items():
        np.testing.assert_array_equal(r0["consolidated"][k], v, err_msg=k)
    for k, v in worlds[2][1]["resumed_params"].items():
        np.testing.assert_array_equal(r0["resumed_params"][k], v)


def test_16bit_export_equals_the_one_rank_file(tp_worlds):
    worlds, _ = tp_worlds
    d = worlds[2][0]["w16"]
    tp = load_16bit_model(os.path.join(d, "tp.npz"))
    with np.load(os.path.join(d, "tp.npz")) as a, \
            np.load(os.path.join(d, "one.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert tp["block"]["qkv"]["kernel"].shape[-1] == \
        tgpt.GPTConfig(**LLAMA).qkv_dim


def test_zero_init_draws_the_model_pieces(tp_worlds):
    """zero.Init over fsdp 2 x model 2 leaves each rank JAX's contiguous
    pieces of every leaf; the engine takes them as they are but the
    fused qkv, which it cuts again head-aligned, and trains as from the
    whole tree."""
    worlds, _ = tp_worlds
    for r in worlds[4]:
        init = r["init"]
        assert init["cut"] and init["split"] > 0
        assert init["taken"] and init["n_taken"] > 0 and init["same"]
        assert init["rows"] == init["whole"]

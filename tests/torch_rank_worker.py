"""One rank of a ``gloo`` world, for tests/test_torch_zero_ranks.py and
tests/test_torch_sequence_parallel.py (on the host) and
tests/test_torch_kernels_gpu.py (on the card).

    python tests/torch_rank_worker.py WORLD RANK STORE INPUTS OUT [MODE]

Joins the process group through a ``FileStore`` (``file://STORE``), runs
every case of its world size on the port's engine (``device="cpu"``; with
MODE ``cuda``, the card's cases on the card, every rank on ``cuda:0``;
with ``sp``, the sequence-parallel cases: ring and Ulysses attention and
the engine over a ``sequence`` axis, on the host, or on ``cuda:0`` with
``sp-cuda``; with ``tp``, the tensor-parallel cases of
tests/test_torch_tensor_parallel.py: the conjugate functions, the
inference and serving engines at ``mp_size`` 2 and the training engine
over a ``model`` axis, on the host, or the card's ``generate`` on
``cuda:0`` with ``tp-cuda``; with ``pipe``, the pipeline cases of
tests/test_torch_pipeline.py: the engine over a ``pipe`` axis under each
schedule, alone and with data, fsdp and model axes, and a checkpoint)
from the seeded inputs the test wrote to INPUTS, and saves its results
to OUT.
It imports torch and the port only, never jax. A failing case exits
non-zero (the test then kills the other ranks).
"""

import os
import pickle
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch import zero  # noqa: E402
from deepspeed_tpu_torch.models import bert as tbert  # noqa: E402
from deepspeed_tpu_torch.models import gpt as tgpt  # noqa: E402
from deepspeed_tpu_torch.parallel import comm  # noqa: E402
from deepspeed_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from deepspeed_tpu_torch.runtime import checkpointing as ckpt  # noqa: E402
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig  # noqa: E402
from deepspeed_tpu_torch.tree import tree_leaves, tree_paths  # noqa: E402


def flat(tree, prefix=""):
    """{path: numpy array} of a nested dict of tensors."""
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        else:
            # a copy: a CPU tensor's numpy view would follow later steps
            out[prefix + k] = tree[k].detach().float().cpu().numpy().copy()
    return out


def run(eng, batches):
    """Per step (loss, grad_norm, loss_scale, overflow)."""
    rows = []
    for b in batches:
        m = eng.train_batch(b)
        rows.append((float(m["loss"]), float(m["grad_norm"]),
                     float(m["loss_scale"]), bool(m["overflow"])))
    return rows


def layouts(eng):
    """Per leaf: its store (master) and update (optimizer-state) shard
    shapes, whether the update is split, and the optimizer-state bytes."""
    mu = dict(zip((lay.path for lay in eng._zero.flat),
                  tree_leaves(eng.opt_state["mu"])))
    nu = dict(zip((lay.path for lay in eng._zero.flat),
                  tree_leaves(eng.opt_state["nu"])))
    return {lay.path: dict(store=tuple(lay.store_shape),
                           update=tuple(lay.update_shape),
                           split=lay.update_split, shape=lay.shape,
                           opt_bytes=sum(t.numel() * t.element_size()
                                         for t in (mu[lay.path],
                                                   nu[lay.path])))
            for lay in eng._zero.flat}


def gpt_engine(inp, config, params=None, mesh=None, **fields):
    cfg = tgpt.GPTConfig(**{**inp["gpt_fields"], **fields})
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt.make_loss_fn(cfg),
        model_parameters=inp["gpt_params"] if params is None else params,
        config=config, mesh=mesh, device="cpu")
    return eng


def gpt_stage(inp, stage, **extra):
    return dict(inp["gpt_config"], zero_optimization={
        "stage": stage, "stage3_min_shard_size": inp["min_shard"]}, **extra)


def cases_world2(inp, rank):
    out = {}
    batches = inp["gpt_batches"]
    comm.reset_stats()
    for stage in (0, 1, 2, 3):
        eng = gpt_engine(inp, gpt_stage(inp, stage))
        out[f"stage{stage}"] = dict(
            rows=run(eng, batches[:3]), params=flat(eng.gather_params()),
            layouts=layouts(eng), eval=float(eng.eval_batch(batches[3])[0]))
    out["comm"] = comm.stats()

    # BERT MLM + NSP with LAMB at stage 1
    bcfg = tbert.BertConfig(**inp["bert_fields"])
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tbert.make_loss_fn(bcfg), model_parameters=inp["bert_params"],
        config=inp["bert_config"], device="cpu")
    out["bert"] = dict(rows=run(eng, inp["bert_batches"]),
                       params=flat(eng.gather_params()))

    # fp16 dynamic loss scaling, an overflow on rank 1's rows only
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=fp16_loss, model_parameters=inp["fp16_params"],
        config=inp["fp16_config"], device="cpu")
    out["fp16"] = dict(rows=run(eng, inp["fp16_batches"]),
                       params=flat(eng.gather_params()),
                       skipped=eng.skipped_steps, step_count=eng.step_count,
                       scale=vars(eng.scale_state))

    # generators: dropout masks differ across ranks, layer-drop decisions
    # and the bf16 stochastic rounding agree (stage 0 stays replicated)
    inner = tgpt.make_loss_fn(tgpt.GPTConfig(**{
        **inp["gpt_fields"], "dropout": 0.1, "dtype": torch.bfloat16}))
    seen = []

    def recorded(params, batch, rng):
        loss = inner(params, batch, rng)
        seen.append(float(loss))
        return loss
    recorded.normalizers = inner.normalizers
    inner.layers_run = []
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=recorded, model_parameters=inp["gpt_params"],
        config=inp["gen_config"], device="cpu")
    run(eng, inp["gen_batches"])
    out["gen"] = dict(local_losses=seen, layers_run=list(inner.layers_run),
                      params={k: v.detach().clone() for k, v in
                              tree_paths(eng.params)})

    # zero.Init: the shards are the slices of init_fn's tree, and the
    # engine trains from them as from the whole tree
    config = gpt_stage(inp, 3)
    cfg = tgpt.GPTConfig(**inp["gpt_fields"])

    def init_fn(seed):
        return tgpt.init_params(cfg, seed=seed, device="cpu")
    mesh = mesh_lib.mesh_from_config(DeepSpeedConfig(config, world_size=2))
    shards = zero.Init(init_fn, 5, mesh, zero_stage=3,
                       min_shard_size=inp["min_shard"], device="cpu")
    # the same shards from the leaves yielded one at a time
    lazy = zero.Init(lambda seed: tgpt.init_leaves(cfg, seed=seed,
                                                   device="cpu"),
                     5, mesh, zero_stage=3, min_shard_size=inp["min_shard"],
                     device="cpu")
    whole = init_fn(5)
    equal = all(torch.equal(s, w[lay.store_box]) and torch.equal(s, z)
                for s, z, w, lay in zip(
                    tree_leaves(shards), tree_leaves(lazy),
                    tree_leaves(whole), shards.partition.flat))
    from_shards = gpt_engine(inp, config, params=shards, mesh=mesh)
    taken = all(a.data_ptr() != b.data_ptr() and torch.equal(a, b)
                for a, b in zip(tree_leaves(from_shards.params),
                                tree_leaves(shards)))
    from_whole = gpt_engine(inp, config, params=whole)
    out["init"] = dict(
        equal=equal, taken=taken,
        split=sum(s.shape != w.shape for s, w in zip(tree_leaves(shards),
                                                     tree_leaves(whole))),
        rows=run(from_shards, batches[:2]), whole=run(from_whole,
                                                      batches[:2]))

    # a stage-3 checkpoint after two steps, then the uninterrupted third
    eng = gpt_engine(inp, gpt_stage(inp, 3))
    run(eng, batches[:2])
    eng.save_checkpoint(inp["ckpt_dir"], tag="ranks2")
    live = flat(eng.gather_params())
    if rank == 0:
        saved = flat(ckpt.load_fp32_state_dict_from_zero_checkpoint(
            inp["ckpt_dir"]))
        out["consolidated"] = all(
            np.array_equal(saved[k], live[k]) for k in live) \
            and sorted(saved) == sorted(live)
    out["uninterrupted"] = run(eng, batches[2:3])[0][0]

    # a checkpoint whose leaves are larger than the engine's, or which
    # holds a leaf the engine lacks, does not load
    out["mismatch"] = {}
    for name, fields in (("vocab", dict(vocab_size=64)),
                         ("untied", dict(tie_embeddings=False))):
        cfg = tgpt.GPTConfig(**{**inp["gpt_fields"], **fields})
        other = gpt_engine(inp, gpt_stage(inp, 3),
                           params=tgpt.init_params(cfg, device="cpu"),
                           **fields)
        if name == "untied":     # the checkpoint holds the extra leaf
            other.save_checkpoint(inp["ckpt_dir"], tag="untied",
                                  save_latest=False)
            other = gpt_engine(inp, gpt_stage(inp, 3))
        try:
            other.load_checkpoint(inp["ckpt_dir"],
                                  tag="untied" if name == "untied"
                                  else "ranks2")
            out["mismatch"][name] = None
        except ckpt.CheckpointError as e:
            out["mismatch"][name] = str(e)
    return out


def fp16_loss(params, batch, rng):
    h = torch.tanh(batch["x"] @ params["w1"])
    return ((h @ params["w2"]).squeeze(-1) - batch["y"]).pow(2).mean()


def cases_world4(inp, rank):
    out = {}
    eng = gpt_engine(inp, gpt_stage(inp, 3, mesh={"replica_parallel_size":
                                                  2}))
    out["stage3_rep2"] = dict(rows=run(eng, inp["gpt_batches"][:3]),
                              params=flat(eng.gather_params()),
                              layouts=layouts(eng),
                              mesh=dict(eng.mesh.shape))
    # the world-2 stage-3 checkpoint resumes at stage 1
    eng = gpt_engine(inp, gpt_stage(inp, 1))
    path, _ = eng.load_checkpoint(inp["ckpt_dir"], tag="ranks2")
    out["resumed"] = dict(path=path, steps=eng.global_steps,
                          loss=run(eng, inp["gpt_batches"][2:3])[0][0])
    return out


def cases_card(inp, rank):
    """Stages 2 and 3 on the card: losses, and the flash kernels'
    launches on this rank."""
    from deepspeed_tpu_torch.ops.attention import flash
    fa = flash.flash_attention
    out = {}
    cfg = tgpt.GPTConfig(**inp["fields"])
    for stage in (2, 3):
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=tgpt.make_loss_fn(cfg), model_parameters=inp["params"],
            config=dict(inp["config"], zero_optimization={"stage": stage}))
        assert eng.device.type == "cuda" and eng.dp_world_size == 2
        fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        out[stage] = dict(rows=run(eng, inp["batches"]), launches=(
            fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches))
        del eng
    # zero.Init on the card: a whole tree built there is refused before
    # it is made; leaves drawn one at a time leave this rank's slices of
    # the same values, the card's peak above them one whole leaf and its
    # slice at most
    mesh = mesh_lib.mesh_from_config(DeepSpeedConfig(dict(
        inp["config"], zero_optimization={"stage": 3}), world_size=2))
    try:
        zero.Init(lambda seed: tgpt.init_params(cfg, seed=seed), 0, mesh,
                  min_shard_size=64)
        refused = False
    except ValueError:
        refused = True
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    shards = zero.Init(lambda seed: tgpt.init_leaves(cfg, seed=seed), 0,
                       mesh, min_shard_size=64)
    peak = torch.cuda.max_memory_allocated() - base
    whole = tgpt.init_params(cfg, seed=0)
    out["init"] = dict(
        refused=refused, peak=peak,
        shards=sum(t.numel() * t.element_size() for t in tree_leaves(shards)),
        largest=max(t.numel() * t.element_size() for t in tree_leaves(whole)),
        split=sum(s.shape != w.shape for s, w in zip(tree_leaves(shards),
                                                     tree_leaves(whole))),
        equal=all(s.is_cuda and torch.equal(s, w[lay.store_box])
                  for s, w, lay in zip(tree_leaves(shards),
                                       tree_leaves(whole),
                                       shards.partition.flat)))
    return out


def _shard_idx(S, n, r, layout):
    """The global token indices rank r holds: its contiguous S/n, of the
    zigzag-permuted order under the zigzag layout."""
    from deepspeed_tpu_torch.ops.attention.ring import zigzag_perm
    perm = zigzag_perm(S, n) if layout == "zigzag" else np.arange(S)
    loc = S // n
    return perm[r * loc:(r + 1) * loc]


def attention_case(case, mesh, rank, n, device):
    """One ring or Ulysses call on this rank's shard of the case's global
    arrays, and its gradients for the case's output gradient: (the
    global token indices held, out, dq, dk, dv) as numpy."""
    from deepspeed_tpu_torch.ops.attention.ring import ring_attention
    from deepspeed_tpu_torch.ops.attention.ulysses import ulysses_attention
    idx = _shard_idx(case["q"].shape[1], n, rank, case["layout"])

    def cut(name, dtype=torch.float32, grad=False):
        a = case.get(name)
        if a is None:
            return None
        t = torch.as_tensor(a[:, idx]).to(device=device, dtype=dtype)
        return t.requires_grad_() if grad else t
    q, k, v = (cut(x, grad=True) for x in "qkv")
    kw = dict(causal=True, segment_ids=cut("segs", torch.int32),
              kv_mask=cut("kv_mask"), window=case.get("window"))
    if case["impl"] == "ring":
        out = ring_attention(q, k, v, mesh, layout=case["layout"],
                             chunk=case.get("chunk", 1024), **kw)
    else:
        out = ulysses_attention(q, k, v, mesh, **kw)
    out.backward(cut("do"))
    return tuple([idx] + [t.detach().float().cpu().numpy()
                          for t in (out, q.grad, k.grad, v.grad)])


def cases_sp(inp, rank, world, device):
    """Ring and Ulysses attention on a mesh of ``world`` sequence ranks,
    then the engine with a ``sequence`` axis: every case of this world
    size, with the launches of the ring-mode kernels on the card."""
    from deepspeed_tpu_torch.ops.attention import flash
    out = {"attn": {}, "engine": {}}
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(data=1, sequence=world))
    comm.reset_stats()
    for name, case in inp["attn"].items():
        out["attn"][name] = attention_case(case, mesh, rank, world, device)
    out["attn_comm"] = comm.stats()
    fb, bb = flash.flash_block_fwd, flash.flash_block_bwd
    for name, e in inp["engine"].items():
        cfg = tgpt.GPTConfig(**e["fields"])
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=tgpt.make_loss_fn(cfg), model_parameters=e["params"],
            config=e["config"], device=device)
        fb.launches = fb.offset_launches = bb.dq_launches = 0
        out["engine"][name] = dict(rows=run(eng, e["batches"]),
                                   mesh=dict(eng.mesh.shape),
                                   launches=(fb.launches,
                                             fb.offset_launches,
                                             bb.dq_launches))
        del eng
    return out


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

def _one_rank_mesh():
    """A mesh of one rank without the process group: a one-rank engine's
    collectives are no-ops beside the world's."""
    return mesh_lib.make_mesh(mesh_lib.MeshSpec(data=1), world_size=1)


def _serve(eng, prompts, n_new, **kw):
    from deepspeed_tpu_torch.inference import serving as tserving
    srv = tserving.ServingEngine(eng, **kw)
    got = srv.run([tserving.ServeRequest(rid=i, prompt=p, max_new_tokens=n_new)
                   for i, p in enumerate(prompts)])
    return dict(streams={k: np.asarray(v) for k, v in got.items()},
                stats=dict(srv.stats), pool=tuple(srv.cache.k.shape),
                blocks=srv.cache.num_blocks)


def tp_inference(inp, device):
    """The inference engine at mp_size 1 and 2: generate (plain and
    left-padded), generate_fused, forward, int8 weights, and the serving
    drains in both pool modes with the prefix cache and speculation, and
    a sampled drain."""
    from deepspeed_tpu_torch import init_inference
    cfg = tgpt.GPTConfig(**inp["fields"])
    toks, mask = inp["toks"], inp["mask"]
    out = {}
    for mp in (1, 2):
        eng = init_inference(model=(cfg, inp["params"]), mp_size=mp,
                             dtype=torch.float32, device=device)
        r = dict(gen=eng.generate(toks, 6),
                 masked=eng.generate(toks, 6, attention_mask=mask),
                 logits=eng.forward(toks).cpu().numpy(),
                 kv_heads=eng.kv_heads)
        if mp > 1:
            # the pieces put back: the whole tree in JAX's column order
            from deepspeed_tpu_torch.parallel import tensor as tp_lib
            whole = tp_lib.unshard(eng.params, eng.mesh, inp["params"],
                                   tgpt.gpt_partition_rules(),
                                   tgpt.tp_columns(cfg, mp))
            r["unshard_equal"] = all(
                torch.equal(a, b.to(a.device)) for a, b in
                zip(tree_leaves(whole), tree_leaves(inp["params"])))
        if device == "cpu":
            r["fused"] = eng.generate_fused(toks, 6)
            r["fused_masked"] = eng.generate_fused(toks, 6,
                                                   attention_mask=mask)
            comm.reset_stats()
            for kvq in ("off", "int8"):
                r[f"serve_{kvq}"] = _serve(
                    eng, inp["prompts"], inp["n_new"], kv_quant=kvq,
                    prefix_cache=True, spec_decode=True,
                    spec_k=inp["spec_k"], **inp["serve_kw"])
            r["comm"] = comm.stats()
            r["sampled"] = _serve(eng, inp["prompts"], inp["n_new"],
                                  temperature=0.8, top_k=8, seed=5,
                                  **inp["serve_kw"])
            e8 = init_inference(model=(cfg, inp["params"]), mp_size=mp,
                                dtype=torch.int8, device=device)
            r["int8"] = e8.generate(toks, 6)
            r["int8_serve"] = _serve(e8, inp["prompts"], inp["n_new"],
                                     kv_quant="int8", **inp["serve_kw"])
        out[mp] = r
    return out


def conjugate_case(rank):
    """copy_to_model and reduce_from_model, forward and backward, on
    seeded per-rank inputs."""
    from deepspeed_tpu_torch.parallel import tensor as tp_lib
    group = mesh_lib.make_mesh(mesh_lib.MeshSpec(data=1, model=2)).group(
        "model")
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, 5, generator=g).requires_grad_()
    w = [torch.randn(3, 5, generator=g) for _ in range(2)]
    y = tp_lib.copy_to_model(x, group)
    (y * w[rank]).sum().backward()
    part = (torch.randn(4, 2, generator=g), torch.randn(4, 2, generator=g))
    p = part[rank].clone().requires_grad_()
    z = tp_lib.reduce_from_model(p, group)
    (z * 2.0).sum().backward()
    return dict(copy_fwd=y.detach().numpy(), copy_grad=x.grad.numpy(),
                want_copy_grad=(w[0] + w[1]).numpy(),
                reduce_fwd=z.detach().numpy(),
                want_reduce_fwd=(part[0] + part[1]).numpy(),
                reduce_grad=p.grad.numpy())


def tp_engine(inp, case, params=None, mesh=None, device="cpu"):
    c = inp["train"][case]
    cfg = tgpt.GPTConfig(**inp["fields"])
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt.make_loss_fn(cfg),
        model_parameters=inp["params"] if params is None else params,
        config=c["config"], mesh=mesh,
        partition_rules=None if mesh is not None
        else tgpt.gpt_partition_rules(), device=device)
    return eng


def _replicated_grads(eng, batch):
    """The compute-box gradients of one accumulation (no update) of the
    leaves the model axis does not split."""
    grads, _ = eng._accum_grads(eng._to_device(batch))
    return {lay.path: g.detach().numpy() for lay, g in
            zip(eng._zero.flat, tree_leaves(grads))
            if "model" not in [e for e in lay.store_spec]}


def mlp_loss(params, batch, rng):
    """tests/simple_model.py's MSE regression model, in torch."""
    h = batch["x"]
    i = 0
    while f"layer_{i}" in params:
        p = params[f"layer_{i}"]
        h = torch.tanh(h @ p["kernel"] + p["bias"])
        i += 1
    pred = (h @ params["head"]["kernel"] + params["head"]["bias"]).squeeze(-1)
    return ((pred - batch["y"]) ** 2).mean()


def tp_training2(inp, rank):
    """World 2, model 2: the llama dialect, a client loss, BERT, and a
    checkpoint."""
    from deepspeed_tpu_torch.parallel.sharding import PartitionRule
    tr = inp["train"]
    out = {}
    eng = tp_engine(inp, "model2")
    out["repl_grads"] = _replicated_grads(eng, tr["model2"]["batches"][0])
    out["model2"] = dict(rows=run(eng, tr["model2"]["batches"]),
                         layouts=layouts(eng), mesh=dict(eng.mesh.shape),
                         params=flat(eng.gather_params()))

    rules = [PartitionRule(r"layer_0/kernel", (None, "model")),
             PartitionRule(r"layer_1/kernel", ("model", None))]
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=mlp_loss, model_parameters=inp["mlp"]["params"],
        config=inp["mlp"]["config"], partition_rules=rules, device="cpu")
    out["mlp"] = dict(rows=run(eng, inp["mlp"]["batches"]),
                      layouts=layouts(eng))

    bcfg = tbert.BertConfig(**inp["bert"]["fields"])
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tbert.make_loss_fn(bcfg), model_parameters=inp["bert"]["params"],
        config=inp["bert"]["config"],
        partition_rules=tbert.bert_partition_rules(), device="cpu")
    out["bert"] = dict(rows=run(eng, inp["bert"]["batches"]),
                       layouts=layouts(eng))

    # a TP checkpoint: the 16-bit export at the start (and the one-rank
    # engine's), two steps, save, the uninterrupted third; a fresh TP
    # engine and a one-rank engine resume it
    batches = tr["model2"]["batches"]
    d16 = os.path.join(inp["ckpt_dir"], f"w16_rank{rank}")
    eng = tp_engine(inp, "model2")
    eng.save_16bit_model(d16, "tp.npz")
    one = tp_engine(inp, "model2", mesh=_one_rank_mesh())
    if rank == 0:
        one.save_16bit_model(d16, "one.npz")
    run(eng, batches[:2])
    eng.save_checkpoint(inp["ckpt_dir"], tag="tp2")
    live = flat(eng.gather_params())
    out["uninterrupted"] = run(eng, batches[2:3])
    fresh = tp_engine(inp, "model2")
    fresh.load_checkpoint(inp["ckpt_dir"], tag="tp2")
    out["resumed"] = run(fresh, batches[2:3])
    out["resumed_params"] = flat(fresh.gather_params())
    one.load_checkpoint(inp["ckpt_dir"], tag="tp2")
    out["one_loaded"] = flat(one.gather_params())
    out["live"] = live
    out["w16"] = d16
    if rank == 0:
        out["consolidated"] = flat(
            ckpt.load_fp32_state_dict_from_zero_checkpoint(inp["ckpt_dir"],
                                                           tag="tp2"))
    return out


def tp_training4(inp, rank):
    """World 4: data 2 x model 2 at ZeRO 1 and 2, fsdp 2 x model 2 at
    ZeRO 3, and zero.Init's pieces at the latter."""
    tr = inp["train"]
    out = {}
    for case in ("zero1", "zero2", "zero3"):
        eng = tp_engine(inp, case)
        out[case] = dict(rows=run(eng, tr[case]["batches"]),
                         layouts=layouts(eng), mesh=dict(eng.mesh.shape))
    cfg = tgpt.GPTConfig(**inp["fields"])
    c = tr["zero3"]["config"]
    mesh = mesh_lib.mesh_from_config(DeepSpeedConfig(c, world_size=4))
    shards = zero.Init(lambda seed: tgpt.init_leaves(cfg, seed=seed,
                                                     device="cpu"),
                       3, mesh, zero_stage=3, rules=tgpt.gpt_partition_rules(),
                       min_shard_size=c["zero_optimization"][
                           "stage3_min_shard_size"], device="cpu")
    whole = tgpt.init_params(cfg, seed=3, device="cpu")
    # JAX's contiguous cut of every leaf, qkv included
    cut = all(torch.equal(s, w[lay.store_box]) for s, w, lay in zip(
        tree_leaves(shards), tree_leaves(whole), shards.partition.flat))
    split = sum(s.shape != w.shape for s, w in zip(tree_leaves(shards),
                                                   tree_leaves(whole)))
    from_shards = tp_engine(inp, "zero3", params=shards)
    from_whole = tp_engine(inp, "zero3", params=whole)
    # the engine's pieces: the qkv leaves cut again head-aligned, every
    # other leaf taken as zero.Init cut it
    taken = [torch.equal(a, b) for a, b, lay in zip(
        tree_leaves(from_shards.params), tree_leaves(shards),
        from_shards._zero.flat) if lay.stored_columns is None]
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(from_whole.params), tree_leaves(from_shards.params)))
    out["init"] = dict(cut=cut, split=split, taken=all(taken),
                       n_taken=len(taken), same=same,
                       rows=run(from_shards, tr["zero3"]["batches"][:2]),
                       whole=run(from_whole, tr["zero3"]["batches"][:2]))
    return out


def cases_tp(inp, rank, world, device):
    if device != "cpu":
        return tp_inference_card(inp)
    if world == 2:
        out = dict(conjugate=conjugate_case(rank), infer=tp_inference(
            inp, "cpu"))
        out.update(tp_training2(inp, rank))
        return out
    return tp_training4(inp, rank)


def tp_inference_card(inp):
    """On the card: generate at mp_size 2 against the one-rank engine, and
    generate_fused's refusal of the gloo group."""
    from deepspeed_tpu_torch import init_inference
    cfg = tgpt.GPTConfig(**inp["fields"])
    out = {}
    for mp in (1, 2):
        eng = init_inference(model=(cfg, inp["params"]), mp_size=mp,
                             dtype=torch.float32)
        out[mp] = dict(gen=eng.generate(inp["toks"], 6),
                       logits=eng.forward(inp["toks"]).cpu().numpy())
    try:
        eng.generate_fused(inp["toks"], 6)
        out["fused_refused"] = None
    except ValueError as e:
        out["fused_refused"] = str(e)
    return out


# ---------------------------------------------------------------------------
# pipeline parallelism
# ---------------------------------------------------------------------------

def pipe_engine(inp, case, mesh=None, device="cpu"):
    """The case's engine over its mesh: the pipelined loss and the
    pipeline rules (a plain loss with ``plain``)."""
    c = inp["pipe"][case]
    cfg = tgpt.GPTConfig(**{**inp["fields"], **c.get("fields", {})})
    mesh = mesh or mesh_lib.make_mesh(mesh_lib.MeshSpec(**c["mesh"]))
    loss = tgpt.make_loss_fn(cfg) if c.get("plain") else \
        tgpt.make_pipeline_loss_fn(cfg, mesh, c["mesh"]["pipe"], c["micro"],
                                   schedule=c["schedule"],
                                   virtual_chunks=c.get("chunks", 1))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=loss, model_parameters=inp["params"], config=c["config"],
        mesh=mesh, partition_rules=tgpt.gpt_pipeline_partition_rules(
            tp=c["mesh"].get("model", 1) > 1), device=device)
    return eng


def pipe_case(inp, case):
    """One accumulation's gradients of the rank's compute boxes (no
    update), then the case's steps, the peak of stage inputs the last
    training step held, and the eval loss through ``eval_fn``."""
    c = inp["pipe"][case]
    eng = pipe_engine(inp, case)
    batches = inp["batches"]
    grads, loss = eng._accum_grads(eng._to_device(batches[0]))
    whole = None
    if hasattr(eng.loss_fn, "eval_fn"):
        # the loss given the whole tree takes its stage's rows itself
        whole = float(eng.loss_fn.eval_fn(inp["params"], {
            "tokens": torch.as_tensor(batches[0]["tokens"])}, None))
    out = dict(grads={lay.path: g.detach().numpy().copy() for lay, g in
                      zip(eng._zero.flat, tree_leaves(grads))},
               boxes={lay.path: [(b.start, b.stop) for b in lay.compute_box]
                      for lay in eng._zero.flat},
               loss=float(loss), whole=whole, coord=dict(eng.mesh.coord),
               mesh=dict(eng.mesh.shape), layouts=layouts(eng))
    comm.reset_stats()
    out["rows"] = run(eng, batches[:c.get("steps", 3)])
    out["comm"] = comm.stats()
    out["stats"] = dict(getattr(eng.loss_fn, "stats", {}))
    if c.get("eval"):
        out["eval"] = float(eng.eval_batch(batches[-1])[0])
    return out


def pipe_checkpoint(inp, rank):
    """The interleaved engine: the 16-bit export at the start (and a
    one-rank engine's), two steps, a save, the uninterrupted third; a
    fresh pipeline engine and a one-rank engine resume it."""
    batches = inp["batches"]
    d16 = os.path.join(inp["ckpt_dir"], f"w16_rank{rank}")
    eng = pipe_engine(inp, "interleaved")
    eng.save_16bit_model(d16, "pp.npz")
    cfg = tgpt.GPTConfig(**inp["fields"])
    one, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt.make_loss_fn(cfg), model_parameters=inp["params"],
        config=inp["pipe"]["interleaved"]["config"], mesh=_one_rank_mesh(),
        device="cpu")
    if rank == 0:
        one.save_16bit_model(d16, "one.npz")
    run(eng, batches[:2])
    eng.save_checkpoint(inp["ckpt_dir"], tag="pp2")
    out = dict(live=flat(eng.gather_params()), w16=d16,
               uninterrupted=run(eng, batches[2:3]))
    fresh = pipe_engine(inp, "interleaved")
    fresh.load_checkpoint(inp["ckpt_dir"], tag="pp2")
    out["resumed"] = run(fresh, batches[2:3])
    one.load_checkpoint(inp["ckpt_dir"], tag="pp2")
    out["one_loaded"] = flat(one.gather_params())
    if rank == 0:
        out["consolidated"] = flat(
            ckpt.load_fp32_state_dict_from_zero_checkpoint(inp["ckpt_dir"],
                                                           tag="pp2"))
    return out


def pipe_explicit(inp, rank, world):
    """make_1f1b_loss_fn and make_interleaved_loss_fn (2 chunks) over the
    world's stages on a stack of tanh layers and a squared-error head:
    the loss and the gradients of this stage's rows, the head and x (the
    last summed over the stages), beside the same composition run whole
    on this rank."""
    from deepspeed_tpu_torch.runtime.pipe import engine as pipe_lib
    e = inp["explicit"]
    mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(pipe=world, data=1))
    n = e["w"].shape[0] // world

    def stage_fn(p, x):
        for w in p["w"].unbind(0):
            x = torch.tanh(x @ w)
        return x

    def head_fn(other, y, t):
        return ((y @ other["h"]).squeeze(-1) - t).pow(2).mean()

    def leaves(rows):
        return ({"w": rows.clone().requires_grad_()},
                {"h": e["h"].clone().requires_grad_()},
                e["x"].clone().requires_grad_())
    st, ot, x = leaves(e["w"])
    M = x.shape[0]
    ref = sum(head_fn(ot, stage_fn(st, x[m]), e["t"][m]) for m in range(M)) / M
    want = torch.autograd.grad(ref, [st["w"], ot["h"], x])
    out = dict(ref=float(ref), want=[g.numpy()[s] for g, s in zip(
        want, (slice(rank * n, (rank + 1) * n), slice(None), slice(None)))])
    for name, fn in (
            ("1f1b", pipe_lib.make_1f1b_loss_fn(stage_fn, head_fn, world,
                                                mesh)),
            ("interleaved", pipe_lib.make_interleaved_loss_fn(
                stage_fn, head_fn, world, 2, M, mesh))):
        st, ot, x = leaves(e["w"][rank * n:(rank + 1) * n])
        loss = fn(st, ot, x, e["t"])
        got = torch.autograd.grad(loss * 2.0, [st["w"], ot["h"], x])
        with torch.no_grad():
            evaluated = fn(st, ot, x, e["t"])
        out[name] = dict(loss=float(loss), eval=float(evaluated),
                         grads=[g.numpy() / 2.0 for g in got])
    return out


def cases_pipe(inp, rank, world):
    out = {name: pipe_case(inp, name) for name, c in inp["pipe"].items()
           if c["world"] == world}
    if world == 2:
        out["ckpt"] = pipe_checkpoint(inp, rank)
    out["explicit"] = pipe_explicit(inp, rank, world)
    return out


def main():
    world, rank, store, inputs, outfile = sys.argv[1:6]
    world, rank = int(world), int(rank)
    mode = sys.argv[6] if len(sys.argv) > 6 else ""
    card = mode in ("cuda", "sp-cuda", "tp-cuda")
    torch.set_num_threads(1)
    deepspeed_tpu_torch.init_distributed(
        dist_backend="gloo", init_method=f"file://{store}",
        num_processes=world, process_id=rank,
        device="cuda" if card else "cpu")
    with open(inputs, "rb") as f:
        inp = pickle.load(f)
    if mode.startswith("sp"):
        out = cases_sp(inp, rank, world, "cuda" if card else "cpu")
    elif mode == "pipe":
        out = cases_pipe(inp, rank, world)
    elif mode.startswith("tp"):
        out = cases_tp(inp, rank, world, "cuda" if card else "cpu")
    else:
        cases = cases_card if card else (cases_world2 if world == 2
                                         else cases_world4)
        out = cases(inp, rank)
    with open(outfile, "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

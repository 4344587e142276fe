"""Sequence parallelism across ranks: the port's ring attention (contiguous
and zigzag layouts, sliding windows, packed segments, key masks, GQA),
Ulysses, and the engine over a ``sequence`` mesh axis, in real ``gloo``
worlds of 2 and 4 processes on the host (tests/torch_rank_worker.py in
its ``sp`` mode, one world per size running every case of that size)
against the JAX package's ``ring_attention``/``ulysses_attention`` and
engine on the conftest's virtual devices at the same ``sequence`` degree,
from the same seeded numpy inputs.

float32 throughout. Attention outputs to 1e-5, q/k/v gradients to rtol
1e-4 / atol 1e-5 (the JAX package's own ring tests' tolerances), engine
losses and gradient norms to 1e-5.
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
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.ops.attention.flash import mha_reference as jmha
from deepspeed_tpu.ops.attention.ring import ring_attention as jring
from deepspeed_tpu.ops.attention.ring import zigzag_perm as jzigzag_perm
from deepspeed_tpu.ops.attention.ulysses import ulysses_attention as julys
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.runtime import dataloader as jdata
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models.convert import params_from_numpy
from deepspeed_tpu_torch.ops.attention import ring as tring
from deepspeed_tpu_torch.runtime import dataloader as tdata
from test_torch_model import numpy_params, one_torch_thread  # noqa: F401
from test_torch_zero_ranks import WORKER, _collect

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=1e-5, atol=1e-5)
B, S, H, HKV, D = 2, 32, 8, 4, 8
GPT = dict(vocab_size=96, n_layers=2, n_heads=4, d_model=32, max_seq_len=32,
           remat=False)
LLAMA = dict(vocab_size=96, n_layers=2, n_heads=4, n_kv_heads=2,
             d_model=32, d_ff=48, max_seq_len=32, rotary_dim=8,
             norm="rmsnorm", activation="swiglu", use_bias=False,
             use_wpe=False, tie_embeddings=False, norm_eps=1e-6,
             remat=False)
CONFIG = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
          "gradient_clipping": 1.0, "steps_per_print": 1000,
          "optimizer": {"type": "AdamW", "params": {"lr": 2e-3,
                                                    "weight_decay": 0.1}}}
# (name, world, model, sp_impl, layout, zero stage, batch kind)
ENGINES = [
    ("gpt_ring", 2, "gpt", "ring", "contiguous", 0, "packed"),
    ("llama_ulysses", 2, "llama", "ulysses", "contiguous", 0, "packed"),
    ("gpt_ring_zero2", 4, "gpt", "ring", "contiguous", 2, "packed"),
    ("llama_zigzag_zero3", 4, "llama", "ring", "zigzag", 3, "packed"),
    ("gpt_ulysses_zero3", 4, "gpt", "ulysses", "contiguous", 3, "plain"),
]


def _spawn(world, inputs, tmp, mode="sp"):
    """One worker process per rank in ``mode`` (its results to the names
    ``test_torch_zero_ranks._collect`` reads)."""
    store = os.path.join(tmp, f"store{world}")
    return [subprocess.Popen(
        [sys.executable, WORKER, str(world), str(r), store, inputs,
         os.path.join(tmp, f"w{world}r{r}.pkl"), mode],
        cwd=os.path.dirname(os.path.dirname(WORKER)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def _attn_cases(n, rng):
    """name -> (impl, layout, window, with segments and key mask): the
    window cuts the ring to two hops at n = 4 (S_loc 8) and runs hop 1
    with q_off = 16 at n = 2."""
    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    base = dict(q=arr(B, S, H, D), k=arr(B, S, HKV, D), v=arr(B, S, HKV, D),
                do=arr(B, S, H, D))
    segs = np.sort(rng.integers(0, 4, (B, S)), axis=1).astype(np.int32)
    start = np.concatenate([np.ones((B, 1), bool),
                            segs[:, 1:] != segs[:, :-1]], 1)
    kvm = ((rng.random((B, S)) < 0.75) | start).astype(np.float32)
    cases = {}
    for name, impl, layout, window, packed in (
            ("contiguous", "ring", "contiguous", None, False),
            ("zigzag", "ring", "zigzag", None, False),
            ("window", "ring", "contiguous", 6, False),
            ("packed", "ring", "contiguous", None, True),
            ("zigzag_packed", "ring", "zigzag", None, True),
            ("ulysses", "ulysses", "contiguous", None, False),
            ("ulysses_packed", "ulysses", "contiguous", 6, True)):
        c = dict(base, impl=impl, layout=layout, window=window, chunk=4)
        if packed:
            c.update(segs=segs, kv_mask=kvm)
        cases[name] = c
    return cases


def _jax_attention(case, mesh, n):
    """JAX ring/Ulysses output and q/k/v gradients in the global order,
    and the dense reference's."""
    perm = jzigzag_perm(S, n) if case["layout"] == "zigzag" else \
        np.arange(S)
    kw = dict(causal=True, segment_ids=case.get("segs"),
              kv_mask=case.get("kv_mask"), window=case["window"])
    lay = {k: (None if case.get(k) is None else jnp.asarray(case[k][:, perm]))
           for k in ("q", "k", "v", "do", "segs", "kv_mask")}
    lkw = dict(kw, segment_ids=lay["segs"], kv_mask=lay["kv_mask"])
    if case["impl"] == "ring":
        def fn(q, k, v):
            return jring(q, k, v, mesh, layout=case["layout"], **lkw)
    else:
        def fn(q, k, v):
            return julys(q, k, v, mesh, **lkw)
    out, vjp = jax.vjp(fn, lay["q"], lay["k"], lay["v"])
    grads = vjp(lay["do"])
    got = [np.empty_like(np.asarray(t)) for t in (out,) + tuple(grads)]
    for g, t in zip(got, (out,) + tuple(grads)):
        g[:, perm] = np.asarray(t)
    dense = dict(kw, segment_ids=None if case.get("segs") is None
                 else jnp.asarray(case["segs"]))

    def ref(q, k, v):
        return jmha(q, k, v, **dense)
    r_out, r_vjp = jax.vjp(ref, *(jnp.asarray(case[x]) for x in "qkv"))
    return got, [np.asarray(t) for t in (r_out,) + r_vjp(
        jnp.asarray(case["do"]))]


def _assemble(results):
    """The ranks' (idx, out, dq, dk, dv) shards in the global order."""
    full = None
    for idx, *parts in results:
        if full is None:
            full = [np.empty((p.shape[0], S) + p.shape[2:], p.dtype)
                    for p in parts]
        for f, p in zip(full, parts):
            f[:, idx] = p
    return full


def _engine_batches(kind, layout, n, rng, vocab=96):
    out = []
    for _ in range(3):
        if kind == "packed":
            docs = [rng.integers(1, vocab, int(k))
                    for k in rng.integers(2, 12, 20)]
            b = {k: v[:4].copy() for k, v in
                 tdata.pack_documents(docs, S + 1).items()}
            for r in range(4):     # uneven mask counts across columns
                b["loss_mask"][r, S - 3 * (r + 1):] = 0
        else:
            b = {"tokens": rng.integers(1, vocab, (4, S + 1))}
        if layout == "zigzag":
            b = tdata.zigzag_batch(b, n)
        out.append(b)
    return out


def _engine_inputs():
    rng = np.random.default_rng(31)
    engines = {}
    for name, world, model, impl, layout, stage, kind in ENGINES:
        fields = GPT if model == "gpt" else LLAMA
        sp = dict(sequence_parallel=True, sp_impl=impl, sp_layout=layout)
        jcfg = jgpt.GPTConfig(**fields, dtype=jnp.float32)
        npp = numpy_params(jcfg, seed=11)
        config = dict(CONFIG, mesh={"sequence_parallel_size": 2},
                      zero_optimization={"stage": stage,
                                         "stage3_min_shard_size": 64})
        engines[name] = dict(
            world=world, fields=dict(fields, dtype=torch.float32, **sp),
            jfields=dict(fields, **sp), npp=npp, config=config,
            params=params_from_numpy(npp, tgpt.GPTConfig(
                **fields, dtype=torch.float32), device="cpu"),
            batches=_engine_batches(kind, layout, 2, rng))
    return engines


def _jax_engine(e, devices):
    n = e["world"]
    spec = jmesh.MeshSpec(data=n // 2, sequence=2) if e["config"][
        "zero_optimization"]["stage"] < 3 else \
        jmesh.MeshSpec(data=1, fsdp=n // 2, sequence=2)
    mesh = jmesh.make_mesh(spec, devices[:n])
    cfg = jgpt.GPTConfig(**e["jfields"], dtype=jnp.float32, mesh=mesh)
    eng = deepspeed_tpu.initialize(model=jgpt.make_loss_fn(cfg),
                                   model_parameters=e["npp"],
                                   config=dict(e["config"]), mesh=mesh)[0]
    return [(float(m["loss"]), float(m["grad_norm"]))
            for m in map(eng.train_batch, e["batches"])]


@pytest.fixture(scope="module")
def sp_worlds(tmp_path_factory, devices):
    """Both worlds' results and the JAX references, computed while the
    ranks run."""
    tmp = str(tmp_path_factory.mktemp("sp"))
    engines = _engine_inputs()
    results, refs = {}, {}
    for n in (2, 4):
        rng = np.random.default_rng(100 + n)
        attn = _attn_cases(n, rng)
        inp = dict(attn=attn, engine={
            k: {f: e[f] for f in ("fields", "params", "config", "batches")}
            for k, e in engines.items() if e["world"] == n})
        inputs = os.path.join(tmp, f"inputs{n}.pkl")
        with open(inputs, "wb") as f:
            pickle.dump(inp, f)
        procs = _spawn(n, inputs, tmp)
        mesh = jmesh.make_mesh(jmesh.MeshSpec(data=1, sequence=n),
                               devices[:n])
        refs[n] = dict(attn={k: _jax_attention(c, mesh, n)
                             for k, c in attn.items()}, cases=attn)
        refs[n]["engine"] = {k: _jax_engine(e, devices)
                             for k, e in engines.items() if e["world"] == n}
        results[n] = _collect(n, procs, tmp)
    return results, refs


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", ["contiguous", "zigzag", "window", "packed",
                                  "zigzag_packed", "ulysses",
                                  "ulysses_packed"])
def test_attention_matches_jax(sp_worlds, n, case):
    """The port's ring/Ulysses output and gradients, assembled from the
    ranks' shards, against JAX's ring_attention/ulysses_attention on a
    mesh of the same sequence degree, and against the dense reference."""
    results, refs = sp_worlds
    got = _assemble([r["attn"][case] for r in results[n]])
    want, dense = refs[n]["attn"][case]
    for name, g, w, d in zip(("out", "dq", "dk", "dv"), got, want, dense):
        tol = OUT_TOL if name == "out" else GRAD_TOL
        np.testing.assert_allclose(g, w, err_msg=f"{case} {name}", **tol)
        np.testing.assert_allclose(g, d, err_msg=f"{case} {name} dense",
                                   **tol)


def test_rotations_and_all_to_alls_are_counted(sp_worlds):
    """The ring's hops are rotations (the windowed case's cut short at
    n = 4), Ulysses' exchanges all-to-alls and its metadata all-gathers,
    each with its bytes; on the host nothing is staged."""
    results, _ = sp_worlds
    for n in (2, 4):
        for r in results[n]:
            c = r["attn_comm"]
            assert c["rotate"]["calls"] > 0 and c["rotate"]["bytes"] > 0
            # q, k, v and the output, forward and backward, in two cases
            assert c["all_to_all"]["calls"] == 2 * (4 + 4)
            assert c["all_gather"]["calls"] == 2
            assert all(v["staged"] == 0 for v in c.values())
    assert tring._num_steps(4, 8, True, 6) == 2
    assert tring._num_steps(2, 16, True, 6) == 2
    assert tring._step_cfg(1, 16, True, 6) == (True, 16, 6)


@pytest.mark.parametrize("name", [e[0] for e in ENGINES])
def test_engine_matches_jax(sp_worlds, name):
    """Three steps of a tiny GPT or llama (rotary, GQA) with the sequence
    split over 2 ranks (world 2: sequence=2; world 4: data=2 x
    sequence=2 at ZeRO 2 or 3), ring or Ulysses, contiguous or zigzag:
    losses and gradient norms equal the JAX engine's on the same mesh, on
    every rank."""
    results, refs = sp_worlds
    n = next(e[1] for e in ENGINES if e[0] == name)
    want = np.array(refs[n]["engine"][name])
    for rank, r in enumerate(results[n]):
        got = r["engine"][name]
        assert got["mesh"]["sequence"] == 2
        assert got["mesh"]["data"] * got["mesh"]["fsdp"] == n // 2
        np.testing.assert_allclose(np.array([x[:2] for x in got["rows"]]),
                                   want, err_msg=f"{name} rank {rank}",
                                   **TOL)


def test_zigzag_batch_matches_jax():
    rng = np.random.default_rng(3)
    docs = [rng.integers(1, 96, int(k)) for k in rng.integers(2, 12, 20)]
    b = {k: v[:4] for k, v in tdata.pack_documents(docs, S + 1).items()}
    for batch in (b, {"tokens": b["tokens"]}):
        got, want = tdata.zigzag_batch(batch, 4), jdata.zigzag_batch(batch, 4)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    np.testing.assert_array_equal(tring.zigzag_perm(32, 4),
                                  jzigzag_perm(32, 4))

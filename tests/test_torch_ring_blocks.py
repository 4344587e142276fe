"""Ring attention's local block and the refusals of sequence parallelism.

The port's ``flash_block_fwd``/``flash_block_bwd`` (their plain versions
on the host: ``mha_reference`` and the kernels' backward formulas with
``q_off`` and the keys' own segment ids, fp32 gradients) and the ring's
chunked plain block (``ring._plain_block_fwd``/``_bwd``) against the JAX
package's ``flash_block_fwd``/``flash_block_bwd`` (Pallas in interpret
mode) and ``_jnp_block_fwd``/``_jnp_block_bwd``, float32, to 1e-5. Rows
with no visible key are garbage by contract in both packages: they are
left out of the output comparison and their output gradient is zero.
Then the refusal texts of ring, Ulysses and the GPT model's sequence
parallelism against the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.ops.attention import flash as jflash
from deepspeed_tpu.ops.attention import ring as jring
from deepspeed_tpu.ops.attention import ulysses as julys
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.ops.attention import flash as tflash
from deepspeed_tpu_torch.ops.attention import ring as tring
from deepspeed_tpu_torch.ops.attention import ulysses as tulys
from deepspeed_tpu_torch.parallel.mesh import AxisGroup
from test_torch_model import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
S_LOC, D = 32, 16

# (name, q_off, causal, window, separate segments + key mask, GQA)
CASES = [
    ("hop1_window", S_LOC, True, 40, False, False),
    ("hop2_window", 2 * S_LOC, True, 80, False, True),
    ("hop1_packed_gqa", S_LOC, True, 48, True, True),
    ("zigzag_half_packed", 0, False, None, True, True),
    ("self_window_gqa", 0, True, 8, True, True),
]
# the Pallas interpret-mode comparison takes the cases with an offset or
# separate key ids (the JAX package's own flash tests hold the rest)
PALLAS_CASES = [c for c in CASES if c[1] or c[0].startswith("zigzag")]


def _problem(case, seed=0):
    name, q_off, causal, window, packed, gqa = case
    rng = np.random.default_rng(seed)
    H, Hkv = (4, 2) if gqa else (2, 2)
    q = rng.standard_normal((2, S_LOC, H, D)).astype(np.float32)
    k = rng.standard_normal((2, S_LOC, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((2, S_LOC, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((2, S_LOC, H, D)).astype(np.float32)
    qs = ks = kvm = None
    if packed:
        qs = np.sort(rng.integers(0, 3, (2, S_LOC)), 1).astype(np.int32)
        ks = np.sort(rng.integers(0, 3, (2, S_LOC)), 1).astype(np.int32)
        kvm = (rng.random((2, S_LOC)) < 0.8).astype(np.float32)
    rows = q_off + np.arange(S_LOC)[:, None]
    cols = np.arange(S_LOC)[None]
    ok = np.ones((2, S_LOC, S_LOC), bool)
    if causal:
        ok &= (cols <= rows)[None]
        if window is not None:
            ok &= (rows - cols < window)[None]
    if packed:
        ok &= qs[:, :, None] == ks[:, None, :]
        ok &= (kvm > 0)[:, None, :]
    valid = ok.any(-1)                         # [B, S]
    do[~valid] = 0.0
    return dict(q=q, k=k, v=v, do=do, qs=qs, ks=ks, kvm=kvm, valid=valid,
                q_off=q_off, causal=causal, window=window)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _port_block(p):
    kw = dict(causal=p["causal"], window=p["window"], q_off=p["q_off"])
    q, k, v, do = (_t(p[x]) for x in ("q", "k", "v", "do"))
    o, lse = tflash.flash_block_fwd(q, k, v, _t(p["kvm"]), _t(p["qs"]),
                                    _t(p["ks"]), **kw)
    grads = tflash.flash_block_bwd(q, k, v, do, o, lse, _t(p["kvm"]),
                                   _t(p["qs"]), _t(p["ks"]), **kw)
    assert all(g.dtype == torch.float32 for g in grads)
    return o.numpy(), lse.numpy(), [g.numpy() for g in grads]


def _compare(p, got, want, what):
    (o, lse, grads), (wo, wlse, wgrads) = got, want
    valid = p["valid"]
    np.testing.assert_allclose(o[valid], wo[valid], err_msg=f"{what} o",
                               **TOL)
    np.testing.assert_allclose(lse.transpose(0, 2, 1)[valid],
                               wlse.transpose(0, 2, 1)[valid],
                               err_msg=f"{what} lse", **TOL)
    for n, g, w in zip(("dq", "dk", "dv"), grads, wgrads):
        np.testing.assert_allclose(g, w, err_msg=f"{what} {n}", **TOL)


@pytest.mark.parametrize("case", PALLAS_CASES,
                         ids=[c[0] for c in PALLAS_CASES])
def test_block_matches_jax_flash_block(case, pallas_interpret):
    """The port's block entry points against JAX's Pallas block kernels
    (interpret mode) with q_off, windows, separate q/kv segment ids, key
    masks and GQA."""
    p = _problem(case)
    kw = dict(causal=p["causal"], window=p["window"], q_off=p["q_off"],
              block_q=16, block_kv=16)
    args = [_j(p[x]) for x in ("q", "k", "v")]
    meta = [_j(p["kvm"]), _j(p["qs"]), _j(p["ks"])]
    wo, wlse = jflash.flash_block_fwd(*args, *meta, **kw)
    wgrads = jflash.flash_block_bwd(*args, _j(p["do"]), wo, wlse, *meta,
                                    **kw)
    want = (np.asarray(wo), np.asarray(wlse),
            [np.asarray(g) for g in wgrads])
    _compare(p, _port_block(p), want, case[0])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_blocks_match_jax_jnp_blocks(case):
    """The ring's chunked plain block and the port's block entry points
    against JAX's ``_jnp_block_fwd``/``_jnp_block_bwd`` (chunks of 8)."""
    p = _problem(case, seed=1)
    scale = 1.0 / np.sqrt(D)
    kw = dict(blk_causal=p["causal"], window=p["window"], q_off=p["q_off"],
              scale=scale, chunk=8)
    jargs = [_j(p[x]) for x in ("q", "k", "v")]
    jmeta = [_j(p["qs"]), _j(p["ks"]), _j(p["kvm"])]
    wo, wlse = jring._jnp_block_fwd(*jargs, *jmeta, **kw)
    wo = np.asarray(wo).transpose(0, 2, 1, 3)
    delta = np.asarray(jnp.sum(_j(p["do"]) * jnp.asarray(wo), -1)
                       ).transpose(0, 2, 1)
    wdq, wdk, wdv = jring._jnp_block_bwd(*jargs, _j(p["do"]), wlse,
                                         jnp.asarray(delta), *jmeta, **kw)
    want = (wo, np.asarray(wlse),
            [np.asarray(wdq).transpose(0, 2, 1, 3),
             np.asarray(wdk).transpose(0, 2, 1, 3),
             np.asarray(wdv).transpose(0, 2, 1, 3)])
    targs = [_t(p[x]) for x in ("q", "k", "v")]
    tmeta = [_t(p["qs"]), _t(p["ks"]), _t(p["kvm"])]
    o, lse = tring._plain_block_fwd(*targs, *tmeta, **kw)
    grads = tring._plain_block_bwd(*targs, _t(p["do"]), lse,
                                   torch.from_numpy(delta.copy()), *tmeta,
                                   **kw)
    _compare(p, (o.numpy(), lse.numpy(), [g.numpy() for g in grads]), want,
             f"{case[0]} chunked")
    _compare(p, _port_block(p), want, f"{case[0]} block")


def test_block_refuses_what_the_kernels_do_not_take():
    q = torch.zeros(1, 8, 2, 8)
    s = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="both or neither"):
        tflash.flash_block_fwd(q, q, q, q_segs=s)
    with pytest.raises(ValueError, match="q_off must be >= 0"):
        tflash.flash_block_fwd(q, q, q, q_off=-1)
    with pytest.raises(ValueError, match="needs lse"):
        tflash.flash_block_bwd(q, q, q, q)


def _raised(fn):
    with pytest.raises((ValueError, AssertionError)) as e:
        fn()
    return str(e.value)


def test_refusal_texts_match_jax(monkeypatch, devices):
    """Each refusal of sequence parallelism raises ValueError with the
    JAX package's text."""
    jm = jmesh.make_mesh(jmesh.MeshSpec(data=1, sequence=2), devices[:2])
    jq = jnp.zeros((1, 8, 3, 8))
    tq = torch.zeros(1, 4, 3, 8)
    # ring: a window or non-causal attention under zigzag, unknown layout
    for kw in (dict(layout="zigzag", window=4),
               dict(layout="zigzag", causal=False), dict(layout="spiral")):
        assert _raised(lambda: tring.ring_attention(tq, tq, tq, **kw)) == \
            _raised(lambda: jring.ring_attention(jq, jq, jq, jm, **kw))
    # Ulysses: the sp degree must divide both head counts
    monkeypatch.setattr(tulys, "sequence_group", lambda mesh, axis: AxisGroup(
        ("sequence",), (0, 1), 0, object()))
    tk = torch.zeros(1, 4, 1, 8)
    for tkv, jkv in ((tq, jq), (tk, jnp.zeros((1, 8, 1, 8)))):
        t4 = torch.zeros(1, 4, 4, 8) if tkv is tk else tq
        j4 = jnp.zeros((1, 8, 4, 8)) if tkv is tk else jq
        assert _raised(lambda: tulys.ulysses_attention(t4, tkv, tkv)) == \
            _raised(lambda: julys.ulysses_attention(j4, jkv, jkv, jm))
    # the model: zigzag under Ulysses, an unknown sp_impl, zigzag without
    # positions
    fields = dict(vocab_size=16, n_layers=1, n_heads=2, d_model=16,
                  max_seq_len=16, sequence_parallel=True)
    for extra in (dict(sp_impl="ulysses", sp_layout="zigzag"),
                  dict(sp_impl="spiral")):
        jcfg = jgpt.GPTConfig(**fields, **extra, mesh=jm)
        tcfg = tgpt.GPTConfig(**fields, **extra)
        assert _raised(lambda: tgpt._attention(tq, tq, tq, tcfg)) == \
            _raised(lambda: jgpt._attention(jq, jq, jq, jcfg))
    jcfg = jgpt.GPTConfig(**fields, sp_layout="zigzag", mesh=jm)
    tcfg = tgpt.GPTConfig(**fields, sp_layout="zigzag")
    jp = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tgpt.init_params(tcfg, device="cpu")
    assert _raised(lambda: tgpt.forward(tp, torch.zeros(1, 8, dtype=torch.long),
                                        tcfg)) == \
        _raised(lambda: jgpt.forward(jp, jnp.zeros((1, 8), jnp.int32), jcfg))
    # the window implementation's name
    assert _raised(lambda: tflash.resolve_window_impl(8, "tiled")) == \
        _raised(lambda: jflash.resolve_window_impl(8, "tiled"))
    assert tflash.resolve_window_impl(8, "masked") == 8

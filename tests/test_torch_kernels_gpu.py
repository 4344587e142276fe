"""Card-only tests: the port's CUDA kernels against their plain PyTorch
versions on the same inputs.

Each test asks for the ``cuda`` fixture, which skips when no card is
visible, so the set of collected tests never depends on the machine.
The suite's conftest imports JAX, which the card's machine may lack; run
these there with::

    python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py

Tolerances: float32 outputs to 1e-4 and the LSE to 1e-3 (the kernel sums
in another order than the plain version); bfloat16 outputs to 2e-2, the
repo's bf16 parity tolerance, against the plain version run in float32 on
the same bf16 inputs (the kernel keeps its scores and sums in fp32 and
rounds only p, as the TPU kernel does, and the output). Each tolerance
holds for the largest error and also relative to the output's own scale
(per query row for flash and block-sparse attention, per slot for paged,
per output row for the int8 matmul), so that rows attending many keys, whose outputs are small,
are held as tightly as the rest; the int8 matmul's largest error is held
relative to its largest output (a sum over K terms, up to ~10 at the
llama-7b widths).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import int8_matmul
from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops.attention import flash, paged


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return 1e-4 if dtype == torch.float32 else 2e-2    # bf16 and fp16


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device=device, dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", [
    dict(B=2, S=128, H=4, Hkv=4, D=128),
    dict(B=2, S=100, H=8, Hkv=2, D=128),                 # ragged S, GQA
    dict(B=1, S=96, H=4, Hkv=4, D=64, window=17),
    dict(B=3, S=64, H=2, Hkv=1, D=64, pad=True),         # left-pad kv_mask
    dict(B=1, S=70, H=2, Hkv=2, D=128, causal=False),
    dict(B=4, S=256, H=4, Hkv=4, D=64, causal=False, tail=True),   # BERT
    dict(B=2, S=150, H=4, Hkv=2, D=64, segs=True),       # packed segments
    dict(B=2, S=128, H=4, Hkv=4, D=128, segs=True, window=40),
])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    rng = np.random.default_rng(0)
    B, S, H, Hkv, D = (case[k] for k in ("B", "S", "H", "Hkv", "D"))
    causal = case.get("causal", True)
    q = _randn(rng, (B, S, H, D), dtype, cuda)
    k = _randn(rng, (B, S, Hkv, D), dtype, cuda)
    v = _randn(rng, (B, S, Hkv, D), dtype, cuda)
    mask = None
    if case.get("pad"):
        pads = np.array([0, 5, 40])[:B]
        mask = torch.from_numpy((np.arange(S)[None] >= pads[:, None])
                                .astype(np.float32)).to(cuda)
    if case.get("tail"):
        mask = _padded_tails(B, S, cuda)
    kw = dict(causal=causal, kv_mask=mask, window=case.get("window"),
              segment_ids=_segments(rng, B, S, cuda) if case.get("segs")
              else None)
    n0 = flash.flash_attention.launches
    o, lse = flash.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash.flash_attention.launches == n0 + 1
    o_ref, lse_ref = flash.mha_reference(q.float(), k.float(), v.float(), **kw)
    valid = torch.ones(B, S, dtype=torch.bool, device=cuda)
    if case.get("pad"):                # rows with no valid key: garbage
        valid = mask > 0
    diff = (o.float() - o_ref).abs()[valid]
    err = diff.max().item()
    rel = (diff.amax(-1) / o_ref.abs()[valid].amax(-1)).max().item()
    assert err <= _tol(dtype) and rel <= _tol(dtype), (err, rel)
    lse_err = (lse - lse_ref).abs().transpose(1, 2)[valid].max().item()
    assert lse_err <= 1e-3, lse_err


def _padded_tails(B, S, device):
    """[B, S] int32 attention mask of a BERT batch: some rows end in
    padding, every row keeps its first half."""
    lengths = np.array([S, S - 56, S // 2 + 3, S])[:B]
    return torch.from_numpy((np.arange(S)[None] < lengths[:, None])
                            .astype(np.int32)).to(device)


def _segments(rng, B, S, device):
    """[B, S] int32 ids of packed rows: documents of random lengths, the
    tail of each row a padding segment -1 (as ``pack_documents`` emits)."""
    segs = np.full((B, S), -1, np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(1, S - 8), 3, replace=False))
        for i, (lo, hi) in enumerate(zip([0, *cuts[:-1]], cuts)):
            segs[b, lo:hi] = i
    return torch.from_numpy(segs).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", [
    dict(B=2, S=128, H=4, Hkv=4, D=64),
    dict(B=2, S=100, H=8, Hkv=2, D=128),                 # ragged S, GQA
    dict(B=1, S=200, H=4, Hkv=1, D=64, window=33),       # MQA, window
    dict(B=3, S=96, H=2, Hkv=2, D=128, pad=True),        # left-pad kv_mask
    dict(B=1, S=70, H=2, Hkv=2, D=64, causal=False),
    dict(B=4, S=256, H=4, Hkv=4, D=64, causal=False, tail=True),   # BERT
    dict(B=2, S=150, H=4, Hkv=4, D=64, segs=True),       # packed segments
    dict(B=2, S=130, H=8, Hkv=2, D=128, segs=True, window=40),
])
def test_flash_bwd_kernels_match_plain(cuda, case, dtype):
    """K2-dq and K2-dkv against the plain formulas on the same q, k, v, o,
    lse and do (the plain version in float32 on the same rounded inputs),
    each gradient held by its largest error and relative to each row's own
    scale (floored at 1e-3 of the gradient's largest entry: dq of a row
    that sees one key is zero but for rounding noise); two launches give
    the same bits (no atomics)."""
    rng = np.random.default_rng(4)
    B, S, H, Hkv, D = (case[k] for k in ("B", "S", "H", "Hkv", "D"))
    q = _randn(rng, (B, S, H, D), dtype, cuda)
    k = _randn(rng, (B, S, Hkv, D), dtype, cuda)
    v = _randn(rng, (B, S, Hkv, D), dtype, cuda)
    do = _randn(rng, (B, S, H, D), dtype, cuda)
    mask = None
    valid = torch.ones(B, S, dtype=torch.bool, device=cuda)
    if case.get("pad"):
        pads = np.array([0, 5, 40])[:B]
        mask = torch.from_numpy((np.arange(S)[None] >= pads[:, None])
                                .astype(np.float32)).to(cuda)
        valid = mask > 0
        do = do * valid[:, :, None, None]     # the loss masks padded rows
    if case.get("tail"):
        mask = _padded_tails(B, S, cuda)
    kw = dict(causal=case.get("causal", True), kv_mask=mask,
              window=case.get("window"),
              segment_ids=_segments(rng, B, S, cuda) if case.get("segs")
              else None)
    o, lse = flash.flash_attention(q, k, v, **kw)
    n_dq = flash.flash_attention.bwd_dq_launches
    n_dkv = flash.flash_attention.bwd_dkv_launches
    got = flash.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert flash.flash_attention.bwd_dq_launches == n_dq + 2
    assert flash.flash_attention.bwd_dkv_launches == n_dkv + 2
    ref = flash.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, g, g2, r in zip(("dq", "dk", "dv"), got, again, ref):
        assert torch.equal(g, g2), f"{name} differs between two launches"
        diff = (g.float() - r).abs()[valid]       # [rows, heads, D]
        scale = r.abs()[valid].amax(-1).clamp_min(1e-3 * r.abs().max().item())
        err, rel = diff.max().item(), (diff.amax(-1) / scale).max().item()
        # gradients are sums over up to S rows of O(1) terms: the absolute
        # error is held relative to the largest entry
        bound = tol * max(1.0, r.abs().max().item())
        assert err <= bound and rel <= tol, (name, err, rel)


@pytest.mark.gpu
def test_flash_autograd_on_card_matches_host(cuda):
    """``FlashAttention`` differentiated on the card (K1-fwd, K2-dq,
    K2-dkv) against the same function on the host (plain versions), small
    float32 shape with GQA, a window and packed segments."""
    rng = np.random.default_rng(5)
    B, S, H, Hkv, D = 2, 80, 4, 2, 64
    host = [torch.from_numpy(rng.standard_normal(s, np.float32))
            .requires_grad_() for s in ((B, S, H, D), (B, S, Hkv, D),
                                        (B, S, Hkv, D))]
    card = [t.detach().to(cuda).requires_grad_() for t in host]
    w = torch.from_numpy(rng.standard_normal((B, S, H, D), np.float32))
    segs = _segments(rng, B, S, "cpu")
    grads = []
    for (q, k, v), dev in ((host, "cpu"), (card, cuda)):
        o, _ = flash.flash_attention(q, k, v, window=30,
                                     segment_ids=segs.to(dev))
        grads.append(torch.autograd.grad((o * w.to(dev)).sum(), (q, k, v)))
    for gh, gc in zip(*grads):
        rel = ((gc.cpu() - gh).abs().max() / gh.abs().max()).item()
        assert rel <= 1e-4, rel


# The tile edges of the tensor-core designs (bfloat16 and float16): K1-fwd
# and K2-dq take 64-row q tiles of 4 warps x 16 rows and walk key tiles of
# 32 keys at head dim 64 and 64 at head dim 128 (`fwd_kt`, `dq_kt`);
# K2-dkv takes 64-key tiles of 4 warps x 16 keys and walks q tiles of 32
# rows at every head dim (`DKV_QT`).
_EDGES = [
    dict(B=2, S=1, H=2, Hkv=2, D=64),
    dict(B=2, S=9, H=2, Hkv=2, D=128),
    dict(B=2, S=33, H=2, Hkv=2, D=64),       # one past a 32 tile
    dict(B=2, S=63, H=2, Hkv=1, D=64),
    dict(B=2, S=65, H=2, Hkv=2, D=128),
    dict(B=1, S=1000, H=2, Hkv=2, D=64),
    dict(B=2, S=300, H=2, Hkv=2, D=64, window=129),      # crosses tiles
    # a kv_mask that blanks the whole key tile 64..127 in mid-row
    dict(B=2, S=256, H=2, Hkv=2, D=64, causal=False, blank=(64, 128)),
    dict(B=2, S=256, H=2, Hkv=2, D=128, blank=(64, 128)),
    # left padding: a row's first valid key lies in a later tile, so the
    # earlier tiles are fully masked (p = 1 until alpha = 0 wipes it)
    dict(B=2, S=200, H=2, Hkv=2, D=64, pad=100),
    # one segment boundary at column 32, 63, 64 or 65
    dict(B=2, S=160, H=2, Hkv=2, D=64, seg_at=32),
    dict(B=2, S=160, H=2, Hkv=2, D=64, seg_at=63),
    dict(B=2, S=160, H=2, Hkv=2, D=128, seg_at=64),
    dict(B=2, S=160, H=2, Hkv=2, D=64, seg_at=65, causal=False),
    dict(B=2, S=192, H=8, Hkv=2, D=128),                 # GQA group 4
    dict(B=1, S=192, H=8, Hkv=1, D=128),                 # GQA group 8
    # q, k, v as strided views of one fused [B, S, H*D + 2*Hkv*D] tensor
    dict(B=2, S=130, H=4, Hkv=4, D=64, fused=True),
    dict(B=2, S=130, H=8, Hkv=2, D=128, fused=True),
    # a window that crosses the 64-key tiles of head dim 128
    dict(B=1, S=1000, H=2, Hkv=2, D=128, window=129),
]


def _edge_problem(case, dtype, device):
    rng = np.random.default_rng(6)
    B, S, H, Hkv, D = (case[k] for k in ("B", "S", "H", "Hkv", "D"))
    if case.get("fused"):
        qkv = _randn(rng, (B, S, H * D + 2 * Hkv * D), dtype, device)
        q, k, v = torch.split(qkv, [H * D, Hkv * D, Hkv * D], dim=-1)
        q, k, v = (t.reshape(B, S, -1, D) for t in (q, k, v))
        assert not q.is_contiguous() and q.stride(1) == qkv.shape[-1]
    else:
        q = _randn(rng, (B, S, H, D), dtype, device)
        k = _randn(rng, (B, S, Hkv, D), dtype, device)
        v = _randn(rng, (B, S, Hkv, D), dtype, device)
    cols = np.arange(S)[None].repeat(B, 0)
    mask = segs = None
    if "blank" in case:
        lo, hi = case["blank"]
        mask = torch.from_numpy(((cols < lo) | (cols >= hi))
                                .astype(np.float32)).to(device)
    if "pad" in case:
        mask = torch.from_numpy((cols >= case["pad"]).astype(np.float32)
                                ).to(device)
    if "seg_at" in case:
        segs = torch.from_numpy((cols >= case["seg_at"]).astype(np.int32)
                                ).to(device)
    kw = dict(causal=case.get("causal", True), kv_mask=mask,
              window=case.get("window"), segment_ids=segs)
    ok = flash._allowed(S, S, device, kw["causal"], kw["window"], mask, segs)
    valid = torch.ones(B, S, dtype=torch.bool, device=device) if ok is None \
        else ok.any(-1)[:, 0].expand(B, S)   # rows with a valid key
    return q, k, v, kw, valid


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", _EDGES)
def test_flash_mma_tile_edges_match_plain(cuda, case, dtype):
    """K1-fwd, K2-dq and K2-dkv, all three on the tensor cores, at the tile
    edges of the fragment designs, against the plain versions in float32
    on the same rounded inputs, at the bf16/fp16 tolerance of the tests
    above; two backward launches give the same bits. Rows with no valid
    key are garbage by contract and are left out (their dO is zero)."""
    assert all(flash.DESIGN[(kernel, dtype)] == "mma"
               for kernel in ("K1-fwd", "K2-dq", "K2-dkv"))
    q, k, v, kw, valid = _edge_problem(case, dtype, cuda)
    if case.get("fused"):     # aligned views go to the kernels uncopied
        assert all(flash.kernel_layout(t) is t for t in (q, k, v))
    tol = _tol(dtype)
    n0 = flash.flash_attention.launches
    o, lse = flash.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash.flash_attention.launches == n0 + 1
    o_ref, lse_ref = flash.mha_reference(q.float(), k.float(), v.float(), **kw)
    diff = (o.float() - o_ref).abs()[valid]
    err = diff.max().item()
    rel = (diff.amax(-1) / o_ref.abs()[valid].amax(-1)).max().item()
    assert err <= tol and rel <= tol, ("o", err, rel)
    lse_err = (lse - lse_ref).abs().transpose(1, 2)[valid].max().item()
    assert lse_err <= 1e-3, lse_err

    g = torch.Generator(device=cuda).manual_seed(7)
    do = torch.randn(q.shape, generator=g, device=cuda).to(dtype)
    do = do * valid[:, :, None, None]
    n_dq = flash.flash_attention.bwd_dq_launches
    n_dkv = flash.flash_attention.bwd_dkv_launches
    got = flash.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert flash.flash_attention.bwd_dq_launches == n_dq + 2
    assert flash.flash_attention.bwd_dkv_launches == n_dkv + 2
    ref = flash.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), **kw)
    for name, gk, g2, r in zip(("dq", "dk", "dv"), got, again, ref):
        assert torch.equal(gk, g2), f"{name} differs between two launches"
        # the row scale is floored at 1e-3 of the largest entry, or of 1
        # where every entry is below 1 (dq at S = 1 is zero in exact
        # arithmetic: its rounding noise has no scale of its own)
        top = max(1.0, r.abs().max().item())
        diff = (gk.float() - r).abs()
        scale = r.abs().amax(-1).clamp_min(1e-3 * top)
        err, rel = diff.max().item(), (diff.amax(-1) / scale).max().item()
        bound = tol * top
        assert err <= bound and rel <= tol, (name, err, rel)


def _pool_problem(rng, dtype, device, B=4, Hkv=2, group=2, Dh=128, bs=16,
                  NB=6, q_len=1, lens=None):
    N = B * NB + 1
    q = _randn(rng, (B, q_len, Hkv, group, Dh), dtype, device)
    kp = _randn(rng, (N, bs, Hkv, Dh), dtype, device)
    vp = _randn(rng, (N, bs, Hkv, Dh), dtype, device)
    ids = rng.permutation(np.arange(1, N)).reshape(B, NB)
    tables = torch.from_numpy(ids.astype(np.int32)).to(device)
    cap = bs * NB - q_len
    if lens is None:
        lens = [bs // 2, 2 * bs + 1, bs * 3 - 1, cap]
    elif lens == "spread":     # from an empty cache up to the full table
        lens = [0, 1, cap // 2, cap]
    lens = np.array(lens)[:B]
    lengths = torch.from_numpy(lens.astype(np.int32)).to(device)
    return q, kp, vp, tables, lengths



@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(),
    dict(Hkv=4, group=1, Dh=64),
    dict(window=21),
    dict(q_len=4, group=4),
    dict(q_len=3, window=9, Dh=64, bs=8),
    dict(bs=4, NB=40, window=30),                        # several splits
    dict(lens="spread", NB=32, group=1),                 # lengths 0 .. full
    dict(lens="spread", NB=32, q_len=4, group=4, Dh=64),
    dict(NB=64, window=400, group=1),                    # window, 7 splits
    dict(q_len=5, group=4, Dh=64, NB=8),                 # R = 20: 2 passes
])
def test_paged_kernel_matches_plain(cuda, case, dtype):
    rng = np.random.default_rng(1)
    case = dict(case)
    window = case.pop("window", None)
    q, kp, vp, tables, lengths = _pool_problem(rng, dtype, cuda, **case)
    scale = q.shape[-1] ** -0.5
    n0 = paged.paged_attention.launches
    if q.shape[1] == 1:
        out = paged.paged_decode_attention(q[:, 0], kp, vp, tables, lengths,
                                           scale=scale, window=window)
        ref = paged.paged_decode_reference(
            q[:, 0].float(), kp.float(), vp.float(), tables, lengths,
            scale=scale, window=window)
    else:
        out = paged.paged_verify_attention(q, kp, vp, tables, lengths,
                                           scale=scale, window=window)
        ref = paged.paged_verify_reference(
            q.float(), kp.float(), vp.float(), tables, lengths, scale=scale,
            window=window)
    torch.cuda.synchronize()
    assert paged.paged_attention.launches == n0 + 1
    B = q.shape[0]
    diff = (out.float() - ref).abs().reshape(B, -1)
    err = diff.max().item()
    rel = (diff.amax(1) / ref.abs().reshape(B, -1).amax(1)).max().item()
    assert err <= _tol(dtype) and rel <= _tol(dtype), (err, rel)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
def test_paged_kernel_two_launches_same_bits(cuda, int8):
    """Slots whose work takes several of the plan's splits (lengths up to
    a full table of 1024 positions) are merged in split order: two
    launches give the same bits, in both pool modes."""
    rng = np.random.default_rng(9)
    kw = dict(NB=64, q_len=2, group=2, lens=[5, 300, 700, 1022])
    if int8:
        q, (kp, vp), (ks, vs), tables, lengths = _int8_pool_problem(
            rng, cuda, **kw)
        q = q.to(torch.bfloat16)
        extra = dict(k_scale=ks, v_scale=vs)
    else:
        q, kp, vp, tables, lengths = _pool_problem(rng, torch.bfloat16,
                                                   cuda, **kw)
        extra = {}
    outs = [paged.paged_verify_attention(q, kp, vp, tables, lengths,
                                         scale=0.1, **extra)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
def test_paged_kernel_ignores_stale_blocks(cuda):
    """Pool entries past each slot's length never reach the output: stale
    lanes of the slot's last block are poisoned with large values, and
    whole table entries past it with NaN, which the kernel must never
    read."""
    rng = np.random.default_rng(2)
    q, kp, vp, tables, lengths = _pool_problem(rng, torch.float32, cuda)
    out = paged.paged_decode_attention(q[:, 0], kp, vp, tables, lengths,
                                       scale=0.1)
    kp2, vp2 = kp.clone(), vp.clone()
    bs = kp.shape[1]
    for b in range(tables.shape[0]):
        last = int(lengths[b]) // bs
        for j in range(tables.shape[1]):
            for s in range(bs):
                if j * bs + s > int(lengths[b]):
                    poison = float("nan") if j > last else 1e4
                    kp2[tables[b, j], s] = poison
                    vp2[tables[b, j], s] = -poison
    out2 = paged.paged_decode_attention(q[:, 0], kp2, vp2, tables, lengths,
                                        scale=0.1)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)


@pytest.mark.gpu
def test_engine_on_card_matches_host(cuda):
    """The whole serving path on the card (K1 in generate's prefill, K3 in
    every decode step) against the same float32 model on the host, for a
    llama-dialect config with GQA, rotary and a sliding window at head dim
    64: logits of the static prefill within 1e-4 relative, and the greedy
    streams of generate and of a ServingEngine drain with chunked prefill
    and an eviction identical."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.serving import (ServeRequest,
                                                       ServingEngine)
    from deepspeed_tpu_torch.models import gpt
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gpt.preset("llama-tiny", n_layers=2, d_model=512, n_heads=8,
                     n_kv_heads=2, attn_window=24, max_seq_len=128)
    params = gpt.init_params(cfg, seed=0, device="cpu")
    engines = [init_inference(model=(cfg, params), dtype=torch.float32,
                              device=d) for d in ("cpu", "cuda")]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (7, 30, 19)]
    batch = np.stack([p[:7] for p in prompts])
    host, card = (e._prefill_fn(torch.as_tensor(batch.astype(np.int64),
                                                device=e.device))[0]
                  for e in engines)
    rel = ((card.cpu() - host).abs().max() / host.abs().max()).item()
    assert rel <= 1e-4, rel
    outs = []
    for e in engines:
        gen = e.generate(batch, max_new_tokens=10)
        srv = ServingEngine(e, num_slots=2, block_size=16, num_blocks=5,
                            prefill_chunk=16)
        srv.cache.watermark = 0
        served = srv.run([ServeRequest(rid=i, prompt=p, max_new_tokens=24)
                          for i, p in enumerate(prompts)])
        outs.append((gen, served, srv.stats["evictions"]))
    (g_h, s_h, ev_h), (g_c, s_c, ev_c) = outs
    np.testing.assert_array_equal(g_c, g_h)
    assert ev_h == ev_c and ev_c >= 1
    for rid in s_h:
        np.testing.assert_array_equal(s_c[rid], s_h[rid])


def _int8_problem(rng, M, K, N, dtype, device):
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.02
    scale = np.abs(w).max(0, keepdims=True) / 127.0 + 1e-12
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    x = _randn(rng, (M, K), dtype, device)
    return (x, torch.from_numpy(q).to(device),
            torch.from_numpy(scale.astype(np.float32)).to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (1, 4096, 4096), (8, 4096, 12288), (8, 11008, 4096), (256, 4096, 11008),
    (37, 1000, 1000), (3, 72, 200),            # ragged: no TMA, row tiles
    (256, 4096, 4096), (256, 11008, 4096),     # attn_out, mlp_out: K split
    (2048, 4096, 12288),                       # generate's prompt, qkv
    (200, 4096, 11008),                        # M not a tile multiple
    (16, 4096, 4096), (17, 4096, 4096)])       # decode / prefill boundary
def test_int8_matmul_kernel_matches_plain(cuda, shape, dtype):
    """K4 against its plain version in float32 on the same inputs; two
    launches give the same bits (the K splits are summed in order)."""
    rng = np.random.default_rng(6)
    M, K, N = shape
    x, q, scale = _int8_problem(rng, M, K, N, dtype, cuda)
    n0 = int8_matmul.int8_matmul.launches
    out = int8_matmul.int8_matmul(x, q, scale)
    again = int8_matmul.int8_matmul(x, q, scale)
    torch.cuda.synchronize()
    assert int8_matmul.int8_matmul.launches == n0 + 2
    assert out.dtype == dtype and out.shape == (M, N)
    assert torch.equal(out, again)
    ref = int8_matmul.int8_matmul_reference(x.float(), q, scale)
    diff = (out.float() - ref).abs()
    top = ref.abs().max().item()
    rel = (diff.amax(1) / ref.abs().amax(1)).max().item()
    assert diff.max().item() <= _tol(dtype) * max(1.0, top), (diff.max(), top)
    assert rel <= _tol(dtype), rel


def _int8_pool_problem(rng, device, **kw):
    """A float problem's q and lengths over int8 pools with random
    positive per-(block, head) scales."""
    q, kp, vp, tables, lengths = _pool_problem(rng, torch.float32, device,
                                               **kw)
    N, Hkv = kp.shape[0], kp.shape[2]
    codes = [torch.from_numpy(rng.integers(-127, 128, tuple(kp.shape))
                              .astype(np.int8)).to(device) for _ in range(2)]
    scales = [torch.from_numpy((0.5 + rng.random((N, Hkv))).astype(
        np.float32) / 127.0).to(device) for _ in range(2)]
    return q, codes, scales, tables, lengths


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(),
    dict(Hkv=4, group=1, Dh=64),
    dict(Hkv=2, group=4),                                # GQA
    dict(window=21),
    dict(q_len=4, group=4),                              # verify, R = 16
    dict(bs=4, NB=40, window=30),                        # several splits
    dict(lens="spread", NB=32, group=1),                 # lengths 0 .. full
    dict(lens="spread", NB=32, q_len=4, group=4, Dh=64),
    dict(NB=64, window=400, group=1),                    # window, 7 splits
])
def test_paged_kernel_int8_matches_plain(cuda, case, dtype):
    """K3's int8-pool mode against the gather-dequant plain version
    (float32 on the same inputs); it counts on its own counter."""
    rng = np.random.default_rng(7)
    case = dict(case)
    window = case.pop("window", None)
    q, (kp, vp), (ks, vs), tables, lengths = _int8_pool_problem(
        rng, cuda, **case)
    q = q.to(dtype)
    kw = dict(scale=q.shape[-1] ** -0.5, window=window, k_scale=ks,
              v_scale=vs)
    n0, f0 = paged.paged_attention.int8_launches, paged.paged_attention.launches
    if q.shape[1] == 1:
        out = paged.paged_decode_attention(q[:, 0], kp, vp, tables, lengths,
                                           **kw)
        ref = paged.paged_decode_reference(q[:, 0].float(), kp, vp, tables,
                                           lengths, **kw)
    else:
        out = paged.paged_verify_attention(q, kp, vp, tables, lengths, **kw)
        ref = paged.paged_verify_reference(q.float(), kp, vp, tables, lengths,
                                           **kw)
    torch.cuda.synchronize()
    assert paged.paged_attention.int8_launches == n0 + 1
    assert paged.paged_attention.launches == f0
    B = q.shape[0]
    diff = (out.float() - ref).abs().reshape(B, -1)
    rel = (diff.amax(1) / ref.abs().reshape(B, -1).amax(1)).max().item()
    assert diff.max().item() <= _tol(dtype) and rel <= _tol(dtype), rel


@pytest.mark.gpu
def test_paged_kernel_int8_ignores_stale_blocks(cuda):
    """int8 mode: codes of stale lanes are poisoned with extremes and the
    scales of whole table entries past each slot's length with NaN, which
    the kernel must never read."""
    rng = np.random.default_rng(8)
    q, (kp, vp), (ks, vs), tables, lengths = _int8_pool_problem(rng, cuda)
    kw = dict(scale=0.1, k_scale=ks, v_scale=vs)
    out = paged.paged_decode_attention(q[:, 0], kp, vp, tables, lengths, **kw)
    kp2, vp2, ks2, vs2 = kp.clone(), vp.clone(), ks.clone(), vs.clone()
    bs = kp.shape[1]
    for b in range(tables.shape[0]):
        last = int(lengths[b]) // bs
        for j in range(tables.shape[1]):
            blk = tables[b, j]
            if j > last:
                ks2[blk] = float("nan")
                vs2[blk] = float("nan")
            for s in range(bs):
                if j * bs + s > int(lengths[b]):
                    kp2[blk, s] = 127
                    vp2[blk, s] = -127
    out2 = paged.paged_decode_attention(q[:, 0], kp2, vp2, tables, lengths,
                                        scale=0.1, k_scale=ks2, v_scale=vs2)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)


@pytest.mark.gpu
def test_int8_serving_on_card_matches_host(cuda):
    """Weight-only int8 and int8 KV blocks on the card (K4, K3-int8)
    against the same float32 model on the host: static prefill logits
    within 1e-4 relative, and the greedy streams of generate and of an
    int8-KV ServingEngine drain identical."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.serving import (ServeRequest,
                                                       ServingEngine)
    from deepspeed_tpu_torch.models import gpt
    cfg = gpt.preset("llama-tiny", n_layers=2, d_model=512, n_heads=8,
                     n_kv_heads=2, attn_window=24, max_seq_len=128)
    params = gpt.init_params(cfg, seed=0, device="cpu")
    host = init_inference(model=(cfg, params), dtype=torch.int8, device="cpu")
    # the card's engine in float32 over the host's int8 tree
    card = init_inference(model=(cfg, host.params), dtype=torch.float32,
                          device="cuda")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (7, 30, 19)]
    batch = np.stack([p[:7] for p in prompts])
    lh, lc = (e._prefill_fn(torch.as_tensor(batch.astype(np.int64),
                                            device=e.device))[0]
              for e in (host, card))
    rel = ((lc.cpu() - lh).abs().max() / lh.abs().max()).item()
    assert rel <= 1e-4, rel
    k4 = int8_matmul.int8_matmul.launches
    outs = []
    for e in (host, card):
        gen = e.generate(batch, max_new_tokens=10)
        srv = ServingEngine(e, num_slots=2, block_size=16, num_blocks=8,
                            prefill_chunk=16, kv_quant="int8")
        served = srv.run([ServeRequest(rid=i, prompt=p, max_new_tokens=24)
                          for i, p in enumerate(prompts)])
        outs.append((gen, served))
    assert int8_matmul.int8_matmul.launches > k4
    (g_h, s_h), (g_c, s_c) = outs
    np.testing.assert_array_equal(g_c, g_h)
    for rid in s_h:
        np.testing.assert_array_equal(s_c[rid], s_h[rid])


# layouts of the block-sparse cases: (config class, its keyword arguments)
SPARSE_LAYOUTS = {
    "fixed": (sa.FixedSparsityConfig, dict(num_local_blocks=4)),
    "fixed-uni": (sa.FixedSparsityConfig, dict(num_local_blocks=4,
                                               attention="unidirectional")),
    "bigbird": (sa.BigBirdSparsityConfig, dict(num_random_blocks=2)),
    "bslongformer": (sa.BSLongformerSparsityConfig,
                     dict(global_block_indices=[0, 5])),
    "variable": (sa.VariableSparsityConfig, dict(
        num_random_blocks=1, local_window_blocks=[2, 4],
        global_block_indices=[1], attention="unidirectional",
        different_layout_per_head=True)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", [
    dict(layout="fixed", B=2, S=512, H=4, D=64, block=16),
    dict(layout="fixed-uni", B=2, S=512, H=4, D=64, block=16),
    dict(layout="bigbird", B=1, S=512, H=2, D=128, block=32),
    dict(layout="bslongformer", B=2, S=512, H=2, D=32, block=64),
    dict(layout="variable", B=1, S=1024, H=2, D=64, block=128),
    dict(layout="fixed", B=1, S=256, H=3, D=40, block=16),
], ids=lambda c: "-".join(f"{v}" for v in c.values()))
def test_blocksparse_kernel_matches_plain(cuda, case, dtype):
    """K5 against the gather version in float32 on the same inputs, by the
    largest error and per query row relative to the row's own scale; two
    launches give the same bits."""
    _blocksparse_case(case, dtype, cuda)


def _blocksparse_case(case, dtype, device):
    rng = np.random.default_rng(6)
    cls, kw = SPARSE_LAYOUTS[case["layout"]]
    B, S, H, D, block = (case[k] for k in ("B", "S", "H", "D", "block"))
    config = cls(num_heads=H, block=block, **kw)
    causal = getattr(config, "attention", "") == "unidirectional"
    layout = config.make_layout(S)
    lut, valid = sa.make_lut(layout)
    q, k, v = (_randn(rng, (B, S, H, D), dtype, device) for _ in range(3))
    n0 = sa.blocksparse_attention_kernel.launches
    o = sa.blocksparse_attention(q, k, v, layout, causal=causal,
                                 lut_valid=(lut, valid))
    again = sa.blocksparse_attention(q, k, v, layout, causal=causal,
                                     lut_valid=(lut, valid))
    torch.cuda.synchronize()
    assert sa.blocksparse_attention_kernel.launches == n0 + 2
    assert torch.equal(o, again)
    ref = sa.blocksparse_attention_gather(q.float(), k.float(), v.float(),
                                          lut, valid, block, causal=causal)
    diff = (o.float() - ref).abs()
    err = diff.max().item()
    rel = (diff.amax(-1) / ref.abs().amax(-1).clamp_min(1e-6)).max().item()
    assert err <= _tol(dtype) and rel <= _tol(dtype), (err, rel)
    return sa.blocksparse.block_table(lut, valid).plan(block)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", [
    # the union walk at the sparse path's shape (one union of 67 blocks per
    # 64-row group)
    dict(layout="fixed", B=1, S=4096, H=2, D=64, block=16),
    dict(layout="fixed-uni", B=1, S=4096, H=2, D=64, block=16),
    # global rows: their unions are split over CTAs and combined
    dict(layout="bigbird", B=2, S=2048, H=2, D=64, block=16, split=True),
    dict(layout="bslongformer", B=2, S=2048, H=2, D=64, block=16,
         split=True),
    dict(layout="bigbird", B=1, S=2048, H=2, D=128, block=32, split=True),
    # head dims padded to a multiple of 16
    dict(layout="fixed", B=2, S=512, H=2, D=40, block=16),
    dict(layout="fixed-uni", B=2, S=512, H=2, D=8, block=32),
    # a 64-row group is half of a 128-row block
    dict(layout="variable", B=1, S=1024, H=2, D=64, block=128),
    dict(layout="fixed", B=1, S=1024, H=2, D=128, block=128),
], ids=lambda c: "-".join(f"{v}" for v in c.values()))
def test_blocksparse_mma_kernel_matches_plain(cuda, case, dtype):
    """The tensor-core K5 (the union walk over 64-row groups, long unions
    split and combined, padded head dims) against the gather version in
    float32, at the bf16/fp16 tolerance; two launches give the same bits,
    split groups included."""
    assert sa.blocksparse.DESIGN[dtype] == "mma"
    plan = _blocksparse_case(case, dtype, cuda)
    assert (plan.split_groups > 0) == case.get("split", False)


@pytest.mark.gpu
def test_blocksparse_kernel_fully_masked_rows_are_zero(cuda):
    """A causal layout whose first query block sees only a block above the
    diagonal: the kernel writes exact zeros there, in bf16 and fp16."""
    nb, block, D = 4, 32, 64
    layout = np.zeros((1, nb, nb), np.int64)
    layout[0, 0, 2] = 1
    layout[0, 1:, 0] = 1
    np.fill_diagonal(layout[0][1:, 1:], 1)
    for dtype in (torch.bfloat16, torch.float16):
        rng = np.random.default_rng(7)
        q, k, v = (_randn(rng, (1, nb * block, 1, D), dtype, cuda)
                   for _ in range(3))
        o = sa.blocksparse_attention(q, k, v, layout, causal=True)
        torch.cuda.synchronize()
        assert torch.isfinite(o).all() and \
            o[0, :block].abs().max().item() == 0
        ref = sa.blocksparse_attention_gather(
            q.float(), k.float(), v.float(), *sa.make_lut(layout), block,
            causal=True)
        assert (o.float() - ref).abs().max().item() <= 2e-2


@pytest.mark.gpu
def test_blocksparse_autograd_on_card_matches_host(cuda):
    """``SparseSelfAttention`` differentiated on the card (K5 forward, the
    gather backward) against the host, float32; with a key-padding mask
    the card takes the gather version, as the routing rule says."""
    rng = np.random.default_rng(8)
    B, S, H, D = 2, 256, 4, 64
    mod = sa.SparseSelfAttention(sa.FixedSparsityConfig(
        num_heads=H, block=16, attention="unidirectional"),
        max_seq_length=S)
    host = [torch.from_numpy(rng.standard_normal((B, S, H, D), np.float32))
            .requires_grad_() for _ in range(3)]
    card = [t.detach().to(cuda).requires_grad_() for t in host]
    w = torch.from_numpy(rng.standard_normal((B, S, H, D), np.float32))
    kp = torch.from_numpy((rng.random((B, S)) > 0.2).astype(np.float32))
    mod_mul = sa.SparseSelfAttention(mod.sparsity_config,
                                     key_padding_mask_mode="mul",
                                     max_seq_length=S)
    for m, mask in ((mod, None), (mod_mul, kp)):
        grads = []
        n0 = sa.blocksparse_attention_kernel.launches
        for (q, k, v), dev in ((host, "cpu"), (card, cuda)):
            o = m(q, k, v, key_padding_mask=None if mask is None
                  else mask.to(dev))
            grads.append(torch.autograd.grad((o * w.to(dev)).sum(),
                                             (q, k, v)))
        assert sa.blocksparse_attention_kernel.launches == \
            n0 + (1 if mask is None else 0)
        for gh, gc in zip(*grads):
            rel = ((gc.cpu() - gh).abs().max() / gh.abs().max()).item()
            assert rel <= 1e-4, rel


@pytest.mark.gpu
def test_bert_on_card_matches_host(cuda):
    """Two bert-large-width layers in float32 at S = 256 with padded tails
    (the flash kernels, non-causal with a key mask, on the card; their
    plain versions on the host): the MLM+NSP loss and every gradient
    leaf."""
    from deepspeed_tpu_torch import tree
    from deepspeed_tpu_torch.models import bert
    cfg = bert.preset("bert-large", n_layers=2, vocab_size=1000,
                      max_seq_len=256, dropout=0.0, dtype=torch.float32)
    host = bert.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(9)
    B, S = 2, 256
    tokens = rng.integers(1, 1000, (B, S))
    mask = np.ones((B, S), np.int64)
    mask[1, 200:] = 0
    batch = {"tokens": tokens, "attention_mask": mask,
             "mlm_labels": np.where((rng.random((B, S)) < 0.15) & (mask > 0),
                                    tokens, -1),
             "nsp_labels": np.array([0, 1])}
    out = []
    n0 = flash.flash_attention.launches
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_()
                  for t in tree.tree_leaves(host)]
        params = tree.tree_unflatten(host, leaves)
        loss = bert.loss_fn(params, {k: torch.as_tensor(v).to(dev)
                                     for k, v in batch.items()}, None, cfg)
        out.append((loss.item(), [g.cpu() for g in
                                  torch.autograd.grad(loss, leaves)]))
    assert flash.flash_attention.launches == n0 + 2
    (lh, gh), (lc, gc) = out
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    for a, b in zip(gc, gh):
        rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        assert rel <= 1e-3, rel


# ---------------------------------------------------------------------------
# the training engine's features on the card: resume, walk-back, the
# prefetching loader, a curriculum length off the tile grid
# ---------------------------------------------------------------------------

def _gpt2_width_engine(device, seed, config, **train):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt
    train.setdefault("max_seq_len", 512)
    cfg = gpt.preset("gpt2-1.5b", n_layers=2, vocab_size=1024, **train)
    # drawn on the host, so that the card's and the host's engines of one
    # seed start from the same weights
    params = gpt.init_params(cfg, seed=seed, device="cpu", dtype=cfg.dtype)
    return deepspeed_tpu_torch.initialize(
        model=gpt.make_loss_fn(cfg), model_parameters=params, device=device,
        config={"train_batch_size": 4, "steps_per_print": 1000,
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
                **config})[0]


_MEM_EFF = {"bf16": {"enabled": True, "memory_efficient": True}}


@pytest.mark.gpu
def test_resume_on_card_is_bit_identical(cuda, tmp_path):
    """gpt2-1.5b width at 2 layers in bf16 with bf16 masters and moments
    (the tensor-core kernels, stochastic rounding from the card's
    generator): four steps against two, a save, a fresh engine from other
    weights, the load and two more; losses, parameters, moments and the
    generator's state equal bit for bit."""
    from deepspeed_tpu_torch import tree
    rng = np.random.default_rng(1)
    batches = [{"tokens": rng.integers(1, 1024, (4, 257))} for _ in range(4)]
    kw = dict(remat=True, remat_policy="full", dtype=torch.bfloat16)
    whole = _gpt2_width_engine(cuda, 0, _MEM_EFF, **kw)
    want = [float(whole.train_batch(b)["loss"]) for b in batches]
    first = _gpt2_width_engine(cuda, 0, _MEM_EFF, **kw)
    got = [float(first.train_batch(b)["loss"]) for b in batches[:2]]
    first.save_checkpoint(str(tmp_path))
    resumed = _gpt2_width_engine(cuda, 1, _MEM_EFF, **kw)
    n0 = flash.flash_attention.bwd_dq_launches
    resumed.load_checkpoint(str(tmp_path), strict=True)
    got += [float(resumed.train_batch(b)["loss"]) for b in batches[2:]]
    assert flash.flash_attention.bwd_dq_launches == n0 + 2 * 2
    assert got == want
    for key in ("params", "mu", "nu"):
        trees = [e.params if key == "params" else e.opt_state[key]
                 for e in (resumed, whole)]
        for a, b in zip(*map(tree.tree_leaves, trees)):
            assert a.device.type == "cuda" and torch.equal(a, b), key
    assert torch.equal(resumed.rng.get_state(), whole.rng.get_state())


@pytest.mark.gpu
def test_corrupt_latest_walks_back_on_card(cuda, tmp_path):
    from deepspeed_tpu_torch import tree
    from deepspeed_tpu_torch.runtime.checkpointing import CheckpointError
    rng = np.random.default_rng(2)
    eng = _gpt2_width_engine(cuda, 0, {}, dtype=torch.float32)
    eng.train_batch({"tokens": rng.integers(1, 1024, (4, 65))})
    eng.save_checkpoint(str(tmp_path), tag="good")
    saved = [t.clone() for t in tree.tree_leaves(eng.params)]
    eng.train_batch({"tokens": rng.integers(1, 1024, (4, 65))})
    eng.save_checkpoint(str(tmp_path), tag="bad")
    with open(tmp_path / "bad" / "state" / "optimizer.pt", "r+b") as f:
        f.seek(200)
        f.write(b"\x00\x01\x02")
    fresh = _gpt2_width_engine(cuda, 3, {}, dtype=torch.float32)
    path, _ = fresh.load_checkpoint(str(tmp_path))
    assert path.endswith("good") and fresh.global_steps == 1
    for a, b in zip(tree.tree_leaves(fresh.params), saved):
        assert torch.equal(a, b)
    with pytest.raises(CheckpointError, match="manifest"):
        fresh.load_checkpoint(str(tmp_path), tag="bad", strict=True)


@pytest.mark.gpu
def test_prefetch_loader_places_the_batches_of_direct_placement(cuda):
    """PrefetchLoader copies each batch on a side stream from pinned
    memory; the consuming stream sees exactly what direct placement
    gives, at depths 1 and 2."""
    from deepspeed_tpu_torch.runtime import dataloader
    rng = np.random.default_rng(3)
    data = [{"tokens": rng.integers(0, 1000, 300).astype(np.int32),
             "mask": rng.random(300).astype(np.float32)} for _ in range(24)]
    eng = type("E", (), {"device": cuda})()
    direct = [{k: torch.as_tensor(v).to(cuda) for k, v in b.items()}
              for b in dataloader.DeepSpeedDataLoader(data, 4, seed=1)]
    for depth in (1, 2):
        got = list(dataloader.PrefetchLoader(
            dataloader.DeepSpeedDataLoader(data, 4, seed=1), eng,
            depth=depth))
        assert len(got) == len(direct) == 6
        for a, b in zip(got, direct):
            for k in b:
                assert a[k].device == b[k].device and torch.equal(a[k], b[k])


@pytest.mark.gpu
def test_curriculum_step_at_520_matches_host(cuda):
    """A seqlen-curriculum step at S = 520 (off the kernels' 64 tiles; the
    batch a truncated, strided view) through K1-fwd, K2-dq and K2-dkv on
    the card against the plain versions on the host: gpt2-1.5b width, 2
    layers, float32, the loss and the parameters after the step."""
    from deepspeed_tpu_torch import tree
    config = {"curriculum_learning": {
        "enabled": True, "curriculum_type": "seqlen", "min_difficulty": 520,
        "max_difficulty": 1024, "schedule_type": "fixed_discrete",
        "schedule_config": {"difficulty": [520, 1024], "max_step": [5]}},
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "eps": 1e-3}}}
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, 1024, (4, 1024)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}
    out = []
    n0 = [flash.flash_attention.launches, flash.flash_attention.bwd_dq_launches]
    for dev in ("cpu", cuda):
        eng = _gpt2_width_engine(dev, 5, config, dtype=torch.float32,
                                 max_seq_len=1024)
        loss = float(eng.train_batch(batch)["loss"])
        assert eng.curriculum_scheduler.get_current_difficulty() == 520
        out.append((loss, [t.cpu() for t in tree.tree_leaves(eng.params)]))
    assert [flash.flash_attention.launches,
            flash.flash_attention.bwd_dq_launches] == [n0[0] + 2, n0[1] + 2]
    (lh, ph), (lc, pc) = out
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    prel = max(((c - h).abs().max() / h.abs().max()).item()
               for h, c in zip(ph, pc))
    assert prel <= 1e-4, prel

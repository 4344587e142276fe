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

from deepspeed_tpu_torch import tree as ttree
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
    # the other built head dims: llama-tiny's 32, gpt2-4b's 72, gpt2-8b's
    # 96 (72 in an 80-wide tile on the tensor cores, 96 on the CUDA cores)
    dict(B=2, S=100, H=8, Hkv=4, D=32, segs=True),       # GQA, segments
    dict(B=2, S=150, H=4, Hkv=2, D=72, window=33),       # GQA, window
    dict(B=3, S=64, H=2, Hkv=1, D=72, pad=True),         # kv_mask
    dict(B=4, S=256, H=4, Hkv=4, D=96, causal=False, tail=True),
    dict(B=2, S=130, H=8, Hkv=2, D=96, segs=True),
    # head dims between the built widths, in the next width's run-time
    # head dim build (100 and 20 padded by the wrapper to 104 and 24)
    dict(B=2, S=90, H=4, Hkv=2, D=40),
    dict(B=2, S=70, H=2, Hkv=2, D=100, window=30),
    dict(B=1, S=66, H=2, Hkv=2, D=20, causal=False),     # not a multiple of 8
    dict(B=2, S=130, H=8, Hkv=2, D=88, segs=True),
    dict(B=3, S=64, H=2, Hkv=1, D=56, pad=True),         # kv_mask
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
    # the other built head dims (see test_flash_kernel_matches_plain)
    dict(B=2, S=100, H=8, Hkv=4, D=32, segs=True),
    dict(B=1, S=200, H=4, Hkv=1, D=72, window=33),       # MQA, window
    dict(B=3, S=96, H=4, Hkv=2, D=72, pad=True),         # GQA, kv_mask
    dict(B=4, S=256, H=4, Hkv=4, D=96, causal=False, tail=True),
    dict(B=2, S=130, H=8, Hkv=2, D=96, segs=True, window=40),
    dict(B=2, S=90, H=4, Hkv=2, D=40),                   # run-time, in 64
    dict(B=1, S=70, H=2, Hkv=2, D=20, causal=False),     # 24, in 32
    dict(B=2, S=130, H=8, Hkv=2, D=80, segs=True, window=40),   # in 96
    dict(B=3, S=96, H=4, Hkv=2, D=120, pad=True),        # in 128
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
# 32 or 64 keys by head dim (`fwd_kt`, `dq_kt`: K1-fwd 64 at 32, 72, 96
# and 128, 32 at 64; K2-dq 32 but at 128); K2-dkv takes 64-key tiles of 4
# warps x 16 keys and walks q tiles of 32 rows at every head dim
# (`DKV_QT`). Head dim 72 runs in an 80-wide tile.
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
    # head dims 32, 72 and 96: the zero-filled columns of 72's tile, the
    # masks and GQA at each, and their fused views
    dict(B=2, S=65, H=2, Hkv=2, D=32),
    dict(B=1, S=192, H=8, Hkv=4, D=32, seg_at=64),      # llama-tiny's GQA
    dict(B=2, S=33, H=2, Hkv=1, D=72),
    dict(B=2, S=300, H=4, Hkv=2, D=72, window=129),
    dict(B=2, S=256, H=2, Hkv=2, D=72, causal=False, blank=(64, 128)),
    dict(B=2, S=160, H=2, Hkv=2, D=72, seg_at=63),
    dict(B=2, S=200, H=2, Hkv=2, D=96, pad=100),
    dict(B=2, S=160, H=8, Hkv=2, D=96, seg_at=65, causal=False),
    dict(B=1, S=1000, H=2, Hkv=2, D=96, window=129),
    dict(B=2, S=130, H=4, Hkv=4, D=72, fused=True),
    dict(B=2, S=130, H=8, Hkv=2, D=96, fused=True),
    dict(B=2, S=130, H=4, Hkv=4, D=32, fused=True),
    # the run-time head dim builds: 48 in 64, 88 in 96, 112 in 128
    dict(B=2, S=33, H=2, Hkv=1, D=48),
    dict(B=2, S=300, H=4, Hkv=2, D=88, window=129),
    dict(B=2, S=160, H=2, Hkv=2, D=112, seg_at=63),
    dict(B=2, S=130, H=8, Hkv=2, D=88, fused=True),
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
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
    dict(B=8, Hkv=32, group=1, q_len=5, NB=8,            # llama-7b verify
         lens=[0, 5, 16, 40, 64, 90, 110, 123]),
    # the tensor-core verify tier (bf16, fp16): R = 40 in one CTA at head
    # dim 64 (four m16 tiles) and in two passes of 32 rows at 128
    dict(q_len=5, group=8, Dh=64, NB=8),
    dict(q_len=5, group=8, NB=8, window=50),
    dict(q_len=5, group=1, window=7, lens="spread", NB=16),
    dict(q_len=5, group=2, Dh=64, bs=8, NB=12, window=12),
    dict(q_len=5, group=6, NB=8),                        # R = 30: 2 tiles
    dict(q_len=3, group=1, lens=[0, 1, 7, 13]),          # one unit each
    # the other built head dims, decode and verify: 72 in a ring row of
    # 96 (CUDA cores) or 80 (tensor cores), 96 and 32
    dict(Dh=72, group=1),
    dict(Dh=96, window=21),
    dict(Dh=32, Hkv=4, group=2, lens="spread", NB=32),
    dict(Dh=72, q_len=5, group=2, NB=8, window=50),
    dict(Dh=96, q_len=5, group=8, NB=8),                 # R = 40: 2 passes
    dict(Dh=32, q_len=5, group=8, NB=8),                 # R = 40: 4 tiles
    dict(Dh=72, q_len=4, group=4, lens="spread", NB=16),
    # head dims between the built widths, in the next width's run-time
    # head dim build (100 padded by the wrapper to 104, pools too)
    dict(Dh=40, group=2),
    dict(Dh=100, q_len=3, group=2),
    dict(Dh=88, window=21),
    dict(Dh=80, q_len=5, group=8, NB=8),                 # R = 40: 2 passes
    dict(Dh=24, Hkv=4, group=2, lens="spread", NB=32),
    dict(Dh=48, q_len=4, group=4, lens="spread", NB=16),
])
def test_paged_kernel_matches_plain(cuda, case, dtype):
    """K3 in its decode and verify modes; each mode counts on its own
    counter."""
    rng = np.random.default_rng(1)
    case = dict(case)
    window = case.pop("window", None)
    q, kp, vp, tables, lengths = _pool_problem(rng, dtype, cuda, **case)
    scale = q.shape[-1] ** -0.5
    counter = "launches" if q.shape[1] == 1 else "verify_launches"
    n0 = getattr(paged.paged_attention, counter)
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
    assert getattr(paged.paged_attention, counter) == n0 + 1
    B = q.shape[0]
    diff = (out.float() - ref).abs().reshape(B, -1)
    err = diff.max().item()
    rel = (diff.amax(1) / ref.abs().reshape(B, -1).amax(1)).max().item()
    assert err <= _tol(dtype) and rel <= _tol(dtype), (err, rel)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    dict(q_len=2, group=2, lens=[5, 300, 700, 1022]),
    dict(q_len=5, group=8, Dh=64, lens=[5, 300, 700, 1018])])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_kernel_two_launches_same_bits(cuda, int8, shape):
    """Slots whose work takes several of the plan's splits (lengths up to
    a full table of 1024 positions) are merged in split order: two
    launches of the tensor-core verify tier give the same bits, in both
    pool modes, at 4 rows and at 40 (four m16 tiles)."""
    rng = np.random.default_rng(9)
    kw = dict(NB=64, **shape)
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
@pytest.mark.parametrize("q_len", [1, 5])
def test_paged_kernel_float16_over_int8_pools(cuda, q_len):
    """A float16 q over int8 pools runs the int8 mode (decode on the CUDA
    cores, verify on the tensor cores with the codes exact in fp16),
    counted as the bf16 q's int8 launches, against the plain version in
    float32 at the float16 tolerance; two launches give the same bits."""
    rng = np.random.default_rng(4)
    q, (kp, vp), (ks, vs), tables, lengths = _int8_pool_problem(
        rng, cuda, q_len=q_len, NB=64, lens=[5, 300, 700, 1018])
    q = q.to(torch.float16)
    kw = dict(scale=0.1, k_scale=ks, v_scale=vs)
    counter = "int8_launches" if q_len == 1 else "int8_verify_launches"
    n0 = getattr(paged.paged_attention, counter)
    outs = [paged.paged_verify_attention(q, kp, vp, tables, lengths, **kw)
            if q_len > 1 else paged.paged_decode_attention(
                q[:, 0], kp, vp, tables, lengths, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert getattr(paged.paged_attention, counter) == n0 + 2
    assert torch.equal(outs[0], outs[1]) and outs[0].dtype == torch.float16
    ref = paged.paged_verify_reference(q.float(), kp, vp, tables, lengths,
                                       **kw)
    if q_len == 1:
        ref = ref[:, 0]
    diff = (outs[0].float() - ref).abs().reshape(4, -1)
    rel = (diff.amax(1) / ref.abs().reshape(4, -1).amax(1)).max().item()
    assert diff.max().item() <= 2e-2 and rel <= 2e-2, rel


@pytest.mark.gpu
@pytest.mark.parametrize("Dh", [40, 88])
def test_runtime_head_dims_read_the_pools_in_place(cuda, Dh):
    """A head dim between the built widths runs in the next width's
    run-time head dim build on the pools as they are: the call allocates
    no padded copy of them (its peak stays below one pool's bytes), and
    its output is the plain version's."""
    from deepspeed_tpu_torch.ops import _build
    rng = np.random.default_rng(Dh)
    q, kp, vp, tables, lengths = _pool_problem(
        rng, torch.bfloat16, cuda, Hkv=8, group=2, Dh=Dh, NB=64)
    scale = Dh ** -0.5
    paged.paged_decode_attention(q[:, 0], kp, vp, tables, lengths,
                                 scale=scale)    # built and loaded
    torch.cuda.synchronize()
    assert ("paged_decode", _build.head_dim_width(Dh), True) \
        in _build._loaded
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = paged.paged_decode_attention(q[:, 0], kp, vp, tables, lengths,
                                       scale=scale)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - base
    assert grew < kp.numel() * kp.element_size(), grew
    ref = paged.paged_decode_reference(q[:, 0].float(), kp.float(),
                                       vp.float(), tables, lengths,
                                       scale=scale)
    assert (out.float() - ref).abs().max().item() <= _tol(torch.bfloat16)


@pytest.mark.gpu
def test_kernels_refuse_head_dims_above_128(cuda):
    """Head dims above 128 have no build: the flash and paged wrappers
    raise, naming the limit, instead of launching."""
    rng = np.random.default_rng(2)
    q = _randn(rng, (1, 64, 2, 136), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="up to 128"):
        flash.flash_attention(q, q, q)
    q, kp, vp, tables, lengths = _pool_problem(rng, torch.bfloat16, cuda,
                                               Dh=136)
    with pytest.raises(ValueError, match="up to 128"):
        paged.paged_decode_attention(q[:, 0], kp, vp, tables, lengths,
                                     scale=0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_generate_fused_replays_generate_on_card(cuda, dtype):
    """``generate_fused`` captures the decode loop once into a CUDA graph
    and replays it: greedy and sampled, left-padded or not, its tokens are
    ``generate``'s bit for bit (the same launches replay), in bf16 and in
    the int8 engine (K4 inside the graph); a second call of a key replays
    without a new capture and counts no launch."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models import gpt
    cfg = gpt.preset("llama-tiny", n_layers=2, d_model=512, n_heads=8,
                     n_kv_heads=2, max_seq_len=96)
    params = gpt.init_params(cfg, seed=0, device="cpu")
    eng = init_inference(model=(cfg, params), dtype=dtype, device="cuda")
    rng = np.random.default_rng(6)
    tok = rng.integers(1, cfg.vocab_size, (3, 20)).astype(np.int32)
    mask = (np.arange(20)[None] >= np.array([0, 4, 9])[:, None]).astype(
        np.float32)
    for kw in (dict(), dict(attention_mask=mask),
               dict(temperature=0.8, top_k=20, seed=1)):
        want = eng.generate(tok, max_new_tokens=24, **kw)
        got = eng.generate_fused(tok, max_new_tokens=24, **kw)
        np.testing.assert_array_equal(got, want)
        k4 = int8_matmul.int8_matmul.launches
        again = eng.generate_fused(tok, max_new_tokens=24, **kw)
        np.testing.assert_array_equal(again, want)
        # the prefill's launches only: the replay is not counted
        assert int8_matmul.int8_matmul.launches - k4 == \
            (5 * cfg.n_layers if dtype == torch.int8 else 0)
    assert len(eng._fused) == 3
    assert all(st["graph"] is not None for st in eng._fused.values())
    assert {"decode_per_token", "decode_per_token_fused",
            "fused_generate_compile"} <= set(eng.latency_ms)


@pytest.mark.gpu
def test_float16_engine_on_card_matches_host(cuda):
    """init_inference(dtype=torch.float16) on the card (K1-fwd in
    generate's prefill, K3-fp16 in every decode step) against the same
    float16 model on the host: the prefill logits within 5e-3 of their
    scale, and a served drain launches K3's float16 mode every step."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.serving import (ServeRequest,
                                                       ServingEngine)
    from deepspeed_tpu_torch.models import gpt
    cfg = gpt.preset("llama-tiny", n_layers=2, d_model=512, n_heads=8,
                     n_kv_heads=2, max_seq_len=128)
    params = gpt.init_params(cfg, seed=0, device="cpu")
    engines = [init_inference(model=(cfg, params), dtype=torch.float16,
                              device=d) for d in ("cpu", "cuda")]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 30, 17)]
    batch = np.stack([p[:9] for p in prompts])
    host, card = (e._prefill_fn(torch.as_tensor(batch.astype(np.int64),
                                                device=e.device))[0]
                  for e in engines)
    rel = ((card.float().cpu() - host.float()).abs().max()
           / host.float().abs().max()).item()
    assert rel <= 5e-3, rel
    n0 = paged.paged_attention.launches
    srv = ServingEngine(engines[1], num_slots=2, block_size=16,
                        num_blocks=12, prefill_chunk=16)
    out = srv.run([ServeRequest(rid=i, prompt=p, max_new_tokens=12)
                   for i, p in enumerate(prompts)])
    assert sorted(out) == [0, 1, 2] and srv.cache.k.dtype == torch.float16
    assert paged.paged_attention.launches - n0 == \
        cfg.n_layers * srv.stats["decode_steps"] > 0


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


@pytest.mark.gpu
@pytest.mark.parametrize("preset,kw", [
    ("llama-tiny", {}),                                  # 32, GQA group 2
    ("gpt2-small", dict(n_layers=2, d_model=144, n_heads=2)),   # 72
    ("gpt2-small", dict(n_layers=2, d_model=192, n_heads=2)),   # 96
])
def test_head_dims_on_card_match_host(cuda, preset, kw):
    """The presets' head dims 32 (llama-tiny as it ships), 72 (gpt2-4b's)
    and 96 (gpt2-8b's) through the whole port in float32, card against
    host: the prefill logits within 1e-4 relative, the greedy streams of
    ``generate`` and of a speculative ServingEngine drain in both pool
    modes identical (K1-fwd, K3 decode and verify counted), and a
    training step's loss within 1e-5 relative and every gradient leaf
    within 1e-3 of its scale (K2-dq and K2-dkv counted)."""
    from deepspeed_tpu_torch import init_inference, tree
    from deepspeed_tpu_torch.inference.serving import (ServeRequest,
                                                       ServingEngine)
    from deepspeed_tpu_torch.models import gpt
    cfg = gpt.preset(preset, vocab_size=512, max_seq_len=256,
                     dtype=torch.float32, **kw)
    assert cfg.head_dim in (32, 72, 96)
    params = gpt.init_params(cfg, seed=0, device="cpu")
    engines = [init_inference(model=(cfg, params), dtype=torch.float32,
                              device=d) for d in ("cpu", "cuda")]
    rng = np.random.default_rng(3)
    # repeated spans, so that the n-gram drafter proposes and verifies run
    prompts = [np.tile(rng.integers(1, 512, 9), 16)[:n].astype(np.int32)
               for n in (140, 30, 19)]
    batch = np.stack([p[:130] for p in prompts[:1]] * 2)
    host, card = (e._prefill_fn(torch.as_tensor(batch.astype(np.int64),
                                                device=e.device))[0]
                  for e in engines)
    rel = ((card.cpu() - host).abs().max() / host.abs().max()).item()
    assert rel <= 1e-4, rel
    counts = (flash.flash_attention.launches, paged.paged_attention.launches,
              paged.paged_attention.verify_launches,
              paged.paged_attention.int8_launches,
              paged.paged_attention.int8_verify_launches)
    outs = []
    for e in engines:
        gen = e.generate(batch, max_new_tokens=8)
        served = []
        for kv_quant in ("off", "int8"):
            for spec in (False, True):
                srv = ServingEngine(e, num_slots=2, block_size=16,
                                    num_blocks=24, prefill_chunk=64,
                                    kv_quant=kv_quant, spec_decode=spec,
                                    spec_k=3)
                served.append(srv.run([ServeRequest(
                    rid=i, prompt=p, max_new_tokens=12)
                    for i, p in enumerate(prompts)]))
        outs.append((gen, served))
    after = (flash.flash_attention.launches, paged.paged_attention.launches,
             paged.paged_attention.verify_launches,
             paged.paged_attention.int8_launches,
             paged.paged_attention.int8_verify_launches)
    assert all(a > b for a, b in zip(after, counts)), (counts, after)
    (g_h, s_h), (g_c, s_c) = outs
    np.testing.assert_array_equal(g_c, g_h)
    for dh, dc in zip(s_h, s_c):
        for rid in dh:
            np.testing.assert_array_equal(dc[rid], dh[rid])

    tcfg = gpt.preset(preset, vocab_size=512, max_seq_len=256,
                      dtype=torch.float32, remat=True, remat_policy="full",
                      **kw)
    tokens = torch.from_numpy(rng.integers(1, 512, (2, 193)))
    n_dq = flash.flash_attention.bwd_dq_launches
    got = []
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_()
                  for t in tree.tree_leaves(params)]
        p = tree.tree_unflatten(params, leaves)
        loss = gpt.make_loss_fn(tcfg)(p, {"tokens": tokens.to(dev)}, None)
        got.append((loss.item(), [g.cpu() for g in
                                  torch.autograd.grad(loss, leaves)]))
    assert flash.flash_attention.bwd_dq_launches == n_dq + tcfg.n_layers
    (lh, gh), (lc, gc) = got
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    for a, b in zip(gc, gh):
        rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        assert rel <= 1e-3, rel


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
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
    dict(B=8, Hkv=32, group=1, q_len=5, NB=8,            # llama-7b verify
         lens=[0, 5, 16, 40, 64, 90, 110, 123]),
    # the tensor-core verify tier with a bf16 q (see the float cases)
    dict(q_len=5, group=8, Dh=64, NB=8),
    dict(q_len=5, group=8, NB=8, window=50),
    dict(q_len=5, group=1, window=7, lens="spread", NB=16),
    dict(q_len=5, group=2, Dh=64, bs=8, NB=12, window=12),
    dict(q_len=3, group=1, lens=[0, 1, 7, 13]),          # one unit each
    # the other built head dims: 72's int8 rows (72 bytes) copied in 8-byte
    # pieces into a ring row of 96, decode and verify
    dict(Dh=72, group=1),
    dict(Dh=72, q_len=5, group=2, NB=8, window=50),
    dict(Dh=72, lens="spread", NB=32, q_len=4, group=4),
    dict(Dh=96, window=21),
    dict(Dh=96, q_len=4, group=4),
    dict(Dh=32, Hkv=4, group=2),
    dict(Dh=32, q_len=5, group=8, NB=8),                 # R = 40: 4 tiles
    dict(Dh=40, q_len=2, group=2),                       # run-time, in 64
    dict(Dh=88, window=21),                              # run-time, in 96
    dict(Dh=104, q_len=5, group=2, NB=8),                # run-time, in 128
    dict(Dh=24, q_len=4, group=4),                       # run-time, in 32
])
def test_paged_kernel_int8_matches_plain(cuda, case, dtype):
    """K3's int8-pool mode against the gather-dequant plain version
    (float32 on the same inputs), with a float32, bfloat16 or float16 q;
    each of its decode and verify modes counts on its own counter."""
    rng = np.random.default_rng(7)
    case = dict(case)
    window = case.pop("window", None)
    q, (kp, vp), (ks, vs), tables, lengths = _int8_pool_problem(
        rng, cuda, **case)
    q = q.to(dtype)
    kw = dict(scale=q.shape[-1] ** -0.5, window=window, k_scale=ks,
              v_scale=vs)
    counter = "int8_launches" if q.shape[1] == 1 else "int8_verify_launches"
    n0, f0 = (getattr(paged.paged_attention, counter),
              paged.paged_attention.launches)
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
    assert getattr(paged.paged_attention, counter) == n0 + 1
    assert paged.paged_attention.launches == f0
    B = q.shape[0]
    diff = (out.float() - ref).abs().reshape(B, -1)
    rel = (diff.amax(1) / ref.abs().reshape(B, -1).amax(1)).max().item()
    assert diff.max().item() <= _tol(dtype) and rel <= _tol(dtype), rel


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
def test_paged_verify_mma_ignores_stale_blocks(cuda, int8):
    """The tensor-core verify tier (bf16 q, q_len 5, GQA) never reads past
    each slot's last verified position: poisoned lanes of its last block
    (extremes) and whole table entries past it (NaN, or NaN scales over
    int8 pools) leave the output's bits as they were."""
    rng = np.random.default_rng(12)
    kw = dict(q_len=5, group=2, lens=[3, 20, 40, 90])
    if int8:
        q, (kp, vp), (ks, vs), tables, lengths = _int8_pool_problem(
            rng, cuda, **kw)
    else:
        q, kp, vp, tables, lengths = _pool_problem(rng, torch.bfloat16,
                                                   cuda, **kw)
        ks = vs = None
    q = q.to(torch.bfloat16)

    def run(k, v, kss, vss):
        return paged.paged_verify_attention(q, k, v, tables, lengths,
                                            scale=0.1, k_scale=kss,
                                            v_scale=vss)
    out = run(kp, vp, ks, vs)
    kp2, vp2 = kp.clone(), vp.clone()
    ks2 = None if ks is None else ks.clone()
    vs2 = None if vs is None else vs.clone()
    bs = kp.shape[1]
    for b in range(tables.shape[0]):
        end = int(lengths[b]) + 4              # the chunk's last position
        for j in range(tables.shape[1]):
            blk = tables[b, j]
            if j > end // bs and int8:
                ks2[blk] = float("nan")
                vs2[blk] = float("nan")
            for s in range(bs):
                if j * bs + s > end:
                    if int8:
                        kp2[blk, s], vp2[blk, s] = 127, -127
                    else:
                        poison = float("nan") if j > end // bs else 1e4
                        kp2[blk, s], vp2[blk, s] = poison, -poison
    out2 = run(kp2, vp2, ks2, vs2)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_paged_verify_mma_empty_range_writes_zeros(cuda, dtype):
    """A slot whose window band lies wholly past its table has no position
    to read: the tensor-core tier writes zeros there (a zero softmax sum
    gives 0) and reads nothing, while the other slots match the plain
    version."""
    rng = np.random.default_rng(13)
    q, kp, vp, tables, lengths = _pool_problem(
        rng, dtype, cuda, q_len=5, group=2, NB=4, lens=[3, 20, 40, 90])
    out = paged.paged_verify_attention(q, kp, vp, tables, lengths,
                                       scale=0.1, window=8)
    ref = paged.paged_verify_reference(q.float(), kp.float(), vp.float(),
                                       tables, lengths, scale=0.1, window=8)
    torch.cuda.synchronize()
    assert int(lengths[3]) - 8 + 1 > 4 * kp.shape[1] - 1   # slot 3: empty
    assert torch.count_nonzero(out[3]) == 0
    diff = (out[:3].float() - ref[:3]).abs().reshape(3, -1)
    rel = (diff.amax(1) / ref[:3].abs().reshape(3, -1).amax(1)).max().item()
    assert diff.max().item() <= _tol(dtype) and rel <= _tol(dtype)


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


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_verify_slots_on_card_matches_host(cuda, kv_quant):
    """``verify_slots`` on the card (K3 in its verify mode, float or int8
    pools) against the same float32 model on the host: teacher-forced
    chunks of 5 tokens after a chunked prefill, logits within 1e-4
    relative (1/127 with int8 pools: a requantized block may move a code
    on a rounding edge by one step, ``chip_smoke.py parity_int8``); then
    spec-on serving with the prefix cache gives the host's streams."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.serving import (ServeRequest,
                                                       ServingEngine)
    from deepspeed_tpu_torch.models import gpt
    quant = kv_quant == "int8"
    cfg = gpt.preset("llama-tiny", n_layers=2, d_model=512, n_heads=8,
                     n_kv_heads=2, attn_window=24, max_seq_len=128)
    params = gpt.init_params(cfg, seed=0, device="cpu")
    engines = [init_inference(model=(cfg, params), dtype=torch.float32,
                              device=d) for d in ("cpu", "cuda")]
    bs, NB = 16, gpt.decode_geometry(cfg, 16)[0]
    N = 2 * NB + 1
    shape = (cfg.n_layers, N, bs, cfg.kv_heads, cfg.head_dim)
    pools = {}
    for e in engines:
        dt = torch.int8 if quant else torch.float32
        pools[e] = [torch.zeros(shape, dtype=dt, device=e.device)
                    for _ in range(2)]
        if quant:
            pools[e] += [torch.zeros(shape[:2] + shape[3:4], device=e.device)
                         for _ in range(2)]

    def call(e, fn, *args):
        p = pools[e]
        kw = dict(k_scale=p[2], v_scale=p[3]) if quant else {}
        out = getattr(e, fn)(p[0], p[1], *args, **kw)
        pools[e] = list(out[-len(p):])
        return out[0].float().cpu()

    rng = np.random.default_rng(4)
    tables = np.arange(1, N, dtype=np.int32).reshape(2, NB)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (21, 40)]
    for slot, p in enumerate(prompts):
        for start in range(0, len(p), 16):
            n = min(16, len(p) - start)
            chunk = np.zeros(16, np.int32)
            chunk[:n] = p[start:start + n]
            for e in engines:
                call(e, "prefill_into_slot", tables[slot], chunk, start, n)
    lengths = np.array([len(p) for p in prompts], np.int32)
    tol = 1.0 / 127 if quant else 1e-4
    counter = "int8_verify_launches" if quant else "verify_launches"
    n0 = getattr(paged.paged_attention, counter)
    for step in range(4):
        chunk = rng.integers(1, cfg.vocab_size, (2, 5)).astype(np.int32)
        active = np.array([True, step != 1])
        host, card = (call(e, "verify_slots", tables, lengths, chunk, active)
                      for e in engines)
        rel = ((card - host)[active].abs().max()
               / host[active].abs().max()).item()
        assert rel <= tol, (step, rel)
        lengths = lengths + np.where(active, 3, 0).astype(np.int32)
    torch.cuda.synchronize()
    assert getattr(paged.paged_attention, counter) == n0 + 4 * cfg.n_layers
    base = np.tile(rng.integers(1, cfg.vocab_size, 6), 4)
    prompts = [np.concatenate([base, rng.integers(1, cfg.vocab_size, n)])
               .astype(np.int32) for n in (5, 11, 3)]
    served = []
    for e in engines:
        srv = ServingEngine(e, num_slots=2, block_size=16, num_blocks=12,
                            prefill_chunk=16, kv_quant=kv_quant,
                            prefix_cache=True, spec_decode=True, spec_k=4)
        served.append(srv.run([ServeRequest(rid=i, prompt=p,
                                            max_new_tokens=20)
                               for i, p in enumerate(prompts)]))
        assert srv.stats["spec_steps"] > 0 and srv.stats["prefix_hits"] > 0
    for rid in served[0]:
        np.testing.assert_array_equal(served[1][rid], served[0][rid])


@pytest.mark.gpu
def test_cow_blocks_on_card_bit_for_bit(cuda):
    """The copy-on-write programs move one block of every layer on the
    card, codes and scales bit for bit, and touch nothing else."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models import gpt
    cfg = gpt.preset("llama-tiny", n_layers=2, d_model=512, n_heads=8,
                     n_kv_heads=2, max_seq_len=128)
    eng = init_inference(model=(cfg, gpt.init_params(cfg, seed=0,
                                                     device="cpu")),
                         dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device=cuda).manual_seed(0)
    shape = (cfg.n_layers, 9, 16, cfg.kv_heads, cfg.head_dim)
    k, v = (torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    kq, vq = (torch.randint(-127, 128, shape, generator=g, device=cuda,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(shape[:2] + shape[3:4], generator=g, device=cuda)
              for _ in range(2))
    before = [t.clone() for t in (k, v, kq, vq, ks, vs)]
    out = eng.cow_blocks(k, v, 3, 7) + eng.cow_blocks_q(kq, vq, ks, vs, 2, 5)
    torch.cuda.synchronize()
    for t, b, (src, dst) in zip(out, before, [(3, 7)] * 2 + [(2, 5)] * 4):
        want = b.clone()
        want[:, dst] = b[:, src]
        assert torch.equal(t, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_horizon_on_card_equals_one_token_decode(cuda, kv_quant):
    """A decode horizon of 4 and of 8 on the card gives the N = 1 streams
    in bf16, token for token and logprob for logprob: the same kernels
    (K3, or K3-int8) run at the same lengths, read from the card. Greedy
    and sampled requests, one with a two-token stop taken from its own
    stream; K3 runs L times per horizon iteration."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.serving import (ServeRequest,
                                                       ServingEngine)
    from deepspeed_tpu_torch.models import gpt
    cfg = gpt.preset("llama-tiny", n_layers=2, d_model=512, n_heads=8,
                     n_kv_heads=2, max_seq_len=256)
    eng = init_inference(model=(cfg, gpt.init_params(cfg, seed=0,
                                                     device="cpu")),
                         dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (7, 40, 19, 66)]
    counter = "int8_launches" if kv_quant == "int8" else "launches"

    def serve(n, stop=None):
        srv = ServingEngine(eng, num_slots=4, block_size=16,
                            prefill_chunk=32, kv_quant=kv_quant,
                            decode_horizon=n)
        reqs = [ServeRequest(rid=i, prompt=p, max_new_tokens=24,
                             logprobs=True, stop=stop if i == 0 else None,
                             temperature=0.8 if i % 2 else None, seed=i)
                for i, p in enumerate(prompts)]
        k3 = getattr(paged.paged_attention, counter)
        srv.run(reqs)
        torch.cuda.synchronize()
        launched = getattr(paged.paged_attention, counter) - k3
        assert launched == cfg.n_layers * srv.decode_iterations
        return [(r.out, r.out_logprobs) for r in reqs], srv

    plain, _ = serve(1)
    stop = [plain[0][0][9:11]]
    ref, srv1 = serve(1, stop)
    assert srv1.stats["stop_hits"] == 1
    for n in (4, 8):
        got, srv = serve(n, stop)
        assert got == ref, n
        assert srv.stats["decode_steps"] < srv1.stats["decode_steps"]


@pytest.mark.gpu
def test_host_tier_round_trip_on_card_bit_for_bit(cuda):
    """A spill through the copy stream into pinned memory and a restore
    through the pinned restore buffers move every layer's codes and fp32
    scales of an int8 pool (and a bf16 pool's values) bit for bit; the
    blocks not restored keep their bytes."""
    from deepspeed_tpu_torch.inference.paged_cache import PagedKVCache
    from deepspeed_tpu_torch.models import gpt
    cfg = gpt.preset("llama-tiny", n_layers=2, d_model=512, n_heads=8,
                     n_kv_heads=2, max_seq_len=128)
    for kv_quant in ("off", "int8"):
        c = PagedKVCache(cfg, num_slots=2, block_size=16, num_blocks=12,
                         dtype=torch.bfloat16, device="cuda",
                         kv_quant=kv_quant, watermark=0, prefix_cache=True,
                         host_tier=True, spill_watermark=100)
        g = torch.Generator(device=cuda).manual_seed(1)
        for t in c._pools():
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                      device=cuda, dtype=torch.int8))
            else:
                t.copy_(torch.randn(t.shape, generator=g, device=cuda))
        tokens = np.arange(48, dtype=np.int32)
        c.allocate(0, 48, tokens=tokens)
        c.lengths[0] = 48
        c.register_prefix(0, tokens)
        chain = list(c._owned[0])
        c.free(0)
        before = {b: [t[:, b].clone() for t in c._pools()] for b in chain}
        assert c.spill_tick() == 0 and c._pending_spill[2] is not None
        assert c.spill_tick() == 3 and c.host_blocks == 3
        for t in c._pools():               # the device copies are gone
            t[:, 1:].zero_()
        untouched = [t.clone() for t in c._pools()]
        assert c.allocate(1, 50, tokens=np.arange(50, dtype=np.int32)) == 48
        torch.cuda.synchronize()
        assert c.host_restores == 3 and c.host_blocks == 0
        restored = c._owned[1][:3]
        for b, old in zip(restored, before.values()):
            for t, o in zip(c._pools(), old):
                assert torch.equal(t[:, b], o)
        for t, u in zip(c._pools(), untouched):
            keep = [b for b in range(c.num_blocks) if b not in restored]
            assert torch.equal(t[:, keep], u[:, keep])


def _migration_caches(cuda, dtype, kv_quant, **kw):
    """A source and a destination cache on the card, llama-tiny widths at
    2 layers, every pool filled with seeded values (int8 codes and fp32
    scales with int8 pools)."""
    from deepspeed_tpu_torch.inference.paged_cache import PagedKVCache
    from deepspeed_tpu_torch.models import gpt
    cfg = gpt.preset("llama-tiny", n_layers=2, d_model=512, n_heads=8,
                     n_kv_heads=2, max_seq_len=128)
    caches = []
    g = torch.Generator(device=cuda).manual_seed(3)
    for _ in range(2):
        c = PagedKVCache(cfg, num_slots=2, block_size=16, dtype=dtype,
                         device="cuda", kv_quant=kv_quant, watermark=0,
                         **kw)
        for t in c._pools():
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                      device=cuda, dtype=torch.int8))
            else:
                t.copy_(torch.rand(t.shape, generator=g, device=cuda) + 0.5)
        caches.append(c)
    return caches


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,kv_quant", [
    (torch.bfloat16, "off"), (torch.float16, "off"),
    (torch.bfloat16, "int8")], ids=["bf16", "fp16", "int8"])
def test_migration_between_card_pools_byte_equal(cuda, dtype, kv_quant):
    """migrate_gather from one card pool and land_parked into another move
    every layer's K/V (codes and fp32 scales with int8 pools) byte for
    byte into free-list blocks; adopt_parked installs the chain; a second
    migration allocates no device memory; the source is untouched."""
    from deepspeed_tpu_torch.inference.host_tier import HostBlockPool
    src, dst = _migration_caches(cuda, dtype, kv_quant, num_blocks=12)
    src.allocate(0, 70)                      # 5 blocks: two batches of 4
    src.lengths[0] = 70
    dst.allocate(1, 20)                      # 2 blocks held on the side
    chain = list(src._owned[0])
    before = [t.clone() for t in src._pools()]
    pool = HostBlockPool()
    stats = torch.cuda.memory_stats
    for rid in ("warm", "steady"):
        free0 = list(dst._free)
        n0 = stats()["allocation.all.allocated"]
        handle = src.migrate_gather(0, pool)
        assert dst.land_parked(rid, handle["keys"], pool,
                               handle["length"]) == 5
        torch.cuda.synchronize()
        if rid == "steady":
            assert stats()["allocation.all.allocated"] == n0
        landed = dst._parked[rid][0]
        assert landed == free0[::-1][:5]         # the free list's tail
        for t, u in zip(src._pools(), dst._pools()):
            assert torch.equal(t[:, chain], u[:, landed])
        for k in handle["keys"]:
            pool.discard(k)
        assert (handle["length"], handle["n_blocks"]) == (70, 5)
    for t, b in zip(src._pools(), before):
        assert torch.equal(t, b)
    dst.drop_parked("warm")
    assert dst.adopt_parked(0, "steady") == 70
    assert list(dst.tables[0, :5]) == landed and dst.active[0]
    st = dst.stats()
    assert (st["parked_blocks"], st["parked_adopted"],
            st["parked_aborts"]) == (0, 1, 1)
    assert len(pool) == 0


@pytest.mark.gpu
def test_migration_landing_free_list_only_and_corruption_refused(cuda):
    """A landing takes free-list blocks only: with cached blocks
    reclaimable but the free list short, it raises CacheExhausted and
    returns what it landed, the cache untouched. A corrupted stored byte
    fails the CRC32 on landing: nothing parks, nothing leaks."""
    from deepspeed_tpu_torch.inference.host_tier import (HostBlockPool,
                                                         HostCorruption)
    from deepspeed_tpu_torch.inference.paged_cache import CacheExhausted
    src, dst = _migration_caches(cuda, torch.bfloat16, "int8",
                                 num_blocks=8, prefix_cache=True)
    src.allocate(0, 64)
    src.lengths[0] = 64
    pool = HostBlockPool()
    handle = src.migrate_gather(0, pool)
    tokens = np.arange(80, dtype=np.int32)
    dst.allocate(0, 80, tokens=tokens)       # 5 blocks, then cached
    dst.lengths[0] = 80
    dst.register_prefix(0, tokens)
    dst.free(0)
    assert dst.free_blocks == 3 and dst.cached_blocks == 5
    cached = [t.clone() for t in dst._pools()]
    with pytest.raises(CacheExhausted, match="free block"):
        dst.land_parked("r", handle["keys"], pool, handle["length"])
    assert dst.free_blocks == 3 and dst.cached_blocks == 5
    assert not dst.has_parked("r")
    idx = [b for b in range(1, dst.num_blocks) if b not in dst._free]
    for t, c in zip(dst._pools(), cached):
        assert torch.equal(t[:, idx], c[:, idx])
    big = _migration_caches(cuda, torch.bfloat16, "int8", num_blocks=8)[1]
    pool.corrupt(handle["keys"][2])
    free0 = list(big._free)
    with pytest.raises(HostCorruption, match="CRC32"):
        big.land_parked("r", handle["keys"], pool, handle["length"])
    assert big._free == free0 and not big.has_parked("r")
    assert big.stats()["parked_blocks"] == 0


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


def _card_server(kv_quant, **kw):
    """A bf16 llama-tiny-dialect engine on the card (head dim 64, GQA)
    behind a ServingEngine with float or int8 pools."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.serving import ServingEngine
    from deepspeed_tpu_torch.models import gpt
    cfg = gpt.preset("llama-tiny", n_layers=2, d_model=512, n_heads=8,
                     n_kv_heads=2, max_seq_len=128)
    params = gpt.init_params(cfg, seed=0, device="cpu")
    eng = init_inference(model=(cfg, params), dtype=torch.bfloat16,
                         device="cuda")
    return ServingEngine(eng, num_slots=2, block_size=16, num_blocks=16,
                         prefill_chunk=16, kv_quant=kv_quant, **kw)


def _card_requests(srv, n_new=12):
    from deepspeed_tpu_torch.inference.serving import ServeRequest
    rng = np.random.default_rng(4)
    return [ServeRequest(rid=i, prompt=rng.integers(
        1, srv.engine.cfg.vocab_size, n).astype(np.int32),
        max_new_tokens=n_new) for i, n in enumerate((21, 37))]


def _pools(cache):
    return [t.clone() for t in (cache.k, cache.v, cache.k_scale,
                                cache.v_scale) if t is not None]


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_faulted_slot_program_leaves_pools_untouched(cuda, kv_quant):
    """A device error at ``engine.prefill``, ``engine.decode`` or
    ``engine.verify``, and with int8 pools at ``cache.quantize``, fires
    before the slot program writes the pools or launches a kernel: the
    pools (and scales) stay byte-equal to what they held, and no K3 or K4
    launch is counted. With float pools ``cache.quantize`` never fires."""
    from deepspeed_tpu_torch.utils import faults
    from deepspeed_tpu_torch.utils.faults import Fault, TransientDeviceError
    srv = _card_server(kv_quant)
    for r in _card_requests(srv):
        srv.submit(r)
    for _ in range(3):                 # both prompts resident, decoding
        srv.step()
    torch.cuda.synchronize()
    c, e = srv.cache, srv.engine
    B = srv.num_slots
    tokens = np.array([r.out[-1] for r in srv.slots], np.int32)
    active = np.ones(B, bool)
    chunk = np.zeros(16, np.int32)
    calls = {
        "engine.decode": lambda: e.decode_slots(
            c.k, c.v, c.tables, c.lengths, tokens, active,
            k_scale=c.k_scale, v_scale=c.v_scale,
            sample_state=srv.sampler.lanes(np.ones(B, np.int64))),
        "engine.verify": lambda: e.verify_slots(
            c.k, c.v, c.tables, c.lengths, np.stack([tokens] * 5, 1),
            active, k_scale=c.k_scale, v_scale=c.v_scale),
        "engine.prefill": lambda: e.prefill_into_slot(
            c.k, c.v, c.tables[0], chunk, int(c.lengths[0]), 4,
            k_scale=c.k_scale, v_scale=c.v_scale)}
    for site, call in calls.items():
        for fault in (site, "cache.quantize"):
            before = _pools(c)
            n0 = (paged.paged_attention.launches
                  + paged.paged_attention.int8_launches
                  + paged.paged_attention.verify_launches
                  + paged.paged_attention.int8_verify_launches
                  + int8_matmul.int8_matmul.launches)
            with faults.injected(Fault(fault, "device_error")) as inj:
                if fault == "cache.quantize" and kv_quant == "off":
                    call()
                    assert not inj.fired
                    continue
                with pytest.raises(TransientDeviceError, match=fault):
                    call()
            torch.cuda.synchronize()
            assert inj.fired == [(fault, "device_error", 0)]
            assert n0 == (paged.paged_attention.launches
                          + paged.paged_attention.int8_launches
                          + paged.paged_attention.verify_launches
                          + paged.paged_attention.int8_verify_launches
                          + int8_matmul.int8_matmul.launches)
            for a, b in zip(before, _pools(c)):
                assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_retried_step_pools_equal_a_fault_free_step(cuda, kv_quant):
    """Two engines on the card step in lockstep over the same requests,
    one with device errors at the prefill and decode dispatches and in
    the slot programs (retried by the scheduler), one without: after every
    step their pools (and scales) are byte-equal, so no retry wrote a
    token's K/V twice, and their streams are identical."""
    from deepspeed_tpu_torch.utils import faults
    spec = ("serving.prefill:device_error@1;engine.decode:device_error@2;"
            "serving.decode:device_error@4*2;engine.prefill:device_error@3")
    if kv_quant == "int8":
        spec += ";cache.quantize:device_error@6"
    with faults.injected():
        clean = _card_server(kv_quant)
    with faults.injected(*faults.parse_spec(spec)) as inj:
        chaos = _card_server(kv_quant, retry_backoff_s=0.0)
        for srv in (clean, chaos):
            for r in _card_requests(srv):
                srv.submit(r)
        steps = 0
        while clean.busy or chaos.busy:
            with faults.injected():
                clean.step()
            chaos.step()
            torch.cuda.synchronize()
            steps += 1
            for a, b in zip(_pools(clean.cache), _pools(chaos.cache)):
                assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), \
                    f"pools differ after step {steps}"
    assert len(inj.fired) == len(faults.parse_spec(spec)) + 1
    assert chaos.stats["retries"] == len(inj.fired)
    assert clean.stats["retries"] == 0
    assert {r.rid: r.out for r in chaos.finished} == \
        {r.rid: r.out for r in clean.finished}


def _card_adapters(eng, ranks=(8, 16), seed=0):
    """Seeded adapters in the ``runtime/lora.py`` export format on every
    dense target of ``eng`` (``kernel`` or int8 ``q``), B noise so the
    delta is not zero."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, r in enumerate(ranks):
        sd = {}
        for t, e in eng.params["block"].items():
            w = e.get("kernel", e.get("q"))
            if w is None:
                continue
            L, din, dout = w.shape
            sd[f"block/{t}/lora_a"] = rng.standard_normal(
                (L, din, r), np.float32) / np.float32(np.sqrt(r))
            sd[f"block/{t}/lora_b"] = rng.standard_normal(
                (L, r, dout), np.float32) * np.float32(0.02)
            sd[f"block/{t}/lora_scale"] = np.full((L,), 2.0, np.float32)
        out[f"a{i}"] = sd
    return out


def _launch_counts():
    pa = paged.paged_attention
    return (pa.launches, pa.int8_launches, pa.verify_launches,
            pa.int8_verify_launches, int8_matmul.int8_matmul.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", ["off", "int8"])
def test_lora_zero_table_is_bit_equal_to_no_lora(cuda, kv_quant):
    """``decode_slots`` and ``verify_slots`` with an all-zeros adapter
    table (every slot base-only: the pool's zero block 0) give logits and
    pools bit-equal to ``lora=None`` on the card, over bf16 weights with
    float pools and over int8 weights (K4) with int8 pools; a table that
    names an adapter changes the logits; and the K3 (K3-int8, verify
    modes) and K4 launch counts are the same with and without ``lora=``."""
    from deepspeed_tpu_torch.inference.adapters import AdapterPool
    srv = _card_server(kv_quant)
    if kv_quant == "int8":
        from deepspeed_tpu_torch import init_inference
        srv = type(srv)(init_inference(
            model=(srv.engine.cfg, srv.engine.params), dtype=torch.int8,
            device="cuda"), num_slots=2, block_size=16, num_blocks=16,
            prefill_chunk=16, kv_quant="int8")
    for r in _card_requests(srv):
        srv.submit(r)
    for _ in range(3):
        srv.step()
    c, e = srv.cache, srv.engine
    pool = AdapterPool(e, pool_blocks=3, max_rank=16, rank_block=8)
    for aid, sd in _card_adapters(e).items():
        pool.register(aid, sd)
    named = np.stack([pool.acquire("a1"), pool.acquire("a0")])
    zeros = np.zeros_like(named)
    B = srv.num_slots
    tokens = np.array([r.out[-1] for r in srv.slots], np.int32)
    active = np.ones(B, bool)
    calls = {
        "decode": lambda lora, p: e.decode_slots(
            p[0], p[1], c.tables, c.lengths, tokens, active,
            **dict(zip(("k_scale", "v_scale"), p[2:])), lora=lora),
        "verify": lambda lora, p: e.verify_slots(
            p[0], p[1], c.tables, c.lengths, np.stack([tokens] * 5, 1),
            active, **dict(zip(("k_scale", "v_scale"), p[2:])), lora=lora)}
    for name, call in calls.items():
        got = {}
        for tag, lora in (("none", None), ("zeros", pool.lora_args(zeros)),
                          ("named", pool.lora_args(named))):
            p = _pools(c)
            torch.cuda.synchronize()
            n0 = _launch_counts()
            out = call(lora, p)
            torch.cuda.synchronize()
            n = tuple(b - a for a, b in zip(n0, _launch_counts()))
            got[tag] = (out[0], p, n)
        assert torch.equal(got["zeros"][0], got["none"][0]), name
        for a, b in zip(got["zeros"][1], got["none"][1]):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        assert not torch.equal(got["named"][0], got["none"][0]), name
        assert got["none"][2] == got["zeros"][2] == got["named"][2], name
        assert sum(got["none"][2]) > 0
        if kv_quant == "int8":
            assert got["none"][2][4] > 0        # K4 in every projection


@pytest.mark.gpu
def test_adapter_load_writes_exactly_its_blocks(cuda):
    """A load on the card writes the adapter's rank blocks into the pool
    blocks of its row, in the pool's dtype (A as staged, B with the scale
    folded in), and nothing else: block 0 stays zero, the blocks of an
    adapter already resident keep their bytes."""
    from deepspeed_tpu_torch.inference.adapters import AdapterPool
    e = _card_server("off").engine
    pool = AdapterPool(e, pool_blocks=4, max_rank=16, rank_block=8)
    sds = _card_adapters(e)
    for aid, sd in sds.items():
        pool.register(aid, sd)
    row0 = pool.acquire("a0")
    before = {t: (a.clone(), pool.b_pool[t].clone())
              for t, a in pool.a_pool.items()}
    row1 = pool.acquire("a1")
    torch.cuda.synchronize()
    assert row0.tolist() == [1, 0] and row1.tolist() == [2, 3]
    for t, a in pool.a_pool.items():
        b = pool.b_pool[t]
        assert a.device.type == "cuda" and a.dtype == e.dtype
        assert not a[:, 0].any() and not b[:, 0].any()
        assert torch.equal(a[:, 1], before[t][0][:, 1])
        assert torch.equal(b[:, 1], before[t][1][:, 1])
        for j, blk in enumerate(row1):
            sl = slice(8 * j, 8 * j + 8)
            sd = sds["a1"]
            want_a = torch.from_numpy(sd[f"block/{t}/lora_a"][:, :, sl])
            want_b = torch.from_numpy(sd[f"block/{t}/lora_b"][:, sl, :]
                                      * sd[f"block/{t}/lora_scale"][:, None,
                                                                    None])
            assert torch.equal(a[:, blk].cpu(), want_a.to(e.dtype))
            assert torch.equal(b[:, blk].cpu(), want_b.to(e.dtype))
        assert not a[:, 4].any() and not b[:, 4].any()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["cache_exhausted", "device_error"])
def test_faulted_adapter_load_leaves_pools_byte_equal(cuda, kind):
    """A ``cache.adapter_load`` fault fires before any pool state moves:
    the pools on the card stay byte-equal, ``stats()`` is unchanged, and
    the next load of the same adapter succeeds."""
    from deepspeed_tpu_torch.inference.adapters import (AdapterLoadError,
                                                        AdapterPool)
    from deepspeed_tpu_torch.utils.faults import (Fault, FaultInjector,
                                                  TransientDeviceError)
    e = _card_server("off").engine
    inj = FaultInjector([Fault("cache.adapter_load", kind, step=1)])
    pool = AdapterPool(e, pool_blocks=3, max_rank=16, rank_block=8,
                       faults=inj)
    for aid, sd in _card_adapters(e).items():
        pool.register(aid, sd)
    pool.acquire("a0")
    before = [t.clone() for t in (*pool.a_pool.values(),
                                  *pool.b_pool.values())]
    stats = pool.stats()
    err = AdapterLoadError if kind == "cache_exhausted" \
        else TransientDeviceError
    with pytest.raises(err):
        pool.acquire("a1")
    torch.cuda.synchronize()
    assert pool.stats() == stats and inj.fired == [
        ("cache.adapter_load", kind, 1)]
    for a, b in zip(before, (*pool.a_pool.values(), *pool.b_pool.values())):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert pool.acquire("a1").tolist() == [2, 3]


@pytest.mark.gpu
def test_lora_drain_launches_and_base_streams_equal_lora_off(cuda):
    """Int8 weights and int8 pools on the card: a drain with two adapter
    requests and two base-only ones against the same four requests with
    LoRA off. The base-only streams and logprobs are equal bit for bit,
    the adapter streams differ, and K3-int8 and K4 launch as often (the
    LoRA delta is a torch product and launches neither)."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.serving import (ServeRequest,
                                                       ServingEngine)
    base = _card_server("off").engine
    e = init_inference(model=(base.cfg, base.params), dtype=torch.int8,
                       device="cuda")
    sds = _card_adapters(e)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, e.cfg.vocab_size, n).astype(np.int32)
               for n in (13, 30, 22, 9)]
    aids = ["a0", None, "a1", None]
    runs = []
    for on in (False, True):
        srv = ServingEngine(e, num_slots=4, block_size=16, num_blocks=24,
                            prefill_chunk=16, kv_quant="int8",
                            lora_serve=on, lora_max_rank=16,
                            lora_rank_block=8, lora_pool_blocks=3)
        if on:
            for aid, sd in sds.items():
                srv.register_adapter(aid, sd)
        reqs = [ServeRequest(rid=i, prompt=p, max_new_tokens=16,
                             logprobs=True, adapter_id=aids[i] if on else None)
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        n0 = _launch_counts()
        srv.run(reqs)
        torch.cuda.synchronize()
        runs.append(([(r.out, r.out_logprobs) for r in reqs],
                     tuple(b - a for a, b in zip(n0, _launch_counts()))))
        if on:
            assert srv.stats["adapter_loads"] == 2
            assert all(srv.adapters.refcount(a) == 0 for a in sds)
    (off, n_off), (lora, n_on) = runs
    assert n_on == n_off and n_off[1] > 0 and n_off[4] > 0
    for i, aid in enumerate(aids):
        if aid is None:
            assert lora[i] == off[i]
        else:
            assert lora[i][0] != off[i][0]


# ---------------------------------------------------------------------------
# data parallelism and ZeRO on the card
# ---------------------------------------------------------------------------

def _zero_case():
    from deepspeed_tpu_torch.models import gpt
    cfg = gpt.preset("gpt2-small", n_layers=2, d_model=128, n_heads=2,
                     vocab_size=512, max_seq_len=128, remat=True,
                     remat_policy="full", dtype=torch.float32)
    params = gpt.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(4)
    batches = [{"tokens": rng.integers(1, 512, (4, 129))} for _ in range(3)]
    config = {"train_batch_size": 4, "steps_per_print": 1000,
              "gradient_clipping": 1.0,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3,
                                                        "weight_decay": 0.1}}}
    return cfg, params, batches, config


@pytest.mark.gpu
def test_zero_on_one_nccl_rank_matches_one_process(cuda):
    """ZeRO stages 0-3 through one NCCL rank (``init_distributed(
    dist_backend="nccl")``, a world of 1, the collectives run) against the
    same engine without a process group, in float32: every step's loss
    and gradient norm and every final parameter bit for bit."""
    import socket
    from deepspeed_tpu_torch import init_distributed, initialize
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.parallel import comm
    from deepspeed_tpu_torch.parallel.mesh import make_mesh
    from deepspeed_tpu_torch.utils import distributed as dist_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params, batches, config = _zero_case()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(dist_backend="nccl",
                     init_method=f"tcp://localhost:{port}", num_processes=1,
                     process_id=0)
    try:
        for stage in range(4):
            got = []
            for mesh in (make_mesh(world_size=1), None):
                eng = initialize(model=gpt.make_loss_fn(cfg),
                                 model_parameters=params,
                                 config=dict(config, zero_optimization={
                                     "stage": stage}), mesh=mesh)[0]
                comm.reset_stats()
                rows = [eng.train_batch(b) for b in batches]
                got.append(([(float(m["loss"]), float(m["grad_norm"]))
                             for m in rows], eng.params,
                            comm.stats()["all_reduce"]["calls"]))
            (a, pa, ca), (b, pb, cb) = got
            assert a == b, stage
            assert ca == 0 and cb > 0
            for x, y in zip(ttree.tree_leaves(pa), ttree.tree_leaves(pb)):
                assert torch.equal(x, y), stage
    finally:
        dist_lib.destroy()


@pytest.mark.gpu
def test_zero_two_gloo_ranks_on_the_card_match_one_process(cuda, tmp_path):
    """Two gloo ranks sharing the card (``tests/torch_rank_worker.py ...
    cuda``), ZeRO stages 2 and 3 in float32: each rank's losses and norms
    within 1e-4 of the one-process run on the card, with K1-fwd and K2
    launched on every rank (full remat: K1-fwd twice per layer); and
    ``zero.Init`` on the card: a whole tree built there refused, leaves
    drawn one at a time kept as this rank's slices, the card's peak above
    them one whole leaf and a slice of it at most."""
    import os
    import pickle
    import subprocess
    import sys
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import gpt
    cfg, params, batches, config = _zero_case()
    eng = initialize(model=gpt.make_loss_fn(cfg), model_parameters=params,
                     config=config)[0]
    want = np.array([[float(m["loss"]), float(m["grad_norm"])]
                     for m in map(eng.train_batch, batches)])
    inputs = str(tmp_path / "inputs.pkl")
    with open(inputs, "wb") as f:
        pickle.dump(dict(fields=dict(vars(cfg)), params=params,
                         batches=batches, config=config), f)
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_rank_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, "2", str(r), str(tmp_path / "store"),
         inputs, str(tmp_path / f"r{r}.pkl"), "cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        errs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    for r in range(2):
        with open(tmp_path / f"r{r}.pkl", "rb") as f:
            out = pickle.load(f)
        for stage in (2, 3):
            got = np.array([row[:2] for row in out[stage]["rows"]])
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                       err_msg=f"rank {r} stage {stage}")
            assert out[stage]["launches"] == (2 * 2 * 3, 2 * 3, 2 * 3)
        init = out["init"]
        assert init["refused"] and init["equal"] and init["split"] >= 4
        assert init["peak"] <= init["shards"] + 2 * init["largest"], init


# ---------------------------------------------------------------------------
# the flash kernels' ring modes (ring attention's local block)
# ---------------------------------------------------------------------------

def _ring_problem(case, dtype, cuda, seed=12):
    """q [B, S, H, D] rows ``q_off`` after the keys k, v [B, Skv, Hkv, D],
    the rows' and the keys' own segment ids, a key mask, and the rows with
    a visible key (the others' do is zero: garbage by contract)."""
    rng = np.random.default_rng(seed)
    B, S, Skv, H, Hkv, D = (case[k] for k in ("B", "S", "Skv", "H", "Hkv",
                                               "D"))
    q = _randn(rng, (B, S, H, D), dtype, cuda)
    k = _randn(rng, (B, Skv, Hkv, D), dtype, cuda)
    v = _randn(rng, (B, Skv, Hkv, D), dtype, cuda)
    do = _randn(rng, (B, S, H, D), dtype, cuda)
    qs = ks = mask = None
    if case.get("segs"):
        qs = torch.from_numpy(np.sort(rng.integers(0, 3, (B, S)), 1).astype(
            np.int32)).to(cuda)
        ks = torch.from_numpy(np.sort(rng.integers(0, 3, (B, Skv)), 1)
                              .astype(np.int32)).to(cuda)
        mask = torch.from_numpy((rng.random((B, Skv)) < 0.8).astype(
            np.float32)).to(cuda)
    kw = dict(causal=case.get("causal", True), window=case.get("window"),
              q_off=case.get("q_off", 0))
    ok = flash._allowed(S, Skv, cuda, kw["causal"], kw["window"], mask, qs,
                        kw["q_off"], ks)
    valid = torch.ones(B, S, dtype=torch.bool, device=cuda) if ok is None \
        else ok.any(-1).any(1).expand(B, S)
    do = do * valid[:, :, None, None]
    return q, k, v, do, mask, qs, ks, kw, valid


_RING_CASES = [
    dict(B=1, S=256, Skv=256, H=4, Hkv=4, D=128, q_off=256, window=300),
    dict(B=2, S=130, Skv=130, H=8, Hkv=2, D=64),           # hop 0, ragged
    dict(B=2, S=128, Skv=64, H=4, Hkv=2, D=64, causal=False, segs=True),
    dict(B=1, S=64, Skv=128, H=4, Hkv=4, D=128, causal=False, segs=True),
    dict(B=2, S=192, Skv=192, H=4, Hkv=1, D=128, q_off=384, window=500,
         segs=True),
    dict(B=1, S=100, Skv=100, H=2, Hkv=2, D=64, q_off=100, window=150),
    dict(B=2, S=96, Skv=96, H=4, Hkv=2, D=64, q_off=96, window=120,
         segs=True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", _RING_CASES)
def test_flash_ring_modes_match_plain(cuda, case, dtype):
    """K1-fwd, K2-dq and K2-dkv in their ring modes (``-DDS_RING``): q rows
    ``q_off`` after the keys, windows, the keys' own segment ids, key
    masks, GQA and Skv != S, at head dims 64 and 128, against the plain
    versions (float32 on the same rounded inputs). The gradients are fp32
    whatever the dtype, held as test_flash_bwd_kernels_match_plain holds
    them; rows with no visible key are left out."""
    q, k, v, do, mask, qs, ks, kw, valid = _ring_problem(case, dtype, cuda)
    fb, bb = flash.flash_block_fwd, flash.flash_block_bwd
    n = (fb.launches, fb.offset_launches, bb.dq_launches, bb.dkv_launches)
    o, lse = fb(q, k, v, mask, qs, ks, **kw)
    grads = bb(q, k, v, do, o, lse, mask, qs, ks, **kw)
    torch.cuda.synchronize()
    off = int(kw["q_off"] > 0)
    assert (fb.launches, fb.offset_launches, bb.dq_launches,
            bb.dkv_launches) == (n[0] + 1, n[1] + off, n[2] + 1, n[3] + 1)
    assert o.dtype == dtype and all(g.dtype == torch.float32 for g in grads)
    f = [None if t is None else t.float() for t in (q, k, v, do)]
    r_o, r_lse = flash.mha_reference(f[0], f[1], f[2], kv_mask=mask,
                                     segment_ids=qs, kv_segs=ks, **kw)
    tol = _tol(dtype)
    diff = (o.float() - r_o).abs()[valid]
    assert diff.max().item() <= tol, diff.max().item()
    assert torch.allclose(lse.transpose(1, 2)[valid],
                          r_lse.transpose(1, 2)[valid], atol=1e-3, rtol=1e-3)
    ref = flash._bwd_reference(f[0], f[1], f[2], r_lse, flash.attention_delta(
        o.float(), f[3]), f[3], kw["causal"], 1.0 / np.sqrt(q.shape[-1]),
        mask, kw["window"], qs, kw["q_off"], ks, out_fp32=True)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        err = (g - r).abs().max().item()
        assert err <= tol * max(1.0, r.abs().max().item()), (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 128])
def test_ring_modes_at_offset_zero_equal_the_flash_kernels(cuda, D, dtype):
    """At q_off = 0, with the keys' ids the rows' own, the ring-mode build
    gives K1-fwd's output and LSE bit for bit, and K2's gradients before
    their rounding: rounded to the dtype they are the flash kernels' bits
    (the old modes are unchanged by the ring modes)."""
    case = dict(B=2, S=160, Skv=160, H=4, Hkv=2, D=D, window=70)
    q, k, v, do, _, _, _, kw, _ = _ring_problem(case, dtype, cuda)
    segs = _segments(np.random.default_rng(2), 2, 160, cuda)
    o, lse = flash.flash_attention(q, k, v, window=70, segment_ids=segs)
    bo, blse = flash.flash_block_fwd(q, k, v, None, segs, segs, window=70)
    assert torch.equal(o, bo) and torch.equal(lse, blse)
    want = flash.flash_attention_bwd(q, k, v, o, lse, do, window=70,
                                     segment_ids=segs)
    got = flash.flash_block_bwd(q, k, v, do, o, lse, None, segs, segs,
                                window=70)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(g.to(dtype), w), name


@pytest.mark.gpu
def test_sequence_parallel_two_gloo_ranks_on_the_card(cuda, tmp_path):
    """Two gloo ranks sharing the card (``tests/torch_rank_worker.py ...
    sp-cuda``): ring attention (contiguous, zigzag, windowed with a hop at
    q_off > 0, packed) and Ulysses in float32 on the card against the
    plain dense attention on the host (1e-4), and a GPT engine at
    sequence=2 (ring, then Ulysses) against the one-process engine on the
    card, with the ring-mode kernels launched on every rank."""
    import os
    import pickle
    import subprocess
    import sys
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import gpt
    rng = np.random.default_rng(5)
    B, S, H, Hkv, D = 1, 512, 4, 2, 64

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    base = dict(q=arr(B, S, H, D), k=arr(B, S, Hkv, D), v=arr(B, S, Hkv, D),
                do=arr(B, S, H, D))
    segs = np.sort(rng.integers(0, 4, (B, S)), 1).astype(np.int32)
    attn = {name: dict(base, impl=impl, layout=layout, window=window,
                       **(dict(segs=segs) if packed else {}))
            for name, impl, layout, window, packed in (
                ("contiguous", "ring", "contiguous", None, False),
                ("zigzag", "ring", "zigzag", None, False),
                ("window", "ring", "contiguous", 300, False),
                ("packed", "ring", "contiguous", None, True),
                ("ulysses", "ulysses", "contiguous", None, True))}
    fields = dict(vocab_size=128, n_layers=2, n_heads=4, d_model=256,
                  max_seq_len=512, dtype=torch.float32)
    cfg = gpt.GPTConfig(**fields)
    params = gpt.init_params(cfg, seed=0, device="cpu")
    tokens = np.random.default_rng(6).integers(0, 128, (2, 513))
    batches = [{"tokens": tokens}] * 2
    config = {"train_batch_size": 2, "steps_per_print": 1000,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    eng = initialize(model=gpt.make_loss_fn(cfg), model_parameters=params,
                     config=config)[0]
    want = np.array([[float(m["loss"]), float(m["grad_norm"])]
                     for m in map(eng.train_batch, batches)])
    del eng
    sp_config = dict(config, mesh={"sequence_parallel_size": 2})
    engine = {impl: dict(fields=dict(fields, sequence_parallel=True,
                                     sp_impl=impl), params=params,
                         config=sp_config, batches=batches)
              for impl in ("ring", "ulysses")}
    inputs = str(tmp_path / "inputs.pkl")
    with open(inputs, "wb") as f:
        pickle.dump(dict(attn=attn, engine=engine), f)
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_rank_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, "2", str(r), str(tmp_path / "store"),
         inputs, str(tmp_path / f"r{r}.pkl"), "sp-cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        errs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    outs = []
    for r in range(2):
        with open(tmp_path / f"r{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    for name, case in attn.items():
        t = {x: torch.from_numpy(case[x]).double().requires_grad_()
             for x in "qkv"}
        sid = None if "segs" not in case else torch.from_numpy(case["segs"])
        ref, _ = flash.mha_reference(t["q"], t["k"], t["v"],
                                     window=case["window"], segment_ids=sid)
        ref.backward(torch.from_numpy(case["do"]).double())
        want_a = [ref.detach()] + [t[x].grad for x in "qkv"]
        for part, w in enumerate(want_a):
            got = np.empty(w.shape, np.float32)
            for out in outs:
                idx, *parts = out["attn"][name]
                got[:, idx] = parts[part]
            np.testing.assert_allclose(got, w.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=f"{name} part {part}")
    for r, out in enumerate(outs):
        c = out["attn_comm"]
        assert c["rotate"]["staged"] == c["rotate"]["calls"] > 0
        for impl in ("ring", "ulysses"):
            got = out["engine"][impl]
            np.testing.assert_allclose(
                np.array([row[:2] for row in got["rows"]]), want, rtol=1e-4,
                atol=1e-4, err_msg=f"rank {r} {impl}")
        # ring: per step and layer one forward block per live hop (hop 1
        # only on rank 1) and a backward; Ulysses runs the flash kernels
        hops = 1 + r
        assert out["engine"]["ring"]["launches"][0] == 2 * 2 * hops
        assert out["engine"]["ring"]["launches"][2] == 2 * 2 * hops
        assert out["engine"]["ulysses"]["launches"][0] == 0


# ---------------------------------------------------------------------------
# tensor parallelism: the kernels at one model rank's shapes
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("q_len", [1, 5])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_kernel_at_one_ranks_heads_matches_plain(cuda, int8, q_len):
    """K3 and K3-int8 at llama-7b's decode and verify shapes on one rank
    of two: 16 of its 32 kv heads, bf16 q."""
    rng = np.random.default_rng(9)
    kw = dict(B=8, Hkv=16, group=1, q_len=q_len, NB=8,
              lens=[0, 5, 16, 40, 64, 90, 110, 123])
    if int8:
        q, (kp, vp), (ks, vs), tables, lengths = _int8_pool_problem(
            rng, cuda, **kw)
        q = q.to(torch.bfloat16)
        extra = dict(k_scale=ks, v_scale=vs)
        kr, vr = kp, vp
    else:
        q, kp, vp, tables, lengths = _pool_problem(rng, torch.bfloat16, cuda,
                                                   **kw)
        extra = {}
        kr, vr = kp.float(), vp.float()
    scale = q.shape[-1] ** -0.5
    if q_len == 1:
        out = paged.paged_decode_attention(q[:, 0], kp, vp, tables, lengths,
                                           scale=scale, **extra)
        ref = paged.paged_decode_reference(q[:, 0].float(), kr, vr, tables,
                                           lengths, scale=scale, **extra)
    else:
        out = paged.paged_verify_attention(q, kp, vp, tables, lengths,
                                           scale=scale, **extra)
        ref = paged.paged_verify_reference(q.float(), kr, vr, tables,
                                           lengths, scale=scale, **extra)
    B = q.shape[0]
    diff = (out.float() - ref).abs().reshape(B, -1)
    rel = (diff.amax(1) / ref.abs().reshape(B, -1).amax(1)).max().item()
    assert diff.max().item() <= 2e-2 and rel <= 2e-2, rel


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (8, 4096, 6144), (8, 2048, 4096), (8, 4096, 5504), (8, 5504, 4096),
    (256, 4096, 6144), (256, 2048, 4096), (256, 4096, 5504),
    (256, 5504, 4096),
    # model degree 4: d_ff / 4 = 2752 is no multiple of the 128-wide tile
    (256, 4096, 2752), (256, 2752, 4096), (8, 4096, 2752)])
def test_int8_matmul_at_shard_shapes_matches_plain(cuda, shape):
    """K4 at llama-7b's shard shapes under tensor parallelism (qkv N 6144,
    attn_out K 2048, mlp_in/mlp_gate N 5504, mlp_out K 5504 at degree 2),
    decode (M = 8) and prefill chunk (M = 256), bf16."""
    rng = np.random.default_rng(8)
    M, K, N = shape
    x, q, scale = _int8_problem(rng, M, K, N, torch.bfloat16, cuda)
    out = int8_matmul.int8_matmul(x, q, scale)
    ref = int8_matmul.int8_matmul_reference(x.float(), q, scale)
    diff = (out.float() - ref).abs()
    top = ref.abs().max().item()
    rel = (diff.amax(1) / ref.abs().amax(1)).max().item()
    assert diff.max().item() <= 2e-2 * max(1.0, top), (diff.max(), top)
    assert rel <= 2e-2, rel


@pytest.mark.gpu
def test_tensor_parallel_two_gloo_ranks_on_the_card(cuda, tmp_path):
    """Two gloo ranks sharing the card (``tests/torch_rank_worker.py ...
    tp-cuda``): ``generate`` at mp_size 2 gives the one-rank engine's
    tokens, the logits within 1e-4 in float32, and ``generate_fused``
    refuses the gloo group (a CUDA graph cannot hold its host-staged
    all-reduce)."""
    import os
    import pickle
    import subprocess
    import sys
    from deepspeed_tpu_torch.models import gpt
    fields = dict(vocab_size=128, n_layers=2, n_heads=8, n_kv_heads=2,
                  d_model=256, d_ff=512, max_seq_len=256, rotary_dim=32,
                  norm="rmsnorm", activation="swiglu", use_bias=False,
                  use_wpe=False, tie_embeddings=False, dtype=torch.float32)
    params = gpt.init_params(gpt.GPTConfig(**fields), seed=0, device="cpu")
    toks = np.random.default_rng(4).integers(1, 128, (2, 130))
    inputs = str(tmp_path / "inputs.pkl")
    with open(inputs, "wb") as f:
        pickle.dump(dict(fields=fields, params=params, toks=toks), f)
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_rank_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, "2", str(r), str(tmp_path / "store"),
         inputs, str(tmp_path / f"r{r}.pkl"), "tp-cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        errs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    for r in range(2):
        with open(tmp_path / f"r{r}.pkl", "rb") as f:
            out = pickle.load(f)
        np.testing.assert_array_equal(out[2]["gen"], out[1]["gen"])
        np.testing.assert_allclose(out[2]["logits"], out[1]["logits"],
                                   rtol=1e-4, atol=1e-4)
        assert "gloo" in out["fused_refused"]

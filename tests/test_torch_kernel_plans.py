"""The work plans of the paged-decode kernel (K3) and the int8 matmul (K4),
chosen in Python from the shapes alone: no JAX, no card.

K3's plan cuts each slot's cache positions into units of 16 and gives a
CTA ``chunk`` units; ``paged.slot_ranges`` is the host's copy of the
range arithmetic each CTA does on the device from the slot's length.
K4's plan picks the kernel, its tiles and the K split.
"""

import numpy as np
import pytest

from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops import int8_matmul as mm
from deepspeed_tpu_torch.ops.attention import paged

# (B, Hkv, R, NB, bs): the llama-7b decode step, GQA, verify, blocks of 4
# and 8, rows over two passes, one slot
PAGED_SHAPES = [(8, 32, 1, 128, 16), (8, 8, 4, 128, 16), (8, 8, 16, 128, 16),
                (4, 2, 2, 40, 4), (4, 2, 6, 12, 8), (2, 2, 20, 8, 16),
                (1, 1, 1, 3, 16)]

LLAMA_PROJ = {"qkv": (4096, 12288), "attn_out": (4096, 4096),
              "mlp_in": (4096, 11008), "mlp_out": (11008, 4096)}


def _lengths(rng, NB, bs, q_len):
    cap = NB * bs - q_len
    return sorted({0, 1, bs - 1, bs, cap, *rng.integers(0, cap + 1, 12)})


@pytest.mark.parametrize("shape", PAGED_SHAPES)
@pytest.mark.parametrize("q_len,window", [(1, None), (1, 21), (4, None),
                                          (3, 300)])
def test_paged_ranges_cover_each_position_once(shape, q_len, window):
    """The splits of a slot read every position from its first row's band
    to its last row exactly once, in order, and none past the slot's last
    block; each split holds at most ``chunk`` units and there are at most
    ``nsplit`` of them (the partial buffers' size)."""
    B, Hkv, R, NB, bs = shape
    p = paged.plan(B, Hkv, R, NB, bs)
    for length in _lengths(np.random.default_rng(NB), NB, bs, q_len):
        ranges = paged.slot_ranges(p, length, q_len, window, NB, bs)
        lo = max(length - window + 1, 0) if window else 0
        hi = min(length + q_len - 1, NB * bs - 1)
        read = [pos for a, b in ranges for pos in range(a, b + 1)]
        assert read == list(range(lo, hi + 1)), (length, ranges)
        assert len(ranges) <= p.nsplit
        last_block = min((length + q_len - 1) // bs, NB - 1)
        for a, b in ranges:
            assert b // bs <= last_block
            assert b // paged.UNIT - a // paged.UNIT + 1 <= p.chunk


@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_paged_plan_is_a_function_of_the_shape(shape):
    """One shape, one plan, on every call (the cached and the uncached
    function agree); the row capacity covers a pass; the passes cover R."""
    p = paged.plan(*shape)
    assert p == paged.plan.__wrapped__(*shape) == paged.plan(*shape)
    R = shape[2]
    assert p.rt in paged.ROW_CAPACITY and p.rt >= min(R, 16)
    assert (p.npass - 1) * 16 < R <= p.npass * 16
    assert paged.MIN_CHUNK <= p.chunk <= paged.MAX_CHUNK


def test_head_dims_run_at_the_next_built_width():
    """Every head dim up to 128 runs in the smallest built width at or
    above it (the presets' 32, 72, 96 at their own, 40 at 64, 100 at
    128): at a width as it is, at a multiple of 8 between the widths in
    the width's run-time head dim build, and at any other head dim
    zero-padded to the next multiple of 8 first; above 128 the kernels
    raise, naming the limit. K3's plans at a head dim are its width's."""
    for D in range(1, 129):
        W = _build.head_dim_width(D)
        assert W == min(w for w in paged.HEAD_DIMS if w >= D), D
        Dk, W_b, runtime = _build.head_dim_build(D)
        assert W_b == W and Dk % 8 == 0 and 0 <= Dk - D < 8, D
        assert runtime == (Dk not in paged.HEAD_DIMS), D
        for R in (1, 5, 40):
            assert paged.plan(8, 32, R, 128, 16, 132, "mma", W).rt <= \
                paged.MMA_ROWS[W]
    for D in (129, 136, 256):
        with pytest.raises(ValueError, match="up to 128"):
            _build.head_dim_width(D)
        with pytest.raises(ValueError, match=f"up to 128, got {D}"):
            _build.head_dim_build(D)


def test_paged_plans_at_the_gpt2_8b_shapes():
    """gpt2-8b's decode step (8 slots, 32 heads of 96, block 16) takes
    llama-7b's plan; its verify (q_len 5, group 1) one m16 tile and 32
    units a CTA; GQA verify at group 8 two passes of 32 rows, as at 128."""
    assert paged.plan(8, 32, 1, 128, 16, 132, "fma", 96) == \
        paged.plan(8, 32, 1, 128, 16)
    assert paged.plan(8, 32, 5, 128, 16, 132, "mma", 96) == \
        paged.PagedPlan(rt=16, npass=1, chunk=32, nsplit=4)
    assert paged.plan(8, 4, 40, 128, 16, 132, "mma", 96)[:2] == (32, 2)
    assert paged.plan(8, 4, 40, 128, 16, 132, "mma", 32)[:2] == (64, 1)


def test_paged_plan_at_the_decode_step():
    """llama-7b's decode step (8 slots of 128 blocks of 16, 32 heads):
    256 positions per CTA, 8 splits per slot at most, so full tables give
    2,048 CTAs, about 8 waves of two CTAs on 132 SMs; partial buffers of
    1 MiB."""
    p = paged.plan(8, 32, 1, 128, 16)
    assert p == paged.PagedPlan(rt=1, npass=1, chunk=16, nsplit=8)
    assert 8 * 32 * p.nsplit * 1 * 128 * 4 == 2**20


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("proj", sorted(LLAMA_PROJ))
def test_int8_plan_at_decode(M, proj):
    """Decode (M <= 16) takes the mma kernel, one row tile, and splits K
    so that two to three CTAs per SM keep weight loads in flight, all
    resident at once (at most four per SM), each split at least 8 stages
    long."""
    K, N = LLAMA_PROJ[proj]
    p = mm.plan(M, N, K, 1, 132)
    assert (p.kernel, p.bm, p.bn) == ("mma", 16, 128)
    grid = mm.grid_of(p, M, N)
    assert grid[2] == 1
    assert 1.5 * 132 <= grid[0] * grid[1] <= 4 * 132
    assert p.kps >= mm.DEC_MIN_STAGES


@pytest.mark.parametrize("M", [17, 37, 128, 200, 256, 2048])
@pytest.mark.parametrize("proj", sorted(LLAMA_PROJ))
def test_int8_plan_at_prefill(M, proj):
    """Past 16 rows, aligned shapes take the wgmma kernel; up to 256 rows
    one CTA covers every row of its column tile, so each weight tile is
    read and widened once per call."""
    K, N = LLAMA_PROJ[proj]
    p = mm.plan(M, N, K, 1, 132)
    assert p.kernel == "wgmma" and p.bn == mm.WG_BN
    assert p.bm == (128 if M <= 128 else 256)
    if M <= 256:
        assert mm.grid_of(p, M, N)[0] == 1


@pytest.mark.parametrize("shape", [(8, 4096, 12288), (256, 4096, 4096),
                                   (256, 11008, 4096), (37, 1000, 1000),
                                   (2048, 4096, 12288), (3, 72, 200)])
@pytest.mark.parametrize("dtype_code", [0, 1])
def test_int8_splits_cover_k_once(shape, dtype_code):
    """The K splits cover every k stage exactly once (the last split may
    be shorter), and the partial bytes are those of the splits."""
    M, K, N = shape
    p = mm.plan(M, N, K, dtype_code, 132)
    bk = mm.FBK if dtype_code == 0 else mm.BK
    stages = -(-K // bk)
    covered = [s for z in range(p.splits)
               for s in range(z * p.kps, min((z + 1) * p.kps, stages))]
    assert covered == list(range(stages))
    assert p.partial_bytes == (4 * p.splits * M * N if p.splits > 1 else 0)
    assert p == mm.plan.__wrapped__(M, N, K, dtype_code, 132)


def test_int8_plan_partials_at_a_prefill_chunk():
    """A prefill chunk's layer (M = 256: qkv, attn_out, mlp_in twice,
    mlp_out) splits K only where 4096 output columns (32 tiles of 128)
    leave SMs idle: attn_out and mlp_out in 4, 32 MiB of fp32 partials in
    all (the previous plan, splitting by CTA count alone, wrote 112 MB)."""
    plans = {n: mm.plan(256, N, K, 1, 132) for n, (K, N) in LLAMA_PROJ.items()}
    assert {n: p.splits for n, p in plans.items()} == {
        "qkv": 1, "attn_out": 4, "mlp_in": 1, "mlp_out": 4}
    total = sum(plans[n].partial_bytes for n in
                ("qkv", "attn_out", "mlp_in", "mlp_in", "mlp_out"))
    assert total == 256 * 4096 * 4 * (4 + 4) == 32 * 2**20
    for n, (K, N) in LLAMA_PROJ.items():
        assert np.prod(mm.grid_of(plans[n], 256, N)) <= 132


@pytest.mark.parametrize("shape", [(37, 1000, 1000), (200, 1001, 4096),
                                   (64, 4096, 4104)])
def test_int8_plan_without_tma(shape):
    """Shapes TMA cannot read (N not a multiple of 16, K not one of 8, or
    unaligned bases) take the mma kernel in row tiles of 16."""
    M, K, N = shape
    p = mm.plan(M, N, K, 1, 132, aligned=False)
    assert p.kernel == "mma"
    assert mm.grid_of(p, M, N)[2] == -(-M // 16)


def test_int8_plan_float32():
    """float32 x stays on the CUDA cores."""
    p = mm.plan(8, 12288, 4096, 0, 132)
    assert (p.kernel, p.bm, p.bn) == ("fma", mm.FBM, mm.FBN)


def test_kernel_builds_reads_ptxas_and_sass():
    """``tools/kernel_builds``: spill bytes per kernel from an ``-Xptxas
    -v`` log, and per kernel the instructions of a ``cuobjdump -sass``
    listing without addresses, encodings or the anonymous namespace's
    source hash, so two builds of one source compare equal."""
    from deepspeed_tpu_torch.tools import kernel_builds as kb
    anon = "_ZN45_GLOBAL__N__0584685a_12_flash_fwd_cu_2bc3d3511k"
    log = (f"ptxas info    : Compiling entry function '{anon}IfLi64EEEv' "
           "for 'sm_90a'\n    0 bytes stack frame, 8 bytes spill stores, "
           "8 bytes spill loads\nptxas info    : Compiling entry function "
           "'_Z1gv' for 'sm_90a'\n    0 bytes stack frame, 0 bytes spill "
           "stores, 0 bytes spill loads\n")
    assert kb.spills(log) == {"_ZN451kIfLi64EEEv": 8, "_Z1gv": 0}
    listing = ("\t\tFunction : {}\n"
               "        /*0000*/                   LDC R1, c[0x0][0x28] ;"
               "   /* 0x00000a00ff017b82 */\n"
               "        /*0010*/                   EXIT ;\n")
    a = kb.sass(listing.format(anon + "v"))
    b = kb.sass(listing.format(anon.replace("0584685a", "77777777") + "v"))
    assert a == b == {"_ZN451kv": ["LDC R1, c[0x0][0x28]", "EXIT"]}


"""K3's two designs, chosen by the C entry point of
``csrc/paged_decode.cu`` and named by ``paged.DESIGN``, and the work plan
of the tensor-core verify tier: no JAX, no card.

``dispatch`` in the CUDA source has one line for each (q dtype, pool,
mode); the table in Python must name the same launcher. The plan for the
tensor-core design takes the fewest m16 tiles that hold a (slot, kv head)'s
R = group * q_len rows, up to ``MMA_ROWS`` a pass, and passes beyond.
"""

import os
import re

import pytest
import torch

from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.attention import paged
from test_torch_model import one_torch_thread  # noqa: F401

CODE = {0: torch.float32, 1: torch.bfloat16, 2: torch.float16}


def _source():
    path = os.path.join(os.path.dirname(_build.__file__), os.pardir, "csrc",
                        "paged_decode.cu")
    with open(path) as f:
        return f.read()


def test_design_matches_the_c_dispatch():
    """Every (mode, q dtype, pool) of ``paged.DESIGN`` has exactly one
    dispatch line in the CUDA source, launching the design it names: the
    tensor cores (``launch_mma``) for the verify mode in bf16 and fp16
    over float and int8 pools; the CUDA cores (``launch_fma``) for the
    decode mode and for float32 q. A float16 q over int8 pools has its
    two lines, as a bf16 q has. The source is built once per head dim of
    ``paged.HEAD_DIMS``, each library dispatching at its own width (and
    its run-time head dim build at the multiples of 8 below it)."""
    lines = re.findall(r"if \(dtype == (\d) && quant == (\d) && verify == (\d)\) "
                       r"return launch_(fma|mma)<", _source())
    found = {}
    for c, quant, verify, design in lines:
        key = ("verify" if verify == "1" else "decode", CODE[int(c)],
               "int8" if quant == "1" else "float")
        assert key not in found, key
        found[key] = design
    assert found == paged.DESIGN
    assert len(found) == 12
    for dtype in (torch.bfloat16, torch.float16):
        for pool in ("float", "int8"):
            assert paged.DESIGN[("verify", dtype, pool)] == "mma"
            assert paged.DESIGN[("decode", dtype, pool)] == "fma"
    assert all(paged.DESIGN[(m, torch.float32, pool)] == "fma"
               for m in ("decode", "verify") for pool in ("float", "int8"))
    src = _source()
    assert "return dispatch<DS_HEAD_DIM>(p, dtype, quant" in src
    assert "takes_head_dim<DS_HEAD_DIM>(head_dim)" in src
    assert list(_build._libraries(["paged_decode"])) == [
        ("paged_decode", w, False) for w in paged.HEAD_DIMS]


def test_mma_tiers_match_the_c_launcher():
    """``launch_mma`` takes the rows a pass that ``MMA_TILES`` lists: 16
    and 32 at every head dim, 64 (four m16 tiles) only where
    ``mma_max_tiles`` allows four, at head dims 32 and 64 (R x tile width
    / 32 accumulator registers a lane, held at 128; 72 runs in 80)."""
    src = _source()
    body = src[src.index("cudaError_t launch_mma("):]
    body = body[:body.index("\n}\n")]
    rows = {int(r): int(t) for r, t in re.findall(
        r"if \(rt == (\d+)\) return launch_tiles<T, TK, D, (\d)>", body)}
    assert rows == {16: 1, 32: 2, 64: 4}
    assert "if constexpr (mma_max_tiles<D>() >= 4)" in body
    assert "return 128 / (16 * tile_width(D) / 32);" in src
    assert paged.MMA_TILES == {32: (1, 2, 4), 64: (1, 2, 4), 72: (1, 2),
                               96: (1, 2), 128: (1, 2)}
    assert paged.MMA_ROWS == {32: 64, 64: 64, 72: 32, 96: 32, 128: 32}
    for d, tiles in paged.MMA_TILES.items():
        tile_width = -(-d // 16) * 16
        assert (4 in tiles) == (128 // (16 * tile_width // 32) >= 4), d


@pytest.mark.parametrize("D", sorted(paged.MMA_TILES))
def test_mma_plan_for_every_row_count(D):
    """For R = 1 .. 2 * MMA_ROWS + 3: the pass holds the fewest m16 tiles
    the rows need, up to the cap; the passes of rt rows cover R and no
    pass is empty; a CTA takes at least 8 units a warp, and the splits
    cover a full table (all from the shapes, never from the lengths)."""
    cap = paged.MMA_ROWS[D]
    for R in range(1, 2 * cap + 4):
        p = paged.plan(8, 8, R, 64, 16, 132, "mma", D)
        assert p == paged.plan.__wrapped__(8, 8, R, 64, 16, 132, "mma", D)
        assert p.rt // 16 in paged.MMA_TILES[D] and p.rt <= cap
        if R <= cap:
            assert p.npass == 1
            assert p.rt == 16 * min(t for t in paged.MMA_TILES[D]
                                    if 16 * t >= R)
        else:
            assert p.rt == cap
        assert (p.npass - 1) * p.rt < R <= p.npass * p.rt
        assert paged.MIN_CHUNK_MMA <= p.chunk <= paged.MAX_CHUNK
        assert p.nsplit == -(-64 * 16 // paged.UNIT // p.chunk)


def test_mma_plan_at_the_verify_shapes():
    """The spec path's verify (llama-7b, 8 slots, q_len 5, group 1: five
    rows) takes one m16 tile and 32 units a CTA, so four splits for a full
    table; GQA verify at group 8 (40 rows) one pass at head dim 64 and
    two of 32 rows at head dim 128; the CUDA-core plan of the same shapes
    is unchanged."""
    assert paged.plan(8, 32, 5, 128, 16, 132, "mma", 128) == \
        paged.PagedPlan(rt=16, npass=1, chunk=32, nsplit=4)
    assert paged.plan(8, 32, 5, 128, 16) == \
        paged.PagedPlan(rt=16, npass=1, chunk=16, nsplit=8)
    assert paged.plan(8, 4, 40, 128, 16, 132, "mma", 64)[:2] == (64, 1)
    assert paged.plan(8, 4, 40, 128, 16, 132, "mma", 128)[:2] == (32, 2)
    assert paged.plan(8, 4, 40, 128, 16)[:2] == (16, 3)

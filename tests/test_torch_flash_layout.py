"""What the flash wrapper and the kernel builder check on the host: the
16-byte layout the tensor-core kernels read (``flash.kernel_layout``), the
design each dtype runs (flash and block-sparse), and that a library is named by the headers its
source includes as well as by the source."""

import os
import re

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.attention import flash
from deepspeed_tpu_torch.ops.sparse_attention import blocksparse


def _fused_qkv(B, S, H, Hkv, D, dtype, offset=0):
    """q, k, v [B, S, heads, D] as views of one fused projection, as
    ``models/gpt.py`` splits it; ``offset`` elements of lead-in shift every
    view's base pointer."""
    rng = np.random.default_rng(0)
    width = H * D + 2 * Hkv * D
    flat = torch.from_numpy(rng.standard_normal((B, S, width + offset),
                                                np.float32)).to(dtype)
    qkv = flat[..., offset:]
    q, k, v = torch.split(qkv, [H * D, Hkv * D, Hkv * D], dim=-1)
    return tuple(t.reshape(B, S, -1, D) for t in (q, k, v))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_aligned_views_are_not_copied(dtype):
    q, k, v = _fused_qkv(2, 8, 4, 2, 64, dtype)
    assert not q.is_contiguous()
    for t in (q, k, v):
        assert flash.kernel_layout(t) is t
    got = flash._kernel_args(q, k, v, None, None)[:3]
    assert all(a is b for a, b in zip(got, (q, k, v)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_misaligned_views_are_copied(dtype):
    # one element of lead-in: every base pointer is 2 bytes off 16
    q, k, v = _fused_qkv(2, 8, 4, 2, 64, dtype, offset=1)
    assert q.data_ptr() % 16 != 0
    got = flash._kernel_args(q, k, v, None, None)[:3]
    for a, b in zip(got, (q, k, v)):
        assert a is not b and a.is_contiguous() and a.data_ptr() % 16 == 0
        assert torch.equal(a, b)
    # rows of 72 elements are 16-byte aligned; of 4 * 64 + 1 they are not
    wide = torch.zeros(2, 8, 4, 72, dtype=dtype)[..., :64]
    odd = torch.zeros(2, 8, 4 * 64 + 1, dtype=dtype)[..., :256].reshape(
        2, 8, 4, 64)
    assert flash.kernel_layout(wide) is wide
    copied = flash.kernel_layout(odd)
    assert copied is not odd and copied.is_contiguous()
    # a contiguous view at a misaligned offset is copied too: contiguous()
    # alone would hand it back as it is
    base = torch.zeros(1 + 2 * 8 * 4 * 64, dtype=dtype)[1:].reshape(
        2, 8, 4, 64)
    assert base.is_contiguous() and base.data_ptr() % 16 != 0
    moved = flash.kernel_layout(base)
    assert moved is not base and moved.data_ptr() % 16 == 0


def test_design_by_dtype():
    """``flash.DESIGN`` names what the C entry points choose: the launcher
    each (dtype code, head dim) line of ``ds_flash_fwd`` and of
    ``dispatch`` in flash_bwd.cu calls (``dispatch`` takes K2-dq's and
    K2-dkv's launchers from one ``DS_CASE`` line); likewise
    ``blocksparse.DESIGN`` for K5, by the dtype lines of
    ``ds_blocksparse_fwd``."""
    code = {c: dt for dt, c in flash._DTYPE_CODE.items()}
    csrc = os.path.join(os.path.dirname(_build.__file__), os.pardir, "csrc")
    with open(os.path.join(csrc, "flash_fwd.cu")) as f:
        fwd = re.findall(r"if \(dtype == (\d) && head_dim == (\d+)\) "
                         r"return launch_(fma|mma)<", f.read())
    with open(os.path.join(csrc, "flash_bwd.cu")) as f:
        bwd_src = f.read()
    bwd = re.findall(r"DS_CASE\((\d), \w+, (\d+), (fma|mma)\)", bwd_src)
    # one DS_CASE line names the design of both backward kernels
    assert "DQ ? launch_dq_##DESIGN<T, D>(p, s) : " \
        "launch_dkv_##DESIGN<T, D>(p, s)" in bwd_src
    for design in ("fma", "mma"):
        assert f"cudaError_t launch_dq_{design}(" in bwd_src
        assert f"cudaError_t launch_dkv_{design}(" in bwd_src
    found = {}
    for kernel, lines in (("K1-fwd", fwd), ("K2-dq", bwd), ("K2-dkv", bwd)):
        assert len(lines) == len(code) * len(flash.HEAD_DIMS), kernel
        for c, d, design in lines:
            found.setdefault((kernel, code[int(c)]), set()).add(design)
    assert found == {key: {d} for key, d in flash.DESIGN.items()}
    assert flash.DESIGN[("K1-fwd", torch.float32)] == "fma"
    for kernel in ("K2-dq", "K2-dkv"):
        assert flash.DESIGN[(kernel, torch.float32)] == "fma"
        assert flash.DESIGN[(kernel, torch.bfloat16)] \
            == flash.DESIGN[(kernel, torch.float16)] == "mma"

    with open(os.path.join(csrc, "blocksparse_fwd.cu")) as f:
        bs = re.findall(r"if \(dtype == (\d)\) return launch_(fma|mma)<",
                        f.read())
    assert len(bs) == len(code)
    assert {code[int(c)]: d for c, d in bs} == blocksparse.DESIGN
    assert blocksparse.DESIGN[torch.float32] == "fma"
    assert blocksparse.DESIGN[torch.bfloat16] \
        == blocksparse.DESIGN[torch.float16] == "mma"


def test_flash_sources_include_the_shared_header():
    for name in ("flash_fwd", "flash_bwd", "paged_decode", "int8_matmul"):
        names = [os.path.basename(p) for p in _build._sources(name)]
        assert names == [f"{name}.cu", "flash_mma.cuh"]


def test_an_edited_header_renames_the_library(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n#include <stdint.h>\n')
    (tmp_path / "h.cuh").write_text('#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    assert [os.path.basename(p) for p in _build._sources("k")] == [
        "k.cu", "h.cuh", "g.cuh"]
    before = _build._target("k")
    assert _build._target("k") == before
    (tmp_path / "g.cuh").write_text("// two\n")
    edited = _build._target("k")
    assert edited != before and os.path.basename(edited).startswith("k-")

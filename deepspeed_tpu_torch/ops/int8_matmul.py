"""Weight-only int8 dequant-matmul: the CUDA kernel ``csrc/int8_matmul.cu``
(K4) and its plain PyTorch version.

Port of ``deepspeed_tpu/ops/int8_matmul.py``: ``x [M, K] @ dequant(q [K,
N] int8, scale [1, N] fp32) -> [M, N]`` in x's dtype, with the weight read
from device memory as int8 (in the JAX layout, never re-laid out) and the
per-output-channel scale applied once to the fp32 sum. The TPU kernel's
tile arguments (``block_m``, ``block_n``, ``block_k``) are not ported: the
tiles are the kernel's, chosen per shape by :func:`plan`:

- bf16 x, M <= 16 (decode): ``mma.sync`` tiles of 16 rows x 128 columns,
  64 k rows per stage, the int8 weight widened in registers; K split so
  that about four CTAs per SM keep weight loads in flight.
- bf16 x, M > 16 (a prefill chunk, ``generate``'s prompt): ``wgmma``
  tiles of 128 or 256 rows (every row of a prefill chunk) x 128 weight
  columns, x and the int8 weight brought by TMA, the weight widened once
  per CTA straight into wgmma's A registers (the product runs
  transposed); the K split is the one of least modelled time on the
  card's SMs, counting the fp32 partials a split writes and reads. Shapes
  TMA cannot read (K not a multiple of 8, N not one of 16, unaligned
  bases) take the decode kernel in row tiles of 16.
- float32 x: CUDA-core tiles of 32 x 64, 32 k rows per stage.

There is no implementation switch: a CPU tensor goes through
:func:`int8_matmul_reference` (the dequantize-then-multiply of the JAX
package's ``gpt._kernel_of``), a CUDA tensor launches the kernel or
raises.
"""

import functools
from typing import NamedTuple

import torch

from deepspeed_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNELS = ("fma", "mma", "wgmma")   # the C entry point's kernel codes 0, 1, 2
BK = 64                     # k rows per stage of the tensor-core kernels
DEC_MAX_M, DEC_BN = 16, 128
# decode: about 2.5 CTAs per SM, each split at least 8 stages long (on an
# NVIDIA H100 80GB HBM3 at 700.00 W, four CTAs per SM, or shorter splits,
# lose to the splits' ramp and tail)
DEC_MIN_STAGES = 8
WG_BN = 128                 # weight columns per CTA of the wgmma kernel
FBM, FBN, FBK = 32, 64, 32  # the float32 kernel's tiles
MAX_SPLITS = 8
# the plan's model of a wgmma CTA: a 64-deep stage takes about the same
# time at any M up to 256 (~0.7 us on an NVIDIA H100 80GB HBM3 at 700.00
# W); fp32 partials move at ~3 TB/s, written once and read once, and the
# reduce launch adds ~3 us
_STAGE_US = 0.7
_BYTES_PER_US = 3.0e6
_REDUCE_US = 3.0


class Int8Plan(NamedTuple):
    kernel: str         # "fma" (float32 x), "mma" (M <= 16), "wgmma"
    bm: int             # rows per CTA
    bn: int             # columns per CTA
    kps: int            # k stages per split
    splits: int         # K splits (1: no partials)
    partial_bytes: int  # fp32 partials the splits write (read once more)


def _split(ktiles: int, want: int, least: int = 4):
    """(k stages per split, splits) for about ``want`` splits of at least
    ``least`` stages each, the last one possibly shorter."""
    s = max(1, min(want, ktiles // least))
    kps = -(-ktiles // s)
    return kps, -(-ktiles // kps)


@functools.lru_cache(maxsize=None)
def plan(M: int, N: int, K: int, dtype_code: int, sms: int = 132,
         aligned: bool = True) -> Int8Plan:
    """The kernel, tiles and K split of one ``int8_matmul`` shape on a card
    of ``sms`` SMs (``dtype_code``: 0 float32 x, 1 bfloat16 x; ``aligned``:
    x and the weight can be read by TMA, i.e. K a multiple of 8, N of 16,
    both bases 16-byte aligned; else bf16 x at any M takes the ``mma``
    kernel in row tiles of 16). A pure function of its arguments."""
    if dtype_code == 0:
        tiles = -(-N // FBN) * -(-M // FBM)
        kps, splits = _split(-(-K // FBK), -(-4 * sms // tiles))
        return Int8Plan("fma", FBM, FBN, kps, splits,
                        4 * splits * M * N if splits > 1 else 0)
    ktiles = -(-K // BK)
    if M <= DEC_MAX_M or not aligned:
        tiles = -(-N // DEC_BN) * -(-M // DEC_MAX_M)
        kps, splits = _split(ktiles, -(-5 * sms // (2 * tiles)),
                             DEC_MIN_STAGES)
        return Int8Plan("mma", DEC_MAX_M, DEC_BN, kps, splits,
                        4 * splits * M * N if splits > 1 else 0)
    bm = 128 if M <= 128 else 256
    tiles = -(-M // bm) * -(-N // WG_BN)
    best = None
    for want in range(1, MAX_SPLITS + 1):
        kps, splits = _split(ktiles, want)
        waves = -(-(tiles * splits) // sms)
        part = 4 * splits * M * N if splits > 1 else 0
        us = waves * kps * _STAGE_US
        if part:
            us += _REDUCE_US + 2 * part / _BYTES_PER_US
        if best is None or round(us, 6) < best[0]:
            best = (round(us, 6), Int8Plan("wgmma", bm, WG_BN, kps, splits,
                                           part))
    return best[1]


def grid_of(p: Int8Plan, M: int, N: int):
    """The launch grid of plan ``p``, as ``ds_int8_matmul`` builds it."""
    if p.kernel == "wgmma":
        return (-(-M // p.bm), -(-N // p.bn), p.splits)
    if p.kernel == "mma":
        return (-(-N // p.bn), p.splits, -(-M // p.bm))
    return (-(-N // p.bn), -(-M // p.bm), p.splits)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def int8_matmul_reference(x, q, scale):
    """``x @ (q * scale)`` with the weight dequantized to x's dtype first,
    as ``deepspeed_tpu/ops/int8_matmul.py int8_matmul_reference``."""
    return x @ (q.to(x.dtype) * scale.to(x.dtype))


def int8_matmul(x, q, scale):
    """x [M, K] float32 or bfloat16, q [K, N] int8, scale [1, N] (or [N])
    float32 -> [M, N] in x's dtype."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: no kernel for device {x.device}")
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"int8_matmul takes x [M, K] and q [K, N], got "
                         f"{tuple(x.shape)} and {tuple(q.shape)}")
    M, K = x.shape
    N = q.shape[1]
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"int8_matmul takes float32 or bfloat16 x, got "
                         f"{x.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32 \
            or scale.numel() != N:
        raise ValueError(f"int8_matmul takes an int8 weight and {N} float32 "
                         f"scales, got {q.dtype} and {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if not (q.device == x.device == scale.device):
        raise ValueError("int8_matmul: x, q and scale must share a device")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8_matmul takes a contiguous weight and scale")
    if K < 1 or N < 1:
        raise ValueError(f"int8_matmul needs K, N >= 1, got {K}, {N}")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    x = x.contiguous()
    code = _DTYPE_CODE[x.dtype]
    # 16-byte loads (cp.async, TMA) need 16-byte aligned rows and bases
    vec_x = int(x.data_ptr() % 16 == 0 and (K * x.element_size()) % 16 == 0)
    vec_q = int(q.data_ptr() % 16 == 0 and N % 16 == 0)
    p = plan(M, N, K, code, _sms(x.device.index or 0), bool(vec_x and vec_q))
    part = torch.empty((p.splits, M, N) if p.splits > 1 else (0,),
                       dtype=torch.float32, device=x.device)
    lib = _build.load("int8_matmul")
    err = lib.ds_int8_matmul(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        part.data_ptr(), KERNELS.index(p.kernel), M, N, K, p.bn, p.bm // 128,
        p.kps, p.splits, vec_x, vec_q,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return out


# launches of the CUDA kernel since the last reset
int8_matmul.launches = 0

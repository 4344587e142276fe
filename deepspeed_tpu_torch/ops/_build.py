"""Build and load the port's CUDA kernels.

Counterpart of ``deepspeed_tpu/ops/op_builder.py``. Each source in
``deepspeed_tpu_torch/csrc/`` is compiled on first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface under
``<repo>/build/torch_kernels/``, and loaded with ``ctypes``. The library's
file name carries a hash of the flags, the source and the headers it
includes from ``csrc/`` (``flash_mma.cuh``), so an edited source or header
is rebuilt and a stale library is never loaded. PyTorch's own extension
builder is not used: a source that includes PyTorch's headers takes
minutes to compile, a plain C one seconds.

The attention kernels (``flash_fwd``, ``flash_bwd``, ``paged_decode``)
are built once per head dim of :data:`HEAD_DIMS`, a library each
(``-DDS_HEAD_DIM=<width>``), so that the widths compile in parallel. A
multiple of 8 between two widths runs in a second build of the wider one
(``-DDS_RUNTIME_D``), which takes its head dim at run time and is built
at its first use (:func:`head_dim_build`); the wrappers zero-pad only a
head dim that is not a multiple of 8. The flash kernels' ring modes
(``q_off``, the keys' own segment ids, fp32 gradients) are a third build
of a width (``-DDS_RING``, library ``flash_fwd-d128ring`` etc.), built at
its first use as well (``load(name, head_dim, ring=True)``).

Each C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise on a nonzero value. Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the head dims the attention kernels are built for: the widths of the
# presets (llama-tiny 32; gpt2 and BERT 64; gpt2-4b 72; gpt2-8b 96; llama
# 128), each compiled as it is (72 runs in 80-wide tensor-core tiles
# whose last columns are zero-filled in the kernel)
HEAD_DIMS = (32, 64, 72, 96, 128)
PER_HEAD_DIM = ("flash_fwd", "flash_bwd", "paged_decode")
# the sources with a ring-mode build (-DDS_RING)
RING_SOURCES = ("flash_fwd", "flash_bwd")


def head_dim_width(D: int) -> int:
    """The width of :data:`HEAD_DIMS` a head dim of ``D`` runs at: the
    smallest at or above it. Above 128 the kernels raise."""
    for w in HEAD_DIMS:
        if D <= w:
            return w
    raise ValueError(f"the attention kernels take head dims up to "
                     f"{HEAD_DIMS[-1]}, got {D}")


def head_dim_build(D: int) -> Tuple[int, int, bool]:
    """How the attention kernels run a head dim of ``D``: ``(Dk, width,
    runtime)``. ``Dk`` is ``D`` rounded up to a multiple of 8, what the
    wrappers zero-pad q, k, v (and K3's pools) to, as the JAX package's
    ``_pad_heads`` does; ``width`` is the build's (:func:`head_dim_width`);
    ``runtime`` says that ``Dk`` is not a width of :data:`HEAD_DIMS` and
    runs in the width's ``-DDS_RUNTIME_D`` build, which takes it at run
    time."""
    width = head_dim_width(D)   # the widths are multiples of 8: Dk's too
    Dk = -(-D // 8) * 8
    return Dk, width, Dk != width


# C signature of each library: {symbol: (argtypes, restype)}
_VP, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
SIGNATURES = {
    "flash_fwd": {"ds_flash_fwd": (
        [_VP] * 7 + [_I] * 7 + [_LL] * 9 + [_F, _I, _I, _VP], _I)},
    "flash_bwd": {
        "ds_flash_bwd_dq": (
            [_VP] * 9 + [_I] * 7 + [_LL] * 12 + [_F, _I, _I, _VP], _I),
        "ds_flash_bwd_dkv": (
            [_VP] * 10 + [_I] * 7 + [_LL] * 12 + [_F, _I, _I, _VP], _I)},
    "paged_decode": {"ds_paged_decode": (
        [_VP] * 10 + [_I] * 13 + [_F, _I, _VP], _I)},
    "int8_matmul": {"ds_int8_matmul": ([_VP] * 5 + [_I] * 10 + [_VP], _I)},
    "blocksparse_fwd": {"ds_blocksparse_fwd": (
        [_VP] * 6 + [_I] * 7 + [_LL] * 9 + [_F, _I] + [_VP] * 5 + [_I] * 5
        + [_VP], _I)},
}

# the entry points of the ring-mode builds (-DDS_RING) of RING_SOURCES
RING_SIGNATURES = {
    "flash_fwd": {"ds_flash_fwd_ring": (
        [_VP] * 8 + [_I] * 7 + [_LL] * 9 + [_F, _I, _I, _I, _VP], _I)},
    "flash_bwd": {
        "ds_flash_bwd_dq_ring": (
            [_VP] * 10 + [_I] * 7 + [_LL] * 12 + [_F, _I, _I, _I, _VP], _I),
        "ds_flash_bwd_dkv_ring": (
            [_VP] * 11 + [_I] * 7 + [_LL] * 12 + [_F, _I, _I, _I, _VP], _I)},
}

_lock = threading.Lock()
_loaded: Dict[tuple, ctypes.CDLL] = {}   # by (name, width, runtime[, True])
# per library: {"seconds": nvcc wall time, "ptxas": the -Xptxas -v report}
build_info: Dict[str, Dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): the port's "
            "CUDA kernels are built from source at first use")
    return path


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(name: str) -> List[str]:
    """``csrc/<name>.cu`` and every header it includes with quotes,
    recursively (paths relative to the including file)."""
    todo, seen = [os.path.join(CSRC, f"{name}.cu")], []
    while todo:
        path = os.path.normpath(todo.pop())
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            for inc in _LOCAL_INCLUDE.findall(f.read()):
                todo.append(os.path.join(os.path.dirname(path),
                                         inc.decode()))
    return seen


def _flags(width: Optional[int], runtime: bool = False,
           ring: bool = False) -> tuple:
    if width is None:
        return NVCC_FLAGS
    return (*NVCC_FLAGS, f"-DDS_HEAD_DIM={width}",
            *(("-DDS_RUNTIME_D",) if runtime else ()),
            *(("-DDS_RING",) if ring else ()))


def library(name: str, width: Optional[int] = None,
            runtime: bool = False, ring: bool = False) -> str:
    """The key of one library in ``build_info``: the source's name, with
    ``-d<width>`` for the attention kernels' per-head-dim builds, ``rt``
    after it for a width's run-time head dim build and ``ring`` for the
    flash kernels' ring-mode build."""
    if width is None:
        return name
    return f"{name}-d{width}{'rt' if runtime else ''}{'ring' if ring else ''}"


def _target(name: str, width: Optional[int] = None,
            runtime: bool = False, ring: bool = False) -> str:
    """The library's path, named by a hash of the flags, the source and
    every header it includes: an edited header is rebuilt too."""
    digest = hashlib.sha256(" ".join(_flags(width, runtime, ring)).encode())
    for path in _sources(name):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    key = library(name, width, runtime, ring)
    return os.path.join(BUILD_DIR, f"{key}-{digest.hexdigest()[:16]}.so")


def _libraries(names: Iterable[str]):
    """(name, width, runtime) of every library the sources ``names`` build
    up front: one per head dim of :data:`HEAD_DIMS` for the attention
    kernels, else one. The run-time head dim builds wait for their first
    use."""
    for name in names:
        for width in (HEAD_DIMS if name in PER_HEAD_DIM else (None,)):
            yield name, width, False


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, Dict]:
    """Compile every library of the named sources that is not built yet,
    one nvcc per library, all started together. Returns ``build_info``,
    keyed by :func:`library`."""
    return _build(list(_libraries(names)))


def ring_libraries(head_dims: Iterable[int]) -> List[tuple]:
    """The ring-mode builds (:data:`RING_SOURCES`) that run head dims
    ``head_dims``, as :func:`_build` takes them."""
    return sorted({(name, *head_dim_build(d)[1:], True)
                   for d in head_dims for name in RING_SOURCES})


def _build(libs) -> Dict[str, Dict]:
    """Compile the libraries ``libs`` ((name, width, runtime[, ring])
    each) that are not built yet, one nvcc each, all started together."""
    with _lock:
        t0 = time.perf_counter()
        started = {}
        for lib in libs:
            name, width, runtime, ring = (*lib, False)[:4]
            key = library(name, width, runtime, ring)
            out = _target(name, width, runtime, ring)
            if os.path.exists(out):
                build_info.setdefault(key, {"seconds": 0.0,
                                            "ptxas": "(cached)"})
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            # build into a private name, then rename: a concurrent loader
            # never sees a half-written library
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *_flags(width, runtime, ring), "-o", tmp,
                   os.path.join(CSRC, f"{name}.cu")]
            started[key] = (tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        for key, (tmp, out, proc) in started.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {key} "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)
            build_info[key] = {"seconds": time.perf_counter() - t0,
                               "ptxas": log}
    return build_info


def load(name: str, head_dim: Optional[int] = None,
         ring: bool = False) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed; the attention
    kernels' for ``head_dim``, a multiple of 8 up to 128: its width's
    build, or the width's run-time build for a head dim between two
    widths; with ``ring``, the flash kernels' ring-mode build of that
    width), with every C entry point's ``argtypes``/``restype``
    declared."""
    if (head_dim is None) != (name not in PER_HEAD_DIM) or (
            head_dim is not None and (head_dim % 8 or head_dim < 8)) or (
            ring and name not in RING_SOURCES):
        raise ValueError(f"{name}: no library at head dim {head_dim}"
                         f"{' in ring modes' if ring else ''}")
    lib_key = (name, None, False) if head_dim is None \
        else (name, *head_dim_build(head_dim)[1:], *((True,) if ring else ()))
    lib = _loaded.get(lib_key)
    if lib is not None:
        return lib
    _build([lib_key])
    with _lock:
        if lib_key not in _loaded:
            lib = ctypes.CDLL(_target(*lib_key))
            sigs = (RING_SIGNATURES if ring else SIGNATURES)[name]
            for sym, (args, res) in sigs.items():
                fn = getattr(lib, sym)
                fn.argtypes, fn.restype = args, res
            _loaded[lib_key] = lib
    return _loaded[lib_key]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

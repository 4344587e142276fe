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
from typing import Dict, Iterable, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
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


def _target(name: str) -> str:
    """The library's path, named by a hash of the flags, the source and
    every header it includes: an edited header is rebuilt too."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, Dict]:
    """Compile every named library that is not built yet, one nvcc per
    source, all started together. Returns ``build_info``."""
    with _lock:
        t0 = time.perf_counter()
        started = {}
        for name in names:
            out = _target(name)
            if os.path.exists(out):
                build_info.setdefault(name, {"seconds": 0.0,
                                             "ptxas": "(cached)"})
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            # build into a private name, then rename: a concurrent loader
            # never sees a half-written library
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, f"{name}.cu")]
            started[name] = (tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        for name, (tmp, out, proc) in started.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {name}.cu "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)
            build_info[name] = {"seconds": time.perf_counter() - t0,
                                "ptxas": log}
    return build_info


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with every C
    entry point's ``argtypes``/``restype`` declared."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(_target(name))
            for sym, (args, res) in SIGNATURES[name].items():
                fn = getattr(lib, sym)
                fn.argtypes, fn.restype = args, res
            _loaded[name] = lib
    return _loaded[name]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

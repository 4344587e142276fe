"""Build report of the attention kernels' libraries, and their machine
code against another checkout's.

    python -m deepspeed_tpu_torch.tools.kernel_builds [--against OTHER]

Builds every library of ``flash_fwd``, ``flash_bwd`` and
``paged_decode``: each width of ``_build.HEAD_DIMS``, each width's
run-time head dim build (``-DDS_RUNTIME_D``; 72 has none: no multiple of
8 lies between 64 and it) and the flash kernels' ring-mode build of each
width (``-DDS_RING``), all nvcc jobs at once, and prints one JSON line per
library: its build seconds, its kernels and the spill bytes ptxas reports
for any of them. With ``--against OTHER``, the checkout at
``OTHER`` builds its width libraries in a process of its own (into its
own ``build/``), and each width's library is compared kernel by kernel
in SASS (``cuobjdump -sass``): one JSON line per library with the
kernels whose instructions differ, and for each the first differing
pairs. Needs ``nvcc`` and ``cuobjdump`` (``CUDA_HOME`` or
``/usr/local/cuda``); no card.
"""

import argparse
import glob
import json
import os
import re
import subprocess
import sys
from typing import Dict, List

from deepspeed_tpu_torch.ops import _build

# the anonymous namespace's mangled name carries a hash of the source
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")


def spills(ptxas_log: str) -> Dict[str, int]:
    """{kernel: spill store bytes} of every kernel in an ``-Xptxas -v``
    log."""
    out, name = {}, None
    for line in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _ANON.sub("", m.group(1))
            out[name] = 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name] = int(m.group(1))
    return out


def sass(text: str) -> Dict[str, List[str]]:
    """{kernel: its instructions} of a ``cuobjdump -sass`` listing, with
    addresses, encodings and the namespace's hash taken out."""
    funcs, name = {}, None
    for line in _ANON.sub("", text).splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if name and m:
            funcs[name].append(m.group(1))
    return funcs


def _cuobjdump(path: str) -> str:
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another checkout of the repository")
    args = ap.parse_args(argv)
    if args.against:
        args.against = os.path.abspath(args.against)
    names = _build.PER_HEAD_DIM
    other = None
    if args.against:
        other = subprocess.Popen([sys.executable, "-c", (
            "import sys; sys.path.insert(0, '.');"
            "from deepspeed_tpu_torch.ops import _build;"
            f"_build.build({list(names)!r})")], cwd=args.against)
    libs = [(n, w, rt) for n in names for w in _build.HEAD_DIMS
            for rt in (False, True)
            if not rt or _build.head_dim_build(w - 8)[1] == w]
    libs += _build.ring_libraries(_build.HEAD_DIMS)
    info = _build._build(libs)
    for lib in libs:
        key = _build.library(*lib)
        found = spills(info[key]["ptxas"])
        print(json.dumps({"library": key,
                          "seconds": round(info[key]["seconds"], 1),
                          "kernels": len(found),
                          "spills": {k: b for k, b in found.items() if b}}),
              flush=True)
    if other is None:
        return 0
    if other.wait() != 0:
        return 1
    for n in names:
        for w in _build.HEAD_DIMS:
            key = _build.library(n, w)
            mine = sass(_cuobjdump(_build._target(n, w)))
            theirs = glob.glob(os.path.join(
                args.against, "build", "torch_kernels", f"{key}-*.so"))
            if len(theirs) != 1:
                print(json.dumps({"library": key, "against": theirs}))
                return 1
            ref = sass(_cuobjdump(theirs[0]))
            differ = {k: [(a, b) for a, b in zip(ref[k], mine.get(k, []))
                          if a != b][:3]
                      for k in ref if ref[k] != mine.get(k)}
            print(json.dumps({
                "library": key, "kernels": len(ref),
                "same_kernels": sorted(ref) == sorted(mine),
                "instructions": sum(map(len, ref.values())),
                "differ": differ,
                "same_count": {k: len(ref[k]) == len(mine.get(k, []))
                               for k in differ}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port stands alone: deepspeed_tpu_torch and chip_smoke.py import
neither jax nor deepspeed_tpu, importing the package leaves jax unloaded,
and its entry points refuse to guess a device on a machine without CUDA.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "deepspeed_tpu")


def _port_sources():
    pkg = os.path.join(REPO, "deepspeed_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_no_jax_or_reference_imports():
    sources = list(_port_sources())
    assert len(sources) > 20
    bad = [(os.path.relpath(p, REPO), mod) for p in sources
           for mod in _imported_roots(p)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_import_leaves_jax_unloaded():
    code = ("import sys, deepspeed_tpu_torch\n"
            "import deepspeed_tpu_torch.inference.serving\n"
            "import deepspeed_tpu_torch.models.convert\n"
            "import deepspeed_tpu_torch.runtime.engine\n"
            "import deepspeed_tpu_torch.runtime.dataloader\n"
            "import deepspeed_tpu_torch.ops.cross_entropy\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deepspeed_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_need_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.paged_cache import PagedKVCache
    from deepspeed_tpu_torch.models import gpt
    cfg = gpt.preset("llama-tiny", n_layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt.init_params(cfg, seed=0)
    params = gpt.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_inference(model=(cfg, params))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(cfg, num_slots=1)

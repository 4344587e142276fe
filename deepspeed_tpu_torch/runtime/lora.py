"""LoRA adapters on the dense projections: add, merge, export, import.

Port of ``deepspeed_tpu/runtime/lora.py``. An adapted dense entry keeps
its frozen ``kernel`` (or int8 ``q``/``scale``) and gains ``lora_a [L, in,
r]``, ``lora_b [L, r, out]`` and ``lora_scale [L]``: the effective weight
is ``W0 + scale * A @ B``, and the forward takes the low-rank path
(``ops/layers.py dense``) without forming the delta. ``merge_lora`` folds
the adapters into the kernels for serving (merge first, then quantize).

The export format is the JAX package's, key for key: ``.npz`` entries
``block/<target>/lora_{a,b,scale}`` in float32, so a file saved by either
package loads in the other. Multi-tenant serving of unmerged adapters
(``inference/adapters.py``) reads the same export.

Training adapters (the JAX ``lora_optimizer`` and the config-driven
``lora`` section of its training engine) waits for the LoRA-training
slice: :func:`lora_optimizer` raises, and so does a training step over a
tree that holds ``lora_a`` leaves.
"""

import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

DEFAULT_TARGETS = ("qkv", "attn_out", "mlp_in", "mlp_gate", "mlp_out")

LORA_TRAINING = "LoRA-training"


def add_lora(params: Dict, generator: torch.Generator, rank: int = 8,
             alpha: float = 16.0,
             targets: Iterable[str] = DEFAULT_TARGETS) -> Dict:
    """``params`` with ``lora_a``/``lora_b``/``lora_scale`` added to every
    targeted dense entry (entries the model lacks, such as ``mlp_gate`` on
    a gelu model, are skipped). A ~ N(0, 1/rank) drawn from ``generator``
    (the JAX package's rate, not its bits), B = 0, so the adapted model
    starts exactly at the base model; ``lora_scale = alpha / rank`` carries
    the layer axis. The leaves are float32 on the kernel's device."""
    targets = set(targets)
    out = dict(params)
    out["block"] = {**params["block"]}
    block = out["block"]
    for name in sorted(targets):
        if name not in block or "kernel" not in block[name]:
            continue
        entry = dict(block[name])
        w = entry["kernel"]
        fan_in, fan_out = w.shape[-2], w.shape[-1]
        lead = tuple(w.shape[:-2])
        a = torch.randn(lead + (fan_in, rank), generator=generator,
                        device=generator.device, dtype=torch.float32)
        entry["lora_a"] = (a / math.sqrt(rank)).to(w.device)
        entry["lora_b"] = torch.zeros(lead + (rank, fan_out),
                                      dtype=torch.float32, device=w.device)
        entry["lora_scale"] = torch.full(lead, alpha / rank,
                                         dtype=torch.float32, device=w.device)
        block[name] = entry
    return out


def lora_label_tree(params: Dict) -> Dict:
    """``"train"`` on ``lora_a``/``lora_b`` leaves, ``"freeze"`` everywhere
    else (``lora_scale`` included: it is a hyperparameter)."""
    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return "train" if key in ("lora_a", "lora_b") else "freeze"
    return walk(params)


def has_lora(params: Dict) -> bool:
    """Whether any dense entry of ``params`` carries ``lora_a``."""
    if not isinstance(params, dict):
        return False
    return "lora_a" in params or any(has_lora(v) for v in params.values())


def lora_optimizer(base, params):
    """The JAX package's optax mask that trains only the adapter leaves;
    waits for the LoRA-training slice."""
    raise NotImplementedError(
        f"lora_optimizer (training only the adapter leaves) waits for the "
        f"{LORA_TRAINING} slice of the port")


def merge_lora(params: Dict) -> Dict:
    """Fold each adapter into its kernel (``W0 + scale * A @ B``, in the
    adapters' dtype, cast to the kernel's) and strip the lora keys: the
    serving form (quantize after merging)."""
    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        if "lora_a" not in tree:
            return {k: walk(v) for k, v in tree.items()}
        out = {k: v for k, v in tree.items() if not k.startswith("lora_")}
        delta = torch.matmul(tree["lora_a"], tree["lora_b"]) \
            * tree["lora_scale"][..., None, None]
        kern = tree["kernel"]
        out["kernel"] = kern + delta.to(kern.device, kern.dtype)
        return out
    return walk(params)


def count_trainable(params: Dict) -> Tuple[int, int]:
    """(adapter parameters, all parameters)."""
    train = total = 0

    def walk(tree, key=None):
        nonlocal train, total
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, k)
            return
        n = int(torch.as_tensor(tree).numel())
        total += n
        if key in ("lora_a", "lora_b"):
            train += n
    walk(params)
    return train, total


def adapter_state_dict(params: Dict) -> Dict[str, np.ndarray]:
    """Only the adapter leaves, keyed by their ``/``-joined path, as
    float32 numpy arrays (bf16 widens exactly): the JAX export."""
    out = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, prefix + (k,))
        elif prefix and prefix[-1].startswith("lora_"):
            t = torch.as_tensor(tree).detach()
            out["/".join(prefix)] = t.float().cpu().numpy()
    walk(params, ())
    return out


def save_adapter(params: Dict, path: str) -> None:
    """Write the adapters, and only them, to ``path`` (``.npz``)."""
    np.savez(path, **adapter_state_dict(params))


def load_adapter(params: Dict, path: str) -> Dict:
    """``params`` with the adapters of ``path`` attached: a bare base
    (entries gain lora keys) or an adapted tree (they are overwritten).
    The leaves land as float32 on the device of their entry's kernel. An
    adapter path with no matching entry raises ``KeyError``; a shape that
    does not fit the base kernel (``kernel``, or an int8 entry's ``q``)
    raises ``ValueError``. ``params`` itself is not changed."""
    out = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in params.items()}
    with np.load(path) as data:
        for flat in data.files:
            keys = flat.split("/")
            node = out
            for k in keys[:-1]:
                if not isinstance(node, dict) or k not in node:
                    raise KeyError(
                        f"adapter path {flat!r} has no matching entry in "
                        f"the base params (at {k!r})")
                if isinstance(node[k], dict):
                    node[k] = dict(node[k])
                node = node[k]
            if not isinstance(node, dict):
                raise KeyError(f"adapter path {flat!r} does not address a "
                               f"dense entry in the base params")
            leaf, val = keys[-1], data[flat]
            kern = node.get("kernel", node.get("q"))
            if kern is not None and leaf in ("lora_a", "lora_b"):
                ks = tuple(kern.shape)
                ok = (val.shape[:-1] == ks[:-1] if leaf == "lora_a"
                      else val.shape[:-2] == ks[:-2]
                      and val.shape[-1] == ks[-1])
                if not ok:
                    raise ValueError(
                        f"adapter {flat!r} shape {val.shape} does not "
                        f"match the base kernel's {ks}")
            device = kern.device if isinstance(kern, torch.Tensor) else "cpu"
            node[leaf] = torch.from_numpy(
                np.array(val, np.float32)).to(device)
    return out

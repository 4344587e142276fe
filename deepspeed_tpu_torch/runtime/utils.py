"""Runtime numeric utilities over the parameter dict: global norm,
clipping, parameter count. Port of ``deepspeed_tpu/runtime/utils.py``."""

from typing import Dict, Optional

import torch

from deepspeed_tpu_torch.tree import tree_leaves

NORM_CHUNK = 1 << 24       # elements of a leaf reduced at a time

def global_norm(tree: Dict) -> torch.Tensor:
    """L2 norm over every leaf as an fp32 0-dim tensor on the leaves'
    device (no host synchronisation). The squares are accumulated in
    float64: the host's fp32 running sum over a leaf of tens of millions
    of entries is off by ~1e-3, which the clipping factor would carry into
    every update. A leaf is taken ``NORM_CHUNK`` elements at a time, so
    that the float64 copy the reduction makes stays small beside the
    stacked ``[L, ...]`` leaves of a deep model."""
    leaves = list(tree_leaves(tree))
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    norms = [torch.linalg.vector_norm(c, 2, dtype=torch.float64)
             for t in leaves for c in t.reshape(-1).split(NORM_CHUNK)]
    return torch.linalg.vector_norm(torch.stack(norms), 2).float()


@torch.no_grad()
def clip_by_global_norm(tree: Dict, max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> Dict:
    """Scale every leaf in place so that the global norm is at most
    ``max_norm``; returns the tree."""
    if norm is None:
        norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for t in tree_leaves(tree):
        t.mul_(scale.to(t.device))
    return tree


def count_parameters(tree: Dict) -> int:
    return sum(t.numel() for t in tree_leaves(tree))

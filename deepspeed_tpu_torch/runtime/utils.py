"""Runtime numeric utilities over the parameter dict: global norm,
clipping, parameter count. Port of ``deepspeed_tpu/runtime/utils.py``."""

import math
from typing import Dict, Optional, Sequence

import torch

from deepspeed_tpu_torch.tree import tree_leaves

NORM_CHUNK = 1 << 24       # elements of a leaf reduced at a time

def sum_of_squares(tree: Dict, weights: Optional[Sequence[float]] = None
                   ) -> torch.Tensor:
    """The sum of the squares of every leaf's entries, a float64 0-dim
    tensor on the leaves' device (no host synchronisation); ``weights``:
    one factor per leaf (tree order). A leaf is taken ``NORM_CHUNK``
    elements at a time, so that the float64 copy the reduction makes
    stays small beside the stacked ``[L, ...]`` leaves of a deep model."""
    leaves = list(tree_leaves(tree))
    if not leaves:
        return torch.zeros((), dtype=torch.float64)
    weights = [1.0] * len(leaves) if weights is None else list(weights)
    norms, per = [], []
    for t, w in zip(leaves, weights):
        for c in t.reshape(-1).split(NORM_CHUNK):
            norms.append(torch.linalg.vector_norm(c, 2, dtype=torch.float64))
            per.append(w)
    sq = torch.stack(norms).square()
    if any(w != 1.0 for w in per):
        sq = sq * torch.tensor(per, dtype=torch.float64, device=sq.device)
    return sq.sum()


def global_norm(tree: Dict) -> torch.Tensor:
    """L2 norm over every leaf as an fp32 0-dim tensor on the leaves'
    device (no host synchronisation). The squares are accumulated in
    float64 (:func:`sum_of_squares`): the host's fp32 running sum over a
    leaf of tens of millions of entries is off by ~1e-3, which the
    clipping factor would carry into every update. Across data-parallel
    ranks the engine sums each rank's :func:`sum_of_squares` of its
    gradient slices (``runtime/zero/partition.py step_metrics``) and takes
    the root the same way."""
    if not list(tree_leaves(tree)):
        return torch.zeros((), dtype=torch.float32)
    return sum_of_squares(tree).sqrt().float()


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
    """Entries over every leaf (tensors, arrays, meta tensors: any leaf
    with a shape)."""
    return sum(math.prod(tuple(t.shape)) for t in tree_leaves(tree))

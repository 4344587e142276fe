"""Pipeline model description: layer lists, stage partitioning, tied
layers.

A copy of ``deepspeed_tpu/runtime/pipe/module.py`` (the reference's
``deepspeed/runtime/pipe/module.py:87``; ``LayerSpec`` :25,
``TiedLayerSpec`` :73, ``_partition_layers`` :363 with the ``uniform``,
``parameters`` and ``type:REGEX`` methods). A stage is one rank of the
mesh's ``pipe`` axis and a layer's parameters are rows of the stacked
tree, so this module does the arithmetic (which layer goes to which
stage, the tied groups) and hands it to the pipeline executor
(``runtime/pipe/engine.py``). ``LayerSpec.build`` takes a
``torch.Generator`` where the JAX one takes a key.
"""

import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from deepspeed_tpu_torch.utils.logging import logger


@dataclass
class LayerSpec:
    """Delayed layer construction (ref: module.py:25). ``build(gen)``, with
    ``gen`` a ``torch.Generator``, returns (params, apply_fn) where
    apply_fn(params, x, gen) -> y."""
    typename: str
    build: Callable  # (torch.Generator) -> (params, apply_fn)
    count_params: Optional[Callable] = None  # () -> int

    def param_count(self) -> int:
        return self.count_params() if self.count_params else 0


@dataclass
class TiedLayerSpec(LayerSpec):
    """Layer sharing weights with all layers of the same ``key``
    (ref: module.py:73). The pipeline executor replicates tied params
    across the stages that use them and sums their gradients over the
    ``pipe`` group (ref: PipelineEngine._exec_reduce_tied_grads
    engine.py:240)."""
    key: str = ""


def partition_uniform(num_items: int, num_parts: int) -> List[int]:
    """Balanced contiguous split; returns part boundaries len=num_parts+1
    (ref: deepspeed/runtime/utils.py partition_uniform)."""
    assert num_parts > 0
    parts = [0] * (num_parts + 1)
    chunk, rem = divmod(num_items, num_parts)
    for p in range(num_parts):
        parts[p + 1] = parts[p] + chunk + (1 if p < rem else 0)
    assert parts[-1] == num_items
    return parts


def partition_balanced(weights: Sequence[float], num_parts: int) -> List[int]:
    """Split minimizing the max part weight via binary search over the
    bottleneck (ref: deepspeed/runtime/utils.py partition_balanced)."""
    n = len(weights)
    assert num_parts > 0
    if num_parts >= n:
        return partition_uniform(n, num_parts)
    prefix = [0.0]
    for w in weights:
        prefix.append(prefix[-1] + w)

    def parts_for(bottleneck: float) -> Optional[List[int]]:
        parts = [0]
        for _ in range(num_parts):
            start = parts[-1]
            # furthest end with weight <= bottleneck
            end = start
            while end < n and prefix[end + 1] - prefix[start] <= bottleneck:
                end += 1
            if end == start:  # single item exceeds bottleneck
                return None
            parts.append(end)
        return parts if parts[-1] == n else None

    lo = max(weights) if weights else 0.0
    hi = prefix[-1]
    for _ in range(50):
        mid = (lo + hi) / 2
        if parts_for(mid) is None:
            lo = mid
        else:
            hi = mid
    parts = parts_for(hi)
    assert parts is not None
    return parts


class PipelineModule:
    """Partitions a layer list over pipeline stages.

    partition_method (ref: module.py:87 docstring):
      'uniform'       equal layer counts
      'parameters'    balance on per-layer parameter counts
      'type:REGEX'    balance on layers whose typename matches REGEX
    """

    def __init__(self, layers: List[LayerSpec], num_stages: int,
                 partition_method: str = "parameters",
                 loss_fn: Optional[Callable] = None):
        self.layers = list(layers)
        self.num_stages = num_stages
        self.partition_method = partition_method
        self.loss_fn = loss_fn
        self.parts = self._partition_layers()
        self.tied_groups = self._build_tied_groups()

    def _partition_layers(self) -> List[int]:
        method = self.partition_method.lower()
        n = len(self.layers)
        if method == "uniform":
            return partition_uniform(n, self.num_stages)
        if method == "parameters":
            weights = [max(1.0, float(l.param_count())) for l in self.layers]
            return partition_balanced(weights, self.num_stages)
        if method.startswith("type:"):
            pat = re.compile(method[5:], re.IGNORECASE)
            weights = [1.0 if pat.search(l.typename) else 0.0
                       for l in self.layers]
            if sum(weights) == 0:
                raise ValueError(f"no layers match {method}")
            return partition_balanced(weights, self.num_stages)
        raise NotImplementedError(f"partition method {method}")

    def _build_tied_groups(self) -> Dict[str, List[int]]:
        groups: Dict[str, List[int]] = {}
        for idx, spec in enumerate(self.layers):
            if isinstance(spec, TiedLayerSpec):
                groups.setdefault(spec.key, []).append(idx)
        return groups

    def stage_of_layer(self, layer_idx: int) -> int:
        for s in range(self.num_stages):
            if self.parts[s] <= layer_idx < self.parts[s + 1]:
                return s
        raise IndexError(layer_idx)

    def layers_of_stage(self, stage_id: int) -> List[int]:
        return list(range(self.parts[stage_id], self.parts[stage_id + 1]))

    def tied_stages(self, key: str) -> List[int]:
        return sorted({self.stage_of_layer(i) for i in self.tied_groups[key]})

    def describe(self) -> str:
        lines = []
        for s in range(self.num_stages):
            names = [self.layers[i].typename for i in self.layers_of_stage(s)]
            lines.append(f"stage {s}: {names}")
        return "\n".join(lines)

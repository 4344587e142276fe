"""JSON config file or dict -> typed configuration object.

Port of ``deepspeed_tpu/runtime/config.py`` for the training engine on
one device: the batch arithmetic, precision, optimizer, scheduler, the
gradient knobs, and the engine's features (``tensorboard``,
``wall_clock_breakdown``, ``flops_profiler``, ``progressive_layer_drop``,
``curriculum_learning``). The schema is the JAX package's. A section that
the port does not run yet (offload, LoRA, quantize-aware training,
elasticity, autotuning, a mesh of more than one device, compressed
communication) raises ``NotImplementedError`` when it is enabled, naming
the slice it waits for, instead of being silently ignored.
"""

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import torch


class DeepSpeedConfigError(Exception):
    pass


def _no_duplicate_keys(ordered_pairs):
    """Reject duplicate keys during JSON parsing."""
    d = dict(ordered_pairs)
    if len(d) != len(ordered_pairs):
        seen, dup = set(), []
        for k, _ in ordered_pairs:
            if k in seen:
                dup.append(k)
            seen.add(k)
        raise ValueError(f"Duplicate keys in DeepSpeed config: {dup}")
    return d


@dataclass
class FP16Config:
    enabled: bool = False
    loss_scale: float = 0.0          # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0

    @staticmethod
    def from_dict(d: Dict) -> "FP16Config":
        return FP16Config(
            enabled=d.get("enabled", False),
            loss_scale=d.get("loss_scale", 0),
            initial_scale_power=d.get("initial_scale_power", 16),
            loss_scale_window=d.get("loss_scale_window", 1000),
            hysteresis=d.get("hysteresis", 2),
            min_loss_scale=d.get("min_loss_scale", 1.0))


@dataclass
class BF16Config:
    enabled: bool = False
    # memory-efficient mode: bf16 master weights (stochastic-rounding
    # updates) and bf16 Adam moments, 8 bytes per parameter of training
    # state instead of 16
    memory_efficient: bool = False

    @staticmethod
    def from_dict(d: Dict) -> "BF16Config":
        return BF16Config(enabled=d.get("enabled", False),
                          memory_efficient=d.get("memory_efficient", False))


@dataclass
class ZeroConfig:
    """``zero_optimization``: the stage is accepted and, on one device,
    changes nothing (as in the JAX package on one chip); the offload tiers
    wait for their slice."""
    stage: int = 0

    @property
    def enabled(self) -> bool:
        return self.stage > 0

    @staticmethod
    def from_dict(d: Optional[Dict]) -> "ZeroConfig":
        if not d:
            return ZeroConfig()
        cfg = ZeroConfig(stage=d.get("stage", 0))
        if cfg.stage not in (0, 1, 2, 3):
            raise DeepSpeedConfigError(f"invalid zero stage {cfg.stage}")
        for key in ("offload_param", "offload_optimizer"):
            if (d.get(key) or {}).get("device", "none") != "none":
                raise NotImplementedError(
                    f"zero_optimization.{key} waits for the memory-tier "
                    f"(offload) slice")
        return cfg


@dataclass
class OptimizerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_dict(d: Optional[Dict]) -> "OptimizerConfig":
        if not d:
            return OptimizerConfig()
        return OptimizerConfig(type=d.get("type"),
                               params=d.get("params", {}) or {})


@dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_dict(d: Optional[Dict]) -> "SchedulerConfig":
        if not d:
            return SchedulerConfig()
        return SchedulerConfig(type=d.get("type"),
                               params=d.get("params", {}) or {})


@dataclass
class SparseAttentionConfig:
    """``sparse_attention``: the block-sparse pattern that
    ``ops.sparse_attention.build_sparsity_config`` instantiates (fields
    and defaults of the JAX package's ``SparseAttentionConfig``)."""
    mode: str = "fixed"
    block: int = 16
    different_layout_per_head: bool = False
    num_local_blocks: int = 4
    num_global_blocks: int = 1
    attention: str = "bidirectional"
    horizontal_global_attention: bool = False
    num_different_global_patterns: int = 1
    num_random_blocks: int = 0
    local_window_blocks: List[int] = field(default_factory=lambda: [4])
    global_block_indices: List[int] = field(default_factory=lambda: [0])
    global_block_end_indices: Optional[List[int]] = None
    num_sliding_window_blocks: int = 3

    @staticmethod
    def from_dict(d: Optional[Dict]) -> Optional["SparseAttentionConfig"]:
        if d is None:
            return None
        cfg = SparseAttentionConfig()
        for k, v in d.items():
            if hasattr(cfg, k):
                setattr(cfg, k, v)
        return cfg


@dataclass
class FlopsProfilerConfig:
    enabled: bool = False
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None

    @staticmethod
    def from_dict(d: Optional[Dict]) -> "FlopsProfilerConfig":
        if not d:
            return FlopsProfilerConfig()
        return FlopsProfilerConfig(
            enabled=d.get("enabled", False),
            profile_step=d.get("profile_step", 1),
            module_depth=d.get("module_depth", -1),
            top_modules=d.get("top_modules", 1),
            detailed=d.get("detailed", True),
            output_file=d.get("output_file"))


TENSORBOARD_JOB_NAME_DEFAULT = "DeepSpeedTPUJobName"


@dataclass
class TensorboardConfig:
    enabled: bool = False
    output_path: str = ""
    job_name: str = TENSORBOARD_JOB_NAME_DEFAULT

    @staticmethod
    def from_dict(d: Optional[Dict]) -> "TensorboardConfig":
        if not d:
            return TensorboardConfig()
        return TensorboardConfig(
            enabled=d.get("enabled", False),
            output_path=d.get("output_path", ""),
            job_name=d.get("job_name", TENSORBOARD_JOB_NAME_DEFAULT))


@dataclass
class PLDConfig:
    enabled: bool = False
    theta: float = 1.0
    gamma: float = 0.001

    @staticmethod
    def from_dict(d: Optional[Dict]) -> "PLDConfig":
        if not d:
            return PLDConfig()
        return PLDConfig(enabled=d.get("enabled", False),
                         theta=d.get("theta", 1.0),
                         gamma=d.get("gamma", 0.001))


@dataclass
class CurriculumConfig:
    enabled: bool = False
    curriculum_type: str = "seqlen"
    min_difficulty: int = 8
    max_difficulty: int = 1024
    schedule_type: str = "fixed_linear"
    schedule_config: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_dict(d: Optional[Dict]) -> "CurriculumConfig":
        if not d:
            return CurriculumConfig()
        return CurriculumConfig(
            enabled=d.get("enabled", False),
            curriculum_type=d.get("curriculum_type", "seqlen"),
            min_difficulty=d.get("min_difficulty", 8),
            max_difficulty=d.get("max_difficulty", 1024),
            schedule_type=d.get("schedule_type", "fixed_linear"),
            schedule_config=d.get("schedule_config", {}))


# sections that raise when enabled: {key: slice they wait for}
_LATER_SLICES = {
    "lora": "the LoRA slice",
    "quantize_training": "the quantize-aware-training (MoQ) slice",
    "elasticity": "the elasticity slice",
    "autotuning": "the autotuning slice",
}
_MESH_KEYS = ("tensor_parallel_size", "pipeline_parallel_size",
              "sequence_parallel_size", "expert_parallel_size",
              "replica_parallel_size")


class DeepSpeedConfig:
    """Typed view over the JSON config.

    config: path to a JSON file or an already-parsed dict. world_size: the
    data-parallel degree used to reconcile the batch sizes (1 on one
    card)."""

    def __init__(self, config: Union[str, Dict], world_size: int = 1):
        if isinstance(config, str):
            if not os.path.exists(config):
                raise DeepSpeedConfigError(
                    f"Expected a string path to an existing deepspeed "
                    f"config, but received: {config}")
            with open(config) as f:
                self._param_dict = json.load(
                    f, object_pairs_hook=_no_duplicate_keys)
        elif isinstance(config, dict):
            self._param_dict = config
        else:
            raise DeepSpeedConfigError(
                f"Expected a string path or dict, got {type(config)}")
        self.world_size = world_size
        self._initialize(self._param_dict)
        self._configure_train_batch_size()
        self._do_sanity_check()

    def _initialize(self, pd: Dict):
        self.train_batch_size = pd.get("train_batch_size")
        self.train_micro_batch_size_per_gpu = pd.get(
            "train_micro_batch_size_per_gpu")
        self.gradient_accumulation_steps = pd.get(
            "gradient_accumulation_steps")
        self.steps_per_print = pd.get("steps_per_print", 10)
        self.gradient_clipping = pd.get("gradient_clipping", 0.0)
        self.prescale_gradients = pd.get("prescale_gradients", False)
        self.gradient_predivide_factor = pd.get(
            "gradient_predivide_factor", 1.0)
        self.wall_clock_breakdown = pd.get("wall_clock_breakdown", False)
        self.seed = pd.get("seed", 1234)

        self.fp16 = FP16Config.from_dict(pd.get("fp16", {}))
        self.bf16 = BF16Config.from_dict(pd.get("bf16",
                                                pd.get("bfloat16", {})))
        self.zero = ZeroConfig.from_dict(pd.get("zero_optimization"))
        self.optimizer = OptimizerConfig.from_dict(pd.get("optimizer"))
        self.scheduler = SchedulerConfig.from_dict(pd.get("scheduler"))
        self.sparse_attention = SparseAttentionConfig.from_dict(
            pd.get("sparse_attention"))
        self.flops_profiler = FlopsProfilerConfig.from_dict(
            pd.get("flops_profiler"))
        self.tensorboard = TensorboardConfig.from_dict(pd.get("tensorboard"))
        self.pld = PLDConfig.from_dict(pd.get("progressive_layer_drop"))
        self.curriculum = CurriculumConfig.from_dict(
            pd.get("curriculum_learning"))

        for key, what in _LATER_SLICES.items():
            if (pd.get(key) or {}).get("enabled", False):
                raise NotImplementedError(f"config section {key!r} waits "
                                          f"for {what}")
        mesh = pd.get("mesh") or {}
        if any(mesh.get(k, 1) != 1 for k in _MESH_KEYS):
            raise NotImplementedError(
                "a mesh of more than one device waits for the multi-GPU "
                "slice")
        if pd.get("comm_backend_name", "ici") != "ici":
            raise NotImplementedError(
                "compressed gradient communication waits for the "
                "multi-GPU slice")

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.fp16.enabled:
            return torch.float16
        if self.bf16.enabled:
            return torch.bfloat16
        return torch.float32

    @property
    def precision_name(self) -> str:
        if self.fp16.enabled:
            return "fp16"
        if self.bf16.enabled:
            return "bf16"
        return "fp32"

    def _configure_train_batch_size(self):
        """Reconcile train_batch = micro_batch * grad_acc * world_size."""
        self._set_batch_related_parameters()
        self._batch_assertion()

    def _set_batch_related_parameters(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        ws = self.world_size

        if all(x is not None for x in (train_batch, micro_batch, grad_acc)):
            pass
        elif train_batch is not None and micro_batch is not None:
            self.gradient_accumulation_steps = train_batch // micro_batch // ws
        elif train_batch is not None and grad_acc is not None:
            self.train_micro_batch_size_per_gpu = train_batch // ws // grad_acc
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = train_batch // ws
        elif micro_batch is not None:
            if grad_acc is None:
                self.gradient_accumulation_steps = 1
            self.train_batch_size = (self.train_micro_batch_size_per_gpu
                                     * self.gradient_accumulation_steps * ws)
        else:
            raise DeepSpeedConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu "
                "needs to be provided")

    def _batch_assertion(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        for name, x in (("Train batch size", train_batch),
                        ("Micro batch size per gpu", micro_batch),
                        ("Gradient accumulation steps", grad_acc)):
            if not x > 0:
                raise DeepSpeedConfigError(
                    f"{name}: {x} has to be greater than 0")
        if train_batch != micro_batch * grad_acc * self.world_size:
            raise DeepSpeedConfigError(
                f"Check batch related parameters. train_batch_size is not "
                f"equal to micro_batch_per_gpu * gradient_acc_step * "
                f"world_size {train_batch} != {micro_batch} * {grad_acc} * "
                f"{self.world_size}")

    def _do_sanity_check(self):
        if self.fp16.enabled and self.bf16.enabled:
            raise DeepSpeedConfigError(
                "fp16 and bf16 modes cannot both be enabled")

    @property
    def param_dict(self) -> Dict:
        return self._param_dict

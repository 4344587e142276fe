"""FLOPs profiler: counted operations and measured time.

Port of ``deepspeed_tpu/profiling/flops_profiler/profiler.py``. Where the
JAX package reads the compiled program's cost analysis,
``torch.utils.flop_counter.FlopCounterMode`` counts the FLOPs of the
PyTorch operators one call runs; its time is the best of a few calls
(synchronised on the card). The counter sees PyTorch's operators only: the
port's own CUDA kernels are called through ctypes, so on the card it
misses attention, much as XLA's cost analysis counts a scanned layer
once. Bytes accessed are not counted (the counter counts operations).
:func:`analytic_model_profile` is the closed-form profile of a
``GPTConfig``, which the engine's profile uses.
"""

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from deepspeed_tpu_torch.telemetry.costs import (attn_flops,
                                                 device_peak_flops,
                                                 infer_flops,
                                                 model_flops_per_token,
                                                 weight_bytes)
from deepspeed_tpu_torch.tree import tree_leaves
from deepspeed_tpu_torch.utils.logging import logger


def analytic_model_profile(cfg, seq_len: Optional[int] = None,
                           param_itemsize: int = 2) -> Dict[str, Any]:
    """Closed-form per-token profile of a ``GPTConfig``: no model is run."""
    from deepspeed_tpu_torch.models.gpt import (kv_bytes_per_token,
                                                num_params,
                                                train_flops_per_token)
    s = int(seq_len if seq_len is not None else cfg.max_seq_len)
    return {
        "params": int(num_params(cfg)),
        "seq_len": s,
        "fwd_flops_per_token": model_flops_per_token(cfg),
        "fwd_attn_flops_seq": attn_flops(cfg, s, 0),
        "fwd_flops_seq": infer_flops(cfg, s, 0),
        "train_flops_per_token": int(train_flops_per_token(cfg, s)),
        "kv_bytes_per_token": int(kv_bytes_per_token(cfg)),
        "weight_bytes": weight_bytes(cfg, param_itemsize),
    }


def _num_to_string(num: float, units=None, precision: int = 2) -> str:
    """1.23e9 -> '1.23 G'."""
    if units is None:
        for cut, unit in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
            if abs(num) >= cut:
                return f"{num / cut:.{precision}f} {unit}"
        return f"{num:.{precision}f} "
    scale = {"T": 1e12, "G": 1e9, "M": 1e6, "K": 1e3, "": 1.0}[units]
    return f"{num / scale:.{precision}f} {units}"


def _devices(tree) -> set:
    if isinstance(tree, (tuple, list)):
        return set().union(*(_devices(x) for x in tree)) if tree else set()
    return {t.device for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


def count_flops(fn: Callable, *args, **kwargs) -> Tuple[float, Any]:
    """(FLOPs of the PyTorch operators of one ``fn(*args, **kwargs)``,
    its result)."""
    counter = FlopCounterMode(display=False)
    with counter:
        out = fn(*args, **kwargs)
    return float(counter.get_total_flops()), out


def analyze_fn(fn: Callable, *args, runs: int = 3,
               **kwargs) -> Dict[str, Any]:
    """Count ``fn(*args)``'s FLOPs and time it: ``{flops, macs,
    bytes_accessed (None), peak_bytes (the card's, None on the host),
    duration_s (best of ``runs`` after one counted call), tflops_achieved,
    mfu (None without a known peak), arithmetic_intensity (None)}``."""
    cuda = [d for d in _devices((args, kwargs)) if d.type == "cuda"]
    device = cuda[0] if cuda else None

    def sync():
        if device is not None:
            torch.cuda.synchronize(device)

    if device is not None:
        sync()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    flops, _ = count_flops(fn, *args, **kwargs)
    sync()
    peak_bytes = (torch.cuda.max_memory_allocated(device) - base) \
        if device is not None else None
    best = float("inf")
    for _ in range(max(1, runs)):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        sync()
        best = min(best, time.perf_counter() - t0)
    peak = device_peak_flops(device) if device is not None else None
    achieved = flops / best if best > 0 else 0.0
    return {
        "flops": flops,
        "macs": flops / 2.0,
        "bytes_accessed": None,
        "peak_bytes": peak_bytes,
        "duration_s": best,
        "tflops_achieved": achieved / 1e12,
        "mfu": (achieved / peak) if peak else None,
        "arithmetic_intensity": None,
    }


def _count_params(tree) -> int:
    return sum(int(t.numel()) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class FlopsProfiler:
    """The reference's profiler API over :func:`analyze_fn`::

        prof = FlopsProfiler(loss_fn, params)
        prof.start_profile()
        prof.profile(batch, rng)       # counts and times
        prof.print_model_profile()
        prof.end_profile()

    ``submodules``: optional ``{name: (fn, args)}`` profiled beside the
    model, for a per-component table."""

    def __init__(self, model: Callable, params=None,
                 submodules: Optional[Dict[str, Tuple[Callable, tuple]]]
                 = None):
        self.model = model
        self.params = params
        self.submodules = submodules or {}
        self.started = False
        self._profile: Dict[str, Any] = {}
        self._sub_profiles: Dict[str, Dict[str, Any]] = {}

    def start_profile(self) -> None:
        self.started = True
        self._profile = {}
        self._sub_profiles = {}

    def stop_profile(self) -> None:
        self.started = False

    def reset_profile(self) -> None:
        self._profile = {}
        self._sub_profiles = {}

    def end_profile(self) -> None:
        self.stop_profile()
        self.reset_profile()

    def profile(self, *args, **kwargs) -> Dict[str, Any]:
        """Count and time ``model(params, *args)`` (``model(*args)``
        without params)."""
        call_args = ((self.params,) + args) if self.params is not None \
            else args
        self._profile = analyze_fn(self.model, *call_args, **kwargs)
        for name, (fn, sub_args) in self.submodules.items():
            self._sub_profiles[name] = analyze_fn(fn, *sub_args)
        return self._profile

    def get_total_flops(self, as_string: bool = False):
        v = self._profile.get("flops", 0.0)
        return _num_to_string(v) + "FLOPS" if as_string else v

    def get_total_macs(self, as_string: bool = False):
        v = self._profile.get("macs", 0.0)
        return _num_to_string(v) + "MACs" if as_string else v

    def get_total_duration(self, as_string: bool = False):
        v = self._profile.get("duration_s", 0.0)
        return f"{v * 1e3:.2f} ms" if as_string else v

    def get_total_params(self, as_string: bool = False):
        v = _count_params(self.params) if self.params is not None else 0
        return _num_to_string(v) + "params" if as_string else v

    def print_model_profile(self, profile_step: int = 1,
                            detailed: bool = True,
                            output_file: Optional[str] = None) -> None:
        """One summary block and, with ``detailed``, the submodule
        table; to ``output_file`` or the log."""
        p = self._profile
        if not p:
            logger.warning("FlopsProfiler: call profile() first")
            return
        lines = [
            "", "-" * 72, "DeepSpeed-TPU-torch Flops Profiler", "-" * 72,
            f"profile step:                   {profile_step}",
            f"params:                         {self.get_total_params(True)}",
            f"fwd(+bwd+step) flops:           {self.get_total_flops(True)}",
            f"fwd(+bwd+step) MACs:            {self.get_total_macs(True)}",
            "flops count:                    FlopCounterMode (PyTorch "
            "operators; the port's CUDA kernels are not seen)",
            f"measured latency:               {self.get_total_duration(True)}",
            f"achieved throughput:            {p['tflops_achieved']:.2f} "
            f"TFLOPS",
        ]
        if p.get("mfu") is not None:
            lines.append(f"model flops utilization (MFU):  "
                         f"{p['mfu'] * 100:.1f}%")
        if detailed and self._sub_profiles:
            lines.append("-" * 72)
            lines.append(f"{'submodule':<28}{'flops':>14}{'latency':>12}"
                         f"{'share':>10}")
            total = max(p["flops"], 1.0)
            for name, sp in sorted(self._sub_profiles.items(),
                                   key=lambda kv: -kv[1]["flops"]):
                lines.append(
                    f"{name:<28}{_num_to_string(sp['flops']):>13} "
                    f"{sp['duration_s'] * 1e3:>10.2f}ms"
                    f"{sp['flops'] / total * 100:>9.1f}%")
        lines.append("-" * 72)
        text = "\n".join(lines)
        if output_file:
            with open(output_file, "w") as f:
                f.write(text + "\n")
        else:
            logger.info(text)

    def print_model_aggregated_profile(self, top_modules: int = 1) -> None:
        """The top ``top_modules`` submodules by FLOPs."""
        if not self._sub_profiles:
            logger.warning("FlopsProfiler: no submodules registered")
            return
        ranked = sorted(self._sub_profiles.items(),
                        key=lambda kv: -kv[1]["flops"])[:top_modules]
        for name, sp in ranked:
            logger.info(f"{name}: {_num_to_string(sp['flops'])}FLOPS, "
                        f"{sp['duration_s'] * 1e3:.2f} ms")


def get_model_profile(model: Callable, args=(), kwargs=None,
                      print_profile: bool = True, detailed: bool = True,
                      as_string: bool = True,
                      output_file: Optional[str] = None):
    """``(flops, macs, params)`` of ``model(*args)`` (params: the leaves
    of ``args[0]``). The JAX package's ``warm_up`` and ``ignore_modules``
    are not taken: the counted call is the warm-up of the timed ones, and
    there are no module hooks to filter."""
    prof = FlopsProfiler(model)
    prof.start_profile()
    prof.profile(*args, **(kwargs or {}))
    if print_profile:
        prof.print_model_profile(detailed=detailed, output_file=output_file)
    flops = prof.get_total_flops(as_string)
    macs = prof.get_total_macs(as_string)
    params = _count_params(args[0]) if args else 0
    if as_string:
        params = _num_to_string(params) + "params"
    prof.end_profile()
    return flops, macs, params

from deepspeed_tpu_torch.profiling.flops_profiler.profiler import (
    FlopsProfiler, analytic_model_profile, analyze_fn, device_peak_flops,
    get_model_profile)

__all__ = ["FlopsProfiler", "analytic_model_profile", "analyze_fn",
           "device_peak_flops", "get_model_profile"]

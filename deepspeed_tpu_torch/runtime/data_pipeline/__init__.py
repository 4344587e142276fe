from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import (
    CurriculumScheduler)

__all__ = ["CurriculumScheduler"]

"""Command-line tools of the port that read its artifacts
(``python -m deepspeed_tpu_torch.tools.postmortem``)."""

"""Command-line tools of the port: the postmortem reader of its flight
artifacts (``python -m deepspeed_tpu_torch.tools.postmortem``) and the
seeded serving load generator (``python -m
deepspeed_tpu_torch.tools.load_gen``)."""

"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card. The
plain PyTorch versions run on the host only when the caller asks for
``device="cpu"`` (as the tests do); nothing falls back to the host
silently.
"""

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deepspeed_tpu_torch runs on a CUDA card by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions on the host")
        return torch.device("cuda")
    return torch.device(device)

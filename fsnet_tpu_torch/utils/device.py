"""Where the port runs: on a CUDA device unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is present. Never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fsnet_tpu_torch runs on a CUDA device and none is "
                           "available; pass device='cpu' to run on the CPU")
    return dev

"""The eval step (counterpart of ``fsnet_tpu.runtime.state.make_eval_step``;
the train step arrives with the training slice)."""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from ..utils.device import DeviceLike, resolve_device


def _to_device(batch: Dict, device: torch.device) -> Dict:
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        if isinstance(v, torch.Tensor):
            v = v.to(device, non_blocking=True)
        out[k] = v
    return out


def make_eval_step(device: DeviceLike = "cuda") -> Callable:
    """Inference step ``eval_step(model, batch) -> prediction dict``: moves a
    string-keyed batch (numpy arrays or tensors) to ``device`` and runs
    ``model.forward_test`` under ``torch.inference_mode()``. ``device`` is a
    CUDA device unless the caller asks for the CPU; raises when CUDA is
    asked for and absent."""
    dev = resolve_device(device)

    def eval_step(model: nn.Module, batch: Dict) -> Dict:
        param = next(model.parameters())
        if param.device.type != dev.type:
            raise ValueError(f"model lives on {param.device}, the eval step "
                             f"on {dev}")
        with torch.inference_mode():
            return model(_to_device(batch, dev), {"is_training": False})

    return eval_step

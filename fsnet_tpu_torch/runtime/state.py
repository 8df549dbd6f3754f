"""The train and eval steps (counterpart of
``fsnet_tpu.runtime.state.make_train_step`` and ``make_eval_step``).

PyTorch runs eagerly, so there is no jitted state: the model carries its
parameters and BN running statistics, and the optimizer
(:mod:`fsnet_tpu_torch.runtime.optim`) its moments and step count.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

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


def _check_model_device(model: nn.Module, dev: torch.device,
                        what: str) -> None:
    param = next(model.parameters())
    if param.device.type != dev.type:
        raise ValueError(f"model lives on {param.device}, the {what} on {dev}")


def make_train_step(device: DeviceLike = "cuda",
                    with_grads: bool = False) -> Callable:
    """Training step ``train_step(model, optimizer, batch, noise=None) ->
    metrics``: moves a string-keyed batch (numpy arrays or tensors) to
    ``device``, runs ``model.forward_train`` (BN in train mode; the running
    statistics are updated in the model), back-propagates the loss in
    float32 or wider, and applies one ``optimizer.step`` to the gradients of
    the optimizer's parameters (zeros for a parameter the loss does not
    reach; the pose net's too, where the model has one). ``noise``:
    the identity tie-break noise [F, B, H, W] of the loss, or None for none.

    Returns the metrics: the loss dict of the head plus ``loss`` and
    ``grad_norm`` (the global gradient norm before clipping), as 0-d
    tensors on ``device``; with ``with_grads`` also ``_grads``, the
    unclipped gradients by parameter name (for parity checks). ``device`` is
    a CUDA device unless the caller asks for the CPU; raises when CUDA is
    asked for and absent."""
    dev = resolve_device(device)

    def train_step(model: nn.Module, optimizer, batch: Dict,
                   noise: Optional[torch.Tensor] = None) -> Dict:
        _check_model_device(model, dev, "train step")
        data = _to_device(batch, dev)
        if noise is not None:
            noise = noise.to(dev)
        out = model.forward_train(data, {"is_training": True}, noise=noise)
        loss = out["loss"]
        loss = loss.to(torch.promote_types(loss.dtype, torch.float32))
        grads = torch.autograd.grad(loss, optimizer.params,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(optimizer.params, grads)]
        metrics = dict(out["loss_dict"])
        metrics["grad_norm"] = optimizer.step(grads)
        metrics["loss"] = loss.detach()
        if with_grads:
            names = {id(p): n for n, p in model.named_parameters()}
            metrics["_grads"] = {names[id(p)]: g for p, g in
                                 zip(optimizer.params, grads)}
        return metrics

    return train_step


def make_eval_step(device: DeviceLike = "cuda") -> Callable:
    """Inference step ``eval_step(model, batch) -> prediction dict``: moves a
    string-keyed batch (numpy arrays or tensors) to ``device`` and runs
    ``model.forward_test`` under ``torch.inference_mode()``. ``device`` is a
    CUDA device unless the caller asks for the CPU; raises when CUDA is
    asked for and absent."""
    dev = resolve_device(device)

    def eval_step(model: nn.Module, batch: Dict) -> Dict:
        _check_model_device(model, dev, "eval step")
        with torch.inference_mode():
            return model(_to_device(batch, dev), {"is_training": False})

    return eval_step

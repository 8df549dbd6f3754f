"""The train and eval steps (counterpart of
``fsnet_tpu.runtime.state.make_train_step`` and ``make_eval_step``).

PyTorch runs eagerly, so there is no jitted state: the model carries its
parameters and BN running statistics, and the optimizer
(:mod:`fsnet_tpu_torch.runtime.optim`) its moments and step count.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ..models.blocks import deferred_updates
from ..utils.device import DeviceLike, resolve_device

# the compute dtypes of make_train_step: None (float32, or the model's own
# type) or bfloat16, by dtype or by the configs' name
_COMPUTE = {None: None, torch.bfloat16: torch.bfloat16,
            "bfloat16": torch.bfloat16}


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


def _cast(batch: Dict, dtype: torch.dtype) -> Dict:
    """Every floating tensor of ``batch`` in ``dtype``: the JAX step's
    ``_cast`` of its batch, whose floating leaves are all float32 there (a
    float64 array, the datasets' patched mask, becomes float32 first)."""
    return {k: v.float().to(dtype) if isinstance(v, torch.Tensor)
            and v.is_floating_point() else v for k, v in batch.items()}


class _FlatMasters:
    """The optimizer's parameters of ``model`` as views of one flat buffer,
    so that the bf16 step casts them with one launch and takes their
    gradient as one flat tensor: made on the first bf16 step (the
    parameters are copied into the buffer and rebound to their views,
    which the optimizer then updates in place), and made again where the
    model, the optimizer's parameters or their storage changed since.
    ``names`` are those parameters' names in ``model``; ``others`` the
    model's other floating parameters, by name."""

    def __init__(self, model: nn.Module, params):
        if len({(p.dtype, p.device) for p in params}) != 1:
            raise ValueError("the bf16 step takes parameters of one dtype "
                             "on one device")
        self.model = model
        self.params = list(params)
        by_id = {id(p): n for n, p in model.named_parameters()}
        self.names = [by_id.pop(id(p)) for p in self.params]
        self.others = [(n, p) for n, p in model.named_parameters()
                       if id(p) in by_id and p.is_floating_point()]
        self.sizes = [p.numel() for p in self.params]
        self.flat = torch.cat([p.detach().reshape(-1) for p in self.params])
        for p, view in zip(self.params, self.views(self.flat)):
            p.data = view

    def views(self, flat: torch.Tensor):
        return [t.view(p.shape) for p, t in
                zip(self.params, flat.split(self.sizes))]

    def intact(self, model: nn.Module, params) -> bool:
        if model is not self.model or len(params) != len(self.params) or \
                any(p is not q for p, q in zip(params, self.params)):
            return False
        at, step = self.flat.data_ptr(), self.flat.element_size()
        for p, n in zip(self.params, self.sizes):
            if p.data_ptr() != at:
                return False
            at += n * step
        return True


def make_train_step(device: DeviceLike = "cuda",
                    compute_dtype: Union[None, str, torch.dtype] = None,
                    with_grads: bool = False) -> Callable:
    """Training step ``train_step(model, optimizer, batch, noise=None) ->
    metrics``: moves a string-keyed batch (numpy arrays or tensors) to
    ``device``, runs ``model.forward_train`` (BN in train mode; the running
    statistics are updated in the model), back-propagates the loss in
    float32 or wider, and applies one ``optimizer.step`` to the gradients of
    the optimizer's parameters (zeros for a parameter the loss does not
    reach; the pose net's too, where the model has one). ``noise``:
    the identity tie-break noise [F, B, H, W] of the loss, or None for none.

    ``compute_dtype`` None runs the model in its own type. ``torch.bfloat16``
    or ``"bfloat16"`` (``configs/common.py``'s training hook) is the JAX
    package's mixed-precision step (``fsnet_tpu.runtime.state``): the
    forward and backward run on bfloat16 copies of the float32 master
    parameters (``torch.func.functional_call``), on the batch with every
    floating tensor cast to bfloat16, and each BN reads its float32 running
    statistics rounded to bfloat16 and writes their float32 update back
    (:class:`~fsnet_tpu_torch.models.blocks.BatchNorm`); the loss is
    float32, and autograd carries each gradient through the cast to its
    master, a bfloat16 value widened to float32, which the clip and Adam
    take. The optimizer's parameters are cast as one flat buffer
    (:class:`_FlatMasters`: the step rebinds them to views of it); the
    model's other parameters each by itself, without a gradient; the BN
    updates are gathered and applied together after the forward
    (:func:`~fsnet_tpu_torch.models.blocks.deferred_updates`). Any other
    value raises.

    Returns the metrics: the loss dict of the head plus ``loss`` and
    ``grad_norm`` (the global gradient norm before clipping), as 0-d
    tensors on ``device``; with ``with_grads`` also ``_grads``, the
    unclipped gradients by parameter name (for parity checks). ``device`` is
    a CUDA device unless the caller asks for the CPU; raises when CUDA is
    asked for and absent."""
    dev = resolve_device(device)
    if not isinstance(compute_dtype, (type(None), str, torch.dtype)) or \
            compute_dtype not in _COMPUTE:
        raise ValueError("compute_dtype must be None, torch.bfloat16 or "
                         f"'bfloat16', got {compute_dtype!r}")
    cdt = _COMPUTE[compute_dtype]
    masters = [None]         # the last optimizer's _FlatMasters

    def low_params(model: nn.Module, optimizer):
        """(the bfloat16 parameters by name, the flat float32 leaf whose
        cast they are views of, the :class:`_FlatMasters`)."""
        flat = masters[0]
        if flat is None or not flat.intact(model, optimizer.params):
            flat = masters[0] = _FlatMasters(model, optimizer.params)
        leaf = flat.flat.detach().requires_grad_()
        params = dict(zip(flat.names, flat.views(leaf.to(cdt))))
        params.update((n, p.detach().to(cdt)) for n, p in flat.others)
        return params, leaf, flat

    def train_step(model: nn.Module, optimizer, batch: Dict,
                   noise: Optional[torch.Tensor] = None) -> Dict:
        _check_model_device(model, dev, "train step")
        data = _to_device(batch, dev)
        if noise is not None:
            noise = noise.to(dev)
        meta = {"is_training": True}
        if cdt is None:
            out = model.forward_train(data, meta, noise=noise)
        else:
            params, leaf, flat = low_params(model, optimizer)
            with deferred_updates():
                out = torch.func.functional_call(
                    model, params, (_cast(data, cdt), meta),
                    {"noise": noise})
        loss = out["loss"]
        loss = loss.to(torch.promote_types(loss.dtype, torch.float32))
        if cdt is None:
            grads = torch.autograd.grad(loss, optimizer.params,
                                        allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(optimizer.params, grads)]
        else:
            grads = flat.views(torch.autograd.grad(loss, leaf)[0])
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

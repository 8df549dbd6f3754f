"""Checkpoint I/O and surgery (counterpart of
``fsnet_tpu.runtime.checkpoint``), on ``torch.save`` / ``torch.load``.

A checkpoint is one file holding a dict:

* ``model``: the model's state_dict (parameters and BN running statistics),
  on the CPU;
* ``optimizer``: the Adam moments ``mu`` and ``nu`` by parameter name and
  the update ``count``, or None;
* ``epoch``: the epochs done.

Resume thus restores the schedule position (``count``), as the JAX
checkpoint's step does. :func:`load_models` loads in place: every tensor is
``copy_``-ed into the model's and the optimizer's own tensors, never
replaced, because the bf16 step binds the parameters to views of one flat
buffer (``runtime/state.py``) and the optimizer holds those parameters.
Files are read with ``weights_only=True``.

Surgery, with the JAX package's ``strict=False`` semantics: a tensor of the
same name and shape replaces the target's, anything else is left as it
was. A trained ``MonoDepthWPose``'s state_dict is cut down to the
distillation teacher's ``{depth_backbone.*, depth_decoder.*}`` (the head's
depth decoder renamed) and grafted under ``teacher_net.`` of a
``DistillWPoseMeta``; :func:`load_teacher` does so from a checkpoint file.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import torch
from torch import nn

_KEEP = {"depth_backbone": "depth_backbone", "head.depth_decoder":
         "depth_decoder"}


def _names(model: nn.Module, optimizer) -> list:
    by_id = {id(p): n for n, p in model.named_parameters()}
    return [by_id[id(p)] for p in optimizer.params]


def save_models(path: str, model: nn.Module, optimizer=None,
                epoch: int = 0) -> None:
    """Writes the checkpoint of ``model`` (and ``optimizer``) after
    ``epoch`` epochs to ``path`` (through a temporary file, so a reader
    never sees half a file)."""
    payload = {"model": {k: v.detach().cpu()
                         for k, v in model.state_dict().items()},
               "optimizer": None, "epoch": int(epoch)}
    if optimizer is not None:
        names = _names(model, optimizer)
        payload["optimizer"] = {
            "mu": {n: t.detach().cpu() for n, t in zip(names, optimizer.mu)},
            "nu": {n: t.detach().cpu() for n, t in zip(names, optimizer.nu)},
            "count": int(optimizer.count)}
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict:
    """The payload of a checkpoint file (tensors on the CPU)."""
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)


def load_partial_state_dict(target: Mapping[str, torch.Tensor],
                            source: Mapping[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """``target`` with each entry replaced by ``source``'s of the same name
    and shape; a new dict."""
    out = dict(target)
    for key, value in target.items():
        src = source.get(key)
        if src is not None and tuple(src.shape) == tuple(value.shape):
            out[key] = src
    return out


def extract_subtree(state: Mapping[str, torch.Tensor], prefix: str
                    ) -> Optional[Dict[str, torch.Tensor]]:
    """The entries under ``prefix`` (dotted, or '/'-joined as in the JAX
    package), the prefix stripped; None where there are none."""
    head = prefix.replace("/", ".") + "."
    out = {k[len(head):]: v for k, v in state.items() if k.startswith(head)}
    return out or None


def load_models(path: str, model: nn.Module, optimizer=None,
                strict: bool = False) -> int:
    """Loads the checkpoint at ``path`` into ``model`` and, where given and
    saved, ``optimizer``, in place; returns its epoch. ``strict`` requires
    every name and shape to agree; otherwise only the entries of the same
    name and shape are taken (the optimizer's count always is)."""
    payload = load_checkpoint(path)
    state = payload["model"]
    if strict:
        model.load_state_dict(state)
    else:
        model.load_state_dict(load_partial_state_dict(model.state_dict(),
                                                      state))
    saved = payload.get("optimizer")
    if optimizer is not None and saved is not None:
        with torch.no_grad():
            for name, mu, nu in zip(_names(model, optimizer), optimizer.mu,
                                    optimizer.nu):
                for mine, theirs in ((mu, saved["mu"].get(name)),
                                     (nu, saved["nu"].get(name))):
                    if theirs is not None and theirs.shape == mine.shape:
                        mine.copy_(theirs)
                    elif strict:
                        raise KeyError(f"{path}: no optimizer state of the "
                                       f"shape of {name}")
        optimizer.count = int(saved["count"])
    return int(payload.get("epoch", 0))


def transform_teacher_params(state: Mapping[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
    """A ``MonoDepthWPose`` state_dict -> the teacher's: ``depth_backbone.*``
    kept, ``head.depth_decoder.*`` renamed ``depth_decoder.*``, the rest
    dropped."""
    out = {}
    for src, dst in _KEEP.items():
        sub = extract_subtree(state, src)
        if sub is not None:
            out.update((f"{dst}.{k}", v) for k, v in sub.items())
    return out


def load_teacher_into_params(state: Mapping[str, torch.Tensor],
                             teacher: Mapping[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
    """``state`` (a ``DistillWPoseMeta`` state_dict) with each
    ``teacher_net.<k>`` replaced by ``teacher[<k>]`` where that exists with
    the same shape; a new dict, ``state`` is not changed."""
    grafted = load_partial_state_dict(
        extract_subtree(state, "teacher_net") or {}, teacher)
    out = dict(state)
    out.update((f"teacher_net.{k}", v) for k, v in grafted.items())
    return out


def graft_teacher(model: nn.Module,
                  wpose_state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Loads the teacher of a trained ``MonoDepthWPose`` (its state_dict)
    into ``model``, a ``DistillWPoseMeta``, in place; returns ``model``."""
    model.load_state_dict(load_teacher_into_params(
        model.state_dict(), transform_teacher_params(wpose_state)))
    return model


def load_teacher(model: nn.Module, path: str) -> nn.Module:
    """:func:`graft_teacher` from the checkpoint file at ``path`` (the
    ``teacher_net_path`` of a distillation config)."""
    return graft_teacher(model, load_checkpoint(path)["model"])

"""Checkpoint surgery for the distillation teacher (counterpart of
``fsnet_tpu.runtime.checkpoint.transform_teacher_params`` and
``load_teacher_into_params``), on state_dicts.

A trained ``MonoDepthWPose``'s state_dict is cut down to the teacher's
``{depth_backbone.*, depth_decoder.*}`` (the head's depth decoder renamed),
then grafted under the ``teacher_net.`` scope of a ``DistillWPoseMeta`` with
the JAX package's ``strict=False`` semantics: a tensor of the same name and
shape replaces the model's, anything else is left as it was. Parameters and
BN running statistics travel together, as in a PyTorch state_dict.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

_KEEP = {"depth_backbone.": "depth_backbone.",
         "head.depth_decoder.": "depth_decoder."}


def transform_teacher_params(state: Mapping[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
    """A ``MonoDepthWPose`` state_dict -> the teacher's: ``depth_backbone.*``
    kept, ``head.depth_decoder.*`` renamed ``depth_decoder.*``, the rest
    dropped."""
    out = {}
    for key, value in state.items():
        for src, dst in _KEEP.items():
            if key.startswith(src):
                out[dst + key[len(src):]] = value
    return out


def load_teacher_into_params(state: Mapping[str, torch.Tensor],
                             teacher: Mapping[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
    """``state`` (a ``DistillWPoseMeta`` state_dict) with each
    ``teacher_net.<k>`` replaced by ``teacher[<k>]`` where that exists with
    the same shape; a new dict, ``state`` is not changed."""
    out = dict(state)
    for key, value in state.items():
        if not key.startswith("teacher_net."):
            continue
        src = teacher.get(key[len("teacher_net."):])
        if src is not None and tuple(src.shape) == tuple(value.shape):
            out[key] = src
    return out


def graft_teacher(model: nn.Module,
                  wpose_state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Loads the teacher of a trained ``MonoDepthWPose`` (its state_dict)
    into ``model``, a ``DistillWPoseMeta``, in place; returns ``model``."""
    model.load_state_dict(load_teacher_into_params(
        model.state_dict(), transform_teacher_params(wpose_state)))
    return model

"""Pretrained encoders from local files (counterpart of
``fsnet_tpu.runtime.pretrained`` for the port's backbones, ResNet-18 and
ResNet-34).

A backbone config with ``pretrained_path`` names its weights; with
``pretrained=True`` and no path they are looked up as the JAX package looks
them up: ``$FSNET_PRETRAINED_DIR``, then ``$TORCH_HOME/hub/checkpoints`` and
``$TORCH_HOME/checkpoints`` (``TORCH_HOME`` defaulting to
``~/.cache/torch``), by torchvision's file names (``resnet18-*.pth``,
``resnet18.pth``). Nothing is downloaded: ``pretrained=True`` with no file
raises. A torchvision-format ResNet state_dict is grafted into the model's
``depth_backbone`` / ``pose_backbone`` by name and shape
(``layer{i}.{b}.*`` -> ``layer{i}_{b}.*``, ``downsample.0/1`` ->
``downsample_conv/bn``, the classifier dropped); a pose encoder over
``num_input_images`` frames takes conv1 repeated over its inputs and
divided by their number, as the reference does. Other backbones raise.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Mapping, Optional

import torch
from torch import nn

from .checkpoint import load_partial_state_dict

_SCOPES = (("depth_backbone", "depth_backbone_cfg"),
           ("pose_backbone", "pose_backbone_cfg"))


def _cache_dirs() -> List[str]:
    dirs = []
    if os.environ.get("FSNET_PRETRAINED_DIR"):
        dirs.append(os.environ["FSNET_PRETRAINED_DIR"])
    torch_home = os.environ.get("TORCH_HOME",
                                os.path.expanduser("~/.cache/torch"))
    dirs.append(os.path.join(torch_home, "hub", "checkpoints"))
    dirs.append(os.path.join(torch_home, "checkpoints"))
    return dirs


def _find_cached_weights(patterns: List[str]) -> Optional[str]:
    for d in _cache_dirs():
        for pat in patterns:
            hits = sorted(glob.glob(os.path.join(d, pat)))
            if hits:
                return hits[0]
    return None


def _is_resnet(backbone_cfg: Mapping) -> bool:
    name = str(backbone_cfg.get("name", "")).lower()
    return name.endswith(".resnet.resnet") or name.endswith("resnet")


def resolve_pretrained_path(backbone_cfg: Mapping) -> Optional[str]:
    """The backbone's weights file: ``pretrained_path`` if set (it must
    exist), else, under ``pretrained=True``, a cache hit for the ResNet's
    depth; None when ``pretrained`` is off. Raises where weights are asked
    for and none are found, and for a backbone the port has no converter
    for."""
    path = str(backbone_cfg.get("pretrained_path", "") or "")
    pretrained = bool(backbone_cfg.get("pretrained", False))
    if not (path or pretrained):
        return None
    if not _is_resnet(backbone_cfg):
        raise NotImplementedError(
            f"pretrained weights for {backbone_cfg.get('name')!r} are not "
            "ported; the port grafts ResNet-18 and ResNet-34")
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"pretrained_path does not exist: {path}")
        return path
    depth = int(backbone_cfg.get("depth", 18))
    found = _find_cached_weights([f"resnet{depth}-*.pth",
                                  f"resnet{depth}.pth"])
    if found:
        return found
    raise FileNotFoundError(
        f"backbone cfg sets pretrained=True but no weights were found for "
        f"ResNet-{depth}. Self-supervised depth converges far worse from "
        f"scratch. Provide 'pretrained_path' in the backbone cfg, place "
        f"torchvision weights under $FSNET_PRETRAINED_DIR or "
        f"$TORCH_HOME/hub/checkpoints, or set pretrained=False to train "
        f"from scratch on purpose.")


def _unwrap(obj) -> Dict[str, torch.Tensor]:
    if isinstance(obj, dict):
        for key in ("model_state_dict", "state_dict", "model"):
            if key in obj and isinstance(obj[key], dict):
                return obj[key]
    return obj


def convert_resnet_state_dict(state: Mapping[str, torch.Tensor],
                              num_input_images: int = 1
                              ) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet state_dict in the port's ``ResNet`` names."""
    out = {}
    for key, value in state.items():
        if key.startswith("fc.") or key.endswith("num_batches_tracked"):
            continue
        name = re.sub(r"^layer(\d+)\.(\d+)\.", r"layer\1_\2.", key)
        name = name.replace(".downsample.0.", ".downsample_conv.")
        name = name.replace(".downsample.1.", ".downsample_bn.")
        if name == "conv1.weight" and num_input_images > 1:
            value = torch.cat([value] * num_input_images,
                              dim=1) / num_input_images
        out[name] = value
    return out


def graft_pretrained_backbones(model: nn.Module, meta_arch_cfg: Mapping,
                               verbose: bool = True) -> List[str]:
    """Grafts the pretrained weights that ``meta_arch_cfg``'s backbones ask
    for into ``model`` in place (a distillation teacher comes from its
    checkpoint instead). Returns the scopes grafted; raises where a graft
    would match no tensor."""
    grafted = []
    for scope, key in _SCOPES:
        cfg = meta_arch_cfg.get(key)
        if not cfg:
            continue
        path = resolve_pretrained_path(cfg)
        if path is None:
            continue
        module = getattr(model, scope)
        source = convert_resnet_state_dict(
            _unwrap(torch.load(path, map_location="cpu", weights_only=True)),
            int(cfg.get("num_input_images", 1)))
        target = module.state_dict()
        merged = load_partial_state_dict(target, source)
        hits = sum(merged[k] is source.get(k) for k in target)
        if hits == 0:
            raise ValueError(f"pretrained graft into '{scope}' matched 0 of "
                             f"{len(source)} tensors of {path}")
        module.load_state_dict(merged)
        grafted.append(scope)
        if verbose:
            print(f"pretrained: grafted {hits}/{len(source)} tensors from "
                  f"{os.path.basename(path)} into '{scope}'")
    return grafted

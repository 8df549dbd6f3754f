"""Config loading and CLI override merging (counterpart of
``fsnet_tpu.utils.config``).

- ``cfg_from_file(path)``: execute a ``.py`` config file in a fresh module
  namespace and return its ``cfg`` as an :class:`EasyDict`. The port's
  configs (``fsnet_tpu_torch/configs/``) build their dicts with this
  package's :mod:`~fsnet_tpu_torch.utils.easydict`; nothing here imports
  the pip ``easydict``.
- ``update_cfg(cfg, **{'a.b.c': v})``: recursive dotted-key override merge.
- ``set_random_seed(seed)``: seed ``random``, numpy's global state and
  PyTorch's default generators.
"""
from __future__ import annotations

import importlib.util
import os
import random

import numpy as np
import torch

from .easydict import EasyDict


def cfg_from_file(cfg_filename: str) -> EasyDict:
    """Load a python config file that defines a module-level ``cfg`` dict."""
    if not cfg_filename.endswith(".py"):
        raise ValueError(f"config must be a .py file, got {cfg_filename}")
    cfg_filename = os.path.abspath(cfg_filename)
    spec = importlib.util.spec_from_file_location(
        f"_fsnet_torch_cfg_{abs(hash(cfg_filename))}", cfg_filename)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load config {cfg_filename}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    cfg = getattr(module, "cfg")
    if not isinstance(cfg, dict):
        raise TypeError(f"{cfg_filename}: cfg is a {type(cfg).__name__}")
    return cfg if isinstance(cfg, EasyDict) else EasyDict(cfg)


def update_dict(obj: dict, key: str, rest_items: list, value):
    """Recursively set ``obj[key][rest...[-1]] = value``, replacing
    intermediate non-dict values with fresh EasyDicts."""
    if len(rest_items) == 0:
        obj[key] = value
        return obj
    if not (key in obj and isinstance(obj[key], dict)):
        obj[key] = EasyDict()
    obj[key] = update_dict(obj[key], rest_items[0], rest_items[1:], value)
    return obj


def update_cfg(cfg: EasyDict, **kwargs) -> EasyDict:
    """Apply dotted-key overrides, e.g. ``update_cfg(cfg, **{'b.c': 3})``."""
    for key, value in kwargs.items():
        key_items = key.split(".")
        cfg = update_dict(cfg, key_items[0], key_items[1:], value)
    return cfg


def set_random_seed(seed: int) -> None:
    """Seed python's ``random``, numpy's global state and PyTorch's default
    generators (CPU and every CUDA device). The port's own random draws
    (weights, tie-break noise, augmentations) take explicit generators
    seeded from the config; this covers what draws from global state (the
    augmentations' default seeds, the loader's worker seeds)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

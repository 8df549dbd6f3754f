"""Reflective object builder: configs name components by dotted import path
and ``build(name=..., **kwargs)`` instantiates them.

Counterpart of ``fsnet_tpu.utils.builder`` (``find_object``, ``build`` and
the compositions ``Sequential``, ``Parallel``, ``Shuffle`` that the
augmentation graphs use); a config that names ``fsnet_tpu_torch.*`` objects
builds the PyTorch port.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Optional

import numpy as np


def merge_name(list_of_name) -> str:
    """Join ['A', 'B', 'C'] into 'A.B.C'."""
    return ".".join(list_of_name)


def find_object(object_string: str):
    """Resolve a dotted path to a module/class/function.

    Tries progressively shorter module prefixes (longest first) then
    getattr-walks the remainder, so both ``pkg.mod`` and
    ``pkg.mod.Class.attr`` resolve.
    """
    splitted_names = object_string.split(".")

    error_traces = []
    for i in range(len(splitted_names), 0, -1):
        merged_name = merge_name(splitted_names[0:i])
        try:
            module = importlib.import_module(merged_name)
            base_obj = module
            for name in splitted_names[i:]:
                base_obj = getattr(base_obj, name)
        except (ImportError, AttributeError) as e:
            error_traces.append((merged_name, e))
            continue
        return base_obj

    error_log = "".join(f"{name} : {error} \n" for name, error in error_traces)
    raise ModuleNotFoundError(
        f"{object_string} not imported, error traces: \n{error_log}")


def build(name: str, *args, **kwargs):
    """Instantiate/call the object named by ``name`` with the remaining
    arguments."""
    obj = find_object(name)
    return obj(*args, **kwargs)


def _build_children(cfg_list: List[Dict], common_keywords: Dict
                    ) -> List[Callable]:
    """Each child cfg merged over ``common_keywords``, built."""
    children = []
    for item in cfg_list:
        tmp = dict(common_keywords)
        tmp.update(item)
        children.append(build(**tmp))
    return children


def _chain(children, args, kwargs):
    """The children called in order, each output feeding the next (tuple
    outputs splatted)."""
    result = None
    for i, child in enumerate(children):
        if i == 0:
            result = child(*args, **kwargs)
        elif isinstance(result, tuple):
            result = child(*result)
        else:
            result = child(result)
    return result


class Sequential:
    """Chain configured callables; ``common_keywords`` are merged under each
    child cfg."""

    def __init__(self, cfg_list: List[Dict], **common_keywords):
        self.children = _build_children(cfg_list, common_keywords)

    def __call__(self, *args, **kwargs):
        return _chain(self.children, args, kwargs)


class Parallel:
    """Fan the same inputs out to every child; their outputs as a list."""

    def __init__(self, cfg_list: List[Dict], **common_keywords):
        self.children = _build_children(cfg_list, common_keywords)

    def __call__(self, *args, **kwargs):
        return [child(*args, **kwargs) for child in self.children]


class Shuffle:
    """Run the children in a random order, drawn at each call from the
    object's own ``np.random.RandomState`` (the JAX package draws it from
    numpy's global state): ``RandomState(s).permutation(n)`` is the order
    ``np.random.seed(s); np.random.permutation(n)`` gives there.
    ``random_seed`` None seeds it from numpy's global state once, here."""

    def __init__(self, cfg_list: List[Dict],
                 random_seed: Optional[int] = None, **common_keywords):
        self.children = _build_children(cfg_list, common_keywords)
        self.rng = np.random.RandomState(
            random_seed if random_seed is not None
            else np.random.randint(0, 2 ** 32))

    def __call__(self, *args, **kwargs):
        order = self.rng.permutation(len(self.children))
        return _chain([self.children[i] for i in order], args, kwargs)

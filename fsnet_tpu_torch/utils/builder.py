"""Reflective object builder: configs name components by dotted import path
and ``build(name=..., **kwargs)`` instantiates them.

Counterpart of ``fsnet_tpu.utils.builder`` (``find_object``/``build``); a
config that names ``fsnet_tpu_torch.*`` objects builds the PyTorch port.
"""
from __future__ import annotations

import importlib


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

"""Attribute-access dict, API-compatible with the ``easydict.EasyDict`` the reference
configs rely on (reference: ``vision_base/utils/utils.py:9`` imports easydict).

Implemented natively so the framework carries no third-party config dependency.
Nested dicts (and dicts inside lists/tuples) are recursively converted, matching
easydict's behavior so existing-style configs work unchanged.
"""
from __future__ import annotations

from typing import Any


class EasyDict(dict):
    """A dict whose items are also attributes, recursively."""

    def __init__(self, d: Any = None, **kwargs):
        super().__init__()
        if d is None:
            d = {}
        elif not isinstance(d, dict):
            d = dict(d)
        if kwargs:
            d = {**d, **kwargs}
        for k, v in d.items():
            setattr(self, k, v)
        # class attributes defined by subclasses become instance items too
        # (callables and our own helpers stay methods, not dict items)
        for k in self.__class__.__dict__:
            if (k.startswith("__") and k.endswith("__")) or k in (
                    "update", "pop", "_convert"):
                continue
            value = getattr(self, k)
            if callable(value):
                continue
            setattr(self, k, value)

    @staticmethod
    def _convert(value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, EasyDict):
            return EasyDict(value)
        if isinstance(value, (list, tuple)):
            converted = [EasyDict._convert(x) for x in value]
            return type(value)(converted)
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        value = EasyDict._convert(value)
        super().__setattr__(name, value)
        super().__setitem__(name, value)

    __setitem__ = __setattr__

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __delattr__(self, name: str) -> None:
        del self[name]

    def update(self, e: Any = None, **f):  # type: ignore[override]
        d = e or {}
        d = {**dict(d), **f}
        for k, v in d.items():
            setattr(self, k, v)

    def pop(self, k, *args):  # type: ignore[override]
        if hasattr(self, k):
            object.__delattr__(self, k)
        return super().pop(k, *args)


# Alias used throughout configs, mirroring `from easydict import EasyDict as edict`.
edict = EasyDict

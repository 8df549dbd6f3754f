"""Stable string encoding for the reference's tuple-keyed sample dicts.

The reference's data contract is a flat dict whose keys are strings or tuples like
``('image', 0)``, ``('relative_pose', -1)``, ``('depth', 0, 0)``
(reference ``monodepth/data/datasets/mono_dataset.py:179-218``). JAX pytrees require
dict keys that sort consistently, and mixed str/tuple keys do not — so at the
host→device boundary every key is canonicalised to a string:

    ('image', 0)        <-> 'image/0'
    ('relative_pose',-1)<-> 'relative_pose/-1'
    ('depth', 0, 0)     <-> 'depth/0/0'
    'P2'                <-> 'P2'

Datasets/augmentations/models all speak tuple keys internally (matching the
reference API); ``encode_batch`` / ``decode_key`` convert at the jit boundary.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

Key = Union[str, Tuple]

_SEP = "/"


def encode_key(key: Key) -> str:
    if isinstance(key, str):
        return key
    if isinstance(key, tuple):
        return _SEP.join(str(part) for part in key)
    raise TypeError(f"unsupported key type: {type(key)}")


def _maybe_int(part: str) -> Union[str, int]:
    try:
        return int(part)
    except ValueError:
        return part


def decode_key(key: str) -> Key:
    if _SEP not in key:
        return key
    parts = key.split(_SEP)
    return tuple(_maybe_int(p) for p in parts)


def encode_batch(batch: Dict[Key, Any]) -> Dict[str, Any]:
    """Canonicalise all keys of a sample/batch dict to strings."""
    return {encode_key(k): v for k, v in batch.items()}


def decode_batch(batch: Dict[str, Any]) -> Dict[Key, Any]:
    """Restore tuple keys (inverse of :func:`encode_batch`)."""
    return {decode_key(k): v for k, v in batch.items()}

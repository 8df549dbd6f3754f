from .builder import build, find_object, merge_name
from .device import resolve_device
from .easydict import EasyDict, edict
from .keys import decode_batch, decode_key, encode_batch, encode_key

__all__ = [
    "build", "find_object", "merge_name", "resolve_device", "EasyDict",
    "edict", "encode_key", "decode_key", "encode_batch", "decode_batch",
]

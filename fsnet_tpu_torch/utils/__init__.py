from .builder import Parallel, Sequential, Shuffle, build, find_object, merge_name
from .config import cfg_from_file, set_random_seed, update_cfg, update_dict
from .device import resolve_device
from .easydict import EasyDict, edict
from .keys import decode_batch, decode_key, encode_batch, encode_key
from .logger import AverageMeter, LossLogger, styling_git_info
from .timer import Timer, formatting_time, profile

__all__ = [
    "build", "find_object", "merge_name", "Sequential", "Parallel",
    "Shuffle", "cfg_from_file", "update_cfg", "update_dict",
    "set_random_seed", "resolve_device", "EasyDict", "edict", "encode_key",
    "decode_key", "encode_batch", "decode_batch", "AverageMeter",
    "LossLogger", "styling_git_info", "Timer", "profile", "formatting_time",
]

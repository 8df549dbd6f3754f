from . import augmentations
from .dataloader import (Dataloader, InferenceSampler, TrainingSampler,
                         build_dataloader, device_prefetch, reseed_numpy)
from .datasets.dataset_utils import ConcatDataset, collate_fn, find_shared_keys

__all__ = [
    "augmentations", "Dataloader", "InferenceSampler", "TrainingSampler",
    "build_dataloader", "device_prefetch", "reseed_numpy", "ConcatDataset",
    "collate_fn", "find_shared_keys",
]

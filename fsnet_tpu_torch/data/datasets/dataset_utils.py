"""Collate and multi-dataset concatenation (counterpart of
``fsnet_tpu.data.datasets.dataset_utils``).

``collate_fn`` stacks only the keys that every sample has: arrays along a
new leading axis, numeric scalars into a [B] array, anything else kept as a
list. ``ConcatDataset`` builds its children from ``cfg_list`` merged over
``common_keywords`` and routes a global index through ``np.searchsorted``
over the cumulative lengths.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from ...utils.builder import build


def find_shared_keys(list_of_dicts: Sequence[Dict]) -> List:
    """Keys present in every sample, in the first sample's order."""
    if not list_of_dicts:
        return []
    shared = set(list_of_dicts[0].keys())
    for d in list_of_dicts[1:]:
        shared &= set(d.keys())
    return [k for k in list_of_dicts[0] if k in shared]


def collate_fn(batch: Sequence[Dict]) -> Dict:
    """Stack the shared keys of ``batch`` (a sequence of sample dicts)."""
    collated: Dict[Any, Any] = {}
    for key in find_shared_keys(batch):
        values = [sample[key] for sample in batch]
        first = values[0]
        if isinstance(first, np.ndarray):
            collated[key] = np.stack(values, axis=0)
        elif isinstance(first, (int, float, np.integer, np.floating, bool)):
            collated[key] = np.asarray(values)
        else:
            collated[key] = values
    return collated


class ConcatDataset:
    """Joint training over several datasets."""

    def __init__(self, cfg_list: Sequence[Dict], **common_keywords):
        self.datasets = []
        for item in cfg_list:
            cfg = dict(common_keywords)
            cfg.update(item)
            self.datasets.append(build(**cfg))
        lengths = [len(d) for d in self.datasets]
        self.separations = np.cumsum(lengths)
        self.total_length = int(self.separations[-1]) if lengths else 0

    def _determine_index(self, index: int):
        dataset_idx = int(np.searchsorted(self.separations, index,
                                          side="right"))
        local = index - (self.separations[dataset_idx - 1]
                         if dataset_idx > 0 else 0)
        return dataset_idx, int(local)

    def __len__(self) -> int:
        return self.total_length

    def __getitem__(self, index: int) -> Dict:
        dataset_idx, local_idx = self._determine_index(index)
        return self.datasets[dataset_idx][local_idx]

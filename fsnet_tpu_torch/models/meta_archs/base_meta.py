"""Meta-architecture base: train/test dispatch + export contract (counterpart
of ``fsnet_tpu.models.meta_archs.base_meta``)."""
from __future__ import annotations

from typing import Dict

from torch import nn


class BaseMetaArch(nn.Module):
    """Subclasses implement ``forward_train``, ``forward_test`` and
    ``dummy_forward`` (image-only forward for export). ``forward(data,
    meta, **kwargs)`` dispatches on ``meta['is_training']``; the keywords
    (the train step's ``noise``) go to ``forward_train``."""

    def forward_train(self, data: Dict, meta: Dict) -> Dict:
        raise NotImplementedError

    def forward_test(self, data: Dict, meta: Dict) -> Dict:
        raise NotImplementedError

    def dummy_forward(self, image) -> Dict:
        raise NotImplementedError

    def forward(self, data: Dict, meta: Dict, **kwargs) -> Dict:
        if meta["is_training"]:
            return self.forward_train(data, meta, **kwargs)
        return self.forward_test(data, meta)

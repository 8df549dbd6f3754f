"""MonoDepth meta-architectures, inference path (counterpart of
``fsnet_tpu.models.meta_archs.monodepth2_model``: ``MonoDepthWPose``'s
``forward_test``/``dummy_forward`` and ``MonoDepthInference``; training
arrives with the next slice).

Batches are string-keyed (``'image/0'``, ``'P2'``) and decoded to the
reference's tuple-key protocol at entry. Images are NHWC float tensors.

A model is built on ``device``, a CUDA device unless the caller asks for the
CPU, and raises when CUDA is asked for and absent. Its random weights come
from a ``torch.Generator`` seeded with ``seed``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...utils.builder import build
from ...utils.device import DeviceLike, resolve_device
from ...utils.keys import decode_batch
from ..blocks import init_params
from .base_meta import BaseMetaArch


def _decode(data: Dict) -> Dict:
    """String-keyed batch -> tuple-key protocol dict."""
    if any("/" in k for k in data if isinstance(k, str)):
        return decode_batch(data)
    return dict(data)


def _place(module: nn.Module, device: DeviceLike, seed: int) -> None:
    dev = resolve_device(device)
    init_params(module, torch.Generator().manual_seed(seed))
    module.to(dev)


class MonoDepthWPose(BaseMetaArch):
    """"Full-scale" flagship: dataset GT relative poses drive the warp in
    training; at test time a depth backbone + the head's depth decoder."""

    def __init__(self, depth_backbone_cfg: Dict, head_cfg: Dict,
                 train_cfg: Dict, test_cfg: Optional[Dict] = None,
                 pose_backbone_cfg: Optional[Dict] = None,
                 device: DeviceLike = "cuda", seed: int = 0):
        super().__init__()
        if pose_backbone_cfg is not None:
            raise NotImplementedError("the residual-pose branch comes with a "
                                      "later slice")
        self.train_cfg = dict(train_cfg)
        self.test_cfg = dict(test_cfg or {})
        self.depth_backbone = build(**dict(depth_backbone_cfg))
        self.head = build(frame_ids=tuple(self.train_cfg["frame_ids"]),
                          **dict(head_cfg))
        _place(self, device, seed)

    def forward_train(self, data: Dict, meta: Dict) -> Dict:
        raise NotImplementedError("training comes with the next slice")

    def forward_test(self, data: Dict, meta: Dict) -> Dict:
        data = _decode(data)
        features = self.depth_backbone(data[("image", 0)], train=False)
        outputs = self.head.forward_depth(features, data["P2"], train=False)
        return self.head.get_prediction(data, outputs)

    def dummy_forward(self, image: torch.Tensor) -> Dict:
        features = self.depth_backbone(image, train=False)
        outputs = self.head.forward_depth(features, train=False)
        return self.head.get_prediction(None, outputs)


class MonoDepthInference(nn.Module):
    """Inference-only backbone + decoder (the distillation teacher)."""

    def __init__(self, backbone_cfg: Dict, depth_head_cfg: Dict,
                 is_produce_detached: bool = True,
                 device: DeviceLike = "cuda", seed: int = 0):
        super().__init__()
        self.is_produce_detached = is_produce_detached
        self.depth_backbone = build(**dict(backbone_cfg))
        self.depth_decoder = build(**dict(depth_head_cfg))
        _place(self, device, seed)

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict:
        features = self.depth_backbone(x, train=False)
        return self.depth_decoder(features, train=False)

    def compute_teacher_depth(self, x: torch.Tensor) -> Dict:
        output_dict = self(x)
        teacher_output = {}
        for key in output_dict:
            if key[0] == "depth":
                value = output_dict[key]
                if self.is_produce_detached:
                    value = value.detach()
                teacher_output[("teacher_depth", key[1], key[2])] = value
        return teacher_output

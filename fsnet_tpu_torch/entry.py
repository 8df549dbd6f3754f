"""The flagship depth model of the port and its export-style forward
(counterpart of ``__graft_entry__._flagship_model`` and ``entry()``).

The configuration is the JAX flagship's with ``fsnet_tpu_torch`` names: a
ResNet-18 encoder with ``out_indices=(-1, 0, 1, 2, 3)`` and a
``MultiChannelDepthDecoder`` with 16 bins, scales 0-3 and depth 0.5-100,
under ``MonoDepthWPose``. It is built through the builder.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from .utils.builder import build
from .utils.device import DeviceLike, resolve_device


def flagship_config(height: int, width: int) -> Dict:
    return dict(
        name="fsnet_tpu_torch.models.meta_archs.monodepth2_model.MonoDepthWPose",
        depth_backbone_cfg=dict(
            name="fsnet_tpu_torch.models.backbones.resnet.resnet",
            depth=18, num_stages=4, out_indices=(-1, 0, 1, 2, 3),
            norm_eval=False, dilations=(1, 1, 1, 1),
        ),
        head_cfg=dict(
            name="fsnet_tpu_torch.models.heads.monodepth2_decoder.MonoDepth2Decoder",
            scales=(0, 1, 2, 3), height=height, width=width,
            min_depth=0.5, max_depth=100.0, is_log_image=False,
            overlapped_mask=True,
            depth_decoder_cfg=dict(
                name="fsnet_tpu_torch.models.heads.depth_decoder.MultiChannelDepthDecoder",
                num_output_channels=16, use_skips=True, scales=(0, 1, 2, 3),
                min_depth=0.5, max_depth=100.0,
            ),
        ),
        train_cfg=dict(frame_ids=(0, 1, -1)),
        test_cfg=dict(),
    )


def flagship_model(height: int, width: int, device: DeviceLike = "cuda",
                   seed: int = 0):
    """The flagship ``MonoDepthWPose`` with seeded random weights on
    ``device``."""
    return build(**flagship_config(height, width), device=device, seed=seed)


def entry(device: DeviceLike = "cuda") -> Tuple[Callable, Tuple[torch.Tensor]]:
    """(fn, example_args): single-image depth forward (``dummy_forward``) at
    the KITTI training resolution, 192x640."""
    dev = resolve_device(device)
    height, width = 192, 640
    model = flagship_model(height, width, device=dev)
    image = torch.zeros((1, height, width, 3), device=dev)

    def fn(image: torch.Tensor) -> Dict:
        with torch.inference_mode():
            return model.dummy_forward(image)

    return fn, (image,)

"""MonoDepth2 head: the depth forward and the eval prediction (counterpart of
``fsnet_tpu.models.heads.monodepth2_decoder.MonoDepth2Decoder``; its
self-supervised loss arrives with the training slice).

The constructor takes the JAX head's full option surface, so one config
dict builds either package; the loss options are stored for the loss.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from torch import nn

from ...utils.builder import build
from ..blocks import interpolate_bilinear


class MonoDepth2Decoder(nn.Module):
    """Depth head built from ``depth_decoder_cfg`` through the builder."""

    def __init__(self, scales: Sequence[int] = (0, 1, 2, 3), height: int = 192,
                 width: int = 640, frame_ids: Sequence[Any] = (0, 1, -1),
                 depth_decoder_cfg: Optional[Dict] = None,
                 pose_decoder_cfg: Optional[Dict] = None,
                 multiscale_head_cfg: Optional[Dict] = None,
                 min_depth: float = 0.1, max_depth: float = 100.0,
                 pose_loss_weight: float = 0.0,
                 distillation_loss_weight: float = 0.0,
                 residualflow_weight: float = 0.0,
                 is_unscaled_distill: bool = False,
                 is_uncertain_distill: bool = False,
                 overlapped_mask: bool = False, is_log_image: bool = True,
                 is_residual_flow: bool = False,
                 is_light_compensate: bool = False,
                 is_ssim_weight: bool = False,
                 learnable_photometric_uncertain: bool = False,
                 photometric_net_cfg: Optional[Dict] = None,
                 photometric_net_grad_weight: float = 0.05,
                 warp_impl: str = "band", warp_band: int = 4):
        super().__init__()
        if depth_decoder_cfg is None:
            raise ValueError("depth_decoder_cfg required")
        if pose_decoder_cfg is not None or learnable_photometric_uncertain:
            raise NotImplementedError("the pose decoder and the photometric "
                                      "uncertainty net come with later slices")
        self.scales = tuple(scales)
        self.height, self.width = height, width
        self.frame_ids = tuple(frame_ids)
        self.min_depth, self.max_depth = min_depth, max_depth
        self.loss_options = dict(
            pose_loss_weight=pose_loss_weight,
            distillation_loss_weight=distillation_loss_weight,
            residualflow_weight=residualflow_weight,
            is_unscaled_distill=is_unscaled_distill,
            is_uncertain_distill=is_uncertain_distill,
            overlapped_mask=overlapped_mask, is_log_image=is_log_image,
            is_residual_flow=is_residual_flow,
            is_light_compensate=is_light_compensate,
            is_ssim_weight=is_ssim_weight,
            photometric_net_grad_weight=photometric_net_grad_weight,
            multiscale_head_cfg=multiscale_head_cfg,
            photometric_net_cfg=photometric_net_cfg,
            warp_impl=warp_impl, warp_band=warp_band)
        self.depth_decoder = build(**dict(depth_decoder_cfg))

    def forward_depth(self, features, P2=None, train: bool = False) -> Dict:
        return self.depth_decoder(features, P2, train=train)

    def get_prediction(self, input_dict, output_dict) -> Dict:
        """Full-resolution depth for eval/export; ('depth', 0, 0) is
        upsampled from the finest scale if the decoder did not emit it."""
        if ("depth", 0, 0) in output_dict:
            depth = output_dict[("depth", 0, 0)]
        else:
            depth = interpolate_bilinear(
                output_dict[("depth", self.scales[0], self.scales[0])],
                self.height, self.width, align_corners=True)
        return dict(depth=depth)

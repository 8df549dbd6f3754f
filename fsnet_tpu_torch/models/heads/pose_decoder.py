"""6-DoF pose decoder on NHWC tensors (counterpart of
``fsnet_tpu.models.heads.pose_decoder.PoseDecoder``): a shared 1x1
``squeeze`` conv with ReLU per input feature pyramid, two 3x3 convs with
ReLU, a 1x1 conv to 6 values per frame, the mean over H and W, scaled by
0.01 and split into (axisangle, translation).

Its convs are :class:`~fsnet_tpu_torch.models.blocks.Conv` with biases
(``F.conv2d``, cuDNN on a CUDA device), as the JAX package runs them in XLA.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..blocks import Conv


class PoseDecoder(nn.Module):

    def __init__(self, num_ch_enc: Sequence[int] = (64, 64, 128, 256, 512),
                 num_input_features: int = 1,
                 num_frames_to_predict_for: Optional[int] = None,
                 stride: int = 1):
        super().__init__()
        self.n_frames = (num_input_features - 1
                         if num_frames_to_predict_for is None
                         else num_frames_to_predict_for)
        self.squeeze = Conv(num_ch_enc[-1], 256, 1, bias=True)
        self.pose_0 = Conv(256 * num_input_features, 256, 3, stride, 1,
                           bias=True)
        self.pose_1 = Conv(256, 256, 3, stride, 1, bias=True)
        self.pose_2 = Conv(256, 6 * self.n_frames, 1, bias=True)

    def forward(self, input_features) -> Tuple[torch.Tensor, torch.Tensor]:
        """``input_features``: a list of feature pyramids; only the last
        (coarsest) map of each is used. Returns (axisangle, translation),
        each [B, n_frames, 1, 3]."""
        cat = torch.cat([torch.relu(self.squeeze(f[-1]))
                         for f in input_features], dim=-1)
        out = torch.relu(self.pose_0(cat))
        out = torch.relu(self.pose_1(out))
        out = self.pose_2(out).mean(dim=(1, 2))
        out = 0.01 * out.reshape(-1, self.n_frames, 1, 6)
        return out[..., :3], out[..., 3:]

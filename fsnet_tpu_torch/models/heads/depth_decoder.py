"""Monodepth2-style U-Net depth decoders on NHWC tensors (counterpart of
``fsnet_tpu.models.heads.depth_decoder``).

Every 3x3 conv of the decoder (the ten upconvs and the replicate-padded
dispconvs) runs through :func:`fsnet_tpu_torch.ops.conv3x3.conv3x3`. The
skip concat is not built: the upsampled map and the skip go to the conv as
two parts, in the order ``[x, skip]``.

Output dict keys keep the reference's tuple-key protocol: ``('logits', s)``,
``('disp', s)``, ``('depth', s, s)`` and, from the uncertain variant,
``('uncertain_z', s)``; tensors are NHWC.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ...ops.depth_codec import build_depth_bins, gather_activation
from ...ops.geometry import depth_to_disp, disp_to_depth
from ..blocks import ConvBnReLU, Conv3x3, upsample2x_nearest

NUM_CH_DEC = (16, 32, 64, 128, 256)


class _RepConv(nn.Module):
    """3x3 dispconv with replicate padding (its parameters live under
    ``conv``, as in the JAX package)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv = Conv3x3(in_features, features, padding_mode="replicate")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class _DecoderTrunk(nn.Module):
    """The 5-stage up-conv trunk shared by the decoder variants; returns the
    stage feature maps for the stages in ``scales``."""

    def __init__(self, num_ch_enc: Sequence[int], scales: Sequence[int],
                 use_skips: bool = True):
        super().__init__()
        self.scales = tuple(scales)
        self.use_skips = use_skips
        for i in range(4, -1, -1):
            ch = NUM_CH_DEC[i]
            cin = num_ch_enc[-1] if i == 4 else NUM_CH_DEC[i + 1]
            self.add_module(f"upconv_{i}_0", ConvBnReLU(cin, ch))
            cin = ch + (num_ch_enc[i - 1] if use_skips and i > 0 else 0)
            self.add_module(f"upconv_{i}_1",
                            ConvBnReLU(cin, ch, padding_mode="replicate"))

    def forward(self, input_features: Sequence[torch.Tensor],
                train: bool = False) -> Dict[int, torch.Tensor]:
        stage_feats = {}
        x = input_features[-1].contiguous()
        for i in range(4, -1, -1):
            x = getattr(self, f"upconv_{i}_0")(x, train)
            x = upsample2x_nearest(x)
            if self.use_skips and i > 0:
                x = (x, input_features[i - 1].contiguous())
            x = getattr(self, f"upconv_{i}_1")(x, train)
            if i in self.scales:
                stage_feats[i] = x
        return stage_feats


def _get_scale(P2: Optional[torch.Tensor], base_fx: Optional[float]):
    """fx-aware depth scale [B, 1, 1, 1] or 1."""
    if base_fx is None or P2 is None:
        return 1.0
    return (P2[:, 0, 0] / base_fx).reshape(-1, 1, 1, 1)


class _DecoderBase(nn.Module):
    def __init__(self, num_ch_enc, scales, num_output_channels, use_skips):
        super().__init__()
        self.scales = tuple(scales)
        self.trunk = _DecoderTrunk(num_ch_enc, scales, use_skips)
        for i in self.scales:
            self.add_module(f"dispconv_{i}",
                            _RepConv(NUM_CH_DEC[i], num_output_channels))

    def dispconv(self, i: int, feat: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"dispconv_{i}")(feat)


class DepthDecoder(_DecoderBase):
    """Sigmoid-disparity variant."""

    def __init__(self, num_ch_enc: Sequence[int] = (64, 64, 128, 256, 512),
                 scales: Sequence[int] = (0, 1, 2, 3),
                 num_output_channels: int = 1, use_skips: bool = True,
                 min_depth: float = 0.1, max_depth: float = 100.0,
                 base_fx: Optional[float] = None):
        super().__init__(num_ch_enc, scales, num_output_channels, use_skips)
        self.min_depth, self.max_depth, self.base_fx = min_depth, max_depth, base_fx

    def forward(self, input_features, P2=None, train: bool = False) -> Dict:
        outputs = {}
        depth_scale = _get_scale(P2, self.base_fx)
        feats = self.trunk(input_features, train)
        for i in self.scales:
            logits = self.dispconv(i, feats[i])
            outputs[("logits", i)] = logits
            disp = torch.sigmoid(logits)
            outputs[("disp", i)] = disp
            _, depth = disp_to_depth(disp, self.min_depth, self.max_depth)
            outputs[("depth", i, i)] = depth * depth_scale
        return outputs


class MultiChannelDepthDecoder(_DecoderBase):
    """Softmax-over-depth-bins variant, the flagship decoder."""

    def __init__(self, num_ch_enc: Sequence[int] = (64, 64, 128, 256, 512),
                 scales: Sequence[int] = (0, 1, 2, 3),
                 num_output_channels: int = 16, use_skips: bool = True,
                 min_depth: float = 0.1, max_depth: float = 100.0,
                 base_fx: Optional[float] = None):
        super().__init__(num_ch_enc, scales, num_output_channels, use_skips)
        self.min_depth, self.max_depth, self.base_fx = min_depth, max_depth, base_fx
        self.register_buffer("depth_bins", torch.from_numpy(build_depth_bins(
            min_depth, max_depth, num_output_channels)), persistent=False)

    def gather_output(self, output_logits, depth_scale):
        """Bins -> (depth, disp) with fx-aware min/max."""
        depth = gather_activation(output_logits, self.depth_bins)
        if self.base_fx is not None:
            depth = depth * depth_scale
        disp = depth_to_disp(depth, self.min_depth * depth_scale,
                             self.max_depth * depth_scale)
        return depth, disp

    def forward(self, input_features, P2=None, train: bool = False) -> Dict:
        outputs = {}
        depth_scale = _get_scale(P2, self.base_fx)
        feats = self.trunk(input_features, train)
        for i in self.scales:
            logits = self.dispconv(i, feats[i])
            outputs[("logits", i)] = logits
            outputs[("depth", i, i)], outputs[("disp", i)] = self.gather_output(
                logits, depth_scale)
        return outputs


class MultiChannelDepthDecoderUncertain(MultiChannelDepthDecoder):
    """The softmax-over-bins decoder plus a per-scale uncertainty: a
    replicate-padded 3x3 conv to one channel (``uncertain_logz_{s}``, through
    the same conv kernel as the dispconvs) and its sigmoid as
    ``('uncertain_z', s)``, the distillation student's decoder. The depth
    scale multiplies the depth whether or not ``base_fx`` is set (1 without
    it), and there is no ``('logits', s)`` output."""

    def __init__(self, num_ch_enc: Sequence[int] = (64, 64, 128, 256, 512),
                 scales: Sequence[int] = (0, 1, 2, 3),
                 num_output_channels: int = 16, use_skips: bool = True,
                 min_depth: float = 0.1, max_depth: float = 100.0,
                 base_fx: Optional[float] = None):
        super().__init__(num_ch_enc, scales, num_output_channels, use_skips,
                         min_depth, max_depth, base_fx)
        for i in self.scales:
            self.add_module(f"uncertain_logz_{i}", _RepConv(NUM_CH_DEC[i], 1))

    def forward(self, input_features, P2=None, train: bool = False) -> Dict:
        outputs = {}
        depth_scale = _get_scale(P2, self.base_fx)
        feats = self.trunk(input_features, train)
        for i in self.scales:
            x = feats[i]
            depth = gather_activation(self.dispconv(i, x), self.depth_bins)
            depth = depth * depth_scale
            outputs[("depth", i, i)] = depth
            outputs[("disp", i)] = depth_to_disp(
                depth, self.min_depth * depth_scale,
                self.max_depth * depth_scale)
            outputs[("uncertain_z", i)] = torch.sigmoid(
                getattr(self, f"uncertain_logz_{i}")(x))
        return outputs

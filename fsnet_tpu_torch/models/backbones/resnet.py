"""ResNet-{18,34} multi-scale feature backbone on NHWC tensors (counterpart
of ``fsnet_tpu.models.backbones.resnet``).

``out_indices`` selects the returned maps: -1 is the post-stem activation
before the max pool, 0..3 the stage outputs. The stem is the plain 7x7/s2
conv with padding 3; the encoder's convs run ``F.conv2d`` (cuDNN on a CUDA
device) on channels-last views, with the explicit paddings of the JAX
package.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from ..blocks import BatchNorm, Conv, max_pool_3x3_s2_p1

_LAYERS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
}

PLANES = (64, 128, 256, 512)


def _conv(in_features: int, features: int, kernel: int, stride: int = 1,
          dilation: int = 1) -> Conv:
    pad = dilation if kernel == 3 else (3 if kernel == 7 else 0)
    return Conv(in_features, features, kernel, stride, pad, dilation)


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity/projection residual."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False,
                 norm_frozen: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = BatchNorm(planes, frozen=norm_frozen)
        self.conv2 = _conv(planes, planes, 3, 1, dilation)
        self.bn2 = BatchNorm(planes, frozen=norm_frozen)
        self.has_downsample = has_downsample
        if has_downsample:
            self.downsample_conv = Conv(inplanes, planes * self.expansion, 1,
                                        stride)
            self.downsample_bn = BatchNorm(planes * self.expansion,
                                           frozen=norm_frozen)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        residual = x
        out = torch.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x), train)
        return torch.relu(out + residual)


class ResNet(nn.Module):
    """Multi-scale ResNet feature extractor returning a list of NHWC maps."""

    def __init__(self, block_type: str = "basic",
                 layers: Tuple[int, ...] = (2, 2, 2, 2), num_stages: int = 4,
                 strides: Tuple[int, ...] = (1, 2, 2, 2),
                 dilations: Tuple[int, ...] = (1, 1, 1, 1),
                 out_indices: Tuple[int, ...] = (-1, 0, 1, 2, 3),
                 frozen_stages: int = -1, norm_eval: bool = True,
                 num_input_images: int = 1):
        super().__init__()
        if block_type != "basic":
            raise NotImplementedError(
                "the port's ResNet has BasicBlock depths (18, 34) only")
        if not 1 <= num_stages <= 4 or max(out_indices) >= num_stages:
            raise ValueError(f"out_indices {out_indices} need stages "
                             f"1..4, got num_stages={num_stages}")
        self.num_stages = num_stages
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        frozen = norm_eval  # norm_eval freezes BN stats even in training
        self.conv1 = _conv(3 * num_input_images, 64, 7, 2)
        self.bn1 = BatchNorm(64, frozen=frozen)

        inplanes = 64
        self.blocks: List[List[str]] = []
        for i in range(num_stages):
            planes = PLANES[i]
            names = []
            for b in range(layers[i]):
                # torch quirk kept for weight parity: the first block of a
                # stage always runs dilation 1
                stride = strides[i] if b == 0 else 1
                has_ds = b == 0 and (stride != 1 or inplanes != planes)
                name = f"layer{i + 1}_{b}"
                self.add_module(name, BasicBlock(
                    inplanes, planes, stride=stride,
                    dilation=1 if b == 0 else dilations[i],
                    has_downsample=has_ds, norm_frozen=frozen))
                names.append(name)
                inplanes = planes
            self.blocks.append(names)

    def forward(self, x: torch.Tensor, train: bool = False) -> List[torch.Tensor]:
        outs = []
        x = torch.relu(self.bn1(self.conv1(x), train))
        if -1 in self.out_indices:
            outs.append(x)
        x = max_pool_3x3_s2_p1(x)
        for i, names in enumerate(self.blocks):
            for name in names:
                x = getattr(self, name)(x, train)
            if i in self.out_indices:
                outs.append(x)
        return outs


def resnet(depth: int, pretrained: bool = False, pretrained_path: str = "",
           **kwargs) -> ResNet:
    """Config-facing factory. Weights come from ``models.flax_convert`` or
    from :func:`fsnet_tpu_torch.models.blocks.init_params`; ``pretrained``
    is accepted for config compatibility."""
    if depth not in _LAYERS:
        raise ValueError("Unsupported model depth for the port, must be one "
                         f"of {sorted(_LAYERS)}")
    block_type, layers = _LAYERS[depth]
    kwargs.pop("pretrained_backbone", None)
    return ResNet(block_type=block_type, layers=layers, **kwargs)

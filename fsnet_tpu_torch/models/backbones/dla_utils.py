"""DLA upsampling head with deformable-conv aggregation on NHWC tensors
(counterpart of ``fsnet_tpu.models.backbones.dla_utils``:
``ModulatedDeformConvPack``, ``DeformConv``, ``_GroupedDeconvUp``,
``IDAUp``, ``DLAUp`` and ``DLASegUpsample``).

Submodules keep the JAX package's scope names (``conv``, ``bn``,
``conv_offset``, ``proj_i``, ``up_i``, ``node_i``, ``ida_i``, ``dla_up``,
``ida_up``), so ``models.flax_convert`` maps a flax checkpoint onto them.
The modules are built with their input channels (flax infers them).
Random initialisation follows the JAX modules: the offset conv is zero
(every DCN starts as a plain conv with masks of 0.5), the DCN weight is
uniform in +-1/sqrt(K*K*Cin), the deconv kernels bilinear.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.dcn import modulated_deform_conv
from ..blocks import BatchNorm, Conv


class ModulatedDeformConvPack(nn.Module):
    """DCNv2 whose offsets and masks come from its own conv
    (``conv_offset``: 2*K*K offsets, then K*K mask logits); ``weight``
    [K, K, Cin, Cout] stays HWIO, the JAX layout, and keeps its flax leaf
    name (``flax_leaves``, read by ``models.flax_convert``)."""

    flax_leaves = {"weight": "weight"}

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1,
                 warp_band: int = 8):
        super().__init__()
        K = kernel_size
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.warp_band = warp_band
        self.conv_offset = Conv(in_features, 3 * K * K, K, stride, padding,
                                bias=True)
        self.weight = nn.Parameter(torch.empty(K, K, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def init_own_params(self, generator: torch.Generator) -> None:
        limit = 1.0 / math.sqrt(self.weight[..., 0].numel())
        u = torch.rand(self.weight.shape, generator=generator,
                       dtype=torch.float64)
        with torch.no_grad():
            self.weight.copy_((2 * u - 1) * limit)
            self.bias.zero_()
            self.conv_offset.weight.zero_()
            self.conv_offset.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        KK = self.weight.shape[0] ** 2
        off_mask = self.conv_offset(x)
        return modulated_deform_conv(
            x, off_mask[..., :2 * KK], torch.sigmoid(off_mask[..., 2 * KK:]),
            self.weight, self.bias, self.stride, self.padding, self.dilation,
            self.warp_band)


class DeformConv(nn.Module):
    """DCN -> BN -> ReLU."""

    def __init__(self, chi: int, cho: int, norm_frozen: bool = False):
        super().__init__()
        self.conv = ModulatedDeformConvPack(chi, cho)
        self.bn = BatchNorm(cho, frozen=norm_frozen)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x), train))


def bilinear_upsample_kernel(f: int, channels: int) -> np.ndarray:
    """The bilinear deconv kernel [2f, 2f, 1, channels] (HWIO, one input
    channel per group) of ``dla_utils._bilinear_upsample_kernel``."""
    k = 2 * f
    fk = math.ceil(k / 2)
    c = (2 * fk - 1 - fk % 2) / (2.0 * fk)
    w1d = np.array([1 - abs(i / fk - c) for i in range(k)], dtype=np.float32)
    return np.tile((w1d[:, None] * w1d[None, :])[:, :, None, None],
                   (1, 1, 1, channels))


class _GroupedDeconvUp(nn.Module):
    """x``f`` upsample by a grouped deconv, kernel [2f, 2f, 1, C] (HWIO, the
    JAX layout; bilinear at init, learned after). The JAX package computes
    it as a correlation over the f-dilated input padded by (3f-2)//2, with
    the kernel as it is; ``F.conv_transpose2d`` correlates with the
    flipped kernel, so the kernel is flipped here: the two agree for any
    kernel, not only the symmetric bilinear one. Identity for f = 1."""

    def __init__(self, channels: int, f: int):
        super().__init__()
        self.f = f
        if f != 1:
            self.weight = nn.Parameter(torch.empty(2 * f, 2 * f, 1, channels))

    def init_own_params(self, generator: torch.Generator) -> None:
        if self.f != 1:
            with torch.no_grad():
                self.weight.copy_(torch.from_numpy(bilinear_upsample_kernel(
                    self.f, self.weight.shape[-1])))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.f == 1:
            return x
        k, C = self.weight.shape[0], self.weight.shape[-1]
        w = self.weight.permute(3, 2, 0, 1).flip(2, 3)      # [C, 1, k, k]
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=self.f,
                               padding=k - 1 - (3 * self.f - 2) // 2,
                               groups=C)
        return y.permute(0, 2, 3, 1)


class IDAUp(nn.Module):
    """Iterative deep aggregation: for i in (startp, endp) layer i goes
    through ``proj_i`` (DeformConv to ``o`` channels), ``up_i`` (x
    ``up_f[i]``) and, summed with layer i - 1, ``node_i``."""

    def __init__(self, o: int, channels: Sequence[int], up_f: Sequence[int],
                 norm_frozen: bool = False):
        super().__init__()
        self.n = len(channels)
        for idx in range(1, self.n):
            self.add_module(f"proj_{idx}", DeformConv(channels[idx], o,
                                                      norm_frozen))
            self.add_module(f"up_{idx}", _GroupedDeconvUp(o, int(up_f[idx])))
            self.add_module(f"node_{idx}", DeformConv(o, o, norm_frozen))

    def forward(self, layers: Sequence[torch.Tensor], startp: int, endp: int,
                train: bool = False) -> List[torch.Tensor]:
        if endp - startp != self.n:
            raise ValueError(f"IDAUp built for {self.n} layers, called on "
                             f"{endp - startp}")
        layers = list(layers)
        for i in range(startp + 1, endp):
            idx = i - startp
            x = getattr(self, f"proj_{idx}")(layers[i], train)
            x = getattr(self, f"up_{idx}")(x)
            layers[i] = getattr(self, f"node_{idx}")(x + layers[i - 1], train)
        return layers


class DLAUp(nn.Module):
    """The DLA upsampling pyramid over ``startp + len(channels)`` layers:
    ``ida_i`` for i < len(channels) - 1, channels and scales updated as
    ``dla_utils.DLAUp`` does after each."""

    def __init__(self, startp: int, channels: Sequence[int],
                 scales: Sequence[int], norm_frozen: bool = False):
        super().__init__()
        self.startp = startp
        channels = list(channels)
        in_channels = list(channels)
        scales = np.array(scales, dtype=int)
        self.n = len(channels) - 1
        for i in range(self.n):
            j = -i - 2
            self.add_module(f"ida_{i}", IDAUp(
                channels[j], in_channels[j:], list(scales[j:] // scales[j]),
                norm_frozen))
            scales[j + 1:] = scales[j]
            in_channels[j + 1:] = [channels[j] for _ in channels[j + 1:]]

    def forward(self, layers: Sequence[torch.Tensor],
                train: bool = False) -> List[torch.Tensor]:
        layers = list(layers)
        if len(layers) != self.startp + self.n + 1:
            raise ValueError(f"DLAUp built for {self.startp + self.n + 1} "
                             f"layers, called on {len(layers)}")
        out = [layers[-1]]
        for i in range(self.n):
            layers = getattr(self, f"ida_{i}")(layers, len(layers) - i - 2,
                                               len(layers), train)
            out.insert(0, layers[-1])
        return out


class DLASegUpsample(nn.Module):
    """The DLASeg upsampling head: ``dla_up`` over the pyramid from level
    log2(down_ratio), then ``ida_up`` over its first ``last_level -
    first_level`` maps; returns the last, at 1/down_ratio resolution with
    ``out_channel or input_channels[first_level]`` channels. (The JAX
    module's unused ``final_kernel`` field is left out.)"""

    def __init__(self, input_channels: Sequence[int], down_ratio: int = 4,
                 last_level: int = 5, out_channel: int = 0,
                 norm_frozen: bool = False):
        super().__init__()
        if down_ratio not in (2, 4, 8, 16):
            raise ValueError(f"down_ratio {down_ratio}: 2, 4, 8 or 16")
        self.first_level = int(np.log2(down_ratio))
        self.last_level = last_level
        channels = list(input_channels)
        fl = self.first_level
        self.dla_up = DLAUp(fl, channels[fl:],
                            [2 ** i for i in range(len(channels[fl:]))],
                            norm_frozen)
        self.ida_up = IDAUp(out_channel or channels[fl],
                            channels[fl:last_level],
                            [2 ** i for i in range(last_level - fl)],
                            norm_frozen)

    def forward(self, tensors: Sequence[torch.Tensor],
                train: bool = False) -> torch.Tensor:
        tensors = self.dla_up(tensors, train)
        y = list(tensors[:self.last_level - self.first_level])
        return self.ida_up(y, 0, len(y), train)[-1]

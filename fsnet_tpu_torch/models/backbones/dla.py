"""Deep Layer Aggregation trunk on NHWC tensors (counterpart of
``fsnet_tpu.models.backbones.dla``: ``DLABasicBlock``, ``DLABottleneck``
(cardinality > 1 is BottleneckX, a grouped conv), ``Root``, ``Tree``,
``DLA``, ``_FACTORIES`` and ``dlanet`` at depths 34/46/60/102/169).

Submodules keep the JAX package's scope names (``base_conv``,
``level0_conv0``, ``levelN``, ``tree1``, ``tree2``, ``root``,
``project_conv``, ``conv1``...), so ``models.flax_convert`` maps a flax
checkpoint onto them; the modules are built with their input channels,
which flax infers. The convs run ``F.conv2d`` (cuDNN on a CUDA device), as
the JAX package left them to XLA. As in the JAX package (and the reference),
a Tree of more than one level computes its own projection of the residual
and its children ignore it: those weights get no gradient, while their BN
statistics are updated.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..blocks import BatchNorm, Conv


def _conv(in_features: int, features: int, k: int, stride: int = 1,
          dilation: int = 1, groups: int = 1) -> Conv:
    pad = dilation if k == 3 else (3 if k == 7 else (k - 1) // 2)
    return Conv(in_features, features, k, stride, pad, dilation,
                groups=groups)


def _max_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Max pool with window = stride, VALID, on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), stride, stride).permute(
        0, 2, 3, 1)


class DLABasicBlock(nn.Module):
    """Two 3x3 convs; the residual is passed in by the Tree."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, norm_frozen: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dilation)
        self.bn1 = BatchNorm(planes, frozen=norm_frozen)
        self.conv2 = _conv(planes, planes, 3, 1, dilation)
        self.bn2 = BatchNorm(planes, frozen=norm_frozen)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        if residual is None:
            residual = x
        out = torch.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        return torch.relu(out + residual)


class DLABottleneck(nn.Module):
    """1x1 -> 3x3 (grouped by ``cardinality``) -> 1x1, the residual passed
    in. The bottleneck width is ``planes * cardinality // 32`` for
    BottleneckX (cardinality > 1), else ``planes // expansion``."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, expansion: int = 2, cardinality: int = 1,
                 norm_frozen: bool = False):
        super().__init__()
        bottle = (planes * cardinality // 32 if cardinality > 1
                  else planes // expansion)
        self.conv1 = _conv(inplanes, bottle, 1)
        self.bn1 = BatchNorm(bottle, frozen=norm_frozen)
        self.conv2 = _conv(bottle, bottle, 3, stride, dilation,
                           groups=cardinality)
        self.bn2 = BatchNorm(bottle, frozen=norm_frozen)
        self.conv3 = _conv(bottle, planes, 1)
        self.bn3 = BatchNorm(planes, frozen=norm_frozen)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        if residual is None:
            residual = x
        out = torch.relu(self.bn1(self.conv1(x), train))
        out = torch.relu(self.bn2(self.conv2(out), train))
        out = self.bn3(self.conv3(out), train)
        return torch.relu(out + residual)


class Root(nn.Module):
    """Aggregation node: conv over the channel concat of the children, BN,
    optionally + the first child, ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, residual: bool = False,
                 norm_frozen: bool = False):
        super().__init__()
        self.residual = residual
        self.conv = _conv(in_channels, out_channels, kernel_size)
        self.bn = BatchNorm(out_channels, frozen=norm_frozen)

    def forward(self, *children: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        x = self.bn(self.conv(torch.cat(children, dim=-1)), train)
        if self.residual:
            x = x + children[0]
        return torch.relu(x)


class Tree(nn.Module):
    """Recursive aggregation tree (``block``: 'basic', 'bottleneck' or
    'bottleneckx')."""

    def __init__(self, levels: int, block: str, in_channels: int,
                 out_channels: int, stride: int = 1, level_root: bool = False,
                 root_dim: int = 0, root_kernel_size: int = 1,
                 dilation: int = 1, root_residual: bool = False,
                 expansion: int = 2, norm_frozen: bool = False):
        super().__init__()
        self.levels, self.stride, self.level_root = levels, stride, level_root
        root_dim = root_dim or 2 * out_channels
        if level_root:
            root_dim += in_channels
        self.project = in_channels != out_channels
        if self.project:
            self.project_conv = _conv(in_channels, out_channels, 1)
            self.project_bn = BatchNorm(out_channels, frozen=norm_frozen)

        def block_(inplanes, planes, stride_):
            if block == "basic":
                return DLABasicBlock(inplanes, planes, stride_, dilation,
                                     norm_frozen)
            return DLABottleneck(inplanes, planes, stride_, dilation,
                                 expansion,
                                 32 if block == "bottleneckx" else 1,
                                 norm_frozen)

        if levels == 1:
            self.tree1 = block_(in_channels, out_channels, stride)
            self.tree2 = block_(out_channels, out_channels, 1)
            self.root = Root(root_dim, out_channels, root_kernel_size,
                             root_residual, norm_frozen)
            return
        sub = dict(root_kernel_size=root_kernel_size, dilation=dilation,
                   root_residual=root_residual, expansion=expansion,
                   norm_frozen=norm_frozen)
        self.tree1 = Tree(levels - 1, block, in_channels, out_channels,
                          stride, root_dim=0, **sub)
        self.tree2 = Tree(levels - 1, block, out_channels, out_channels,
                          root_dim=root_dim + out_channels, **sub)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                children: Optional[Sequence[torch.Tensor]] = None,
                train: bool = False) -> torch.Tensor:
        children = [] if children is None else list(children)
        bottom = _max_pool(x, self.stride) if self.stride > 1 else x
        residual = (self.project_bn(self.project_conv(bottom), train)
                    if self.project else bottom)
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            x1 = self.tree1(x, residual, train=train)
            x2 = self.tree2(x1, train=train)
            return self.root(x2, x1, *children, train=train)
        x1 = self.tree1(x, residual, train=train)
        children.append(x1)
        return self.tree2(x1, children=children, train=train)


class DLA(nn.Module):
    """7-scale trunk on RGB input: ``out_indices`` selects from -1 (base)
    and levels 0..5, at scales 1, 1, 2, 4, 8, 16, 32."""

    def __init__(self, levels: Sequence[int] = (1, 1, 1, 2, 2, 1),
                 channels: Sequence[int] = (16, 32, 64, 128, 256, 512),
                 block: str = "basic", residual_root: bool = False,
                 expansion: int = 2,
                 out_indices: Tuple[int, ...] = (-1, 0, 1, 2, 3, 4, 5),
                 norm_eval: bool = False):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.levels = tuple(levels)
        frozen = norm_eval
        ch = channels
        self.base_conv = _conv(3, ch[0], 7)
        self.base_bn = BatchNorm(ch[0], frozen=frozen)
        for lvl, (planes, stride, prev) in enumerate(((ch[0], 1, ch[0]),
                                                      (ch[1], 2, ch[0]))):
            for i in range(levels[lvl]):
                self.add_module(f"level{lvl}_conv{i}", _conv(
                    prev if i == 0 else planes, planes, 3,
                    stride if i == 0 else 1))
                self.add_module(f"level{lvl}_bn{i}",
                                BatchNorm(planes, frozen=frozen))
        in_ch = ch[1]
        for lvl in range(2, 6):
            self.add_module(f"level{lvl}", Tree(
                levels[lvl], block, in_ch, ch[lvl], 2,
                level_root=lvl != 2, root_residual=residual_root,
                expansion=expansion, norm_frozen=frozen))
            in_ch = ch[lvl]

    def forward(self, x: torch.Tensor,
                train: bool = False) -> List[torch.Tensor]:
        y = []
        x = torch.relu(self.base_bn(self.base_conv(x), train))
        if -1 in self.out_indices:
            y.append(x)
        for lvl in (0, 1):
            for i in range(self.levels[lvl]):
                x = torch.relu(getattr(self, f"level{lvl}_bn{i}")(
                    getattr(self, f"level{lvl}_conv{i}")(x), train))
            if lvl in self.out_indices:
                y.append(x)
        for lvl in range(2, 6):
            x = getattr(self, f"level{lvl}")(x, train=train)
            if lvl in self.out_indices:
                y.append(x)
        return y


_FACTORIES = {
    34: dict(levels=(1, 1, 1, 2, 2, 1), channels=(16, 32, 64, 128, 256, 512),
             block="basic"),
    46: dict(levels=(1, 1, 1, 2, 2, 1), channels=(16, 32, 64, 64, 128, 256),
             block="bottleneck", expansion=2),
    60: dict(levels=(1, 1, 1, 2, 3, 1), channels=(16, 32, 128, 256, 512, 1024),
             block="bottleneck", expansion=2),
    102: dict(levels=(1, 1, 1, 3, 4, 1),
              channels=(16, 32, 128, 256, 512, 1024), block="bottleneck",
              expansion=2, residual_root=True),
    169: dict(levels=(1, 1, 2, 3, 5, 1),
              channels=(16, 32, 128, 256, 512, 1024), block="bottleneck",
              expansion=2, residual_root=True),
}


def dlanet(depth: int = 34, pretrained=None, **kwargs) -> DLA:
    """The DLA of ``depth`` (``dla.py:427-439``); ``kwargs`` override the
    factory's fields. ``pretrained`` is accepted for config compatibility;
    weights come from ``models.flax_convert`` or
    :func:`fsnet_tpu_torch.models.blocks.init_params`."""
    if depth not in _FACTORIES:
        raise ValueError(f"DLA depth {depth}: one of {sorted(_FACTORIES)}")
    cfg = dict(_FACTORIES[depth])
    kwargs.pop("pretrained", None)
    cfg.update(kwargs)
    return DLA(**cfg)

"""Network blocks on NHWC tensors (counterpart of ``fsnet_tpu.models.blocks``).

Every block takes and returns NHWC tensors, as the JAX package does, and
takes ``train`` at call time. Parameters keep the JAX package's names one to
one (``kernel`` -> ``weight``, BN ``scale`` -> ``weight``, ``mean``/``var``
-> ``running_mean``/``running_var``), so ``models.flax_convert`` maps a flax
checkpoint onto them by name.

Random initialisation mirrors flax's defaults (truncated-normal LeCun
kernels, zero biases, identity BatchNorm) and draws only from the
``torch.Generator`` passed to :func:`init_params`.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv3x3 import PAD_MODES, conv3x3, conv3x3_bn, is_low


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis of an NHWC tensor.

    Eval (or ``frozen``) uses the running statistics; training normalises
    with the biased batch variance and updates the running statistics as
    flax does: ``ra = 0.9 * ra + (1 - 0.9) * batch``. eps 1e-5.

    On a bfloat16 input (the bf16 train step, whose parameters arrive as
    bfloat16 copies) this is flax 0.12.3's ``nn.BatchNorm`` on the bf16
    tree that ``fsnet_tpu.runtime.state`` casts: the running statistics are
    read rounded to bfloat16; in training the batch statistics are float32
    (the variance clamped at 0), the normalisation runs in float32 and is
    rounded to bfloat16, and the update ``bf16(bf16(0.9) * ra) + 0.1 *
    batch`` is float32, written back to the float32 buffers; in eval every
    operation is bfloat16."""

    momentum = 0.9      # flax convention (torch momentum 0.1)
    eps = 1e-5
    _deferred = None    # the updates gathered by deferred_updates()

    def __init__(self, num_features: int, frozen: bool = False):
        super().__init__()
        self.frozen = frozen
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def update_stats(self, mean: torch.Tensor, var: torch.Tensor,
                     dtype: torch.dtype) -> None:
        """The momentum update from the batch statistics of an input of
        ``dtype``: the old statistics are read in ``dtype`` and scaled there
        by the momentum in ``dtype``, and the sum is taken in the
        statistics' own dtype (at their own dtype ``0.9 ra + 0.1 batch``;
        in bfloat16 flax's update on the cast tree)."""
        if BatchNorm._deferred is not None:
            BatchNorm._deferred.append((self, mean.detach(), var.detach(),
                                        dtype))
            return
        _momentum_update(self.running_mean, mean.detach(), dtype)
        _momentum_update(self.running_var, var.detach(), dtype)

    def normalize(self, x: torch.Tensor, mean: torch.Tensor,
                  var: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean) * mul + self.bias).to(x.dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train and not self.frozen:
            dims = tuple(range(x.dim() - 1))
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xf.mean(dim=dims)
            var = (xf * xf).mean(dim=dims) - mean * mean
            if is_low(x.dtype):
                var = var.clamp_min(0.0)
            self.update_stats(mean, var, x.dtype)
        else:
            mean, var = self.running_mean, self.running_var
            if is_low(x.dtype):
                mean, var = mean.to(x.dtype), var.to(x.dtype)
        return self.normalize(x, mean, var)


def _momentum_update(ra: torch.Tensor, batch: torch.Tensor,
                     dtype: torch.dtype) -> None:
    """``ra <- (ra in dtype * 0.9 in dtype) + 0.1 batch`` in place, the sum
    in ``ra``'s dtype, elementwise: the running statistics ``ra`` of one BN,
    or those of many concatenated."""
    m = torch.tensor(BatchNorm.momentum, dtype=dtype)
    with torch.no_grad():
        torch.add((ra.to(dtype) * m).to(ra.dtype),
                  batch * (1 - BatchNorm.momentum), out=ra)


@contextlib.contextmanager
def deferred_updates():
    """Within the block, every :meth:`BatchNorm.update_stats` is gathered
    and none applied; on a normal exit they are applied in a few launches,
    in order: a module updated twice takes its second update from the
    result of its first. (The bf16 train step's forward: no BN reads its
    running statistics in training.)"""
    if BatchNorm._deferred is not None:
        raise RuntimeError("deferred_updates does not nest")
    BatchNorm._deferred = pending = []
    try:
        yield
    finally:
        BatchNorm._deferred = None
    while pending:
        done, rest = set(), []
        stats, batch = [], []
        dtype = pending[0][3]
        for item in pending:
            bn, mean, var, dt = item
            if bn in done or dt != dtype:
                rest.append(item)
            else:
                stats += [bn.running_mean, bn.running_var]
                batch += [mean, var]
            done.add(bn)
        flat = torch.cat([t.reshape(-1) for t in stats])
        _momentum_update(flat, torch.cat([t.reshape(-1) for t in batch]),
                         dtype)
        torch._foreach_copy_(stats, [t.view_as(r) for t, r in zip(
            flat.split([t.numel() for t in stats]), stats)])
        pending = rest


class Conv(nn.Module):
    """Convolution on NHWC tensors (counterpart of the flax ``nn.Conv`` the
    JAX encoder and pose decoder use), bias-free unless ``bias``, grouped
    with ``groups``. The weight is OIHW, PyTorch's layout; the call runs
    ``F.conv2d`` on a channels-last view, so no copy is made."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias: bool = False, groups: int = 1):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                     self.stride, self.padding, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class Conv3x3(nn.Module):
    """Stride-1 3x3 conv with one-pixel ``zeros`` or ``replicate`` padding
    through :func:`fsnet_tpu_torch.ops.conv3x3.conv3x3` (the Hopper kernel on
    a CUDA device). The weight stays HWIO ``[3, 3, Cin, Co]``, the JAX
    layout the kernel reads. ``x`` may be a tuple of NHWC parts, convolved as
    their channel concat."""

    def __init__(self, in_features: int, out_features: int,
                 padding_mode: str = "zeros"):
        super().__init__()
        if padding_mode not in PAD_MODES:
            raise ValueError(f"padding_mode must be one of {PAD_MODES}")
        self.padding_mode = padding_mode
        self.weight = nn.Parameter(torch.empty(3, 3, in_features,
                                               out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x) -> torch.Tensor:
        return conv3x3(x, self.weight, self.bias, self.padding_mode)


class ConvBnReLU(nn.Module):
    """3x3 conv -> BN -> ReLU, the decoder's block. ``padding_mode``
    'zeros' or 'replicate' (the decoder's second upconv).

    In training the batch statistics come with the conv
    (:func:`~fsnet_tpu_torch.ops.conv3x3.conv3x3_bn`, the kernel's moments
    epilogue): mean = s1 / n, var = s2 / n - mean^2 over the n = B*H*W
    pixels, as ``fsnet_tpu.models.blocks.ConvBnReLU._call_packed``; on a
    bfloat16 input the moments are float32 sums of the stored bf16 output
    and the variance is clamped at 0, as flax's ``_compute_stats``."""

    def __init__(self, input_features: int, output_features: int,
                 padding_mode: str = "zeros"):
        super().__init__()
        self.conv = Conv3x3(input_features, output_features, padding_mode)
        self.norm = BatchNorm(output_features)

    def forward(self, x, train: bool = False) -> torch.Tensor:
        if not train or self.norm.frozen:
            return torch.relu(self.norm(self.conv(x), train))
        conv = self.conv
        y, s1, s2 = conv3x3_bn(x, conv.weight, conv.bias, conv.padding_mode)
        n = y.shape[0] * y.shape[1] * y.shape[2]
        mean = s1 / n
        var = s2 / n - mean * mean
        if is_low(y.dtype):
            var = var.clamp_min(0.0)
        self.norm.update_stats(mean, var, y.dtype)
        return torch.relu(self.norm.normalize(y, mean, var))


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of an NHWC tensor (contiguous result:
    from a 1x1 map ``reshape`` returns a view of stride 0, which the conv
    kernel's wrapper refuses)."""
    B, H, W, C = x.shape
    x = x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C)
    return x.reshape(B, H * 2, W * 2, C).contiguous()


def _interp_matrix(in_size: int, out_size: int, align_corners: bool,
                   dtype, device) -> torch.Tensor:
    """Dense 1D bilinear interpolation matrix [out, in] (two-hot rows)."""
    if align_corners and out_size > 1 and in_size > 1:
        pos = torch.linspace(0.0, in_size - 1.0, out_size, dtype=dtype,
                             device=device)
    else:
        pos = ((torch.arange(out_size, dtype=dtype, device=device) + 0.5)
               * (in_size / out_size) - 0.5).clamp(0.0, in_size - 1.0)
    i0 = torch.floor(pos).long()
    i1 = torch.clamp(i0 + 1, max=in_size - 1)
    f = pos - i0.to(dtype)
    cols = torch.arange(in_size, device=device)
    m = ((cols[None, :] == i0[:, None]) * (1.0 - f[:, None])
         + (cols[None, :] == i1[:, None]) * f[:, None])
    return m.to(dtype)


def interpolate_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                         align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of an NHWC tensor, as ``F.interpolate`` with
    ``align_corners``; separable, as two small matrix products."""
    B, H, W, C = x.shape
    Ay = _interp_matrix(H, out_h, align_corners, x.dtype, x.device)
    Ax = _interp_matrix(W, out_w, align_corners, x.dtype, x.device)
    x = torch.einsum("oh,bhwc->bowc", Ay, x)
    return torch.einsum("pw,bowc->bopc", Ax, x)


def adaptive_avg_pool2d(x: torch.Tensor, out_h: int,
                        out_w: int) -> torch.Tensor:
    """Adaptive average pool of an NHWC tensor, torch's window arithmetic:
    a reshape-mean when the sizes divide, else windows
    [floor(i H / out), ceil((i + 1) H / out))."""
    B, H, W, C = x.shape
    if H % out_h == 0 and W % out_w == 0:
        return x.reshape(B, out_h, H // out_h, out_w, W // out_w, C).mean(
            dim=(2, 4))
    rows = []
    for i in range(out_h):
        y0, y1 = (i * H) // out_h, -(-((i + 1) * H) // out_h)
        rows.append(torch.stack([
            x[:, y0:y1, (j * W) // out_w:-(-((j + 1) * W) // out_w)].mean(
                dim=(1, 2)) for j in range(out_w)], dim=1))
    return torch.stack(rows, dim=1)


def max_pool_3x3_s2_p1(x: torch.Tensor) -> torch.Tensor:
    """``MaxPool2d(kernel_size=3, stride=2, padding=1)`` on NHWC (the padding
    acts as -inf)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1)
    return y.permute(0, 2, 3, 1)


def _lecun_normal_(t: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal on [-2, 2] standard deviations,
    scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    # inverse-CDF sampling of a standard normal cut at [-2, 2]
    cut = math.erf(2 / math.sqrt(2))
    u = torch.rand(t.shape, generator=generator, dtype=torch.float64)
    v = torch.erfinv((2 * u - 1) * cut) * (std * math.sqrt(2.0))
    with torch.no_grad():
        t.copy_(v.clamp(-2 * std, 2 * std))


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every conv and BatchNorm under ``module`` as flax's
    defaults would, then every module with its own initialiser
    (``init_own_params``, as a JAX module with its own initializers), drawing
    only from ``generator``."""
    for m in module.modules():
        if isinstance(m, Conv):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, Conv3x3):
            _lecun_normal_(m.weight, m.weight[..., 0].numel(), generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, BatchNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    for m in module.modules():
        if hasattr(m, "init_own_params"):
            m.init_own_params(generator)

"""Modulated deformable convolution, DCNv2 (counterpart of
``fsnet_tpu.ops.dcn``: ``modulated_deform_conv`` and ``deform_conv``,
``dcn.py:26-89``, NHWC, offsets (dy, dx) per tap).

Each of the K*K taps samples the input at its regular position plus a
learned offset through a bilinear, zeros-padded band warp
(:func:`~fsnet_tpu_torch.ops.warp_fast.grid_sample` with ``image_grad``:
kernel E forward and kernel K backward on a CUDA device), scales the
sample by the tap's mask, and a 1x1 contraction over (tap, channel) sums
the taps. The JAX package runs one warp and one contraction per tap; the
port warps all K*K taps as one grid batch of K*K*B against the B inputs
(warp ``t*B + b`` reads input ``b``) and contracts them in one matrix
product, the im2col shape of the reference CUDA extension: one launch of
each warp kernel per conv instead of K*K. The taps are then summed in
another order than the JAX package's, which shows only in float32
rounding.
"""
from __future__ import annotations

from typing import Optional

import torch

from .conv3x3 import is_low
from .warp_fast import grid_sample


def tap_grid(offset: torch.Tensor, H: int, W: int, K: int, stride: int = 1,
             padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """The normalized sampling grid [K*K*B, Ho, Wo, 2] of every tap, tap
    ``t = ky*K + kx`` at rows ``t*B .. t*B + B - 1``, from ``offset``
    [B, Ho, Wo, 2*K*K] in pixels, built as ``dcn.py:55-63``: ``sy = (y*s -
    p + ky*d) + dy``, ``gy = sy / max(H-1, 1) * 2 - 1``, likewise x."""
    B, Ho, Wo = offset.shape[:3]
    dtype, dev = offset.dtype, offset.device
    ys = torch.arange(Ho, dtype=dtype, device=dev) * stride - padding
    xs = torch.arange(Wo, dtype=dtype, device=dev) * stride - padding
    taps = torch.arange(K, dtype=dtype, device=dev) * dilation
    off = offset.reshape(B, Ho, Wo, K, K, 2).permute(3, 4, 0, 1, 2, 5)
    sy = (ys[:, None] + taps[:, None, None, None, None]) + off[..., 0]
    sx = (xs[None, :] + taps[None, :, None, None, None]) + off[..., 1]
    gx = sx / max(W - 1, 1) * 2.0 - 1.0
    gy = sy / max(H - 1, 1) * 2.0 - 1.0
    return torch.stack([gx, gy], dim=-1).reshape(K * K * B, Ho, Wo, 2)


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor,
                          mask: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          stride: int = 1, padding: int = 1,
                          dilation: int = 1,
                          warp_band: int = 8) -> torch.Tensor:
    """``x`` [B, H, W, Cin], ``offset`` [B, Ho, Wo, 2*K*K] (dy, dx per tap,
    pixels), ``mask`` [B, Ho, Wo, K*K] (post-sigmoid), ``weight``
    [K, K, Cin, Cout] (HWIO), ``bias`` [Cout] -> [B, Ho, Wo, Cout],
    ``Ho = (H + 2p - d(K-1) - 1) / s + 1``."""
    if is_low(x.dtype):
        raise TypeError(f"the deformable conv takes float32, not {x.dtype}: "
                        "its kernels have no bfloat16 form yet")
    B, H, W, Cin = x.shape
    K, Cout = weight.shape[0], weight.shape[-1]
    Ho, Wo = offset.shape[1:3]
    grid = tap_grid(offset, H, W, K, stride, padding, dilation)
    sampled = grid_sample(x, grid, mode="bilinear",
                          padding_mode="zeros", band=warp_band,
                          image_grad=True).view(K * K, B, Ho, Wo, Cin)
    sampled = sampled * mask.permute(3, 0, 1, 2)[..., None]
    out = torch.einsum("tbhwc,tcd->bhwd", sampled,
                       weight.reshape(K * K, Cin, Cout))
    return out if bias is None else out + bias


def deform_conv(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, stride: int = 1,
                padding: int = 1, dilation: int = 1,
                warp_band: int = 8) -> torch.Tensor:
    """The non-modulated variant: every mask 1."""
    B, Ho, Wo = offset.shape[:3]
    K = weight.shape[0]
    ones = torch.ones((B, Ho, Wo, K * K), dtype=x.dtype, device=x.device)
    return modulated_deform_conv(x, offset, ones, weight, bias, stride,
                                 padding, dilation, warp_band)

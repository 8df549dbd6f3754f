"""Band-limited bilinear warp with border padding: its plain semantics
(counterpart of ``fsnet_tpu.ops.warp_fast._indices_and_weights`` and the
band gather, ``warp_fast.py:65-163``, bilinear/border, align_corners).

For each output row the source rows are limited to a band of ``band`` rows
starting at ``ymin``: the row-minimum of ``floor(y)`` (after the border
clamp), clipped to ``[0, H - band]`` and rounded down to even. Each sample's
two source rows are clamped into the band. This is the band-4 warp that the
JAX flagship trains with, not an exact ``grid_sample``: a sample whose rows
leave the band reads the band's edge row.
"""
from __future__ import annotations

from typing import Dict

import torch


def indices_and_weights(x: torch.Tensor, y: torch.Tensor, H: int, W: int,
                        band: int) -> Dict[str, torch.Tensor]:
    """Pixel coordinates ``x``, ``y`` [N, Ho, Wo] -> integer corners and
    fractions: x0c, x1c (columns), r0, r1 (source rows, inside the band),
    fx, fy (raw bilinear fractions, [N, Ho, Wo] f32) and ymin [N, Ho]."""
    xb = x.clamp(0.0, W - 1)
    yb = y.clamp(0.0, H - 1)
    x0f = torch.floor(xb)
    y0f = torch.floor(yb)
    x0c = x0f.long()
    y0c = y0f.long()
    x1c = (x0c + 1).clamp(max=W - 1)
    y1c = (y0c + 1).clamp(max=H - 1)
    ymin = y0c.amin(dim=2).clamp(0, max(H - band, 0))
    ymin = ymin - ymin % 2
    ym = ymin[:, :, None]
    return dict(x0c=x0c, x1c=x1c,
                r0=ym + (y0c - ym).clamp(0, band - 1),
                r1=ym + (y1c - ym).clamp(0, band - 1),
                fx=xb - x0f, fy=yb - y0f, ymin=ymin)


def band_sample(image: torch.Tensor, src: torch.Tensor, iw: Dict):
    """Gather the four corners of each sample from ``image`` [M, H, W, C]
    (warp n reads image ``src[n]``) and blend them. Returns
    (out, va = d out/d fx, vb = d out/d fy), each [N, Ho, Wo, C]."""
    M, H, W, C = image.shape
    flat = image.reshape(M * H * W, C)
    base = src.view(-1, 1, 1) * H

    def corner(r, c):
        return flat[((base + r) * W + c).reshape(-1)].reshape(*r.shape, C)

    i00, i01 = corner(iw["r0"], iw["x0c"]), corner(iw["r0"], iw["x1c"])
    i10, i11 = corner(iw["r1"], iw["x0c"]), corner(iw["r1"], iw["x1c"])
    fx = iw["fx"][..., None].to(image.dtype)
    fy = iw["fy"][..., None].to(image.dtype)
    wx0, wy0 = 1.0 - fx, 1.0 - fy
    h0 = i00 * wx0 + i01 * fx
    h1 = i10 * wx0 + i11 * fx
    out = h0 * wy0 + h1 * fy
    va = (i01 - i00) * wy0 + (i11 - i10) * fy
    return out, va, h1 - h0

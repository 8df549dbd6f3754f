"""Band-limited image warp by a sampling grid (counterpart of
``fsnet_tpu.ops.warp_fast``: ``_indices_and_weights``, the band gather and
``grid_sample_band`` with its custom VJP, ``warp_fast.py:65-399``;
align_corners, bilinear or nearest, border or zeros padding).

For each output row the source rows are limited to a band of ``band`` rows
starting at ``ymin``: the row-minimum of the clipped first corner row,
clipped to ``[0, H - band]`` and rounded down to even. Each sample's two
source rows are clamped into the band. This is the band-4 warp that the JAX
flagship trains with, not an exact ``grid_sample``: a sample whose rows
leave the band reads the band's edge row.

:func:`grid_sample` (``impl='band'``) is differentiable in the grid, and
with ``image_grad`` in the image too, as in the JAX package. Without
``image_grad`` the image cotangent is zero, a nearest warp's grid cotangent
is zero, and a bilinear warp's comes from ``va = d out/d fx`` and
``vb = d out/d fy``, which the forward emits. On a CUDA device the forward
is ``csrc/warp_grid.cu`` (kernel E, :func:`grid_band_fwd`; under grad a
bilinear warp takes kernel F, :func:`grid_band_fused`, which also writes
``va`` and ``vb``); on the CPU their plain versions, :func:`grid_band_plain`.
With ``image_grad`` (the deformable conv) the forward is kernel E and the
backward recomputes both cotangents from the image: ``csrc/warp_grad.cu``
(kernel K, :func:`grid_band_bwd`; plain version
:func:`grid_band_bwd_plain`). Warp ``n`` of a grid batch ``N`` reads image
``n mod M`` of an image batch ``M`` that divides it, and its image
cotangent goes to image ``n mod M``; nothing is tiled.
"""
from __future__ import annotations

from typing import Dict

import torch

from .conv3x3 import _entry, _raise_on, _route, _stream

MODES = ("bilinear", "nearest")
PADDINGS = ("border", "zeros")
_DTYPES = (torch.float32,)


def unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """[-1, 1] -> pixel coordinate (align_corners)."""
    return (coord + 1.0) / 2.0 * (size - 1)


def indices_and_weights(x: torch.Tensor, y: torch.Tensor, H: int, W: int,
                        band: int, mode: str = "bilinear",
                        padding: str = "border") -> Dict[str, torch.Tensor]:
    """Pixel coordinates ``x``, ``y`` [N, Ho, Wo] -> integer corners x0c,
    x1c (columns), r0, r1 (source rows, inside the band), the corner weights
    wx0, wx1, wy0, wy1 with the zeros-padding masks folded in, the corners'
    validity mx0, mx1, my0, my1 (1.0 under border padding) and ymin
    [N, Ho]."""
    if padding == "border":
        x = x.clamp(0.0, W - 1)
        y = y.clamp(0.0, H - 1)
    if mode == "nearest":
        x0f, y0f = torch.floor(x + 0.5), torch.floor(y + 0.5)
        fx, fy = torch.zeros_like(x), torch.zeros_like(y)
    else:
        x0f, y0f = torch.floor(x), torch.floor(y)
        fx, fy = x - x0f, y - y0f
    x1f, y1f = x0f + 1, y0f + 1
    w = dict(wx0=1.0 - fx, wx1=fx, wy0=1.0 - fy, wy1=fy)
    masks = dict(mx0=1.0, mx1=1.0, my0=1.0, my1=1.0)
    if padding == "zeros":
        for key, f, n in (("x0", x0f, W), ("x1", x1f, W), ("y0", y0f, H),
                          ("y1", y1f, H)):
            valid = (f >= 0) & (f <= n - 1)
            w["w" + key] = torch.where(valid, w["w" + key], 0.0)
            masks["m" + key] = valid.to(x.dtype)
    y0c = y0f.clamp(0, H - 1).long()
    y1c = y1f.clamp(0, H - 1).long()
    ymin = y0c.amin(dim=2).clamp(0, max(H - band, 0))
    ymin = ymin - ymin % 2
    ym = ymin[:, :, None]
    return dict(x0c=x0f.clamp(0, W - 1).long(), x1c=x1f.clamp(0, W - 1).long(),
                r0=ym + (y0c - ym).clamp(0, band - 1),
                r1=ym + (y1c - ym).clamp(0, band - 1), ymin=ymin, **w,
                **masks)


def band_sample(image: torch.Tensor, src: torch.Tensor, iw: Dict,
                with_vjp: bool = True):
    """Gather the four corners of each sample from ``image`` [M, H, W, C]
    (warp n reads image ``src[n]``) and blend them with the weights of
    ``iw``. Returns (out, va = d out/d fx, vb = d out/d fy), each
    [N, Ho, Wo, C] (va, vb None without ``with_vjp``)."""
    M, H, W, C = image.shape
    flat = image.reshape(M * H * W, C)
    base = src.view(-1, 1, 1) * H

    def corner(r, c):
        return flat[((base + r) * W + c).reshape(-1)].reshape(*r.shape, C)

    def weight(key):
        t = iw[key]
        return t[..., None].to(image.dtype) if torch.is_tensor(t) else t

    i00, i01 = corner(iw["r0"], iw["x0c"]), corner(iw["r0"], iw["x1c"])
    i10, i11 = corner(iw["r1"], iw["x0c"]), corner(iw["r1"], iw["x1c"])
    wx0, wx1, wy0, wy1 = (weight(k) for k in ("wx0", "wx1", "wy0", "wy1"))
    h0 = i00 * wx0 + i01 * wx1
    h1 = i10 * wx0 + i11 * wx1
    out = h0 * wy0 + h1 * wy1
    if not with_vjp:
        return out, None, None
    mx0, mx1, my0, my1 = (weight(k) for k in ("mx0", "mx1", "my0", "my1"))
    va = (i01 * mx1 - i00 * mx0) * wy0 + (i11 * mx1 - i10 * mx0) * wy1
    return out, va, h1 * my1 - h0 * my0


def _check(image: torch.Tensor, grid: torch.Tensor, mode: str, padding: str,
           band: int) -> None:
    if mode not in MODES or padding not in PADDINGS:
        raise ValueError(f"grid warp: mode {mode!r} must be one of {MODES}, "
                         f"padding {padding!r} one of {PADDINGS}")
    if image.dim() != 4 or grid.dim() != 4 or grid.shape[3] != 2 or \
            grid.shape[0] % image.shape[0] or not 1 <= band <= image.shape[1]:
        raise ValueError(f"grid warp: image {tuple(image.shape)}, grid "
                         f"{tuple(grid.shape)}, band {band} do not fit")
    for t in (image, grid):
        if t.dtype not in _DTYPES or t.dtype != image.dtype or \
                t.device != image.device or not t.is_contiguous():
            raise TypeError("grid warp takes contiguous float32 tensors on "
                            "one device")


def grid_band_plain(image: torch.Tensor, grid: torch.Tensor, mode: str,
                    padding: str, band: int, with_vjp: bool = True):
    """Plain version of kernels E and F: (out, va, vb), each
    [N, Ho, Wo, C] (va, vb None without ``with_vjp``)."""
    M, H, W, C = image.shape
    iw = indices_and_weights(unnormalize(grid[..., 0], W),
                             unnormalize(grid[..., 1], H), H, W, band, mode,
                             padding)
    src = torch.arange(grid.shape[0], device=image.device) % M
    return band_sample(image, src, iw, with_vjp)


def _launch(lib: str, fn: str, image, grid, tensors, band, flags):
    M, H, W, C = image.shape
    N, Ho, Wo, _ = grid.shape
    n_ptr = 2 + len(tensors)
    with torch.cuda.device(image.device):
        err = _entry(lib, fn, tuple(range(n_ptr)),
                     n_ptr + 8 + len(flags) + 1)(
            image.data_ptr(), grid.data_ptr(),
            *(t.data_ptr() for t in tensors), M, N, H, W, C, Ho, Wo, band,
            *flags, _stream(image))
    _raise_on(err, fn)


def grid_band_fwd(image: torch.Tensor, grid: torch.Tensor, mode: str,
                  padding: str, band: int) -> torch.Tensor:
    """The forward (kernel E on a CUDA device): out [N, Ho, Wo, C]."""
    _check(image, grid, mode, padding, band)
    if not _route(image, "grid_band_fwd"):
        return grid_band_plain(image, grid, mode, padding, band, False)[0]
    out = torch.empty((*grid.shape[:3], image.shape[3]), dtype=torch.float32,
                      device=image.device)
    _launch("warp_grid", "fsnet_warp_grid_fwd", image, grid, (out,), band,
            (int(mode == "nearest"), int(padding == "zeros")))
    grid_band_fwd.launches += 1
    return out


def grid_band_fused(image: torch.Tensor, grid: torch.Tensor, padding: str,
                    band: int):
    """The bilinear forward with the values of its VJP (kernel F on a CUDA
    device): (out, va, vb), each [N, Ho, Wo, C]."""
    _check(image, grid, "bilinear", padding, band)
    if not _route(image, "grid_band_fused"):
        return grid_band_plain(image, grid, "bilinear", padding, band)
    out, va, vb = (torch.empty((*grid.shape[:3], image.shape[3]),
                               dtype=torch.float32, device=image.device)
                   for _ in range(3))
    _launch("warp_grid", "fsnet_warp_grid_fused", image, grid, (out, va, vb),
            band, (int(padding == "zeros"),))
    grid_band_fused.launches += 1
    return out, va, vb


def grid_band_bwd_plain(image: torch.Tensor, grid: torch.Tensor,
                        g: torch.Tensor, mode: str, padding: str, band: int):
    """Plain version of kernel K: the cotangents of the warp for the output
    cotangent ``g`` [N, Ho, Wo, C]. Returns (gfx, gfy, dimage): gfx =
    sum_c g va and gfy = sum_c g vb [N, Ho, Wo] (``va``, ``vb`` recomputed
    from the image as :func:`band_sample` blends them), and dimage
    [M, H, W, C], the transpose of the forward: ``(g wy) wx`` added into
    the four band-clamped corners of image ``n mod M``."""
    M, H, W, C = image.shape
    iw = indices_and_weights(unnormalize(grid[..., 0], W),
                             unnormalize(grid[..., 1], H), H, W, band, mode,
                             padding)
    src = torch.arange(grid.shape[0], device=image.device) % M
    _, va, vb = band_sample(image, src, iw)
    dimage = torch.zeros_like(image)
    flat = dimage.view(M * H * W, C)
    base = src.view(-1, 1, 1) * H
    for r, wy in ((iw["r0"], iw["wy0"]), (iw["r1"], iw["wy1"])):
        gy = g * wy[..., None].to(g.dtype)
        for c, wx in ((iw["x0c"], iw["wx0"]), (iw["x1c"], iw["wx1"])):
            flat.index_add_(0, ((base + r) * W + c).reshape(-1),
                            (gy * wx[..., None].to(g.dtype)).reshape(-1, C))
    return (g * va).sum(-1), (g * vb).sum(-1), dimage


def grid_band_bwd(image: torch.Tensor, grid: torch.Tensor, g: torch.Tensor,
                  mode: str, padding: str, band: int):
    """Both cotangents of the warp (kernel K on a CUDA device): (gfx, gfy,
    dimage) as :func:`grid_band_bwd_plain` gives them."""
    _check(image, grid, mode, padding, band)
    if g.shape != (*grid.shape[:3], image.shape[3]) or \
            g.dtype != image.dtype or g.device != image.device or \
            not g.is_contiguous():
        raise ValueError(f"grid warp backward: cotangent {tuple(g.shape)} "
                         f"{g.dtype} does not fit the warp of image "
                         f"{tuple(image.shape)} by grid {tuple(grid.shape)}")
    if not _route(image, "grid_band_bwd"):
        return grid_band_bwd_plain(image, grid, g, mode, padding, band)
    gfx, gfy = (torch.empty(grid.shape[:3], dtype=torch.float32,
                            device=image.device) for _ in range(2))
    dimage = torch.zeros_like(image)
    _launch("warp_grad", "fsnet_warp_grid_bwd", image, grid,
            (g, gfx, gfy, dimage), band,
            (int(mode == "nearest"), int(padding == "zeros")))
    grid_band_bwd.launches += 1
    return gfx, gfy, dimage


def _chain_to_grid(grid: torch.Tensor, gfx: torch.Tensor, gfy: torch.Tensor,
                   H: int, W: int, padding: str) -> torch.Tensor:
    """Pixel-space (gfx, gfy) -> the normalized grid's cotangent; under
    border padding zero where the unclamped coordinate is not strictly
    inside the image (``warp_fast._chain_to_grid``)."""
    if padding == "border":
        x = unnormalize(grid[..., 0], W)
        y = unnormalize(grid[..., 1], H)
        gfx = torch.where((x > 0) & (x < W - 1), gfx, 0.0)
        gfy = torch.where((y > 0) & (y < H - 1), gfy, 0.0)
    return torch.stack([gfx * ((W - 1) / 2.0), gfy * ((H - 1) / 2.0)],
                       dim=-1).to(grid.dtype)


class GridSampleBand(torch.autograd.Function):
    """Forward: the warp (kernel F when the grid needs a bilinear cotangent
    and the image none, else kernel E). Backward: the grid cotangent from
    F's va/vb, or with ``image_grad`` both cotangents from kernel K."""

    @staticmethod
    def forward(ctx, image, grid, mode, padding, band, image_grad):
        ctx.mode, ctx.padding, ctx.band = mode, padding, band
        ctx.image_grad = image_grad
        ctx.hw = image.shape[1:3]
        if image_grad:
            ctx.save_for_backward(image, grid)
        elif mode == "bilinear" and ctx.needs_input_grad[1]:
            out, va, vb = grid_band_fused(image, grid, padding, band)
            ctx.save_for_backward(grid, va, vb)
            return out
        else:
            ctx.save_for_backward(grid)
        return grid_band_fwd(image, grid, mode, padding, band)

    @staticmethod
    def backward(ctx, g):
        if not (ctx.image_grad or ctx.needs_input_grad[1]):
            return (None,) * 6
        H, W = ctx.hw
        dimage = None
        if ctx.image_grad:
            image, grid = ctx.saved_tensors
            gfx, gfy, dimage = grid_band_bwd(image, grid, g.contiguous(),
                                             ctx.mode, ctx.padding, ctx.band)
        elif ctx.mode == "bilinear":
            grid, va, vb = ctx.saved_tensors
            gfx = (g * va).sum(-1)
            gfy = (g * vb).sum(-1)
        else:
            (grid,) = ctx.saved_tensors
        dgrid = (torch.zeros_like(grid) if ctx.mode == "nearest" else
                 _chain_to_grid(grid, gfx, gfy, H, W, ctx.padding))
        return dimage, dgrid, None, None, None, None


def grid_sample(image: torch.Tensor, grid: torch.Tensor,
                mode: str = "bilinear", padding_mode: str = "border",
                impl: str = "band", band: int = 16,
                image_grad: bool = False) -> torch.Tensor:
    """Band warp of ``image`` [M, H, W, C] by ``grid`` [N, Ho, Wo, 2]
    (``N % M == 0``, align_corners) -> [N, Ho, Wo, C], differentiable in
    the grid, and in the image with ``image_grad`` (else the image is a
    constant): the dispatcher of ``warp_fast.grid_sample`` with
    ``impl='band'``. The JAX package asserts N == M under ``image_grad``;
    the port takes any N that M divides (the deformable conv warps its
    K*K taps as one grid batch), and warp n's image cotangent goes to
    image n mod M. The exact ``impl='gather'`` warp comes with a later
    slice."""
    if impl != "band":
        raise NotImplementedError(f"the port's grid_sample runs impl='band', "
                                  f"not {impl!r}")
    return GridSampleBand.apply(image, grid, mode, padding_mode,
                                min(band, image.shape[1]), image_grad)


grid_band_fwd.launches = 0
grid_band_fused.launches = 0
grid_band_bwd.launches = 0

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

The kernels have several routes, all hand-written, which :func:`warp_route`
picks from the operands before the launch (a launch that fails raises,
never falls back): the narrow one (one thread per sample for E and F,
scalar loads and atomics for K) takes every shape; the channel-wide one
(vector lanes over the channels, vector atomics for K) takes E and K at C
a multiple of 4 (8 in bfloat16) with every pointer 16-byte aligned, the
deformable convs' case; the row one (each sample's grid read once, the
row staged in shared memory and written as 16-byte stores) takes E
elsewhere and F where the row width is a multiple of 4 and the staged row
fits, the grid route's frames and masks. ``grid_band_fwd.routes``,
``grid_band_fused.routes`` and ``grid_band_bwd.routes`` count the
launches of each route, and
:func:`_launch_grid` launches E or F on one route (the card tests and
``chip_smoke.py`` hold the routes against each other with it).

A bfloat16 image (the bf16 train step) takes a float32 grid, as the JAX
package's grid route hands it one (``reproject`` computes and returns the
grid in float32) and as the deformable conv widens its bfloat16 one: E and
F warp it as that route's unpacked TPU kernels do (``warp_fast.py:244-263``),
the image widened to float32 (exactly), float32 arithmetic, and out, va and
vb rounded to bfloat16; the grid cotangent is then formed from va and vb in
bfloat16 and scaled by the bfloat16-rounded ``(W - 1) / 2``, as JAX's weakly
typed scalars round. On the channel-wide route (the deformable convs, C a
multiple of 8) kernels E and K have bfloat16 forms of their own, which load
the bfloat16 operands as vectors (E 8 channels a lane, K 4) and compute in
float32: E stores its output rounded (bitwise the widened warp, rounded); K
(``image_grad``) writes float32 gfx and gfy and adds the image cotangent in
a float32 scratch, rounded to bfloat16 once. On the narrow and row routes,
and in the plain versions, the wrapper widens the image (and K's ``g``) and
rounds the outputs. ``grid_band_fwd.dtypes`` and ``grid_band_bwd.dtypes``
count E's and K's launches by the dtype of the operands the kernel read.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .conv3x3 import _DT_NAMES, _entry, _raise_on, _route, _stream, is_low

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
    wide = torch.float32 if is_low(image.dtype) else image.dtype
    if wide not in _DTYPES or grid.dtype != wide or \
            grid.device != image.device or not image.is_contiguous() or \
            not grid.is_contiguous():
        raise TypeError("grid warp takes contiguous float32 tensors on one "
                        "device, or a bfloat16 image with a float32 grid")


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


ROUTES = ("narrow", "vector")                 # kernel K's routes
FWD_ROUTES = ("narrow", "vector", "row")      # kernel E's
FUSED_ROUTES = ("narrow", "row")              # kernel F's
_SUFFIX = dict(narrow="", vector="_vec", row="_row")   # of the C entry points
# a row-staging kernel's row: W / 4 threads of at most 512, and its staged
# row in at most this much shared memory (csrc/warp_rows.cuh
# row_fits_bytes)
_ROW_MAX_W, _ROW_MAX_SMEM = 2048, 232448 - 1024


def warp_route(*tensors: torch.Tensor, grid: Optional[torch.Tensor] = None,
               fused: bool = False) -> str:
    """The route of kernels E, F and K for these operands, the first the
    image [M, H, W, C]:

    * ``'vector'`` (the channel-wide kernels of E and K; not with
      ``fused``, kernel F) when a sample's C channels are a multiple of 16
      bytes (C a multiple of 4 in float32, of 8 in bfloat16) and every
      tensor's data is 16-byte aligned;
    * else ``'row'`` (kernels E and F, which pass their ``grid``
      [N, Ho, Wo, 2]) when Wo % 4 == 0, Wo <= 2048, the staged row (4 Wo C
      bytes; with ``fused`` 12 Wo C) fits in shared memory and the grid's
      data and every tensor's are 16-byte aligned;
    * else ``'narrow'``."""
    C = tensors[0].shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    if not fused and C * tensors[0].element_size() % 16 == 0 and aligned:
        return "vector"
    if grid is not None:
        Wo = grid.shape[2]
        if Wo % 4 == 0 and 0 < Wo <= _ROW_MAX_W and \
                (12 if fused else 4) * Wo * C <= _ROW_MAX_SMEM and \
                aligned and grid.data_ptr() % 16 == 0:
            return "row"
    return "narrow"


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


def _launch_grid(route: str, image: torch.Tensor, grid: torch.Tensor,
                 mode: str, padding: str, band: int, fused: bool = False):
    """Kernel E, or with ``fused`` kernel F (bilinear), on ``route`` for
    checked CUDA operands (the channel-wide and row entry points raise where
    the operands do not fit them): out, or (out, va, vb), each
    [N, Ho, Wo, C] of the image's dtype. A bfloat16 image launches E's
    bfloat16 form, on the channel-wide route only."""
    routes = FUSED_ROUTES if fused else FWD_ROUTES
    if route not in routes:
        raise ValueError(f"kernel {'F' if fused else 'E'} route must be one "
                         f"of {routes}, got {route!r}")
    low = is_low(image.dtype)
    if low and (fused or route != "vector"):
        raise TypeError(f"kernel {'F' if fused else 'E'} has no bfloat16 "
                        f"form on the {route} route")
    outs = tuple(torch.empty((*grid.shape[:3], image.shape[3]),
                             dtype=image.dtype, device=image.device)
                 for _ in range(3 if fused else 1))
    zeros = int(padding == "zeros")
    if fused:
        fn, flags, counter = "fsnet_warp_grid_fused", (zeros,), \
            grid_band_fused
    else:
        fn, flags, counter = "fsnet_warp_grid_fwd", \
            (int(mode == "nearest"), zeros), grid_band_fwd
    _launch("warp_grid", fn + _SUFFIX[route] + ("_bf16" if low else ""),
            image, grid, outs, band, flags)
    counter.launches += 1
    counter.routes[route] += 1
    if not fused:
        counter.dtypes[_DT_NAMES[image.dtype]] += 1
    return outs if fused else outs[0]


def grid_band_fwd(image: torch.Tensor, grid: torch.Tensor, mode: str,
                  padding: str, band: int) -> torch.Tensor:
    """The forward (kernel E on a CUDA device, on the route of
    :func:`warp_route`): out [N, Ho, Wo, C]. A bfloat16 image takes E's
    bfloat16 form on the channel-wide route, else it is widened and the
    output rounded."""
    _check(image, grid, mode, padding, band)
    if is_low(image.dtype) and not (_route(image, "grid_band_fwd") and
                                    warp_route(image, grid=grid) == "vector"):
        return grid_band_fwd(image.float(), grid, mode, padding, band).to(
            image.dtype)
    if not _route(image, "grid_band_fwd"):
        return grid_band_plain(image, grid, mode, padding, band, False)[0]
    # the route from the inputs: the output, a fresh CUDA allocation, is
    # 16-byte aligned
    return _launch_grid(warp_route(image, grid=grid), image, grid, mode,
                        padding, band)


def grid_band_fused(image: torch.Tensor, grid: torch.Tensor, padding: str,
                    band: int):
    """The bilinear forward with the values of its VJP (kernel F on a CUDA
    device, on the route of :func:`warp_route`): (out, va, vb), each
    [N, Ho, Wo, C]."""
    _check(image, grid, "bilinear", padding, band)
    if is_low(image.dtype):
        return tuple(t.to(image.dtype) for t in grid_band_fused(
            image.float(), grid, padding, band))
    if not _route(image, "grid_band_fused"):
        return grid_band_plain(image, grid, "bilinear", padding, band)
    return _launch_grid(warp_route(image, grid=grid, fused=True), image, grid,
                        "bilinear", padding, band, fused=True)


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
    """Both cotangents of the warp (kernel K on a CUDA device, on the route
    of :func:`warp_route`): (gfx, gfy, dimage) as
    :func:`grid_band_bwd_plain` gives them. A bfloat16 image and ``g``
    take K's bfloat16 form on the channel-wide route (float32 gfx and gfy,
    dimage summed in float32 and rounded once), else they are widened and
    dimage rounded."""
    _check(image, grid, mode, padding, band)
    if g.shape != (*grid.shape[:3], image.shape[3]) or \
            g.dtype != image.dtype or g.device != image.device or \
            not g.is_contiguous():
        raise ValueError(f"grid warp backward: cotangent {tuple(g.shape)} "
                         f"{g.dtype} does not fit the warp of image "
                         f"{tuple(image.shape)} by grid {tuple(grid.shape)}")
    low = is_low(image.dtype)
    if low and not (_route(image, "grid_band_bwd") and
                    warp_route(image, g) == "vector"):
        gfx, gfy, dimage = grid_band_bwd(image.float(), grid, g.float(),
                                         mode, padding, band)
        return gfx, gfy, dimage.to(image.dtype)
    if not _route(image, "grid_band_bwd"):
        return grid_band_bwd_plain(image, grid, g, mode, padding, band)
    gfx, gfy = (torch.empty(grid.shape[:3], dtype=torch.float32,
                            device=image.device) for _ in range(2))
    if low:
        sums = torch.zeros(image.shape, dtype=torch.float32,
                           device=image.device)
        dimage = torch.empty_like(image)
        route, fn, outs = "vector", "fsnet_warp_grid_bwd_vec_bf16", \
            (g, gfx, gfy, sums, dimage)
    else:
        dimage = torch.zeros_like(image)
        route = warp_route(image, g, dimage)
        fn, outs = "fsnet_warp_grid_bwd" + _SUFFIX[route], \
            (g, gfx, gfy, dimage)
    _launch("warp_grad", fn, image, grid, outs, band,
            (int(mode == "nearest"), int(padding == "zeros")))
    grid_band_bwd.launches += 1
    grid_band_bwd.routes[route] += 1
    grid_band_bwd.dtypes[_DT_NAMES[image.dtype]] += 1
    return gfx, gfy, dimage


def _chain_to_grid(grid: torch.Tensor, gfx: torch.Tensor, gfy: torch.Tensor,
                   H: int, W: int, padding: str) -> torch.Tensor:
    """Pixel-space (gfx, gfy) -> the normalized grid's cotangent; under
    border padding zero where the unclamped coordinate is not strictly
    inside the image (``warp_fast._chain_to_grid``). The scales are taken in
    the cotangents' dtype, as JAX takes a Python scalar."""
    if padding == "border":
        x = unnormalize(grid[..., 0], W)
        y = unnormalize(grid[..., 1], H)
        gfx = torch.where((x > 0) & (x < W - 1), gfx, 0.0)
        gfy = torch.where((y > 0) & (y < H - 1), gfy, 0.0)

    def scale(s):
        return torch.tensor(s, dtype=gfx.dtype)
    return torch.stack([gfx * scale((W - 1) / 2.0),
                        gfy * scale((H - 1) / 2.0)], dim=-1).to(grid.dtype)


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
grid_band_fwd.routes = dict.fromkeys(FWD_ROUTES, 0)
grid_band_fused.routes = dict.fromkeys(FUSED_ROUTES, 0)
grid_band_bwd.routes = dict.fromkeys(ROUTES, 0)
grid_band_fwd.dtypes = dict.fromkeys(_DT_NAMES.values(), 0)
grid_band_bwd.dtypes = dict.fromkeys(_DT_NAMES.values(), 0)

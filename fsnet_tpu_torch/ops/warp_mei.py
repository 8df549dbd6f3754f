"""Norm-direct fisheye photometric warp: per-scale norm maps + Mei camera
rows -> warped frames and overlap masks (counterpart of
``fsnet_tpu.ops.warp_mei``: ``make_mei_rows`` and ``warp_mei_fused``,
``warp_mei.py:65-190``).

The fisheye head's "depth" is the norm of the 3D point along the pixel's
ray. For warp n = (s*F + f)*B + b, pixel (i, j) lifts to
``p = norm[s*B + b, i, j] * (R r) + t`` with ``r = rays[b, :, i, j]`` and
(R, t) the pose of frame f, and projects through the Mei camera
(eps = 1e-6, ``mei_prep_kernel._mei_pix``):

    nn = |p|;  (xh, yh, zh) = p / (nn + eps)    (as a multiply by 1/(nn+eps))
    a = xh / (zh + xi + eps);  b = yh / (zh + xi + eps)   (the same)
    rho2 = a^2 + b^2;  fac = 1 + k1 rho2 + k2 rho2^2
    x = g1 a fac + u0;  y = g2 b fac + v0

Source frame ``n mod F*B`` is warped there with the band-limited
border-padded bilinear warp of :mod:`~fsnet_tpu_torch.ops.warp_fast`. With
``with_mask`` the source validity ``mask[n mod B]`` is warped with the same
corners and fractions rounded to {0, 1} (the nearest sample), and the
overlap is that warp ``== 1.0`` AND the in-bounds test
``-0.5 <= x < W - 0.5, -0.5 <= y < H - 0.5`` of the unclamped coordinates.
Non-finite coordinates clamp like finite ones (a NaN to 0), so no corner
ever leaves the image.

On a CUDA device the forward is one kernel pass (``csrc/warp_mei.cu``
kernel G, replacing the TPU kernels ``mei_prep_pallas`` and both sweeps of
``warp_rows_pallas_dma_fused``) and the norm cotangent another (kernel H,
replacing ``mei_prep_bwd_pallas``). Their plain versions here are written
for any float type and round once per operation in the kernels' order.

Contract, as in the JAX package: images, masks, rays and rows are constants
under autodiff; only the norm cotangent is produced. Callers dispatch here
only when every pose is a dataset constant (``MonoDepthWPose``).
:func:`warp_mei_fwd` and :func:`warp_mei_bwd` pick their route from the
device of the tensors they are given and count launches in
``<function>.launches``. Kernel G has two routes, bitwise equal, picked by
:func:`~fsnet_tpu_torch.ops.warp_depth.proj_route` as kernel A's: the
vector route (each pixel projected once, the row written as 16-byte
stores) where the row fits it, the narrow route for every other shape;
``warp_mei_fwd.routes`` counts launches by route and :func:`_launch_fwd`
launches one route.

A bfloat16 image (the bf16 train step) is warped as the JAX package's
unpacked route warps it (``fsnet_tpu/ops/warp_mei.py:147-148``): the image
and a bfloat16 or float32 norm widened (exactly), the projection and the
bilinear arithmetic in float32 on the float32 rays, mask and rows, and out,
va and vb rounded once to bfloat16 (the overlap as at float32). The
cotangent's bfloat16 form loads bfloat16 g, va and vb, forms ``gfx`` and
``gfy`` as PyTorch's bfloat16 ops form them (kernel B's bfloat16 form,
:func:`~fsnet_tpu_torch.ops.warp_depth._channel_sum`), runs the float32
derivative and rounds d norm to the norm's dtype (``warp_mei.py:186``).
Kernels G and H have bfloat16 forms of their own; ``<function>.dtypes``
counts launches by the dtype of the image (g, va, vb).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .conv3x3 import (_DT_NAMES, _counted, _entry, _raise_on, _route,
                      _stream, is_low)
from .warp_depth import ROUTES, _SUFFIX, _channel_sum, _known, proj_route
from .warp_fast import band_sample, indices_and_weights

_DTYPES = (torch.float32,)
_EPS = 1e-6


def make_mei_rows(P: torch.Tensor, params: torch.Tensor, Ts: torch.Tensor,
                  S: int) -> torch.Tensor:
    """(P [B, 3+, 4], params [B, 3] = (xi, k1, k2), Ts [F, B, 4, 4]) ->
    mrows [S*F*B, 24] (float32 or wider) in (s, f, b) order: cols 0-8 the
    row-major R = T[:3, :3], 9-11 t = T[:3, 3], 12-14 (xi, k1, k2), 15-18
    (gamma1, gamma2, u0, v0), the rest zero. Rows do not depend on s."""
    ft = torch.promote_types(Ts.dtype, torch.float32)
    Ts = Ts.to(ft)
    F, B = Ts.shape[:2]
    cam = torch.stack([params[:, 0], params[:, 1], params[:, 2],
                       P[:, 0, 0], P[:, 1, 1], P[:, 0, 2], P[:, 1, 2]],
                      dim=-1).to(ft)                            # [B, 7]
    rows = torch.cat([Ts[:, :, :3, :3].reshape(F, B, 9), Ts[:, :, :3, 3],
                      cam[None].expand(F, B, 7),
                      torch.zeros((F, B, 5), dtype=ft, device=Ts.device)],
                     dim=-1)                                    # [F, B, 24]
    return rows[None].expand(S, F, B, 24).reshape(-1, 24).contiguous()


def mei_pix(norm: torch.Tensor, rays_cf: torch.Tensor, mrows: torch.Tensor,
            S: int, F: int) -> Dict[str, torch.Tensor]:
    """Pixel coordinates of every warp, [S*F*B, H, W] each, with the
    intermediates the backward reuses, one rounding per operation in the
    order of ``mei_prep_kernel._mei_pix``. ``norm`` [S*B, H, W], ``rays_cf``
    [B, 3, H, W], ``mrows`` [S*F*B, 24]."""
    SB, H, W = norm.shape
    N, B = mrows.shape[0], rays_cf.shape[0]
    ft = torch.promote_types(norm.dtype, torch.float32)
    n = norm.to(ft).view(S, 1, B, H, W).expand(S, F, B, H, W).reshape(N, H, W)
    r = rays_cf.to(ft)[None].expand(S * F, B, 3, H, W).reshape(N, 3, H, W)
    rx, ry, rz = r[:, 0], r[:, 1], r[:, 2]
    m = [mrows[:, k].to(ft).view(N, 1, 1) for k in range(19)]
    gx = m[0] * rx + m[1] * ry + m[2] * rz
    gy = m[3] * rx + m[4] * ry + m[5] * rz
    gz = m[6] * rx + m[7] * ry + m[8] * rz
    px, py, pz = n * gx + m[9], n * gy + m[10], n * gz + m[11]
    nn = torch.sqrt(px * px + py * py + pz * pz)
    inv_e = 1.0 / (nn + _EPS)
    xh, yh, zh = px * inv_e, py * inv_e, pz * inv_e
    inv_d = 1.0 / (zh + m[12] + _EPS)
    a, b = xh * inv_d, yh * inv_d
    rho2 = a * a + b * b
    fac = 1.0 + m[13] * rho2 + m[14] * rho2 * rho2
    return dict(x=m[15] * a * fac + m[17], y=m[16] * b * fac + m[18],
                gx=gx, gy=gy, gz=gz, px=px, py=py, pz=pz, nn=nn,
                inv_e=inv_e, xh=xh, yh=yh, zh=zh, inv_d=inv_d, a=a, b=b,
                rho2=rho2, fac=fac, k1=m[13], k2=m[14], g1=m[15], g2=m[16])


def _check(image, norm, rays_cf, mrows, S, F, like_image=(), wide=()):
    """Shapes, and the dtypes: ``image`` and ``like_image`` (g, va, vb) of
    one dtype, float32 or bfloat16; ``norm`` of that dtype or, beside a
    bfloat16 image, float32; ``rays_cf``, ``mrows`` and ``wide`` (the mask)
    float32 beside a bfloat16 image, else of the image's dtype."""
    FB, H, W, C = image.shape
    B = FB // F
    if FB % F or tuple(norm.shape) != (S * B, H, W) or \
            tuple(rays_cf.shape) != (B, 3, H, W) or \
            tuple(mrows.shape) != (S * FB, 24):
        raise ValueError(f"warp_mei: image {tuple(image.shape)}, norm "
                         f"{tuple(norm.shape)}, rays {tuple(rays_cf.shape)}, "
                         f"mrows {tuple(mrows.shape)} do not fit S={S}, F={F}")
    dt = image.dtype
    fp = torch.float32 if is_low(dt) else dt
    if fp not in _DTYPES or norm.dtype not in (dt, fp) or \
            any(t.dtype != dt for t in like_image) or \
            any(t.dtype != fp for t in (rays_cf, mrows, *wide)):
        raise TypeError("warp_mei takes float32 tensors (an image, g, va and "
                        "vb in bfloat16 beside a bfloat16 or float32 norm; "
                        "rays, mask and rows float32 always)")
    for t in (image, norm, rays_cf, mrows, *like_image, *wide):
        if t.device != image.device or not t.is_contiguous():
            raise TypeError("warp_mei takes contiguous tensors on one device")


def _code(image: torch.Tensor, norm: torch.Tensor) -> int:
    """The C entry points' ``dtype``: 0 float32, 1 a bfloat16 image (g, va,
    vb) and norm, 2 a bfloat16 image with a float32 norm."""
    if not is_low(image.dtype):
        return 0
    return 1 if norm.dtype == image.dtype else 2


def _clamp(v: torch.Tensor, hi: int) -> torch.Tensor:
    """``fminf(fmaxf(v, 0), hi)``: a NaN becomes 0, +-inf the edges."""
    return torch.fmin(torch.fmax(v, v.new_zeros(())), v.new_full((), hi))


def warp_mei_plain(image: torch.Tensor, mask: torch.Tensor,
                   norm: torch.Tensor, rays_cf: torch.Tensor,
                   mrows: torch.Tensor, S: int, F: int, band: int,
                   with_mask: bool):
    """Plain version of the forward: (out, overlap, va, vb) with out, va, vb
    [S*F*B, H, W, C] in the image's dtype and overlap [S*F*B, H, W] bool
    (None without ``with_mask``); a bfloat16 image's outputs are the
    float32 ones of the widened image, rounded."""
    if is_low(image.dtype):
        out, overlap, va, vb = warp_mei_plain(image.float(), mask, norm,
                                              rays_cf, mrows, S, F, band,
                                              with_mask)
        return (out.to(image.dtype), overlap, va.to(image.dtype),
                vb.to(image.dtype))
    FB, H, W, C = image.shape
    N = mrows.shape[0]
    p = mei_pix(norm, rays_cf, mrows, S, F)
    x, y = p["x"], p["y"]
    iw = indices_and_weights(_clamp(x, W - 1), _clamp(y, H - 1), H, W, band)
    n = torch.arange(N, device=image.device)
    out, va, vb = band_sample(image, n % FB, iw)
    overlap = None
    if with_mask:
        fx = (iw["wx1"] >= 0.5).to(mask.dtype)
        fy = (iw["wy1"] >= 0.5).to(mask.dtype)
        nearest = dict(iw, wx0=1.0 - fx, wx1=fx, wy0=1.0 - fy, wy1=fy)
        mout = band_sample(mask[..., None], n % (FB // F), nearest, False)[0]
        inb = (x >= -0.5) & (x < W - 0.5) & (y >= -0.5) & (y < H - 0.5)
        overlap = (mout[..., 0] == 1.0) & inb
    return out, overlap, va, vb


def warp_mei_bwd_plain(norm: torch.Tensor, rays_cf: torch.Tensor,
                       g: torch.Tensor, va: torch.Tensor, vb: torch.Tensor,
                       mrows: torch.Tensor, S: int, F: int) -> torch.Tensor:
    """Plain version of the backward: the fraction cotangents
    ``gfx = sum_c g va``, ``gfy = sum_c g vb`` (in bfloat16 as
    :func:`~fsnet_tpu_torch.ops.warp_depth._channel_sum` forms them) -> d
    norm [S*B, H, W] in the norm's dtype, through the closed-form
    derivative of the projection (``mei_prep_kernel._mei_prep_bwd_kernel``,
    float32 or wider), masked by the strict border test 0 < x < W-1,
    0 < y < H-1 and summed over the F frames."""
    SB, H, W = norm.shape
    q = mei_pix(norm, rays_cf, mrows, S, F)
    dnn = (q["px"] * q["gx"] + q["py"] * q["gy"] + q["pz"] * q["gz"]) \
        / torch.clamp(q["nn"], min=1e-12)
    dxh = (q["gx"] - q["xh"] * dnn) * q["inv_e"]
    dyh = (q["gy"] - q["yh"] * dnn) * q["inv_e"]
    dzh = (q["gz"] - q["zh"] * dnn) * q["inv_e"]
    da = (dxh - q["a"] * dzh) * q["inv_d"]
    db = (dyh - q["b"] * dzh) * q["inv_d"]
    k = q["k1"] + 2.0 * q["k2"] * q["rho2"]
    common = 2.0 * k * (q["a"] * da + q["b"] * db)
    dux = q["g1"] * (q["fac"] * da + q["a"] * common)
    dvy = q["g2"] * (q["fac"] * db + q["b"] * common)
    x, y = q["x"], q["y"]
    mx = ((x > 0.0) & (x < W - 1)).to(dux.dtype)
    my = ((y > 0.0) & (y < H - 1)).to(dux.dtype)
    gfx, gfy = _channel_sum(g, va), _channel_sum(g, vb)
    term = gfx * mx * dux + gfy * my * dvy                    # [N, H, W]
    return term.view(S, F, SB // S, H, W).sum(dim=1).reshape(
        SB, H, W).to(norm.dtype)


def warp_mei_fwd(image: torch.Tensor, mask: torch.Tensor, norm: torch.Tensor,
                 rays_cf: torch.Tensor, mrows: torch.Tensor, S: int, F: int,
                 band: int, with_mask: bool):
    """The forward (kernel G on a CUDA device, on the route of
    :func:`~fsnet_tpu_torch.ops.warp_depth.proj_route`): (out, overlap, va,
    vb), out, va and vb in the image's dtype."""
    _check(image, norm, rays_cf, mrows, S, F, wide=(mask,))
    if tuple(mask.shape) != (rays_cf.shape[0], *image.shape[1:3]) or \
            not 1 <= band <= image.shape[1]:
        raise ValueError(f"warp_mei: mask {tuple(mask.shape)} or band {band} "
                         f"does not fit image {tuple(image.shape)}")
    if not _route(image, "warp_mei_fwd"):
        return warp_mei_plain(image, mask, norm, rays_cf, mrows, S, F, band,
                              with_mask)
    # the route from the inputs: the outputs, fresh CUDA allocations, are
    # 16-byte aligned
    return _launch_fwd(proj_route(image, mask, norm, rays_cf, mrows), image,
                       mask, norm, rays_cf, mrows, S, F, band, with_mask)


def _launch_fwd(route: str, image: torch.Tensor, mask: torch.Tensor,
                norm: torch.Tensor, rays_cf: torch.Tensor, mrows: torch.Tensor,
                S: int, F: int, band: int, with_mask: bool):
    """Kernel G on ``route`` for checked CUDA operands (the vector route's
    entry point raises where they do not fit it): (out, overlap, va, vb)."""
    _known(route)
    FB, H, W, C = image.shape
    N = S * FB
    dev = image.device
    out, va, vb = (torch.empty((N, H, W, C), dtype=image.dtype, device=dev)
                   for _ in range(3))
    overlap = (torch.empty((N, H, W), dtype=torch.bool, device=dev)
               if with_mask else None)
    fn = "fsnet_warp_mei_fwd" + _SUFFIX[route]
    with torch.cuda.device(dev):
        err = _entry("warp_mei", fn, range(9), 19)(
            image.data_ptr(), mask.data_ptr(), norm.data_ptr(),
            rays_cf.data_ptr(), mrows.data_ptr(), out.data_ptr(),
            va.data_ptr(), vb.data_ptr(),
            overlap.data_ptr() if with_mask else None,
            S, F, FB // F, H, W, C, band, int(with_mask), _code(image, norm),
            _stream(image))
    _raise_on(err, fn)
    _counted(warp_mei_fwd, image.dtype)
    warp_mei_fwd.routes[route] += 1
    return out, overlap, va, vb


def warp_mei_bwd(norm: torch.Tensor, rays_cf: torch.Tensor, g: torch.Tensor,
                 va: torch.Tensor, vb: torch.Tensor, mrows: torch.Tensor,
                 S: int, F: int) -> torch.Tensor:
    """The norm cotangent (kernel H on a CUDA device) -> [S*B, H, W] in the
    norm's dtype; g, va and vb float32, or all bfloat16 (kernel H's
    bfloat16 form)."""
    if g.shape != va.shape or vb.shape != va.shape:
        raise ValueError("warp_mei_bwd: g, va and vb must share one shape")
    N, H, W, C = va.shape
    B = rays_cf.shape[0]
    _check(va[:N // S], norm, rays_cf, mrows, S, F, like_image=(g, vb))
    if not _route(norm, "warp_mei_bwd"):
        return warp_mei_bwd_plain(norm, rays_cf, g, va, vb, mrows, S, F)
    dnorm = torch.empty((S * B, H, W), dtype=norm.dtype, device=norm.device)
    with torch.cuda.device(norm.device):
        err = _entry("warp_mei", "fsnet_warp_mei_bwd", range(7), 15)(
            norm.data_ptr(), rays_cf.data_ptr(), g.data_ptr(), va.data_ptr(),
            vb.data_ptr(), mrows.data_ptr(), dnorm.data_ptr(), S, F, B, H, W,
            C, _code(va, norm), _stream(norm))
    _raise_on(err, "warp_mei_bwd")
    _counted(warp_mei_bwd, va.dtype)
    return dnorm


class WarpMeiFunction(torch.autograd.Function):
    """Forward: (preds, overlap); saves va, vb. Backward: d norm only (the
    image, mask, rays and rows get none, as the JAX VJP gives them
    zeros)."""

    @staticmethod
    def forward(ctx, image, mask, norm, rays_cf, mrows, S, F, band,
                with_mask):
        out, overlap, va, vb = warp_mei_fwd(image, mask, norm, rays_cf, mrows,
                                            S, F, band, with_mask)
        ctx.S, ctx.F = S, F
        ctx.save_for_backward(norm, rays_cf, mrows, va, vb)
        if overlap is not None:
            ctx.mark_non_differentiable(overlap)
        return out, overlap

    @staticmethod
    def backward(ctx, g, _):
        norm, rays_cf, mrows, va, vb = ctx.saved_tensors
        dnorm = warp_mei_bwd(norm, rays_cf, g.contiguous(), va, vb, mrows,
                             ctx.S, ctx.F)
        return None, None, dnorm, None, None, None, None, None, None


def warp_mei_fused(image: torch.Tensor, mask: torch.Tensor,
                   norm: torch.Tensor, rays_cf: torch.Tensor,
                   mrows: torch.Tensor, S: int, F: int, band: int,
                   with_mask: bool
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Border-padded bilinear band warp of ``image`` [F*B, H, W, C] by the
    Mei reprojection of ``norm`` [S*B, H, W] lifted through ``rays_cf``
    [B, 3, H, W] and projected by ``mrows`` [S*F*B, 24]
    (:func:`make_mei_rows`). ``mask`` [B, H, W]: source validity (patched x
    fisheye-valid); with ``with_mask`` it is nearest-warped and AND'd with
    the in-bounds test. Returns (preds [S*F*B, H, W, C], overlap bool
    [S*F*B, H, W] or None). Differentiable in ``norm`` only."""
    return WarpMeiFunction.apply(image, mask, norm, rays_cf, mrows, S, F,
                                 band, with_mask)


warp_mei_fwd.launches = 0
warp_mei_fwd.routes = dict.fromkeys(ROUTES, 0)
warp_mei_fwd.dtypes = dict.fromkeys(_DT_NAMES.values(), 0)
warp_mei_bwd.launches = 0
warp_mei_bwd.dtypes = dict.fromkeys(_DT_NAMES.values(), 0)

"""Depth-direct photometric warp: depth + projection rows -> warped frames
(counterpart of ``fsnet_tpu.ops.warp_depth``: ``make_affine_rows`` and
``warp_depth_fused``, ``warp_depth.py:50-127``).

The warp of source frames by the reprojection of per-scale depth is one
kernel pass on the card (``csrc/warp_depth.cu`` kernel A, replacing the TPU
kernels ``warp_prep_pallas`` + ``warp_rows_pallas_dma_fused``), and its
depth cotangent another (kernel B, replacing ``warp_prep_bwd_pallas``).
Their plain versions compose :func:`~fsnet_tpu_torch.ops.geometry.project_rows`
with the band warp of :mod:`~fsnet_tpu_torch.ops.warp_fast`.

Contract, as in the JAX package: images and projection rows are constants
under autodiff; only the depth cotangent is produced. Callers dispatch here
only when every pose is a dataset constant (the GT-pose flagship).

:func:`warp_depth_fwd` and :func:`warp_depth_bwd` pick their route from the
device of the tensors they are given (the kernel on a CUDA device, the plain
version on the CPU) and count launches in ``<function>.launches``. Kernel A
has two routes, bitwise equal, picked by :func:`proj_route` (shared with
kernel G of :mod:`~fsnet_tpu_torch.ops.warp_mei`): the vector route (each
pixel projected once, the row written as 16-byte stores) where the row
fits it, the narrow route for every other shape; ``warp_depth_fwd.routes``
counts launches by route and :func:`_launch_fwd` launches one route (tests
and ``chip_smoke.py`` hold both routes with it).

A bfloat16 image (the bf16 train step; depth and rows stay float32) is
warped as the JAX package's unpacked TPU route does (``warp_depth.py:80``,
:90-91): widened to float32 (exactly), kernel A in float32, and out, va and
vb rounded to bfloat16. Kernel B's bfloat16 form then loads g, va and vb
in bfloat16 and forms ``gfx = sum_c g va`` and ``gfy`` as torch's bfloat16
ops do (``warp_depth.py:117-120`` forms them in bf16): each product rounded
to bfloat16, the channels summed in float32 in order, the sum rounded; the
rest is the float32 kernel's, and the depth cotangent is float32, depth's
dtype. Kernel A is the float32 one.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .conv3x3 import _DTYPES as _CODES
from .conv3x3 import (_DT_NAMES, _counted, _entry, _raise_on, _route,
                      _stream, is_low)
from .geometry import project_rows
# the vector route's row: W / 4 threads of at most 512, and out, va, vb
# (W C elements each) and the overlap (W bytes) staged in at most
# _ROW_MAX_SMEM bytes of shared memory (csrc/warp_rows.cuh row_fits)
from .warp_fast import (_ROW_MAX_SMEM, _ROW_MAX_W, band_sample,
                        indices_and_weights)

_DTYPES = (torch.float32,)
ROUTES = ("narrow", "vector")
_SUFFIX = dict(narrow="", vector="_vec")     # of the routes' C entry points


def proj_route(image: torch.Tensor, *others: torch.Tensor) -> str:
    """The route of the projecting warps (kernels A and G) for these
    operands: ``'vector'`` when ``image`` [., H, W, C] has W % 4 == 0,
    W <= 2048, an output row of whole 16-byte stores (W C e bytes, e the
    image's element size, which the outputs share: in bfloat16 W C a
    multiple of 8) and 3 W C e + W bytes of staged row within the
    shared-memory limit, and every tensor's data is 16-byte aligned; else
    ``'narrow'``."""
    W, C = image.shape[2], image.shape[3]
    row = W * C * image.element_size()
    vec = W % 4 == 0 and W <= _ROW_MAX_W and row % 16 == 0 and \
        3 * row + W <= _ROW_MAX_SMEM and \
        all(t.data_ptr() % 16 == 0 for t in (image, *others))
    return "vector" if vec else "narrow"


def _known(route):
    if route not in ROUTES:
        raise ValueError(f"warp route must be one of {ROUTES}, got {route!r}")


def make_affine_rows(K: torch.Tensor, inv_K: torch.Tensor, Ts: torch.Tensor,
                     S: int) -> torch.Tensor:
    """(K [B, 4, 4], inv_K [B, 4, 4], Ts [F, B, 4, 4]) -> arows [S*F*B, 16]
    (float32 or wider) in (s, f, b) order: cols 0-8 the row-major 3x3
    A = (K T)[:3, :3] inv_K3, cols 9-11 b = (K T)[:3, 3], the rest zero."""
    ft = torch.promote_types(K.dtype, torch.float32)
    KT = torch.matmul(K.to(ft)[None], Ts.to(ft))              # [F, B, 4, 4]
    P = KT[:, :, :3, :]
    A = torch.matmul(P[..., :3], inv_K[None, :, :3, :3].to(ft))
    F, B = A.shape[:2]
    rows = torch.cat([A.reshape(F, B, 9), P[..., 3],
                      torch.zeros((F, B, 4), dtype=ft, device=K.device)],
                     dim=-1)
    return rows[None].expand(S, F, B, 16).reshape(-1, 16).contiguous()


def _per_warp_depth(depth: torch.Tensor, S: int, F: int) -> torch.Tensor:
    """[S*B, H, W] -> [S*F*B, H, W]: warp n = (s*F + f)*B + b reads depth
    row s*B + b."""
    SB, H, W = depth.shape
    B = SB // S
    return depth.view(S, 1, B, H, W).expand(S, F, B, H, W).reshape(-1, H, W)


def _sources(S: int, F: int, B: int, device) -> torch.Tensor:
    """Warp n = (s*F + f)*B + b reads source image f*B + b."""
    n = torch.arange(S * F * B, device=device)
    return n % (F * B)


def _check(image, depth, arows, S, F, extra=()):
    FB, H, W, C = image.shape
    if FB % F or depth.shape[0] != S * (FB // F) or \
            tuple(depth.shape[1:]) != (H, W) or \
            tuple(arows.shape) != (S * FB, 16):
        raise ValueError(f"warp_depth: image {tuple(image.shape)}, depth "
                         f"{tuple(depth.shape)}, arows {tuple(arows.shape)} "
                         f"do not fit S={S}, F={F}")
    wide = torch.float32 if is_low(image.dtype) else image.dtype
    for t, want in ((image, image.dtype), (depth, wide), (arows, wide),
                    *((e, image.dtype) for e in extra)):
        if wide not in _DTYPES or t.dtype != want or \
                t.device != image.device or not t.is_contiguous():
            raise TypeError("warp_depth takes contiguous float32 tensors on "
                            "one device (image, g, va and vb may be "
                            "bfloat16 together)")


def warp_depth_plain(image: torch.Tensor, depth: torch.Tensor,
                     arows: torch.Tensor, S: int, F: int, band: int):
    """Plain version of the forward: (out, overlap, va, vb) with out/va/vb
    [S*F*B, H, W, C] f32 and overlap [S*F*B, H, W] bool."""
    FB, H, W, C = image.shape
    p = project_rows(_per_warp_depth(depth, S, F), arows)
    x, y = p["x"], p["y"]
    overlap = (x >= -0.5) & (x < W - 0.5) & (y >= -0.5) & (y < H - 0.5)
    iw = indices_and_weights(x, y, H, W, band)
    out, va, vb = band_sample(image, _sources(S, F, FB // F, image.device), iw)
    return out, overlap, va, vb


def _channel_sum(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``sum_c g v`` [N, H, W]: in float32 (or wider) by torch's sum; in
    bfloat16 each product rounded, the channels summed in float32 in
    order, the sum rounded and widened (kernel B's bfloat16 form)."""
    if not is_low(v.dtype):
        return (g * v).sum(-1)
    prod = (g * v).float()
    acc = prod[..., 0]
    for c in range(1, prod.shape[-1]):
        acc = acc + prod[..., c]
    return acc.to(v.dtype).float()


def warp_depth_bwd_plain(depth: torch.Tensor, g: torch.Tensor,
                         va: torch.Tensor, vb: torch.Tensor,
                         arows: torch.Tensor, S: int, F: int) -> torch.Tensor:
    """Plain version of the backward: fraction cotangents
    ``gfx = sum_c g va``, ``gfy = sum_c g vb`` (:func:`_channel_sum`) -> d
    depth [S*B, H, W] f32, masked by the strict border test and summed over
    the F frames (``prep_kernel._prep_bwd_kernel``)."""
    SB, H, W = depth.shape
    p = project_rows(_per_warp_depth(depth, S, F), arows)
    bz = arows[:, 11].view(-1, 1, 1) + 1e-7
    inv2 = p["inv"] * p["inv"]
    dxdd = (p["cx"] * bz - arows[:, 9].view(-1, 1, 1) * p["cz"]) * inv2
    dydd = (p["cy"] * bz - arows[:, 10].view(-1, 1, 1) * p["cz"]) * inv2
    gx, gy = _channel_sum(g, va), _channel_sum(g, vb)
    mx = ((p["x"] > 0.0) & (p["x"] < W - 1)).to(gx.dtype)
    my = ((p["y"] > 0.0) & (p["y"] < H - 1)).to(gx.dtype)
    term = gx * mx * dxdd + gy * my * dydd                    # [N, H, W]
    return term.view(S, F, SB // S, H, W).sum(dim=1).reshape(SB, H, W)


def _launch_fwd(route: str, image: torch.Tensor, depth: torch.Tensor,
                arows: torch.Tensor, S: int, F: int, band: int):
    """Kernel A on ``route`` for checked CUDA operands (the vector route's
    entry point raises where they do not fit it): (out, overlap, va, vb)."""
    _known(route)
    FB, H, W, C = image.shape
    N = S * FB
    out, va, vb = (torch.empty((N, H, W, C), dtype=torch.float32,
                               device=image.device) for _ in range(3))
    overlap = torch.empty((N, H, W), dtype=torch.bool, device=image.device)
    fn = "fsnet_warp_depth_fwd" + _SUFFIX[route]
    with torch.cuda.device(image.device):
        err = _entry("warp_depth", fn, (0, 1, 2, 3, 4, 5, 6), 15)(
            image.data_ptr(), depth.data_ptr(), arows.data_ptr(),
            out.data_ptr(), va.data_ptr(), vb.data_ptr(), overlap.data_ptr(),
            S, F, FB // F, H, W, C, band, _stream(image))
    _raise_on(err, fn)
    warp_depth_fwd.launches += 1
    warp_depth_fwd.routes[route] += 1
    return out, overlap, va, vb


def warp_depth_fwd(image: torch.Tensor, depth: torch.Tensor,
                   arows: torch.Tensor, S: int, F: int, band: int):
    """The forward (kernel A on a CUDA device, on the route of
    :func:`proj_route`): (out, overlap, va, vb); a bfloat16 image is warped
    widened and out, va and vb are rounded to bfloat16."""
    if is_low(image.dtype):
        out, overlap, va, vb = warp_depth_fwd(image.float(), depth, arows, S,
                                              F, band)
        return (out.to(image.dtype), overlap, va.to(image.dtype),
                vb.to(image.dtype))
    _check(image, depth, arows, S, F)
    if not _route(image, "warp_depth_fwd"):
        return warp_depth_plain(image, depth, arows, S, F, band)
    # the route from the inputs: the outputs, fresh CUDA allocations, are
    # 16-byte aligned
    return _launch_fwd(proj_route(image, depth, arows), image, depth, arows,
                       S, F, band)


def warp_depth_bwd(depth: torch.Tensor, g: torch.Tensor, va: torch.Tensor,
                   vb: torch.Tensor, arows: torch.Tensor, S: int,
                   F: int) -> torch.Tensor:
    """The depth cotangent (kernel B on a CUDA device) -> [S*B, H, W]
    float32; g, va and vb float32, or all bfloat16 (kernel B's bfloat16
    form)."""
    if g.shape != va.shape or vb.shape != va.shape:
        raise ValueError("warp_depth_bwd: g, va and vb must share one shape")
    N, H, W, C = va.shape
    _check(va[:N // S], depth, arows, S, F, extra=(g, va, vb))
    if not _route(depth, "warp_depth_bwd"):
        return warp_depth_bwd_plain(depth, g, va, vb, arows, S, F)
    SB = depth.shape[0]
    ddepth = torch.empty((SB, H, W), dtype=torch.float32, device=depth.device)
    with torch.cuda.device(depth.device):
        err = _entry("warp_depth", "fsnet_warp_depth_bwd",
                     (0, 1, 2, 3, 4, 5), 14)(
            depth.data_ptr(), g.data_ptr(), va.data_ptr(), vb.data_ptr(),
            arows.data_ptr(), ddepth.data_ptr(), S, F, SB // S, H, W, C,
            _CODES[g.dtype], _stream(depth))
    _raise_on(err, "warp_depth_bwd")
    _counted(warp_depth_bwd, g.dtype)
    return ddepth


class WarpDepthFunction(torch.autograd.Function):
    """Forward: (preds, overlap); saves va, vb. Backward: d depth only (the
    image and the rows get none, as in the JAX custom VJP)."""

    @staticmethod
    def forward(ctx, image, depth, arows, S, F, band):
        out, overlap, va, vb = warp_depth_fwd(image, depth, arows, S, F, band)
        ctx.S, ctx.F = S, F
        ctx.save_for_backward(depth, arows, va, vb)
        ctx.mark_non_differentiable(overlap)
        return out, overlap

    @staticmethod
    def backward(ctx, g, _):
        depth, arows, va, vb = ctx.saved_tensors
        ddepth = warp_depth_bwd(depth, g.contiguous(), va, vb, arows, ctx.S,
                                ctx.F)
        return None, ddepth, None, None, None, None


def warp_depth_fused(image: torch.Tensor, depth: torch.Tensor,
                     arows: torch.Tensor, S: int, F: int,
                     band: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Border-padded bilinear band warp of ``image`` [F*B, H, W, C] by the
    reprojection of ``depth`` [S*B, H, W] through ``arows`` [S*F*B, 16]
    (:func:`make_affine_rows`). Returns (preds [S*F*B, H, W, C], overlap
    [S*F*B, H, W] bool, the in-bounds mask of the unclamped sampling
    coordinates). Differentiable in ``depth`` only."""
    return WarpDepthFunction.apply(image, depth, arows, S, F, band)


warp_depth_fwd.launches = 0
warp_depth_fwd.routes = dict.fromkeys(ROUTES, 0)
warp_depth_bwd.launches = 0
warp_depth_bwd.dtypes = dict.fromkeys(_DT_NAMES.values(), 0)

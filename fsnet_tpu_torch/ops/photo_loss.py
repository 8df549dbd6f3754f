"""The photometric loss of the loss head, fused: predictions + target ->
per-pixel ``w * mean_c SSIM-dissimilarity + (1 - w) * mean_c |y - x|``
(counterpart of ``fsnet_tpu.ops.photo_loss.reprojection_loss_fused``,
``photo_loss.py:72-111``).

``pred`` [N, H, W, C] and ``target`` [B, H, W, C] with N % B == 0:
prediction n compares with target n mod B, and ``(muy, sy)`` are
:func:`~fsnet_tpu_torch.ops.ssim.ssim_target_stats` of ``target``. Nothing
is tiled to N. The result is [N, H, W]. It is the function of the head's
``reprojection_loss`` (``ops/ssim.py``'s pool: reflect-101, the H pass then
the W pass, each ``((a + b) + c) * f32(1/3)``) with the channel mean taken
as an in-order sum times ``1 / C``.

On a CUDA device the forward and the prediction cotangent are kernels of
``csrc/photo_loss.cu`` (replacing the TPU kernels ``photo_loss_pallas`` and
``photo_loss_bwd_pallas``) on one of two routes, picked by
:func:`photo_route`: the vector route (C <= 4, W % 4 == 0, every operand
16-byte aligned; the target tile held on chip across its predictions) or
the narrow route for every other shape. Their plain versions
here are written for any float type and round once per operation in the
kernels' order, so the forward kernel is bitwise equal to its plain version
in float32. The cotangent is the closed-form pooled adjoint

    dL/dx = P^T(a_u) + 2 x P^T(a_v) + y P^T(a_w) + L1 term,

with a_u, a_v, a_w the loss's partials with respect to P(x), P(x^2) and
P(xy). At exact ties it follows autodiff of the JAX package's default
route, as :func:`~fsnet_tpu_torch.ops.ssim.ssim` does: the variance clamp
and the clip pass half the cotangent, and d |y - x| / dx is -1 where
y - x >= 0. (The TPU kernel's strict gates pass none at a tie.)

Only ``pred`` gets a cotangent: the target and its stats are dataset
constants, as in the JAX package. :func:`photo_loss_fwd` and
:func:`photo_loss_bwd` pick the plain version or a kernel from the device
of the tensors they are given, count launches in ``<function>.launches``,
by dtype in ``<function>.dtypes`` and by route in ``<function>.routes``;
:func:`_launch_fwd` and
:func:`_launch_bwd` launch one route's kernel (tests and ``chip_smoke.py``
hold both routes with them).

In bfloat16 (the bf16 train step: pred, target, stats and the loss
cotangent all bfloat16) the kernels and the plain versions take every
value widened to float32, compute exactly as in float32, and round the loss
and the cotangent to bfloat16 (TPU ``photo_loss_pallas`` writes the loss in
the prediction's dtype; the JAX caller rounds ``photo_loss_bwd_pallas``'s
float32 cotangent to it, ``photo_loss.py:110``); both routes take it.
"""
from __future__ import annotations

import torch

from .conv3x3 import _DT_NAMES, _counted, _entry, _raise_on, _route, _stream
from .conv3x3 import _DTYPES as _CODES
from .conv3x3 import is_low
from .geometry import abs_
from .ssim import _C1, _C2, _relu0, avg_pool3

_DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("narrow", "vector")
_SUFFIX = dict(narrow="", vector="_vec")     # of the routes' C entry points


def photo_route(pred: torch.Tensor, *others: torch.Tensor) -> str:
    """The route of kernels I and J for these operands: ``'vector'`` when
    ``pred`` [N, H, W, C] has C <= 4 and W % 4 == 0 and every tensor's data
    is 16-byte aligned; else ``'narrow'``."""
    vec = pred.shape[3] <= 4 and pred.shape[2] % 4 == 0 and \
        all(t.data_ptr() % 16 == 0 for t in (pred, *others))
    return "vector" if vec else "narrow"


def _known(route):
    if route not in ROUTES:
        raise ValueError(f"photo_loss route must be one of {ROUTES}, got "
                         f"{route!r}")


def _check(pred, target, muy, sy, extra=()):
    if pred.dim() != 4 or target.dim() != 4:
        raise ValueError("photo_loss takes NHWC pred and target, got "
                         f"{tuple(pred.shape)} and {tuple(target.shape)}")
    N, H, W, C = pred.shape
    B = target.shape[0]
    if B == 0 or N % B or tuple(target.shape[1:]) != (H, W, C) or \
            tuple(muy.shape) != tuple(target.shape) or \
            tuple(sy.shape) != tuple(target.shape) or H < 2 or W < 2:
        raise ValueError(f"photo_loss: pred {tuple(pred.shape)}, target "
                         f"{tuple(target.shape)}, stats {tuple(muy.shape)}, "
                         f"{tuple(sy.shape)} do not fit (N % B == 0, H and "
                         "W >= 2)")
    for t in (pred, target, muy, sy, *extra):
        if t.dtype not in _DTYPES or t.dtype != pred.dtype or \
                t.device != pred.device or not t.is_contiguous():
            raise TypeError("photo_loss takes contiguous tensors of one "
                            f"dtype of {sorted(map(str, _DTYPES))} on one "
                            "device")


def _terms(pred, target, muy, sy):
    """The pooled quantities and SSIM terms, as [N // B, B, H, W, C] views
    (one rounding per operation, in the kernels' order)."""
    N, H, W, C = pred.shape
    five = (N // target.shape[0],) + tuple(target.shape)

    def pool(t):
        return avg_pool3(t.reshape(N, H, W, C)).view(five)

    x = pred.view(five)
    u, v, w = pool(x), pool(x * x), pool(x * target)
    uu = u * u
    sx_raw = v - uu
    n1 = 2.0 * u * muy + _C1
    n2 = 2.0 * (w - u * muy) + _C2
    d1 = uu + muy * muy + _C1
    d2 = _relu0(sx_raw) + sy + _C2
    r = (n1 * n2) / (d1 * d2)
    return dict(x=x, u=u, sx_raw=sx_raw, n1=n1, n2=n2, d1=d1, d2=d2, r=r,
                val=(1.0 - r) / 2.0)


def _mean_c(t: torch.Tensor) -> torch.Tensor:
    """Channel mean as the kernels take it: the channels summed in order,
    times 1 / C."""
    acc = t[..., 0]
    for c in range(1, t.shape[-1]):
        acc = acc + t[..., c]
    return acc * (1.0 / t.shape[-1])


def photo_loss_plain(pred: torch.Tensor, target: torch.Tensor,
                     muy: torch.Tensor, sy: torch.Tensor,
                     ssim_weight: float = 0.85) -> torch.Tensor:
    """Plain version of the forward: the per-pixel loss [N, H, W]. Its
    clamps and abs differentiate as :func:`~fsnet_tpu_torch.ops.ssim.ssim`
    and the JAX package do, so autograd of it is the closed-form cotangent
    of :func:`photo_loss_bwd_plain`. In bfloat16: the float32 loss of the
    widened inputs, rounded."""
    if is_low(pred.dtype):
        return photo_loss_plain(pred.float(), target.float(), muy.float(),
                                sy.float(), ssim_weight).to(pred.dtype)
    t = _terms(pred, target, muy, sy)
    val = t["val"]
    dis = torch.minimum(_relu0(val), torch.ones((), dtype=val.dtype,
                                                 device=val.device))
    l1 = abs_(target - t["x"])
    loss = ssim_weight * _mean_c(dis) + (1.0 - ssim_weight) * _mean_c(l1)
    return loss.reshape(pred.shape[:3])


def _tie(gt: torch.Tensor, eq: torch.Tensor) -> torch.Tensor:
    """1 where ``gt``, 0.5 where ``eq``, else 0: the split of max, min and
    clip at a tie."""
    return gt.to(torch.float32) + 0.5 * eq.to(torch.float32)


def _adjoint3(a: torch.Tensor, dim: int) -> torch.Tensor:
    """The adjoint of one axis of the reflect-101 3-tap mean:
    ``(a[p-1] + a[p]) + a[p+1]`` with ``a`` = 0 outside the axis, then
    ``s[1] += a[0]`` and ``s[n-2] += a[n-1]`` (the reflected taps), times
    f32(1/3)."""
    n = a.shape[dim]
    z = torch.zeros_like(a.narrow(dim, 0, 1))
    ap = torch.cat([z, a, z], dim=dim)
    s = ap.narrow(dim, 0, n) + ap.narrow(dim, 1, n) + ap.narrow(dim, 2, n)
    s.narrow(dim, 1, 1).add_(a.narrow(dim, 0, 1))
    s.narrow(dim, n - 2, 1).add_(a.narrow(dim, n - 1, 1))
    third = torch.tensor(1.0 / 3.0, dtype=torch.promote_types(
        a.dtype, torch.float32), device=a.device)
    return s * third


def _pool_adjoint(a: torch.Tensor) -> torch.Tensor:
    """P^T of an [N, H, W, C] tensor: the W axis, then the H axis."""
    return _adjoint3(_adjoint3(a, 2), 1)


def photo_loss_bwd_plain(pred: torch.Tensor, target: torch.Tensor,
                         muy: torch.Tensor, sy: torch.Tensor, g: torch.Tensor,
                         ssim_weight: float = 0.85) -> torch.Tensor:
    """Plain version of the cotangent: d loss / d pred [N, H, W, C] for the
    loss cotangent ``g`` [N, H, W]. In bfloat16: the float32 cotangent of
    the widened inputs, rounded."""
    if is_low(pred.dtype):
        return photo_loss_bwd_plain(
            pred.float(), target.float(), muy.float(), sy.float(), g.float(),
            ssim_weight).to(pred.dtype)
    N, H, W, C = pred.shape
    t = _terms(pred, target, muy, sy)
    r, u, x, val = t["r"], t["u"], t["x"], t["val"]
    dt = pred.dtype
    gmax = _tie(t["sx_raw"] > 0, t["sx_raw"] == 0).to(dt)
    gclip = _tie((val > 0) & (val < 1), (val == 0) | (val == 1)).to(dt)
    g5 = g.view(*x.shape[:4], 1)
    G = g5 * (-0.5 * ssim_weight / C) * gclip
    inv1 = 1.0 / t["d1"]
    inv2 = 1.0 / t["d2"]
    dr_dsx = -r * inv2
    dr_dw = 2.0 * t["n1"] * inv1 * inv2
    dr_du = (2.0 * muy * t["n2"] * inv1 * inv2 - 2.0 * u * r * inv1
             - 2.0 * u * gmax * dr_dsx - muy * dr_dw)

    def adj(a):
        return _pool_adjoint(a.reshape(N, H, W, C)).view(x.shape)

    hu = adj(G * dr_du)
    hv = adj(G * (dr_dsx * gmax))
    hw = adj(G * dr_dw)
    sign = torch.where(target - x >= 0, -1.0, 1.0).to(dt)
    dl1 = g5 * ((1.0 - ssim_weight) / C) * sign
    return (hu + 2.0 * x * hv + target * hw + dl1).reshape(N, H, W, C)


def _launch_fwd(route: str, pred: torch.Tensor, target: torch.Tensor,
                muy: torch.Tensor, sy: torch.Tensor,
                ssim_weight: float = 0.85) -> torch.Tensor:
    """Kernel I on ``route`` for checked CUDA operands (the vector route's
    entry point raises where they do not fit it): loss [N, H, W]."""
    _known(route)
    N, H, W, C = pred.shape
    loss = torch.empty((N, H, W), dtype=pred.dtype, device=pred.device)
    fn = "fsnet_photo_loss_fwd" + _SUFFIX[route]
    with torch.cuda.device(pred.device):
        err = _entry("photo_loss", fn, range(5), 15, floats=(10, 11, 12))(
            pred.data_ptr(), target.data_ptr(), muy.data_ptr(), sy.data_ptr(),
            loss.data_ptr(), N, target.shape[0], H, W, C, float(ssim_weight),
            1.0 - ssim_weight, 1.0 / C, _CODES[pred.dtype], _stream(pred))
    _raise_on(err, fn)
    _counted(photo_loss_fwd, pred.dtype)
    photo_loss_fwd.routes[route] += 1
    return loss


def _launch_bwd(route: str, pred: torch.Tensor, target: torch.Tensor,
                muy: torch.Tensor, sy: torch.Tensor, g: torch.Tensor,
                ssim_weight: float = 0.85) -> torch.Tensor:
    """Kernel J on ``route`` for checked CUDA operands (the vector route's
    entry point raises where they do not fit it): dpred [N, H, W, C]."""
    _known(route)
    N, H, W, C = pred.shape
    dpred = torch.empty_like(pred)
    fn = "fsnet_photo_loss_bwd" + _SUFFIX[route]
    with torch.cuda.device(pred.device):
        err = _entry("photo_loss", fn, range(6), 15, floats=(11, 12))(
            pred.data_ptr(), target.data_ptr(), muy.data_ptr(), sy.data_ptr(),
            g.data_ptr(), dpred.data_ptr(), N, target.shape[0], H, W, C,
            -0.5 * ssim_weight / C, (1.0 - ssim_weight) / C,
            _CODES[pred.dtype], _stream(pred))
    _raise_on(err, fn)
    _counted(photo_loss_bwd, pred.dtype)
    photo_loss_bwd.routes[route] += 1
    return dpred


def photo_loss_fwd(pred: torch.Tensor, target: torch.Tensor,
                   muy: torch.Tensor, sy: torch.Tensor,
                   ssim_weight: float = 0.85) -> torch.Tensor:
    """The forward (kernel I on a CUDA device, on the route of
    :func:`photo_route`): loss [N, H, W]."""
    _check(pred, target, muy, sy)
    if not _route(pred, "photo_loss_fwd"):
        return photo_loss_plain(pred, target, muy, sy, ssim_weight)
    # the route from the inputs: the output, a fresh CUDA allocation, is
    # 16-byte aligned
    return _launch_fwd(photo_route(pred, target, muy, sy), pred, target, muy,
                       sy, ssim_weight)


def photo_loss_bwd(pred: torch.Tensor, target: torch.Tensor,
                   muy: torch.Tensor, sy: torch.Tensor, g: torch.Tensor,
                   ssim_weight: float = 0.85) -> torch.Tensor:
    """The prediction cotangent (kernel J on a CUDA device, on the route of
    :func:`photo_route`): dpred [N, H, W, C]."""
    _check(pred, target, muy, sy, extra=(g,))
    N, H, W, C = pred.shape
    if tuple(g.shape) != (N, H, W):
        raise ValueError(f"photo_loss_bwd: g {tuple(g.shape)} is not "
                         f"{(N, H, W)}")
    if not _route(pred, "photo_loss_bwd"):
        return photo_loss_bwd_plain(pred, target, muy, sy, g, ssim_weight)
    return _launch_bwd(photo_route(pred, target, muy, sy, g), pred, target,
                       muy, sy, g, ssim_weight)


class PhotoLossFunction(torch.autograd.Function):
    """Forward: the per-pixel loss; saves the inputs. Backward: d pred only
    (the target and its stats get none, as the JAX VJP gives them
    zeros)."""

    @staticmethod
    def forward(ctx, pred, target, muy, sy, ssim_weight):
        ctx.ssim_weight = ssim_weight
        ctx.save_for_backward(pred, target, muy, sy)
        return photo_loss_fwd(pred, target, muy, sy, ssim_weight)

    @staticmethod
    def backward(ctx, g):
        pred, target, muy, sy = ctx.saved_tensors
        dpred = photo_loss_bwd(pred, target, muy, sy, g.contiguous(),
                               ctx.ssim_weight)
        return dpred, None, None, None, None


def reprojection_loss_fused(pred: torch.Tensor, target: torch.Tensor,
                            muy: torch.Tensor, sy: torch.Tensor,
                            ssim_weight: float = 0.85) -> torch.Tensor:
    """Per-pixel photometric loss [N, H, W] of ``pred`` [N, H, W, C] against
    ``target`` [B, H, W, C] (prediction n against target n mod B), with
    ``(muy, sy)`` the :func:`~fsnet_tpu_torch.ops.ssim.ssim_target_stats` of
    ``target``. Differentiable in ``pred`` only."""
    return PhotoLossFunction.apply(pred, target, muy, sy, ssim_weight)


for _fn in (photo_loss_fwd, photo_loss_bwd):
    _fn.launches = 0
    _fn.dtypes = dict.fromkeys(_DT_NAMES.values(), 0)
photo_loss_fwd.routes = dict.fromkeys(ROUTES, 0)
photo_loss_bwd.routes = dict.fromkeys(ROUTES, 0)

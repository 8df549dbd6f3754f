"""Camera geometry on NHWC tensors (counterpart of ``fsnet_tpu.ops.geometry``:
``disp_to_depth``, ``depth_to_disp``, ``make_K44``, ``invert_K``,
``reproject``, ``rot_from_axisangle``, ``get_translation_matrix``,
``transformation_from_parameters`` and ``get_smooth_loss``).

Projection runs in float32 at least, and the per-pixel 3x3 matvec is an
explicit chain of multiplies and adds, one rounding per operation, as
``geometry.py:191-197`` requires: pixel addressing needs sub-pixel
precision at W=640. :func:`project_rows` is that chain in pixel space, for
warps given as affine rows; the warp kernels of ``csrc/warp_depth.cu``
repeat it operation for operation. :func:`reproject` is the grid route's
form, with the JAX package's order of operations.
"""
from __future__ import annotations

from typing import Dict

import torch


def disp_to_depth(disp, min_depth: float, max_depth: float):
    """Sigmoid disparity -> (scaled_disp, depth)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    depth = 1.0 / scaled_disp
    return scaled_disp, depth


def depth_to_disp(depth, min_depth, max_depth):
    """Inverse of :func:`disp_to_depth`. ``min_depth``/``max_depth`` may be
    scalars or broadcastable tensors (fx-scaled per-sample bounds)."""
    return (1.0 / depth - 1.0 / max_depth) / (1.0 / min_depth - 1.0 / max_depth)


def _mat_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def make_K44(P: torch.Tensor) -> torch.Tensor:
    """The 3x3 intrinsics of a [B, 3, 4] (or [B, 4, 4]) camera matrix in a
    [B, 4, 4] K with K[3, 3] = 1."""
    K = torch.zeros((P.shape[0], 4, 4), dtype=P.dtype, device=P.device)
    K[:, :3, :3] = P[:, :3, :3]
    K[:, 3, 3] = 1.0
    return K


def invert_K(K: torch.Tensor) -> torch.Tensor:
    """Inverse of a [B, 4, 4] intrinsics matrix, in float32 or wider."""
    return torch.linalg.inv(K.to(_mat_dtype(K.dtype)))


def project_rows(depth: torch.Tensor, arows: torch.Tensor) -> Dict:
    """Pixel-space projection of ``depth`` [N, H, W] through per-warp affine
    rows ``arows`` [N, 16] (cols 0-8 the row-major 3x3 A = (K T)[:3, :3]
    inv_K3, cols 9-11 b = (K T)[:3, 3]). For pixel (col j, row i):
    ``c = A [j, i, 1]``, ``inv = 1 / (d cz + bz + 1e-7)``,
    ``x = (d cx + bx) inv``, ``y = (d cy + by) inv``. Returns x, y, cx, cy,
    cz, inv, each [N, H, W] in float32 or wider."""
    N, H, W = depth.shape
    ft = _mat_dtype(depth.dtype)
    jj = torch.arange(W, dtype=ft, device=depth.device).view(1, 1, W)
    ii = torch.arange(H, dtype=ft, device=depth.device).view(1, H, 1)
    a = [arows[:, k].to(ft).view(N, 1, 1) for k in range(12)]
    d = depth.to(ft)
    cx = a[0] * jj + a[1] * ii + a[2]
    cy = a[3] * jj + a[4] * ii + a[5]
    cz = a[6] * jj + a[7] * ii + a[8]
    inv = torch.reciprocal(d * cz + a[11] + 1e-7)
    return dict(x=(d * cx + a[9]) * inv, y=(d * cy + a[10]) * inv,
                cx=cx, cy=cy, cz=cz, inv=inv)


def reproject(depth: torch.Tensor, K: torch.Tensor, inv_K: torch.Tensor,
              T: torch.Tensor) -> torch.Tensor:
    """Depth [B, H, W, 1] through pose T and intrinsics K (each [B, 4, 4])
    -> the sampling grid [B, H, W, 2] in normalized [-1, 1] coordinates
    (align_corners), in float32 or wider. ``A = (K T)[:3, :3] inv_K3`` and
    ``b = (K T)[:3, 3]`` are composed per batch; per pixel
    ``c = A [j, i, 1]`` as an explicit chain, then ``x = (cx d + bx) /
    (cz d + bz + 1e-7)`` with a true division, as ``geometry.py:196-206``
    computes it."""
    B, H, W, _ = depth.shape
    mt = _mat_dtype(K.dtype)
    P = torch.matmul(K.to(mt), T.to(mt))[:, :3, :]
    A = torch.matmul(P[:, :, :3], inv_K[:, :3, :3].to(mt))
    jj = torch.arange(W, dtype=mt, device=depth.device).view(1, 1, W)
    ii = torch.arange(H, dtype=mt, device=depth.device).view(1, H, 1)
    d = depth[..., 0].to(mt)
    a = A.view(B, 9, 1, 1)
    b = P[:, :, 3].view(B, 3, 1, 1)
    cam = [(a[:, 3 * k] * jj + a[:, 3 * k + 1] * ii + a[:, 3 * k + 2]) * d
           + b[:, k] for k in range(3)]
    den = cam[2] + 1e-7
    u = cam[0] / den / (W - 1)
    v = cam[1] / den / (H - 1)
    return torch.stack([(u - 0.5) * 2.0, (v - 0.5) * 2.0], dim=-1)


def rot_from_axisangle(vec: torch.Tensor) -> torch.Tensor:
    """Axis-angle [B, 3] or [B, 1, 3] -> rotation [B, 4, 4] (Rodrigues,
    with the 1e-7 axis epsilon of ``geometry.py:45-76``)."""
    if vec.dim() == 3:
        vec = vec[:, 0, :]
    angle = torch.linalg.norm(vec, dim=-1, keepdim=True)
    axis = vec / (angle + 1e-7)
    ca = torch.cos(angle)[..., 0]
    sa = torch.sin(angle)[..., 0]
    C = 1.0 - ca
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    xs, ys, zs = x * sa, y * sa, z * sa
    xC, yC, zC = x * C, y * C, z * C
    xyC, yzC, zxC = x * yC, y * zC, z * xC
    zeros, ones = torch.zeros_like(ca), torch.ones_like(ca)
    return torch.stack([
        x * xC + ca, xyC - zs, zxC + ys, zeros,
        xyC + zs, y * yC + ca, yzC - xs, zeros,
        zxC - ys, yzC + xs, z * zC + ca, zeros,
        zeros, zeros, zeros, ones], dim=-1).reshape(vec.shape[0], 4, 4)


def get_translation_matrix(translation: torch.Tensor) -> torch.Tensor:
    """Translation [B, 3] -> [B, 4, 4]."""
    B = translation.shape[0]
    eye = torch.eye(4, dtype=translation.dtype, device=translation.device)
    top = torch.cat([eye[:3, :3].expand(B, 3, 3), translation[:, :, None]],
                    dim=2)
    return torch.cat([top, eye[3:].expand(B, 1, 4)], dim=1)


def transformation_from_parameters(axisangle: torch.Tensor,
                                   translation: torch.Tensor,
                                   invert: bool = False) -> torch.Tensor:
    """(axisangle, translation), each [B, 1, 3] as the pose decoder gives
    them per frame (or [B, 3]) -> cam_T_cam [B, 4, 4]: ``T R``, or
    ``R^T T(-t)`` with ``invert`` (``geometry.py:90-101``)."""
    R = rot_from_axisangle(axisangle)
    t = translation[:, 0, :] if translation.dim() == 3 else translation
    if invert:
        R = R.transpose(1, 2)
        t = -t
    T = get_translation_matrix(t)
    return torch.matmul(R, T) if invert else torch.matmul(T, R)


def abs_(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with JAX's derivative at 0 (+1; ``torch.abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)


def get_smooth_loss(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware first-order smoothness of NHWC ``disp`` [B, H, W, 1]
    guided by ``img`` [B, H, W, C]."""
    grad_disp_x = abs_(disp[:, :, :-1] - disp[:, :, 1:])
    grad_disp_y = abs_(disp[:, :-1] - disp[:, 1:])
    grad_img_x = abs_(img[:, :, :-1] - img[:, :, 1:]).mean(-1, keepdim=True)
    grad_img_y = abs_(img[:, :-1] - img[:, 1:]).mean(-1, keepdim=True)
    grad_disp_x = grad_disp_x * torch.exp(-grad_img_x)
    grad_disp_y = grad_disp_y * torch.exp(-grad_img_y)
    acc = _mat_dtype(grad_disp_x.dtype)
    return grad_disp_x.to(acc).mean() + grad_disp_y.to(acc).mean()

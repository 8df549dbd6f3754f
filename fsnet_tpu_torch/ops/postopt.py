"""Test-time depth post-optimisation from sparse VO depth (counterpart of
``fsnet_tpu.ops.postopt``).

SLIC superpixels on CIELAB colour, image position and predicted depth
(:func:`slic_assign`), the VO pixels whose log depth lies nearest the
prediction's (:func:`select_best_vo_points`), and one log-scale per
segment from a K x K linear system that pulls each segment towards its VO
points and its neighbours (:func:`post_optimization`). The segments stay a
dense per-pixel assignment, so every shape is static; the per-segment
sums are ``index_add_`` where the JAX package multiplies by a one-hot
matrix (the same sums in another order). Everything is torch on the
tensors' device, in their dtype.

Two choices keep the results those of the JAX package: distances are the
norms of the differences (``torch.cdist``'s matmul form rounds otherwise
and flips the argmin at near-ties), and the VO points are chosen by a
stable ascending sort of the masked distance, so that equal distances
pick the lower index as ``jax.lax.top_k`` does.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class PostOptError(ValueError):
    """The refine cannot give a finite depth for this frame."""


def denorm(image: torch.Tensor, rgb_mean, rgb_std) -> torch.Tensor:
    """Undo the input normalisation of an [H, W, 3] image: uint8 of
    ``clip((image std + mean) 255, 0, 255)``, truncated, computed in
    float64 as numpy computes it with float64 ``rgb_mean``/``rgb_std``."""
    mean = torch.as_tensor(rgb_mean, dtype=torch.float64, device=image.device)
    std = torch.as_tensor(rgb_std, dtype=torch.float64, device=image.device)
    new = ((image.double() * std + mean) * 255).clamp(0, 255)
    return new.to(torch.uint8)


def depth_image_to_point_cloud_array(depth_image: torch.Tensor
                                     ) -> torch.Tensor:
    """[H, W] depth -> [H, W, 3] (u, v, depth) in the depth's dtype."""
    H, W = depth_image.shape
    v, u = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=depth_image.device),
        torch.arange(W, dtype=torch.float32, device=depth_image.device),
        indexing="ij")
    dt = depth_image.dtype
    return torch.stack([u.to(dt), v.to(dt), depth_image], dim=-1)


def rgb2lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB [..., 3] in [0, 1] -> CIELAB (D65), with skimage's constants."""
    rgb = rgb.clamp(0.0, 1.0)
    linear = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                         rgb / 12.92)
    M = torch.tensor([[0.412453, 0.357580, 0.180423],
                      [0.212671, 0.715160, 0.072169],
                      [0.019334, 0.119193, 0.950227]], dtype=rgb.dtype,
                     device=rgb.device)
    xyz = torch.einsum("ij,...j->...i", M, linear)
    white = torch.tensor([0.95047, 1.0, 1.08883], dtype=rgb.dtype,
                         device=rgb.device)
    xyz = xyz / white
    eps, kappa = 0.008856, 903.3
    f = torch.where(xyz > eps, xyz.clamp(min=eps) ** (1.0 / 3.0),
                    (kappa * xyz + 16.0) / 116.0)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([L, a, b], dim=-1)


def _norm(diffs) -> torch.Tensor:
    """sqrt of the sum of squares of the [P, K] differences, left to
    right (``jnp.linalg.norm`` of the stacked differences)."""
    total = diffs[0] * diffs[0]
    for d in diffs[1:]:
        total = total + d * d
    return torch.sqrt(total)


def _segment_sums(assign: torch.Tensor, values: torch.Tensor,
                  K: int) -> torch.Tensor:
    """Sums of ``values`` [P, ...] over each of the K segments."""
    out = values.new_zeros((K,) + tuple(values.shape[1:]))
    return out.index_add_(0, assign, values)


def _distances(flat_lab, flat_uvz, center_lab, center_uvz, lab_w, dep_w,
               img_w) -> torch.Tensor:
    """[P, K]: colour, depth and image distances, weighted and summed."""
    lab_d = _norm([flat_lab[:, None, c] - center_lab[None, :, c]
                   for c in range(3)])
    dep_d = (flat_uvz[:, None, 2] - center_uvz[None, :, 2]).abs()
    img_d = _norm([flat_uvz[:, None, c] - center_uvz[None, :, c]
                   for c in range(2)])
    return lab_d * lab_w + dep_d * dep_w + img_d * img_w


def slic_assign(image_lab: torch.Tensor, uvz: torch.Tensor, h_seg: int,
                w_seg: int, lab_dist_weight: float = 1.0, iter_num: int = 5,
                depth_dist_weight: float = 1.0,
                image_dist_weight: float = 1.0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SLIC-style clustering, dense: ``image_lab`` [H, W, 3], ``uvz``
    [H, W, 3] (u, v, depth) -> (assignment [H, W] int64, centre uv [K, 2],
    centre depth [K]). The K = h_seg w_seg centres start on a regular grid
    over [-1, 1], sampled from the inputs."""
    H, W, _ = image_lab.shape
    if uvz.shape[:2] != (H, W):
        raise PostOptError(f"the image {tuple(image_lab.shape[:2])} and the "
                           f"depth {tuple(uvz.shape[:2])} differ in size")
    K = h_seg * w_seg
    # the grid as numpy builds it (float32; float64 for float64 inputs, as
    # the JAX package under x64), the sampled pixel truncated
    gdt = np.float64 if image_lab.dtype == torch.float64 else np.float32
    gy = np.arange(-1.0, 1.0, 2.0 / h_seg, dtype=gdt)
    gx = np.arange(-1.0, 1.0, 2.0 / w_seg, dtype=gdt)
    if (len(gy), len(gx)) != (h_seg, w_seg):
        raise ValueError(f"the centre grid of {h_seg}x{w_seg} has "
                         f"{len(gy)}x{len(gx)} points")
    cy, cx = np.meshgrid(gy, gx, indexing="ij")
    one, two = gdt(1), gdt(2)
    py = np.clip(((cy.reshape(-1) + one) / two * gdt(H - 1)).astype(np.int64),
                 0, H - 1)
    px = np.clip(((cx.reshape(-1) + one) / two * gdt(W - 1)).astype(np.int64),
                 0, W - 1)
    py = torch.as_tensor(py, device=image_lab.device)
    px = torch.as_tensor(px, device=image_lab.device)
    center_lab = image_lab[py, px]
    center_uvz = uvz[py, px]
    flat_lab = image_lab.reshape(-1, 3)
    flat_uvz = uvz.reshape(-1, 3)
    weights = (lab_dist_weight, depth_dist_weight, image_dist_weight)
    for _ in range(iter_num):
        assign = torch.argmin(_distances(flat_lab, flat_uvz, center_lab,
                                         center_uvz, *weights), dim=-1)
        counts = _segment_sums(assign, torch.ones_like(flat_lab[:, 0]),
                               K) + 1e-4
        center_lab = _segment_sums(assign, flat_lab, K) / counts[:, None]
        center_uvz = _segment_sums(assign, flat_uvz, K) / counts[:, None]
    assign = torch.argmin(_distances(flat_lab, flat_uvz, center_lab,
                                     center_uvz, *weights), dim=-1)
    return assign.reshape(H, W), center_uvz[:, 0:2], center_uvz[:, 2]


def select_best_vo_points(log_pred: torch.Tensor, log_vo: torch.Tensor,
                          max_points: int) -> torch.Tensor:
    """[H, W] mask of the ``max_points`` VO pixels (depth in (3, 80) m)
    closest to the prediction in log space, the lower index first among
    equal distances; every valid pixel where there are fewer."""
    H, W = log_pred.shape
    flat_pred = log_pred.reshape(-1)
    flat_vo = log_vo.reshape(-1)
    log80 = torch.log(torch.tensor(80.0, dtype=flat_vo.dtype))
    log3 = torch.log(torch.tensor(3.0, dtype=flat_vo.dtype))
    base_valid = (flat_vo < log80.to(flat_vo.device)) & (
        flat_vo > log3.to(flat_vo.device))
    diff = torch.where(base_valid, (flat_pred - flat_vo).abs(),
                       torch.full_like(flat_pred, float("inf")))
    order = torch.sort(diff, stable=True).indices[:max_points]
    top = torch.zeros_like(base_valid)
    top[order] = True
    use_all = base_valid.sum() < max_points
    return torch.where(use_all, base_valid, base_valid & top).reshape(H, W)


def post_optimization(image, depth_image, depth_prediction, reference_depth,
                      h_seg: int, w_seg: int, lab_dist_weight: float = 1.0,
                      iter_num: int = 5, depth_dist_weight: float = 1.0,
                      image_dist_weight: float = 1.0, lambda0: float = 0.0,
                      lambda1: float = 1.0, lambda2: float = 0.001,
                      max_distance: float = 100.0, max_points: int = 800):
    """Refine ``depth_prediction`` [H, W] with the sparse VO depth
    ``reference_depth`` [H, W]: ``image`` [H, W, 3] RGB in [0, 1],
    ``depth_image`` [H, W, 3] (u, v, depth). Returns the refined depth
    [H, W]. Raises :class:`PostOptError` where the inputs' sizes differ or
    the refined depth is not finite."""
    del max_distance  # kept for the configs (unused in the JAX package too)
    if not (image.shape[:2] == depth_image.shape[:2]
            == depth_prediction.shape == reference_depth.shape):
        raise PostOptError(
            f"image {tuple(image.shape[:2])}, uvz "
            f"{tuple(depth_image.shape[:2])}, prediction "
            f"{tuple(depth_prediction.shape)} and VO depth "
            f"{tuple(reference_depth.shape)} must be one size")
    K = h_seg * w_seg
    assignment, centers_uv, _ = slic_assign(
        rgb2lab(image), depth_image, h_seg, w_seg,
        lab_dist_weight=lab_dist_weight, iter_num=iter_num,
        depth_dist_weight=depth_dist_weight,
        image_dist_weight=image_dist_weight)
    log_pred = torch.log(depth_prediction)
    log_vo = torch.log(reference_depth)
    valid_f = select_best_vo_points(log_pred, log_vo, max_points
                                    ).reshape(-1).to(log_pred.dtype)
    flat = assignment.reshape(-1)
    lp = log_pred.reshape(-1)
    counts = _segment_sums(flat, torch.ones_like(lp), K)
    base_scales = _segment_sums(flat, lp, K) / counts.clamp(min=1e-4)
    seg_valid = _segment_sums(flat, valid_f, K)
    seg_residual = _segment_sums(flat, (log_vo.reshape(-1) - lp) * valid_f,
                                 K)
    has_valid = seg_valid >= 1
    lambda1_array = lambda1 * has_valid.to(lp.dtype)
    target_scales = torch.where(
        has_valid, seg_residual / seg_valid.clamp(min=1.0) + base_scales,
        torch.ones_like(base_scales))
    roki = base_scales[:, None] - base_scales[None, :]
    center_diff = _norm([centers_uv[:, None, c] - centers_uv[None, :, c]
                         for c in range(2)])
    weights = torch.exp(-center_diff / 20.0)
    sum_weights = weights.sum(dim=-1)
    A = (torch.diag(sum_weights * lambda0 + lambda1_array + lambda2)
         - lambda0 * weights)
    B = (lambda2 * base_scales + lambda1_array * target_scales
         + lambda0 * (roki * weights).sum(dim=-1))
    new_scale = torch.linalg.solve(A, B[:, None])[:, 0]
    refined = torch.exp(log_pred + (new_scale - base_scales)[assignment])
    if not bool(torch.isfinite(refined).all()):
        raise PostOptError("the refined depth is not finite")
    return refined

"""Mei unified camera model (fisheye): the forward projection in torch and the
host-side inverse that backtracks a whole pixel grid to unit rays
(counterpart of ``fsnet_tpu.ops.fisheye``: ``mei_distort``, ``cam2image``,
``_newton_radial_np``, ``_bisection_mirror_np``, ``backtrack_ray_map`` and
``MeiCameraProjection.get_ray_map``, ``fisheye.py:29-166``).

The inverse is numpy and runs once per (H, W, intrinsics) on the host; its
ray maps enter a batch as ``'fisheye_rays'`` [B, H, W, 4] = (X, Y, Z, mask).
The code of the inverse is the JAX package's, so both packages build the
same rays bit for bit. The in-graph inverse for traced intrinsics
(``image2cam_fixed_iter``) is not ported.

Calib dict layout as the reference yaml:
``{"mirror_parameters": {"xi": ...}, "distortion_parameters": {"k1": ...,
"k2": ...}}``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def mei_distort(x, y, k1, k2):
    """Radial distortion on the normalized plane."""
    ro2 = x * x + y * y
    factor = 1.0 + k1 * ro2 + k2 * ro2 * ro2
    return x * factor, y * factor


def cam2image(points: torch.Tensor, P: torch.Tensor, xi, k1, k2,
              eps: float = 1e-6) -> torch.Tensor:
    """Camera points [..., 3] -> pixel (x, y, signed_norm) [..., 3]; ``P``
    is [3, 4]-like or [4, 4]."""
    norm = torch.linalg.vector_norm(points, dim=-1)
    x = points[..., 0] / (norm + eps)
    y = points[..., 1] / (norm + eps)
    z = points[..., 2] / (norm + eps)

    x = x / (z + xi + eps)
    y = y / (z + xi + eps)
    x, y = mei_distort(x, y, k1, k2)

    gamma1, gamma2 = P[0, 0], P[1, 1]
    u0, v0 = P[0, 2], P[1, 2]
    px = gamma1 * x + u0
    py = gamma2 * y + v0
    signed_norm = norm * points[..., 2] / (torch.abs(points[..., 2]) + eps)
    return torch.stack([px, py, signed_norm], dim=-1)


# ------------------------------------------------------------ inverse (host)

def _newton_radial_np(r1: np.ndarray, k1: float, k2: float,
                      iters: int = 50, tol: float = 1e-6) -> np.ndarray:
    """Vectorized Newton solve of r1 = r0 (1 + k1 r0^2 + k2 r0^4) for r0."""
    r0 = r1.copy()

    def f(x):
        return x - r1 / (1.0 + k1 * x ** 2 + k2 * x ** 4)

    for _ in range(iters):
        fx = f(r0)
        dfx = (f(r0 + tol) - fx) / tol
        step = np.where(np.abs(dfx) > 1e-12, fx / np.where(dfx == 0, 1, dfx), 0.0)
        converged = np.abs(fx) < tol
        r0 = np.where(converged, r0, r0 - step)
    return r0


def _bisection_mirror_np(r0: np.ndarray, xi: float, iters: int = 50,
                         tol: float = 1e-6) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized bisection solve of r0^2 = (1 - Z^2)/(xi + Z)^2 for Z in
    [0, 1]. Returns (valid, Z)."""

    def g(Z):
        return r0 ** 2 - (1.0 - Z ** 2) / (xi + Z) ** 2

    lo = np.zeros_like(r0)
    hi = np.ones_like(r0)
    y_lo = g(lo)
    y_hi = g(hi)
    valid = (y_lo * y_hi) <= 0

    for _ in range(iters):
        mid = (lo + hi) / 2.0
        y_mid = g(mid)
        go_right = y_mid * g(lo) < 0
        hi = np.where(go_right, mid, hi)
        lo = np.where(go_right, lo, mid)
    Z = (lo + hi) / 2.0
    return valid, np.where(valid, Z, lo - 1.0)


def backtrack_ray_map(H: int, W: int, P: np.ndarray, xi: float, k1: float,
                      k2: float, ref_compat_xy: bool = False):
    """Full-image inverse projection: pixel grid -> (X, Y, Z, mask), each
    [1, H, W] float32, with X/Y/Z the per-pixel ray such that
    ``point3d = ray * norm``. Pixels whose mirror solve fails or whose Z is
    below 0.05 are invalid (mask 0, X = Y = -(xi - 1), Z = -1).

    The reference solves the radial model for ``r0`` but keeps the
    distorted-plane X/Y; here X/Y are rescaled by ``r0 / r1`` so that the
    forward model inverts the map. ``ref_compat_xy=True`` keeps the
    reference's X/Y."""
    u0, v0 = float(P[0, 2]), float(P[1, 2])
    gamma1, gamma2 = float(P[0, 0]), float(P[1, 1])

    uu, vv = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32), indexing="xy")
    X = (uu - u0) / gamma1
    Y = (vv - v0) / gamma2

    r1 = np.sqrt(X ** 2 + Y ** 2)
    r0 = _newton_radial_np(r1, k1, k2)
    valid, Z = _bisection_mirror_np(r0, xi)

    mask = valid.astype(np.float32)
    mask[Z < 0.05] = 0
    not_mask = mask == 0
    Z = Z.copy()
    Z[not_mask] = -1.0
    if not ref_compat_xy:
        X = X * r0 / np.maximum(r1, 1e-12)
        Y = Y * r0 / np.maximum(r1, 1e-12)
    X[not_mask] = -1.0
    Y[not_mask] = -1.0
    X = X * (Z + xi)
    Y = Y * (Z + xi)
    return (X[None].astype(np.float32), Y[None].astype(np.float32),
            Z[None].astype(np.float32), mask[None].astype(np.float32))


class MeiCameraProjection:
    """Host cache of inverse ray maps, one entry per camera."""

    def __init__(self):
        self.cache: Dict = {}

    @staticmethod
    def _calib_params(calib: Dict):
        return (float(calib["mirror_parameters"]["xi"]),
                float(calib["distortion_parameters"]["k1"]),
                float(calib["distortion_parameters"]["k2"]))

    def get_ray_map(self, H: int, W: int, P, calib: Dict):
        """(X, Y, Z, mask) numpy [1, H, W] for one camera; cached."""
        xi, k1, k2 = self._calib_params(calib)
        P = np.asarray(P)
        key = (H, W, float(P[0, 0]), float(P[1, 1]), float(P[0, 2]),
               float(P[1, 2]), k1, k2, xi)
        if key not in self.cache:
            self.cache[key] = backtrack_ray_map(H, W, P, xi, k1, k2)
        return self.cache[key]

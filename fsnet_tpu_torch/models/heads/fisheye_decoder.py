"""Fisheye (Mei unified camera) loss head (counterpart of
``fsnet_tpu.models.heads.fisheye_decoder.FishEyeDecoder``).

The decoder's "depth" output is read as the *norm* of the 3D point along
each pixel's ray. The batch carries the host-backtracked ray maps
(``'fisheye_rays'`` [B, H, W, 4] = (X, Y, Z, mask),
:func:`~fsnet_tpu_torch.ops.fisheye.backtrack_ray_map`) and the camera
scalars (``'fisheye_params'`` [B, 3] = (xi, k1, k2)). The loss lifts the
norm along the rays, moves the points by the frame's pose, projects them
through the Mei forward model and warps the source frames there, on one of
the JAX head's two routes:

* norm-direct, when every pose is a dataset constant (``MonoDepthWPose``),
  with or without a ``patched_mask``:
  :func:`~fsnet_tpu_torch.ops.warp_mei.warp_mei_fused`, the source validity
  being ``rays[..., 3] * patched_mask``;
* the grid route otherwise: the rotated ray field is built once per frame
  with an explicit multiply-add chain, the [S*F*B, H, W, 2] grids come from
  :func:`_mei_project`, one bilinear/border band warp
  (:func:`~fsnet_tpu_torch.ops.warp_fast.grid_sample`) warps all of them,
  and the overlap is the nearest/zeros warp of ``patched * valid`` tested
  ``== 1.0``.

In the bf16 step (a bfloat16 batch; the decoded norms are float32, as
the depth bins are) both routes keep the sources in bfloat16, as the JAX
head does: the norm-direct route gives kernel G the bfloat16 sources
beside the norms and float32 rays, validity and Mei rows (widened from
the cast batch's values), and the grid route builds its grids in float32
(``fsnet_tpu/models/heads/fisheye_decoder.py:138-166``) and warps the
bfloat16 sources and validity; the predictions are bfloat16.

The rest of the loss (min-reprojection, automask, the patched-mask
normaliser, smoothness) is :class:`MonoDepth2Decoder`'s. ``get_prediction``
returns the z-depth, the norm and the fisheye validity mask.
"""
from __future__ import annotations

from typing import Dict

import torch

from ...ops.conv3x3 import is_low
from ...ops.warp_fast import grid_sample
from ...ops.warp_mei import make_mei_rows, warp_mei_fused
from ..blocks import interpolate_bilinear
from .monodepth2_decoder import MonoDepth2Decoder


def _mei_project(points: torch.Tensor, P: torch.Tensor, params: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Batched Mei forward projection: points [N, H, W, 3], P [N, 3+, 4],
    params [N, 3] = (xi, k1, k2) -> pixel coords [N, H, W, 2]."""
    xi, k1, k2 = (params[:, k].view(-1, 1, 1) for k in range(3))
    norm = torch.linalg.vector_norm(points, dim=-1)
    x = points[..., 0] / (norm + eps)
    y = points[..., 1] / (norm + eps)
    z = points[..., 2] / (norm + eps)

    x = x / (z + xi + eps)
    y = y / (z + xi + eps)
    ro2 = x * x + y * y
    factor = 1.0 + k1 * ro2 + k2 * ro2 * ro2
    x = x * factor
    y = y * factor

    gamma1, gamma2 = P[:, 0, 0].view(-1, 1, 1), P[:, 1, 1].view(-1, 1, 1)
    u0, v0 = P[:, 0, 2].view(-1, 1, 1), P[:, 1, 2].view(-1, 1, 1)
    return torch.stack([gamma1 * x + u0, gamma2 * y + v0], dim=-1)


class FishEyeDecoder(MonoDepth2Decoder):
    """Drop-in fisheye head with the JAX head's config surface; the band of
    its warps defaults to 16 rows (Mei reprojections bend rows vertically
    far more than pinhole ones)."""

    def __init__(self, *args, warp_band: int = 16, **kwargs):
        super().__init__(*args, warp_band=warp_band, **kwargs)

    def _lift(self, norm_map: torch.Tensor, input_dict: Dict):
        """norm [B, H, W, 1] + the batch's ray maps -> (points [B, H, W, 3],
        valid mask [B, H, W])."""
        rays = input_dict["fisheye_rays"]
        return rays[..., 0:3] * norm_map, rays[..., 3]

    def _warp_all(self, input_dict, output_dict):
        """(preds [S, F, B, H, W, C], overlap [S, F, B, H, W] bool or None,
        norms_full [S, B, H, W, 1]), norm-direct when every pose is a
        constant, else on the grid route."""
        frames = self.frame_ids[1:]
        S, F = len(self.scales), len(frames)
        H, W = self.height, self.width
        norms_full = torch.stack([
            interpolate_bilinear(output_dict[("depth", s, s)], H, W,
                                 align_corners=True)
            for s in self.scales], dim=0)
        B = norms_full.shape[1]
        N = S * F * B
        P = input_dict["P2"]
        params = input_dict["fisheye_params"]
        Ts = torch.stack([output_dict[("cam_T_cam", f)] for f in frames])
        sources = torch.stack([input_dict[("original_image", f)]
                               for f in frames])
        C = sources.shape[-1]
        # the grid math's dtype (the decoded norms': float32, or wider) and
        # the sources' (bfloat16 in the bf16 step, else the grid math's)
        ft = torch.promote_types(norms_full.dtype, torch.float32)
        cdt = sources.dtype if is_low(sources.dtype) else ft
        sources = sources.reshape(F * B, H, W, C).to(cdt).contiguous()
        rays = input_dict["fisheye_rays"].to(ft)
        valid = rays[..., 3]
        if "patched_mask" in input_dict:
            valid = valid * input_dict["patched_mask"].to(ft)

        if bool(output_dict.pop("pose_is_const", False)):
            preds, overlap = warp_mei_fused(
                sources, valid.contiguous(),
                norms_full.reshape(S * B, H, W).contiguous(),
                rays[..., 0:3].permute(0, 3, 1, 2).contiguous(),
                make_mei_rows(P, params, Ts, S).to(ft), S, F, self.warp_band,
                bool(self.overlapped_mask))
            preds = preds.reshape(S, F, B, H, W, C)
            overlap = (overlap.reshape(S, F, B, H, W) if self.overlapped_mask
                       else None)
            return preds, overlap, norms_full

        # the grid route: T (rays * norm) = norm (R rays) + t, so the
        # rotated ray field is built once per frame, as an explicit chain
        R = Ts[:, :, :3, :3].to(ft)[:, :, None, None]           # [F,B,1,1,3,3]
        rot = torch.stack([R[..., k, 0] * rays[None, ..., 0]
                           + R[..., k, 1] * rays[None, ..., 1]
                           + R[..., k, 2] * rays[None, ..., 2]
                           for k in range(3)], dim=-1)          # [F,B,H,W,3]
        trans = Ts[:, :, :3, 3].to(ft)[:, :, None, None]         # [F,B,1,1,3]
        points = norms_full[:, None].to(ft) * rot[None] + trans[None]

        def per_warp(t):                              # [B, ...] -> [N, ...]
            return t[None, None].expand(S, F, *t.shape).reshape(
                N, *t.shape[1:])

        pix = _mei_project(points.reshape(N, H, W, 3), per_warp(P.to(ft)),
                           per_warp(params.to(ft)))
        grids = torch.stack([pix[..., 0] / max(W - 1, 1) * 2.0 - 1.0,
                             pix[..., 1] / max(H - 1, 1) * 2.0 - 1.0],
                            dim=-1).contiguous()
        preds = grid_sample(sources, grids, mode="bilinear",
                            padding_mode="border", impl=self.warp_impl,
                            band=self.warp_band).reshape(S, F, B, H, W, C)
        overlap = None
        if self.overlapped_mask:
            # warp n reads mask n mod B
            warped = grid_sample(valid[..., None].to(cdt).contiguous(),
                                 grids, mode="nearest", padding_mode="zeros",
                                 impl=self.warp_impl, band=self.warp_band)
            overlap = (warped == 1.0).reshape(S, F, B, H, W)
        return preds, overlap, norms_full

    def get_prediction(self, input_dict, output_dict) -> Dict:
        """z-depth, norm and the fisheye validity mask at full resolution."""
        if ("depth", 0, 0) in output_dict:
            norm = output_dict[("depth", 0, 0)]
        else:
            norm = interpolate_bilinear(
                output_dict[("depth", self.scales[0], self.scales[0])],
                self.height, self.width, align_corners=True)
        points, mask = self._lift(norm, input_dict)
        return dict(depth=points[..., 2:3], norm=norm, fisheye_mask=mask)

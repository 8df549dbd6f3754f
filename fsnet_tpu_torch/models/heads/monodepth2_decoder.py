"""MonoDepth2 head: the depth and pose forwards, the eval prediction and the
self-supervised loss (counterpart of
``fsnet_tpu.models.heads.monodepth2_decoder.MonoDepth2Decoder``).

The loss warps the source frames into frame 0 for all S scales x F frames
in one pass, on one of the JAX package's two routes:

* depth-direct, when every pose is a dataset constant and the batch has no
  ``patched_mask`` (the GT-pose flagship on a synthetic batch):
  :func:`~fsnet_tpu_torch.ops.warp_depth.warp_depth_fused`;
* the grid route otherwise (every dataset batch carries ``patched_mask``;
  learned poses): :func:`~fsnet_tpu_torch.ops.geometry.reproject` builds
  the [S*F*B, H, W, 2] grids, one bilinear/border band warp
  (:func:`~fsnet_tpu_torch.ops.warp_fast.grid_sample`) warps all of them
  against the F*B sources, and the overlap is the analytic in-bounds test,
  or with a mask its nearest/zeros warp tested ``== 1.0``. Gradients reach
  depth and poses through the grid.

Then 0.85 SSIM + 0.15 L1 per pixel
(:func:`~fsnet_tpu_torch.ops.photo_loss.reprojection_loss_fused`, against
target n mod B), the overlap mask, the identity automask
with the identity candidates pre-minned over the frames (or, where the
batch carries a precomputed ``motion_mask``, the min-reprojection with no
gradient through the mask's pixels and no identity stack), the patched
mask, and edge-aware smoothness over a dyadic color pyramid; with
``distillation_loss_weight`` the teacher-student depth loss of every scale
(:meth:`MonoDepth2Decoder.compute_distill_loss`). Other branches (residual
poses or flow, light compensation, SSIM weights, depth monitors) raise. On
a CUDA device the warps and the photometric loss are the Hopper kernels.

The identity tie-break noise is an input: ``noise`` [F, B, H, W] standard
normal values, scaled by 1e-5 as in the JAX package; without it no noise is
added. The port cannot reproduce the JAX random bits.

The constructor takes the JAX head's full option surface, so one config
dict builds either package.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from ...ops.geometry import (abs_, get_smooth_loss, invert_K, make_K44,
                             reproject)
from ...ops.photo_loss import reprojection_loss_fused
from ...ops.ssim import ssim, ssim_target_stats
from ...ops.warp_depth import make_affine_rows, warp_depth_fused
from ...ops.warp_fast import grid_sample, unnormalize
from ...utils.builder import build
from ..blocks import adaptive_avg_pool2d, interpolate_bilinear


def reprojection_loss(pred: torch.Tensor, target: torch.Tensor,
                      ssim_weight: float = 0.85,
                      target_stats=None) -> torch.Tensor:
    """0.85 SSIM + 0.15 L1, mean over channels -> [..., H, W, 1]: the
    photometric loss in its reference form, on shape-matched operands (the
    head's loss runs
    :func:`~fsnet_tpu_torch.ops.photo_loss.reprojection_loss_fused`)."""
    l1 = abs_(target - pred).mean(dim=-1, keepdim=True)
    s = ssim(pred, target, y_stats=target_stats).mean(dim=-1, keepdim=True)
    return ssim_weight * s + (1.0 - ssim_weight) * l1


class MonoDepth2Decoder(nn.Module):
    """Depth head built from ``depth_decoder_cfg`` through the builder."""

    def __init__(self, scales: Sequence[int] = (0, 1, 2, 3), height: int = 192,
                 width: int = 640, frame_ids: Sequence[Any] = (0, 1, -1),
                 depth_decoder_cfg: Optional[Dict] = None,
                 pose_decoder_cfg: Optional[Dict] = None,
                 multiscale_head_cfg: Optional[Dict] = None,
                 min_depth: float = 0.1, max_depth: float = 100.0,
                 pose_loss_weight: float = 0.0,
                 distillation_loss_weight: float = 0.0,
                 residualflow_weight: float = 0.0,
                 is_unscaled_distill: bool = False,
                 is_uncertain_distill: bool = False,
                 overlapped_mask: bool = False, is_log_image: bool = True,
                 is_residual_flow: bool = False,
                 is_light_compensate: bool = False,
                 is_ssim_weight: bool = False,
                 learnable_photometric_uncertain: bool = False,
                 photometric_net_cfg: Optional[Dict] = None,
                 photometric_net_grad_weight: float = 0.05,
                 warp_impl: str = "band", warp_band: int = 4):
        super().__init__()
        if depth_decoder_cfg is None:
            raise ValueError("depth_decoder_cfg required")
        if learnable_photometric_uncertain:
            raise NotImplementedError("the photometric uncertainty net comes "
                                      "with a later slice")
        self.scales = tuple(scales)
        self.height, self.width = height, width
        self.frame_ids = tuple(frame_ids)
        self.min_depth, self.max_depth = min_depth, max_depth
        self.pose_loss_weight = pose_loss_weight
        self.distillation_loss_weight = distillation_loss_weight
        self.is_unscaled_distill = is_unscaled_distill
        self.is_uncertain_distill = is_uncertain_distill
        self.residualflow_weight = residualflow_weight
        self.overlapped_mask = overlapped_mask
        self.is_log_image = is_log_image
        self.warp_impl, self.warp_band = warp_impl, warp_band
        # switches of loss branches the port does not run yet: the loss
        # raises when one is on (the net options act only with the net)
        self.unported = dict(is_residual_flow=is_residual_flow,
                             is_light_compensate=is_light_compensate,
                             is_ssim_weight=is_ssim_weight)
        self.depth_decoder = build(**dict(depth_decoder_cfg))
        if pose_decoder_cfg is not None:
            self.pose_decoder = build(**dict(pose_decoder_cfg))

    def forward_depth(self, features, P2=None, train: bool = False) -> Dict:
        return self.depth_decoder(features, P2, train=train)

    def forward_pose(self, pose_features, base_pose=None):
        """(axisangle, translation) of the pose decoder; ``base_pose``, which
        the residual-pose branch passes, is unused, as in the JAX package
        and the reference."""
        del base_pose
        return self.pose_decoder(pose_features)

    def get_prediction(self, input_dict, output_dict) -> Dict:
        """Full-resolution depth for eval/export; ('depth', 0, 0) is
        upsampled from the finest scale if the decoder did not emit it."""
        if ("depth", 0, 0) in output_dict:
            depth = output_dict[("depth", 0, 0)]
        else:
            depth = interpolate_bilinear(
                output_dict[("depth", self.scales[0], self.scales[0])],
                self.height, self.width, align_corners=True)
        return dict(depth=depth)

    # ------------------------------------------------------------------ loss

    def _check_branch(self, input_dict, output_dict) -> None:
        on = [k for k, v in self.unported.items() if v]
        if self.warp_impl != "band":
            on.append(f"warp_impl={self.warp_impl!r}")
        if "depth_gt" in input_dict:
            on.append("input 'depth_gt'")
        if on:
            raise NotImplementedError("the port's loss does not run the "
                                      f"branches of {on} yet")
        if self.residualflow_weight != 0:
            raise AssertionError("residual-flow loss is dormant in the "
                                 "reference; not implemented")

    def _warp_all(self, input_dict, output_dict):
        """Warp the source frames into frame 0 for every (scale, frame) pair
        in one pass, depth-direct when every pose is a constant and there is
        no patched mask, else on the grid route. Returns (preds
        [S, F, B, H, W, C], overlap [S, F, B, H, W] bool or None,
        depths_full [S, B, H, W, 1])."""
        frames = self.frame_ids[1:]
        S, F = len(self.scales), len(frames)
        H, W = self.height, self.width
        depths_full = torch.stack([
            interpolate_bilinear(output_dict[("depth", s, s)], H, W,
                                 align_corners=True)
            for s in self.scales], dim=0)
        B = depths_full.shape[1]
        K = make_K44(input_dict["P2"])
        inv_K = invert_K(K)
        Ts = torch.stack([output_dict[("cam_T_cam", f)] for f in frames])
        sources = torch.stack([input_dict[("original_image", f)]
                               for f in frames])
        C = sources.shape[-1]
        ft = torch.promote_types(depths_full.dtype, torch.float32)
        # a bf16 step's images stay bf16 into the warps, which round their
        # outputs to it as the JAX package's do; depth, rows and grids are
        # float32 or wider
        it = torch.bfloat16 if sources.dtype == torch.bfloat16 else ft
        sources = sources.reshape(F * B, H, W, C).to(it).contiguous()
        pose_const = bool(output_dict.pop("pose_is_const", False))
        if pose_const and "patched_mask" not in input_dict:
            preds, overlap = warp_depth_fused(
                sources, depths_full.reshape(S * B, H, W).to(ft).contiguous(),
                make_affine_rows(K, inv_K, Ts, S).to(ft), S, F,
                self.warp_band)
            preds = preds.reshape(S, F, B, H, W, C)
            overlap = (overlap.reshape(S, F, B, H, W) if self.overlapped_mask
                       else None)
            return preds, overlap, depths_full

        # the grid route: warp n = (s F + f) B + b reads source f B + b,
        # i.e. n mod F B, which the band warp indexes without tiling
        N = S * F * B

        def per_warp(t):                              # [B, ...] -> [N, ...]
            return t[None, None].expand(S, F, *t.shape).reshape(
                N, *t.shape[1:])

        grids = reproject(
            depths_full[:, None].expand(S, F, B, H, W, 1).reshape(N, H, W, 1),
            per_warp(K), per_warp(inv_K),
            Ts[None].expand(S, F, B, 4, 4).reshape(N, 4, 4))
        grids = grids.to(ft).contiguous()
        preds = grid_sample(sources, grids, mode="bilinear",
                            padding_mode="border", impl=self.warp_impl,
                            band=self.warp_band).reshape(S, F, B, H, W, C)
        overlap = None
        if self.overlapped_mask:
            if "patched_mask" not in input_dict:
                # the nearest/zeros warp of all-ones is exactly the
                # in-bounds test of the grid
                xu = unnormalize(grids[..., 0], W)
                yu = unnormalize(grids[..., 1], H)
                overlap = ((xu >= -0.5) & (xu < W - 0.5) & (yu >= -0.5)
                           & (yu < H - 0.5))
            else:
                # the mask of warp n is mask n mod B, as the JAX package's
                # F-fold broadcast of it gives
                patched = input_dict["patched_mask"].to(preds.dtype)
                warped = grid_sample(patched[..., None].contiguous(), grids,
                                     mode="nearest", padding_mode="zeros",
                                     impl=self.warp_impl, band=self.warp_band)
                overlap = warped == 1.0
            overlap = overlap.reshape(S, F, B, H, W)
        return preds, overlap, depths_full

    def compute_total_reprojection_loss(self, output_dict, input_dict,
                                        noise: Optional[torch.Tensor] = None):
        """Min-reprojection + identity automask + smoothness over all scales.
        Returns (losses dict, hm dict, total loss); stores the full-resolution
        depths in ``output_dict[('depth', 0, s)]``."""
        scales = self.scales
        frames = self.frame_ids[1:]
        S, F = len(scales), len(frames)
        H, W = self.height, self.width

        preds, overlap, depths_full = self._warp_all(input_dict, output_dict)
        for si, s in enumerate(scales):
            output_dict[("depth", 0, s)] = depths_full[si]
            for fi, f in enumerate(frames):
                output_dict[("original_image", f, s)] = preds[si, fi]

        target = input_dict[("original_image", 0)]
        B, C = target.shape[0], target.shape[-1]
        # the photometric loss of every warp against target n mod B, and of
        # the stacked sources for the automask, with the target's pooled
        # stats taken once; on a CUDA device each is one kernel pass
        tgt = target.to(preds.dtype).contiguous()
        t_stats = ssim_target_stats(tgt)
        proj_loss = reprojection_loss_fused(
            preds.reshape(-1, H, W, C), tgt, *t_stats).reshape(S, F, B, H, W)
        if overlap is not None:
            # a large constant blocks gradients and loses the min
            proj_loss = torch.where(overlap, proj_loss,
                                    proj_loss.new_full((), 100.0))

        losses: Dict[str, torch.Tensor] = {}
        hm: Dict[str, Any] = {}
        if self.is_log_image:
            hm["original_image"] = target[0:1]
            for fi, f in enumerate(frames):
                hm[f"predicted_image_{f}"] = preds[0, fi, 0:1]

        if "motion_mask" in input_dict:
            # the precomputed motion mask gates the gradient: its pixels
            # keep their min-reprojection value but pass no gradient; no
            # identity candidates, so the tie-break noise is not read
            motion = input_dict["motion_mask"].to(proj_loss.dtype)[None]
            to_opt = torch.amin(proj_loss, dim=1)             # [S, B, H, W]
            to_opt = to_opt.detach() * motion + to_opt * (1.0 - motion)
        else:
            # identity automask, with the identity candidates pre-minned
            # over the frames (scale-independent)
            sources = torch.stack([input_dict[("original_image", f)]
                                   for f in frames]).to(tgt.dtype)
            identity = reprojection_loss_fused(
                sources.reshape(F * B, H, W, C), tgt, *t_stats
            ).reshape(F, B, H, W)
            if noise is not None:
                identity = identity + noise.to(identity) * 1e-5
            identity_min = torch.amin(identity, dim=0)
            combined = torch.cat([identity_min[None, None].expand(
                S, 1, B, H, W), proj_loss], dim=1)
            to_opt = torch.amin(combined, dim=1)              # [S, B, H, W]
            if self.is_log_image:
                hm["loss_mask_0"] = dict(data=(
                    torch.amin(proj_loss[0], dim=0) < identity_min
                )[0:1, ..., None])

        # sums in float32 or wider; the normaliser is the patched mask's sum
        # (the pixel count without one). Datasets give the mask as float64:
        # cast it first, or it would widen the whole loss chain
        acc = torch.promote_types(to_opt.dtype, torch.float32)
        patched = input_dict.get("patched_mask")
        if patched is None:
            photo_norm = torch.tensor(B * H * W, dtype=acc) + 1e-6
        else:
            patched = patched.to(to_opt.dtype)
            to_opt = to_opt * patched[None]
            photo_norm = patched.to(acc).sum() + 1e-6
        # dyadic color pyramid by successive 2x2 means, while the sizes
        # halve; other scales take the adaptive pool of the target (the
        # JAX package's reshape fails there)
        color_pyr = {0: target}
        cur = target
        for s in range(1, max(scales) + 1 if scales else 1):
            Bc, Hc, Wc, Cc = cur.shape
            if Hc % 2 or Wc % 2:
                break
            cur = cur.to(acc).reshape(Bc, Hc // 2, 2, Wc // 2, 2, Cc).mean(
                dim=(2, 4)).to(target.dtype)
            color_pyr[s] = cur
        total_loss = 0.0
        for si, s in enumerate(scales):
            loss_s = to_opt[si].to(acc).sum() / photo_norm.to(to_opt.device)
            disp = output_dict[("disp", s)]
            h, w = disp.shape[1], disp.shape[2]
            color = (color_pyr[s]
                     if s in color_pyr and color_pyr[s].shape[1:3] == (h, w)
                     else adaptive_avg_pool2d(target, h, w))
            mean_disp = disp.to(acc).mean(dim=(1, 2), keepdim=True)
            norm_disp = disp / (mean_disp + 1e-7).to(disp.dtype)
            smooth = get_smooth_loss(norm_disp, color) * 1e-5 / (2 ** s)
            losses[f"smooth_loss/{s}"] = smooth.detach()
            loss_s = loss_s + smooth
            total_loss = total_loss + loss_s
            losses[f"loss/{s}"] = loss_s.detach()
        return losses, hm, total_loss / S

    def compute_pose_loss(self, output_dict, input_dict) -> torch.Tensor:
        """L1 between the warp poses and the GT relative poses."""
        pose_loss = 0.0
        for f in self.frame_ids[1:]:
            pose_loss = pose_loss + abs_(
                input_dict[("relative_pose", f)]
                - output_dict[("cam_T_cam", f)]).mean()
        return pose_loss

    def compute_distill_loss(self, output_dict, input_dict,
                             scale: int) -> torch.Tensor:
        """Teacher-student depth loss at ``scale``: the mean of |teacher -
        student| (with ``is_unscaled_distill`` the teacher first scaled by
        the per-sample mean of student / (teacher + 1e-5)), with
        ``is_uncertain_distill`` weighted as error / z + log(z + 1e-5) by
        the student's ``('uncertain_z', scale)``. No gradient reaches the
        teacher's depth."""
        pred = output_dict[("depth", scale, scale)]
        teacher = output_dict[("teacher_depth", scale, scale)].detach()
        if self.is_unscaled_distill:
            ratio = (pred / (teacher + 1e-5)).mean(dim=(1, 2), keepdim=True)
            error = abs_(ratio * teacher - pred)
        else:
            error = abs_(teacher - pred)
        if self.is_uncertain_distill:
            z = output_dict[("uncertain_z", scale)]
            return (error / z + torch.log(z + 1e-5)).mean()
        return error.mean()

    def loss(self, output_dict, input_dict,
             noise: Optional[torch.Tensor] = None) -> Dict:
        """Total training loss: {'loss', 'loss_dict', 'hm'}. The loss dict
        keeps the JAX package's key ``distilation/{s}``."""
        self._check_branch(input_dict, output_dict)
        losses, hm, total_loss = self.compute_total_reprojection_loss(
            output_dict, input_dict, noise=noise)
        if self.pose_loss_weight > 0:
            pose_loss = self.compute_pose_loss(output_dict, input_dict)
            losses["pose_loss"] = pose_loss.detach()
            total_loss = total_loss + self.pose_loss_weight * pose_loss
        if self.distillation_loss_weight > 0:
            for s in self.scales:
                d = self.compute_distill_loss(output_dict, input_dict, s)
                losses[f"distilation/{s}"] = d.detach()
                total_loss = total_loss + d * self.distillation_loss_weight
        losses["total_loss"] = total_loss.detach()
        if not self.is_log_image:
            hm = {}
        return {"loss": total_loss, "loss_dict": losses, "hm": hm}

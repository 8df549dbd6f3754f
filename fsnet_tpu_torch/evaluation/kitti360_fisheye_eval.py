"""KITTI-360 fisheye depth evaluator, host code (counterpart of
``fsnet_tpu.evaluation.kitti360_fisheye_eval``).

The ground truth of a split: each frame's velodyne scan moved into camera
02's frame, Mei-projected into its fisheye image (the points ahead of the
camera that land inside it), scattered with the nearest point kept per
pixel, and the close-range mask (ground-truth norm under 8 m) beside it;
both are saved to the ``.npz`` and loaded from it (each package reads the
other's). ``single_call`` resizes the prediction to the ground truth's
size and scores the pixels within 0.3-60 m and the close-range mask
(median-scaled and absolute suites, each clamped to [1e-3, 80] m).

The projection runs the port's torch ``cam2image`` in float32, the dtype
the JAX package computes it in (``jnp.asarray`` of the float64 points under
JAX's default), and truncates the pixel coordinates to int32 from that
result. ``cv2.resize`` becomes ``resize_linear`` and the image size is
read from the PNG's header.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..data.augmentations import resize_linear
from ..data.datasets.fisheye_dataset import (extract_P_from_fisheye_calib,
                                             read_fisheye_extrinsics,
                                             read_fisheycalib)
from ..data.datasets.image_io import png_size
from ..data.datasets.io_utils import read_pc_from_bin
from ..data.datasets.kitti360_dataset import read_T_from_sequence
from ..ops.fisheye import cam2image
from ..ops.metrics import compute_errors
from .kitti_unsupervised_eval import KittiEigenEvaluator, _object_array


class Kitti360FisheyeEvaluator(KittiEigenEvaluator):
    """Fisheye evaluation against velodyne ground truth, close range
    only."""

    def __init__(self, data_path, split_file, gt_saved_file,
                 is_evaluate_absolute: bool = False):
        self.is_evaluate_absolute = is_evaluate_absolute
        if os.path.isfile(gt_saved_file):
            loaded = np.load(gt_saved_file, fix_imports=True,
                             encoding="latin1", allow_pickle=True)
            self.gt_depths = loaded["data"]
            self.close_masks = loaded["close_masks"]
        else:
            print(f"Exporting fisheye GT from {split_file} to {gt_saved_file}")
            self._precompute(data_path, split_file, gt_saved_file)

    def _load_calib(self, calib_dir):
        left_calib = read_fisheycalib(os.path.join(calib_dir, "image_02.yaml"))
        right_calib = read_fisheycalib(os.path.join(calib_dir, "image_03.yaml"))
        Ts = read_fisheye_extrinsics(
            os.path.join(calib_dir, "calib_cam_to_pose.txt"))
        T_cam2velo = read_T_from_sequence(
            os.path.join(calib_dir, "calib_cam_to_velo.txt"))
        self.cam_calib = dict(
            left_calib=left_calib, right_calib=right_calib,
            T_image2pose=Ts,
            P0=extract_P_from_fisheye_calib(left_calib),
            P1=extract_P_from_fisheye_calib(right_calib),
            T_cam2velo=T_cam2velo,
        )

    def single_call(self, depth_0, index):
        return self._single_loss(
            depth_0, np.asarray(self.gt_depths[index], dtype=np.float64),
            np.asarray(self.close_masks[index], dtype=bool))

    def _single_loss(self, depth_0, gt_depth, close_mask):
        gt_height, gt_width = gt_depth.shape[:2]
        pred_depth = resize_linear(depth_0, gt_width, gt_height)

        mask = np.logical_and(gt_depth > 0.3, gt_depth < 60.0)
        mask = np.logical_and(mask, close_mask)

        pred_depth = pred_depth[mask]
        gt = gt_depth[mask]
        if len(pred_depth) == 0 or len(gt) == 0:
            raise ValueError("empty fisheye eval mask")

        ratio = np.median(gt) / np.median(pred_depth)
        scaled = np.clip(pred_depth * ratio, 1e-3, 80.0)
        error = compute_errors(gt, scaled)

        pred_clamped = np.clip(pred_depth, 1e-3, 80.0)
        abs_error = compute_errors(gt, pred_clamped)
        return dict(ratio=ratio, error=error, abs_error=abs_error)

    def _projection(self, velo_pts_im, norm, im_shape):
        """Scatter of (u, v, depth) points and their norms, the nearest
        point kept where several fall on one pixel."""
        us = velo_pts_im[:, 0].astype(np.int32)
        vs = velo_pts_im[:, 1].astype(np.int32)
        order = np.argsort(-velo_pts_im[:, 2])
        depth = np.zeros(tuple(im_shape[:2]))
        gt_norm = np.zeros(tuple(im_shape[:2]))
        depth[vs[order], us[order]] = velo_pts_im[order, 2]
        gt_norm[vs[order], us[order]] = norm[order]
        depth[depth < 0] = 0
        gt_norm[gt_norm < 0] = 0
        return depth, gt_norm

    def _precompute(self, data_path, split_file, gt_saved_file):
        img_dir = os.path.join(data_path, "data_2d_raw")
        calib_dir = os.path.join(data_path, "calibration")
        pc_dir = os.path.join(data_path, "data_3d_raw")
        self._load_calib(calib_dir)

        with open(split_file, "r") as f:
            lines = f.readlines()

        T_cam002pose = self.cam_calib["T_image2pose"]["T_image0"]
        T_cam022pose = self.cam_calib["T_image2pose"]["T_image2"]
        T_velo2cam02 = (np.linalg.inv(T_cam022pose) @ T_cam002pose
                        @ np.linalg.inv(self.cam_calib["T_cam2velo"]))

        calib = self.cam_calib["left_calib"]
        xi = calib["mirror_parameters"]["xi"]
        k1 = calib["distortion_parameters"]["k1"]
        k2 = calib["distortion_parameters"]["k2"]
        P0 = torch.from_numpy(self.cam_calib["P0"]).float()

        gt_depths, masks = [], []
        for line in lines:
            seq, _, img_index, _, _ = line.strip().split(",")
            frame_id = int(img_index)
            velo = read_pc_from_bin(os.path.join(
                pc_dir, seq, "velodyne_points/data",
                "{:010d}.bin".format(frame_id)))
            cam = (T_velo2cam02 @ np.concatenate(
                [velo[:, 0:3], np.ones([velo.shape[0], 1])], axis=1).T
            ).T[:, 0:3]
            cam = cam[cam[:, 2] > 0]

            image_shape = np.array(png_size(os.path.join(
                img_dir, seq, "image_02", "data_rgb",
                "{:010d}.png".format(frame_id))), dtype=np.int32)

            pts = cam2image(torch.from_numpy(cam).float(), P0, xi, k1,
                            k2).numpy()
            in_bounds = ((pts[:, 0] >= 0) & (pts[:, 0] < image_shape[1])
                         & (pts[:, 1] >= 0) & (pts[:, 1] < image_shape[0]))
            pts = pts[in_bounds]
            cam_ib = cam[in_bounds]
            pts[:, 2] = cam_ib[:, 2]
            norm = np.linalg.norm(cam_ib[:, 0:3], axis=1)

            gt_depth, gt_norm = self._projection(pts, norm, image_shape)
            masks.append(((gt_norm > 0) & (gt_norm < 8)).astype(bool))
            gt_depths.append(gt_depth.astype(np.float32))

        np.savez_compressed(gt_saved_file, data=_object_array(gt_depths),
                            close_masks=_object_array(masks))
        self.gt_depths = gt_depths
        self.close_masks = masks

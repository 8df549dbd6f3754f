"""FusionPortable depth evaluator, host code (counterpart of
``fsnet_tpu.evaluation.fusionportable_eval``): the ground truth of a split
projected from each frame's Ouster ``.pcd`` scan into camera 00 through
``P @ R_rect @ inv(T_cam00_to_ouster)`` at the camera's calibrated size,
with depth the forward distance x (the port's ``project_depth_map``);
scored as :class:`~fsnet_tpu_torch.evaluation.kitti_unsupervised_eval.
KittiEigenEvaluator` scores (the Eigen crop, both suites).
"""
from __future__ import annotations

import os

import numpy as np

from ..data.datasets.fusionportable_dataset import (read_camera_calib,
                                                    read_ouster_calib,
                                                    read_pcd_file)
from .kitti_unsupervised_eval import KittiEigenEvaluator, _object_array
from .lidar_projection import project_depth_map


class FusionPortableEvaluator(KittiEigenEvaluator):
    """Evaluation against Ouster ground truth."""

    def _load_calib(self, calib_dir):
        self.ouster_calib = read_ouster_calib(
            os.path.join(calib_dir, "ouster00.yaml"))
        self.cam00_calib = read_camera_calib(
            os.path.join(calib_dir, "frame_cam00.yaml"))

    def _precompute(self, data_path, split_file, gt_saved_file):
        calib_dir = os.path.join(data_path, "calib")
        pc_dir = os.path.join(data_path, "ouster00", "point", "data")
        self._load_calib(calib_dir)

        with open(split_file, "r") as f:
            lines = f.readlines()

        R_rect = np.eye(4)
        R_rect[0:3, 0:3] = self.cam00_calib["R"]
        P_ouster2img = (np.asarray(self.cam00_calib["P"]) @ R_rect
                        @ np.linalg.inv(self.ouster_calib["T_cam002ouster"]))

        gt_depths = []
        for line in lines:
            index = int(line.strip())
            lidar = read_pcd_file(
                os.path.join(pc_dir, "{:06d}.pcd".format(index)))
            if lidar.shape[1] == 3:
                lidar = np.concatenate(
                    [lidar, np.ones((lidar.shape[0], 1))], axis=1)
            image_shape = np.array([self.cam00_calib["height"],
                                    self.cam00_calib["width"]])
            gt_depths.append(project_depth_map(
                lidar, P_ouster2img, image_shape).astype(np.float32))

        np.savez_compressed(gt_saved_file, data=_object_array(gt_depths))
        self.gt_depths = gt_depths

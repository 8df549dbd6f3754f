"""KITTI and KITTI-360 unsupervised depth evaluators, host code (counterpart
of ``fsnet_tpu.evaluation.kitti_unsupervised_eval``).

* :class:`KittiEigenEvaluator`: the ground truth of a split projected from
  its velodyne scans and saved as an object-array ``.npz`` on the first
  call where the file is missing (loaded where it exists: each package
  reads the other's); per frame, ``single_call`` resizes the prediction to
  the ground truth's size, applies the Eigen crop and the [1e-3, 80] m
  clamp and returns the median-scaled and the absolute error suites;
  ``log`` prints the table; ``__call__`` evaluates a directory of saved
  depth PNGs.
* :class:`Kitti360Evaluator`: the ground truth projected through
  ``P0 @ R0 @ inv(T_cam2velo)`` at the size of each frame's image.

``cv2.resize`` becomes the port's ``resize_linear`` (the same bilinear
taps in float32 arithmetic, within float32 rounding of OpenCV's) and the
image size is read from the PNG's header.
"""
from __future__ import annotations

import os

import numpy as np

from ..data.augmentations import resize_linear
from ..data.datasets.image_io import png_size
from ..data.datasets.io_utils import read_depth, read_pc_from_bin
from ..data.datasets.kitti360_dataset import (read_extrinsic_from_sequence,
                                              read_P01_from_sequence,
                                              read_T_from_sequence)
from ..ops.metrics import compute_errors
from .lidar_projection import generate_depth_map, project_depth_map


def _object_array(arrays):
    """The per-frame maps in a 1-d object array (``np.array(..., dtype=
    object)`` would make an array of scalars where the shapes agree)."""
    out = np.empty(len(arrays), dtype=object)
    for i, a in enumerate(arrays):
        out[i] = np.asarray(a)
    return out


class KittiEigenEvaluator:
    """Eigen-split evaluation against velodyne ground truth."""

    def __init__(self, data_path: str, split_file: str, gt_saved_file: str,
                 is_evaluate_absolute: bool = False):
        self.is_evaluate_absolute = is_evaluate_absolute
        if os.path.isfile(gt_saved_file):
            self.gt_depths = np.load(gt_saved_file, fix_imports=True,
                                     encoding="latin1",
                                     allow_pickle=True)["data"]
        else:
            print(f"Exporting GT depths from {split_file} to {gt_saved_file}")
            self._precompute(data_path, split_file, gt_saved_file)

    def _precompute(self, data_path, split_file, gt_saved_file):
        with open(split_file, "r") as f:
            lines = f.readlines()
        gt_depths = []
        for line in lines:
            folder, frame_id, _ = line.split()
            frame_id = int(frame_id)
            calib_dir = os.path.join(data_path, folder.split("/")[0])
            velo_filename = os.path.join(
                data_path, folder, "velodyne_points/data",
                "{:010d}.bin".format(frame_id))
            gt_depths.append(
                generate_depth_map(calib_dir, velo_filename, 2, True)
                .astype(np.float32))
        np.savez_compressed(gt_saved_file, data=_object_array(gt_depths))
        self.gt_depths = gt_depths

    def _single_loss(self, depth_0: np.ndarray, gt_depth: np.ndarray):
        """The Eigen crop, the clamp, and the median-scaled and absolute
        error suites of one float32 prediction."""
        gt_height, gt_width = gt_depth.shape[:2]
        pred_depth = resize_linear(depth_0, gt_width, gt_height)
        mask = np.logical_and(gt_depth > 1e-3, gt_depth < 80.0)

        crop = np.array([0.40810811 * gt_height, 0.99189189 * gt_height,
                         0.03594771 * gt_width, 0.96405229 * gt_width]
                        ).astype(np.int32)
        crop_mask = np.zeros(mask.shape)
        crop_mask[crop[0]:crop[1], crop[2]:crop[3]] = 1
        mask = np.logical_and(mask, crop_mask)

        pred_depth = pred_depth[mask]
        gt_depth = gt_depth[mask]
        if len(pred_depth) == 0 or len(gt_depth) == 0:
            raise ValueError("empty mask in evaluation")

        ratio = np.median(gt_depth) / np.median(pred_depth)
        scaled = np.clip(pred_depth * ratio, 1e-3, 80.0)
        error = compute_errors(gt_depth, scaled)

        pred_clamped = np.clip(pred_depth, 1e-3, 80.0)
        abs_error = compute_errors(gt_depth, pred_clamped)
        return dict(ratio=ratio, error=error, abs_error=abs_error)

    def single_call(self, depth_0: np.ndarray, index: int):
        return self._single_loss(depth_0,
                                 np.asarray(self.gt_depths[index],
                                            dtype=np.float64))

    def log(self, writer, mean_errors, mean_abs_errors, global_step=0,
            epoch_num=0, is_print=True):
        log_str = f"Epoch {epoch_num}"
        log_str += "\n  " + ("{:>8} | " * 7).format(
            "abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
        log_str += ("\n" + ("&{: 8.3f}  " * 7).format(*list(mean_errors))
                    + "\\\\")
        log_str += f"\nEpoch {epoch_num}| Abs Error without Scaled"
        log_str += "\n  " + ("{:>8} | " * 7).format(
            "abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
        log_str += ("\n" + ("&{: 8.3f}  " * 7).format(*list(mean_abs_errors))
                    + "\\\\")

        if writer is not None:
            writer.add_text("evaluation logs",
                            log_str.replace(" ", "&nbsp;").replace(
                                "\n", "  \n"),
                            global_step=epoch_num)
        if is_print:
            print(log_str)
        return log_str

    def __call__(self, result_path: str, writer=None, global_step=0,
                 epoch_num=0):
        """Offline evaluation over a directory of saved depth PNGs (uint16,
        metres * 256), one per ground-truth frame in sorted order."""
        filelist = sorted(os.listdir(result_path))
        if len(filelist) != len(self.gt_depths):
            print(f"pred count {len(filelist)} != gt count "
                  f"{len(self.gt_depths)}; drop evaluation")
            return

        errors, abs_errors, ratios = [], [], []
        for i, image_file in enumerate(filelist):
            pred = read_depth(os.path.join(result_path, image_file))
            result = self._single_loss(pred, self.gt_depths[i])
            errors.append(result["error"])
            abs_errors.append(result["abs_error"])
            ratios.append(result["ratio"])

        mean_errors = np.array(errors).mean(0)
        mean_abs_errors = np.array(abs_errors).mean(0)
        scales = np.array(ratios)
        print(f"Scaled ratio {scales.mean():.4f} +- {scales.std():.4f}")
        self.log(writer, mean_errors, mean_abs_errors, global_step, epoch_num)


class Kitti360Evaluator(KittiEigenEvaluator):
    """Ground truth from the velodyne scans projected through
    ``P0 @ R0 @ inv(T_cam2velo)``."""

    def _load_calib(self, calib_dir):
        T_cam2velo = read_T_from_sequence(
            os.path.join(calib_dir, "calib_cam_to_velo.txt"))
        P0, P1, R0, R1 = read_P01_from_sequence(
            os.path.join(calib_dir, "perspective.txt"))
        read_extrinsic_from_sequence(
            os.path.join(calib_dir, "calib_cam_to_pose.txt"))
        self.cam_calib = dict(P0=P0, R0=R0, T_cam2velo=T_cam2velo)

    def _precompute(self, data_path, split_file, gt_saved_file):
        img_dir = os.path.join(data_path, "data_2d_raw")
        calib_dir = os.path.join(data_path, "calibration")
        pc_dir = os.path.join(data_path, "data_3d_raw")
        self._load_calib(calib_dir)

        with open(split_file, "r") as f:
            lines = f.readlines()

        P_velo2img = (self.cam_calib["P0"] @ self.cam_calib["R0"]
                      @ np.linalg.inv(self.cam_calib["T_cam2velo"]))
        gt_depths = []
        for line in lines:
            seq, _, img_index, _, _ = line.strip().split(",")
            frame_id = int(img_index)
            velo = read_pc_from_bin(os.path.join(
                pc_dir, seq, "velodyne_points/data",
                "{:010d}.bin".format(frame_id)))
            image_shape = np.array(png_size(os.path.join(
                img_dir, seq, "image_00", "data_rect",
                "{:010d}.png".format(frame_id))), dtype=np.int32)
            gt_depths.append(
                project_depth_map(velo, P_velo2img, image_shape)
                .astype(np.float32))
        np.savez_compressed(gt_saved_file, data=_object_array(gt_depths))
        self.gt_depths = gt_depths

"""The nuScenes surround-view depth evaluator, host code (counterpart of
``fsnet_tpu.evaluation.nuscenes_unsupervised_eval``).

* :func:`pad_or_trim_to_np` and :func:`generate_depth_map`: a LiDAR cloud
  in the ego frame projected to a camera's depth map (the nearest point
  wins each pixel);
* :class:`NuscenesEvaluator`: per frame, ``single_call`` reads the 16-bit
  ground-truth PNG that ``filename`` maps to (``samples`` ->
  ``gt_saved_dir``, ``.jpg`` -> ``.png``), resizes the prediction to its
  size, applies the nuScenes crop and the [1e-3, 80] m clamp and returns
  the median-scaled and the absolute error suites; ``log`` prints one
  channel's table; ``__call__`` evaluates a directory of saved depth PNGs
  per camera.

``cv2.resize`` becomes the port's ``resize_linear`` (the same bilinear
taps in float32 arithmetic, within float32 rounding of OpenCV's). The
ground truth's precompute from the LiDAR sweeps needs the nuscenes-devkit
and ``pyquaternion``; where they are missing it raises the JAX package's
``ImportError``, and where they are present it raises too: it is not
ported. Evaluate against ground-truth PNGs made elsewhere.
"""
from __future__ import annotations

import os
import warnings

import numpy as np

from ..data.augmentations import resize_linear
from ..data.datasets.io_utils import read_depth
from ..ops.metrics import compute_errors
from .kitti_unsupervised_eval import KittiEigenEvaluator

DEFAULT_CAMERAS = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT",
                   "CAM_BACK", "CAM_BACK_LEFT", "CAM_FRONT_LEFT")
_HEADER = ("{:>8} | " * 7).format("abs_rel", "sq_rel", "rmse", "rmse_log",
                                   "a1", "a2", "a3")


def pad_or_trim_to_np(x, shape, pad_val=0):
    """``x`` zero-padded (``pad_val``) or cut to ``shape`` [rows, cols]."""
    shape = np.asarray(shape)
    pad = shape - np.minimum(np.shape(x), shape)
    zeros = np.zeros_like(pad)
    x = np.pad(x, np.stack([zeros, pad], axis=1), constant_values=pad_val)
    return x[: shape[0], : shape[1]]


def generate_depth_map(velo, extrinsics, intrinsics, cam=2,
                       im_shape=(900, 1600)):
    """[N, >= 3] LiDAR points (ego frame) -> an ``im_shape`` depth map
    through ``intrinsics @ inv(extrinsics)`` (camera -> ego); each pixel
    keeps its nearest point; pixel (u, v) is round(projection) - 1."""
    N = velo.shape[0]
    homo_velo = np.ones([N, 4])
    homo_velo[:, 0:3] = velo[:, 0:3]
    homo_intrinsics = np.eye(4)
    homo_intrinsics[0:3, 0:3] = intrinsics
    projection = homo_intrinsics @ np.linalg.inv(extrinsics)

    pts = (projection @ homo_velo.T).T
    pts = pts[pts[:, 2] > 0]
    pts[:, :2] = pts[:, :2] / pts[:, 2][..., np.newaxis]

    us = np.round(pts[:, 0]) - 1
    vs = np.round(pts[:, 1]) - 1
    valid = (us >= 0) & (vs >= 0) & (us < im_shape[1]) & (vs < im_shape[0])
    us = us[valid].astype(np.int32)
    vs = vs[valid].astype(np.int32)
    ds = pts[valid, 2]

    depth = np.zeros(tuple(im_shape[:2]))
    order = np.argsort(-ds)            # far first, so the nearest is kept
    depth[vs[order], us[order]] = ds[order]
    depth[depth < 0] = 0
    return depth


class NuscenesEvaluator(KittiEigenEvaluator):
    """Per-camera evaluation against ground-truth depth PNGs under
    ``gt_saved_dir`` (``<gt_saved_dir>/<CAM>/<name>.png``, metres * 256).
    ``split_file``'s lines start with the sample tokens whose ground truth
    the precompute would write."""

    def __init__(self, data_path, split_file, gt_saved_dir,
                 nuscenes_version="v1.0-trainval",
                 is_evaluate_absolute=False, is_force_recompute=False,
                 channels=DEFAULT_CAMERAS):
        self.is_evaluate_absolute = is_evaluate_absolute
        self.split_file = split_file
        with open(split_file, "r") as f:
            self.token_list = [line.strip().split(",")[0]
                               for line in f.readlines()]
        if (not os.path.isdir(gt_saved_dir)) or is_force_recompute:
            print(f"Exporting NuScenes GT depths to {gt_saved_dir}")
            self._precompute(data_path, gt_saved_dir, nuscenes_version)
        self.channels = list(channels)
        self.gt_saved_dir = gt_saved_dir

    def _precompute(self, data_path, gt_saved_dir, nuscenes_version):
        from pyquaternion import Quaternion  # noqa: F401

        from ..data.datasets.nuscenes_utils import NuScenes

        NuScenes(version=nuscenes_version, dataroot=data_path, verbose=True)
        raise NotImplementedError(
            "the nuScenes ground truth's precompute from the LiDAR sweeps "
            "is not ported; write the depth PNGs under gt_saved_dir first")

    def log(self, writer, channel, mean_errors, mean_abs_errors,
            global_step=0, epoch_num=0, is_print=True):
        log_str = f"Epoch {epoch_num} for channel {channel}"
        log_str += "\n  " + _HEADER
        log_str += ("\n" + ("&{: 8.3f}  " * 7).format(*list(mean_errors))
                    + "\\\\")
        log_str += (f"\nEpoch {epoch_num} for channel {channel} "
                    "| Abs Error without Scaled")
        log_str += "\n  " + _HEADER
        log_str += ("\n" + ("&{: 8.3f}  " * 7).format(*list(mean_abs_errors))
                    + "\\\\")
        if writer is not None:
            writer.add_text(f"Evaluation logs/{channel}",
                            log_str.replace(" ", "&nbsp;").replace(
                                "\n", "  \n"),
                            global_step=epoch_num)
        if is_print:
            print(log_str)
        return log_str

    def _single_loss(self, depth_0, gt_depth):
        """The nuScenes crop (rows 0.0359-0.9919 H, columns 0.0359-0.9641
        W), the clamp, and the two error suites of one float32
        prediction."""
        gt_height, gt_width = gt_depth.shape[:2]
        pred_depth = resize_linear(depth_0, gt_width, gt_height)
        mask = np.logical_and(gt_depth > 1e-3, gt_depth < 80.0)

        crop = np.array([0.03594771 * gt_height, 0.99189189 * gt_height,
                         0.03594771 * gt_width, 0.96405229 * gt_width]
                        ).astype(np.int32)
        crop_mask = np.zeros(mask.shape)
        crop_mask[crop[0]:crop[1], crop[2]:crop[3]] = 1
        mask = np.logical_and(mask, crop_mask)

        pred_depth = pred_depth[mask]
        gt = gt_depth[mask]
        if len(pred_depth) == 0 or len(gt) == 0:
            raise ValueError("empty nuscenes eval mask")

        ratio = np.median(gt) / np.median(pred_depth)
        scaled = np.clip(pred_depth * ratio, 1e-3, 80.0)
        error = compute_errors(gt, scaled)
        pred_clamped = np.clip(pred_depth, 1e-3, 80.0)
        abs_error = compute_errors(gt, pred_clamped)
        return dict(ratio=ratio, error=error, abs_error=abs_error)

    def single_call(self, depth_0, filename):
        gt_depth = read_depth(filename.replace(
            "samples", self.gt_saved_dir).replace(".jpg", ".png"))
        return self._single_loss(depth_0, gt_depth)

    def __call__(self, result_path, writer=None, global_step=0, epoch_num=0):
        """Offline evaluation of ``<result_path>/predict_depth/<CAM>/`` PNGs
        against the ground truth of the same names, camera by camera, then
        the mean over the cameras."""
        all_mean, all_mean_abs = [], []
        for cam in self.channels:
            errors, abs_errors = [], []
            predict_dir = os.path.join(result_path, "predict_depth", cam)
            gt_dir = os.path.join(self.gt_saved_dir, cam)
            for image_file in sorted(os.listdir(predict_dir)):
                gt_depth = read_depth(os.path.join(gt_dir, image_file))
                pred = read_depth(os.path.join(predict_dir, image_file))
                try:
                    result = self._single_loss(pred, gt_depth)
                except ValueError:
                    warnings.warn(f"{image_file} from {cam}: no usable "
                                  "points")
                    continue
                errors.append(result["error"])
                abs_errors.append(result["abs_error"])

            mean_errors = np.array(errors).mean(0)
            mean_abs = np.array(abs_errors).mean(0)
            self.log(writer, cam, mean_errors, mean_abs,
                     global_step=global_step, epoch_num=epoch_num)
            all_mean.append(mean_errors)
            all_mean_abs.append(mean_abs)

        self.log(writer, "all mean", np.array(all_mean).mean(0),
                 np.array(all_mean_abs).mean(0), global_step=global_step,
                 epoch_num=epoch_num)

"""LiDAR -> image-plane sparse depth maps, host code in numpy (counterpart
of ``fsnet_tpu.evaluation.lidar_projection``): ``read_calib_file``,
``load_velodyne_points``, ``generate_depth_map`` (KITTI raw: velodyne to
the rectified camera plane, the nearest point winning where several land
on one pixel) and ``project_depth_map`` (a given ``P_velo2im``, used by
KITTI-360).

Where points share a pixel, they are sorted by depth, descending, and
scattered in that order, so that the nearest is written last and wins; the
maps are the JAX package's bit for bit.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np


def read_calib_file(path: str) -> Dict:
    """KITTI calibration text -> dict of float arrays (strings where a
    value does not parse)."""
    float_chars = set("0123456789.e+- ")
    data: Dict = {}
    with open(path, "r") as f:
        for line in f.readlines():
            key, value = line.split(":", 1)
            value = value.strip()
            data[key] = value
            if float_chars.issuperset(value):
                try:
                    data[key] = np.array(list(map(float, value.split(" "))))
                except ValueError:
                    pass
    return data


def load_velodyne_points(filename: str) -> np.ndarray:
    """KITTI .bin -> [N, 4] homogeneous points."""
    points = np.fromfile(filename, dtype=np.float32).reshape(-1, 4)
    points[:, 3] = 1.0
    return points


def _scatter_min_depth(us: np.ndarray, vs: np.ndarray, ds: np.ndarray,
                       shape) -> np.ndarray:
    """Scatters depths to pixels, the minimum winning at each pixel."""
    depth = np.zeros(shape, dtype=np.float64)
    order = np.argsort(-ds)  # descending: nearer points written last win
    depth[vs[order], us[order]] = ds[order]
    depth[depth < 0] = 0
    return depth


def generate_depth_map(calib_dir: str, velo_filename: str, cam: int = 2,
                       vel_depth: bool = False) -> np.ndarray:
    """KITTI raw velodyne scan -> sparse depth map of camera ``cam``."""
    cam2cam = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    velo2cam_raw = read_calib_file(os.path.join(calib_dir,
                                                "calib_velo_to_cam.txt"))
    velo2cam = np.hstack((velo2cam_raw["R"].reshape(3, 3),
                          velo2cam_raw["T"][..., np.newaxis]))
    velo2cam = np.vstack((velo2cam, np.array([0, 0, 0, 1.0])))

    im_shape = cam2cam["S_rect_02"][::-1].astype(np.int32)

    R_cam2rect = np.eye(4)
    R_cam2rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P_rect = cam2cam["P_rect_0" + str(cam)].reshape(3, 4)
    P_velo2im = P_rect @ R_cam2rect @ velo2cam

    velo = load_velodyne_points(velo_filename)
    velo = velo[velo[:, 0] >= 0, :]

    velo_pts_im = (P_velo2im @ velo.T).T
    velo_pts_im[:, :2] = velo_pts_im[:, :2] / velo_pts_im[:, 2][..., np.newaxis]
    if vel_depth:
        velo_pts_im[:, 2] = velo[:, 0]

    # minus 1 matches the KITTI matlab devkit exactly
    us = np.round(velo_pts_im[:, 0]) - 1
    vs = np.round(velo_pts_im[:, 1]) - 1
    valid = (us >= 0) & (vs >= 0) & (us < im_shape[1]) & (vs < im_shape[0])
    us = us[valid].astype(np.int32)
    vs = vs[valid].astype(np.int32)
    ds = velo_pts_im[valid, 2]

    return _scatter_min_depth(us, vs, ds, tuple(im_shape[:2]))


def project_depth_map(velo: np.ndarray, P_velo2im: np.ndarray,
                      im_shape: np.ndarray) -> np.ndarray:
    """Projection through ``P_velo2im`` with depth = forward distance x."""
    velo_input = velo[velo[:, 0] >= 0, :].copy()
    velo_input[:, 3] = 1.0

    velo_pts_im = (P_velo2im @ velo_input.T).T
    velo_pts_im[:, :2] = velo_pts_im[:, :2] / velo_pts_im[:, 2][..., np.newaxis]
    velo_pts_im[:, 2] = velo_input[:, 0]

    us = np.round(velo_pts_im[:, 0]) - 1
    vs = np.round(velo_pts_im[:, 1]) - 1
    valid = (us >= 0) & (vs >= 0) & (us < im_shape[1]) & (vs < im_shape[0])
    us = us[valid].astype(np.int32)
    vs = vs[valid].astype(np.int32)
    ds = velo_pts_im[valid, 2]

    return _scatter_min_depth(us, vs, ds, tuple(np.asarray(im_shape[:2])))

"""Dataset file-format readers, host code (counterpart of
``fsnet_tpu.data.datasets.io_utils``): the velodyne, image, depth,
VO-depth and ``pose.mat`` readers, the relative-pose algebra, the KITTI raw
calibration parsers and the split-file reader.

The images are read by the port's own PNG reader
(:mod:`fsnet_tpu_torch.data.datasets.image_io`) where the JAX package calls
``PIL.Image.open`` and ``cv2.imread``; it returns what those calls return,
bit for bit.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import scipy.io as sio
from scipy.spatial.transform import Rotation

from .image_io import imread_unchanged, read_image  # noqa: F401


def read_pc_from_bin(bin_path: str) -> np.ndarray:
    """KITTI velodyne .bin -> [N, 4] (x, y, z, reflectance)."""
    return np.fromfile(bin_path, dtype=np.float32).reshape(-1, 4)


def read_depth(path: str) -> np.ndarray:
    """uint16 PNG / 256 -> metres: float64 arithmetic, float32 result."""
    return np.array(imread_unchanged(path) / 256.0, dtype=np.float32)


def read_vo_depth(image_path: str) -> np.ndarray:
    """VO sparse depth: uint16 / 65535 * 120 m, invalid (< 3 m or > 80 m)
    -> 120."""
    depth = imread_unchanged(image_path) / 65535.0 * 120.0
    depth[depth < 3] = 120.0
    depth[depth > 80] = 120.0
    return depth.astype(np.float32)


def read_pose_mat(path: str) -> np.ndarray:
    """The Matlab devkit's pose file -> [N, 4, 4]."""
    return sio.loadmat(path)["pose_mat"]


def cam_relative_pose(T_imu2world_0, T_imu2world_1, T_imu2vel, T_vel2cam):
    """cam0_T_cam1 through the imu -> velo -> cam chain."""
    return (T_vel2cam @ T_imu2vel @ np.linalg.inv(T_imu2world_1)
            @ T_imu2world_0 @ np.linalg.inv(T_imu2vel)
            @ np.linalg.inv(T_vel2cam))


def cam_relative_pose_nusc(T_imu2world_0, T_imu2world_1, T_imu2cam):
    """The ego-chain variant (nuScenes, KITTI-360)."""
    return (T_imu2cam @ np.linalg.inv(T_imu2world_1) @ T_imu2world_0
            @ np.linalg.inv(T_imu2cam))


def get_transformation_matrix(translation, rotation) -> np.ndarray:
    """translation [x, y, z] + quaternion [w, x, y, z] -> 4x4."""
    rot = Rotation.from_quat([rotation[1], rotation[2], rotation[3],
                              rotation[0]])
    T = np.eye(4)
    T[0:3, 0:3] = rot.as_matrix()
    T[0:3, 3] = translation
    return T


# ------------------------------------------------ KITTI raw calib/split files

def read_P23_from_sequence(file: str):
    """P_rect_02 and P_rect_03 of calib_cam_to_cam.txt."""
    P2 = P3 = None
    with open(file, "r") as f:
        for line in f.readlines():
            if line.startswith("P_rect_02"):
                P2 = np.array([float(x) for x in line.split(" ")[1:13]]
                              ).reshape(3, 4)
            if line.startswith("P_rect_03"):
                P3 = np.array([float(x) for x in line.split(" ")[1:13]]
                              ).reshape(3, 4)
    if P2 is None or P3 is None:
        raise ValueError(f"can not find P2 and P3 in file {file}")
    return P2, P3


def read_imu2velo(file: str) -> np.ndarray:
    """calib_imu_to_velo.txt -> 4x4."""
    T = np.eye(4)
    R = t = None
    with open(file, "r") as f:
        for line in f.readlines():
            if line.startswith("R"):
                R = np.array([float(x) for x in line.split(" ")[1:10]]
                             ).reshape(3, 3)
            if line.startswith("T"):
                t = np.array([float(x) for x in line.split(" ")[1:4]]
                             ).reshape(3, 1)
    if R is None or t is None:
        raise ValueError(f"can not find R and T in file {file}")
    T[0:3, 0:3] = R
    T[0:3, 3:4] = t
    return T


def read_T_from_sequence(file: str) -> np.ndarray:
    """calib_velo_to_cam.txt -> 4x4."""
    R = T = None
    with open(file, "r") as f:
        for line in f.readlines():
            if line.startswith("R:"):
                R = np.array([float(x) for x in line.split(" ")[1:10]]
                             ).reshape(3, 3)
            if line.startswith("T:"):
                T = np.array([float(x) for x in line.split(" ")[1:4]]
                             ).reshape(3, 1)
    if R is None or T is None:
        raise ValueError(f"can not find R: and T: in file {file}")
    T_velo2cam = np.eye(4)
    T_velo2cam[0:3, 0:3] = R
    T_velo2cam[0:3, 3:4] = T
    return T_velo2cam


def read_split_file(file: str) -> List[Dict]:
    """Eigen-style split lines 'folder index side'."""
    imdb = []
    with open(file, "r") as f:
        for raw in f.readlines():
            line = raw.strip().split()
            if not line:
                continue
            folder, index, side = line[0], int(line[1]), line[2]
            imdb.append(dict(folder=folder, index=index, side=side,
                             datetime=folder.split("/")[0]))
    return imdb

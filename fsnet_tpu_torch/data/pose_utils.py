"""SE(3) pose helpers for the host data pipeline (counterpart of
``fsnet_tpu.data.pose_utils``): the mirror flip of a relative pose by euler
negation, relative-pose algebra and quaternion conversion."""
from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as R


def flip_relative_pose(pose: np.ndarray, axis_num: int = 0) -> np.ndarray:
    """Pose of the mirrored world: negate euler angles off the mirror axis and
    the translation along it."""
    rotation = R.from_matrix(pose[0:3, 0:3])
    xyz = rotation.as_euler("xyz")
    for i in range(3):
        if i != axis_num:
            xyz[i] = -xyz[i]
    t = pose[0:3, 3:4].copy()
    t[axis_num, :] *= -1

    new_pose = np.eye(4, dtype=np.float32)
    new_pose[0:3, 0:3] = R.from_euler("xyz", xyz).as_matrix()
    new_pose[0:3, 3:4] = t
    return new_pose


def cam_relative_pose(T_w_a: np.ndarray, T_w_b: np.ndarray) -> np.ndarray:
    """a_T_b from world poses."""
    return np.linalg.inv(T_w_a) @ T_w_b


def cam_relative_pose_nusc(T_w_a: np.ndarray, T_w_b: np.ndarray,
                           T_c_e: np.ndarray) -> np.ndarray:
    """NuScenes variant composing the camera-from-ego extrinsic."""
    return T_c_e @ np.linalg.inv(T_w_a) @ T_w_b @ np.linalg.inv(T_c_e)


def pose_from_quat_trans(quat_wxyz: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """(w, x, y, z) quaternion + translation -> 4x4."""
    T = np.eye(4, dtype=np.float32)
    w, x, y, z = quat_wxyz
    T[0:3, 0:3] = R.from_quat([x, y, z, w]).as_matrix()
    T[0:3, 3] = trans
    return T

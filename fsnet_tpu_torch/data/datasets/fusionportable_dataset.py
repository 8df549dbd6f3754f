"""FusionPortable dataset: stereo frame cameras, an Ouster LiDAR and TUM
odometry (counterpart of ``fsnet_tpu.data.datasets.fusionportable_dataset``).

* :func:`read_opencv_yaml`: OpenCV's yaml (a ``%YAML:1.0`` header,
  ``!!opencv-matrix`` nodes as numpy arrays of ``rows`` x ``cols``). The
  matrix constructor is registered on a loader class of this module only,
  not on PyYAML's global loaders, so it leaves other readers alone.
* :func:`read_pcd_file`: the x, y, z of a PCD file, ASCII or binary.
* :func:`read_camera_calib`, :func:`read_ouster_calib`: intrinsics and the
  sensor -> body-IMU extrinsics from their quaternions (w first in the
  files); :func:`read_odom`: TUM lines ``ts x y z qx qy qz qw``.
* :class:`FusionportableMonoDataset`: frames of ``frame_cam00`` or
  ``frame_cam01``, picked per sample by ``rand() < 0.5`` from a
  ``RandomState`` the dataset owns (``rng``, seeded from numpy's global
  state when the dataset is built; the JAX package draws from numpy's
  global state, so with ``rng`` set to ``RandomState(s)`` this picks
  what ``np.random.seed(s)`` would have made it pick; loader workers
  reseed it), relative poses through the IMU chain, static filtering.
"""
from __future__ import annotations

import os
from copy import deepcopy
from typing import Dict, List

import numpy as np
import yaml
from scipy.spatial.transform import Rotation as R

from ...utils.builder import build
from .io_utils import cam_relative_pose_nusc, read_image


class _OpenCVLoader(yaml.FullLoader):
    """PyYAML's full loader with OpenCV's matrix tag."""


def _opencv_matrix(loader, node):
    mapping = loader.construct_mapping(node, deep=True)
    mat = np.array(mapping["data"])
    mat.resize(mapping["rows"], mapping["cols"])
    return mat


_OpenCVLoader.add_constructor("tag:yaml.org,2002:opencv-matrix",
                              _opencv_matrix)


def read_opencv_yaml(file_path: str) -> Dict:
    """An OpenCV yaml file (``%YAML:1.0`` header) -> dict."""
    with open(file_path) as fin:
        c = fin.read()
        if c.startswith("%YAML:1.0"):
            c = "%YAML 1.1" + os.linesep + "---" + c[len("%YAML:1.0"):]
        return yaml.load(c, Loader=_OpenCVLoader)


def read_pcd_file(file_name: str) -> np.ndarray:
    """[N, 3] float64 x, y, z of a PCD file (``DATA ascii`` or ``binary``,
    fields of any float size)."""
    with open(file_name, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="ignore").strip()
            key = line.split(" ")[0].upper()
            header[key] = line.split(" ")[1:]
            if key == "DATA":
                break
        fields = header.get("FIELDS", ["x", "y", "z"])
        sizes = [int(s) for s in header.get("SIZE", ["4"] * len(fields))]
        count = int(header.get("POINTS", ["0"])[0])
        data_kind = header["DATA"][0]

        if data_kind == "ascii":
            body = np.loadtxt(f, dtype=np.float64, max_rows=count)
            body = np.atleast_2d(body)
        else:
            point_step = sum(sizes)
            raw = f.read(count * point_step)
            if all(s == 4 for s in sizes):
                body = np.frombuffer(raw, dtype=np.float32).reshape(
                    count, len(fields))
            else:
                dtype = np.dtype({
                    "names": fields,
                    "formats": [f"f{s}" for s in sizes]})
                rec = np.frombuffer(raw, dtype=dtype)
                body = np.stack([rec[name] for name in fields], axis=-1)
        idx = [fields.index(n) for n in ("x", "y", "z")]
        return np.asarray(body[:, idx], dtype=np.float64)


def T_from_quaternion_translation(q, t) -> np.ndarray:
    """[qx, qy, qz, qw] and t -> 4x4."""
    T = np.eye(4)
    T[:3, :3] = R.from_quat(q).as_matrix()
    T[:3, 3] = t
    return T


def read_camera_calib(file: str) -> Dict:
    """A frame camera's yaml -> K, R, D, P, its size and the IMU -> camera
    extrinsic."""
    c = read_opencv_yaml(file)
    q = c["quaternion_sensor_bodyimu"][0]  # qw, qx, qy, qz
    q = [q[1], q[2], q[3], q[0]]
    t = c["translation_sensor_bodyimu"][0]
    return dict(
        K=c["camera_matrix"], distortion_model=c["distortion_model"],
        R=c["rectification_matrix"], D=c["distortion_coefficients"],
        P=c["projection_matrix"], height=c["image_height"],
        width=c["image_width"], q_imu2cam=q, t_imu2cam=t,
        T_imu2cam=T_from_quaternion_translation(q, t))


def read_ouster_calib(file: str) -> Dict:
    """The Ouster's yaml -> its IMU and camera-00 extrinsics."""
    c = read_opencv_yaml(file)
    q_i = c["quaternion_sensor_bodyimu"][0]
    q_i = [q_i[1], q_i[2], q_i[3], q_i[0]]
    t_i = c["translation_sensor_bodyimu"][0]
    q_c = c["quaternion_sensor_frame_cam00"][0]
    q_c = [q_c[1], q_c[2], q_c[3], q_c[0]]
    t_c = c["translation_sensor_frame_cam00"][0]
    return dict(
        q_imu2ouster=q_i, t_imu2ouster=t_i,
        T_imu2ouster=T_from_quaternion_translation(q_i, t_i),
        q_cam002ouster=q_c, t_cam002ouster=t_c,
        T_cam002ouster=T_from_quaternion_translation(q_c, t_c))


def read_odom(file: str) -> Dict:
    """TUM odometry lines ``ts x y z qx qy qz qw`` -> translations,
    quaternions and [N, 4, 4] poses."""
    t_list, q_list, T_list = [], [], []
    with open(file, "r") as f:
        for line in f.readlines():
            e = line.split(" ")
            t_list.append(np.array([float(x) for x in e[1:4]]))
            q_list.append(np.array([float(x) for x in e[4:8]]))
            T_list.append(T_from_quaternion_translation(q_list[-1], t_list[-1]))
    return dict(t_list=np.array(t_list), q_list=np.array(q_list),
                T_list=np.array(T_list))


def read_split_file(file: str) -> List[int]:
    with open(file, "r") as f:
        return [int(line.strip()) for line in f.readlines()]


class FusionportableMonoDataset:
    """Monocular training dataset over one FusionPortable sequence."""

    def __init__(self, **data_cfg):
        self.base_path = data_cfg["base_path"]
        self.use_right_image = data_cfg.get("use_right_image", True)
        self.frame_idxs = list(data_cfg["frame_idxs"])
        self.odom_file = data_cfg.get("odom_file",
                                      "20220226_campus_road_day.txt")

        self.imdb = read_split_file(data_cfg["split_file"])

        calib_dir = os.path.join(self.base_path, "calib")
        self.meta_dict = dict(calib=dict(
            Cam00=read_camera_calib(os.path.join(calib_dir, "frame_cam00.yaml")),
            Cam01=read_camera_calib(os.path.join(calib_dir, "frame_cam01.yaml")),
            Ouster00=read_ouster_calib(os.path.join(calib_dir, "ouster00.yaml")),
        ))
        self.meta_dict["poses"] = read_odom(
            os.path.join(self.base_path, self.odom_file))

        self.is_filter_static = data_cfg.get("is_filter_static", True)
        if self.is_filter_static:
            self.imdb = self._filter_static_indexes()
        self.rng = np.random.RandomState(np.random.randint(0, 2 ** 32))
        self.transform = build(**data_cfg["augmentation"])

    def _filter_static_indexes(self):
        imdb = []
        T_imu2cam = self.meta_dict["calib"]["Cam00"]["T_imu2cam"]
        for index in self.imdb:
            imu2world_s = self.get_pose(
                [index + idx for idx in self.frame_idxs])
            is_static = False
            for i, _ in enumerate(self.frame_idxs[1:]):
                pose = cam_relative_pose_nusc(
                    imu2world_s[0], imu2world_s[i + 1],
                    T_imu2cam).astype(np.float32)
                if np.linalg.norm(pose[0:3, 3]) < 0.03:
                    is_static = True
            if not is_static:
                imdb.append(index)
        print(f"FusionPortable filtering: {len(self.imdb)} -> {len(imdb)}")
        return imdb

    def __len__(self):
        return len(self.imdb)

    def __getitem__(self, i: int) -> Dict:
        index = self.imdb[i]
        if (not self.use_right_image) or (self.rng.rand() < 0.5):
            calib = self.meta_dict["calib"]["Cam00"]
            image_dir_name = "frame_cam00"
        else:
            calib = self.meta_dict["calib"]["Cam01"]
            image_dir_name = "frame_cam01"

        data: Dict = {}
        for idx in self.frame_idxs:
            data[("image", idx)] = self.get_color(index + idx, image_dir_name)
            data[("original_image", idx)] = data[("image", idx)].copy()
        h, w, _ = data[("image", 0)].shape
        data["patched_mask"] = np.ones([h, w])

        imu2world_s = self.get_pose([index + idx for idx in self.frame_idxs])
        for i2, idx in enumerate(self.frame_idxs[1:]):
            data[("relative_pose", idx)] = cam_relative_pose_nusc(
                imu2world_s[0], imu2world_s[i2 + 1],
                calib["T_imu2cam"]).astype(np.float32)

        data["P2"] = np.array(calib["P"], dtype=np.float32).reshape(3, 4)
        data["original_P2"] = data["P2"].copy()
        return self.transform(deepcopy(data))

    def get_color(self, frame_index, image_dir_name):
        return read_image(os.path.join(
            self.base_path, image_dir_name, "image", "data",
            "%06d.png" % frame_index))

    def get_pose(self, frame_indexes: List[int]):
        return self.meta_dict["poses"]["T_list"][frame_indexes, :, :]

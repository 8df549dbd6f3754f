"""nuScenes surround-view datasets, host code (counterpart of
``fsnet_tpu.data.datasets.nuscene_dataset``):

* :class:`NusceneDepthMonoDataset`: the devkit's tables (one index per
  token line and camera), relative poses through the ego poses and the
  camera's extrinsics, and static samples (under ``filter_threshold`` or
  over 3 m) replaced by a random other index;
* :class:`NusceneSweepDepthMonoDataset`: the neighbours walked along the
  camera's ``prev`` / ``next`` sample_data;
* :class:`NusceneJsonDataset`: the paths, poses and intrinsics of each
  sample precomputed in a JSON file (no devkit); the CAM_BACK frames'
  rows from 700 on masked out (the ego vehicle's body), and an optional VO
  depth map.

The JPEG frames are read by the port's own decoder
(:func:`~fsnet_tpu_torch.data.datasets.image_io.read_image`), bit for bit
what PIL reads. The static resampling draws from a generator the dataset
owns (``rng``, seeded from numpy's global state when the dataset is made;
loader workers reseed it) where the JAX package draws from numpy's global
state.
"""
from __future__ import annotations

import json
import os
from copy import deepcopy
from functools import partial
from typing import Dict

import numpy as np

from ...utils.builder import build
from .io_utils import (cam_relative_pose_nusc, get_transformation_matrix,
                       read_image, read_vo_depth)

DEFAULT_CAMERAS = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT",
                   "CAM_BACK", "CAM_BACK_LEFT", "CAM_FRONT_LEFT")


class NusceneDepthMonoDataset:
    """Samples of the devkit's tables: ``split_file`` lines of sample
    tokens (the frame, then its neighbours), one index per line and camera
    of ``channels``."""

    def __init__(self, **data_cfg):
        self.nuscenes_version = data_cfg.get("nuscenes_version",
                                             "v1.0-trainval")
        self.nuscenes_dir = data_cfg.get("nuscenes_dir", "/data/nuscene")

        with open(data_cfg["split_file"], "r") as f:
            self.token_list = [line.strip().split(",")
                               for line in f.readlines()]

        self.nusc = build(
            "fsnet_tpu_torch.data.datasets.nuscenes_utils.NuScenes",
            version=self.nuscenes_version, dataroot=self.nuscenes_dir,
            verbose=True)
        print(f"Found {len(self.nusc.scene)} scenes "
              f"in {self.nuscenes_version}")

        self.nusc_get_sample = partial(self.nusc.get, "sample")
        self.nusc_get_sample_data = partial(self.nusc.get, "sample_data")
        self.nusc_get_sensor = partial(self.nusc.get, "calibrated_sensor")
        self.nusc_get_ego_pose = partial(self.nusc.get, "ego_pose")

        self.cameras = list(data_cfg.get("channels", DEFAULT_CAMERAS))
        self.vo_path = data_cfg.get("vo_path")
        self.is_read_vo_depth = self.vo_path is not None
        self.frame_ids = list(data_cfg.get("frame_ids", [0, -1, 1]))

        self.is_motion_mask = data_cfg.get("is_motion_mask", False)
        self.precompute_path = data_cfg.get("precompute_path", "")
        self.is_filter_static = data_cfg.get("is_filter_static", True)
        self.filter_threshold = data_cfg.get("filter_threshold", 0.03)

        self.transform = build(**data_cfg["augmentation"])
        self.rng = np.random.RandomState(np.random.randint(0, 2 ** 32))

    def __len__(self):
        return len(self.token_list) * len(self.cameras)

    @staticmethod
    def get_intrinsic(cs_record):
        return np.array(cs_record["camera_intrinsic"])

    @staticmethod
    def get_extrinsic(cs_record):
        return get_transformation_matrix(cs_record["translation"],
                                         cs_record["rotation"])

    @staticmethod
    def get_ego_pose(ego_record):
        return get_transformation_matrix(ego_record["translation"],
                                         ego_record["rotation"])

    def _camera_datas(self, index):
        token_index = index // len(self.cameras)
        camera_type_index = index % len(self.cameras)
        camera_type = self.cameras[camera_type_index]
        samples = list(map(self.nusc_get_sample,
                           self.token_list[token_index]))
        camera_datas = list(map(
            self.nusc_get_sample_data,
            [s["data"][camera_type] for s in samples]))
        return camera_type_index, camera_type, camera_datas

    def _assemble(self, index, camera_type_index, camera_type, camera_datas):
        cs_records = list(map(
            self.nusc_get_sensor,
            [cd["calibrated_sensor_token"] for cd in camera_datas]))
        ego_records = list(map(
            self.nusc_get_ego_pose,
            [cd["ego_pose_token"] for cd in camera_datas]))

        image_arrays = [read_image(os.path.join(self.nuscenes_dir,
                                                cd["filename"]))
                        for cd in camera_datas]
        P2 = self.get_intrinsic(cs_records[0])
        extrinsics = list(map(self.get_extrinsic, cs_records))
        poses = list(map(self.get_ego_pose, ego_records))

        data: Dict = {}
        for i, idx in enumerate(self.frame_ids[1:]):
            data[("relative_pose", idx)] = cam_relative_pose_nusc(
                poses[0], poses[i + 1],
                np.linalg.inv(extrinsics[0])).astype(np.float32)
            if self.is_filter_static:
                t = np.linalg.norm(data[("relative_pose", idx)][0:3, 3])
                if t < self.filter_threshold or t > 3:
                    # a static (or jumping) sample: another, at random
                    return self[self.rng.randint(len(self))]

        for i, frame_id in enumerate(self.frame_ids):
            data[("image", frame_id)] = image_arrays[i]
            data[("original_image", frame_id)] = \
                data[("image", frame_id)].copy()

        if self.is_read_vo_depth:
            vo_path = camera_datas[0]["filename"].replace(
                "samples", self.vo_path).replace(".jpg", ".png")
            if os.path.isfile(vo_path):
                data[("vo_depth", 0)] = read_vo_depth(vo_path)
            else:
                print(f"No VO Depth file found at {index}, {vo_path}")

        h, w, _ = data[("image", 0)].shape
        data["patched_mask"] = np.ones([h, w])
        data["P2"] = np.zeros((3, 4), dtype=np.float32)
        data["P2"][0:3, 0:3] = P2
        data["original_P2"] = data["P2"].copy()
        data["camera_type_index"] = camera_type_index
        data[("filename", 0)] = camera_datas[0]["filename"]
        data["camera_type"] = camera_type

        return self.transform(deepcopy(data))

    def __getitem__(self, index):
        camera_type_index, camera_type, camera_datas = \
            self._camera_datas(index)
        return self._assemble(index, camera_type_index, camera_type,
                              camera_datas)


class NusceneSweepDepthMonoDataset(NusceneDepthMonoDataset):
    """The neighbours walked from the line's first token along the
    camera's ``next`` (positive frame ids) or ``prev`` sample_data, one
    step per unit of the frame id."""

    def __getitem__(self, index):
        token_index = index // len(self.cameras)
        camera_type_index = index % len(self.cameras)
        camera_type = self.cameras[camera_type_index]

        main_sample = self.nusc_get_sample(self.token_list[token_index][0])
        main_camera = self.nusc_get_sample_data(
            main_sample["data"][camera_type])
        camera_datas = [main_camera]
        for frame_id in self.frame_ids[1:]:
            next_key = "next" if frame_id > 0 else "prev"
            cam = main_camera
            for _ in range(abs(frame_id)):
                cam = self.nusc_get_sample_data(cam[next_key])
            camera_datas.append(cam)

        return self._assemble(index, camera_type_index, camera_type,
                              camera_datas)


class NusceneJsonDataset:
    """Samples precomputed in ``json_path`` (``samples``: the frames'
    paths under ``image_keys``, ``pose01`` and ``pose0-1``, the 3x3
    intrinsics under ``intrinsic_key``, ``camera_type`` and
    ``camera_type_indexes``). No devkit."""

    def __init__(self, **data_cfg):
        self.json_path = data_cfg.get(
            "json_path", "meta_data/nusc_trainsub/json_nusc_front_train.json")
        with open(self.json_path, "r") as f:
            self.json_dict = json.load(f)

        self.image_keys = list(data_cfg.get(
            "image_keys", ["frame0", "frame1", "frame-1"]))
        self.pose_keys = list(data_cfg.get("pose_keys",
                                           ["pose01", "pose0-1"]))
        self.intrinsic_key = data_cfg.get("intrinsic_key", "P2")
        self.cameras = list(data_cfg.get("channels", DEFAULT_CAMERAS))
        self.frame_ids = list(data_cfg.get("frame_ids", [0, 1, -1]))
        self.transform = build(**data_cfg["augmentation"])
        self.vo_path = data_cfg.get("vo_path")
        self.is_read_vo_depth = self.vo_path is not None

    def __len__(self):
        return len(self.json_dict["samples"])

    def __getitem__(self, index):
        sample = self.json_dict["samples"][index]
        image_arrays = [read_image(sample[key]) for key in self.image_keys]
        P2 = np.array(sample[self.intrinsic_key]).reshape(3, 3).astype(
            np.float32)
        camera_type_index = sample["camera_type_indexes"]
        camera_type = sample["camera_type"]

        data: Dict = {}
        data[("relative_pose", 1)] = np.array(
            sample["pose01"]).reshape([4, 4]).astype(np.float32)
        data[("relative_pose", -1)] = np.array(
            sample["pose0-1"]).reshape([4, 4]).astype(np.float32)

        for i, frame_id in enumerate(self.frame_ids):
            data[("image", frame_id)] = image_arrays[i]
            data[("original_image", frame_id)] = \
                data[("image", frame_id)].copy()

        h, w, _ = data[("image", 0)].shape
        data["patched_mask"] = np.ones([h, w])
        if camera_type == "CAM_BACK":
            # the ego vehicle's body fills the back camera's lower rows
            data["patched_mask"][700:, :] = 0

        data["P2"] = np.zeros((3, 4), dtype=np.float32)
        data["P2"][0:3, 0:3] = P2
        data["original_P2"] = data["P2"].copy()
        data["camera_type_index"] = camera_type_index
        data[("filename", 0)] = os.path.join(
            *sample[self.image_keys[0]].split("/")[-3:])
        data["camera_type"] = camera_type

        if self.is_read_vo_depth:
            # relative to the working directory, as the JAX package's
            vo_path = data[("filename", 0)].replace(
                "samples", self.vo_path).replace(".jpg", ".png")
            if os.path.isfile(vo_path):
                data[("vo_depth", 0)] = read_vo_depth(vo_path)
            else:
                print(f"No VO Depth file found at {index}, {vo_path}")

        return self.transform(deepcopy(data))

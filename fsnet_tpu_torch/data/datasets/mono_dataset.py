"""KITTI raw self-supervised depth datasets (counterpart of
``fsnet_tpu.data.datasets.mono_dataset``).

* :class:`KittiDepthMonoDataset` (training): frames ``frame_idxs`` around
  each split entry, ground-truth relative poses from ``oxts/pose.mat``
  through the imu -> velo -> cam chain, static filtering (a neighbour
  closer than 0.03 m drops the entry), optional sparse depth, motion mask
  and flow channels.
* :class:`KittiDepthMonoEigenTestDataset`: the Eigen test split, frame 0
  and the pose to the previous frame, P2 or P3 by side, optional sparse
  depth.

The sample dict is the JAX package's: ``('image', f)`` and
``('original_image', f)`` HWC ``uint8`` before the augmentation,
``('relative_pose', f)``, ``'P2'``, ``'original_P2'``, ``'patched_mask'``
and the optional keys. The PNGs are read by the port's own reader; the
motion mask and the flow as ``cv2.imread(path, -1)`` reads them, so a
colour flow file comes in BGR order and ``[:, :, 0:2]`` takes its third and
second channels, as the JAX package's does.
"""
from __future__ import annotations

import os
from copy import deepcopy
from typing import Dict, List

import numpy as np

from ...utils.builder import build
from .image_io import imread_unchanged
from .io_utils import (cam_relative_pose, read_depth, read_image,
                       read_imu2velo, read_P23_from_sequence, read_pose_mat,
                       read_split_file, read_T_from_sequence)


def read_kitti_dates(raw_path: str) -> Dict[str, Dict]:
    """P2, P3, T_vel2cam and T_imu2vel of every date folder of
    ``raw_path``."""
    meta = {}
    for date_time in os.listdir(raw_path):
        folder = os.path.join(raw_path, date_time)
        if not os.path.isdir(folder):
            continue
        P2, P3 = read_P23_from_sequence(
            os.path.join(folder, "calib_cam_to_cam.txt"))
        meta[date_time] = dict(
            P2=P2, P3=P3,
            T_vel2cam=read_T_from_sequence(
                os.path.join(folder, "calib_velo_to_cam.txt")),
            T_imu2vel=read_imu2velo(
                os.path.join(folder, "calib_imu_to_velo.txt")))
    return meta


def _color_path(raw_path: str, folder: str, frame_index: int, side: str):
    camera_folder = {"l": "image_02", "r": "image_03"}[side]
    return os.path.join(raw_path, folder, camera_folder, "data",
                        "%010d.png" % frame_index)


class KittiDepthMonoDataset:
    """Training dataset over KITTI raw sequences."""

    def __init__(self, **data_cfg):
        self.raw_path = data_cfg["raw_path"]
        self.depth_path = data_cfg.get("depth_path")
        self.frame_idxs = list(data_cfg["frame_idxs"])

        self.imdb = read_split_file(data_cfg["split_file"])
        self.meta_dict = read_kitti_dates(self.raw_path)
        self.pose_dict = {
            folder: read_pose_mat(
                os.path.join(self.raw_path, folder, "oxts", "pose.mat"))
            for folder in {obj["folder"] for obj in self.imdb}
        }

        self.is_motion_mask = data_cfg.get("is_motion_mask", False)
        self.is_precompute_flow = data_cfg.get("is_precompute_flow", False)
        self.precompute_path = data_cfg.get("motion_mask_path", "")
        self.flow_path = data_cfg.get("flow_path", "")
        self.is_filter_static = data_cfg.get("is_filter_static", True)
        if self.is_filter_static:
            self.imdb = self._filter_static_indexes()
        self.transform = build(**data_cfg["augmentation"])

    def _filter_static_indexes(self) -> List[Dict]:
        """Drops the entries with a neighbour whose relative translation is
        under 0.03 m."""
        imdb = []
        for obj in self.imdb:
            imu2world_s = self.get_pose(
                obj["folder"], [obj["index"] + idx for idx in self.frame_idxs])
            meta = self.meta_dict[obj["datetime"]]
            is_static = False
            for i, _ in enumerate(self.frame_idxs[1:]):
                pose = cam_relative_pose(
                    imu2world_s[0], imu2world_s[i + 1],
                    meta["T_imu2vel"], meta["T_vel2cam"]).astype(np.float32)
                if np.linalg.norm(pose[0:3, 3]) < 0.03:
                    is_static = True
            if not is_static:
                imdb.append(obj)
        print(f"Static filtering: {len(self.imdb)} -> {len(imdb)} samples")
        return imdb

    def __len__(self) -> int:
        return len(self.imdb)

    def __getitem__(self, i: int) -> Dict:
        obj = self.imdb[i]
        folder, index = obj["folder"], obj["index"]
        side, datetime = obj["side"], obj["datetime"]
        meta = self.meta_dict[datetime]

        data: Dict = {}
        for idx in self.frame_idxs:
            data[("image", idx)] = self.get_color(folder, index + idx, side)
            data[("original_image", idx)] = data[("image", idx)].copy()
        h, w, _ = data[("image", 0)].shape
        data["patched_mask"] = np.ones([h, w])

        if self.is_motion_mask:
            data["motion_mask"] = self.get_motion_mask(i)
        if self.is_precompute_flow:
            data["flow"] = self.get_flow(i)

        imu2world_s = self.get_pose(
            folder, [index + idx for idx in self.frame_idxs])
        for j, idx in enumerate(self.frame_idxs[1:]):
            data[("relative_pose", idx)] = cam_relative_pose(
                imu2world_s[0], imu2world_s[j + 1],
                meta["T_imu2vel"], meta["T_vel2cam"]).astype(np.float32)

        data["P2"] = meta[{"l": "P2", "r": "P3"}[side]]
        data["original_P2"] = data["P2"].copy()

        if self.depth_path is not None:
            data[("sparse_depth", 0)] = self.get_depth(folder, index, side)

        return self.transform(deepcopy(data))

    def get_color(self, folder, frame_index, side):
        return read_image(_color_path(self.raw_path, folder, frame_index,
                                      side))

    def get_depth(self, folder, frame_index, side):
        camera_folder = {"l": "image_02", "r": "image_03"}[side]
        return read_depth(os.path.join(
            self.depth_path, folder.split("/")[1], "proj_depth",
            "groundtruth", camera_folder, "%010d.png" % frame_index))

    def get_pose(self, folder, frame_indexes: List[int]):
        return self.pose_dict[folder][frame_indexes, :, :]

    def get_motion_mask(self, i):
        return imread_unchanged(os.path.join(self.precompute_path,
                                             f"{i:08d}.png"))

    def get_flow(self, i):
        arflow = imread_unchanged(os.path.join(self.flow_path,
                                               f"{i:08d}.png"))[:, :, 0:2]
        return (arflow.astype(np.float32) - 2 ** 15) / 64.0


class KittiDepthMonoEigenTestDataset:
    """The Eigen test split: frame 0, the previous frame and the pose to
    it, P2 or P3 by side, optional sparse depth."""

    def __init__(self, **data_cfg):
        self.raw_path = data_cfg["raw_path"]
        self.depth_path = data_cfg.get("depth_path")
        self.imdb = read_split_file(data_cfg["split_file"])
        self.meta_dict = read_kitti_dates(self.raw_path)
        self.transform = build(**data_cfg["augmentation"])

    def __len__(self):
        return len(self.imdb)

    def __getitem__(self, index: int) -> Dict:
        obj = self.imdb[index]
        folder, idx = obj["folder"], obj["index"]
        side, datetime = obj["side"], obj["datetime"]
        meta = self.meta_dict[datetime]

        data: Dict = {}
        data[("image", 0)] = self.get_color(folder, idx, side)
        data[("image", -1)] = self.get_color(folder, max(idx - 1, 0), side)
        data[("original_image", 0)] = data[("image", 0)].copy()

        data["P2"] = meta[{"l": "P2", "r": "P3"}[side]]
        data["original_P2"] = data["P2"].copy()

        imu2world_s = self.get_pose(folder, [idx, idx - 1])
        data[("relative_pose", -1)] = cam_relative_pose(
            imu2world_s[0], imu2world_s[1],
            meta["T_imu2vel"], meta["T_vel2cam"]).astype(np.float32)

        if self.depth_path is not None:
            data[("sparse_depth", 0)] = read_depth(os.path.join(
                self.raw_path, folder, "depth", "%010d.png" % idx))

        return self.transform(deepcopy(data))

    def get_color(self, folder, frame_index, side):
        return read_image(_color_path(self.raw_path, folder, frame_index,
                                      side))

    def get_pose(self, folder, frame_indexes: List[int]):
        pose_array = read_pose_mat(
            os.path.join(self.raw_path, folder, "oxts", "pose.mat"))
        return pose_array[frame_indexes, :, :]

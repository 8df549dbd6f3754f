"""KITTI-360 perspective dataset (counterpart of
``fsnet_tpu.data.datasets.kitti360_dataset``): a meta file of (sequence,
pose index, image index, previous, next) lines, the perspective.txt and
calib_cam_to_pose.txt calibration chain, ground-truth relative poses from
the key poses, static and > 3 m jump filtering, and a random pick of the
left or right camera per sample (from numpy's global state, as the JAX
package draws it; loader workers reseed it).
"""
from __future__ import annotations

import os
from copy import deepcopy
from typing import Dict, List

import numpy as np

from ...utils.builder import build
from .io_utils import cam_relative_pose_nusc, read_image


def read_P01_from_sequence(file: str):
    """P_rect_00/01 and R_rect_00/01 of perspective.txt."""
    P0 = P1 = None
    R0, R1 = np.eye(4), np.eye(4)
    with open(file, "r") as f:
        for line in f.readlines():
            data = line.strip().split(" ")
            if line.startswith("P_rect_00"):
                P0 = np.array([float(x) for x in data[1:13]]).reshape(3, 4)
            if line.startswith("R_rect_00"):
                R0[0:3, 0:3] = np.array(
                    [float(x) for x in data[1:10]]).reshape(3, 3)
            if line.startswith("P_rect_01"):
                P1 = np.array([float(x) for x in data[1:13]]).reshape(3, 4)
            if line.startswith("R_rect_01"):
                R1[0:3, 0:3] = np.array(
                    [float(x) for x in data[1:10]]).reshape(3, 3)
    assert P0 is not None and P1 is not None, file
    return P0, P1, R0, R1


def read_extrinsic_from_sequence(file: str):
    """The image_00/01 cam -> pose extrinsics of calib_cam_to_pose.txt."""
    T0, T1 = np.eye(4), np.eye(4)
    with open(file, "r") as f:
        for line in f.readlines():
            data = line.strip().split(" ")
            if line.startswith("image_00"):
                T0[0:3, :] = np.array([float(x) for x in data[1:13]]).reshape(3, 4)
            if line.startswith("image_01"):
                T1[0:3, :] = np.array([float(x) for x in data[1:13]]).reshape(3, 4)
    return T0, T1


def read_poses_file(file: str):
    """poses.txt -> (key_frames, [N, 4, 4])."""
    key_frames, poses = [], []
    with open(file, "r") as f:
        for line in f.readlines():
            data = line.strip().split(" ")
            key_frames.append(int(data[0]))
            pose = np.eye(4)
            pose[0:3, :] = np.array([float(x) for x in data[1:13]]).reshape(3, 4)
            poses.append(pose)
    return key_frames, np.array(poses)


def read_T_from_sequence(file: str) -> np.ndarray:
    """calib_cam_to_velo.txt, one line of a 3x4 -> 4x4."""
    with open(file, "r") as f:
        data = f.readlines()[0].strip().split(" ")
    T_velo2cam = np.eye(4)
    T_velo2cam[0:3, :] = np.array([float(x) for x in data[0:12]]).reshape(3, 4)
    return T_velo2cam


class KITTI360MonoDataset:
    """Training (and, unfiltered, validation) dataset over KITTI-360."""

    def __init__(self, **data_cfg):
        self.raw_path = data_cfg.get("raw_path", "/data/KITTI-360")
        self.meta_file = data_cfg.get("split_file", "kitti360_meta.txt")

        self.img_dir = os.path.join(self.raw_path, "data_2d_raw")
        self.pose_dir = os.path.join(self.raw_path, "data_poses")
        self.calib_dir = os.path.join(self.raw_path, "calibration")
        self.pc_dir = os.path.join(self.raw_path, "data_3d_raw")

        self.frame_ids = list(data_cfg.get("frame_ids",
                                           data_cfg.get("frame_idxs", [0, -1, 1])))
        self.imdb: List[Dict] = []
        self.sequence_names = set()
        with open(self.meta_file, "r") as f:
            for line in f.readlines():
                seq, pose_idx, img_idx, former, latter = line.strip().split(",")
                pose_idx, img_idx = int(pose_idx), int(img_idx)
                former, latter = int(former), int(latter)
                self.sequence_names.add(seq)
                index_dict = {0: img_idx, -1: former, 1: latter}
                self.imdb.append(dict(
                    sequence_name=seq,
                    pose_indexes=[pose_idx + i for i in self.frame_ids],
                    img_indexes=[index_dict[i] for i in self.frame_ids],
                ))

        self._load_calib()
        self._load_keypose()

        self.is_motion_mask = data_cfg.get("is_motion_mask", False)
        self.precompute_path = data_cfg.get("motion_mask_path", "")
        self.is_filter_static = data_cfg.get("is_filter_static", True)
        self.filter_threshold = data_cfg.get("filter_threshold", 0.03)
        if self.is_filter_static:
            self.imdb = self._filter_indexes()

        self.use_right_image = data_cfg.get("use_right_image", True)
        self.transform = build(**data_cfg["augmentation"])

    def _load_calib(self):
        P0, P1, R0, R1 = read_P01_from_sequence(
            os.path.join(self.calib_dir, "perspective.txt"))
        T0, T1 = read_extrinsic_from_sequence(
            os.path.join(self.calib_dir, "calib_cam_to_pose.txt"))
        self.cam_calib = dict(
            P0=P0, P1=P1,
            T_rect02baselink=R0 @ T0,
            T_rect12baselink=R1 @ T1,
        )

    def _load_keypose(self):
        self.keypose = {}
        for seq in self.sequence_names:
            _, poses = read_poses_file(
                os.path.join(self.pose_dir, seq, "poses.txt"))
            self.keypose[seq] = poses

    def _filter_indexes(self) -> List[Dict]:
        """Drops the static (< threshold) and key-pose-jump (> 3 m)
        samples."""
        imdb = []
        extrinsics = self.cam_calib["T_rect02baselink"]
        for obj in self.imdb:
            poses = self.keypose[obj["sequence_name"]][obj["pose_indexes"]]
            is_overlook = False
            for i, _ in enumerate(self.frame_ids[1:]):
                pose_diff = cam_relative_pose_nusc(
                    poses[0], poses[i + 1],
                    np.linalg.inv(extrinsics)).astype(np.float32)
                translation = np.linalg.norm(pose_diff[0:3, 3])
                if translation < self.filter_threshold or translation > 3:
                    is_overlook = True
            if not is_overlook:
                imdb.append(obj)
        print(f"KITTI-360 filtering: {len(self.imdb)} -> {len(imdb)} samples")
        return imdb

    def __len__(self):
        return len(self.imdb)

    def __getitem__(self, index: int) -> Dict:
        obj = self.imdb[index]
        seq = obj["sequence_name"]

        if (not self.use_right_image) or (np.random.rand() < 0.5):
            extrinsics = self.cam_calib["T_rect02baselink"]
            image_dir_name = "image_00"
            P2 = self.cam_calib["P0"]
        else:
            extrinsics = self.cam_calib["T_rect12baselink"]
            image_dir_name = "image_01"
            P2 = self.cam_calib["P1"]

        data: Dict = {}
        poses = self.keypose[seq][obj["pose_indexes"]]
        for i, idx in enumerate(self.frame_ids[1:]):
            data[("relative_pose", idx)] = cam_relative_pose_nusc(
                poses[0], poses[i + 1],
                np.linalg.inv(extrinsics)).astype(np.float32)

        image_dir = os.path.join(self.img_dir, seq, image_dir_name, "data_rect")
        for i, frame_id in enumerate(self.frame_ids):
            img_path = os.path.join(
                image_dir, f"{obj['img_indexes'][i]:010d}.png")
            data[("image", frame_id)] = read_image(img_path)
            data[("original_image", frame_id)] = data[("image", frame_id)].copy()

        data["P2"] = np.zeros((3, 4), dtype=np.float32)
        data["P2"][0:3, 0:3] = P2[0:3, 0:3]
        data["original_P2"] = data["P2"].copy()

        h, w, _ = data[("image", 0)].shape
        data["patched_mask"] = np.ones([h, w])

        return self.transform(deepcopy(data))
